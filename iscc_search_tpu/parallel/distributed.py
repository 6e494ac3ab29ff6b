"""
Multi-host initialization for pod-slice deployments (BASELINE config 5:
100M codes sharded across several devices).

One process per host joins the cluster via ``jax.distributed``; the global
mesh then spans every chip, the database row-shards over it
(parallel.pm1_sharded), and the all-gather top-k merge rides ICI within the
slice and DCN across hosts — no NCCL/MPI layer, XLA owns the collectives.
"""

from __future__ import annotations

import os

from iscc_search_tpu.parallel.mesh import SHARD_AXIS, make_mesh
from iscc_search_tpu.utils import get_logger

logger = get_logger(__name__)


def init_distributed(coordinator_address=None, num_processes=None, process_id=None):
    # type: (str | None, int | None, int | None) -> None
    """
    Join (or bootstrap) a multi-host JAX cluster.

    Arguments default to the ISCC_SEARCH_COORDINATOR / ISCC_SEARCH_NUM_HOSTS /
    ISCC_SEARCH_HOST_ID environment variables; on managed TPU pods where the
    runtime injects cluster metadata, calling with no arguments lets
    jax.distributed auto-detect. Single-host setups skip initialization.
    """
    import jax

    coordinator_address = coordinator_address or os.environ.get("ISCC_SEARCH_COORDINATOR")
    num_processes = num_processes or _int_env("ISCC_SEARCH_NUM_HOSTS")
    process_id = process_id if process_id is not None else _int_env("ISCC_SEARCH_HOST_ID")

    if coordinator_address is None and (num_processes is None or num_processes == 1):
        # Explicit ISCC_SEARCH_NUM_HOSTS=1 with no coordinator IS the
        # documented single-host mode; passing it to jax.distributed would
        # crash on cluster auto-detection instead.
        logger.info("No coordinator configured - single-host mode")
        return
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )
    logger.info(
        f"Joined cluster: process {jax.process_index()}/{jax.process_count()}, "
        f"{jax.local_device_count()} local / {jax.device_count()} global devices"
    )


def _int_env(name):
    # type: (str) -> int | None
    raw = os.environ.get(name)
    return int(raw) if raw else None


def global_mesh(axis_name=SHARD_AXIS):
    # type: (str) -> ...
    """1-D mesh over every device in the (possibly multi-host) cluster."""
    return make_mesh(axis_name=axis_name)
