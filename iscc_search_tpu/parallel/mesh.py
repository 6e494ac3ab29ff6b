"""Device mesh construction and row placement for sharded search."""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding
from jax.sharding import PartitionSpec as P

SHARD_AXIS = "shards"


def make_mesh(n_devices=None, axis_name=SHARD_AXIS):
    # type: (int | None, str) -> Mesh
    """
    1-D device mesh over the first ``n_devices`` devices.

    The database rows shard along this single axis (capacity scaling — the
    analog of the reference's file-level shard rotation, SURVEY §2.3); queries
    replicate. Within a host the axis rides the cards' interconnect; across hosts jax.distributed
    extends the same mesh over DCN.
    """
    devices = jax.devices()
    if n_devices is None:
        n_devices = len(devices)
    if n_devices > len(devices):
        raise ValueError(f"requested {n_devices} devices, only {len(devices)} available")
    return Mesh(np.array(devices[:n_devices]), (axis_name,))


def process_row_block(mesh, n_rows):
    # type: (Mesh, int) -> tuple[int, int]
    """
    Contiguous global row range [lo, hi) owned by THIS process's devices when
    ``n_rows`` rows shard over all of ``mesh``'s axes (host-major order).

    Requires the mesh's flattened device order to group devices by process
    with every process holding an equal device count — the layout
    :func:`iscc_search_tpu.parallel.hier.make_mesh_2d` constructs. Raises if
    the mesh interleaves processes (a sliced global array would then not be
    feedable from per-process contiguous blocks).
    """
    flat = mesh.devices.reshape(-1)
    procs = [d.process_index for d in flat]
    if procs != sorted(procs):
        raise ValueError("mesh devices are not grouped by process (use make_mesh_2d)")
    n_procs = len(set(procs))
    if len(flat) % n_procs or procs.count(procs[0]) != len(flat) // n_procs:
        raise ValueError("mesh processes hold unequal device counts")
    if n_rows % n_procs:
        raise ValueError(f"{n_rows} rows not divisible by {n_procs} processes")
    per_proc = n_rows // n_procs
    rank = sorted(set(procs)).index(jax.process_index())
    return rank * per_proc, (rank + 1) * per_proc


def place_rows(mesh, arr, with_cols=True):
    # type: (Mesh, np.ndarray, bool) -> jax.Array
    """
    Row-shard a host array over ALL mesh axes (host-major row order).

    Single-process: a plain sharded device_put. Multi-process
    (``jax.distributed``): every process holds the full host-side array (the
    store is the shared truth) but uploads ONLY its own contiguous row block —
    no device ever receives another host's rows, and no host pays device
    transfer for rows it does not serve (the "derived shards host-local"
    placement for BASELINE config 5).
    """
    axes = tuple(mesh.axis_names)
    spec = P(axes, *([None] * (arr.ndim - 1))) if with_cols else P(axes)
    sharding = NamedSharding(mesh, spec)
    if jax.process_count() > 1:
        lo, hi = process_row_block(mesh, arr.shape[0])
        return jax.make_array_from_process_local_data(
            sharding, np.ascontiguousarray(arr[lo:hi]), arr.shape
        )
    return jax.device_put(arr, sharding)
