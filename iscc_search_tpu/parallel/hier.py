"""
Hierarchical multi-host top-k: 2-D (dcn x ici) mesh with a two-stage merge.

BASELINE config 5 (100M codes across a pod slice) spans hosts. A flat
all-gather over every chip would push ``n_hosts * chips_per_host * k``
candidates per query across DCN — the slow inter-host network. Instead the
mesh is 2-D:

- axis ``ici``: the chips within one host/slice, connected by ICI
- axis ``dcn``: one entry per host, connected by data-center network

and the merge is hierarchical: each device scans its row shard, the per-chip
candidates all-gather over the ICI axis and reduce to a per-host top-k
(intra-host, fast), and only then do the per-host winners all-gather over the
DCN axis (``n_hosts * k`` candidates — chips_per_host-fold less DCN traffic
than the flat merge). The final top-k is replicated on every device.

The reference explicitly does not support multi-process serving
(/root/reference/iscc_search/indexes/usearch/manager.py:43-47 warns against
it); this module is the accelerator-native answer to that gap. XLA owns all
collectives — there is no NCCL/MPI layer.

Process topology: with ``jax.distributed`` each host contributes its local
chips; :func:`make_mesh_2d` orders the device array so each mesh row is one
process's devices, making the ICI axis process-local by construction (on CPU
test clusters the "ici" axis is simply intra-process).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding
from jax.sharding import PartitionSpec as P

try:
    from jax import shard_map
except ImportError:  # pragma: no cover - older jax
    from jax.experimental.shard_map import shard_map

from iscc_search_tpu.ops.pm1_scan import pm1_blockmax_topk_impl
from iscc_search_tpu.ops.nphd import NEG_SCORE
from iscc_search_tpu.ops.topk import topk_scan_impl

DCN_AXIS = "dcn"
ICI_AXIS = "ici"
ROW_AXES = (DCN_AXIS, ICI_AXIS)


def make_mesh_2d(n_hosts=None, chips_per_host=None):
    # type: (int | None, int | None) -> Mesh
    """
    2-D (dcn, ici) mesh over the global device set.

    Devices sort by (process_index, id) so row ``h`` of the mesh holds host
    ``h``'s local chips — the ICI axis never crosses a host boundary. In a
    single-process virtual mesh (tests) the grouping is positional.
    """
    devices = sorted(jax.devices(), key=lambda d: (d.process_index, d.id))
    if n_hosts is None:
        n_hosts = max(jax.process_count(), 1)
    if chips_per_host is None:
        if len(devices) % n_hosts:
            raise ValueError(f"{len(devices)} devices not divisible by {n_hosts} hosts")
        chips_per_host = len(devices) // n_hosts
    need = n_hosts * chips_per_host
    if need > len(devices):
        raise ValueError(f"requested {n_hosts}x{chips_per_host} devices, only {len(devices)} available")
    grid = np.array(devices[:need]).reshape(n_hosts, chips_per_host)
    return Mesh(grid, ROW_AXES)


def row_sharding(mesh):
    # type: (Mesh) -> NamedSharding
    """Rows sharded over both axes (host-major), columns replicated."""
    return NamedSharding(mesh, P(ROW_AXES, None))


def shard_database_2d(mesh, db_codes, db_lanes, db_valid):
    # type: (...) -> tuple
    """Row-shard database arrays over the flattened (dcn, ici) axes.

    Single-process only (device_put needs all shards addressable); in a real
    multi-host cluster each process feeds its local rows through
    :func:`make_global_array` instead.
    """
    n = mesh.shape[DCN_AXIS] * mesh.shape[ICI_AXIS]
    if db_codes.shape[0] % n:
        raise ValueError(f"db rows {db_codes.shape[0]} not divisible by {n} shards")
    rows = NamedSharding(mesh, P(ROW_AXES))
    return (
        jax.device_put(db_codes, row_sharding(mesh)),
        jax.device_put(db_lanes, rows),
        jax.device_put(db_valid, rows),
    )


def make_global_array(mesh, local_rows, global_shape, with_cols=True):
    # type: (...) -> jax.Array
    """
    Assemble a row-sharded global array from this process's local rows.

    ``local_rows`` covers the contiguous row range owned by this process's
    devices (host-major order, matching :func:`make_mesh_2d`). Works in
    multi-process clusters where remote shards are not addressable.
    """
    spec = P(ROW_AXES, None) if with_cols else P(ROW_AXES)
    sharding = NamedSharding(mesh, spec)
    return jax.make_array_from_process_local_data(sharding, local_rows, global_shape)


@functools.lru_cache(maxsize=64)
def _hier_topk_fn(mesh, k, chunk_size, metric, ndim_bits, merge_k):
    # type: (...) -> ...
    merge_k = k if merge_k is None else merge_k
    n_ici = mesh.shape[ICI_AXIS]

    def local_step(q_codes, q_lanes, db_codes, db_lanes, db_valid):
        scores, idx = topk_scan_impl(
            q_codes, q_lanes, db_codes, db_lanes, db_valid, k, chunk_size, metric, ndim_bits,
            pvary_axes=ROW_AXES,
        )
        # local row -> global row (host-major shard order)
        shard = jax.lax.axis_index(DCN_AXIS) * n_ici + jax.lax.axis_index(ICI_AXIS)
        local_rows = db_codes.shape[0]
        idx = jnp.where(idx >= 0, idx + shard * local_rows, -1)

        # Stage 1: intra-host merge over ICI (n_ici*k candidates, fast axis)
        s1 = jax.lax.all_gather(scores, ICI_AXIS, axis=1, tiled=True)
        i1 = jax.lax.all_gather(idx, ICI_AXIS, axis=1, tiled=True)
        host_k = min(merge_k, s1.shape[1])
        ts, pos = jax.lax.top_k(s1, host_k)
        ti = jnp.take_along_axis(i1, pos, axis=1)

        # Stage 2: cross-host merge over DCN (n_hosts*host_k candidates only)
        s2 = jax.lax.all_gather(ts, DCN_AXIS, axis=1, tiled=True)
        i2 = jax.lax.all_gather(ti, DCN_AXIS, axis=1, tiled=True)
        top_s, pos2 = jax.lax.top_k(s2, min(merge_k, s2.shape[1]))
        top_i = jnp.take_along_axis(i2, pos2, axis=1)
        return top_s, jnp.where(top_s > NEG_SCORE, top_i, -1)

    kwargs = dict(
        mesh=mesh,
        in_specs=(P(), P(), P(ROW_AXES, None), P(ROW_AXES), P(ROW_AXES)),
        out_specs=(P(), P()),
    )
    try:
        mapped = shard_map(local_step, check_vma=False, **kwargs)
    except TypeError:  # pragma: no cover - older jax spelling
        mapped = shard_map(local_step, check_rep=False, **kwargs)
    return jax.jit(mapped)


def hier_topk(mesh, q_codes, q_lanes, db_codes, db_lanes, db_valid, k,
              chunk_size=8192, metric="nphd", ndim_bits=None, merge_k=None):
    # type: (...) -> tuple
    """
    Exact global top-k over a (dcn, ici)-sharded database, two-stage merge.

    :return: replicated (scores (Q, merge_k or k), global row indices)
    """
    fn = _hier_topk_fn(mesh, k, chunk_size, metric, ndim_bits, merge_k)
    return fn(q_codes, q_lanes, db_codes, db_lanes, db_valid)


@functools.lru_cache(maxsize=64)
def _hier_pm1_fn(mesh, k, nbits, chunk_size, dtype, merge_k):
    # type: (...) -> ...
    merge_k = k if merge_k is None else merge_k
    n_ici = mesh.shape[ICI_AXIS]

    def local_step(q_pm1, q_scale, db_packed, db_valid):
        scores, idx = pm1_blockmax_topk_impl(
            q_pm1, q_scale, db_packed, db_valid, k, nbits,
            chunk_size=chunk_size, dtype=dtype, pvary_axes=ROW_AXES,
        )
        shard = jax.lax.axis_index(DCN_AXIS) * n_ici + jax.lax.axis_index(ICI_AXIS)
        idx = jnp.where(idx >= 0, idx + shard * db_packed.shape[0], -1)

        s1 = jax.lax.all_gather(scores, ICI_AXIS, axis=1, tiled=True)
        i1 = jax.lax.all_gather(idx, ICI_AXIS, axis=1, tiled=True)
        ts, pos = jax.lax.top_k(s1, min(merge_k, s1.shape[1]))
        ti = jnp.take_along_axis(i1, pos, axis=1)

        s2 = jax.lax.all_gather(ts, DCN_AXIS, axis=1, tiled=True)
        i2 = jax.lax.all_gather(ti, DCN_AXIS, axis=1, tiled=True)
        top_s, pos2 = jax.lax.top_k(s2, min(merge_k, s2.shape[1]))
        top_i = jnp.take_along_axis(i2, pos2, axis=1)
        return top_s, jnp.where(top_s > NEG_SCORE, top_i, -1)

    kwargs = dict(
        mesh=mesh,
        in_specs=(P(), P(), P(ROW_AXES, None), P(ROW_AXES)),
        out_specs=(P(), P()),
    )
    try:
        mapped = shard_map(local_step, check_vma=False, **kwargs)
    except TypeError:  # pragma: no cover - older jax spelling
        mapped = shard_map(local_step, check_rep=False, **kwargs)
    return jax.jit(mapped)


def hier_pm1_topk(mesh, q_pm1, q_scale, db_packed, db_valid, k, nbits,
                  chunk_size=32768, dtype=jnp.bfloat16, merge_k=None):
    # type: (...) -> tuple
    """Global pm1-matmul top-k over a (dcn, ici)-sharded packed database."""
    fn = _hier_pm1_fn(mesh, k, nbits, chunk_size, dtype, merge_k)
    return fn(q_pm1, q_scale, db_packed, db_valid)
