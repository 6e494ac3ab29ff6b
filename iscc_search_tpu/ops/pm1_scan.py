"""
Matmul formulation of the NPHD/Hamming scan — the production search path.

Key identity: with codes encoded as ±1 vectors, ``dot(q, d) = matched_bits -
mismatched_bits = bits - 2*hamming``. Masking the *query* to the pair's
common prefix (zeros contribute nothing to the dot) gives, for a query
compared over ``min_bits``:

    dot = min_bits - 2 * hamming_prefix
    nphd_score = 1 - hamming_prefix / min_bits = 0.5 + dot / (2 * min_bits)

so the entire variable-length NPHD scoring collapses to ONE int8/bf16 matmul
per length partition plus a per-query scale — no popcount, no per-pair
masking. The engine partitions database rows by code length so ``min_bits``
depends only on (query, partition), making the scale a per-row broadcast
(SURVEY §7 "hard parts": sort/partition rows by length).

The database stays bit-packed in device memory ((N, 8) uint32 = 32 B/row);
each scan chunk is unpacked to ±1 on the fly (8x less memory traffic than
storing unpacked codes). The exact path is a two-phase block-max scan
(:func:`pm1_blockmax_topk_impl`); the recall-targeted path takes a per-chunk
``approx_max_k`` (or exact ``lax.top_k``) and merges chunk winners in a
single final top-k (no serial carry, so XLA pipelines chunk loads against
compute).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from iscc_search_tpu.compile_cache import ensure_compile_cache

# Restart parity: persist compiled executables before the first trace
# (minutes of per-process recompiles otherwise — see compile_cache.py).
ensure_compile_cache()

NEG_SCORE = -1.0

#: Named scopes of the block-max scan's phases; a profiler trace attributes
#: device time to them through the op metadata of each kernel.
PHASE_SCOPES = (
    "blockmax_phase1_scan",
    "blockmax_phase2_top_blocks",
    "blockmax_phase3_rescore",
    "blockmax_final_topk",
)

def _mark_varying(x, axes):
    """Mark a value device-varying over mesh axes (pcast with pvary fallback)."""
    try:
        return jax.lax.pcast(x, axes, to="varying")
    except (AttributeError, TypeError):  # pragma: no cover - older jax
        return jax.lax.pvary(x, axes)


def unpack_pm1(packed, nbits, dtype=jnp.bfloat16):
    # type: (jnp.ndarray, int, ...) -> jnp.ndarray
    """
    Unpack (N, L) uint32 packed codes to (N, nbits) ±1 values.

    Bit order: lanes in order, MSB-first within each lane — identical to the
    big-endian byte order of the original code bodies, so 64-bit group g
    occupies columns [64g, 64g+64).
    """
    lanes = nbits // 32
    # Shifts built via iota (not a captured constant) and the 0/1 -> ±1 step
    # via compare+select (no direct uint32 -> bf16 cast).
    shifts = (31 - jax.lax.broadcasted_iota(jnp.int32, (1, 1, 32), 2)).astype(jnp.uint32)
    bits = (packed[:, :lanes, None] >> shifts) & jnp.uint32(1)
    bits = bits.reshape(packed.shape[0], nbits)
    one = jnp.ones((), dtype)
    return jnp.where(bits > 0, one, -one)


def unpack_pm1_np(packed, nbits, dtype=np.float32):
    # type: (np.ndarray, int, ...) -> np.ndarray
    """NumPy twin of unpack_pm1 (host-side query preparation)."""
    lanes = nbits // 32
    # order="C" so the byte view is valid even for F-contiguous inputs
    # (e.g. arrays read back from a device gather)
    as_bytes = packed[:, :lanes].astype(">u4", order="C").view(np.uint8).reshape(packed.shape[0], lanes * 4)
    bits = np.unpackbits(as_bytes, axis=1)
    return (bits.astype(dtype) * 2 - 1).astype(dtype)


def _chunk_scores(q_pm1, q_scale, chunk_packed, chunk_valid, nbits, dtype):
    """Scores for one chunk: unpack -> matmul -> scale -> mask.

    The ±1 products and their sums are small integers, so bf16 operands with
    f32 accumulation are exact."""
    d = unpack_pm1(chunk_packed, nbits, dtype)
    acc_t = jnp.float32 if dtype == jnp.bfloat16 else jnp.int32
    dot = jax.lax.dot_general(
        q_pm1.astype(dtype), d, (((1,), (1,)), ((), ())), preferred_element_type=acc_t
    )
    s = 0.5 + dot.astype(jnp.float32) * q_scale[:, None]
    return jnp.where(chunk_valid[None, :], s, NEG_SCORE)


def pm1_topk_impl(
    q_pm1,
    q_scale,
    db_packed,
    db_valid,
    k,
    nbits,
    chunk_size=32768,
    dtype=jnp.bfloat16,
    recall_target=None,
    pvary_axes=(),
):
    # type: (...) -> tuple[jnp.ndarray, jnp.ndarray]
    """
    Exact (or recall-targeted) top-k scan via the ±1 matmul identity.

    :param q_pm1: (Q, nbits) ±1 queries, already zero-masked beyond each
        query's common-prefix bits for this partition
    :param q_scale: (Q,) float32 per-query scale = 1 / (2 * min_bits)
    :param db_packed: (N, L) uint32 bit-packed codes, N % chunk_size == 0
    :param db_valid: (N,) bool tombstone/padding mask
    :param k: results per query (static)
    :param nbits: partition code width in bits (static, multiple of 64)
    :param chunk_size: scan chunk rows (static)
    :param dtype: matmul input dtype (bf16 default; int8 where supported)
    :param recall_target: None = exact lax.top_k per chunk; float in (0,1] =
        ``lax.approx_max_k`` with that per-chunk recall target
    :return: (scores (Q, k) float32 desc, indices (Q, k) int32, -1 padding)
    """
    n = db_packed.shape[0]
    q = q_pm1.shape[0]
    if n % chunk_size:
        raise ValueError(f"db size {n} not a multiple of chunk_size {chunk_size}")
    kk = min(k, chunk_size)
    nch = n // chunk_size

    db_c = db_packed.reshape(nch, chunk_size, db_packed.shape[1])
    valid_c = db_valid.reshape(nch, chunk_size)

    def body(carry, xs):
        chunk, v = xs
        s = _chunk_scores(q_pm1, q_scale, chunk, v, nbits, dtype)
        if recall_target is not None:
            ts, ti = jax.lax.approx_max_k(s, kk, recall_target=recall_target)
        else:
            ts, ti = jax.lax.top_k(s, kk)
        return carry, (ts, ti.astype(jnp.int32))

    # Inside shard_map the scanned db arrays are device-varying; a dummy
    # varying carry keeps the scan's carry types consistent under VMA checks.
    carry = None
    if pvary_axes:
        carry = _mark_varying(jnp.zeros((), jnp.int32), tuple(pvary_axes))
    _, (ts, ti) = jax.lax.scan(body, carry, (db_c, valid_c))
    # (nch, Q, kk) -> final merge over all chunk winners
    all_s = jnp.transpose(ts, (1, 0, 2)).reshape(q, nch * kk)
    base = (jnp.arange(nch, dtype=jnp.int32) * chunk_size)[None, :, None]  # (1, nch, 1)
    all_i = (jnp.transpose(ti, (1, 0, 2)) + base).reshape(q, nch * kk)
    out_k = min(k, all_s.shape[1])
    fs, pos = jax.lax.top_k(all_s, out_k)
    fi = jnp.take_along_axis(all_i, pos, axis=1)
    fi = jnp.where(fs > NEG_SCORE, fi, -1)
    if out_k < k:  # pragma: no cover - k > nch*kk edge
        pad = k - out_k
        fs = jnp.pad(fs, ((0, 0), (0, pad)), constant_values=NEG_SCORE)
        fi = jnp.pad(fi, ((0, 0), (0, pad)), constant_values=-1)
    return fs, fi


pm1_topk = jax.jit(
    pm1_topk_impl,
    static_argnames=("k", "nbits", "chunk_size", "dtype", "recall_target", "pvary_axes"),
)


def topk_blocks_hier(block_max, k, super_block=128):
    # type: (jnp.ndarray, int, int) -> jnp.ndarray
    """
    EXACT top-k block ids from per-block maxima, hierarchically.

    A flat ``lax.top_k`` over all N/128 block maxima dominates phase-2 cost at
    large N (e.g. 82K candidates per query at 10M rows). Grouping blocks into
    super-blocks of ``super_block`` and taking top-k super-blocks first cuts
    the sort to ~N/16384 + k*super_block candidates.

    Exactness (ties included) follows the same superset argument as the
    block-max cut itself, applied twice: a block containing any top-k row has
    max >= the k-th score, so its super-block does too; if either level drops
    it, every survivor at that level has max >= it, and each survivor
    contributes at least one gathered row with score >= the k-th score — the
    final candidate set always contains a complete top-k score multiset.

    Returns (Q, min(k, n_blocks)) distinct block ids.
    """
    q, nb = block_max.shape
    kk = min(k, nb)
    ns = nb // super_block
    if nb % super_block or ns <= kk * 2:
        # Ragged or too few super-blocks for the hierarchy to pay for itself.
        return jax.lax.top_k(block_max, kk)[1]
    bm3 = block_max.reshape(q, ns, super_block)
    super_max = jnp.max(bm3, axis=2)
    _, top_super = jax.lax.top_k(super_max, kk)  # (Q, kk) distinct super ids
    # Gather the surviving super-blocks' maxima rows. A gather copies the f32
    # maxima bit for bit; a one-hot f32 matmul would not on a GPU, where a
    # default-precision f32 dot may run in TF32 and round the maxima, which
    # breaks the superset argument above.
    cand = jnp.take_along_axis(bm3, top_super[:, :, None], axis=1)  # (Q, kk, super_block)
    _, pos = jax.lax.top_k(cand.reshape(q, kk * super_block), kk)
    sel_super = jnp.take_along_axis(top_super, pos // super_block, axis=1)
    return sel_super * super_block + pos % super_block


def segmented_unpack_dots(q_d, db_packed, rows, nbits, dtype, acc_t):
    # type: (jnp.ndarray, jnp.ndarray, jnp.ndarray, int, ..., ...) -> jnp.ndarray
    """±1 dots of each query against gathered packed rows, bounded memory.

    ``rows`` is (Q, total) global row ids; returns (Q, total) float32 dots.
    Candidates are gathered, unpacked, and dotted in segments sized to a
    ~1 GiB f32-equivalent unpacked working set (bf16 halves it) via
    ``lax.map`` — the all-at-once materialization is O(Q·total) HBM and
    OOMs at Q=256, total=32768, nbits=256. ``total`` may be any size: the
    row table pads to a whole number of segments (padding gathers row 0;
    the padded columns are sliced off before they can contribute).
    """
    q, total = rows.shape
    seg_budget = 1 << max(11, ((1 << 30) // (q * nbits * 4)).bit_length() - 1)

    def dots_for(rows_part):
        width = rows_part.shape[-1]
        cand_packed = jnp.take(db_packed, rows_part.reshape(-1), axis=0)
        cand_pm1 = unpack_pm1(cand_packed, nbits, dtype).reshape(q, width, nbits)
        return jax.lax.dot_general(
            q_d[:, None, :],
            cand_pm1,
            (((2,), (2,)), ((0,), (0,))),
            preferred_element_type=acc_t,
        ).reshape(q, width)

    if total <= seg_budget:
        return dots_for(rows).astype(jnp.float32)
    n_seg = -(-total // seg_budget)
    padded = n_seg * seg_budget
    rows_p = jnp.pad(rows, ((0, 0), (0, padded - total))) if padded > total else rows
    segs = rows_p.reshape(q, n_seg, seg_budget).transpose(1, 0, 2)  # (n_seg, Q, seg)
    dots = jax.lax.map(dots_for, segs).transpose(1, 0, 2).reshape(q, padded)
    return dots[:, :total].astype(jnp.float32)


def pm1_blockmax_topk_impl(
    q_pm1,
    q_scale,
    db_packed,
    db_valid,
    k,
    nbits,
    chunk_size=32768,
    dtype=jnp.bfloat16,
    block=128,
    pvary_axes=(),
):
    # type: (...) -> tuple[jnp.ndarray, jnp.ndarray]
    """
    EXACT top-k via two phases, avoiding any per-chunk sort:

    1. Scan chunks computing only per-128-row block maxima of the scores
       (a cheap reduction fused into the matmul epilogue).
    2. Take the top-k BLOCKS per query by maximum, gather those k*block rows,
       rescore them exactly, and select the final top-k.

    Exactness: every element scoring strictly above the true k-th score lives
    in a block whose max exceeds it; at most k-1 such elements exist, so all
    their blocks survive the top-k block cut, and each selected block
    contributes at least one candidate >= the k-th score — the candidate set
    always contains a complete top-k score multiset.

    Same signature/semantics as pm1_topk_impl with recall_target=None, but
    ~an order of magnitude cheaper than per-chunk lax.top_k at large N.
    """
    n = db_packed.shape[0]
    q = q_pm1.shape[0]
    if n % chunk_size or chunk_size % block:
        raise ValueError("db size must divide by chunk_size and chunk_size by block")
    nch = n // chunk_size
    blocks_per_chunk = chunk_size // block
    total_blocks = n // block
    if total_blocks < k:
        # Tiny database: the single-phase exact path is cheap enough.
        return pm1_topk_impl(
            q_pm1, q_scale, db_packed, db_valid, k, nbits, chunk_size, dtype, None, pvary_axes
        )

    db_c = db_packed.reshape(nch, chunk_size, db_packed.shape[1])
    valid_c = db_valid.reshape(nch, chunk_size)

    def body(carry, xs):
        chunk, v = xs
        s = _chunk_scores(q_pm1, q_scale, chunk, v, nbits, dtype)
        return carry, jnp.max(s.reshape(q, blocks_per_chunk, block), axis=2)

    # Inside shard_map the scanned db arrays are device-varying; a dummy
    # varying carry keeps the scan's carry types consistent under VMA checks.
    carry = None
    if pvary_axes:
        carry = _mark_varying(jnp.zeros((), jnp.int32), tuple(pvary_axes))
    with jax.named_scope(PHASE_SCOPES[0]):
        _, bm = jax.lax.scan(body, carry, (db_c, valid_c))  # (nch, Q, bpc)
        block_max = jnp.transpose(bm, (1, 0, 2)).reshape(q, total_blocks)

    with jax.named_scope(PHASE_SCOPES[1]):
        top_blocks = topk_blocks_hier(block_max, k)  # (Q, k) block ids

    # Gather candidate rows and rescore exactly
    rows = top_blocks[:, :, None] * block + jnp.arange(block, dtype=jnp.int32)[None, None, :]
    rows = rows.reshape(q, k * block)  # (Q, k*block) global row ids
    # Per-row takes, so XLA can fuse them into the unpack+dot consumer.
    #
    # The rescore streams over candidate segments (segmented_unpack_dots):
    # materializing all (Q, k*block, nbits) unpacked candidates at once is
    # O(Q*k) device memory — 8 GB at Q=256, k=256, nbits=256 in f32 — for a
    # legal API call. The validity gather stays full-width: (Q, k*block)
    # bools are tiny next to the unpacked candidates.
    acc_t = jnp.float32 if dtype == jnp.bfloat16 else jnp.int32
    with jax.named_scope(PHASE_SCOPES[2]):
        dots = segmented_unpack_dots(q_pm1.astype(dtype), db_packed, rows, nbits, dtype, acc_t)
        cand_valid = jnp.take(db_valid, rows.reshape(-1), axis=0).reshape(q, k * block)
        scores = 0.5 + dots * q_scale[:, None]
        scores = jnp.where(cand_valid, scores, NEG_SCORE)

    with jax.named_scope(PHASE_SCOPES[3]):
        fs, pos = jax.lax.top_k(scores, k)
        fi = jnp.take_along_axis(rows, pos, axis=1)
        fi = jnp.where(fs > NEG_SCORE, fi, -1)
    return fs, fi


pm1_blockmax_topk = jax.jit(
    pm1_blockmax_topk_impl,
    static_argnames=("k", "nbits", "chunk_size", "dtype", "block", "pvary_axes"),
)


def prepare_queries_impl(q_packed, q_lanes, partition_bits):
    # type: (jnp.ndarray, jnp.ndarray, int) -> tuple[jnp.ndarray, jnp.ndarray]
    """
    Traceable twin of :func:`prepare_queries`: unpack + prefix-mask + scale
    from the 32 B/query packed codes, composable INSIDE the jitted search
    programs — so serving uploads packed queries and pays ONE dispatch.

    Bit-exact vs the host version (same unpack order, f32 arithmetic).
    """
    q_pm1 = unpack_pm1(q_packed[:, : partition_bits // 32], partition_bits, jnp.float32)
    min_bits = jnp.minimum(q_lanes.astype(jnp.int32) * 32, partition_bits)
    col = jax.lax.broadcasted_iota(jnp.int32, (1, partition_bits), 1)
    q_pm1 = jnp.where(col < min_bits[:, None], q_pm1, 0.0)
    q_scale = 1.0 / (2.0 * jnp.maximum(min_bits, 1).astype(jnp.float32))
    return q_pm1, q_scale


prepare_queries_device = jax.jit(prepare_queries_impl, static_argnames="partition_bits")


def pm1_topk_packedq_impl(q_packed, q_lanes, db_packed, db_valid, k, nbits, **kw):
    q_pm1, q_scale = prepare_queries_impl(q_packed, q_lanes, nbits)
    return pm1_topk_impl(q_pm1, q_scale, db_packed, db_valid, k, nbits, **kw)


def pm1_blockmax_topk_packedq_impl(q_packed, q_lanes, db_packed, db_valid, k, nbits, **kw):
    q_pm1, q_scale = prepare_queries_impl(q_packed, q_lanes, nbits)
    return pm1_blockmax_topk_impl(q_pm1, q_scale, db_packed, db_valid, k, nbits, **kw)


pm1_topk_packedq = jax.jit(
    pm1_topk_packedq_impl,
    static_argnames=("k", "nbits", "chunk_size", "dtype", "recall_target", "pvary_axes"),
)

pm1_blockmax_topk_packedq = jax.jit(
    pm1_blockmax_topk_packedq_impl,
    static_argnames=("k", "nbits", "chunk_size", "dtype", "block", "pvary_axes"),
)


def prepare_queries(q_packed, q_lanes, partition_bits):
    # type: (np.ndarray, np.ndarray, int) -> tuple[np.ndarray, np.ndarray]
    """
    Host-side query prep for one length partition.

    Unpacks queries to ±1 over the partition width and zeroes positions past
    each query's own length, so the matmul computes the common-prefix dot.

    :param q_packed: (Q, L) uint32 packed query codes
    :param q_lanes: (Q,) int32 query lane counts
    :param partition_bits: partition code width in bits
    :return: (q_pm1 (Q, partition_bits) float32, q_scale (Q,) float32)
    """
    q_pm1 = unpack_pm1_np(q_packed, partition_bits, np.float32)
    q_bits = q_lanes.astype(np.int64) * 32
    min_bits = np.minimum(q_bits, partition_bits)
    col = np.arange(partition_bits)[None, :]
    q_pm1 = np.where(col < min_bits[:, None], q_pm1, 0.0).astype(np.float32)
    q_scale = (1.0 / (2.0 * np.maximum(min_bits, 1))).astype(np.float32)
    return q_pm1, q_scale
