"""
NPHD (Normalized Prefix Hamming Distance) and Hamming similarity scoring in
pure JAX — the semantic reference implementation for the matmul scan
and the execution path on CPU backends.

NPHD semantics (matching iscc-usearch's patched metric as exercised by the
reference at indexes/usearch/index.py:2024-2045):

    nphd(q, d) = popcount(xor(q, d) over the common prefix) / min_bits
    min_bits   = min(len(q), len(d))
    score      = 1.0 - nphd

Since ISCC-UNIT bodies are multiples of 64 bits packed into 32-bit lanes, the
common prefix is a whole number of lanes and the masked popcount is exact.

Scores for tombstoned/padded rows are forced to -1.0 so they sort after any
real match (real scores are in [0, 1]).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

NEG_SCORE = -1.0


def nphd_scores(q_codes, q_lanes, db_codes, db_lanes, db_valid=None):
    # type: (jnp.ndarray, jnp.ndarray, jnp.ndarray, jnp.ndarray, jnp.ndarray | None) -> jnp.ndarray
    """
    Dense NPHD similarity scores for all (query, db) pairs.

    :param q_codes: (Q, L) uint32 packed query codes
    :param q_lanes: (Q,) int32 active lane counts per query
    :param db_codes: (N, L) uint32 packed database codes
    :param db_lanes: (N,) int32 active lane counts per row
    :param db_valid: optional (N,) bool; invalid rows score NEG_SCORE
    :return: (Q, N) float32 scores in [0, 1] (or NEG_SCORE)
    """
    max_lanes = q_codes.shape[-1]
    # (Q, N, L) xor popcounts — fine for the reference path / small chunks;
    # the production path tiles this inside a scan.
    x = jnp.bitwise_xor(q_codes[:, None, :], db_codes[None, :, :])
    pops = jax.lax.population_count(x).astype(jnp.int32)

    min_lanes = jnp.minimum(q_lanes[:, None], db_lanes[None, :])  # (Q, N)
    lane_idx = jnp.arange(max_lanes, dtype=jnp.int32)
    prefix_mask = lane_idx[None, None, :] < min_lanes[:, :, None]  # (Q, N, L)
    ham = jnp.sum(jnp.where(prefix_mask, pops, 0), axis=-1)  # (Q, N)

    min_bits = (min_lanes * 32).astype(jnp.float32)
    scores = 1.0 - ham.astype(jnp.float32) / jnp.maximum(min_bits, 1.0)
    if db_valid is not None:
        scores = jnp.where(db_valid[None, :], scores, NEG_SCORE)
    return scores


def hamming_scores(q_codes, db_codes, ndim_bits, db_valid=None):
    # type: (jnp.ndarray, jnp.ndarray, int, jnp.ndarray | None) -> jnp.ndarray
    """
    Dense fixed-width Hamming similarity: score = 1 - hamming/ndim_bits.

    Matches the simprint scoring at indexes/simprint/usearch_core.py:181-183.

    :param q_codes: (Q, L) uint32 packed query simprints
    :param db_codes: (N, L) uint32 packed stored simprints
    :param ndim_bits: simprint width in bits (lanes beyond ndim are zero-padded
        identically on both sides so they contribute 0 to the distance)
    :return: (Q, N) float32 scores
    """
    x = jnp.bitwise_xor(q_codes[:, None, :], db_codes[None, :, :])
    ham = jnp.sum(jax.lax.population_count(x).astype(jnp.int32), axis=-1)
    scores = 1.0 - ham.astype(jnp.float32) / float(ndim_bits)
    if db_valid is not None:
        scores = jnp.where(db_valid[None, :], scores, NEG_SCORE)
    return scores
