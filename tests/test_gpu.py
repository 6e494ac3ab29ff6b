"""Checks that need an NVIDIA GPU: the exact scan as XLA compiles it for the
card, against the numpy brute force. Each takes the ``gpu`` fixture, which
skips it where JAX sees no GPU; ``python chip_smoke.py`` runs them on the card."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import chip_smoke as cs
from iscc_search_tpu.engine import DeviceNphdIndex
from iscc_search_tpu.ops.pm1_scan import _chunk_scores, prepare_queries, topk_blocks_hier

pytestmark = pytest.mark.gpu


def test_gpu_engine_matches_brute_force(gpu, tmp_path):
    """1M mixed-width rows with tombstones through the engine on the card."""
    rng = np.random.default_rng(5)
    n = 1 << 20
    packed, lanes = cs.mixed_rows(rng, n)
    valid = np.ones(n, bool)
    dead = rng.choice(n, n // 16, replace=False)
    valid[dead] = False
    idx = DeviceNphdIndex(tmp_path / "i", shard_size=1 << 40)
    idx.add_packed(cs._keys8(1, n), packed, lanes)
    idx.remove([int(r) + 1 for r in dead])
    rows = rng.choice(np.flatnonzero(valid), 64, replace=False)
    ref = cs.brute_force_nphd(packed[rows[:8]], lanes[rows[:8]], packed, lanes, valid)
    for count in (10, 100):
        res = idx.search(cs._bodies(packed[rows], lanes[rows]), count)
        cs.check_topk(f"gpu k={count}", res, ref, count, cs._rows_of_keys8)
    assert idx._partitions[8].packed_dev.devices() == {gpu}
    idx.close()


def test_gpu_topk_blocks_hier_keeps_f32_maxima(gpu):
    """Block maxima that differ below TF32 precision must still be ranked
    exactly (the super-block gather copies them, it does not round them)."""
    rng = np.random.default_rng(6)
    q, nb, k = 8, 128 * 64, 16
    base = rng.integers(0, 1 << 20, (q, nb)).astype(np.float32)
    bm = (0.5 + base * np.float32(2.0**-24)).astype(np.float32)  # spacing far below TF32's 2^-11
    got = np.asarray(jax.jit(lambda x: topk_blocks_hier(x, k))(jax.device_put(bm, gpu)))
    for qi in range(q):
        kth = np.sort(bm[qi])[::-1][k - 1]
        assert np.all(bm[qi][got[qi]] >= kth)


def test_gpu_chunk_scores_exact(gpu):
    """bf16 ±1 operands with f32 accumulation give exact NPHD on the card."""
    rng = np.random.default_rng(7)
    n = 4096
    db = rng.integers(0, 2**32, (n, 8), dtype=np.uint32)
    q_packed = db[:16].copy()
    q_lanes = np.array([2, 4, 6, 8] * 4, np.int32)
    q_pm1, q_scale = prepare_queries(q_packed, q_lanes, 256)
    s = jax.jit(lambda a, b, c, d: _chunk_scores(a, b, c, d, 256, jnp.bfloat16))(
        jax.device_put(q_pm1, gpu), jax.device_put(q_scale, gpu), jax.device_put(db, gpu),
        jax.device_put(np.ones(n, bool), gpu),
    )
    ref = cs.brute_force_nphd(q_packed, q_lanes, db, np.full(n, 8, np.int32), np.ones(n, bool))
    assert np.max(np.abs(np.asarray(s, np.float64) - ref)) <= cs.SCORE_TOL
