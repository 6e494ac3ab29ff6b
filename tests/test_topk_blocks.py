"""topk_blocks_hier: the hierarchical block selection keeps every block a
flat top-k would need, ties and near-equal maxima included."""

import jax
import numpy as np
import pytest

from iscc_search_tpu.ops.pm1_scan import topk_blocks_hier


def _maxima(kind, rng, q, nb):
    if kind == "ties":
        return rng.integers(0, 8, (q, nb)).astype(np.float32) / 8
    if kind == "near_equal":  # spacing far below TF32 precision
        return (0.5 + rng.integers(0, 1 << 20, (q, nb)) * 2.0**-24).astype(np.float32)
    return rng.random((q, nb), dtype=np.float32)


@pytest.mark.parametrize("kind", ["ties", "near_equal", "continuous"])
@pytest.mark.parametrize("k", [1, 5, 40])
def test_selection_holds_a_complete_top_k(kind, k):
    rng = np.random.default_rng(k)
    q, nb = 4, 128 * 96  # 96 super-blocks: the hierarchical path
    bm = _maxima(kind, rng, q, nb)
    got = np.asarray(jax.jit(lambda x: topk_blocks_hier(x, k))(bm))
    assert got.shape == (q, k)
    for qi in range(q):
        assert len(set(got[qi].tolist())) == k  # distinct blocks
        kth = np.sort(bm[qi])[::-1][k - 1]
        assert np.all(bm[qi][got[qi]] >= kth)
        # every block strictly above the k-th maximum is selected
        assert set(np.flatnonzero(bm[qi] > kth)) <= set(got[qi].tolist())
