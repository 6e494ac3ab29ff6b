"""The exact engine (XLA block-max scan) against the numpy brute-force NPHD
reference: every code width, k from 1 to 1000, with and without tombstones,
one partition or all four, and appends after the first sync."""

import numpy as np
import pytest

from __graft_entry__ import _brute_force_nphd
from iscc_search_tpu.engine import DeviceNphdIndex
from iscc_search_tpu.engine.device_index import PackedCodeIndex

ROWS = 12_000  # per partition: capacity 16384, 128 blocks at a 2048-row chunk
CHUNK = 2048
TOL = 1e-6


def _data(rng, lane_choices, n):
    lanes = rng.choice(np.array(lane_choices, np.int32), n)
    packed = rng.integers(0, 2**32, (n, 8), dtype=np.uint32)
    packed[np.arange(8)[None, :] >= lanes[:, None]] = 0
    return packed, lanes


def _keys(first, n):
    return np.arange(first, first + n, dtype=">u8").view(np.uint8).reshape(n, 8)


def _bodies(packed, lanes, rows):
    return [packed[r, : lanes[r]].astype(">u4").tobytes() for r in rows]


def _check(results, ref, count):
    for qi, (keys, scores) in enumerate(results):
        live = int(np.count_nonzero(ref[qi] >= 0))
        want = min(count, live)
        assert len(scores) == want
        top = np.sort(ref[qi])[::-1][:want]
        np.testing.assert_allclose(np.sort(scores)[::-1], top, rtol=0, atol=TOL)
        rows = keys.view(">u8").reshape(-1).astype(np.int64) - 1
        assert np.all(ref[qi][rows] >= 0), "a tombstoned row came back"
        np.testing.assert_allclose(ref[qi][rows], scores, rtol=0, atol=TOL)


def _index(tmp_path, packed, lanes):
    idx = DeviceNphdIndex(tmp_path / "i", shard_size=1 << 30)
    idx.chunk_rows = CHUNK
    idx.add_packed(_keys(1, len(packed)), packed, lanes)
    return idx


@pytest.mark.parametrize("tombstones", [False, True], ids=["live", "tombstones"])
@pytest.mark.parametrize("count", [1, 10, 100, 1000])
@pytest.mark.parametrize("widths", [(2,), (4,), (6,), (8,), (2, 4, 6, 8)], ids=["64", "128", "192", "256", "mixed"])
def test_engine_matches_brute_force(tmp_path, widths, count, tombstones):
    rng = np.random.default_rng(sum(widths) * 1000 + count)
    n = ROWS * len(widths)
    packed, lanes = _data(rng, widths, n)
    valid = np.ones(n, bool)
    idx = _index(tmp_path, packed, lanes)
    q_rows = list(rng.choice(n, 6, replace=False))
    if tombstones:
        dead = rng.choice(n, n // 16, replace=False)
        dead = np.union1d(dead, q_rows[:2])  # two queries whose own row is gone
        idx.remove([int(r) + 1 for r in dead])
        valid[dead] = False
    queries = _bodies(packed, lanes, q_rows)
    # two queries shorter/longer than the rows: prefix semantics across widths
    extra = rng.integers(0, 2**32, (2, 8), dtype=np.uint32)
    extra_lanes = np.array([2, 8], np.int32)
    queries += _bodies(extra, extra_lanes, [0, 1])
    q_codes = np.concatenate([packed[q_rows], extra])
    q_lanes = np.concatenate([lanes[q_rows], extra_lanes])
    ref = _brute_force_nphd(q_codes, q_lanes, packed, lanes, valid)
    _check(idx.search(queries, count), ref, count)
    idx.close()


@pytest.mark.parametrize("in_place", [True, False], ids=["headroom", "rebuild"])
@pytest.mark.parametrize("lanes_", [2, 4, 6, 8])
def test_append_after_sync_matches_brute_force(tmp_path, lanes_, in_place):
    """Rows appended after the first sync land in the partition's headroom
    (device append) or overflow it (rebuild); some are then tombstoned."""
    rng = np.random.default_rng(lanes_ * 10 + in_place)
    n = 9000 if in_place else 16384
    packed, lanes = _data(rng, (lanes_,), n)
    idx = _index(tmp_path, packed, lanes)
    q0 = _bodies(packed, lanes, [0])
    idx.search(q0, 5)  # first sync
    part = idx._partitions[lanes_]
    extra, extra_lanes = _data(rng, (lanes_,), 512)
    idx.add_packed(_keys(n + 1, 512), extra, extra_lanes)
    idx.search(q0, 5)  # syncs the append
    assert (idx._partitions[lanes_] is part) == in_place
    gone = n + rng.choice(512, 64, replace=False)
    idx.remove([int(r) + 1 for r in gone])
    packed = np.concatenate([packed, extra])
    lanes = np.concatenate([lanes, extra_lanes])
    valid = np.ones(len(packed), bool)
    valid[gone] = False
    q_rows = [n + r for r in range(512) if n + r not in set(gone)][:4] + [1, 2]
    ref = _brute_force_nphd(packed[q_rows], lanes[q_rows], packed, lanes, valid)
    res = idx.search(_bodies(packed, lanes, q_rows), 10)
    _check(res, ref, 10)
    for qi in range(4):
        assert res[qi][1][0] == pytest.approx(1.0)  # appended rows find themselves
    idx.close()


@pytest.mark.parametrize(
    "count,rows,chunk_rows,expected",
    [
        (10, 65536, 32768, (16, 32768)),  # default: pow2 k, configured chunk
        (1, 8192, 32768, (1, 8192)),  # chunk capped at the rows
        (100, 196608, 131072, (128, 65536)),  # chunk not dividing rows -> gcd
        (1000, 8192, 512, (1024, 1024)),  # k past the chunk grows it
        (5000, 65536 * 3, 4096, (8192, 8192)),  # grown chunk still divides
        (40000, 65536 * 3, 32768, (65536, 65536)),  # grown chunk divides the 65536-quantized cap
        (70000, 65536 * 3, 32768, (131072, 196608)),  # grown chunk not dividing -> one chunk, k capped
        (3, 24576, 16384, (4, 8192)),  # gcd of 24576 and 16384
    ],
)
def test_scan_k_chunk(tmp_path, count, rows, chunk_rows, expected):
    idx = PackedCodeIndex(tmp_path / "i")
    idx.chunk_rows = chunk_rows
    k, chunk = idx._scan_k_chunk(count, rows)
    assert (k, chunk) == expected
    assert rows % chunk == 0 and k <= chunk
