"""
Round-5 perf-path tests: fused multi-partition sweeps, quantized partition
capacities, and multi-query-asset simprint batching.

The fused scan (engine/device_index.py:_fused_scan_fn) traces every length
partition into ONE jitted program; these tests pin its exactness against an
independent numpy brute force across mixed lengths, including partitions past
the 65536 capacity quantum (where capacities stop being powers of two).
"""

import numpy as np
import pytest

from iscc_search_tpu.engine.device_index import _cap_rows, DeviceNphdIndex
from iscc_search_tpu.engine.simprint import SimprintEngine


def brute_nphd(q, db):
    # type: (bytes, list[bytes]) -> np.ndarray
    """Independent NPHD similarity of one query against all db bodies."""
    out = np.zeros(len(db), np.float64)
    qb = np.unpackbits(np.frombuffer(q, np.uint8))
    for i, d in enumerate(db):
        db_bits = np.unpackbits(np.frombuffer(d, np.uint8))
        m = min(len(qb), len(db_bits))
        ham = int(np.count_nonzero(qb[:m] ^ db_bits[:m]))
        out[i] = 1.0 - ham / m
    return out


class TestCapRows:
    def test_small_partitions_stay_pow2(self):
        assert _cap_rows(1) == 8192
        assert _cap_rows(8192) == 8192
        assert _cap_rows(8193) == 16384
        assert _cap_rows(65536) == 65536

    def test_large_partitions_quantize_with_headroom(self):
        cap = _cap_rows(65537)
        assert cap % 65536 == 0
        assert cap >= 65537
        # 12.5% headroom, not a pow2 doubling
        n = 4_194_304 + 1
        cap = _cap_rows(n)
        assert n < cap < 2 * n
        assert cap % 65536 == 0
        assert cap >= n + n // 8

    def test_quantum_keeps_kernel_divisibility(self):
        for n in (70_000, 131_073, 1_000_001):
            cap = _cap_rows(n)
            assert cap % 32768 == 0  # scan chunk
            assert cap % 128 == 0  # block


class TestFusedMixedLengthScan:
    def test_mixed_lengths_exact_vs_brute_force(self, tmp_path):
        """Three length partitions in one fused program, exact scores."""
        rng = np.random.default_rng(7)
        lens = rng.choice([8, 16, 32], 3000, p=[0.4, 0.3, 0.3])
        bodies = [rng.integers(0, 256, l, dtype=np.uint8).tobytes() for l in lens.tolist()]
        idx = DeviceNphdIndex(tmp_path / "v")
        idx.add(list(range(len(bodies))), bodies)

        queries = [bodies[0], bodies[1500], bodies[2999], rng.integers(0, 256, 24, dtype=np.uint8).tobytes()]
        results = idx.search(queries, 10)
        assert len(results) == len(queries)
        for q, (keys, scores) in zip(queries, results):
            want = np.sort(brute_nphd(q, bodies))[::-1][:10]
            got = np.sort(np.asarray(scores, np.float64))[::-1]
            np.testing.assert_allclose(got, want, atol=1e-6)

    def test_partition_past_capacity_quantum(self, tmp_path):
        """A partition larger than 65536 rows gets a quantized (non-pow2)
        capacity and still scans exactly."""
        rng = np.random.default_rng(11)
        n = 70_000
        codes = rng.integers(0, 2**63, n, dtype=np.int64).astype(np.uint64)
        bodies = [codes[i].astype(">u8").tobytes() for i in range(n)]
        idx = DeviceNphdIndex(tmp_path / "v")
        idx.add(list(range(n)), bodies)
        (keys, scores), = idx.search([bodies[12345]], 5)
        part = idx._sync_device()[2]
        assert part.cap % 65536 == 0 and part.cap >= n
        assert scores[0] == pytest.approx(1.0)
        assert int.from_bytes(keys[0].tobytes(), "big") == 12345
        want = np.sort(brute_nphd(bodies[12345], bodies))[::-1][:5]
        np.testing.assert_allclose(np.asarray(scores, np.float64), want, atol=1e-6)

    def test_append_after_quantized_build_rebuilds_or_appends(self, tmp_path):
        """Incremental appends stay correct across the quantized capacity."""
        rng = np.random.default_rng(3)
        idx = DeviceNphdIndex(tmp_path / "v")
        bodies = [rng.integers(0, 256, 8, dtype=np.uint8).tobytes() for _ in range(500)]
        idx.add(list(range(500)), bodies)
        idx.search([bodies[0]], 3)  # build partitions
        more = [rng.integers(0, 256, 8, dtype=np.uint8).tobytes() for _ in range(500)]
        idx.add(list(range(500, 1000)), more)
        (keys, scores), = idx.search([more[250]], 1)
        assert int.from_bytes(keys[0].tobytes(), "big") == 750
        assert scores[0] == pytest.approx(1.0)


class TestSearchRawMany:
    def _build(self, tmp_path, n_assets=40, chunks=6, ndim=128):
        rng = np.random.default_rng(5)
        eng = SimprintEngine(tmp_path / "sp", ndim=ndim)
        vecs = {}
        for a in range(n_assets):
            keys, vs = [], []
            for c in range(chunks):
                key = int(a).to_bytes(8, "big") + int(c * 100).to_bytes(4, "big") + int(100).to_bytes(4, "big")
                v = rng.integers(0, 256, ndim // 8, dtype=np.uint8).tobytes()
                keys.append(key)
                vs.append(v)
            eng.add_raw(keys, vs)
            vecs[a] = vs
        return eng, vecs

    def test_many_matches_single(self, tmp_path):
        """Batched multi-asset search returns exactly the per-asset results."""
        eng, vecs = self._build(tmp_path)
        queries = [vecs[3], vecs[17], vecs[31][:2]]
        single = [
            eng.search_raw(q, limit=5, threshold=0.5, detailed=True, total_assets=40)
            for q in queries
        ]
        many = eng.search_raw_many(queries, limit=5, threshold=0.5, detailed=True, total_assets=40)
        assert len(many) == len(single)
        for s, m in zip(single, many):
            assert [(r.iscc_id_body, r.score, r.queried, r.matches) for r in s] == [
                (r.iscc_id_body, r.score, r.queried, r.matches) for r in m
            ]

    def test_many_splits_at_sweep_cap(self, tmp_path, monkeypatch):
        """Batches larger than max_sweep_queries split into multiple sweeps
        without changing results."""
        eng, vecs = self._build(tmp_path)
        monkeypatch.setattr(SimprintEngine, "max_sweep_queries", 4)
        sweeps = []
        orig = eng._index.search

        def counting(bodies, count, return_rows=False):
            sweeps.append(len(bodies))
            return orig(bodies, count, return_rows=return_rows)

        monkeypatch.setattr(eng._index, "search", counting)
        queries = [vecs[0], vecs[1]]  # 12 chunk queries -> 3 sweeps of <=4
        many = eng.search_raw_many(queries, limit=3, total_assets=40)
        assert all(s <= 4 for s in sweeps) and len(sweeps) == 3
        assert many[0][0].iscc_id_body == int(0).to_bytes(8, "big")
        assert many[1][0].iscc_id_body == int(1).to_bytes(8, "big")

    def test_empty_inputs(self, tmp_path):
        eng, vecs = self._build(tmp_path, n_assets=2)
        assert eng.search_raw_many([]) == []
        out = eng.search_raw_many([[], vecs[1], []], limit=3, total_assets=2)
        assert out[0] == [] and out[2] == []
        assert out[1][0].iscc_id_body == int(1).to_bytes(8, "big")
        assert out[1][0].score == pytest.approx(1.0)

    def test_sweep_fn_hook(self, tmp_path):
        """A caller-supplied sweep_fn replaces the direct device sweep."""
        eng, vecs = self._build(tmp_path, n_assets=4)
        calls = []

        def sweep(bodies, count):
            calls.append((len(bodies), count))
            return eng._index.search(bodies, count, return_rows=True)

        res = eng.search_raw(vecs[2], limit=3, sweep_fn=sweep, total_assets=4)
        assert calls and calls[0][0] == len(vecs[2])
        assert res[0].iscc_id_body == int(2).to_bytes(8, "big")


class TestSimprintBatcherWiring:
    def _entry(self, n, body, rng):
        from iscc_search_tpu import codec as ic
        from iscc_search_tpu.schema import IsccEntry
        from tests.conftest import make_iscc_id, make_unit

        return IsccEntry(
            iscc_id=make_iscc_id(n),
            units=[make_unit(ic.MT.DATA, 0, 64), make_unit(ic.MT.INSTANCE, 0, 64)],
            simprints={"CONTENT_TEXT_V0": [
                {"simprint": ic.encode_base64(body), "offset": 0, "size": 100}
            ]},
        )

    def test_sp_search_routes_through_batcher_and_falls_back(self, tmp_path):
        import numpy as np

        from iscc_search_tpu import codec as ic
        from iscc_search_tpu.indexes.tpu import TpuIndex
        from iscc_search_tpu.schema import IsccQuery

        rng = np.random.default_rng(9)
        idx = TpuIndex(tmp_path / "idx", search_batching=True, match_threshold_simprints=0.4)
        try:
            bodies = [rng.integers(0, 256, 16, dtype=np.uint8).tobytes() for _ in range(5)]
            idx.add_assets([self._entry(i, b, rng) for i, b in enumerate(bodies)])
            q = IsccQuery(simprints={"CONTENT_TEXT_V0": [ic.encode_base64(bodies[2])]})
            res = idx.search_assets(q, limit=3)
            assert res.chunk_matches and res.chunk_matches[0].score == pytest.approx(1.0)
            assert "sp:CONTENT_TEXT_V0" in idx._batchers
            # A rebuild closing the batcher mid-flight degrades to unbatched.
            idx._batchers["sp:CONTENT_TEXT_V0"].close()
            res = idx.search_assets(q, limit=3)
            assert res.chunk_matches and res.chunk_matches[0].score == pytest.approx(1.0)
        finally:
            idx.close()

    def test_rebuild_closes_sp_batcher(self, tmp_path):
        import numpy as np

        from iscc_search_tpu import codec as ic
        from iscc_search_tpu.indexes.tpu import TpuIndex
        from iscc_search_tpu.schema import IsccQuery

        rng = np.random.default_rng(10)
        idx = TpuIndex(tmp_path / "idx", search_batching=True, match_threshold_simprints=0.4)
        try:
            bodies = [rng.integers(0, 256, 16, dtype=np.uint8).tobytes() for _ in range(3)]
            idx.add_assets([self._entry(i, b, rng) for i, b in enumerate(bodies)])
            q = IsccQuery(simprints={"CONTENT_TEXT_V0": [ic.encode_base64(bodies[0])]})
            idx.search_assets(q, limit=3)
            old = idx._batchers["sp:CONTENT_TEXT_V0"]
            idx.rebuild([], ["CONTENT_TEXT_V0"])
            assert "sp:CONTENT_TEXT_V0" not in idx._batchers
            assert old._closed
            res = idx.search_assets(q, limit=3)
            assert res.chunk_matches and res.chunk_matches[0].score == pytest.approx(1.0)
        finally:
            idx.close()


class TestBatcherReturnRows:
    def test_return_rows_mode_fuses_and_slices(self, tmp_path):
        import threading

        import numpy as np

        from iscc_search_tpu.engine.batcher import SearchBatcher
        from iscc_search_tpu.engine.device_index import DeviceHammingIndex

        rng = np.random.default_rng(13)
        idx = DeviceHammingIndex(tmp_path / "h")
        keys = [rng.integers(0, 256, 16, dtype=np.uint8).tobytes() for _ in range(64)]
        vecs = [rng.integers(0, 256, 16, dtype=np.uint8).tobytes() for _ in range(64)]
        idx.add(keys, vecs)
        b = SearchBatcher(idx, max_batch=16, window_ms=20.0, return_rows=True)
        try:
            outs = {}

            def call(name, body, count):
                outs[name] = b.search([body], count)

            t1 = threading.Thread(target=call, args=("a", vecs[3], 2))
            t2 = threading.Thread(target=call, args=("b", vecs[7], 5))
            t1.start(); t2.start(); t1.join(); t2.join()
            (k1, s1, r1), = outs["a"]
            (k2, s2, r2), = outs["b"]
            assert len(s1) == 2 and len(s2) == 5  # per-caller count slicing
            assert k1[0].tobytes() == keys[3] and s1[0] == pytest.approx(1.0)
            assert k2[0].tobytes() == keys[7]
            assert idx.body_at(int(r1[0])) == vecs[3]
        finally:
            b.close()
