"""
Multi-config benchmark harness (BASELINE.json configs).

Measures on the active JAX device:
  1. 100K x 64-bit units, exact Hamming/NPHD top-10   (memory:// parity scale)
  2. 1M x 256-bit units, exact NPHD top-k + snapshot persistence
  3. 10M variable-length units, NPHD top-k            (headline; see bench.py)
  4. SIMPRINT granular: assets x ~100 chunks, per-chunk match + aggregation
  5. sharded scan dry-run                              (virtual mesh unless real)
plus index build rate (codes/sec pack-and-append).

Writes benchmarks/RESULTS.json. Scale with ISCC_BENCH_SCALE (default 1.0).

Run: PYTHONPATH=. python benchmarks/run_all.py
"""

import json
import os
import time
from pathlib import Path

import numpy as np


def amortized(fn, repeat=5):
    # type: (..., int) -> float
    """Best amortized seconds per call (async dispatch, one readback)."""
    out = fn()
    np.asarray(out[0] if isinstance(out, tuple) else out)
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        for _r in range(repeat):
            out = fn()
        np.asarray(out[0] if isinstance(out, tuple) else out)
        best = min(best, (time.perf_counter() - t0) / repeat)
    return best


def main():
    import jax
    import jax.numpy as jnp

    from iscc_search_tpu.ops.pm1_scan import pm1_blockmax_topk, prepare_queries

    scale = float(os.environ.get("ISCC_BENCH_SCALE", 1.0))
    rng = np.random.default_rng(0)
    results = {"device": str(jax.devices()[0]), "scale": scale}

    # ---- config 1: 100K x 64-bit, exact top-10 ----
    n1 = max(8192, int(102_400 * scale)) // 8192 * 8192
    packed = np.zeros((n1, 2), np.uint32)
    packed[:] = rng.integers(0, 2**32, (n1, 2), dtype=np.uint32)
    q = 64
    qi = (np.arange(q) * (n1 // q))
    q_pm1, q_scale = prepare_queries(packed[qi], np.full(q, 2, np.int32), 64)
    db_d = jax.device_put(jnp.asarray(packed))
    valid_d = jax.device_put(jnp.asarray(np.ones(n1, bool)))
    qp, qs = jnp.asarray(q_pm1), jnp.asarray(q_scale)
    dt = amortized(lambda: pm1_blockmax_topk(qp, qs, db_d, valid_d, 10, 64, chunk_size=8192))
    results["config1_100k_64bit"] = {"n": n1, "batch": q, "sweep_ms": round(dt * 1e3, 3), "qps": round(q / dt)}

    # ---- config 2: 1M x 256-bit, exact + snapshot persistence ----
    from iscc_search_tpu.engine import DeviceNphdIndex

    n2 = max(65536, int(1_048_576 * scale)) // 32768 * 32768
    bodies_arr = rng.integers(0, 256, (n2, 32), dtype=np.uint8)
    bodies = [bodies_arr[i].tobytes() for i in range(n2)]
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        idx = DeviceNphdIndex(Path(tmp) / "i")
        t0 = time.perf_counter()
        B = 100_000
        for s in range(0, n2, B):
            idx.add(list(range(s, min(s + B, n2))), bodies[s : min(s + B, n2)])
        build_s = time.perf_counter() - t0
        results["build_rate_codes_per_s"] = round(n2 / build_s)
        t0 = time.perf_counter()
        idx.save()
        results["snapshot_save_s"] = round(time.perf_counter() - t0, 2)

        qbod = [bodies[i] for i in range(0, n2, n2 // 64)][:64]
        t0 = time.perf_counter()
        res = idx.search(qbod, 10)
        first = time.perf_counter() - t0
        t0 = time.perf_counter()
        res = idx.search(qbod, 10)
        warm = time.perf_counter() - t0
        assert int.from_bytes(res[0][0][0].tobytes(), "big") == 0
        results["config2_1m_256bit"] = {
            "n": n2,
            "engine_search_first_ms": round(first * 1e3, 1),
            "engine_search_warm_ms": round(warm * 1e3, 1),
            "engine_qps_warm": round(64 / warm),
        }
        t0 = time.perf_counter()
        idx2 = DeviceNphdIndex(Path(tmp) / "i")
        results["snapshot_load_s"] = round(time.perf_counter() - t0, 2)
        assert idx2.size == n2
        idx2.close()
        idx.close()

    # ---- config 3: variable-length units (64-256 bit), engine-level ----
    # BASELINE config 3 is variable-length; bench.py measures the fixed
    # 256-bit kernel, this measures the length-partitioned engine search.
    n3 = max(131072, int(2_097_152 * scale)) // 65536 * 65536
    lens = rng.choice([8, 16, 24, 32], n3, p=[0.25, 0.25, 0.1, 0.4])
    bodies3_arr = rng.integers(0, 256, (n3, 32), dtype=np.uint8)
    bodies3 = [bodies3_arr[i, : lens[i]].tobytes() for i in range(n3)]
    with tempfile.TemporaryDirectory() as tmp:
        idx3 = DeviceNphdIndex(Path(tmp) / "v")
        B = 200_000
        for s in range(0, n3, B):
            idx3.add(list(range(s, min(s + B, n3))), bodies3[s : min(s + B, n3)])
        qsel = [bodies3[i] for i in range(0, n3, n3 // 64)][:64]
        idx3.search(qsel, 10)  # warm-up/compile (one partition per length)
        t0 = time.perf_counter()
        res3 = idx3.search(qsel, 10)
        warm3 = time.perf_counter() - t0
        assert all(r[1][0] >= 0.999 for r in res3), "self-match failed"
        results["config3_varlen"] = {
            "n": n3,
            "lengths": "64/128/192/256-bit mixed",
            "engine_search_warm_ms": round(warm3 * 1e3, 1),
            "engine_qps_warm": round(64 / warm3),
        }
        idx3.close()

    # ---- end-to-end TpuIndex ingest rate (store + derived indexes) ----
    from iscc_search_tpu import codec as ic_codec
    from iscc_search_tpu.indexes.tpu import TpuIndex
    from iscc_search_tpu.schema import IsccEntry

    n_ing = max(2000, int(20_000 * scale))

    def _unit(mt):
        body = rng.integers(0, 256, 8, dtype=np.uint8).tobytes()
        h = ic_codec.encode_header(mt, 0, 0, ic_codec.encode_length(mt, 64))
        return "ISCC:" + ic_codec.encode_base32(h + body)

    ing_entries = [
        IsccEntry(
            iscc_id=ic_codec.gen_iscc_id_v1(i + 1, 0, 0)["iscc"],
            units=[_unit(ic_codec.MT.CONTENT), _unit(ic_codec.MT.DATA), _unit(ic_codec.MT.INSTANCE)],
        )
        for i in range(n_ing)
    ]
    with tempfile.TemporaryDirectory() as tmp:
        tix = TpuIndex(Path(tmp) / "ing", search_batching=False)
        t0 = time.perf_counter()
        for s in range(0, n_ing, 1000):
            tix.add_assets(ing_entries[s : s + 1000])
        dt = time.perf_counter() - t0
        results["tpuindex_ingest_assets_per_s"] = round(n_ing / dt)
        tix.close()

    # ---- config 4: SIMPRINT granular (scaled) ----
    from iscc_search_tpu.engine.simprint import SimprintEngine

    # ISCC_BENCH_SP_ASSETS scales config 4 independently (BASELINE config 4
    # is 1M assets x ~100 chunks; the default keeps the full run short)
    n_assets = int(os.environ.get("ISCC_BENCH_SP_ASSETS", max(512, int(10_000 * scale))))
    chunks_per = 100
    with tempfile.TemporaryDirectory() as tmp:
        sp = SimprintEngine(Path(tmp) / "sp", ndim=128)
        keys, vecs = [], []
        sp_arr = rng.integers(0, 256, (n_assets * chunks_per, 16), dtype=np.uint8)
        for a in range(n_assets):
            body = a.to_bytes(8, "big")
            for c in range(chunks_per):
                keys.append(body + (c * 100).to_bytes(4, "big") + (100).to_bytes(4, "big"))
                vecs.append(sp_arr[a * chunks_per + c].tobytes())
        t0 = time.perf_counter()
        sp.add_raw(keys, vecs)
        sp_build = time.perf_counter() - t0
        query = [vecs[5], vecs[105], vecs[205]]
        matches = sp.search_raw(query, limit=10, threshold=0.5, total_assets=n_assets)  # warm-up/compile
        t0 = time.perf_counter()
        matches = sp.search_raw(query, limit=10, threshold=0.5, total_assets=n_assets)
        sp_search = time.perf_counter() - t0
        assert matches, "simprint search returned nothing"
        results["config4_simprint"] = {
            "assets": n_assets,
            "chunks": len(keys),
            "build_rate_chunks_per_s": round(len(keys) / sp_build),
            "search_3q_ms": round(sp_search * 1e3, 1),
        }
        sp.close()

    # Fold the separately-measured 10M cold start (benchmarks/coldstart_10m.py,
    # run in its own process because it times open->first-query from scratch)
    # into the summary so RESULTS.json carries the full picture.
    cold_path = Path(__file__).parent / "COLDSTART_10M.json"
    if cold_path.exists():
        results["coldstart_10m"] = json.loads(cold_path.read_text())

    # Reduced-scale runs land in a scale-suffixed file so RESULTS.json only
    # ever holds full-scale numbers — mixing scales across commits made the
    # recorded history incomparable.
    name = "RESULTS.json" if scale == 1.0 else f"RESULTS_scale{scale}.json"
    out_path = Path(__file__).parent / name
    out_path.write_text(json.dumps(results, indent=2))
    print(json.dumps(results, indent=2))


if __name__ == "__main__":
    main()
