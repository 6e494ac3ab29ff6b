"""
Measured HNSW baseline for the "vs usearch" comparison (BASELINE.md).

The reference's engine (iscc-usearch, a patched unum-cloud/usearch C++ HNSW)
is not installable in this environment, so the north-star comparison cannot
be run directly. This script provides the honest substitute the comparison
links to:

1. A real HNSW (numpy-vectorized distances, standard insert/search with an
   efConstruction beam) over NPHD-metric 256-bit codes, MEASURED at small N:
   build rate, single-core QPS, recall@10 vs brute force, and — the key
   instrument — DISTANCE EVALUATIONS PER QUERY.
2. An explicit extrapolation model for native C++ HNSW at 10M codes:
   evals/query grow ~log(N); a native implementation pays ~50-150 ns per
   eval (32-byte XOR+popcount plus a dependent graph-pointer load from a
   working set far beyond LLC at 10M). Native single-core QPS estimate =
   1 / (evals(10M) x ns_per_eval). Both bounds are reported.

Run: PYTHONPATH=. python benchmarks/hnsw_baseline.py   (CPU only)
Writes benchmarks/HNSW_BASELINE.json.
"""

import json
import os
import time
from pathlib import Path

import numpy as np

M = 16  # graph degree (reference default: options.py units connectivity 16)
M0 = 32  # level-0 degree
EF_CONSTRUCTION = 128  # reference default expansion_add
EF_SEARCH = 64  # reference default expansion_search
K = 10


class NphdHnsw:
    """Minimal-but-real HNSW over packed 256-bit codes, NPHD distance."""

    def __init__(self, capacity):
        self.codes = np.zeros((capacity, 4), np.uint64)
        self.levels = np.zeros(capacity, np.int32)
        self.links = []  # per node: list over levels of np.ndarray neighbor ids
        self.count = 0
        self.entry = -1
        self.max_level = -1
        self.rng = np.random.default_rng(0)
        self.evals = 0  # distance evaluations (profiling instrument)

    def dist(self, q, ids):
        # type: (np.ndarray, np.ndarray) -> np.ndarray
        self.evals += len(ids)
        x = np.bitwise_xor(self.codes[ids], q[None, :])
        return np.bitwise_count(x).sum(axis=1).astype(np.float32) / 256.0

    def _search_layer(self, q, entry, level, ef):
        # type: (np.ndarray, int, int, int) -> list[tuple[float, int]]
        d0 = float(self.dist(q, np.array([entry]))[0])
        visited = {entry}
        cands = [(d0, entry)]  # ascending candidate heap (list-based; ef small)
        best = [(d0, entry)]  # ascending result list, trimmed to ef
        while cands:
            cd, cid = min(cands)
            cands.remove((cd, cid))
            if cd > best[-1][0] and len(best) >= ef:
                break
            nbrs = self.links[cid][level]
            fresh = np.array([n for n in nbrs if n not in visited], np.int64)
            if not len(fresh):
                continue
            visited.update(fresh.tolist())
            dists = self.dist(q, fresh)
            for d, n in zip(dists.tolist(), fresh.tolist()):
                if len(best) < ef or d < best[-1][0]:
                    best.append((d, n))
                    best.sort()
                    del best[ef:]
                    cands.append((d, n))
        return best

    def add(self, code):
        # type: (np.ndarray) -> None
        node = self.count
        self.count += 1
        self.codes[node] = code
        level = int(-np.log(self.rng.uniform(1e-12, 1.0)) / np.log(M))
        self.levels[node] = level
        self.links.append([np.zeros(0, np.int64) for _ in range(level + 1)])
        if self.entry < 0:
            self.entry = node
            self.max_level = level
            return
        ep = self.entry
        for lvl in range(self.max_level, level, -1):
            ep = self._search_layer(code, ep, lvl, 1)[0][1]
        for lvl in range(min(level, self.max_level), -1, -1):
            found = self._search_layer(code, ep, lvl, EF_CONSTRUCTION)
            cap = M0 if lvl == 0 else M
            chosen = [n for _, n in found[:cap]]
            self.links[node][lvl] = np.array(chosen, np.int64)
            for n in chosen:  # reverse links with degree pruning
                nl = self.links[n][lvl]
                if len(nl) < cap:
                    self.links[n][lvl] = np.append(nl, node)
                else:
                    ids = np.append(nl, node)
                    d = self.dist(self.codes[n], ids)
                    self.links[n][lvl] = ids[np.argsort(d)[:cap]]
            ep = found[0][1]
        if level > self.max_level:
            self.max_level = level
            self.entry = node

    def search(self, code, k, ef=EF_SEARCH):
        # type: (np.ndarray, int, int) -> list[tuple[float, int]]
        ep = self.entry
        for lvl in range(self.max_level, 0, -1):
            ep = self._search_layer(code, ep, lvl, 1)[0][1]
        return self._search_layer(code, ep, 0, max(ef, k))[:k]


def main():
    n = int(os.environ.get("ISCC_HNSW_N", 200_000))
    nq = int(os.environ.get("ISCC_HNSW_Q", 200))
    rng = np.random.default_rng(3)
    codes = rng.integers(0, 2**64, (n, 4), dtype=np.uint64)  # full 64-bit range

    idx = NphdHnsw(n)
    t0 = time.perf_counter()
    for i in range(n):
        idx.add(codes[i])
    build_s = time.perf_counter() - t0

    # Queries: noisy near-duplicates of db rows (realistic workload)
    q_rows = rng.integers(0, n, nq)
    queries = codes[q_rows].copy()
    noise = (
        rng.integers(0, 2**64, (nq, 4), dtype=np.uint64)
        & rng.integers(0, 2**64, (nq, 4), dtype=np.uint64)
        & rng.integers(0, 2**64, (nq, 4), dtype=np.uint64)
    )
    queries ^= noise

    # Ground truth via brute force, TIE-AWARE: include every row whose
    # distance equals the k-th best (integer distances tie at the boundary;
    # an HNSW returning an equally-distant different id is correct, and
    # counting it as a miss would deflate the COMPETITOR's recall in the
    # published comparison — the bias would run in our favor).
    truth = []
    for qi in range(nq):
        ham = np.bitwise_count(np.bitwise_xor(codes, queries[qi][None, :])).sum(axis=1)
        kth = np.partition(ham, K - 1)[K - 1]
        truth.append(set(np.flatnonzero(ham <= kth).tolist()))

    sweeps = {}
    for ef in (64, 128, 256):
        idx.evals = 0
        t0 = time.perf_counter()
        results = [idx.search(queries[qi], K, ef=ef) for qi in range(nq)]
        search_s = time.perf_counter() - t0
        hits = sum(len({nid for _, nid in res} & truth[qi]) for qi, res in enumerate(results))
        sweeps[ef] = {
            "qps_single_core": round(nq / search_s, 1),
            "recall_at_10": round(hits / (nq * K), 4),
            "distance_evals_per_query": round(idx.evals / nq),
        }
    # headline numbers from the reference default ef
    evals_per_query = sweeps[EF_SEARCH]["distance_evals_per_query"]
    recall = sweeps[EF_SEARCH]["recall_at_10"]
    search_s = nq / sweeps[EF_SEARCH]["qps_single_core"]

    # --- extrapolation model for native C++ HNSW at 10M codes -------------
    n_target = 10_485_760
    evals_10m = evals_per_query * np.log(n_target) / np.log(n)
    native = {
        "assumed_ns_per_eval": [50, 150],
        "evals_per_query_at_10m": round(float(evals_10m)),
        "single_core_qps_range": [
            round(1e9 / (evals_10m * 150)),
            round(1e9 / (evals_10m * 50)),
        ],
        "model": "evals/query ~ log(N); native eval = 32B XOR+popcount + dependent "
        "graph pointer load (working set >> LLC at 10M); QPS = 1/(evals x ns)",
        "bias": "this HNSW lacks usearch's neighbor-diversity heuristic, so its "
        "evals-for-recall are a LOWER bound on what recall>=0.9 costs; the native "
        "QPS range is therefore an UPPER bound (conservative for our comparison)",
    }

    out = {
        "n": n,
        "queries": nq,
        "k": K,
        "params": {"M": M, "M0": M0, "ef_construction": EF_CONSTRUCTION, "ef_search": EF_SEARCH},
        "python_hnsw": {
            "build_s": round(build_s, 1),
            "build_codes_per_s": round(n / build_s),
            "qps_single_core": round(nq / search_s, 1),
            "recall_at_10": round(recall, 4),
            "distance_evals_per_query": round(evals_per_query),
            "ef_sweep": sweeps,
        },
        "native_hnsw_estimate_at_10m": native,
        "note": "usearch/iscc-usearch is not installable here (the comparison links "
        "this file as the measured+modeled stand-in for the BASELINE.md north star)",
    }
    Path(__file__).with_name("HNSW_BASELINE.json").write_text(json.dumps(out, indent=2))
    print(json.dumps(out, indent=2))


if __name__ == "__main__":
    main()
