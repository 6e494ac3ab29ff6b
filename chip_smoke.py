"""
Smoke run of the exact search engine and its served path on one NVIDIA GPU.

Every phase drives the system through the entry points a user calls and
compares what comes out with a plain numpy brute force (XOR + popcount
NPHD), so a wrong row, a wrong score or a lost tombstone fails the run:

0. environment: card name and power limit, JAX version, device kind,
   ``XLA_FLAGS``, the compile-cache directory, optional packages;
1. the NPHD engine at BASELINE config 3: 10,485,760 mixed 64/128/192/256-bit
   units (25/25/10/40 %), about 6 % tombstoned, loaded into
   ``DeviceNphdIndex`` through ``add_packed``; top-10 searches at Q=64 and
   Q=512 and top-1000; 65,536 rows appended after the first sync, some of
   them tombstoned; warm sweep times, peak device memory, the fused scan's
   memory analysis and a sweep over scan chunk rows;
2. the SIMPRINT engine: 10M 128-bit vectors in ``DeviceHammingIndex``;
3. the served path: a ``tpu://`` index opened through ``options.get_index``
   and served by ``server.httpd.serve`` (pooled backend) on a thread of this
   process, 100K assets (the reference's Sandbox profile) added over HTTP,
   search requests checked against the brute force;
4. the tests marked ``gpu`` (``pytest -m gpu``), in this process.

Run from the repository root:

    python chip_smoke.py                # one card, phases 0-4
    python chip_smoke.py --four-cards   # BASELINE config 5 on a 4-card mesh only

It exits non-zero, and prints no result line, when JAX finds no GPU. The
last line of a passing run is one JSON object naming the device. The phase
functions take their sizes as arguments, so a CPU rehearsal can call them at
a tiny size (tests/test_chip_smoke.py).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

import numpy as np

from __graft_entry__ import _brute_force_nphd as brute_force_nphd

CONFIG3_ROWS = 10_485_760
CONFIG3_LANES = (2, 4, 6, 8)  # 64/128/192/256-bit units
CONFIG3_SHARES = (0.25, 0.25, 0.10, 0.40)
TOMBSTONE_SHARE = 0.06
APPEND_ROWS = 65_536
SIMPRINT_ROWS = 10_000_000
SANDBOX_ASSETS = 100_000  # reference Sandbox sizing profile
CONFIG5_ROWS = 100_000_000
CHECKED_QUERIES = 8
SCORE_TOL = 1e-6  # f32 rounding of i / min_bits
CHUNK_SWEEP = (16_384, 32_768, 65_536, 131_072)


def log(msg):
    # type: (str) -> None
    print(msg, flush=True)


def card_line():
    # type: () -> str
    """``name, power.limit`` of the card as nvidia-smi reports them, read in a
    child process that stays off JAX."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


# --------------------------------------------------------------- reference


def check_topk(label, results, ref, count, row_of_keys):
    # type: (str, list, np.ndarray, int, ...) -> None
    """Engine results of the first len(ref) queries against the reference:
    equal sorted score multisets, and each returned row's reference score
    equal to its returned score."""
    for qi in range(ref.shape[0]):
        keys, scores = results[qi][:2]
        live = int(np.count_nonzero(ref[qi] >= 0))
        want = min(count, live)
        if len(scores) != want:
            raise AssertionError(f"{label} q{qi}: {len(scores)} results, expected {want}")
        top = -np.sort(-np.partition(ref[qi], ref.shape[1] - want)[ref.shape[1] - want :])
        got = -np.sort(-np.asarray(scores, np.float64))
        worst = float(np.max(np.abs(got - top))) if want else 0.0
        if worst > SCORE_TOL:
            raise AssertionError(f"{label} q{qi}: score multiset differs from brute force by {worst}")
        rows = row_of_keys(keys)
        if np.any(ref[qi][rows] < 0):
            raise AssertionError(f"{label} q{qi}: returned a tombstoned row")
        worst = float(np.max(np.abs(ref[qi][rows] - scores))) if want else 0.0
        if worst > SCORE_TOL:
            raise AssertionError(f"{label} q{qi}: a returned row's score is off by {worst}")


def _bodies(packed, lanes):
    # type: (np.ndarray, np.ndarray) -> list[bytes]
    return [packed[i, : int(lanes[i])].astype(">u4").tobytes() for i in range(len(packed))]


def _keys8(first, n):
    # type: (int, int) -> np.ndarray
    return np.arange(first, first + n, dtype=">u8").view(np.uint8).reshape(n, 8)


def _rows_of_keys8(keys):
    # type: (np.ndarray) -> np.ndarray
    return np.ascontiguousarray(keys).view(">u8").reshape(-1).astype(np.int64) - 1


def _timed(fn, runs):
    # type: (..., int) -> list[float]
    out = []
    for _ in range(runs):
        t0 = time.perf_counter()
        fn()
        out.append((time.perf_counter() - t0) * 1000.0)
    return out


def _ms(samples):
    # type: (list[float]) -> str
    return f"median {float(np.median(samples))} ms, min {min(samples)} ms ({len(samples)} runs)"


def mixed_rows(rng, n):
    # type: (np.random.Generator, int) -> tuple[np.ndarray, np.ndarray]
    """n random codes at the config-3 width mix: (n, 8) uint32 packed with
    zeroed trailing lanes, and (n,) int32 lane counts."""
    lanes = rng.choice(np.array(CONFIG3_LANES, np.int32), n, p=CONFIG3_SHARES)
    packed = rng.integers(0, 2**32, (n, 8), dtype=np.uint32)
    packed[np.arange(8)[None, :] >= lanes[:, None]] = 0
    return packed, lanes


# ---------------------------------------------------------------- phase 0


def phase_env():
    # type: () -> str
    import jax

    from iscc_search_tpu.compile_cache import ensure_compile_cache

    card = card_line()
    log(f"phase0 card: {card}")
    dev = jax.devices()[0]
    log(f"phase0 jax {jax.__version__}, device_kind {dev.device_kind!r}, platform {dev.platform}, "
        f"devices {len(jax.devices())}")
    log(f"phase0 XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}")
    log(f"phase0 compile cache dir: {ensure_compile_cache()}")
    from importlib import import_module, metadata

    for mod, dist in (("pydantic", "pydantic"), ("platformdirs", "platformdirs"), ("click", "click"),
                      ("rich", "rich"), ("httpx", "httpx"), ("yaml", "PyYAML")):
        try:
            import_module(mod)
        except ImportError:
            log(f"phase0 package {mod}: missing")
            continue
        try:
            version = metadata.version(dist)
        except metadata.PackageNotFoundError:
            version = "present"
        log(f"phase0 package {mod}: {version}")
    return card


# ---------------------------------------------------------------- phase 1


def phase_engine(card, seed, n=CONFIG3_ROWS, n_append=APPEND_ROWS, batches=(64, 512), big_k=1000,
                 chunk_sweep=CHUNK_SWEEP, runs=5):
    # type: (str, int, int, int, tuple, int, tuple, int) -> None
    import jax

    from iscc_search_tpu.engine import DeviceNphdIndex
    from iscc_search_tpu.engine.device_index import _fused_scan_fn
    from iscc_search_tpu.ops.packing import pack_codes

    rng = np.random.default_rng(seed)
    packed, lanes = mixed_rows(rng, n)
    valid = np.ones(n, bool)
    dead = rng.choice(n, int(n * TOMBSTONE_SHARE), replace=False)
    valid[dead] = False
    tag = f"[{card}] phase1"

    with tempfile.TemporaryDirectory() as tmp:
        idx = DeviceNphdIndex(os.path.join(tmp, "units"), shard_size=1 << 40)
        t0 = time.perf_counter()
        idx.add_packed(_keys8(1, n), packed, lanes)
        removed = idx.remove([int(r) + 1 for r in dead])
        if removed != len(dead):
            raise AssertionError(f"removed {removed} of {len(dead)} keys")
        log(f"phase1 loaded {n} rows ({len(dead)} tombstoned) in {time.perf_counter() - t0:.1f} s")

        qmax = max(batches)
        q_rows = rng.choice(np.flatnonzero(valid), qmax, replace=False)
        q_rows[1] = dead[0]  # a tombstoned row's own code must not come back
        queries = _bodies(packed[q_rows], lanes[q_rows])
        ref = brute_force_nphd(packed[q_rows[:CHECKED_QUERIES]], lanes[q_rows[:CHECKED_QUERIES]], packed, lanes, valid)

        for q in batches:
            t0 = time.perf_counter()
            res = idx.search(queries[:q], 10)
            log(f"phase1 Q={q} first search (upload + compile) {time.perf_counter() - t0:.1f} s")
            check_topk(f"phase1 Q={q} k=10", res, ref, 10, _rows_of_keys8)
            log(f"{tag} warm sweep Q={q} k=10: {_ms(_timed(lambda: idx.search(queries[:q], 10), runs))}")
        res = idx.search(queries[: batches[0]], big_k)
        check_topk(f"phase1 Q={batches[0]} k={big_k}", res, ref, big_k, _rows_of_keys8)
        log(f"{tag} warm sweep Q={batches[0]} k={big_k}: "
            f"{_ms(_timed(lambda: idx.search(queries[: batches[0]], big_k), runs))}")
        stats = jax.devices()[0].memory_stats() or {}
        log(f"{tag} peak_bytes_in_use {stats.get('peak_bytes_in_use')}")

        with idx._lock:
            parts = {ln: (p.packed_dev, p.valid_dev, p.row_map, p.cap) for ln, p in idx._sync_device().items()}
        q_codes, q_lanes = pack_codes(queries[:qmax], idx.max_lanes)
        buffers, specs, _ = idx._fused_scan_inputs(parts, 10)
        compiled = _fused_scan_fn().lower(q_codes, q_lanes, buffers, specs).compile()
        log(f"{tag} fused scan Q={qmax} specs (nbits, k, chunk, recall) {specs}")
        log(f"{tag} fused scan memory_analysis: {compiled.memory_analysis()}")

        default_chunk = idx.chunk_rows
        for chunk in chunk_sweep:
            idx.chunk_rows = chunk
            used = [spec[2] for spec in idx._fused_scan_inputs(parts, 10)[1]]
            res = idx.search(queries[:qmax], 10)
            check_topk(f"phase1 chunk {chunk}", res, ref, 10, _rows_of_keys8)
            log(f"{tag} chunk_rows {chunk} (per partition {used}) warm sweep Q={qmax} k=10: "
                f"{_ms(_timed(lambda: idx.search(queries[:qmax], 10), runs))}")
        idx.chunk_rows = default_chunk

        # Append after the first sync: rows land in the existing partitions'
        # headroom (no rebuild), then some of them are tombstoned.
        new_packed, new_lanes = mixed_rows(rng, n_append)
        before = dict(idx._partitions)
        free = {ln: p.cap - p.count for ln, p in before.items()}
        idx.add_packed(_keys8(n + 1, n_append), new_packed, new_lanes)
        packed = np.concatenate([packed, new_packed])
        lanes = np.concatenate([lanes, new_lanes])
        valid = np.concatenate([valid, np.ones(n_append, bool)])
        q_new = n + np.arange(CHECKED_QUERIES // 2)
        idx.search(queries[:8], 10)  # syncs the append
        if any(idx._partitions[ln] is not p for ln, p in before.items()):
            raise AssertionError("phase1 the append rebuilt a partition instead of appending in place")
        left = {ln: p.cap - p.count for ln, p in idx._partitions.items()}
        gone = n + rng.choice(n_append, n_append // 16, replace=False)
        gone = gone[~np.isin(gone, q_new)]
        idx.remove([int(r) + 1 for r in gone])
        valid[gone] = False
        check_rows = np.concatenate([q_new, q_rows[: CHECKED_QUERIES - len(q_new)]])
        check_q = _bodies(packed[check_rows], lanes[check_rows])
        ref2 = brute_force_nphd(packed[check_rows], lanes[check_rows], packed, lanes, valid)
        res = idx.search(check_q + queries[: batches[0] - len(check_q)], 10)
        check_topk("phase1 after append", res, ref2, 10, _rows_of_keys8)
        for qi in range(len(q_new)):
            if res[qi][1][0] < 1.0 - SCORE_TOL:
                raise AssertionError("phase1 an appended row does not find itself")
        log(f"phase1 appended {n_append} rows in place (free rows per partition {free} -> {left}), "
            f"tombstoned {len(gone)}; results match")
        idx.close()
    log("phase1 OK")


# ---------------------------------------------------------------- phase 2


def phase_simprint(card, seed, n=SIMPRINT_ROWS, q=64, runs=5):
    # type: (str, int, int, int, int) -> None
    from iscc_search_tpu.engine import DeviceHammingIndex

    rng = np.random.default_rng(seed + 1)
    packed = rng.integers(0, 2**32, (n, 4), dtype=np.uint32)
    lanes = np.full(n, 4, np.int32)
    keys = np.zeros((n, 16), np.uint8)
    keys[:, :8] = _keys8(1, n)
    with tempfile.TemporaryDirectory() as tmp:
        idx = DeviceHammingIndex(os.path.join(tmp, "simprints"), ndim=128, shard_size=1 << 40)
        idx.add_packed(keys, packed, 4)
        q_rows = rng.choice(n, q, replace=False)
        queries = _bodies(packed[q_rows], lanes[q_rows])
        ref = brute_force_nphd(packed[q_rows[:CHECKED_QUERIES]], lanes[q_rows[:CHECKED_QUERIES]], packed, lanes,
                               np.ones(n, bool))
        res = idx.search(queries, 10)
        check_topk(f"phase2 Q={q} k=10", res, ref, 10, lambda k: _rows_of_keys8(k[:, :8]))
        log(f"[{card}] phase2 warm sweep {n} x 128-bit Q={q} k=10: "
            f"{_ms(_timed(lambda: idx.search(queries, 10), runs))}")
        idx.close()
    log("phase2 OK")


# ---------------------------------------------------------------- phase 3

_UNIT_BITS = (64, 128, 192, 256)


def _unit(mtype, stype, bits, body):
    # type: (int, int, int, bytes) -> str
    from iscc_search_tpu import codec as ic

    return "ISCC:" + ic.encode_component(mtype, stype, 0, bits, body)


def make_assets(rng, n):
    # type: (np.random.Generator, int) -> tuple[list[dict], dict]
    """n assets with a CONTENT-TEXT unit of mixed width, a 64-bit DATA unit,
    a 256-bit INSTANCE unit and three 64-bit CONTENT-TEXT simprints; returns
    the JSON bodies and the unit codes per type for the reference."""
    from iscc_search_tpu import codec as ic

    content_bits = rng.choice(np.array(_UNIT_BITS), n)
    content = rng.integers(0, 2**32, (n, 8), dtype=np.uint32)
    content[np.arange(8)[None, :] >= (content_bits // 32)[:, None]] = 0
    data = rng.integers(0, 2**32, (n, 2), dtype=np.uint32)
    instance = rng.integers(0, 256, (n, 32), dtype=np.uint8)
    sps = rng.integers(0, 256, (n, 3, 8), dtype=np.uint8)
    assets = []
    for i in range(n):
        bits = int(content_bits[i])
        assets.append({
            "iscc_id": ic.gen_iscc_id_v1(timestamp_us=i + 1, server_id=i % 4096)["iscc"],
            "units": [
                _unit(ic.MT.CONTENT, ic.ST_CC.TEXT, bits, content[i, : bits // 32].astype(">u4").tobytes()),
                _unit(ic.MT.DATA, ic.ST.NONE, 64, data[i].astype(">u4").tobytes()),
                _unit(ic.MT.INSTANCE, ic.ST.NONE, 256, instance[i].tobytes()),
            ],
            "simprints": {"CONTENT_TEXT_V0": [
                {"simprint": ic.encode_base64(sps[i, j].tobytes()), "offset": 100 * j, "size": 100}
                for j in range(3)
            ]},
        })
    codes = {
        "CONTENT_TEXT_V0": (content, (content_bits // 32).astype(np.int32)),
        "DATA_NONE_V0": (np.pad(data, ((0, 0), (0, 6))), np.full(n, 2, np.int32)),
    }
    return assets, codes


def _http(method, url, body=None):
    # type: (str, str, object) -> object
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data, method=method, headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=600) as resp:
        raw = resp.read()
    return json.loads(raw) if raw else None


def phase_served(card, seed, n=SANDBOX_ASSETS, batch=1000, n_queries=16, limit=20):
    # type: (str, int, int, int, int, int) -> None
    from iscc_search_tpu.options import SearchOptions
    from iscc_search_tpu.server import httpd

    rng = np.random.default_rng(seed + 2)
    assets, codes = make_assets(rng, n)
    with tempfile.TemporaryDirectory() as tmp:
        # serve() opens the backend through options.get_index, as a
        # deployment does.
        opts = SearchOptions(index_uri=f"tpu://{tmp}", host="127.0.0.1", port=0, http_backend="pooled")
        ready = threading.Event()
        box = {}

        def on_ready(server):
            box["server"] = server
            ready.set()

        def run():
            try:
                httpd.serve(opts, on_ready=on_ready)
            except BaseException as exc:  # surfaced to the main thread below
                box["error"] = exc
                ready.set()

        thread = threading.Thread(target=run, name="smoke-serve", daemon=True)
        thread.start()
        if not ready.wait(300) or "error" in box:
            raise RuntimeError(f"server did not start: {box.get('error')}")
        base = f"http://127.0.0.1:{box['server'].server_port}"
        try:
            _http("POST", f"{base}/indexes", {"name": "smoke"})
            t0 = time.perf_counter()
            for s in range(0, n, batch):
                _http("POST", f"{base}/indexes/smoke/assets", assets[s : s + batch])
            log(f"[{card}] phase3 added {n} assets over HTTP in {time.perf_counter() - t0:.1f} s")
            ids = [a["iscc_id"] for a in assets]
            index_of = {iscc_id: i for i, iscc_id in enumerate(ids)}
            picks = rng.choice(n, n_queries, replace=False)
            lat = []
            for qi in picks:
                query = {"units": assets[qi]["units"], "simprints": {
                    t: [s["simprint"] for s in sp] for t, sp in assets[qi]["simprints"].items()}}
                t0 = time.perf_counter()
                result = _http("POST", f"{base}/indexes/smoke/search?limit={limit}", query)
                lat.append((time.perf_counter() - t0) * 1000.0)
                check_served(result, ids[qi], index_of, codes, opts)
            log(f"[{card}] phase3 search latency over HTTP ({n_queries} requests, limit {limit}): {_ms(lat)}")
        finally:
            box["server"].shutdown()
            thread.join(120)
        if thread.is_alive():
            raise RuntimeError("server thread did not stop")
    log("phase3 OK")


def check_served(result, query_id, index_of, codes, opts):
    # type: (dict, str, dict, dict, ...) -> None
    """One search response against the brute force: the queried asset first
    with score 1.0, matches sorted, each reported unit-type score equal to
    the reference NPHD, each match score the confidence-weighted aggregate
    of its unit scores, and the queried asset first among chunk matches."""
    qi = index_of[query_id]
    matches = result["global_matches"]
    if not matches or matches[0]["iscc_id"] != query_id or abs(matches[0]["score"] - 1.0) > SCORE_TOL:
        raise AssertionError(f"phase3 query asset {qi} is not the first match with score 1.0: {matches[:1]}")
    scores = [m["score"] for m in matches]
    if scores != sorted(scores, reverse=True):
        raise AssertionError("phase3 matches are not sorted by score")
    for m in matches:
        row = index_of[m["iscc_id"]]
        for unit_type, score in m["types"].items():
            if unit_type.startswith("INSTANCE_"):
                continue
            packed, lanes = codes[unit_type]
            ref = brute_force_nphd(packed[qi : qi + 1], lanes[qi : qi + 1], packed[row : row + 1],
                                   lanes[row : row + 1], np.ones(1, bool))[0, 0]
            if abs(ref - score) > SCORE_TOL:
                raise AssertionError(f"phase3 {unit_type} score {score} for {m['iscc_id']} != brute force {ref}")
        confident = [s for s in m["types"].values() if s >= opts.match_threshold_units]
        agg = sum(s**opts.confidence_exponent for s in confident) / sum(confident)
        if abs(agg - m["score"]) > SCORE_TOL:
            raise AssertionError(f"phase3 aggregate score {m['score']} != {agg} from its unit scores")
    chunk = result.get("chunk_matches") or []
    if not chunk or chunk[0]["iscc_id"] != query_id:
        raise AssertionError(f"phase3 query asset {qi} is not the first chunk match")


# ---------------------------------------------------------------- phase 4


class _Outcomes:
    """pytest plugin counting test outcomes."""

    def __init__(self):
        self.counts = {"passed": 0, "failed": 0, "skipped": 0}

    def pytest_runtest_logreport(self, report):
        if report.when == "call" or report.outcome != "passed":
            self.counts[report.outcome] = self.counts.get(report.outcome, 0) + 1


def phase_gpu_tests():
    # type: () -> None
    import jax
    import pytest

    # The test configuration pins the platform; keep the one this process runs on.
    os.environ["ISCC_TEST_PLATFORM"] = jax.config.jax_platforms or jax.devices()[0].platform
    outcomes = _Outcomes()
    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider", "-p", "no:randomly",
                      os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests")], plugins=[outcomes])
    log(f"phase4 gpu tests: {outcomes.counts} (pytest rc {int(rc)})")
    if int(rc) != 0 or outcomes.counts["failed"] or outcomes.counts["skipped"] or not outcomes.counts["passed"]:
        raise AssertionError(f"gpu-marked tests did not all pass on the card: {outcomes.counts}")
    log("phase4 OK")


# ------------------------------------------------------------- four cards


def phase_four_cards(card, seed, n=CONFIG5_ROWS, q=64, runs=5, n_cards=4):
    # type: (str, int, int, int, int, int) -> None
    """BASELINE config 5: uniform 256-bit codes row-sharded over an
    n_cards mesh, sharded scan with the all-gather top-k merge, against the
    brute force; then the cost of the pow2-per-shard capacity padding."""
    import jax
    import jax.numpy as jnp

    from iscc_search_tpu.engine import DeviceNphdIndex
    from iscc_search_tpu.ops.pm1_scan import prepare_queries_device
    from iscc_search_tpu.parallel import make_mesh
    from iscc_search_tpu.parallel.pm1_sharded import sharded_pm1_topk

    mesh = make_mesh(n_cards)
    rng = np.random.default_rng(seed + 3)
    packed = rng.integers(0, 2**32, (n, 8), dtype=np.uint32)
    lanes = np.full(n, 8, np.int32)
    tag = f"[{card}] four-cards"
    with tempfile.TemporaryDirectory() as tmp:
        idx = DeviceNphdIndex(os.path.join(tmp, "units"), mesh=mesh, shard_size=1 << 40)
        t0 = time.perf_counter()
        idx.add_packed(_keys8(1, n), packed, 8)
        q_rows = rng.choice(n, q, replace=False)
        queries = _bodies(packed[q_rows], lanes[q_rows])
        res = idx.search(queries, 10)
        log(f"four-cards loaded {n} rows and ran the first search in {time.perf_counter() - t0:.1f} s")
        ref = brute_force_nphd(packed[q_rows[:CHECKED_QUERIES]], lanes[q_rows[:CHECKED_QUERIES]], packed, lanes,
                               np.ones(n, bool))
        check_topk(f"four-cards Q={q} k=10", res, ref, 10, _rows_of_keys8)
        log(f"{tag} warm sweep {n} x 256-bit Q={q} k=10: {_ms(_timed(lambda: idx.search(queries, 10), runs))}")
        part = idx._partitions[8]
        cap = part.cap
        idx.close()

    # Padding cost: the engine rounds each shard up to a power of two; scan
    # the same number of shards at that size and at the smallest
    # chunk-aligned size that holds the rows.
    chunk = 32768
    aligned = -(-n // n_cards // chunk) * chunk
    q_packed = jnp.asarray(packed[q_rows])
    q_pm1, q_scale = prepare_queries_device(q_packed, jnp.full((q,), 8, jnp.int32), 256)
    key = jax.random.PRNGKey(seed)
    for per_shard in sorted({cap // n_cards, aligned}):
        rows = per_shard * n_cards
        sharding = jax.sharding.NamedSharding(mesh, jax.sharding.PartitionSpec(mesh.axis_names, None))
        db = jax.jit(lambda k: jax.random.bits(k, (rows, 8), jnp.uint32), out_shardings=sharding)(key)
        vs = jax.jit(lambda: jnp.ones((rows,), bool),
                     out_shardings=jax.sharding.NamedSharding(mesh, jax.sharding.PartitionSpec(mesh.axis_names)))()

        def sweep():
            s, _ = sharded_pm1_topk(mesh, q_pm1, q_scale, db, vs, 16, 256, chunk_size=min(chunk, per_shard),
                                    merge_k=16)
            np.asarray(s)

        sweep()
        log(f"{tag} padding: {per_shard} rows per shard ({rows} total, engine capacity {cap} for {n} rows): "
            f"{_ms(_timed(sweep, runs))}")
        del db, vs
    log("four-cards OK")


# ------------------------------------------------------------------- main


def main(argv=None):
    # type: (list[str] | None) -> int
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--seed", type=int, default=0, help="seed of every generated dataset")
    parser.add_argument("--four-cards", action="store_true",
                        help="run only BASELINE config 5 on a 4-card mesh (needs 4 GPUs)")
    args = parser.parse_args(argv)

    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"chip_smoke: needs an NVIDIA GPU, JAX found {devices[0].platform}", file=sys.stderr)
        return 2
    n_cards = 4 if args.four_cards else 1
    if len(devices) < n_cards:
        print(f"chip_smoke: --four-cards needs 4 GPUs, JAX found {len(devices)}", file=sys.stderr)
        return 2

    card = phase_env()
    if args.four_cards:
        phase_four_cards(card, args.seed, n_cards=n_cards)
    else:
        phase_engine(card, args.seed)
        phase_simprint(card, args.seed)
        phase_served(card, args.seed)
        phase_gpu_tests()
    log(f"card: {card_line()}")
    dev = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {"platform": dev.platform, "kind": dev.device_kind,
                                             "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
