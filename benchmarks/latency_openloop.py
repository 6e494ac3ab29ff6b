"""
Open-loop serving benchmark: offered-load sweep to find saturation QPS.

Closed-loop client pools measure latency AT a concurrency level but can't say where the server saturates — the clients
slow down with the server (coordinated omission). This harness fires
requests on a fixed schedule regardless of completions, sweeps the offered
rate, and reports achieved throughput + latency percentiles per step; the
saturation point is the last step where achieved >= 95% of offered.

Process topology (every piece GIL-isolated):
- the SERVER runs in its own process (same-interpreter load generation
  collapses to the combined python ceiling — round-3 lesson),
- the LOAD spreads over ISCC_OL_CLIENT_PROCS client subprocesses with
  persistent keep-alive connections (a single urllib client process caps
  near 1k QPS of pure request-building overhead and would understate the
  pooled/scale-out servers).

Run: PYTHONPATH=. python benchmarks/latency_openloop.py
Knobs: ISCC_OL_ASSETS (200_000), ISCC_OL_SECONDS (12 per step),
       ISCC_OL_RATES (csv, default "100,200,400,800,1600,3200"),
       ISCC_OL_TOPOLOGY (wsgiref | pooled | scaleout; default pooled),
       ISCC_OL_WORKERS (scaleout worker processes, default 4),
       ISCC_OL_CLIENT_PROCS (default 4),
       ISCC_OL_BULK (1 = flagship-scale corpus via the bulk primitives;
       pair with ISCC_OL_ASSETS=10485760 for the headline 10.5M index),
       ISCC_OL_SUFFIX (artifact name override, e.g. "_10M")
Writes benchmarks/LATENCY_OPENLOOP<suffix>.json.
"""

import json
import os
import socket
import subprocess
import sys
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

TOPOLOGY = os.environ.get("ISCC_OL_TOPOLOGY", "pooled")


def build_index(n_assets, tmp_dir=None):
    from iscc_search_tpu import codec as ic
    from iscc_search_tpu.options import SearchOptions, get_index
    from iscc_search_tpu.schema import IsccEntry, IsccIndex

    rng = np.random.default_rng(0)
    tmp_dir = tmp_dir or tempfile.mkdtemp()
    opts = SearchOptions(index_uri=f"tpu://{tmp_dir}")
    index = get_index(opts.index_uri)
    index.create_index(IsccIndex(name="ol"))

    if os.environ.get("ISCC_OL_BULK") == "1":
        _bulk_fill(index, n_assets)
        return index, opts, None

    def unit(mt, body):
        header = ic.encode_header(mt, 0, ic.VS.V0, ic.encode_length(mt, len(body) * 8))
        return "ISCC:" + ic.encode_base32(header + body)

    bodies = [rng.integers(0, 256, 32, dtype=np.uint8).tobytes() for _ in range(n_assets)]
    batch = []
    for i, body in enumerate(bodies):
        iscc_id = ic.gen_iscc_id_v1(timestamp_us=i + 1, server_id=i % 4096, realm_id=0)["iscc"]
        batch.append(
            IsccEntry(iscc_id=iscc_id, units=[unit(ic.MT.DATA, body), unit(ic.MT.INSTANCE, body[:8])])
        )
        if len(batch) == 50_000:
            index.add_assets("ol", batch)
            batch = []
    if batch:
        index.add_assets("ol", batch)
    return index, opts, bodies


def _bulk_fill(manager, n_assets, unit_type="DATA_NONE_V0"):
    """Flagship-scale corpus (ISCC_OL_BULK=1) through the product's own bulk
    primitives: store putmulti / dup_putmulti_arrays for the truth rows and
    the vectorized device add_packed the rebuild path uses — the same
    structures add_assets produces, at memcpy-bound rates (the per-asset
    add_assets path would take ~20 min for the 10.5M headline corpus).

    Bodies are regenerated per slice with the SAME deterministic stream the
    query builder uses (one rng seed, 32 bytes/asset), so queries remain db
    members without holding 10.5M bodies in this process."""
    import struct as _struct
    import json as _json

    from iscc_search_tpu import codec as ic
    from iscc_search_tpu.models import IsccID

    idx = manager._get_or_load_index("ol")
    # Persist the realm the way _init_metadata would have on first add.
    if idx._realm_id is None:
        idx._realm_id = 0
        idx.store.put("meta", b"realm_id", _struct.pack(">I", 0))
    nphd = idx._new_nphd_index(unit_type)
    rng = np.random.default_rng(0)
    slice_n = 262_144
    data_hdr = ic.encode_header(ic.MT.DATA, 0, ic.VS.V0, ic.encode_length(ic.MT.DATA, 256))
    inst_hdr = ic.encode_header(ic.MT.INSTANCE, 0, ic.VS.V0, ic.encode_length(ic.MT.INSTANCE, 64))
    for a0 in range(0, n_assets, slice_n):
        a1 = min(a0 + slice_n, n_assets)
        bodies = rng.integers(0, 256, (a1 - a0, 32), dtype=np.uint8)
        keys_int = []
        asset_pairs = []
        for i in range(a0, a1):
            b = bodies[i - a0].tobytes()
            iscc_id = ic.gen_iscc_id_v1(timestamp_us=i + 1, server_id=i % 4096, realm_id=0)["iscc"]
            key = int(IsccID(iscc_id))
            keys_int.append(key)
            units = ["ISCC:" + ic.encode_base32(data_hdr + b), "ISCC:" + ic.encode_base32(inst_hdr + b[:8])]
            asset_pairs.append(
                (key.to_bytes(8, "big"), _json.dumps({"iscc_id": iscc_id, "units": units}).encode())
            )
        idx.store.putmulti("assets", asset_pairs)
        key_arr = np.array(keys_int, dtype=">u8").view(np.uint8).reshape(-1, 8)
        idx.store.dup_putmulti_arrays("instance", bodies[:, :8], key_arr)
        packed = bodies.reshape(-1, 8, 4).view(">u4")[..., 0].astype(np.uint32)
        nphd.add_packed(key_arr, packed, 8)
        print(f"bulk build: {a1}/{n_assets}", flush=True)
    idx.store.flush()
    idx._nphd_indexes[unit_type] = nphd
    idx._set_count(b"nphd_count:", unit_type, nphd.size)


# --------------------------------------------------------------- server child


def serve_forever(port_file):
    # type: (str) -> None
    """Child-process mode: build the index, serve, report the port."""
    n_assets = int(os.environ.get("ISCC_OL_ASSETS", 200_000))

    if TOPOLOGY == "scaleout":
        # Engine + SO_REUSEPORT workers: build the corpus, release the
        # single-process handle, then run the scale-out topology on it.
        from iscc_search_tpu.options import SearchOptions
        from iscc_search_tpu.server.scaleout import serve_scaleout

        tmp_dir = tempfile.mkdtemp()
        index, opts, _bodies = build_index(n_assets, tmp_dir)
        index.close()
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
        s.close()
        opts = SearchOptions(
            index_uri=f"tpu://{tmp_dir}",
            host="127.0.0.1",
            port=port,
            workers=int(os.environ.get("ISCC_OL_WORKERS", 4)),
            http_threads=64,
        )
        with open(port_file, "w") as f:
            f.write(str(port))
        serve_scaleout(opts)
        return

    from iscc_search_tpu.server.app import create_app

    index, opts, _bodies = build_index(n_assets)
    app = create_app(index=index, opts=opts)
    if TOPOLOGY == "pooled":
        from iscc_search_tpu.server.pooled import PooledHTTPServer

        srv = PooledHTTPServer("127.0.0.1", 0, app, threads=64)
        with open(port_file, "w") as f:
            f.write(str(srv.server_port))
        srv.serve_forever()
    else:
        from wsgiref.simple_server import make_server

        from iscc_search_tpu.server.httpd import QuietHandler, ThreadingWSGIServer

        srv = make_server(
            "127.0.0.1", 0, app, server_class=ThreadingWSGIServer, handler_class=QuietHandler
        )
        with open(port_file, "w") as f:
            f.write(str(srv.server_address[1]))
        srv.serve_forever()


# --------------------------------------------------------------- client child


def client_main(port, rate, seconds, nthreads, out_file, query_file):
    # type: (int, float, float, int, str, str) -> None
    """Open-loop load from one client process over keep-alive connections.

    Thread j fires request k at t0 + (j + k*nthreads)/rate; latency counts
    from the SCHEDULED send time (no coordinated omission: if the server
    lags, queueing shows up in the percentiles, not in a slower schedule).
    """
    queries = [q.encode() for q in json.load(open(query_file))]
    n_total = int(rate * seconds)
    latencies = []
    errors = [0]
    sheds = [0]  # 503 responses — deliberate overload shedding, not failures
    lock = threading.Lock()
    t0 = time.perf_counter() + 0.5  # all threads share one epoch

    def make_req(body):
        return (
            b"POST /indexes/ol/search?limit=10 HTTP/1.1\r\nHost: 127.0.0.1\r\n"
            b"Content-Type: application/json\r\nContent-Length: %d\r\n\r\n%s" % (len(body), body)
        )

    def run(j):
        sock = None
        buf = b""
        local_lat = []
        local_err = 0
        local_shed = 0
        k = j
        while k < n_total:
            body = queries[k % len(queries)]
            scheduled = t0 + k / rate
            now = time.perf_counter()
            if scheduled > now:
                time.sleep(scheduled - now)
            try:
                if sock is None:
                    sock = socket.create_connection(("127.0.0.1", port), timeout=30)
                    sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                    sock.settimeout(30)
                    buf = b""
                sock.sendall(make_req(body))
                while b"\r\n\r\n" not in buf:
                    data = sock.recv(65536)
                    if not data:
                        raise ConnectionError("closed")
                    buf += data
                head, rest = buf.split(b"\r\n\r\n", 1)
                status = int(head.split(b" ", 2)[1])
                clen = 0
                for line in head.split(b"\r\n"):
                    if line.lower().startswith(b"content-length:"):
                        clen = int(line.split(b":")[1])
                while len(rest) < clen:
                    data = sock.recv(65536)
                    if not data:
                        raise ConnectionError("closed")
                    rest += data
                buf = rest[clen:]
                if status == 503:
                    local_shed += 1
                    if b"connection: close" in head.lower():
                        sock.close()
                        sock = None
                    k += nthreads
                    continue
                if status != 200:
                    raise ConnectionError(f"HTTP {status}")
                local_lat.append(time.perf_counter() - scheduled)
                if b"connection: close" in head.lower():
                    sock.close()
                    sock = None
            except (OSError, ConnectionError, ValueError):
                local_err += 1
                if sock is not None:
                    try:
                        sock.close()
                    except OSError:
                        pass
                    sock = None
            k += nthreads
        if sock is not None:
            sock.close()
        with lock:
            latencies.extend(local_lat)
            errors[0] += local_err
            sheds[0] += local_shed

    threads = [threading.Thread(target=run, args=(j,)) for j in range(nthreads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    with open(out_file, "w") as f:
        json.dump({"latencies": latencies, "errors": errors[0], "sheds": sheds[0], "wall": wall}, f)


def _client_env():
    # type: () -> dict
    """Load-generator env: pure-host python pinned to the CPU backend — only
    the server process owns the card (a second JAX process on it would
    reserve device memory the server needs)."""
    return dict(os.environ, JAX_PLATFORMS="cpu")


def run_step(port, query_file, rate, seconds, n_procs):
    # type: (int, str, float, float, int) -> dict
    """One offered-load step across n_procs client subprocesses."""
    outs = []
    procs = []
    env = _client_env()
    for i in range(n_procs):
        out = tempfile.mktemp(prefix=f"ol_out_{i}_")
        outs.append(out)
        procs.append(
            subprocess.Popen(
                [
                    sys.executable,
                    __file__,
                    "--client",
                    str(port),
                    str(rate / n_procs),
                    str(seconds),
                    "64",
                    out,
                    query_file,
                ],
                env=env,
            )
        )
    for p in procs:
        p.wait()
    latencies = []
    errors = 0
    sheds = 0
    wall = 0.0
    for out in outs:
        data = json.load(open(out))
        latencies.extend(data["latencies"])
        errors += data["errors"]
        sheds += data.get("sheds", 0)
        wall = max(wall, data["wall"])
        os.unlink(out)
    lat = np.array(sorted(latencies)) * 1e3
    return {
        "offered_qps": rate,
        "achieved_qps": round(len(latencies) / wall, 1) if wall else 0.0,
        "errors": errors,
        "sheds": sheds,
        "p50_ms": round(float(np.percentile(lat, 50)), 1) if len(lat) else None,
        "p90_ms": round(float(np.percentile(lat, 90)), 1) if len(lat) else None,
        "p99_ms": round(float(np.percentile(lat, 99)), 1) if len(lat) else None,
    }


# --------------------------------------------------------------------- parent


def main():
    n_assets = int(os.environ.get("ISCC_OL_ASSETS", 200_000))
    seconds = float(os.environ.get("ISCC_OL_SECONDS", 12))
    rates = [float(r) for r in os.environ.get("ISCC_OL_RATES", "100,200,400,800,1600,3200").split(",")]
    n_client_procs = int(os.environ.get("ISCC_OL_CLIENT_PROCS", 4))

    from iscc_search_tpu import codec as ic

    port_file = tempfile.mktemp(prefix="ol_port_")
    server = subprocess.Popen([sys.executable, __file__, "--serve", port_file])
    try:
        print(f"waiting for the server subprocess to build {n_assets:,} assets...", flush=True)
        deadline = time.time() + 1800
        port = None
        while time.time() < deadline:
            if os.path.exists(port_file):
                port = int(open(port_file).read())
                break
            if server.poll() is not None:
                raise RuntimeError("server subprocess died during index build")
            time.sleep(1.0)
        assert port, "server never became ready"

        def unit(mt, body):
            header = ic.encode_header(mt, 0, ic.VS.V0, ic.encode_length(mt, len(body) * 8))
            return "ISCC:" + ic.encode_base32(header + body)

        # Same generator seed AND draw shape as the build: queries are db
        # members. (Draw shape matters: the bulk path consumes the stream in
        # 262,144-row blocks; per-asset draws would produce a different
        # sequence.)
        rng = np.random.default_rng(1)
        sel = sorted(int(i) for i in rng.integers(0, n_assets, 512))
        rng0 = np.random.default_rng(0)
        sampled = {}
        if os.environ.get("ISCC_OL_BULK") == "1":
            slice_n = 262_144
            for a0 in range(0, n_assets, slice_n):
                blk = rng0.integers(0, 256, (min(slice_n, n_assets - a0), 32), dtype=np.uint8)
                for s in sel:
                    if a0 <= s < a0 + len(blk):
                        sampled[s] = blk[s - a0].tobytes()
        else:
            bodies = [rng0.integers(0, 256, 32, dtype=np.uint8).tobytes() for _ in range(n_assets)]
            sampled = {s: bodies[s] for s in sel}
        queries = []
        for i in sel:
            q = {"units": [unit(3, sampled[i])]}  # MT.DATA = 3; limit rides
            # the query string (a body "limit" is not part of IsccQuery and
            # was silently ignored — earlier sweeps actually served limit=100)
            queries.append(json.dumps(q))
        query_file = tempfile.mktemp(prefix="ol_queries_")
        with open(query_file, "w") as f:
            json.dump(queries, f)

        # Readiness: one long-timeout search forces the device compile
        # before the sweep.
        import urllib.request

        def fire(body):
            req = urllib.request.Request(
                f"http://127.0.0.1:{port}/indexes/ol/search?limit=10",
                data=body.encode() if isinstance(body, str) else body,
                headers={"Content-Type": "application/json"},
            )
            for _ in range(20):
                try:
                    with urllib.request.urlopen(req, timeout=900) as res:
                        res.read()
                    return
                except urllib.error.HTTPError as exc:
                    # Warm bursts intentionally exceed the admission bound;
                    # 503 sheds are the overload policy working, not failures.
                    if exc.code != 503:
                        raise
                    time.sleep(0.2)
            raise RuntimeError("warm-up request shed 20 times - server wedged?")

        # The port file appears before workers finish binding (scaleout
        # writes it ahead of the blocking serve call): poll readiness first.
        ready_deadline = time.time() + 180
        while True:
            try:
                with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz", timeout=2) as res:
                    res.read()
                break
            except OSError:
                if time.time() > ready_deadline:
                    raise RuntimeError("server never answered /healthz")
                time.sleep(0.5)
        fire(queries[0])
        print("server compiled + ready", flush=True)

        # Warm EVERY query-pad bucket the batcher can produce: fusion sizes
        # grow with offered load, and each pow2 pad bucket (8..256) is a
        # separate device compile. Without
        # this, the first mid-step bucket crossing stalls every queued
        # request behind one compile and poisons the percentiles.
        pool = ThreadPoolExecutor(max_workers=512)
        for conc in (8, 16, 32, 64, 128, 256, 512):
            t0 = time.perf_counter()
            list(pool.map(fire, queries[: min(conc, len(queries))]))
            print(f"warm burst conc={conc}: {time.perf_counter()-t0:.1f}s", flush=True)

        warm = run_step(port, query_file, 50, 2, 1)
        print(f"warm: {warm}", flush=True)
        # Second warm at the first sweep rate with the REAL client topology:
        # the first multi-proc step otherwise absorbs one-off costs (client
        # process spawn + import, any residual fusion-shape compile) as a
        # fake early knee.
        warm2 = run_step(port, query_file, rates[0], 3, n_client_procs)
        print(f"warm2: {warm2}", flush=True)

        steps = []
        saturation = None
        fails = 0  # CONSECUTIVE below-95% steps. Keep sweeping 2 steps past
        # the knee: the artifact must show OVERLOAD behavior (sheds rise,
        # p50 of served stays bounded), not just where the knee is. A single
        # transient-stalled step (one device recompile / host hiccup) must
        # not poison the sweep — a later clean step at a HIGHER rate proves
        # the earlier failure was noise, so the counter resets.
        for rate in rates:
            step = run_step(port, query_file, rate, seconds, n_client_procs)
            steps.append(step)
            print(step, flush=True)
            if step["achieved_qps"] >= 0.95 * rate and step["errors"] == 0:
                saturation = step
                fails = 0
            else:
                fails += 1
                if fails >= 2:
                    break

        out = {
            "description": (
                f"Open-loop offered-load sweep through the full HTTP stack, {n_assets} assets, "
                f"single-unit queries, fixed-schedule arrivals (no coordinated omission); "
                f"topology={TOPOLOGY}; server and each of the {n_client_procs} keep-alive load "
                "generators run in their own processes (GIL isolation). 'sheds' are deliberate "
                "503 + Retry-After overload responses (admission bound + queue deadline); past "
                "saturation the server sheds instead of queueing unboundedly, so p50 of SERVED "
                "requests stays bounded"
            ),
            "assets": n_assets,
            "topology": TOPOLOGY,
            "bulk_build": os.environ.get("ISCC_OL_BULK") == "1",
            "step_seconds": seconds,
            "overload_policy": {  # what the spawned server actually runs with
                "http_max_pending": int(os.environ.get("ISCC_SEARCH_HTTP_MAX_PENDING", 64)),
                "http_queue_deadline_ms": float(
                    os.environ.get("ISCC_SEARCH_HTTP_QUEUE_DEADLINE_MS", 500.0)
                ),
            },
            "steps": steps,
            "saturation_qps": saturation["offered_qps"] if saturation else None,
            "saturation_detail": saturation,
        }
        if TOPOLOGY == "scaleout":
            affinity = getattr(os, "sched_getaffinity", None)
            cores = len(affinity(0)) if affinity is not None else (os.cpu_count() or 1)
            out["core_guard"] = {
                "host_runnable_cores": cores,
                "forced": os.environ.get("ISCC_SEARCH_SCALEOUT_FORCE") == "1",
                "note": (
                    "scale-out needs >= workers+1 cores; on fewer the guard shrinks the worker "
                    "count or falls back to single-process pooled serving. A forced run on an "
                    "undersized host measures the overload/shedding path, not scale-out speedup."
                ),
            }
        print(json.dumps(out, indent=1))
        suffix = os.environ.get(
            "ISCC_OL_SUFFIX", {"wsgiref": "", "pooled": "_POOLED", "scaleout": "_SCALEOUT"}[TOPOLOGY]
        )
        with open(f"benchmarks/LATENCY_OPENLOOP{suffix}.json", "w") as f:
            json.dump(out, f, indent=1)
        os.unlink(query_file)
    finally:
        server.terminate()
        server.wait(60)
        try:
            os.unlink(port_file)
        except OSError:
            pass


if __name__ == "__main__":
    if len(sys.argv) > 2 and sys.argv[1] == "--serve":
        serve_forever(sys.argv[2])
    elif len(sys.argv) > 2 and sys.argv[1] == "--client":
        client_main(
            int(sys.argv[2]),
            float(sys.argv[3]),
            float(sys.argv[4]),
            int(sys.argv[5]),
            sys.argv[6],
            sys.argv[7],
        )
    else:
        main()
