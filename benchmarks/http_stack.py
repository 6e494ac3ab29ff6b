"""HTTP-stack ceiling: max QPS through the server with the app stubbed out.

Isolates the serving transport from the engine: the WSGI app returns a
canned search response without touching any index. Run each server flavor
in a subprocess (GIL isolation from the load generator) and load it with
raw-socket keep-alive clients.

Usage:
    python benchmarks/http_stack.py            # compare server flavors
    python benchmarks/http_stack.py --serve wsgiref|pool  # (internal)
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import threading
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

PORT = 18431
BODY = json.dumps({"units": ["ISCC:GABW5LUACIDN3QSFY7EGVQ6ZWMQGY"]}).encode()
CANNED = json.dumps(
    {
        "query": {"units": ["ISCC:GABW5LUACIDN3QSFY7EGVQ6ZWMQGY"]},
        "global_matches": [
            {"iscc_id": "ISCC:MAIATETDPXBL7OKD", "score": 0.93, "types": {"DATA_NONE_V0": 0.93}}
        ]
        * 10,
        "chunk_matches": [],
    }
).encode()


def stub_app(environ, start_response):
    # Read the body like the real app would
    try:
        length = int(environ.get("CONTENT_LENGTH") or 0)
    except ValueError:
        length = 0
    if length:
        environ["wsgi.input"].read(length)
    start_response("200 OK", [("Content-Type", "application/json"), ("Content-Length", str(len(CANNED)))])
    return [CANNED]


CANNED_DICT = json.loads(CANNED)


class _StubResult:
    def model_dump(self, **_kw):
        return CANNED_DICT


class _StubIndex:
    """Engine-side stub: instant search, so only the IPC/transport is timed."""

    def search_assets(self, name, query, limit=100):
        return _StubResult()


def _rpc_stub_app(rpc):
    """Worker-side app: body parse + one engine RPC round trip per request
    (the production scaleout data path minus pydantic route handling)."""

    def app(environ, start_response):
        try:
            length = int(environ.get("CONTENT_LENGTH") or 0)
        except ValueError:
            length = 0
        qdict = json.loads(environ["wsgi.input"].read(length)) if length else {}
        result = rpc.search_assets("x", qdict, 10)
        payload = json.dumps(result.model_dump()).encode()
        start_response(
            "200 OK",
            [("Content-Type", "application/json"), ("Content-Length", str(len(payload)))],
        )
        return [payload]

    return app


def serve(flavor):
    if flavor == "scaleout":
        # Engine process: stub index over the real unix-socket IPC + N real
        # pooled workers doing one RPC per request.
        import tempfile

        from iscc_search_tpu.server.scaleout import EngineIPCServer

        sock_path = os.path.join(tempfile.mkdtemp(prefix="iscc-stack-"), "engine.sock")
        ipc = EngineIPCServer(_StubIndex(), sock_path)
        ipc.start()
        workers = [
            subprocess.Popen(
                [sys.executable, __file__, "--serve", "scaleout-worker"],
                env={**os.environ, "ISCC_STACK_SOCK": sock_path, "JAX_PLATFORMS": "cpu"},
            )
            for _ in range(int(os.environ.get("ISCC_STACK_WORKERS", "4")))
        ]
        import signal

        def _term(_s, _f):
            for w in workers:
                w.terminate()

        signal.signal(signal.SIGTERM, _term)
        try:
            for w in workers:
                w.wait()
        finally:
            ipc.close()
        return
    if flavor == "scaleout-worker":
        from iscc_search_tpu.server.pooled import PooledHTTPServer
        from iscc_search_tpu.server.scaleout import EngineRPCIndex, reuseport_socket

        rpc = EngineRPCIndex(os.environ["ISCC_STACK_SOCK"])
        if not rpc.ping(timeout=10.0):
            raise SystemExit("engine IPC not reachable")
        sock = reuseport_socket("127.0.0.1", PORT)
        srv = PooledHTTPServer("127.0.0.1", PORT, _rpc_stub_app(rpc), threads=16, sock=sock)
        srv.serve_forever()
        return
    if flavor == "wsgiref":
        from wsgiref.simple_server import make_server

        from iscc_search_tpu.server.httpd import QuietHandler, ThreadingWSGIServer

        srv = make_server("127.0.0.1", PORT, stub_app, server_class=ThreadingWSGIServer, handler_class=QuietHandler)
        srv.serve_forever()
    elif flavor == "pool":
        from iscc_search_tpu.server.pooled import PooledHTTPServer

        srv = PooledHTTPServer("127.0.0.1", PORT, stub_app, threads=16)
        srv.serve_forever()
    else:
        raise SystemExit(f"unknown flavor {flavor}")


REQ = (
    b"POST /indexes/x/search HTTP/1.1\r\n"
    b"Host: 127.0.0.1\r\n"
    b"Content-Type: application/json\r\n"
    b"Content-Length: %d\r\n"
    b"\r\n%s" % (len(BODY), BODY)
)


def client_loop(n_reqs, keepalive, counts, idx):
    done = 0
    sock = None
    buf = b""

    def connect():
        s = socket.create_connection(("127.0.0.1", PORT))
        s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        return s

    while done < n_reqs:
        try:
            if sock is None:
                sock = connect()
                buf = b""
            sock.sendall(REQ)
            # Read one response: headers + content-length body
            while b"\r\n\r\n" not in buf:
                chunk = sock.recv(65536)
                if not chunk:
                    raise ConnectionError("closed")
                buf += chunk
            head, rest = buf.split(b"\r\n\r\n", 1)
            clen = 0
            for line in head.split(b"\r\n"):
                if line.lower().startswith(b"content-length:"):
                    clen = int(line.split(b":")[1])
            while len(rest) < clen:
                chunk = sock.recv(65536)
                if not chunk:
                    raise ConnectionError("closed")
                rest += chunk
            buf = rest[clen:]
            done += 1
            keep = b"connection: close" not in head.lower()
            if not keepalive or not keep:
                sock.close()
                sock = None
        except (ConnectionError, OSError):
            sock = None
    counts[idx] = done


def load(flavor, clients=16, n_per_client=2000, keepalive=True):
    # The stub servers own no index: keep them off the card.
    proc = subprocess.Popen([sys.executable, __file__, "--serve", flavor], env={**os.environ, "JAX_PLATFORMS": "cpu"})
    try:
        for _ in range(100):
            try:
                socket.create_connection(("127.0.0.1", PORT), timeout=0.2).close()
                break
            except OSError:
                time.sleep(0.1)
        counts = [0] * clients
        threads = [
            threading.Thread(target=client_loop, args=(n_per_client, keepalive, counts, i))
            for i in range(clients)
        ]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        dt = time.perf_counter() - t0
        total = sum(counts)
        print(
            f"{flavor:8s} keepalive={keepalive}: {total} reqs in {dt:.1f}s = "
            f"{total / dt:,.0f} QPS ({clients} clients)",
            flush=True,
        )
        return total / dt
    finally:
        proc.terminate()
        proc.wait()


if __name__ == "__main__":
    if "--serve" in sys.argv:
        serve(sys.argv[sys.argv.index("--serve") + 1])
    else:
        flavors = sys.argv[1:] or ["wsgiref", "pool", "scaleout"]
        for flavor in flavors:
            for ka in (True, False) if flavor != "scaleout" else (True,):
                try:
                    load(flavor, keepalive=ka)
                except Exception as exc:
                    print(f"{flavor} keepalive={ka}: FAILED {exc}", flush=True)
