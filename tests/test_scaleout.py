"""Scale-out serving: engine IPC protocol + multi-process end-to-end."""

import json
import os
import signal
import socket
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

import httpx
import pytest

from iscc_search_tpu.indexes.memory import MemoryIndex
from iscc_search_tpu.schema import IsccEntry, IsccIndex, IsccQuery
from iscc_search_tpu.server.scaleout import EngineIPCServer, EngineRPCIndex


@pytest.fixture
def ipc_pair(tmp_path):
    index = MemoryIndex()
    sock_path = str(tmp_path / "engine.sock")
    server = EngineIPCServer(index, sock_path)
    server.start()
    client = EngineRPCIndex(sock_path)
    assert client.ping()
    yield index, client
    client.close()
    server.close()


def test_rpc_full_protocol(ipc_pair, entry_factory):
    _, client = ipc_pair
    created = client.create_index(IsccIndex(name="rpc"))
    assert created.name == "rpc"
    assert [i.name for i in client.list_indexes()] == ["rpc"]
    assert client.get_index("rpc").name == "rpc"

    entry = IsccEntry(**entry_factory())
    results = client.add_assets("rpc", [entry])
    assert results[0].iscc_id == entry.iscc_id

    got = client.get_asset("rpc", entry.iscc_id)
    assert got.iscc_code == entry.iscc_code

    result = client.search_assets("rpc", IsccQuery(iscc_code=entry.iscc_code), 10)
    dumped = result.model_dump(mode="json", exclude_none=True)
    assert dumped["global_matches"][0]["iscc_id"] == entry.iscc_id

    client.delete_index("rpc")
    assert client.list_indexes() == []


def test_rpc_exception_relay(ipc_pair):
    _, client = ipc_pair
    with pytest.raises(FileNotFoundError):
        client.get_index("missing")
    client.create_index(IsccIndex(name="dup"))
    with pytest.raises(FileExistsError):
        client.create_index(IsccIndex(name="dup"))
    with pytest.raises(FileNotFoundError):
        client.get_asset("dup", "ISCC:MAIGIIFJRDGEQQAB")


def test_rpc_unknown_method_rejected(ipc_pair):
    _, client = ipc_pair
    with pytest.raises(ValueError):
        client._roundtrip(("call", "close", ()))
    with pytest.raises(ValueError):
        client._roundtrip(("bogus",))


def test_rpc_concurrent_threads(ipc_pair, entry_factory):
    _, client = ipc_pair
    client.create_index(IsccIndex(name="conc"))
    entry = IsccEntry(**entry_factory())
    client.add_assets("conc", [entry])
    errors = []

    def worker():
        try:
            for _ in range(30):
                r = client.search_assets("conc", IsccQuery(iscc_code=entry.iscc_code), 5)
                assert r.model_dump()["global_matches"]
        except Exception as exc:  # pragma: no cover
            errors.append(exc)

    threads = [threading.Thread(target=worker) for _ in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30)
    assert not errors


def test_rpc_reconnect_after_drop(ipc_pair):
    _, client = ipc_pair
    assert client.ping()
    # Kill the client's thread-local connection behind its back
    client._local.conn.close()
    assert client.ping()  # reconnects transparently


SCALEOUT_MAIN = """
import sys
from iscc_search_tpu.options import SearchOptions
from iscc_search_tpu.server.scaleout import serve_scaleout

opts = SearchOptions(
    index_uri="memory://",
    host="127.0.0.1",
    port=int(sys.argv[1]),
    workers=2,
    http_threads=4,
)
serve_scaleout(opts)
"""


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_scaleout_end_to_end(tmp_path, entry_factory):
    """Two real worker processes + engine: CRUD + search over HTTP, then
    graceful SIGTERM shutdown."""
    port = _free_port()
    script = tmp_path / "main.py"
    script.write_text(SCALEOUT_MAIN)
    repo_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(
        os.environ,
        JAX_PLATFORMS="cpu",
        PYTHONPATH=repo_root + os.pathsep + os.environ.get("PYTHONPATH", ""),
    )
    proc = subprocess.Popen([sys.executable, str(script), str(port)], env=env)
    base = f"http://127.0.0.1:{port}"
    try:
        deadline = time.time() + 60
        while time.time() < deadline:
            try:
                with urllib.request.urlopen(f"{base}/healthz", timeout=1) as res:
                    if json.load(res)["status"] == "ok":
                        break
            except OSError:
                time.sleep(0.25)
        else:
            pytest.fail("scale-out server did not come up")

        with httpx.Client(base_url=base) as client:
            assert client.post("/indexes", json={"name": "so"}).status_code == 201
            entry = entry_factory()
            assert client.post("/indexes/so/assets", json=[entry]).status_code == 201
            # Both workers must serve reads of the same engine state: spread
            # requests over fresh connections so SO_REUSEPORT distributes them
            for _ in range(8):
                r = client.post("/indexes/so/search", json={"iscc_code": entry["iscc_code"]})
                assert r.status_code == 200
                assert r.json()["global_matches"][0]["iscc_id"] == entry["iscc_id"]
            r = client.get("/indexes")
            assert [i["name"] for i in r.json()] == ["so"]
    finally:
        proc.send_signal(signal.SIGTERM)
        try:
            code = proc.wait(30)
        except subprocess.TimeoutExpired:
            proc.kill()
            pytest.fail("scale-out parent did not exit on SIGTERM")
    assert code == 0


def test_scaleout_worker_respawn(tmp_path, entry_factory):
    """A killed worker is respawned and service continues."""
    port = _free_port()
    script = tmp_path / "main.py"
    script.write_text(SCALEOUT_MAIN)
    repo_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(
        os.environ,
        JAX_PLATFORMS="cpu",
        PYTHONPATH=repo_root + os.pathsep + os.environ.get("PYTHONPATH", ""),
    )
    proc = subprocess.Popen([sys.executable, str(script), str(port)], env=env)
    base = f"http://127.0.0.1:{port}"
    try:
        deadline = time.time() + 60
        while time.time() < deadline:
            try:
                with urllib.request.urlopen(f"{base}/healthz", timeout=1) as res:
                    if json.load(res)["status"] == "ok":
                        break
            except OSError:
                time.sleep(0.25)
        else:
            pytest.fail("scale-out server did not come up")

        # Find the worker children and kill one
        children = subprocess.run(
            ["pgrep", "-P", str(proc.pid)], capture_output=True, text=True
        ).stdout.split()
        assert len(children) == 2, children
        os.kill(int(children[0]), signal.SIGKILL)
        time.sleep(1.5)  # respawn loop ticks every 0.5s

        ok = 0
        for _ in range(12):
            try:
                with urllib.request.urlopen(f"{base}/healthz", timeout=2) as res:
                    if json.load(res)["status"] == "ok":
                        ok += 1
            except OSError:
                time.sleep(0.25)
        assert ok >= 10  # service continuity through the kill + respawn
        children_after = subprocess.run(
            ["pgrep", "-P", str(proc.pid)], capture_output=True, text=True
        ).stdout.split()
        assert len(children_after) == 2, children_after
    finally:
        proc.send_signal(signal.SIGTERM)
        try:
            proc.wait(30)
        except subprocess.TimeoutExpired:
            proc.kill()


# -------------------------------------------------- in-process coverage legs


def test_worker_main_in_process(tmp_path, monkeypatch):
    """worker_main boots against a live engine IPC and serves requests —
    driven in-process with an injected pre-bound socket port."""
    from iscc_search_tpu.server import pooled as pooled_mod
    from iscc_search_tpu.server import scaleout as so

    index = MemoryIndex()
    sock_path = str(tmp_path / "e.sock")
    engine = EngineIPCServer(index, sock_path)
    engine.start()

    cfg = {
        "opts": {"index_uri": "memory://", "host": "127.0.0.1", "port": 0, "http_threads": 2},
        "socket_path": sock_path,
    }
    monkeypatch.setenv("ISCC_SCALEOUT_CONFIG", json.dumps(cfg))

    srv_box = {}
    real_serve_forever = pooled_mod.PooledHTTPServer.serve_forever

    def capture_serve(self):
        srv_box["srv"] = self
        return real_serve_forever(self)

    monkeypatch.setattr(pooled_mod.PooledHTTPServer, "serve_forever", capture_serve)
    t = threading.Thread(target=so.worker_main, daemon=True)
    t.start()
    deadline = time.time() + 15
    while "srv" not in srv_box and time.time() < deadline:
        time.sleep(0.05)
    srv = srv_box["srv"]
    with urllib.request.urlopen(f"http://127.0.0.1:{srv.server_port}/healthz", timeout=5) as res:
        assert json.load(res)["status"] == "ok"
    # Index calls flow through the RPC to the engine-side MemoryIndex
    body = json.dumps({"name": "wm"}).encode()
    req = urllib.request.Request(
        f"http://127.0.0.1:{srv.server_port}/indexes",
        data=body,
        headers={"Content-Type": "application/json"},
    )
    with urllib.request.urlopen(req, timeout=5) as res:
        assert res.status == 201
    assert [i.name for i in index.list_indexes()] == ["wm"]
    srv.shutdown()
    t.join(10)
    assert not t.is_alive()
    engine.close()


def test_worker_main_engine_unreachable(tmp_path, monkeypatch):
    from iscc_search_tpu.server import scaleout as so

    cfg = {
        "opts": {"index_uri": "memory://", "host": "127.0.0.1", "port": 0},
        "socket_path": str(tmp_path / "missing.sock"),
    }
    monkeypatch.setenv("ISCC_SCALEOUT_CONFIG", json.dumps(cfg))
    monkeypatch.setattr(so.EngineRPCIndex, "ping", lambda self, timeout=30.0: False)
    with pytest.raises(SystemExit):
        so.worker_main()


def test_serve_scaleout_in_process(tmp_path, monkeypatch):
    """serve_scaleout's orchestration loop with fake worker processes:
    spawn, one crash + respawn, stop via injected event, full cleanup."""
    from iscc_search_tpu.server import scaleout as so

    spawned = []

    class FakeProc:
        def __init__(self):
            self.pid = 4000 + len(spawned)
            self._polls = 0
            self.terminated = False

        def poll(self):
            # The first fake worker "crashes" permanently: drives the
            # respawn arm exactly once (the monitor replaces it in-place)
            if self.pid == 4000:
                return 1
            return None

        def terminate(self):
            self.terminated = True

        def wait(self, timeout=None):
            return 0

    def fake_popen(cmd, env=None, preexec_fn=None):
        assert "iscc_search_tpu.server.worker" in " ".join(cmd)
        assert env["JAX_PLATFORMS"] == "cpu"
        assert "ISCC_SCALEOUT_CONFIG" in env
        proc = FakeProc()
        spawned.append(proc)
        return proc

    monkeypatch.setattr(so.subprocess, "Popen", fake_popen)
    stop = threading.Event()
    opts_kw = dict(index_uri=f"tpu://{tmp_path}/so", host="127.0.0.1", port=_free_port(), workers=2)
    from iscc_search_tpu.options import SearchOptions

    def stopper():
        deadline = time.time() + 15
        while len(spawned) < 3 and time.time() < deadline:  # 2 + 1 respawn
            time.sleep(0.05)
        stop.set()

    killer = threading.Thread(target=stopper, daemon=True)
    killer.start()
    so.serve_scaleout(SearchOptions(**opts_kw), stop=stop)
    killer.join(5)
    assert len(spawned) >= 3  # respawn happened
    assert all(p.terminated for p in spawned if p.poll() is None)


def test_serve_scaleout_port_in_use(tmp_path):
    from iscc_search_tpu.options import SearchOptions
    from iscc_search_tpu.server import scaleout as so

    blocker = socket.socket()
    blocker.bind(("127.0.0.1", 0))
    blocker.listen(1)
    port = blocker.getsockname()[1]
    try:
        with pytest.raises(OSError):
            so.serve_scaleout(
                SearchOptions(index_uri="memory://", host="127.0.0.1", port=port, workers=2)
            )
    finally:
        blocker.close()


def test_httpd_serve_dispatches_to_scaleout(monkeypatch):
    """httpd.serve() routes workers>1 to serve_scaleout without touching
    the index or binding anything itself."""
    from iscc_search_tpu.options import SearchOptions
    from iscc_search_tpu.server import httpd as httpd_mod
    from iscc_search_tpu.server import scaleout as so

    called = []
    monkeypatch.setattr(so, "serve_scaleout", lambda opts, stop=None: called.append(opts))
    monkeypatch.setattr(
        httpd_mod, "get_index", lambda uri: pytest.fail("engine index must not open here"), raising=False
    )
    httpd_mod.serve(SearchOptions(index_uri="memory://", workers=3))
    assert called and called[0].workers == 3


def test_worker_module_imports():
    """The -m entry module is importable (its __main__ arm runs only as a
    subprocess, exercised by the e2e tests)."""
    import iscc_search_tpu.server.worker as w

    assert w.worker_main is not None


@pytest.mark.parametrize("backend", ["pooled", "wsgiref"])
def test_httpd_serve_bind_failure_closes_index(monkeypatch, backend):
    """A failed public-port bind must close the just-opened index and raise
    (nothing else may have started), on both transport backends."""
    from iscc_search_tpu.options import SearchOptions
    from iscc_search_tpu.server import httpd as httpd_mod

    blocker = socket.socket()
    blocker.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    blocker.bind(("127.0.0.1", 0))
    blocker.listen(1)
    port = blocker.getsockname()[1]

    closed = []

    class FakeIndex:
        def close(self):
            closed.append(True)

    monkeypatch.setattr("iscc_search_tpu.options.get_index", lambda uri: FakeIndex())
    try:
        with pytest.raises(OSError):
            httpd_mod.serve(
                SearchOptions(index_uri="memory://", host="127.0.0.1", port=port, http_backend=backend)
            )
        assert closed == [True]
    finally:
        blocker.close()


def test_recv_frame_oversized_rejected():
    from iscc_search_tpu.server import scaleout as so

    a, b = socket.socketpair()
    try:
        a.sendall(so._HEADER.pack(so._MAX_FRAME + 1))
        with pytest.raises(ConnectionError, match="oversized"):
            so._recv_frame(b)
    finally:
        a.close()
        b.close()


def test_recv_frame_peer_closed_mid_frame():
    from iscc_search_tpu.server import scaleout as so

    a, b = socket.socketpair()
    try:
        a.sendall(so._HEADER.pack(100) + b"short")
        a.close()
        with pytest.raises(ConnectionError, match="mid-frame"):
            so._recv_frame(b)
    finally:
        b.close()


def test_recv_exact_spans_multiple_chunks():
    from iscc_search_tpu.server import scaleout as so

    a, b = socket.socketpair()
    try:
        payload = b"x" * 5000
        import pickle

        frame = pickle.dumps(payload, protocol=5)
        a.sendall(so._HEADER.pack(len(frame)))
        # Dribble the payload so _recv_exact loops
        half = len(frame) // 2
        a.sendall(frame[:half])
        t = threading.Thread(target=lambda: (time.sleep(0.05), a.sendall(frame[half:])), daemon=True)
        t.start()
        assert so._recv_frame(b) == payload
        t.join(2)
    finally:
        a.close()
        b.close()


def test_rpc_search_accepts_plain_dict_query(ipc_pair, entry_factory):
    _, client = ipc_pair
    client.create_index(IsccIndex(name="dictq"))
    entry = IsccEntry(**entry_factory())
    client.add_assets("dictq", [entry])
    result = client.search_assets("dictq", {"iscc_code": entry.iscc_code}, 5)
    assert result.model_dump()["global_matches"][0]["iscc_id"] == entry.iscc_id


def test_ping_times_out_without_engine(tmp_path):
    client = EngineRPCIndex(str(tmp_path / "never.sock"))
    t0 = time.monotonic()
    assert client.ping(timeout=0.3) is False
    assert time.monotonic() - t0 < 5


SCALEOUT_DEVICE_MAIN = """
import sys
from iscc_search_tpu.options import SearchOptions
from iscc_search_tpu.server.scaleout import serve_scaleout

opts = SearchOptions(
    index_uri="tpu://" + sys.argv[2],
    host="127.0.0.1",
    port=int(sys.argv[1]),
    workers=2,
    http_threads=4,
)
serve_scaleout(opts)
"""


def test_scaleout_device_backend_end_to_end(tmp_path, entry_factory):
    """Scale-out over the real device engine (CPU jax): adds and NPHD
    searches flow worker -> RPC -> engine -> batcher -> scan."""
    port = _free_port()
    script = tmp_path / "main.py"
    script.write_text(SCALEOUT_DEVICE_MAIN)
    repo_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(
        os.environ,
        JAX_PLATFORMS="cpu",
        PYTHONPATH=repo_root + os.pathsep + os.environ.get("PYTHONPATH", ""),
    )
    data_dir = tmp_path / "idx"
    proc = subprocess.Popen([sys.executable, str(script), str(port), str(data_dir)], env=env)
    base = f"http://127.0.0.1:{port}"
    try:
        deadline = time.time() + 90
        while time.time() < deadline:
            try:
                with urllib.request.urlopen(f"{base}/healthz", timeout=1) as res:
                    if json.load(res)["status"] == "ok":
                        break
            except OSError:
                time.sleep(0.25)
        else:
            pytest.fail("scale-out device server did not come up")

        with httpx.Client(base_url=base, timeout=120) as client:
            assert client.post("/indexes", json={"name": "dev"}).status_code == 201
            entries = [entry_factory() for _ in range(8)]
            assert client.post("/indexes/dev/assets", json=entries).status_code == 201
            # Similarity search (not exact-code): exercises the NPHD scan
            r = client.post(
                "/indexes/dev/search", json={"units": [entries[3]["units"][0]], "limit": 5}
            )
            assert r.status_code == 200
            got = [m["iscc_id"] for m in r.json()["global_matches"]]
            assert entries[3]["iscc_id"] in got
            # get_asset through RPC
            r = client.get(f"/indexes/dev/assets/{entries[0]['iscc_id']}")
            assert r.status_code == 200
    finally:
        proc.send_signal(signal.SIGTERM)
        try:
            code = proc.wait(60)
        except subprocess.TimeoutExpired:
            proc.kill()
            pytest.fail("device scale-out did not exit on SIGTERM")
    assert code == 0
    # The engine flushed its segments on shutdown (durability contract)
    assert (data_dir / "dev").exists()


def test_serve_scaleout_rejects_port_zero(tmp_path):
    """Port 0 gives every SO_REUSEPORT worker its OWN ephemeral port (the
    kernel only balances sockets bound to the same port) — no single
    endpoint would exist; reject before opening the index."""
    from iscc_search_tpu.options import SearchOptions
    from iscc_search_tpu.server.scaleout import serve_scaleout

    opts = SearchOptions(index_uri=f"tpu://{tmp_path}/z", port=0, workers=2)
    with pytest.raises(ValueError, match="port"):
        serve_scaleout(opts)
