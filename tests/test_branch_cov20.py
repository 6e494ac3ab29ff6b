"""Branch coverage round 20: the last decidable arms — listener-close failure
during server_close, normal-exit scale-out finally, and the remaining backend
query-shape arms."""

import socket
import threading

import numpy as np
import pytest

from iscc_search_tpu import codec as ic
from iscc_search_tpu.engine import DeviceNphdIndex
from iscc_search_tpu.schema import IsccEntry, IsccQuery

from tests.conftest import make_iscc_id


def test_pooled_server_close_with_failing_listener():
    from iscc_search_tpu.server.pooled import PooledHTTPServer, _Conn

    from tests.test_branch_cov11 import _ScriptedSock

    srv = PooledHTTPServer("127.0.0.1", 0, _app_ok, threads=1)
    real_sock = srv._sock

    class BoomSock:
        def close(self):
            raise OSError("close failed")

        def fileno(self):
            return real_sock.fileno()

    # two parked conns must still be closed when the listener close raises
    for i in (1, 2):
        sock = _ScriptedSock()
        sock.fileno = lambda i=i: 100 + i
        srv._parked[100 + i] = _Conn(sock, ("t", i))
    srv.shutdown()
    srv._sock = BoomSock()
    with pytest.raises(OSError, match="close failed"):
        srv.server_close()
    assert not srv._parked
    real_sock.close()


def _app_ok(environ, start_response):
    start_response("200 OK", [])
    return [b"ok"]


def test_serve_scaleout_normal_exit_with_preset_stop(tmp_path, monkeypatch):
    from iscc_search_tpu import options as optmod
    from iscc_search_tpu.server import scaleout as so_mod

    monkeypatch.setenv("ISCC_SEARCH_SCALEOUT_FORCE", "1")
    with socket.socket() as probe:
        probe.bind(("127.0.0.1", 0))
        port = probe.getsockname()[1]
    stop = threading.Event()
    stop.set()  # supervision loop exits on the first check
    opts = optmod.SearchOptions(index_uri="memory://", host="127.0.0.1", port=port, workers=1)
    so_mod.serve_scaleout(opts, stop=stop)  # normal finally path, main thread


# ------------------------------------------------- device_index twin budgets


def test_add_packed_after_remove_keeps_key_map(tmp_path):
    rng = np.random.default_rng(101)
    idx = DeviceNphdIndex(tmp_path / "i")
    idx.add([1, 2], [rng.integers(0, 256, 32, dtype=np.uint8).tobytes() for _ in range(2)])
    assert idx.remove([1]) == 1  # materializes the key->row map
    keys = np.zeros((1, idx.key_bytes), np.uint8)
    keys[0, -1] = 9
    idx.add_packed(keys, rng.integers(0, 2**32, (1, 8), dtype=np.uint32), 8)
    assert len(idx) == 2  # 1 tombstoned + 2 live... live count excludes removed
    idx.close()


def test_sync_device_cache_and_incremental_arms(tmp_path):
    rng = np.random.default_rng(104)
    idx = DeviceNphdIndex(tmp_path / "i")
    idx.add([1], [rng.integers(0, 256, 32, dtype=np.uint8).tobytes()])
    idx._sync_device()
    idx.add([2], [rng.integers(0, 256, 32, dtype=np.uint8).tobytes()])
    idx._sync_device()  # incremental append (partitions exist, rows grew)
    # partitions dropped without marking stale: rebuilt, not returned stale
    idx._partitions = None
    idx._device_stale = False
    parts = idx._sync_device()
    assert parts and parts[8].count == 2
    idx.close()


# ----------------------------------------------------- backend query shapes


def test_memory_query_shape_arms():
    from iscc_search_tpu.indexes.memory import MemoryIndex
    from iscc_search_tpu.schema import IsccIndex

    from tests.test_branch_cov12 import _inst, _unit

    idx = MemoryIndex()
    try:
        idx.create_index(IsccIndex(name="t"))
        u = _unit(b"\x41" * 8)
        code = ic.gen_iscc_code_v0([u, _inst(7)])["iscc"]
        idx.add_assets("t", [IsccEntry(iscc_id=make_iscc_id(1), iscc_code=code, units=[u, _inst(7)])])
        res = idx.search_assets(
            "t", IsccQuery(simprints={"CONTENT_TEXT_V0": [ic.encode_base64(b"\x01" * 16)]})
        )  # simprint-only: the per-unit comprehension never iterates
        assert res.global_matches == []
    finally:
        idx.close()


def test_tpu_manager_sizes_with_residue(tmp_path):
    from iscc_search_tpu.indexes.tpu.manager import TpuIndexManager

    from tests.test_branch_cov12 import _inst, _unit

    mgr = TpuIndexManager(tmp_path)
    try:
        from iscc_search_tpu.schema import IsccIndex

        mgr.create_index(IsccIndex(name="t"))
        mgr.add_assets("t", [IsccEntry(iscc_id=make_iscc_id(1), units=[_unit(b"\x51" * 8), _inst(8)])])
        residue = tmp_path / "t" / "residue-component"
        residue.mkdir()
        (residue / "data.bin").write_bytes(b"x" * 10)
        (residue / "sub").mkdir()  # non-file in the rglob
        listing = mgr.list_indexes()
        assert [i.name for i in listing] == ["t"]
        assert "residue-component" in listing[0].sizes
    finally:
        mgr.close()


def test_static_parent_escape_single_segment():
    import io

    from iscc_search_tpu.indexes.memory import MemoryIndex
    from iscc_search_tpu.options import SearchOptions
    from iscc_search_tpu.server.app import create_app

    app = create_app(index=MemoryIndex(), opts=SearchOptions(index_uri="memory://"))
    environ = {
        "REQUEST_METHOD": "GET",
        "PATH_INFO": "/static/..",
        "QUERY_STRING": "",
        "SERVER_NAME": "t",
        "SERVER_PORT": "80",
        "wsgi.input": io.BytesIO(b""),
        "wsgi.errors": io.StringIO(),
        "wsgi.url_scheme": "http",
    }
    status = {}
    list(app(environ, lambda s, h, e=None: status.update(s=s)))
    assert status["s"].startswith("404")


def test_convert_workers_fallback_with_cpu_count(monkeypatch):
    import os

    from iscc_search_tpu.options import SearchOptions

    monkeypatch.delattr(os, "sched_getaffinity", raising=False)
    monkeypatch.setattr(os, "cpu_count", lambda: 4)
    assert SearchOptions(index_uri="memory://").aggregator_convert_workers == 1
