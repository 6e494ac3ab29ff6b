"""Branch coverage round 18: loop-iteration-count arms (while/for sites need
0, 1, and >=2 iterations), remaining short-circuit arms across the serving
stack, and TpuIndex degraded-state arms."""

import os
import socket
import struct
import threading
import time

import numpy as np
import pytest

from iscc_search_tpu import codec as ic
from iscc_search_tpu.engine import DeviceNphdIndex
from iscc_search_tpu.engine import device_index as di
from iscc_search_tpu.indexes.tpu.index import DB_META, TpuIndex
from iscc_search_tpu.schema import IsccEntry, IsccQuery

from tests.conftest import make_iscc_id, make_unit


@pytest.fixture
def rng():
    import random

    return random.Random(18)


# ------------------------------------------------------------- pooled loops


def _app(environ, start_response):
    start_response("200 OK", [("Content-Type", "text/plain")])
    return [b"ok"]


def test_pooled_shutdown_before_serving_and_two_parked_conns():
    from iscc_search_tpu.server.pooled import PooledHTTPServer

    srv = PooledHTTPServer("127.0.0.1", 0, _app, threads=1)
    srv.shutdown()  # threads started by serve_forever exit on first check
    t = threading.Thread(target=srv.serve_forever)
    t.start()
    t.join(10)
    assert not t.is_alive()
    srv.server_close()

    srv2 = PooledHTTPServer("127.0.0.1", 0, _app, threads=1)
    t2 = threading.Thread(target=srv2.serve_forever, daemon=True)
    t2.start()
    time.sleep(0.1)
    c1 = socket.create_connection(("127.0.0.1", srv2.server_port))
    c2 = socket.create_connection(("127.0.0.1", srv2.server_port))
    time.sleep(0.4)
    assert len(srv2._parked) == 2
    srv2.shutdown()
    srv2.server_close()  # two parked conns: the close loop iterates twice
    t2.join(5)
    c1.close()
    c2.close()


def test_pooled_shed_nonblocking_iteration_counts(tmp_path):
    from iscc_search_tpu.server.pooled import PooledHTTPServer, _Conn

    from tests.test_branch_cov11 import _ScriptedSock

    srv = PooledHTTPServer("127.0.0.1", 0, _app, threads=1)
    try:
        srv._shed(_Conn(_ScriptedSock(recvs=[b""]), ("t", 0)), blocking=False)  # 0 iters
        srv._shed(_Conn(_ScriptedSock(recvs=[b"a", b"b", b""]), ("t", 0)), blocking=False)  # 2 iters
    finally:
        srv.server_close()


def test_pooled_body_arrives_in_two_chunks():
    from iscc_search_tpu.server.pooled import PooledHTTPServer, _Conn

    from tests.test_branch_cov11 import _ScriptedSock

    srv = PooledHTTPServer("127.0.0.1", 0, _app, threads=1)
    try:
        sock = _ScriptedSock(recvs=[b"hel", b"lo"])
        conn = _Conn(sock, ("t", 0))
        conn.buf = b"POST /x HTTP/1.1\r\nHost: t\r\nContent-Length: 5\r\n\r\n"
        assert srv._handle_one(conn) is True
    finally:
        srv.server_close()


# ----------------------------------------------------------- scaleout loops


def test_ipc_stop_before_start_and_rpc_result_json(tmp_path):
    from iscc_search_tpu.server import scaleout as so_mod

    sp = str(tmp_path / "e.sock")
    ipc = so_mod.EngineIPCServer(object(), sp)
    ipc._stop.set()
    ipc.start()
    ipc.close()
    assert not ipc._accept.is_alive()

    wrapped = so_mod._DumpedResult({"a": 1})
    assert wrapped.model_dump() == {"a": 1}
    assert wrapped.model_dump_json() == '{"a": 1}'


def test_rpc_ping_zero_budget(tmp_path):
    from iscc_search_tpu.server import scaleout as so_mod

    rpc = so_mod.EngineRPCIndex(str(tmp_path / "nope.sock"))
    assert rpc.ping(timeout=-0.1) is False  # deadline already past: 0 iters


def test_supervise_with_stop_preset():
    from iscc_search_tpu.server import scaleout as so_mod

    stop = threading.Event()
    stop.set()
    so_mod._supervise([], lambda: None, stop)  # 0 iterations


def test_serve_scaleout_crash_path_cleans_up(tmp_path, monkeypatch):
    from iscc_search_tpu import options as optmod
    from iscc_search_tpu.server import scaleout as so_mod

    def boom(procs, spawn, stop, **kw):
        raise RuntimeError("supervisor crashed")

    monkeypatch.setattr(so_mod, "_supervise", boom)
    monkeypatch.setenv("ISCC_SEARCH_SCALEOUT_FORCE", "1")
    with socket.socket() as probe:
        probe.bind(("127.0.0.1", 0))
        port = probe.getsockname()[1]
    opts = optmod.SearchOptions(index_uri="memory://", host="127.0.0.1", port=port, workers=1)
    with pytest.raises(RuntimeError, match="supervisor crashed"):
        so_mod.serve_scaleout(opts)  # main thread: SIGTERM handler installed

    result = {}

    def run_off_main():
        try:
            so_mod.serve_scaleout(opts)
        except BaseException as exc:
            result["exc"] = exc

    t = threading.Thread(target=run_off_main)
    t.start()
    t.join(60)
    assert isinstance(result.get("exc"), RuntimeError)


# ------------------------------------------------------- service chunked io


def test_service_recv_exact_in_two_chunks():
    from iscc_search_tpu.parallel.service import _recv_exact

    a, b = socket.socketpair()
    try:

        def feed():
            b.sendall(b"abc")
            time.sleep(0.1)
            b.sendall(b"defg")

        t = threading.Thread(target=feed)
        t.start()
        assert _recv_exact(a, 7) == b"abcdefg"
        t.join(5)
    finally:
        a.close()
        b.close()


def test_service_check_live_mismatch():
    import pickle

    from iscc_search_tpu.parallel.service import _LEN, MultihostService

    a, b = socket.socketpair()
    svc = object.__new__(MultihostService)
    svc.is_coordinator = False
    svc._stopped = False
    svc._sock = a

    class Stub:
        save_enabled = True
        _rows = 5
        _live = 2  # rows match, live does not

    payload = pickle.dumps(("check", "idx", 5, 3))
    b.sendall(_LEN.pack(len(payload)) + payload)
    with pytest.raises(RuntimeError, match="replica state mismatch"):
        svc.follow(lambda name: Stub())
    b.close()


# ----------------------------------------------------- small remaining arms


def test_mesh_row_block_rejects_indivisible_devices():
    from tests.test_branch_cov10 import _StubMesh
    from iscc_search_tpu.parallel.mesh import process_row_block

    with pytest.raises(ValueError, match="unequal"):
        process_row_block(_StubMesh([0, 0, 1]), 8)  # 3 devices, 2 procs


def test_convert_workers_default_without_affinity_api(monkeypatch):
    from iscc_search_tpu.options import SearchOptions

    monkeypatch.delattr(os, "sched_getaffinity", raising=False)
    monkeypatch.setattr(os, "cpu_count", lambda: None)
    assert SearchOptions(index_uri="memory://").aggregator_convert_workers == 0


def test_compile_cache_implicit_env_off(monkeypatch):
    from iscc_search_tpu import compile_cache as cc

    monkeypatch.setattr(cc, "_configured", None)
    monkeypatch.setenv("ISCC_SEARCH_COMPILE_CACHE_DIR", "off")
    assert cc.ensure_compile_cache() is None


def test_static_traversal_raw_wsgi_path():
    from iscc_search_tpu.indexes.memory import MemoryIndex
    from iscc_search_tpu.options import SearchOptions
    from iscc_search_tpu.server.app import create_app

    app = create_app(index=MemoryIndex(), opts=SearchOptions(index_uri="memory://"))
    environ = {
        "REQUEST_METHOD": "GET",
        "PATH_INFO": "/static/../../options.py",
        "QUERY_STRING": "",
        "SERVER_NAME": "t",
        "SERVER_PORT": "80",
        "wsgi.input": __import__("io").BytesIO(b""),
        "wsgi.errors": __import__("io").StringIO(),
        "wsgi.url_scheme": "http",
    }
    status = {}
    body = app(environ, lambda s, h, e=None: status.update(s=s))
    assert status["s"].startswith("404")
    # and a real static file serves (the startswith-guard's happy arm)
    environ["PATH_INFO"] = "/static/app.js"
    list(app(environ, lambda s, h, e=None: status.update(s=s)))
    assert status["s"].startswith("200")


def test_kv_search_with_two_units(tmp_path):
    from iscc_search_tpu.indexes.kv import KvIndex

    from tests.test_branch_cov12 import _inst, _unit

    idx = KvIndex(tmp_path / "kv")
    try:
        u1, u2 = _unit(b"\x11" * 8), _unit(b"\x22" * 8, ic.MT.CONTENT, 0)
        idx.add_assets([IsccEntry(iscc_id=make_iscc_id(1), units=[u1, u2, _inst(1)])])
        res = idx.search_assets(IsccQuery(units=[u1, u2]))  # two-unit loop
        assert res.global_matches
    finally:
        idx.close()


def test_memory_search_two_assets_and_types(tmp_path):
    from iscc_search_tpu.indexes.memory import MemoryIndex
    from iscc_search_tpu.schema import IsccIndex

    from tests.test_branch_cov12 import _inst, _unit

    idx = MemoryIndex()
    try:
        idx.create_index(IsccIndex(name="t"))
        u1, u2 = _unit(b"\x31" * 8), _unit(b"\x32" * 8, ic.MT.CONTENT, 0)
        code = ic.gen_iscc_code_v0([u1, _inst(3)])["iscc"]
        idx.add_assets(
            "t",
            [
                IsccEntry(iscc_id=make_iscc_id(1), iscc_code=code, units=[u1, u2, _inst(3)]),
                IsccEntry(iscc_id=make_iscc_id(2), units=[u1, _inst(4)]),
            ],
        )
        res = idx.search_assets("t", IsccQuery(iscc_code=code, units=[u1, u2]))
        assert res.global_matches
    finally:
        idx.close()


def test_cli_serve_aggregator_default_workers(monkeypatch, tmp_path):
    from click.testing import CliRunner

    from iscc_search_tpu.cli import cli
    from iscc_search_tpu.cli import common as cli_common
    from iscc_search_tpu.config import ConfigManager

    manager = ConfigManager(config_dir=tmp_path / "cfg")
    cli_common.set_config_manager(manager)
    called = {}
    monkeypatch.setattr("iscc_search_tpu.server.httpd.serve", lambda opts: called.update(ok=True))
    from iscc_search_tpu.options import SearchOptions

    monkeypatch.setattr(
        "iscc_search_tpu.options.search_opts",
        SearchOptions(index_uri="memory://", aggregator_network="testnet"),
    )
    r = CliRunner()
    result = r.invoke(cli, ["serve"])
    cli_common.set_config_manager(None)
    assert result.exit_code == 0, result.output
    assert called == {"ok": True}


def test_cli_index_remove_remote_with_delete_data(tmp_path):
    from click.testing import CliRunner

    from iscc_search_tpu.cli import cli
    from iscc_search_tpu.cli import common as cli_common
    from iscc_search_tpu.config import ConfigManager

    manager = ConfigManager(config_dir=tmp_path / "cfg")
    cli_common.set_config_manager(manager)
    r = CliRunner()
    r.invoke(cli, ["index", "add", "main", "--path", str(tmp_path / "data")])
    r.invoke(cli, ["index", "add", "rem", "--url", "http://x", "--remote-name", "i", "--no-use"])
    result = r.invoke(cli, ["index", "remove", "rem", "--delete-data"])  # remote: no rm
    cli_common.set_config_manager(None)
    assert result.exit_code == 0, result.output


def test_cli_index_rebuild_unit_type_flag(tmp_path):
    from click.testing import CliRunner

    from iscc_search_tpu.cli import cli
    from iscc_search_tpu.cli import common as cli_common
    from iscc_search_tpu.config import ConfigManager

    manager = ConfigManager(config_dir=tmp_path / "cfg")
    cli_common.set_config_manager(manager)
    r = CliRunner()
    r.invoke(cli, ["index", "add", "main", "--path", str(tmp_path / "data")])
    result = r.invoke(cli, ["index", "rebuild", "--unit-type", "DATA_NONE_V0"])
    cli_common.set_config_manager(None)
    assert result.exit_code == 0, result.output


def test_store_close_waits_through_two_inflight_sessions(tmp_path):
    from iscc_search_tpu.store.kv import HostStore

    s = HostStore(tmp_path / "db")
    gates = [threading.Event(), threading.Event()]
    started = [threading.Event(), threading.Event()]

    def hold(i):
        with s._use():
            started[i].set()
            gates[i].wait(10)

    threads = [threading.Thread(target=hold, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for ev in started:
        assert ev.wait(10)
    closer = threading.Thread(target=s.close)
    closer.start()
    time.sleep(0.2)
    gates[0].set()  # close() wakes, still one inflight: loops again
    time.sleep(0.2)
    assert closer.is_alive()
    gates[1].set()
    for t in threads:
        t.join(10)
    closer.join(10)
    assert not closer.is_alive()


# ---------------------------------------------------------- TpuIndex arms


def entry(n, units, **kw):
    return IsccEntry(iscc_id=make_iscc_id(n), units=units, **kw)


def data_units(rng):
    return [make_unit(ic.MT.DATA, 0, 64, rng=rng), make_unit(ic.MT.INSTANCE, 0, 64, rng=rng)]


def test_multi_type_simprint_query(tmp_path, rng):
    rnd = np.random.default_rng(81)
    sp_a = rnd.integers(0, 256, 16, dtype=np.uint8).tobytes()
    sp_b = rnd.integers(0, 256, 16, dtype=np.uint8).tobytes()
    idx = TpuIndex(tmp_path / "i")
    idx.add_assets([
        entry(1, data_units(rng), simprints={
            "CONTENT_TEXT_V0": [{"simprint": ic.encode_base64(sp_a), "offset": 0, "size": 5}],
            "CONTENT_AUDIO_V0": [{"simprint": ic.encode_base64(sp_b), "offset": 0, "size": 5}],
        }),
    ])
    q = IsccQuery(simprints={
        "CONTENT_TEXT_V0": [ic.encode_base64(sp_a)],
        "CONTENT_AUDIO_V0": [ic.encode_base64(sp_b)],
    })
    res = idx.search_assets(q)
    assert res.chunk_matches and len(res.chunk_matches[0].types) == 2
    idx.close()


def test_update_swapping_simprint_type_with_index_present_and_missing(tmp_path, rng):
    """An update that replaces one simprint type with another: the dropped
    type sees deletions with no additions."""
    rnd = np.random.default_rng(82)
    sp_a = rnd.integers(0, 256, 16, dtype=np.uint8).tobytes()
    idx = TpuIndex(tmp_path / "i")
    e = entry(1, data_units(rng), simprints={
        "CONTENT_TEXT_V0": [{"simprint": ic.encode_base64(sp_a), "offset": 0, "size": 5}],
    })
    idx.add_assets([e])
    # model_construct: an internally-consistent update whose TEXT list is
    # empty (deletion-only); the wire schema forbids it, rebuild-style
    # internal flows are where the arm matters.
    upd = IsccEntry.model_construct(
        iscc_id=e.iscc_id, iscc_code=None, units=list(e.units), metadata=None,
        simprints={"CONTENT_TEXT_V0": []},
    )
    idx.add_assets([upd])  # index present: deletion reaches the device index
    assert idx.search_assets(IsccQuery(simprints={"CONTENT_TEXT_V0": [ic.encode_base64(sp_a)]})).chunk_matches == []
    # Re-add, then drop again with the device index gone
    idx.add_assets([e])
    dropped = idx._simprint_indexes.pop("CONTENT_TEXT_V0")
    dropped.close()
    idx.add_assets([upd])
    idx.close()


def test_zero_score_confident_match_keeps_slot(tmp_path, rng):
    idx = TpuIndex(tmp_path / "i", match_threshold_units=0.0)
    body = bytes([0x00] * 8)
    inv = bytes([0xFF] * 8)
    u = "ISCC:" + ic.encode_base32(
        ic.encode_header(ic.MT.DATA, 0, ic.VS.V0, ic.encode_length(ic.MT.DATA, 64)) + body
    )
    q = "ISCC:" + ic.encode_base32(
        ic.encode_header(ic.MT.DATA, 0, ic.VS.V0, ic.encode_length(ic.MT.DATA, 64)) + inv
    )
    idx.add_assets([entry(1, [u, make_unit(ic.MT.INSTANCE, 0, 64, rng=rng)])])
    res = idx.search_assets(IsccQuery(units=[q]))
    assert res.global_matches and res.global_matches[0].score == 0.0
    idx.close()


def test_batcher_fallback_when_index_vanishes_midway(tmp_path, rng):
    idx = TpuIndex(tmp_path / "i")
    e = entry(1, data_units(rng))
    idx.add_assets([e])
    q = IsccQuery(units=list(e.units))
    assert idx.search_assets(q).global_matches  # build batcher
    for b in idx._batchers.values():
        b.close()
    real = idx._nphd_indexes

    class VanishingDict(dict):
        """Returns the real index once, then None (rebuild race)."""

        def __init__(self, src):
            super().__init__(src)
            self.calls = 0

        def get(self, k, default=None):
            if k == "DATA_NONE_V0":
                self.calls += 1
                if self.calls > 1:
                    return None
            return super().get(k, default)

    idx._nphd_indexes = VanishingDict(real)
    res = idx.search_assets(q)
    # the DATA scan fell back to the vanished index -> no DATA score; the
    # INSTANCE exact path still matches
    assert all("DATA_NONE_V0" not in m.types for m in res.global_matches)
    idx._nphd_indexes = real
    idx.close()


def test_convert_simprint_match_without_chunks(tmp_path, rng):
    from iscc_search_tpu.engine import simprint_ops as sp_ops
    from iscc_search_tpu.models import IsccID

    idx = TpuIndex(tmp_path / "i")
    e = entry(1, data_units(rng))
    idx.add_assets([e])
    raw = sp_ops.SimprintMatchMulti(
        iscc_id=IsccID(e.iscc_id).digest,
        score=0.5,
        types={"CONTENT_TEXT_V0": sp_ops.TypeMatchResult(score=0.5, queried=1, matches=1, chunks=None)},
    )
    m = idx._convert_simprint_match(raw)
    assert m.types["CONTENT_TEXT_V0"].chunks is None
    idx.close()


def test_load_with_absent_count_records(tmp_path, rng):
    rnd = np.random.default_rng(83)
    path = tmp_path / "i"
    idx = TpuIndex(path)
    idx.add_assets([entry(1, data_units(rng), simprints={
        "CONTENT_TEXT_V0": [{"simprint": ic.encode_base64(rnd.integers(0, 256, 16, dtype=np.uint8).tobytes()), "offset": 0, "size": 5}],
    })])
    idx.flush()
    idx.close()
    from iscc_search_tpu.store.kv import HostStore

    s = HostStore(path / "store")
    s.delete(DB_META, b"nphd_count:DATA_NONE_V0")
    s.put(DB_META, b"sp_count:CONTENT_TEXT_V0", struct.pack(">Q", 999))
    s.close()
    idx2 = TpuIndex(path)  # nphd: no expectation; sp: mismatch warning
    assert len(idx2) == 1
    idx2.close()
    s2 = HostStore(path / "store")
    s2.delete(DB_META, b"sp_count:CONTENT_TEXT_V0")
    s2.close()
    idx3 = TpuIndex(path)
    idx3.close()


def test_derived_sizes_with_directory_residue(tmp_path, rng):
    idx = TpuIndex(tmp_path / "i")
    idx.add_assets([entry(1, data_units(rng))])
    idx.flush()
    (idx._nphd_indexes["DATA_NONE_V0"].path / "residue").mkdir()
    assert idx.derived_sizes["DATA_NONE_V0"] >= 0
    idx.close()


# --------------------------------------------------- device_index leftovers


def _np_rng():
    return np.random.default_rng(84)


def test_add_packed_more_shape_arms(tmp_path):
    rng = _np_rng()
    idx = DeviceNphdIndex(tmp_path / "i")
    packed = rng.integers(0, 2**32, (2, 8), dtype=np.uint32)
    keys = np.zeros((2, idx.key_bytes), np.uint8)
    with pytest.raises(ValueError, match="keys must be"):
        idx.add_packed(np.zeros(2 * idx.key_bytes, np.uint8), packed, 8)  # 1-D keys
    with pytest.raises(ValueError, match="packed must be"):
        idx.add_packed(keys, rng.integers(0, 2**32, (2, 99), dtype=np.uint32), 8)  # too wide
    idx.add_packed(keys, packed, np.int32(8))  # 0-d array nlanes
    assert len(idx) == 2
    idx.close()


def test_resave_all_after_failed_segment_write(tmp_path, monkeypatch):
    rng = _np_rng()
    idx = DeviceNphdIndex(tmp_path / "i", shard_size=4 * 1024)
    n = idx.shard_rows
    idx.add(list(range(n)), [rng.integers(0, 256, 32, dtype=np.uint8).tobytes() for _ in range(n)])
    real_write = di._atomic_write
    calls = {"n": 0}

    def failing(path, data, sync_dir=True):
        calls["n"] += 1
        raise OSError("disk full")

    monkeypatch.setattr(di, "_atomic_write", failing)
    idx.save()
    idx.drain_rotations()  # write failed; seals stay unconfirmed
    monkeypatch.setattr(di, "_atomic_write", real_write)
    idx.save()  # unconfirmed seals re-emitted
    idx.drain_rotations()
    idx.close()
    idx2 = DeviceNphdIndex(tmp_path / "i")
    assert len(idx2) == n
    idx2.close()


def test_reload_without_valid_file(tmp_path):
    rng = _np_rng()
    path = tmp_path / "i"
    idx = DeviceNphdIndex(path)
    idx.add([1, 2], [rng.integers(0, 256, 32, dtype=np.uint8).tobytes() for _ in range(2)])
    idx.save()
    idx.drain_rotations()
    idx.close()
    import json

    state = json.loads((path / "state.json").read_text())
    (path / state["valid_file"]).unlink()
    state.pop("valid_file", None)
    (path / "state.json").write_text(json.dumps(state))
    idx2 = DeviceNphdIndex(path)  # legacy manifest without a valid file
    assert len(idx2) == 2
    idx2.close()


def test_gc_keeps_unclassifiable_prefix(tmp_path):
    rng = _np_rng()
    path = tmp_path / "i"
    idx = DeviceNphdIndex(path)
    idx.add([1], [rng.integers(0, 256, 32, dtype=np.uint8).tobytes()])
    idx.save()
    idx.drain_rotations()
    idx.close()
    (path / "other-123.npz").write_bytes(b"x")  # digits but unknown prefix
    idx2 = DeviceNphdIndex(path)
    assert (path / "other-123.npz").exists()
    idx2.close()


