"""Branch coverage round 23: the round-5 residual arms — double-checked-lock
inner arms (keymap, simprint batcher), materialized-keymap bulk appends, mesh
large-count chunk growth past the default chunk, save
pipeline wait loops driven by a blocked writer, order-independent simprint
best-per-asset scoring, store in-flight gate nesting and close-drain, bulk
dupsort validation, accept/serve loop stop-flag exits, blocking-shed drain
outcomes, batcher queue refill and batch-boundary stop, and the poller's
prefetch cancellation on stop."""

import asyncio
import socket
import threading
import time

import numpy as np
import pytest

from iscc_search_tpu.engine import DeviceNphdIndex
from iscc_search_tpu.engine.batcher import SearchBatcher
from iscc_search_tpu.engine.simprint import SimprintEngine
from iscc_search_tpu.engine import simprint_ops as sp_ops
from iscc_search_tpu.store import HostStore


@pytest.fixture
def rng():
    return np.random.default_rng(23)


class _ArmLock:
    """Context-manager wrapper around a real lock that runs a hook AFTER
    acquiring — deterministically simulates 'another thread won the race
    while we waited on the lock' for double-checked-locking inner arms."""

    def __init__(self, real, on_enter):
        self.real = real
        self.on_enter = on_enter

    def __enter__(self):
        r = self.real.__enter__()
        self.on_enter()
        return r

    def __exit__(self, *exc):
        return self.real.__exit__(*exc)


# ------------------------------------------------- double-checked lock arms


def test_keymap_double_checked_inner_arm(tmp_path, rng):
    """A thread that loses the _keymap build race must use the winner's map
    (inner None-check False) instead of rebuilding."""
    idx = DeviceNphdIndex(tmp_path / "i")
    idx.add([1, 2], [rng.integers(0, 256, 16, dtype=np.uint8).tobytes() for _ in range(2)])
    idx.save()
    re = DeviceNphdIndex(tmp_path / "i")  # snapshot load -> map stays lazy
    assert re._key_to_row is None
    sentinel = {b"\x00" * 8: 0}
    real = re._lock
    re._lock = _ArmLock(real, lambda: setattr(re, "_key_to_row", sentinel))
    try:
        assert re._keymap is sentinel  # winner's map adopted, no rebuild
    finally:
        re._lock = real
        re._key_to_row = None
    assert len(re._keymap) == 2  # the real lazy build still works after
    re.close()
    idx.close()


def test_sp_batcher_double_checked_inner_arm(tmp_path):
    """Losing the simprint-batcher creation race adopts the winner's batcher."""
    from iscc_search_tpu.indexes.tpu import TpuIndex

    idx = TpuIndex(tmp_path / "idx")

    class _Sentinel:
        def search(self, bodies, count):  # pragma: no cover - never swept
            raise AssertionError

    sentinel = _Sentinel()
    real = idx._batcher_lock
    idx._batcher_lock = _ArmLock(
        real, lambda: idx._batchers.__setitem__("sp:CONTENT_TEXT_V0", sentinel)
    )
    try:
        fn = idx._sp_sweep_fn("CONTENT_TEXT_V0")
        assert fn.__self__ is sentinel
    finally:
        idx._batcher_lock = real
        idx._batchers.pop("sp:CONTENT_TEXT_V0", None)
    idx.close()


def test_add_packed_updates_materialized_keymap(tmp_path, rng):
    """Bulk appends keep an already-built keymap coherent (mutation lookups
    see the new rows without a rebuild); when the map is still lazy the
    append must NOT force a build."""
    idx = DeviceNphdIndex(tmp_path / "i")
    bodies = [rng.integers(0, 256, 32, dtype=np.uint8).tobytes() for _ in range(4)]
    idx.add([1, 2], bodies[:2])
    assert idx._key_to_row is not None  # add() built it

    def key_arr(ns):
        arr = np.zeros((len(ns), idx.key_bytes), np.uint8)
        arr[:, :8] = np.frombuffer(np.array(ns, dtype=">u8").tobytes(), np.uint8).reshape(-1, 8)
        return arr

    packed = np.stack([np.frombuffer(b, dtype=">u4").astype(np.uint32) for b in bodies[2:]])
    idx.add_packed(key_arr([3, 4]), packed, 8)
    assert idx.get(4) == bodies[3]  # map saw the bulk rows
    # Lazy-map direction: a fresh snapshot load leaves the map None and a
    # bulk append must leave it None (rows ride the one-time build later).
    idx.save()
    re = DeviceNphdIndex(tmp_path / "i")
    assert re._key_to_row is None
    packed5 = np.frombuffer(bodies[0], dtype=">u4").astype(np.uint32)[None, :]
    re.add_packed(key_arr([5]), packed5, 8)
    assert re._key_to_row is None
    assert re.get(5) == bodies[0]  # one-time build includes the bulk row
    re.close()
    idx.close()


# ------------------------------------------------------- mesh count arms


def test_mesh_count_above_per_shard_chunk(tmp_path, rng, monkeypatch):
    """count > per-shard chunk grows the scan chunk (exact large-k mesh)."""
    from iscc_search_tpu.parallel import make_mesh

    mesh = make_mesh(8)
    n = 8 * 4096
    packed = rng.integers(0, 2**32, (n, 8), dtype=np.uint32)
    keys = np.zeros((n, 8), np.uint8)
    keys[:, :8] = np.frombuffer(np.arange(n, dtype=">u8").tobytes(), np.uint8).reshape(-1, 8)
    idx = DeviceNphdIndex(tmp_path / "i", mesh=mesh, shard_size=1 << 30)
    idx.add_packed(keys, packed, 8)
    cap = idx._sync_device()[8].cap
    count = cap // 8 + 7  # k = pow2ceil(count) > cap // n_shards
    res = idx.search([packed[11].astype(">u4").tobytes()], count)
    assert res[0][1][0] == pytest.approx(1.0, abs=1e-3)
    assert len(res[0][1]) == count
    assert np.all(np.diff(res[0][1]) <= 1e-6)  # scores non-increasing
    idx.close()


def test_mesh_chunk_past_pallas_bound_routes_xla(tmp_path, rng, monkeypatch):
    """A count past the default chunk grows the per-shard scan chunk beyond
    it, and the mesh sweep still returns every requested row in order."""
    from iscc_search_tpu.engine import device_index as di
    from iscc_search_tpu.parallel import make_mesh

    mesh = make_mesh(8)
    n = 8 * 65536
    packed = rng.integers(0, 2**32, (n, 8), dtype=np.uint32)
    keys = np.zeros((n, 8), np.uint8)
    keys[:, :8] = np.frombuffer(np.arange(n, dtype=">u8").tobytes(), np.uint8).reshape(-1, 8)
    idx = DeviceNphdIndex(tmp_path / "i", mesh=mesh, shard_size=1 << 30)
    idx.add_packed(keys, packed, 8)
    cap = idx._sync_device()[8].cap
    count = di._DEFAULT_CHUNK_ROWS + 1  # grown chunk = pow2ceil(count) > default chunk
    assert cap // 8 > di._DEFAULT_CHUNK_ROWS
    res = idx.search([packed[42].astype(">u4").tobytes()], count)
    assert res[0][1][0] == pytest.approx(1.0, abs=1e-3)
    assert len(res[0][1]) == count
    idx.close()


# ------------------------------------------------------- save pipeline arms


def test_save_wait_and_drain_block_on_inflight_write(tmp_path, rng):
    """save(wait=True) and drain_rotations() wait out a queued snapshot AND an
    in-flight write; the worker picks up a queued snapshot without re-waiting."""
    idx = DeviceNphdIndex(tmp_path / "i")
    idx.add([1], [rng.integers(0, 256, 16, dtype=np.uint8).tobytes()])

    started = threading.Event()
    release = threading.Event()
    orig = idx._write_snapshot

    def slow_write(snapshot):
        started.set()
        assert release.wait(30)
        return orig(snapshot)

    idx._write_snapshot = slow_write
    idx.save(wait=False)  # worker dequeues and blocks inside the write
    assert started.wait(30)
    idx.add([2], [rng.integers(0, 256, 16, dtype=np.uint8).tobytes()])
    idx.save(wait=False)  # queued behind the blocked write
    t_drain = threading.Thread(target=idx.drain_rotations)
    t_wait = threading.Thread(target=idx.save)  # wait=True
    t_drain.start()
    t_wait.start()
    time.sleep(0.15)  # both threads reach their wait loops
    assert t_drain.is_alive() and t_wait.is_alive()
    release.set()
    t_drain.join(30)
    t_wait.join(30)
    assert not t_drain.is_alive() and not t_wait.is_alive()
    idx._write_snapshot = orig
    re = DeviceNphdIndex(tmp_path / "i")
    assert len(re) == 2  # both snapshots landed, newest state on disk
    re.close()
    idx.close()


# -------------------------------------------- simprint best-per-asset arms


def test_simprint_best_per_asset_is_order_independent(tmp_path, rng):
    """Per-(asset, query) best keeps the max score whether candidates arrive
    ascending or descending (the device contract is descending, but the
    batcher hook makes ordering an external input — guard both ways)."""
    eng = SimprintEngine(tmp_path / "sp", ndim=128)
    real_vec = rng.integers(0, 256, 16, dtype=np.uint8).tobytes()
    eng.add_raw([sp_ops.pack_chunk_pointer(b"A" * 8, 0, 10)], [real_vec])

    def fake_sweep(bodies, count):
        out = []
        for i, _ in enumerate(bodies):
            keys = np.stack(
                [
                    np.frombuffer(sp_ops.pack_chunk_pointer(b"A" * 8, 0, 10), np.uint8),
                    np.frombuffer(sp_ops.pack_chunk_pointer(b"A" * 8, 10, 10), np.uint8),
                ]
            )
            scores = np.array([0.8, 0.9]) if i == 0 else np.array([0.9, 0.8])
            out.append((keys, scores, np.array([0, 0])))
        return out

    res = eng.search_raw([b"q1" * 8, b"q2" * 8], limit=5, total_assets=1, sweep_fn=fake_sweep)
    assert len(res) == 1
    # Both query chunks matched asset A at best 0.9 regardless of order.
    assert res[0].score == pytest.approx(0.9)
    eng.close()


# --------------------------------------------------- store gate/close arms


def test_store_nested_use_keeps_gate_open(tmp_path):
    """Releasing an inner in-flight registration while another remains must
    not signal the close-drain (inflight > 0 arm)."""
    s = HostStore(tmp_path / "db")
    with s._use():
        with s._use():
            pass
        assert s._inflight == 1
    assert s._inflight == 0
    s.close()


def test_store_close_waits_for_inflight_call(tmp_path):
    """close() blocks until the last in-flight native call drains."""
    s = HostStore(tmp_path / "db")
    entered = threading.Event()
    release = threading.Event()
    closed = threading.Event()

    def inflight():
        with s._use():
            entered.set()
            assert release.wait(30)

    t = threading.Thread(target=inflight)
    t.start()
    assert entered.wait(30)
    tc = threading.Thread(target=lambda: (s.close(), closed.set()))
    tc.start()
    time.sleep(0.1)
    assert not closed.is_set()  # close is waiting on the in-flight call
    release.set()
    t.join(30)
    tc.join(30)
    assert closed.is_set()


def test_store_use_exception_path_releases_gate(tmp_path):
    """The in-flight gate releases on the EXCEPTION exit too — both with
    another registration still open (no notify) and as the last one
    (notify): the finally block's exception-path bytecode copy."""
    s = HostStore(tmp_path / "db")
    with pytest.raises(RuntimeError, match="boom"):
        with s._use():
            with s._use():
                raise RuntimeError("boom")
    assert s._inflight == 0
    s.close()  # close still drains cleanly after exception exits


def test_dup_putmulti_arrays_validation(tmp_path, rng):
    s = HostStore(tmp_path / "db")
    keys = rng.integers(0, 256, (4, 8), dtype=np.uint8)
    vals = rng.integers(0, 256, (4, 8), dtype=np.uint8)
    with pytest.raises(ValueError, match="equal n"):
        s.dup_putmulti_arrays("instance", keys.ravel(), vals)  # keys.ndim != 2
    with pytest.raises(ValueError, match="equal n"):
        s.dup_putmulti_arrays("instance", keys, vals.ravel())  # vals.ndim != 2
    with pytest.raises(ValueError, match="equal n"):
        s.dup_putmulti_arrays("instance", keys, vals[:3])  # n mismatch
    s.dup_putmulti_arrays("instance", keys, vals)  # happy path still lands
    assert s.get_dups("instance", keys[0].tobytes()) == [vals[0].tobytes()]
    s.close()


# ------------------------------------------------------ loop stop-flag arms


def test_pooled_accept_loop_exits_on_shutdown_flag():
    from iscc_search_tpu.server.pooled import PooledHTTPServer

    srv = PooledHTTPServer("127.0.0.1", 0, app=None, threads=1)
    srv._shutdown.set()
    srv._accept_loop()  # stop observed at the loop head -> immediate return
    srv.server_close()


def test_engine_ipc_loops_exit_on_stop_flag(tmp_path):
    from iscc_search_tpu.server.scaleout import EngineIPCServer

    srv = EngineIPCServer(index=object(), socket_path=str(tmp_path / "ipc.sock"))
    srv._stop.set()
    srv._accept_loop()  # stop observed at the loop head
    a, b = socket.socketpair()
    try:
        srv._serve_conn(a)  # stop observed before the first frame read
    finally:
        a.close()
        b.close()
    srv.close()


# ----------------------------------------------------- blocking shed drains


def test_blocking_shed_drains_pipelined_bytes():
    """Worker-thread shed: buffered request bytes are drained (loop body) and
    the peer's FIN ends the drain (loop exit) — the 503 survives."""
    from iscc_search_tpu.server.pooled import PooledHTTPServer, _Conn

    srv = PooledHTTPServer("127.0.0.1", 0, app=None, threads=1)
    a, b = socket.socketpair()
    b.sendall(b"GET / HTTP/1.1\r\n\r\nGET / HTTP/1.1\r\n\r\n")
    b.shutdown(socket.SHUT_WR)  # FIN -> drain sees data, then b""
    srv._shed(_Conn(a, ("x", 0)), blocking=True)
    got = b.recv(65536)
    assert b"503" in got
    b.close()
    srv.server_close()


def test_blocking_shed_times_out_on_silent_open_peer():
    """A peer that neither sends nor closes: the bounded FIN wait times out
    instead of pinning the worker (the round-4 drain-stall fix)."""
    from iscc_search_tpu.server.pooled import PooledHTTPServer, _Conn

    srv = PooledHTTPServer("127.0.0.1", 0, app=None, threads=1)
    a, b = socket.socketpair()
    t0 = time.monotonic()
    srv._shed(_Conn(a, ("x", 0)), blocking=True)
    assert time.monotonic() - t0 < 1.0  # one 50 ms wait, not 64 x 0.5 s
    assert b"503" in b.recv(65536)
    b.close()
    srv.server_close()


def test_blocking_shed_peer_fin_without_data():
    """A peer that FIN'd with nothing buffered: the drain sees EOF at once."""
    from iscc_search_tpu.server.pooled import PooledHTTPServer, _Conn

    srv = PooledHTTPServer("127.0.0.1", 0, app=None, threads=1)
    a, b = socket.socketpair()
    b.shutdown(socket.SHUT_WR)  # FIN, no request bytes
    srv._shed(_Conn(a, ("x", 0)), blocking=True)
    assert b"503" in b.recv(65536)
    b.close()
    srv.server_close()


def test_blocking_shed_drains_multiple_buffers():
    """More buffered request bytes than one recv returns: the drain loops."""
    from iscc_search_tpu.server.pooled import PooledHTTPServer, _Conn

    srv = PooledHTTPServer("127.0.0.1", 0, app=None, threads=1)
    a, b = socket.socketpair()
    b.sendall(b"x" * 140_000)  # > one 65536 recv
    b.shutdown(socket.SHUT_WR)
    srv._shed(_Conn(a, ("x", 0)), blocking=True)
    assert b"503" in b.recv(65536)
    b.close()
    srv.server_close()


# ------------------------------------------------------------ batcher arms


def test_batcher_refills_from_queue_and_stops_at_batch_boundary():
    """While a sweep is in flight the queue refills (no wait on re-entry) and
    collection stops at the item that would overflow max_batch."""
    release = threading.Event()
    calls = []

    class FakeIndex:
        def search(self, bodies, count):
            calls.append(list(bodies))
            if len(calls) == 1:
                assert release.wait(30)
            return [(np.arange(2), np.ones(2))] * len(bodies)

    b = SearchBatcher(FakeIndex(), max_batch=4, window_ms=0.0)
    results = {}

    def go(name, bodies):
        results[name] = b.search(bodies, 1)

    t1 = threading.Thread(target=go, args=("one", ["a"]))
    t1.start()
    while not calls:  # collector holds the first sweep
        time.sleep(0.005)
    # Queue in a deterministic order while the sweep is held: 3,2,1,2
    # queries against max_batch=4 exercises every collection boundary —
    # second item too big immediately (3+2), a later item too big after
    # fills (2+1 then +2), and the final lone item emptying the queue.
    threads = [t1]
    for name, bodies in (("w3", ["b", "c", "d"]), ("w2", ["e", "f"]), ("w1", ["g"]), ("v2", ["h", "i"])):
        t = threading.Thread(target=go, args=(name, bodies))
        t.start()
        threads.append(t)
        while len(b._queue) < len(threads) - 1:
            time.sleep(0.005)
    release.set()
    for t in threads:
        t.join(30)
    assert {k: len(v) for k, v in results.items()} == {"one": 1, "w3": 3, "w2": 2, "w1": 1, "v2": 2}
    assert [len(c) for c in calls] == [1, 3, 3, 2]
    b.close()


def test_batcher_close_drains_queued_requests():
    """close() with requests still queued: the collector finishes the queue
    before exiting (no caller left hanging)."""
    release = threading.Event()

    class FakeIndex:
        def search(self, bodies, count):
            release.wait(30)
            return [(np.arange(1), np.ones(1))] * len(bodies)

    b = SearchBatcher(FakeIndex(), max_batch=8, window_ms=0.0)
    results = {}
    t1 = threading.Thread(target=lambda: results.setdefault("a", b.search(["a"], 1)))
    t1.start()
    while not b._queue and release.wait(0) is False and t1.is_alive():
        time.sleep(0.005)  # until the collector picked it up
    t2 = threading.Thread(target=lambda: results.setdefault("b", b.search(["b"], 1)))
    t2.start()
    while not b._queue:
        time.sleep(0.005)
    tc = threading.Thread(target=b.close)  # closed with "b" still queued
    tc.start()
    time.sleep(0.05)
    release.set()
    for t in (t1, t2, tc):
        t.join(30)
    assert len(results["a"]) == 1 and len(results["b"]) == 1


# ------------------------------------------------------------- poller arm


def test_poller_cancels_prefetch_on_stop(monkeypatch):
    """Stopping mid-poll with a pipelined prefetch in flight cancels it."""
    httpx = pytest.importorskip("httpx")
    from iscc_search_tpu.aggregator import poller, hublist
    from iscc_search_tpu.aggregator.entry import convert_group
    from iscc_search_tpu.indexes.memory import MemoryIndex
    from iscc_search_tpu.schema import IsccIndex
    from tests.test_aggregator import FakeLog, make_record

    monkeypatch.setattr(poller, "GROUP_BUNDLES", 1)
    index = MemoryIndex()
    index.create_index(IsccIndex(name="idptest"))
    records = [make_record(i) for i in range(1, 600)]
    fake = FakeLog(records)
    client = httpx.AsyncClient(transport=httpx.MockTransport(fake.handler))
    hub = hublist.Hub(hub_id=0, url="https://hub0.example")

    stop = asyncio.Event()

    class StopDuringConvert:
        active = True  # pipelined prefetch on

        async def convert(self, recs, already_done, network):
            stop.set()  # group 0 converts -> stop before group 1 is awaited
            return convert_group(recs, already_done, network)

    async def go():
        return await poller.poll_hub_once(
            client, hub, 0, index, "idptest", "testnet", stop, convert=StopDuringConvert()
        )

    result = asyncio.run(go())
    assert result.error is None
    assert result.last_size == 256  # exactly group 0 committed
    assert index.get_index("idptest").assets == 256


# ------------------------------------------- simprint search without batcher


def test_simprint_search_without_batching(tmp_path, rng):
    """search_batching=False routes simprint sweeps DIRECTLY to the engine
    (sweep_fn None arm) — same results as the batched path."""
    from iscc_search_tpu import codec as ic
    from iscc_search_tpu.indexes.tpu import TpuIndex
    from iscc_search_tpu.schema import IsccEntry, IsccQuery
    from tests.conftest import make_iscc_id, make_unit

    idx = TpuIndex(tmp_path / "idx", search_batching=False)
    sp = rng.integers(0, 256, 16, dtype=np.uint8).tobytes()
    units = [make_unit(ic.MT.DATA, 0, 64), make_unit(ic.MT.INSTANCE, 0, 64)]
    e = IsccEntry(
        iscc_id=make_iscc_id(1),
        units=units,
        simprints={"CONTENT_TEXT_V0": [{"simprint": ic.encode_base64(sp), "offset": 0, "size": 10}]},
    )
    idx.add_assets([e])
    res = idx.search_assets(IsccQuery(simprints={"CONTENT_TEXT_V0": [ic.encode_base64(sp)]}), limit=5)
    assert res.chunk_matches and res.chunk_matches[0].score == pytest.approx(1.0)
    assert not idx._batchers  # no batcher was created for the sweep
    idx.close()


# ---------------------------------------------------- kv manager load arm


def test_kv_manager_list_skips_corrupt_index(tmp_path):
    from iscc_search_tpu.indexes.kv import KvIndexManager
    from iscc_search_tpu.schema import IsccIndex

    mgr = KvIndexManager(tmp_path)
    mgr.create_index(IsccIndex(name="good"))
    bad = HostStore(tmp_path / "bad.kv")
    bad.put("metadata", b"realm_id", b"\x01")  # non-numeric: realm parse fails
    bad.close()
    names = [i.name for i in mgr.list_indexes()]
    assert names == ["good"]  # corrupt dir skipped with a warning, not fatal
    mgr.close()
