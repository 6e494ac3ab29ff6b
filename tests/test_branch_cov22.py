"""Branch coverage round 22: the round-4 residual arms — simprint
batched-search degenerate inputs and scoring dedup, store session/bulk-insert
arms, accept-loop graceful exits, shed-drain peer states, and device-index
keymap/chunk-growth arms."""

import json
import socket
import threading
import time

import numpy as np
import pytest

from iscc_search_tpu.engine.device_index import DeviceHammingIndex, DeviceNphdIndex
from iscc_search_tpu.engine.simprint import SimprintEngine
from iscc_search_tpu.engine import simprint_ops as sp_ops
from iscc_search_tpu.store import HostStore


@pytest.fixture
def store(tmp_path):
    s = HostStore(tmp_path / "db")
    yield s
    s.close()


@pytest.fixture
def rng():
    return np.random.default_rng(22)


# ------------------------------------------------------------------- simprint


def key16(asset, offset):
    return sp_ops.pack_chunk_pointer(int(asset).to_bytes(8, "big"), offset, 10)


def test_search_raw_many_all_empty_query_assets(tmp_path):
    """Query assets with zero simprints each: no sweep, one empty result
    list per asset (simprint.py 'not flat' arm)."""
    eng = SimprintEngine(tmp_path / "sp", ndim=128)
    eng.add_raw([key16(1, 0)], [bytes(16)])
    assert eng.search_raw_many([[], []], limit=5, total_assets=1) == [[], []]
    eng.close()


def test_second_candidate_same_asset_not_better(tmp_path, rng):
    """Two chunks of ONE asset both match one query: the lower/equal-scored
    candidate must not displace the best (scoring-loop dedup False arm)."""
    eng = SimprintEngine(tmp_path / "sp", ndim=128)
    vec = rng.integers(0, 256, 16, dtype=np.uint8).tobytes()
    eng.add_raw([key16(7, 0), key16(7, 100)], [vec, vec])  # identical chunks
    res = eng.search_raw([vec], limit=5, total_assets=1)
    assert len(res) == 1 and res[0].matches == 1
    assert res[0].iscc_id_body == (7).to_bytes(8, "big")
    assert res[0].score == pytest.approx(1.0)
    eng.close()


# ------------------------------------------------------------ device index


def test_add_packed_updates_materialized_keymap(tmp_path, rng):
    """add_packed keeps the key->row map coherent when it is ALREADY
    materialized (get() after bulk rows must see them)."""
    idx = DeviceHammingIndex(tmp_path / "h", ndim=128)
    k1 = rng.integers(0, 256, (1, 16), dtype=np.uint8)
    v1 = rng.integers(0, 2**32, (1, 4), dtype=np.uint32)
    idx.add_packed(k1, v1, 4)
    assert idx.get(k1[0].tobytes()) is not None  # materializes the map
    k2 = rng.integers(0, 256, (2, 16), dtype=np.uint8)
    v2 = rng.integers(0, 2**32, (2, 4), dtype=np.uint32)
    idx.add_packed(k2, v2, 4)  # km is not None arm
    assert idx.get(k2[1].tobytes()) is not None
    # And the cached-map arm of _keymap (second access skips the rebuild)
    assert idx.get(k2[0].tobytes()) is not None
    idx.close()


def _bulk_rows(rng, n):
    bodies = rng.integers(0, 256, (n, 32), dtype=np.uint8)
    keys = np.arange(n, dtype=">u8").view(np.uint8).reshape(n, 8)
    packed = bodies.reshape(n, 8, 4).view(">u4")[..., 0].astype(np.uint32)
    return bodies, keys, packed


def test_search_chunk_growth_divisibility_arms(tmp_path, rng):
    """Grown scan chunks vs partition capacity: a pow2 cap stays divisible
    (chunk = k), and a 65536-quantized cap that k does NOT divide scans as
    one whole-partition chunk instead of a ragged tail."""
    # Divisible arm: cap 65536 (pow2), k grows to 65536.
    idx = DeviceNphdIndex(tmp_path / "a", ndim=256)
    bodies, keys, packed = _bulk_rows(rng, 40_000)
    idx.add_packed(keys, packed, 8)
    (res,) = idx.search([bodies[5].tobytes()], 33_000)
    assert len(res[1]) == 33_000 and res[1][0] == pytest.approx(1.0)
    idx.close()
    # Non-divisible arm: cap 196608 (3 x 65536), k = 131072 -> whole-chunk.
    idx2 = DeviceNphdIndex(tmp_path / "b", ndim=256)
    bodies2, keys2, packed2 = _bulk_rows(rng, 120_000)
    idx2.add_packed(keys2, packed2, 8)
    (res2,) = idx2.search([bodies2[7].tobytes()], 66_000)
    assert len(res2[1]) == 66_000 and res2[1][0] == pytest.approx(1.0)
    idx2.close()


def test_search_count_exceeding_chunk_grows_chunk(tmp_path, rng):
    """count > scan chunk: the per-chunk top-k must hold k candidates, so the
    chunk grows instead of silently truncating the result set."""
    idx = DeviceNphdIndex(tmp_path / "n", ndim=256)
    keys = list(range(300))
    vecs = [rng.integers(0, 256, 32, dtype=np.uint8).tobytes() for _ in range(300)]
    idx.add(keys, vecs)
    (res,) = idx.search([vecs[0]], 9000)  # k -> 16384 > the 8192-cap chunk
    assert len(res[1]) == 300  # every live row returned
    assert res[1][0] == pytest.approx(1.0)
    idx.close()


# ------------------------------------------------------------------ batcher


def test_batcher_single_oversized_request_dispatches_alone(tmp_path, rng):
    """One request larger than max_batch: the fuse loop admits nothing, and
    the oversized request still dispatches (whole, alone)."""
    from iscc_search_tpu.engine.batcher import SearchBatcher

    idx = DeviceNphdIndex(tmp_path / "n", ndim=256)
    vecs = [rng.integers(0, 256, 32, dtype=np.uint8).tobytes() for _ in range(8)]
    idx.add(list(range(8)), vecs)
    b = SearchBatcher(idx, max_batch=2, window_ms=0.0)
    res = b.search(vecs[:5], 3)  # 5 bodies > max_batch=2
    assert len(res) == 5 and all(len(r[1]) for r in res)
    b.close()
    idx.close()


def test_batcher_close_with_queued_item_drains_then_exits(tmp_path, rng):
    """close() racing a queued request: the collector wakes to (closed,
    queue non-empty), drains the batch, then exits."""
    from iscc_search_tpu.engine.batcher import SearchBatcher, _Pending

    idx = DeviceNphdIndex(tmp_path / "n", ndim=256)
    vecs = [rng.integers(0, 256, 32, dtype=np.uint8).tobytes() for _ in range(4)]
    idx.add(list(range(4)), vecs)
    b = SearchBatcher(idx, max_batch=8, window_ms=50.0)
    b.search(vecs[:1], 2)  # prime last_dispatch so the next batch waits
    item = _Pending(vecs[:2], 2)
    with b._cond:
        b._queue.append(item)
        b._closed = True
        b._cond.notify_all()
    b._thread.join(10)
    assert not b._thread.is_alive()
    assert item.event.wait(1) and item.error is None and len(item.result) == 2
    idx.close()


# -------------------------------------------------------------------- store


def test_store_nested_sessions_inflight_arm(store):
    """Nested _use sessions: the inner exit sees inflight > 0 and must NOT
    signal the close handshake."""
    with store._use():
        with store._use():
            pass
        store.put("a", b"k", b"v")
    assert store.get("a", b"k") == b"v"


def test_dup_putmulti_arrays_rejected_on_plain_db(store):
    """Array bulk insert into a PLAIN db: the native layer rejects the dup
    op (kind flip) and the wrapper raises."""
    store.put("plain", b"k", b"v")
    k = np.zeros((1, 4), np.uint8)
    with pytest.raises(ValueError, match="rejected"):
        store.dup_putmulti_arrays("plain", k, k)


# ----------------------------------------------------- accept-loop graceful


def test_pooled_accept_loop_exits_on_shutdown_flag():
    """_accept_loop's graceful exit arm: the shutdown flag (not a closed
    socket) ends the loop at the next accept timeout."""
    from iscc_search_tpu.server.pooled import PooledHTTPServer

    srv = PooledHTTPServer("127.0.0.1", 0, lambda e, s: [], threads=1)
    t = threading.Thread(target=srv._accept_loop, daemon=True)
    t.start()
    time.sleep(0.1)
    srv._shutdown.set()  # flag only; listener stays open
    t.join(3)
    assert not t.is_alive()
    srv._shutdown.clear()
    srv.server_close()


def test_engine_ipc_accept_loop_exits_on_stop_flag(tmp_path):
    """EngineIPCServer accept loop: stop flag (listener open) exits via the
    while-condition, not the closed-socket OSError path."""
    from iscc_search_tpu.indexes.memory import MemoryIndex
    from iscc_search_tpu.server.scaleout import EngineIPCServer

    ipc = EngineIPCServer(MemoryIndex(), str(tmp_path / "e.sock"))
    ipc.start()
    time.sleep(0.1)
    ipc._stop.set()
    ipc._accept.join(3)
    assert not ipc._accept.is_alive()
    ipc._stop.clear()
    ipc.close()


# -------------------------------------------------------------- shed drains


def test_shed_blocking_peer_already_closed():
    """Blocking shed against a peer that closed first: the non-blocking
    drain reads EOF (no exception arm) and the shed completes."""
    from iscc_search_tpu.server.pooled import PooledHTTPServer, _Conn

    srv = PooledHTTPServer("127.0.0.1", 0, lambda e, s: [], threads=1)
    a, b = socket.socketpair()
    b.close()  # peer gone: sendall may fail OR drain sees EOF — both safe
    conn = _Conn(a, ("127.0.0.1", 0))
    srv._shed(conn, blocking=True)
    assert conn.closed
    srv.server_close()


def test_shed_blocking_peer_sends_then_fin():
    """Blocking shed with buffered request bytes + FIN: drain consumes the
    bytes then EOF without the timeout arm."""
    from iscc_search_tpu.server.pooled import PooledHTTPServer, _Conn

    srv = PooledHTTPServer("127.0.0.1", 0, lambda e, s: [], threads=1)
    a, b = socket.socketpair()
    b.sendall(b"GET / HTTP/1.1\r\n\r\n")
    b.shutdown(socket.SHUT_WR)  # FIN after the request bytes
    conn = _Conn(a, ("127.0.0.1", 0))
    srv._shed(conn, blocking=True)
    assert conn.closed
    head = b.recv(65536)
    assert b"503" in head
    b.close()
    srv.server_close()


# --------------------------------------------------------------- kv backend


def test_kv_search_simprints_only_query(tmp_path):
    """A simprints-only query against the kv backend: the unit loop never
    enters (the backend has no simprint engine) and the result is empty."""
    from iscc_search_tpu.indexes.kv import KvIndex
    from iscc_search_tpu.schema import IsccQuery

    idx = KvIndex(tmp_path / "kv")
    res = idx.search_assets(IsccQuery(simprints={"CONTENT_TEXT_V0": ["AAAAAAAAAAAAAAAAAAAAAA"]}), limit=5)
    assert res.global_matches == []
    idx.close()


# ------------------------------------------------------------- tpu manager


def test_manager_sizes_skip_stray_file(tmp_path, rng):
    """A stray FILE in an index directory must not break (or count toward)
    the per-component size report — only directories are components."""
    from iscc_search_tpu.indexes.tpu.manager import TpuIndexManager
    from iscc_search_tpu.schema import IsccIndex

    mgr = TpuIndexManager(tmp_path)
    mgr.create_index(IsccIndex(name="sz"))
    (tmp_path / "sz" / "stray.txt").write_text("not a component")
    info = mgr.get_index("sz")
    assert info.name == "sz"
    mgr.close()


# ------------------------------------------------------------------ poller


def test_poll_cancelled_with_prefetched_next_group():
    """Cancellation while a PIPELINED successor group is in flight: the
    exception-path finally must cancel and await the prefetched task (the
    not-None arm of the cleanup, unreachable without an active pool)."""
    import asyncio

    import httpx

    import tests.test_aggregator as agg
    from iscc_search_tpu.aggregator import hublist, poller

    index = agg.MemoryIndex()
    index.create_index(agg.IsccIndex(name="idptest"))
    # Two bundle groups: GROUP_BUNDLES=16 bundles x 256 records + 1 more.
    records = [agg.make_record(i) for i in range(1, 16 * 256 + 2)]
    fake = agg.FakeLog(records)
    client = httpx.AsyncClient(transport=httpx.MockTransport(fake.handler))
    started = asyncio.Event()

    class StubPool:
        active = True

        async def convert(self, records, already_done, network):
            started.set()
            await asyncio.sleep(30)

    async def go():
        stop = asyncio.Event()
        hub = hublist.Hub(hub_id=0, url="https://hub0.example")
        task = asyncio.ensure_future(
            poller.poll_hub_once(client, hub, 0, index, "idptest", "testnet", stop, convert=StubPool())
        )
        await asyncio.wait_for(started.wait(), 20)
        await asyncio.sleep(0)  # let the prefetch task get scheduled
        task.cancel()
        with pytest.raises(asyncio.CancelledError):
            await task

    asyncio.run(go())
    index.close()


# ------------------------------------------------------------- worker main


def test_worker_main_breaker_disabled(tmp_path, monkeypatch):
    """scaleout_breaker_ms=0 wires NO admission probe (the pre-breaker
    shape) — worker still serves."""
    import urllib.request

    from iscc_search_tpu.indexes.memory import MemoryIndex
    from iscc_search_tpu.server import pooled as pooled_mod
    from iscc_search_tpu.server import scaleout as so
    from iscc_search_tpu.server.scaleout import EngineIPCServer

    sock_path = str(tmp_path / "e.sock")
    engine = EngineIPCServer(MemoryIndex(), sock_path)
    engine.start()
    cfg = {
        "opts": {
            "index_uri": "memory://",
            "host": "127.0.0.1",
            "port": 0,
            "http_threads": 2,
            "scaleout_breaker_ms": 0,
        },
        "socket_path": sock_path,
    }
    monkeypatch.setenv("ISCC_SCALEOUT_CONFIG", json.dumps(cfg))
    srv_box = {}
    real = pooled_mod.PooledHTTPServer.serve_forever

    def capture(self):
        srv_box["srv"] = self
        return real(self)

    monkeypatch.setattr(pooled_mod.PooledHTTPServer, "serve_forever", capture)
    t = threading.Thread(target=so.worker_main, daemon=True)
    t.start()
    deadline = time.time() + 15
    while "srv" not in srv_box and time.time() < deadline:
        time.sleep(0.05)
    srv = srv_box["srv"]
    assert srv.overload_probe is None
    with urllib.request.urlopen(f"http://127.0.0.1:{srv.server_port}/healthz", timeout=5) as res:
        assert json.load(res)["status"] == "ok"
    srv.shutdown()
    t.join(10)
    engine.close()
