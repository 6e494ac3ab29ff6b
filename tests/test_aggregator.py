"""Aggregator tests: tlog wire format, hub list, entry conversion, and the
poller against an in-memory fake tlog server (httpx.MockTransport) — the
distributed path tested without a cluster (SURVEY §4.8)."""

import asyncio
import hashlib
import json
import struct

import httpx
import pytest

from iscc_search_tpu import codec as ic
from iscc_search_tpu.aggregator import entry as entry_mod
from iscc_search_tpu.aggregator import hublist, poller, tlog
from iscc_search_tpu.indexes.memory import MemoryIndex
from iscc_search_tpu.options import SearchOptions
from iscc_search_tpu.schema import IsccIndex

from tests.conftest import make_iscc_id, make_unit


# ---------------------------------------------------------------- tlog core


def test_parse_checkpoint():
    assert tlog.parse_checkpoint("origin\n42\nroothash\n\nsig") == 42
    assert tlog.parse_checkpoint("origin\n0\nhash") == 0


def test_parse_checkpoint_invalid():
    with pytest.raises(ValueError):
        tlog.parse_checkpoint("one line")
    with pytest.raises(ValueError):
        tlog.parse_checkpoint("o\nnotanumber\nh")
    with pytest.raises(ValueError):
        tlog.parse_checkpoint("o\n007\nh")
    with pytest.raises(ValueError):
        tlog.parse_checkpoint("o\n-3\nh")


def test_entry_bundle_roundtrip():
    records = [b"alpha", b"", b"x" * 300]
    framed = b"".join(struct.pack(">H", len(r)) + r for r in records)
    assert tlog.parse_entry_bundle(framed) == records


def test_entry_bundle_truncated():
    with pytest.raises(ValueError):
        tlog.parse_entry_bundle(b"\x00")
    with pytest.raises(ValueError):
        tlog.parse_entry_bundle(struct.pack(">H", 10) + b"short")


def test_format_index():
    assert tlog.format_index(0) == "000"
    assert tlog.format_index(67) == "067"
    assert tlog.format_index(1234) == "x001/234"
    assert tlog.format_index(1234067) == "x001/x234/067"


def test_entries_path():
    assert tlog.entries_path(5) == "tile/entries/005"
    assert tlog.entries_path(5, width=17) == "tile/entries/005.p/17"


# ---------------------------------------------------------------- plan


def test_plan_bundles_empty_and_regression():
    assert poller.plan_bundles(100, 100) == []
    assert poller.plan_bundles(100, 50) == []


def test_plan_bundles_partial_and_full():
    assert poller.plan_bundles(0, 10) == [(0, 10)]
    assert poller.plan_bundles(0, 256) == [(0, 0)]
    assert poller.plan_bundles(0, 300) == [(0, 0), (1, 44)]
    assert poller.plan_bundles(256, 300) == [(1, 44)]
    assert poller.plan_bundles(200, 256) == [(0, 0)]
    assert poller.plan_bundles(512, 1000) == [(2, 0), (3, 232)]


# ---------------------------------------------------------------- hub list


HUBS_YAML = """
version: 1
network: testnet
hubs:
  - hub_id: 0
    url: https://hub0.example
    active: true
  - hub_id: 1
    url: https://hub1.example
    active: false
"""


def test_parse_hub_list():
    hubs = hublist.parse_hub_list(HUBS_YAML, "testnet")
    assert hubs == [hublist.Hub(hub_id=0, url="https://hub0.example")]


def test_parse_hub_list_errors():
    with pytest.raises(ValueError):
        hublist.parse_hub_list("[]", "testnet")
    with pytest.raises(ValueError):
        hublist.parse_hub_list(HUBS_YAML, "mainnet")


# ---------------------------------------------------------------- entries


def make_record(n=1, realm=0, schema=entry_mod.DECLARATION_SCHEMA, gateway=None, units=None):
    iscc_id = make_iscc_id(n, realm_id=realm)
    data_unit = make_unit(ic.MT.DATA, 0, 64)
    datahash = "1e20" + hashlib.sha256(str(n).encode()).hexdigest()
    inst_unit = "ISCC:" + ic.encode_component(ic.MT.INSTANCE, 0, 0, 64, bytes.fromhex(datahash[4:]))
    code = ic.gen_iscc_code_v0([data_unit, inst_unit], wide=False)["iscc"]
    note = {"$schema": schema, "iscc_code": code, "datahash": datahash}
    if gateway:
        note["gateway"] = gateway
    if units:
        note["units"] = units
    return json.dumps({"iscc_id": iscc_id, "note": note}).encode()


def test_record_to_entry_ok():
    record = make_record(1)
    entry, reason = entry_mod.record_to_entry(record, "testnet")
    assert reason == "ok"
    assert entry.iscc_id == make_iscc_id(1)
    types = {ic.decode_header(ic.decode_base32(u.removeprefix("ISCC:"))).maintype for u in entry.units}
    assert ic.MT.DATA in types and ic.MT.INSTANCE in types
    # INSTANCE expands to the full 256-bit datahash form
    from iscc_search_tpu.models import IsccUnit

    inst = [u for u in entry.units if "INSTANCE" in IsccUnit(u).unit_type]
    assert len(IsccUnit(inst[0])) == 256


def test_record_to_entry_skips():
    assert entry_mod.record_to_entry(b"notjson", "testnet") == (None, "malformed")
    assert entry_mod.record_to_entry(b"{}", "testnet") == (None, "malformed")
    assert entry_mod.record_to_entry(make_record(schema=entry_mod.DELETION_SCHEMA), "testnet")[1] == "deletion"
    assert entry_mod.record_to_entry(make_record(schema="http://other"), "testnet")[1] == "unknown_schema"
    assert entry_mod.record_to_entry(make_record(realm=1), "testnet")[1] == "realm_mismatch"


def test_expand_gateway():
    url = entry_mod.expand_gateway(
        "https://gw.example/{iscc_id}", "ISCC:MAIGIIFJRDGEQQAA", "ISCC:KACYPXW445FTYNJ3", "1e20ab"
    )
    assert url == "https://gw.example/maigiifjrdgeqqaa"
    assert entry_mod.expand_gateway("https://x/{/datahash}", "ISCC:A", "ISCC:B", "1e20ab") == "https://x//1e20ab"
    assert entry_mod.expand_gateway("https://plain", "ISCC:A", "ISCC:B", "x") == "https://plain"


# ---------------------------------------------------------------- poller e2e


class FakeLog:
    """In-memory tlog-tiles hub server."""

    def __init__(self, records):
        self.records = records
        self.fail_bundles = set()

    def handler(self, request):
        path = request.url.path
        if path == "/hubs.yaml":
            return httpx.Response(200, text=HUBS_YAML)
        if path == "/log/checkpoint":
            return httpx.Response(200, text=f"origin\n{len(self.records)}\nhash\n")
        if path.startswith("/log/tile/entries/"):
            seg = path[len("/log/tile/entries/"):]
            if ".p/" in seg:
                idx_s, width_s = seg.split(".p/")
                width = int(width_s)
            else:
                idx_s, width = seg, 0
            index = int(idx_s.replace("x", "").replace("/", ""))
            if index in self.fail_bundles:
                return httpx.Response(500, text="boom")
            start = index * tlog.TILE_WIDTH
            count = width or tlog.TILE_WIDTH
            chunk = self.records[start : start + count]
            body = b"".join(struct.pack(">H", len(r)) + r for r in chunk)
            return httpx.Response(200, content=body)
        return httpx.Response(404)


@pytest.fixture
def agg_setup():
    index = MemoryIndex()
    index.create_index(IsccIndex(name="idptest"))
    opts = SearchOptions(
        index_uri="memory://",
        aggregator_network="testnet",
        aggregator_hub_list_url="https://hub0.example/hubs.yaml",
    )
    return index, opts


def run_async(coro):
    return asyncio.run(coro)  # closes the loop (new_event_loop leaked one per call)


def test_poll_hub_once_ingests(agg_setup):
    index, opts = agg_setup
    records = [make_record(i) for i in range(1, 301)]  # one full + one partial bundle
    fake = FakeLog(records)
    client = httpx.AsyncClient(transport=httpx.MockTransport(fake.handler))
    hub = hublist.Hub(hub_id=0, url="https://hub0.example")

    async def go():
        stop = asyncio.Event()
        return await poller.poll_hub_once(client, hub, 0, index, "idptest", "testnet", stop)

    result = run_async(go())
    assert result.error is None
    assert result.last_size == 300
    assert result.counts["ok"] == 300
    assert index.get_index("idptest").assets == 300
    # Asset is retrievable
    index.get_asset("idptest", make_iscc_id(7))


def test_poll_hub_once_resumes_from_cursor(agg_setup):
    index, opts = agg_setup
    records = [make_record(i) for i in range(1, 301)]
    fake = FakeLog(records)
    client = httpx.AsyncClient(transport=httpx.MockTransport(fake.handler))
    hub = hublist.Hub(hub_id=0, url="https://hub0.example")

    async def go():
        stop = asyncio.Event()
        return await poller.poll_hub_once(client, hub, 290, index, "idptest", "testnet", stop)

    result = run_async(go())
    assert result.counts["ok"] == 10
    assert result.last_size == 300


def test_poll_hub_once_bundle_failure_keeps_progress(agg_setup, monkeypatch):
    """A failed bundle ends the poll but keeps prior committed progress.
    Retry granularity is the bundle GROUP (poller.GROUP_BUNDLES); pin the
    group size to 1 so the boundary under test is a single bundle."""
    index, opts = agg_setup
    monkeypatch.setattr(poller, "GROUP_BUNDLES", 1)
    records = [make_record(i) for i in range(1, 600)]
    fake = FakeLog(records)
    fake.fail_bundles = {1}
    client = httpx.AsyncClient(transport=httpx.MockTransport(fake.handler))
    hub = hublist.Hub(hub_id=0, url="https://hub0.example")

    async def go():
        stop = asyncio.Event()
        return await poller.poll_hub_once(client, hub, 0, index, "idptest", "testnet", stop)

    result = run_async(go())
    assert result.error is not None
    assert result.last_size == 256  # bundle 0 landed, bundle 1 failed


def test_poll_hub_once_group_failure_keeps_group_progress(agg_setup):
    """With the default group size, a failure inside group 2 keeps group 1's
    committed records (cursor lands on the group boundary)."""
    index, opts = agg_setup
    group_records = poller.GROUP_BUNDLES * 256
    records = [make_record(i) for i in range(1, group_records + 600)]
    fake = FakeLog(records)
    fake.fail_bundles = {poller.GROUP_BUNDLES + 1}
    client = httpx.AsyncClient(transport=httpx.MockTransport(fake.handler))
    hub = hublist.Hub(hub_id=0, url="https://hub0.example")

    async def go():
        stop = asyncio.Event()
        return await poller.poll_hub_once(client, hub, 0, index, "idptest", "testnet", stop)

    result = run_async(go())
    assert result.error is not None
    assert result.last_size == group_records  # first group landed
    assert result.counts["ok"] == group_records


def test_poll_hub_once_regression_resets(agg_setup):
    index, opts = agg_setup
    fake = FakeLog([make_record(i) for i in range(1, 10)])
    client = httpx.AsyncClient(transport=httpx.MockTransport(fake.handler))
    hub = hublist.Hub(hub_id=0, url="https://hub0.example")

    async def go():
        stop = asyncio.Event()
        return await poller.poll_hub_once(client, hub, 500, index, "idptest", "testnet", stop)

    result = run_async(go())
    assert result.last_size == 0


def test_poll_loop_full_cycle(agg_setup):
    index, opts = agg_setup
    records = [make_record(i) for i in range(1, 50)]
    fake = FakeLog(records)
    client = httpx.AsyncClient(transport=httpx.MockTransport(fake.handler))
    status = {}

    async def go():
        stop = asyncio.Event()

        async def stopper():
            # Generous budget: the suite may share a loaded single-core host
            for _ in range(500):
                await asyncio.sleep(0.01)
                if status.get(0) and status[0].counts.get("ok"):
                    break
            stop.set()

        await asyncio.gather(poller.poll_loop(index, opts, stop, client, status), stopper())

    run_async(go())
    assert status[0].cursor == 49
    assert status[0].ok is True
    assert status[0].counts["ok"] == 49
    assert index.get_index("idptest").assets == 49


# ---------------------------------------------------------------- cursors


def test_cursor_store_roundtrip(tmp_path):
    from iscc_search_tpu.aggregator.cursors import CursorStore

    store = CursorStore(tmp_path / "c.json", "testnet")
    assert store.load() == {}
    store.save({0: 300, 7: 512})
    assert store.load() == {0: 300, 7: 512}
    # Another network's store ignores the file
    other = CursorStore(tmp_path / "c.json", "mainnet")
    assert other.load() == {}


def test_cursor_store_corrupt_file(tmp_path):
    from iscc_search_tpu.aggregator.cursors import CursorStore

    path = tmp_path / "c.json"
    path.write_text("{not json")
    assert CursorStore(path, "testnet").load() == {}
    path.write_text(json.dumps({"network": "testnet", "cursors": {"x": "y", "3": 9}}))
    assert CursorStore(path, "testnet").load() == {3: 9}


def test_cursor_store_for_uri_schemes(tmp_path):
    from iscc_search_tpu.aggregator.cursors import cursor_store_for

    opts = SearchOptions(index_uri=f"tpu://{tmp_path}", aggregator_network="testnet")
    store = cursor_store_for(opts)
    assert store is not None and store.network == "testnet"
    # memory:// is non-durable -> no cursor persistence (must re-backfill)
    assert cursor_store_for(SearchOptions(index_uri="memory://", aggregator_network="testnet")) is None
    # not in aggregator mode -> None
    assert cursor_store_for(SearchOptions(index_uri=f"tpu://{tmp_path}")) is None


def test_poll_loop_persists_and_resumes_cursor(agg_setup, tmp_path):
    from iscc_search_tpu.aggregator.cursors import CursorStore

    index, opts = agg_setup
    records = [make_record(i) for i in range(1, 50)]
    fake = FakeLog(records)
    store = CursorStore(tmp_path / "c.json", "testnet")

    def cycle(status):
        client = httpx.AsyncClient(transport=httpx.MockTransport(fake.handler))

        async def go():
            stop = asyncio.Event()

            async def stopper():
                for _ in range(500):
                    await asyncio.sleep(0.01)
                    if status.get(0) and status[0].cursor == 49:
                        break
                stop.set()

            await asyncio.gather(
                poller.poll_loop(index, opts, stop, client, status, cursor_store=store), stopper()
            )

        run_async(go())

    status1 = {}
    cycle(status1)
    assert status1[0].cursor == 49
    assert store.load() == {0: 49}

    # "Restart": fresh status dict seeds from the persisted cursor; with no
    # new records the poller ingests nothing but keeps the cursor at 49.
    before = index.get_index("idptest").assets
    status2 = {}
    cycle(status2)
    assert status2[0].cursor == 49
    assert index.get_index("idptest").assets == before


TWO_HUBS_YAML = """
version: 1
network: testnet
hubs:
  - hub_id: 0
    url: https://hub0.example
    active: true
  - hub_id: 1
    url: https://hub1.example
    active: true
"""


class TwoHubLog:
    """Two active hubs; hub1's checkpoint endpoint can be broken."""

    def __init__(self, records, hub1_down=True, hubs_yaml=None):
        self.records = records
        self.hub1_down = hub1_down
        self.hubs_yaml = hubs_yaml or TWO_HUBS_YAML
        self.fail_hub_list = False
        self.inner = FakeLog(records)

    def handler(self, request):
        if request.url.path == "/hubs.yaml":
            if self.fail_hub_list:
                return httpx.Response(503, text="unavailable")
            return httpx.Response(200, text=self.hubs_yaml)
        if request.url.host == "hub1.example" and self.hub1_down:
            return httpx.Response(500, text="hub down")
        return self.inner.handler(request)


def test_poll_loop_hub_failure_isolated(agg_setup):
    """One hub failing must not stop ingestion from the healthy hub; the
    failed hub's status row reports not-ok."""
    index, opts = agg_setup
    records = [make_record(i) for i in range(1, 20)]
    fake = TwoHubLog(records, hub1_down=True)
    client = httpx.AsyncClient(transport=httpx.MockTransport(fake.handler))
    status = {}

    async def go():
        stop = asyncio.Event()

        async def stopper():
            for _ in range(500):
                await asyncio.sleep(0.01)
                if status.get(0) and status[0].counts.get("ok") and 1 in status:
                    break
            stop.set()

        await asyncio.gather(poller.poll_loop(index, opts, stop, client, status), stopper())

    run_async(go())
    assert status[0].ok is True and status[0].counts["ok"] == 19
    assert status[1].ok is False
    assert index.get_index("idptest").assets == 19


def test_roster_refresh_failure_keeps_previous_list(agg_setup):
    """A failed hub-list refresh keeps the last-known-good hubs."""
    _, opts = agg_setup
    fake = TwoHubLog([], hub1_down=False)
    client = httpx.AsyncClient(transport=httpx.MockTransport(fake.handler))
    roster = poller._Roster(opts)
    status = {}
    run_async(roster.refresh(client, status))
    assert [h.hub_id for h in roster.hubs] == [0, 1]
    fake.fail_hub_list = True
    roster._due = 0.0
    run_async(roster.refresh(client, status))
    assert [h.hub_id for h in roster.hubs] == [0, 1]  # kept


def test_roster_prunes_hubs_absent_from_refresh(agg_setup):
    """A hub removed from a NON-empty refreshed list loses its status row;
    an empty refresh prunes nothing (cursors survive transient outages)."""
    _, opts = agg_setup
    fake = TwoHubLog([], hub1_down=False)
    client = httpx.AsyncClient(transport=httpx.MockTransport(fake.handler))
    roster = poller._Roster(opts)
    status = {0: poller.HubStatus(0, "https://hub0.example"), 1: poller.HubStatus(1, "https://hub1.example")}
    fake.hubs_yaml = HUBS_YAML  # hub 1 now inactive -> absent
    run_async(roster.refresh(client, status))
    assert list(status) == [0]
    # Empty list refresh: keep remaining rows
    fake.hubs_yaml = "version: 1\nnetwork: testnet\nhubs: []\n"
    roster._due = 0.0
    run_async(roster.refresh(client, status))
    assert list(status) == [0]


# ------------------------------------------------- conversion pool / pipeline


def test_record_to_fields_matches_entry():
    """The primitive form round-trips to exactly what record_to_entry builds."""
    for record in [make_record(1), make_record(2, gateway="https://gw.example/{iscc_id}")]:
        fields, reason = entry_mod.record_to_fields(record, "testnet")
        assert reason == "ok"
        entry, _ = entry_mod.record_to_entry(record, "testnet")
        assert entry_mod.entry_from_fields(fields) == entry
    for bad, want in [
        (b"notjson", "malformed"),
        (make_record(3, schema=entry_mod.DELETION_SCHEMA), "deletion"),
        (make_record(4, realm=1), "realm_mismatch"),
    ]:
        fields, reason = entry_mod.record_to_fields(bad, "testnet")
        assert fields is None and reason == want


def test_convert_group_skip_offset_and_tally():
    """convert_group honors the cursor skip and tallies every reason."""
    records = [
        make_record(1),
        make_record(2),
        make_record(3, schema=entry_mod.DELETION_SCHEMA),
        b"junk",
        make_record(4),
    ]
    fields, tally = entry_mod.convert_group(records, 1, "testnet")
    assert [f[0] for f in fields] == [make_iscc_id(2), make_iscc_id(4)]
    assert tally == {"ok": 2, "deletion": 1, "malformed": 1, "unknown_schema": 0, "realm_mismatch": 0}


def test_convert_pool_inline_when_zero():
    """workers=0 never spawns a worker process."""
    pool = poller.ConvertPool(0)

    async def go():
        return await pool.convert([make_record(1)], 0, "testnet")

    fields, tally = run_async(go())
    assert tally["ok"] == 1 and pool._procs == []
    pool.close()


def test_convert_pool_worker_roundtrip():
    """A real spawned worker converts identically to the inline path, is
    reused across calls, and close() reaps it."""
    records = [make_record(i) for i in range(1, 6)] + [b"junk"]
    pool = poller.ConvertPool(1)
    try:

        async def go():
            return await pool.convert(records, 0, "testnet")

        fields, tally = run_async(go())
        assert len(pool._procs) == 1  # really went through the pool
        inline_fields, inline_tally = entry_mod.convert_group(records, 0, "testnet")
        assert fields == inline_fields and tally == inline_tally
        fields2, _ = run_async(go())
        assert fields2 == inline_fields and len(pool._procs) == 1  # reused, not respawned
        proc = pool._procs[0]
    finally:
        pool.close()
    assert pool._procs == [] and proc.poll() is not None  # reaped


def test_convert_pool_broken_falls_back(monkeypatch):
    """A pool failure degrades to inline conversion permanently."""
    pool = poller.ConvertPool(1)

    def boom(records, skip, network):
        raise OSError("no processes for you")

    monkeypatch.setattr(pool, "_roundtrip", boom)

    async def go():
        return await pool.convert([make_record(1)], 0, "testnet")

    fields, tally = run_async(go())
    assert tally["ok"] == 1 and not pool.active
    # Second call stays inline without touching the pool again
    monkeypatch.setattr(
        pool, "_roundtrip", lambda *a: (_ for _ in ()).throw(AssertionError("must not use the pool"))
    )
    fields, tally = run_async(go())
    assert tally["ok"] == 1
    pool.close()


def test_convert_pool_dead_worker_degrades_inline():
    """A worker that dies mid-stream is reaped and the pool goes inline."""
    pool = poller.ConvertPool(1)
    records = [make_record(1)]

    async def go():
        return await pool.convert(records, 0, "testnet")

    fields, tally = run_async(go())
    assert tally["ok"] == 1 and len(pool._procs) == 1
    pool._procs[0].kill()
    pool._procs[0].wait()
    fields, tally = run_async(go())  # detects EOF, falls back inline
    assert tally["ok"] == 1 and not pool.active and pool._procs == []
    pool.close()


def test_convert_pool_checkout_cap_converts_inline():
    """With every worker checked out, the calling thread converts inline."""
    pool = poller.ConvertPool(1)
    try:
        first = pool._checkout()
        assert first is not None and pool._checkout() is None  # cap reached
        fields, tally = pool._roundtrip([make_record(1)], 0, "testnet")
        assert tally["ok"] == 1 and pool._idle == []  # inline, no worker used
    finally:
        pool.close()


def test_convert_pool_cancelled_convert_consumes_orphan(monkeypatch):
    """Cancelling convert() mid-roundtrip leaves the thread to finish in the
    background (shield) and consumes its eventual exception via the orphan
    callback instead of leaving an un-retrieved task exception."""
    import threading

    pool = poller.ConvertPool(1)
    gate, release = threading.Event(), threading.Event()
    orphans = []
    monkeypatch.setattr(poller, "_log_orphan_convert", orphans.append)

    def blocking_roundtrip(records, skip, network):
        gate.set()
        release.wait(10)
        raise EOFError("conversion worker exited")  # post-close() outcome

    monkeypatch.setattr(pool, "_roundtrip", blocking_roundtrip)

    async def go():
        task = asyncio.ensure_future(pool.convert([make_record(1)], 0, "testnet"))
        await asyncio.to_thread(gate.wait, 10)
        task.cancel()
        with pytest.raises(asyncio.CancelledError):
            await task
        release.set()
        for _ in range(500):  # orphan thread finishes; callback fires
            if orphans:
                break
            await asyncio.sleep(0.01)
        assert orphans, "orphan done-callback never registered/fired"
        exc = orphans[0].exception()
        assert isinstance(exc, EOFError)
        # Cancellation must not poison the pool for later calls
        assert not pool._broken

    run_async(go())
    pool.close()


def test_log_orphan_convert_outcomes():
    """The orphan consumer tolerates cancelled / failed / clean tasks."""

    async def go():
        ok = asyncio.ensure_future(asyncio.sleep(0))
        await ok
        poller._log_orphan_convert(ok)  # clean: no-op

        failed = asyncio.ensure_future(asyncio.to_thread(lambda: (_ for _ in ()).throw(EOFError("x"))))
        with pytest.raises(EOFError):
            await failed
        poller._log_orphan_convert(failed)  # exception: logged, consumed

        cancelled = asyncio.ensure_future(asyncio.sleep(60))
        cancelled.cancel()
        with pytest.raises(asyncio.CancelledError):
            await cancelled
        poller._log_orphan_convert(cancelled)  # cancelled: no exception() call

    run_async(go())


def test_worker_pythonpath_exclude_override(monkeypatch):
    """An empty ISCC_SEARCH_WORKER_PYTHONPATH_EXCLUDE disables the
    PYTHONPATH filter (the filter token is configuration, not code)."""
    import os as os_mod

    monkeypatch.setenv("PYTHONPATH", "/x/hook_site" + os_mod.pathsep + "/b")
    monkeypatch.setattr(poller, "WORKER_PYTHONPATH_EXCLUDE", "")
    env = poller._worker_env()
    assert "/x/hook_site" in env["PYTHONPATH"].split(os_mod.pathsep)


def test_worker_pythonpath_exclude_component_not_substring(monkeypatch):
    """The exclude token matches whole path COMPONENTS: an unrelated entry
    that merely contains it (hook_site_backup) must survive the filter."""
    import os as os_mod

    monkeypatch.setattr(poller, "WORKER_PYTHONPATH_EXCLUDE", "hook_site")
    monkeypatch.setenv(
        "PYTHONPATH",
        os_mod.pathsep.join(["/home/hook_site_backup/lib", "/x/hook_site", "/x/hook_site/sub", "/b"]),
    )
    env = poller._worker_env()
    parts = env["PYTHONPATH"].split(os_mod.pathsep)
    assert "/home/hook_site_backup/lib" in parts  # contains token, kept
    assert "/x/hook_site" not in parts  # component match, stripped
    assert "/x/hook_site/sub" not in parts  # mid-path component, stripped
    assert "/b" in parts


def test_worker_env_hermetic_no_global_mutation(monkeypatch):
    """_worker_env strips excluded entries into a PRIVATE dict; os.environ intact."""
    import os as os_mod

    monkeypatch.setattr(poller, "WORKER_PYTHONPATH_EXCLUDE", "hook_site")
    monkeypatch.setenv("PYTHONPATH", "/a" + os_mod.pathsep + "/x/hook_site" + os_mod.pathsep + "/b")
    monkeypatch.setenv("JAX_PLATFORMS", "cuda")
    env = poller._worker_env()
    assert "hook_site" not in env["PYTHONPATH"]
    assert "/a" in env["PYTHONPATH"] and "/b" in env["PYTHONPATH"]
    assert env["JAX_PLATFORMS"] == "cpu"
    # The process-global env is untouched (other threads read it concurrently)
    assert "hook_site" in os_mod.environ["PYTHONPATH"]
    assert os_mod.environ["JAX_PLATFORMS"] == "cuda"
    # Re-running with the package parent already on PYTHONPATH keeps it single
    monkeypatch.setenv("PYTHONPATH", env["PYTHONPATH"])
    again = poller._worker_env()
    parts = again["PYTHONPATH"].split(os_mod.pathsep)
    assert len(parts) == len(set(parts))


def test_convert_worker_serve_loop():
    """The worker's frame loop converts one group per request frame."""
    import io

    from iscc_search_tpu.aggregator import convert_worker as cw

    record = make_record(1)
    stdin = io.BytesIO()
    cw.write_frame(stdin, ([record, b"junk"], 0, "testnet"))
    cw.write_frame(stdin, ([make_record(2)], 1, "testnet"))  # skip past everything
    stdin.seek(0)
    out = io.BytesIO()
    assert cw.serve(stdin, out) == 0
    out.seek(0)
    fields, tally = cw.read_frame(out)
    assert tally["ok"] == 1 and tally["malformed"] == 1
    assert fields == entry_mod.convert_group([record, b"junk"], 0, "testnet")[0]
    fields2, tally2 = cw.read_frame(out)
    assert fields2 == [] and tally2["ok"] == 0
    assert cw.read_frame(out) is None  # clean EOF ends the loop


def test_convert_worker_frame_errors():
    """Short header reads as clean EOF; a truncated payload raises."""
    import io

    from iscc_search_tpu.aggregator import convert_worker as cw

    assert cw.read_frame(io.BytesIO(b"")) is None
    assert cw.read_frame(io.BytesIO(b"\x01\x02")) is None
    truncated = io.BytesIO(struct.pack("<Q", 100) + b"short")
    with pytest.raises(EOFError):
        cw.read_frame(truncated)


def test_convert_pool_worker_eof_degrades_inline(monkeypatch):
    """A worker that exits without answering (EOF after a successful write)
    is detected, reaped, and the pool degrades to inline conversion."""
    import subprocess
    import sys as sys_mod

    def spawn_stub():
        # Consumes exactly the request frame, then exits without replying.
        script = (
            "import struct, sys\n"
            "header = sys.stdin.buffer.read(8)\n"
            "(n,) = struct.unpack('<Q', header)\n"
            "sys.stdin.buffer.read(n)\n"
        )
        return subprocess.Popen(
            [sys_mod.executable, "-c", script],
            stdin=subprocess.PIPE,
            stdout=subprocess.PIPE,
        )

    pool = poller.ConvertPool(1)
    monkeypatch.setattr(pool, "_spawn", spawn_stub)

    async def go():
        return await pool.convert([make_record(1)], 0, "testnet")

    fields, tally = run_async(go())
    assert tally["ok"] == 1  # inline fallback still converted
    assert not pool.active and pool._procs == []
    pool.close()


def test_poll_hub_once_short_bundle_errors(agg_setup):
    """A bundle with fewer records than its width claims fails the group
    (and the poll keeps prior cursor progress + surfaces the error)."""
    index, opts = agg_setup
    records = [make_record(i) for i in range(1, 11)]
    fake = FakeLog(records)

    def handler(request):
        response = fake.handler(request)
        if request.url.path.startswith("/log/tile/entries/"):
            # Drop the last record from the framed body: length mismatch
            body = response.content
            trimmed = tlog.parse_entry_bundle(body)[:-1]
            body = b"".join(struct.pack(">H", len(r)) + r for r in trimmed)
            return httpx.Response(200, content=body)
        return response

    client = httpx.AsyncClient(transport=httpx.MockTransport(handler))
    hub = hublist.Hub(hub_id=0, url="https://hub0.example")

    async def go():
        return await poller.poll_hub_once(
            client, hub, 0, index, "idptest", "testnet", asyncio.Event()
        )

    result = run_async(go())
    assert result.error is not None and "expected" in result.error
    assert result.last_size == 0
    assert index.get_index("idptest").assets == 0


def test_poll_hub_once_stop_preset_skips_groups(agg_setup):
    """A stop event set before the group loop leaves the cursor untouched."""
    index, opts = agg_setup
    fake = FakeLog([make_record(i) for i in range(1, 11)])
    client = httpx.AsyncClient(transport=httpx.MockTransport(fake.handler))
    hub = hublist.Hub(hub_id=0, url="https://hub0.example")
    stop = asyncio.Event()
    stop.set()

    async def go():
        return await poller.poll_hub_once(client, hub, 0, index, "idptest", "testnet", stop)

    result = run_async(go())
    assert result.last_size == 0 and result.error is None
    assert index.get_index("idptest").assets == 0


def test_poll_hub_once_prefetch_cancelled_on_group_failure(agg_setup):
    """With the pipeline active, a failing group cancels the already-prefetched
    successor group (it is re-fetched next poll; idempotent upserts make the
    discard safe) and keeps the committed cursor."""
    index, opts = agg_setup
    records = [make_record(i) for i in range(1, 601)]  # 3 one-bundle groups
    fake = FakeLog(records)
    fake.fail_bundles.add(1)  # group 1 of 3 fails; group 2 is prefetched
    client = httpx.AsyncClient(transport=httpx.MockTransport(fake.handler))
    hub = hublist.Hub(hub_id=0, url="https://hub0.example")
    pool = poller.ConvertPool(1)

    async def go():
        try:
            return await poller.poll_hub_once(
                client, hub, 0, index, "idptest", "testnet", asyncio.Event(), convert=pool
            )
        finally:
            pool.close()

    old = poller.GROUP_BUNDLES
    poller.GROUP_BUNDLES = 1
    try:
        result = run_async(go())
    finally:
        poller.GROUP_BUNDLES = old
    assert result.error is not None and "bundle 1 failed" in result.error
    assert result.last_size == 256  # group 0 committed, nothing past it
    assert result.counts["ok"] == 256
    assert index.get_index("idptest").assets == 256


def test_sync_backend_durability_barrier():
    """_sync_backend calls the index's sync hook when present, else no-ops."""

    class Syncable:
        synced = None

        def sync(self, index_name):
            self.synced = index_name

    target = Syncable()
    poller._sync_backend(target, "idx")
    assert target.synced == "idx"
    poller._sync_backend(object(), "idx")  # no sync attribute: benign no-op

    class NotCallable:
        sync = "nope"

    poller._sync_backend(NotCallable(), "idx")  # non-callable: benign no-op


def test_roster_refresh_debounced(agg_setup):
    """A second refresh inside the refresh interval makes no HTTP request."""
    index, opts = agg_setup
    calls = []

    def handler(request):
        calls.append(request.url.path)
        return httpx.Response(200, text=HUBS_YAML)

    client = httpx.AsyncClient(transport=httpx.MockTransport(handler))
    roster = poller._Roster(opts)

    async def go():
        await roster.refresh(client, {})
        await roster.refresh(client, {})  # inside the interval: debounced

    run_async(go())
    assert len(calls) == 1
    assert [h.hub_id for h in roster.hubs] == [0]


def test_poll_loop_stop_during_roster_refresh(agg_setup):
    """A stop that lands during the roster refresh breaks out of the hub
    iteration before any hub is polled."""
    index, opts = agg_setup
    stop = asyncio.Event()
    polled = []

    def handler(request):
        if request.url.path == "/hubs.yaml":
            stop.set()  # stop arrives while the roster refreshes
            return httpx.Response(200, text=HUBS_YAML)
        polled.append(request.url.path)
        return httpx.Response(500)

    client = httpx.AsyncClient(transport=httpx.MockTransport(handler))
    status = {}

    run_async(poller.poll_loop(index, opts, stop, client, status))
    assert polled == []  # no hub poll happened after the stop


def test_poll_loop_second_cycle_reuses_state(agg_setup):
    """Two poll cycles: the second goes through the interval timeout and
    reuses the existing HubStatus row instead of reseeding it."""
    index, opts = agg_setup
    opts = opts.model_copy(update={"aggregator_poll_interval": 1})
    records = [make_record(i) for i in range(1, 4)]
    fake = FakeLog(records)
    client = httpx.AsyncClient(transport=httpx.MockTransport(fake.handler))
    status = {}
    stop = asyncio.Event()

    async def go():
        async def stopper():
            for _ in range(800):
                await asyncio.sleep(0.01)
                state = status.get(0)
                if state and state.last_poll and len(polls) >= 2:
                    break
            stop.set()

        polls = []
        original = poller.poll_hub_once

        async def counting(*args, **kwargs):
            result = await original(*args, **kwargs)
            polls.append(result)
            return result

        poller_poll = poller.poll_hub_once
        poller.poll_hub_once = counting
        try:
            await asyncio.gather(poller.poll_loop(index, opts, stop, client, status), stopper())
        finally:
            poller.poll_hub_once = poller_poll
        return polls

    polls = run_async(go())
    assert len(polls) >= 2  # second cycle ran after the interval timeout
    first_state = status[0]
    assert first_state.cursor == 3 and first_state.counts["ok"] == 3
    assert index.get_index("idptest").assets == 3


def make_poison_record(n):
    """A record that converts to fields but fails IsccEntry validation:
    an iscc_code that is a lone raw INSTANCE unit dedupes against the
    datahash INSTANCE to a single-element units list (< min_length 2)."""
    iscc_id = make_iscc_id(n)
    datahash = "1e20" + hashlib.sha256(str(n).encode()).hexdigest()
    code = "ISCC:" + ic.encode_component(ic.MT.INSTANCE, 0, 0, 64, bytes.fromhex(datahash[4:]))
    note = {"$schema": entry_mod.DECLARATION_SCHEMA, "iscc_code": code, "datahash": datahash}
    return json.dumps({"iscc_id": iscc_id, "note": note}).encode()


def test_record_to_entry_validation_failure_is_skip():
    """Wire-model rejection classifies as 'malformed', never raises."""
    fields, reason = entry_mod.record_to_fields(make_poison_record(1), "testnet")
    assert reason == "ok" and fields is not None  # primitives convert fine
    entry, reason = entry_mod.record_to_entry(make_poison_record(1), "testnet")
    assert entry is None and reason == "malformed"


def test_poll_hub_once_poison_record_does_not_stall(agg_setup):
    """One validation-poison record is dropped + tallied; the cursor still
    advances past it (a crash here would re-fetch and re-crash forever)."""
    index, opts = agg_setup
    records = [make_record(1), make_poison_record(2), make_record(3)]
    fake = FakeLog(records)
    client = httpx.AsyncClient(transport=httpx.MockTransport(fake.handler))
    hub = hublist.Hub(hub_id=0, url="https://hub0.example")

    async def go():
        stop = asyncio.Event()
        return await poller.poll_hub_once(client, hub, 0, index, "idptest", "testnet", stop)

    result = run_async(go())
    assert result.error is None
    assert result.last_size == 3
    assert result.counts["ok"] == 2 and result.counts["malformed"] == 1
    assert index.get_index("idptest").assets == 2


def test_poll_hub_once_pipelined_with_pool(agg_setup):
    """End-to-end ingest through poll_hub_once with a live conversion pool
    (multiple groups, so the prefetch pipeline actually overlaps)."""
    index, opts = agg_setup
    records = [make_record(i) for i in range(1, 601)]
    fake = FakeLog(records)
    client = httpx.AsyncClient(transport=httpx.MockTransport(fake.handler))
    hub = hublist.Hub(hub_id=0, url="https://hub0.example")
    pool = poller.ConvertPool(1)

    async def go():
        stop = asyncio.Event()
        try:
            return await poller.poll_hub_once(
                client, hub, 0, index, "idptest", "testnet", stop, convert=pool
            )
        finally:
            pool.close()

    # Pin the group size so the 600-record log spans 3 pipelined groups.
    old = poller.GROUP_BUNDLES
    poller.GROUP_BUNDLES = 1
    try:
        result = run_async(go())
    finally:
        poller.GROUP_BUNDLES = old
    assert result.error is None
    assert result.last_size == 600
    assert result.counts["ok"] == 600
    assert index.get_index("idptest").assets == 600
