"""Branch-coverage round 8: aggregator entry/cursor edges, CLI error paths,
server edge responses, device-backend manager resilience, distributed init."""

import hashlib
import json

import httpx
import pytest
from click.testing import CliRunner

from iscc_search_tpu import codec as ic
from iscc_search_tpu.aggregator import cursors as cursors_mod
from iscc_search_tpu.aggregator import entry as entry_mod
from iscc_search_tpu.cli import cli
from iscc_search_tpu.cli import common as cli_common
from iscc_search_tpu.config import ConfigManager
from iscc_search_tpu.indexes.memory import MemoryIndex
from iscc_search_tpu.options import SearchOptions
from iscc_search_tpu.server.app import create_app, init_sentry

from tests.conftest import make_iscc_id, make_unit


# ------------------------------------------------------------ entry edges


def _record(note_overrides=None, units=None):
    datahash = "1e20" + hashlib.sha256(b"cov8").hexdigest()
    data_unit = make_unit(ic.MT.DATA, 0, 64)
    inst_unit = "ISCC:" + ic.encode_component(ic.MT.INSTANCE, 0, 0, 64, bytes.fromhex(datahash[4:]))
    code = ic.gen_iscc_code_v0([data_unit, inst_unit], wide=False)["iscc"]
    note = {"$schema": entry_mod.DECLARATION_SCHEMA, "iscc_code": code, "datahash": datahash}
    if units is not None:
        note["units"] = units
    note.update(note_overrides or {})
    return json.dumps({"iscc_id": make_iscc_id(8101), "note": note}).encode(), data_unit


def test_record_short_datahash_is_malformed():
    """A datahash whose digest is shorter than 32 bytes classifies as
    malformed (the INSTANCE unit cannot be derived at 256 bits)."""
    record, _ = _record(note_overrides={"datahash": "1e20" + "ab" * 8})
    fields, reason = entry_mod.record_to_fields(record, "testnet")
    assert fields is None and reason == "malformed"


def test_note_units_string_path_and_tie_keeps_first():
    """note.units strings flow through the string branch of _widest_per_type;
    an equal-width same-type unit does NOT replace the incumbent."""
    rival = make_unit(ic.MT.DATA, 0, 64)  # same type + width as the code's DATA
    record, data_unit = _record(units=[rival])
    fields, reason = entry_mod.record_to_fields(record, "testnet")
    assert reason == "ok"
    _, _, units, _ = fields
    assert data_unit in units and rival not in units  # first wins ties


def test_note_units_wider_unit_replaces_incumbent():
    """A wider same-type unit in note.units replaces the code-derived one."""
    wide = make_unit(ic.MT.DATA, 0, 256)
    record, data_unit = _record(units=[wide])
    fields, reason = entry_mod.record_to_fields(record, "testnet")
    assert reason == "ok"
    _, _, units, _ = fields
    assert wide in units and data_unit not in units


# ------------------------------------------------------------ cursor edges


def test_cursor_save_failure_warns_and_cleans_tmp(tmp_path, monkeypatch, caplog):
    """A failed cursor save logs a warning, removes the temp file, and never
    raises (cursor persistence is an optimization, not a correctness
    dependency)."""
    store = cursors_mod.CursorStore(tmp_path / "cursors.json", "testnet")

    def boom(_src, _dst):
        raise OSError("disk detached")

    monkeypatch.setattr(cursors_mod.os, "replace", boom)
    with caplog.at_level("WARNING"):
        store.save({0: 42})
    monkeypatch.undo()
    assert "failed to persist cursors" in caplog.text
    assert list(tmp_path.iterdir()) == []  # tmp file cleaned up
    assert store.load() == {}
    # The unpatched store works in the same directory afterwards
    store.save({0: 42})
    assert store.load() == {0: 42}


def test_cursor_store_for_schemeless_uri():
    """A scheme-less index URI (bare path) gets no cursor store."""
    opts = SearchOptions(index_uri="memory://", aggregator_mode=True)
    opts = opts.model_copy(update={"index_uri": "/bare/path"})
    assert cursors_mod.cursor_store_for(opts) is None


# ------------------------------------------------------------ CLI edges


@pytest.fixture
def runner(tmp_path):
    manager = ConfigManager(config_dir=tmp_path / "cfg")
    cli_common.set_config_manager(manager)
    yield CliRunner(), manager, tmp_path
    cli_common.set_config_manager(None)


def test_index_add_duplicate_name_exits_red(runner, tmp_path):
    r, _, base = runner
    assert r.invoke(cli, ["index", "add", "dup", "--path", str(base / "d")]).exit_code == 0
    result = r.invoke(cli, ["index", "add", "dup", "--path", str(base / "d2")])
    assert result.exit_code == 1
    assert "dup" in result.output


def test_index_use_unknown_exits_red(runner):
    r, _, _ = runner
    result = r.invoke(cli, ["index", "use", "ghost"])
    assert result.exit_code == 1


def test_index_remove_unknown_exits_red(runner):
    r, _, _ = runner
    result = r.invoke(cli, ["index", "remove", "ghost"])
    assert result.exit_code == 1


def test_index_remove_delete_data_removes_dir(runner, tmp_path):
    r, _, base = runner
    data = base / "deldata"
    assert r.invoke(cli, ["index", "add", "victim", "--path", str(data)]).exit_code == 0
    target = data / "victim"  # index data lives at <path>/<name>
    target.mkdir(parents=True, exist_ok=True)
    (target / "file.bin").write_bytes(b"x")
    result = r.invoke(cli, ["index", "remove", "victim", "--delete-data"])
    assert result.exit_code == 0
    assert not target.exists()


def test_index_add_default_path_uses_user_data_dir(runner, tmp_path, monkeypatch):
    """index add without --path/--url places the index under the user data dir."""
    import types

    import iscc_search_tpu

    r, manager, _ = runner
    stub = types.SimpleNamespace(user_data_dir=str(tmp_path / "xdg"))
    monkeypatch.setattr(iscc_search_tpu, "dirs", stub)
    result = r.invoke(cli, ["index", "add", "defaulted"])
    assert result.exit_code == 0, result.output
    assert str(tmp_path / "xdg") in str(manager.list()["defaulted"].path)


def test_index_rebuild_requires_a_target(runner, tmp_path):
    r, _, base = runner
    assert r.invoke(cli, ["index", "add", "main", "--path", str(base / "d")]).exit_code == 0
    result = r.invoke(cli, ["index", "rebuild"])
    assert result.exit_code == 1
    assert "--unit-type" in result.output


def test_add_skips_invalid_json_file(runner, tmp_path, caplog):
    r, _, base = runner
    assert r.invoke(cli, ["index", "add", "main", "--path", str(base / "d")]).exit_code == 0
    bad = base / "bad.iscc.json"
    bad.write_text("{not json")
    result = r.invoke(cli, ["add", str(bad)])
    assert result.exit_code == 0, result.output
    assert "0 created" in result.output or "skipped" in result.output.lower()


def test_add_directory_collects_ndjson_and_jsonl(runner, tmp_path, entry_factory):
    """A directory argument collects *.iscc.json, *.ndjson AND *.jsonl files;
    invalid lines and entry-less lines inside ndjson are skipped."""
    r, _, base = runner
    assert r.invoke(cli, ["index", "add", "main", "--path", str(base / "d")]).exit_code == 0
    src = base / "srcdir"
    src.mkdir()
    good = entry_factory()
    lines = [
        json.dumps(good),
        "{broken json",
        json.dumps({"metadata": {"no": "codes"}}),  # no iscc_code/units -> skipped
    ]
    (src / "batch.jsonl").write_text("\n".join(lines))
    (src / "one.iscc.json").write_text(json.dumps(entry_factory()))
    result = r.invoke(cli, ["add", str(src)])
    assert result.exit_code == 0, result.output
    assert "2 created" in result.output


def test_add_small_batch_size_flushes_midstream(runner, tmp_path, entry_factory):
    r, _, base = runner
    assert r.invoke(cli, ["index", "add", "main", "--path", str(base / "d")]).exit_code == 0
    src = base / "many"
    src.mkdir()
    entries = [entry_factory() for _ in range(3)]
    (src / "batch.ndjson").write_text("\n".join(json.dumps(e) for e in entries))
    result = r.invoke(cli, ["add", str(src), "--batch-size", "2"])
    assert result.exit_code == 0, result.output
    assert "3 created" in result.output


# ------------------------------------------------------------ server edges


@pytest.fixture
def client():
    app = create_app(index=MemoryIndex(), opts=SearchOptions(index_uri="memory://"))
    transport = httpx.WSGITransport(app=app)
    with httpx.Client(transport=transport, base_url="http://testserver") as c:
        yield c


def test_init_sentry_success_with_stub(monkeypatch):
    """With a DSN and an importable sentry_sdk, init runs with the options'
    DSN and sample rate."""
    import sys
    import types

    calls = {}
    stub = types.ModuleType("sentry_sdk")
    stub.init = lambda **kw: calls.update(kw)
    monkeypatch.setitem(sys.modules, "sentry_sdk", stub)
    opts = SearchOptions(index_uri="memory://", sentry_dsn="https://k@sentry.example/1")
    assert init_sentry(opts) is True
    assert calls["dsn"] == "https://k@sentry.example/1"
    assert calls["traces_sample_rate"] == opts.sentry_traces_sample_rate


def test_create_app_builds_index_from_options(tmp_path, monkeypatch):
    """create_app(index=None) constructs the backend from opts.index_uri and
    registers its close with atexit (captured here so the close runs inside
    the test, not after pytest tears the log streams down)."""
    from iscc_search_tpu.server import app as app_mod

    closers = []
    monkeypatch.setattr(app_mod.atexit, "register", closers.append)
    opts = SearchOptions(index_uri=f"tpu://{tmp_path / 'auto'}")
    app = create_app(opts=opts)
    transport = httpx.WSGITransport(app=app)
    with httpx.Client(transport=transport, base_url="http://testserver") as c:
        assert c.get("/healthz").json() == {"status": "ok"}
        assert c.post("/indexes", json={"name": "boot"}).status_code == 201
    assert len(closers) == 1
    closers[0]()


def test_readyz_not_ready_when_backend_fails():
    """A backend whose list_indexes raises turns /readyz into 503."""

    class Broken(MemoryIndex):
        def list_indexes(self):
            raise RuntimeError("backend down")

    app = create_app(index=Broken(), opts=SearchOptions(index_uri="memory://"))
    transport = httpx.WSGITransport(app=app)
    with httpx.Client(transport=transport, base_url="http://testserver") as c:
        r = c.get("/readyz")
        assert r.status_code == 503
        assert r.json()["reason"] == "list_indexes_failed"


def test_search_non_integer_limit_is_422(client):
    client.post("/indexes", json={"name": "s"})
    r = client.post("/indexes/s/search?limit=abc", json={"iscc_code": "ISCC:EAASKDNZNYGUUF5A"})
    assert r.status_code == 422
    assert "integer" in r.json()["detail"]


def test_static_unknown_file_404(client):
    assert client.get("/static/nosuchfile.js").status_code == 404


# --------------------------------------------------------- device manager


def test_manager_list_skips_corrupt_index_dir(tmp_path, caplog):
    from iscc_search_tpu.indexes.tpu.manager import TpuIndexManager

    mgr = TpuIndexManager(tmp_path)
    from iscc_search_tpu.schema import IsccIndex

    mgr.create_index(IsccIndex(name="good"))
    # A directory that LOOKS like an index but whose store is garbage
    bad = tmp_path / "badidx"
    (bad / "store").mkdir(parents=True)
    (bad / "store" / "data.tstore").write_bytes(b"\x00" * 7)
    with caplog.at_level("WARNING"):
        names = [i.name for i in mgr.list_indexes()]
    assert names == ["good"] or names == ["badidx", "good"]
    mgr.close()


def test_manager_delete_closes_cached_instance(tmp_path):
    from iscc_search_tpu.indexes.tpu.manager import TpuIndexManager
    from iscc_search_tpu.schema import IsccIndex

    mgr = TpuIndexManager(tmp_path)
    mgr.create_index(IsccIndex(name="cached"))
    idx = mgr._get_or_open("cached") if hasattr(mgr, "_get_or_open") else None
    if idx is None:  # fall back to the public read path to populate the cache
        mgr.get_index("cached")
    mgr.delete_index("cached")
    assert "cached" not in [i.name for i in mgr.list_indexes()]
    mgr.close()


def test_manager_sizes_include_unknown_component_dirs(tmp_path):
    """An extra on-disk component directory shows up in the size breakdown."""
    from iscc_search_tpu.indexes.tpu.manager import TpuIndexManager
    from iscc_search_tpu.schema import IsccIndex

    mgr = TpuIndexManager(tmp_path)
    mgr.create_index(IsccIndex(name="sz"))
    extra = tmp_path / "sz" / "mystery"
    extra.mkdir()
    (extra / "blob.bin").write_bytes(b"z" * 2048)
    listed = {i.name: i for i in mgr.list_indexes()}
    assert "sz" in listed
    sizes = listed["sz"].sizes or {}
    assert "mystery" in sizes
    mgr.close()


# ------------------------------------------------------------ distributed


def test_distributed_initialize_joins_cluster(monkeypatch):
    """With a coordinator configured, init_distributed calls
    jax.distributed.initialize and logs the joined topology."""
    import jax

    from iscc_search_tpu.parallel import distributed

    called = {}

    def fake_init(coordinator_address=None, num_processes=None, process_id=None):
        called.update(
            coordinator_address=coordinator_address, num_processes=num_processes, process_id=process_id
        )

    monkeypatch.setattr(jax.distributed, "initialize", fake_init)
    distributed.init_distributed(
        coordinator_address="127.0.0.1:9999", num_processes=1, process_id=0
    )
    assert called == {"coordinator_address": "127.0.0.1:9999", "num_processes": 1, "process_id": 0}


# ------------------------------------------------------------ ops validation


def test_pm1_topk_rejects_indivisible_chunks():
    import jax.numpy as jnp
    import numpy as np

    from iscc_search_tpu.ops import pm1_scan

    q = jnp.asarray(np.ones((1, 64), np.int8))
    scale = jnp.asarray(np.full(1, 1 / 128, np.float32))
    db = jnp.asarray(np.zeros((100, 2), np.uint32))
    valid = jnp.asarray(np.ones(100, bool))
    with pytest.raises(ValueError, match="not a multiple"):
        pm1_scan.pm1_topk_impl(q, scale, db, valid, k=4, nbits=64, chunk_size=64)
    with pytest.raises(ValueError, match="divide"):
        pm1_scan.pm1_blockmax_topk_impl(
            q, scale, db, valid, k=4, nbits=64, chunk_size=64, block=128
        )


def test_serve_cli_rejects_aggregator_with_workers(runner, monkeypatch):
    """Aggregator mode + multi-worker scale-out is a config error (one poller).

    The search_opts singleton is built at import time, so env vars set here
    would be invisible — patch the derived-field source on the instance.
    """
    r, _, _ = runner
    from iscc_search_tpu import options as options_mod

    monkeypatch.setattr(options_mod.search_opts, "aggregator_network", "testnet")
    result = r.invoke(cli, ["serve", "--workers", "2"])
    assert result.exit_code == 1
    assert "single worker" in result.output


def test_aggregator_runner_stop_before_start_is_noop():
    from iscc_search_tpu.server.httpd import AggregatorRunner

    runner = AggregatorRunner(MemoryIndex(), SearchOptions(index_uri="memory://"), {})
    runner.stop()  # never started: must not raise


def test_options_from_env_skips_empty_strings(monkeypatch):
    """An env var present but EMPTY falls back to the default (never passes
    '' into field validation)."""
    monkeypatch.setenv("ISCC_SEARCH_INDEX_URI", "")
    monkeypatch.setenv("ISCC_SEARCH_PORT", "9001")
    opts = SearchOptions.from_env()
    assert opts.port == 9001
    assert opts.index_uri == SearchOptions().index_uri


def test_get_index_defaults_to_options_uri(monkeypatch):
    from iscc_search_tpu import options as options_mod

    monkeypatch.setattr(options_mod.search_opts, "index_uri", "memory://")
    idx = options_mod.get_index(None)
    assert isinstance(idx, MemoryIndex)
    idx.close()
