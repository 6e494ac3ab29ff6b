"""
Branch-coverage fillers: the gate (scripts/pycov.py, [tool.pycov] branch_min)
measures both outcomes of every source-level branch; these tests exercise
the error paths, guard rails, and layout-combination arms that the feature
suites never hit — the reference enforces 100% line+branch
(/root/reference/pyproject.toml:106-113), this suite closes the same class
of gaps.
"""

import asyncio
import json
import threading
import time

import numpy as np
import pytest
from click.testing import CliRunner


from iscc_search_tpu.cli import cli
from iscc_search_tpu.cli import common as cli_common
from iscc_search_tpu.config import ConfigManager


@pytest.fixture
def runner(tmp_path):
    manager = ConfigManager(config_dir=tmp_path / "cfg")
    cli_common.set_config_manager(manager)
    yield CliRunner(), manager, tmp_path
    cli_common.set_config_manager(None)


# ------------------------------------------------------------ cli/index.py


def test_index_list_empty_and_discovered(runner, monkeypatch):
    r, manager, _ = runner
    result = r.invoke(cli, ["index", "list"])
    assert result.exit_code == 0
    assert "No indexes configured" in result.output
    monkeypatch.setattr(manager, "discover", lambda: ["found-on-disk"])
    result = r.invoke(cli, ["index", "list"])
    assert "found-on-disk" in result.output


def test_index_list_remote_location_and_active_mark(runner, tmp_path):
    r, manager, base = runner
    r.invoke(cli, ["index", "add", "loc", "--path", str(base / "d")])
    r.invoke(cli, ["index", "add", "rem", "--url", "https://api.example", "--no-use"])
    result = r.invoke(cli, ["index", "list"])
    assert result.exit_code == 0
    assert "https://api.example" in result.output  # remote location arm
    assert "*" in result.output  # active mark arm


def test_index_add_default_path(runner, monkeypatch, tmp_path):
    r, manager, _ = runner
    import iscc_search_tpu

    class FakeDirs:
        user_data_dir = str(tmp_path / "default")

    monkeypatch.setattr(iscc_search_tpu, "dirs", FakeDirs())
    result = r.invoke(cli, ["index", "add", "defpath"])
    assert result.exit_code == 0
    assert "defpath" in result.output


def test_index_remove_delete_data(runner, tmp_path):
    r, manager, base = runner
    data = base / "data"
    r.invoke(cli, ["index", "add", "doomed", "--path", str(data)])
    (data / "doomed").mkdir(parents=True)
    (data / "doomed" / "x.bin").write_bytes(b"x")
    result = r.invoke(cli, ["index", "remove", "doomed", "--delete-data"])
    assert result.exit_code == 0
    assert not (data / "doomed").exists()
    # removing a remote entry with --delete-data touches nothing on disk
    r.invoke(cli, ["index", "add", "rem2", "--url", "https://api.example"])
    result = r.invoke(cli, ["index", "remove", "rem2", "--delete-data"])
    assert result.exit_code == 0
    # --delete-data when the data dir never existed
    r.invoke(cli, ["index", "add", "ghost", "--path", str(base / "nodata")])
    result = r.invoke(cli, ["index", "remove", "ghost", "--delete-data"])
    assert result.exit_code == 0


def test_index_rebuild_requires_scope(runner):
    r, _, _ = runner
    result = r.invoke(cli, ["index", "rebuild"])
    assert result.exit_code == 1
    assert "Specify" in result.output


def test_index_rebuild_unsupported_backend(runner, monkeypatch):
    r, manager, _ = runner

    class NoRebuild:
        closed = False

        def close(self):
            self.closed = True

    stub = NoRebuild()
    monkeypatch.setattr("iscc_search_tpu.cli.common.get_active_index", lambda name=None: (stub, "x"))
    result = r.invoke(cli, ["index", "rebuild", "--all"])
    assert result.exit_code == 1
    assert "does not support rebuild" in result.output
    assert stub.closed


def test_index_rebuild_explicit_types(runner, tmp_path):
    r, manager, base = runner
    r.invoke(cli, ["index", "add", "reb", "--path", str(base / "rdata")])
    result = r.invoke(cli, ["index", "rebuild", "reb", "--unit-type", "DATA_NONE_V0_64"])
    assert result.exit_code == 0, result.output
    result = r.invoke(cli, ["index", "rebuild", "reb", "--all"])
    assert result.exit_code == 0, result.output


# ------------------------------------------------------------ cli/common.py


def test_get_active_index_errors(runner):
    _, manager, _ = runner
    with pytest.raises(ValueError, match="not found"):
        cli_common.get_active_index("missing")
    with pytest.raises(ValueError, match="No active index"):
        cli_common.get_active_index()


def test_get_active_index_remote(runner):
    r, manager, _ = runner
    manager.add_remote("rm", "https://api.example", "remote-idx", api_key=None, use=True)
    index, name = cli_common.get_active_index()
    assert name == "remote-idx"
    assert type(index).__name__ == "RemoteIndex"


def test_parse_simprints_edge_paths():
    parse = cli_common.parse_simprints_from_features
    assert parse([]) is None
    # missing maintype/subtype/simprints -> skipped
    assert parse([{"maintype": "", "subtype": "TEXT", "simprints": ["AA"]}]) is None
    # array length mismatch -> trimmed
    out = parse(
        [{"maintype": "CONTENT", "subtype": "TEXT", "simprints": ["YWJjZGVmZ2g", "aWprbG1ub3A"], "offsets": [0], "sizes": [4]}]
    )
    assert len(out["CONTENT_TEXT_V0"]) == 1
    # truncation shorter than requested bits -> entry dropped -> feature empty
    out = parse(
        [{"maintype": "CONTENT", "subtype": "TEXT", "simprints": ["YWI"], "offsets": [0], "sizes": [1]}],
        simprint_bits=256,
    )
    assert out is None
    # valid truncation arm
    out = parse(
        [{"maintype": "CONTENT", "subtype": "TEXT", "simprints": ["YWJjZGVmZ2g"], "offsets": [0], "sizes": [8]}],
        simprint_bits=32,
    )
    assert len(out["CONTENT_TEXT_V0"]) == 1


# ------------------------------------------------------------ cli/serve.py


def test_serve_guards(runner, monkeypatch):
    r, _, _ = runner
    served = []
    monkeypatch.setattr("iscc_search_tpu.server.httpd.serve", lambda opts: served.append(opts))
    # workers > 1 with a persistent backend -> allowed (scale-out topology:
    # the parent keeps exclusive index ownership, workers go through IPC)
    result = r.invoke(cli, ["serve", "--index-uri", "kv:///tmp/x", "--workers", "2"])
    assert result.exit_code == 0, result.output
    assert served and served[-1].workers == 2
    # workers > 1 with aggregator mode -> refused (one poller)
    import iscc_search_tpu.options as options_mod

    agg_opts = options_mod.SearchOptions(index_uri="memory://", aggregator_network="testnet")
    monkeypatch.setattr(options_mod, "search_opts", agg_opts)
    result = r.invoke(cli, ["serve", "--index-uri", "memory://", "--workers", "2"])
    assert result.exit_code == 1
    # workers > 1 on memory:// without aggregator -> scale-out serve
    plain = options_mod.SearchOptions(index_uri="memory://")
    monkeypatch.setattr(options_mod, "search_opts", plain)
    result = r.invoke(cli, ["serve", "--index-uri", "memory://", "--workers", "2"])
    assert result.exit_code == 0, result.output
    assert served[-1].workers == 2


# ------------------------------------------------------------ server/httpd.py


def test_aggregator_runner_stop_before_start():
    from iscc_search_tpu.server.httpd import AggregatorRunner

    runner = AggregatorRunner(index=None, opts=None, status={})
    runner.stop()  # no loop yet: must be a no-op


def test_aggregator_runner_stop_on_closed_loop():
    from iscc_search_tpu.server.httpd import AggregatorRunner

    runner = AggregatorRunner(index=None, opts=None, status={})
    loop = asyncio.new_event_loop()
    loop.close()
    runner._loop = loop
    runner._stop_event = asyncio.Event()
    runner.stop()  # call_soon_threadsafe on a closed loop: logged, not raised


def test_serve_aggregator_lifecycle(monkeypatch, tmp_path):
    """serve() in the main thread with an immediately-returning server loop:
    covers the aggregator start/stop arms and the signal restore arm."""
    from iscc_search_tpu.options import SearchOptions
    from iscc_search_tpu.server import httpd

    monkeypatch.setattr(httpd.ThreadingWSGIServer, "serve_forever", lambda self, poll_interval=0.5: None)
    opts = SearchOptions(
        index_uri="memory://",
        host="127.0.0.1",
        port=0,
        aggregator_network="testnet",
        aggregator_hub_list_url="http://127.0.0.1:9/hubs.yaml",  # refused instantly
        aggregator_poll_interval=3600,
        http_backend="wsgiref",  # this test drives the wsgiref lifecycle arms
    )
    httpd.serve(opts)  # starts poller thread, stops it, closes index


def test_serve_plain_lifecycle(monkeypatch):
    from iscc_search_tpu.options import SearchOptions
    from iscc_search_tpu.server import httpd

    monkeypatch.setattr(httpd.ThreadingWSGIServer, "serve_forever", lambda self, poll_interval=0.5: None)
    httpd.serve(SearchOptions(index_uri="memory://", host="127.0.0.1", port=0, http_backend="wsgiref"))


# ------------------------------------------------------------ engine/batcher.py


class _EchoIndex:
    def search(self, bodies, count):
        return [(np.zeros((1, 8), np.uint8), np.ones(1, np.float32)) for _ in bodies]


def test_batcher_zero_window_and_oversized():
    from iscc_search_tpu.engine.batcher import SearchBatcher

    b = SearchBatcher(_EchoIndex(), max_batch=4, window_ms=0)
    try:
        assert b.search([], 5) == []
        out = b.search([b"a" * 8] * 6, 5)  # single request larger than max_batch
        assert len(out) == 6
        out = b.search([b"b" * 8], 5)
        assert len(out) == 1
    finally:
        b.close()


# ------------------------------------------------------------ codec.py


def test_codec_error_arms():
    from iscc_search_tpu import codec as ic

    with pytest.raises(ValueError):
        ic.encode_length(ic.MT.DATA, 63)  # bits % 32
    with pytest.raises(ValueError):
        ic.decode_length(ic.MT.ISCC, 99)  # out-of-range composite length
    with pytest.raises(ValueError):
        ic.gen_iscc_id_v1(timestamp_us=1, server_id=5000)  # server id range


def test_gen_iscc_code_arms(rng):
    from iscc_search_tpu import codec as ic
    from tests.conftest import make_unit

    # duplicate unit types: the longer body wins (line 410 arm)
    short = make_unit(ic.MT.CONTENT, ic.ST_CC.TEXT, 64, rng=rng)
    long = make_unit(ic.MT.CONTENT, ic.ST_CC.TEXT, 128, rng=rng)
    data = make_unit(ic.MT.DATA, 0, 64, rng=rng)
    inst = make_unit(ic.MT.INSTANCE, 0, 256, rng=rng)
    out = ic.gen_iscc_code_v0([short, long, data, inst])
    assert out["iscc"].startswith("ISCC:")
    # SEMANTIC without CONTENT (line 422 arm)
    sem = make_unit(ic.MT.SEMANTIC, ic.ST_CC.TEXT, 64, rng=rng)
    out2 = ic.gen_iscc_code_v0([sem, data, inst])
    assert out2["iscc"].startswith("ISCC:")
    # SEMANTIC + CONTENT subtype mismatch (line 420 arm)
    sem_img = make_unit(ic.MT.SEMANTIC, ic.ST_CC.IMAGE, 64, rng=rng)
    with pytest.raises(ValueError):
        ic.gen_iscc_code_v0([sem_img, short, data, inst])


# ------------------------------------------------------------ config.py


def test_config_manager_arms(tmp_path):
    m = ConfigManager(config_dir=tmp_path / "cfg")
    # first add with use=False still becomes active (no active yet)
    m.add_local("first", str(tmp_path / "a"), use=False)
    assert m.get_active()[0] == "first"
    # duplicate add rejected
    with pytest.raises(ValueError):
        m.add_local("first", str(tmp_path / "a"))
    # second add with use=False does NOT steal active
    m.add_local("second", str(tmp_path / "b"), use=False)
    assert m.get_active()[0] == "first"
    # removing the non-active entry keeps active
    m.remove("second")
    assert m.get_active()[0] == "first"
    # use() on unknown raises
    with pytest.raises(KeyError):
        m.use("nope")


def test_config_discover_skips_non_index_dirs(tmp_path):
    m = ConfigManager(config_dir=tmp_path / "cfg")
    base = tmp_path / "data"
    (base / "real" / "store").mkdir(parents=True)
    (base / "junk").mkdir(parents=True)
    (base / "afile").write_text("x")
    found = m.discover(base_dir=str(base))
    assert "real" in found and "junk" not in found


# ------------------------------------------------------- indexes/tpu/manager.py


def test_manager_list_skips_foreign_dirs(tmp_path, entry_factory):
    from iscc_search_tpu.indexes.tpu.manager import TpuIndexManager
    from iscc_search_tpu.schema import IsccIndex

    m = TpuIndexManager(str(tmp_path))
    m.create_index(IsccIndex(name="real"))
    (tmp_path / "not-an-index").mkdir()
    (tmp_path / "real" / "extradir").mkdir()
    (tmp_path / "stray.txt").write_text("x")
    names = [i.name for i in m.list_indexes()]
    assert names == ["real"]
    # cache-hit arm of get_index internals
    first = m.get_index("real")
    second = m.get_index("real")
    assert first is not None and second is not None
    stats = m.get_index("real")
    m.close()
