"""
Branch-coverage fillers for the device engine (engine/device_index.py) and
the native store veneer (store/kv.py): empty-input fast paths, layout-budget
routing, save-failure re-emission, crash-residue GC arms, and native error
surfaces. Companion to test_branch_cov{,2}.py for the branch gate
(reference parity: /root/reference/pyproject.toml:106-113).
"""

import os
import struct
import threading
import time

import numpy as np
import pytest

from iscc_search_tpu.engine import device_index as di
from iscc_search_tpu.engine.device_index import DeviceNphdIndex
from iscc_search_tpu.store import kv
from iscc_search_tpu.store.kv import HostStore


def vec(rng, nbytes=8):
    return rng.integers(0, 256, nbytes, dtype=np.uint8).tobytes()


# ----------------------------------------------------------- device index


def test_empty_add_remove_search(tmp_path):
    idx = DeviceNphdIndex(tmp_path / "d")
    idx.add([], [])  # device_index.py:324 True
    assert idx.remove([]) == 0
    assert idx.search([], 5) == []  # 395 `not query_bodies` True
    idx.close()


def test_pow2_query_batch_no_padding(tmp_path):
    """Exactly 8 queries: q_pad == nq (416 False arm)."""
    rng = np.random.default_rng(1)
    idx = DeviceNphdIndex(tmp_path / "d")
    vs = [vec(rng) for _ in range(16)]
    idx.add(list(range(16)), vs)
    res = idx.search(vs[:8], 3)
    assert len(res) == 8
    for i, (keys, scores) in enumerate(res):
        assert scores[0] == pytest.approx(1.0)
        assert int.from_bytes(keys[0].tobytes(), "big") == i
    idx.close()


def test_numpy_vector_accepted(tmp_path):
    rng = np.random.default_rng(2)
    idx = DeviceNphdIndex(tmp_path / "d")
    arr = rng.integers(0, 256, 8, dtype=np.uint8)
    idx.add([7], [arr])  # 823 True (ndarray -> bytes)
    assert idx.get(7) == arr.tobytes()
    idx.close()


def test_save_compacts_when_tombstones_dominate(tmp_path):
    """save() compacts past 50% tombstones above the row floor (587 True),
    and post-compaction rows < synced_rows forces a full device rebuild
    (860 True)."""
    rng = np.random.default_rng(5)
    n = di._MIN_DEVICE_ROWS + 1000
    idx = DeviceNphdIndex(tmp_path / "d", shard_size=1)  # shard_rows=1024: seals segments
    vs = [vec(rng) for _ in range(n)]
    idx.add(list(range(n)), vs)
    idx.search([vs[0]], 1)  # sync the device mirror
    idx.remove(list(range(n // 2 + 500)))
    assert idx.tombstone_fraction > 0.5
    idx.save()
    assert idx.tombstone_fraction == 0.0
    assert idx._rows < idx._synced_rows or idx._synced_rows == 0
    keep = n // 2 + 500
    ((keys, scores),) = idx.search([vs[keep]], 1)
    assert int.from_bytes(keys[0].tobytes(), "big") == keep
    idx.close()


def test_sealed_boundary_shard_count(tmp_path):
    """Rows exactly at a seal boundary: active segment empty (301 arm)."""
    rng = np.random.default_rng(6)
    idx = DeviceNphdIndex(tmp_path / "d", shard_size=1)  # shard_rows = 1024
    idx.add(list(range(1024)), [vec(rng) for _ in range(1024)])
    idx.save()
    assert idx.shard_count == 1  # one sealed, no active rows
    idx.close()


def test_failed_save_reemits_all_segments(tmp_path, monkeypatch):
    """A failed background write marks _resave_all; the next save re-emits
    every sealed segment (605-611), and an unconfirmed seal without the
    resave flag re-emits just that file (613-616 True)."""
    rng = np.random.default_rng(7)
    idx = DeviceNphdIndex(tmp_path / "d", shard_size=1)
    idx.add(list(range(2100)), [vec(rng) for _ in range(2100)])

    real_write = idx._write_snapshot
    calls = {"n": 0}

    def flaky(snapshot):
        calls["n"] += 1
        if calls["n"] == 1:
            raise OSError("disk full (injected)")
        return real_write(snapshot)

    monkeypatch.setattr(idx, "_write_snapshot", flaky)
    idx.save()  # fails in the worker; index re-marked dirty
    assert idx.dirty > 0 and idx._resave_all
    idx.save()  # re-emits both sealed segments + active
    assert idx.dirty == 0 and not idx._resave_all and not idx._unconfirmed_seals
    # Unconfirmed-seal arm without resave_all (e.g. a coalesced snapshot)
    seg_file = idx._segments[0]["file"]
    idx._unconfirmed_seals.add(seg_file)
    idx.save()
    assert seg_file not in idx._unconfirmed_seals
    idx2 = DeviceNphdIndex(tmp_path / "d")
    assert idx2.size == 2100
    idx2.close()
    idx.close()


def test_load_truncates_at_missing_segment(tmp_path):
    rng = np.random.default_rng(8)
    idx = DeviceNphdIndex(tmp_path / "d", shard_size=1)
    idx.add(list(range(2100)), [vec(rng) for _ in range(2100)])
    idx.save()
    seg0 = idx._segments[0]["file"]
    idx.close()
    (tmp_path / "d" / seg0).unlink()
    idx = DeviceNphdIndex(tmp_path / "d")  # 1065 True: truncated load
    assert idx.size == 0  # first segment gone -> nothing loadable after the gap
    idx.close()


def test_gc_crash_residue_arms(tmp_path):
    """GC on open: stale seq'd files deleted, higher-seq and unparseable
    files kept, directories skipped, tmp rules (1120-1145)."""
    rng = np.random.default_rng(9)
    p = tmp_path / "d"
    idx = DeviceNphdIndex(p, shard_size=1)
    idx.add(list(range(1100)), [vec(rng) for _ in range(1100)])
    idx.save()
    idx.close()
    # Residue: stale vs in-flight vs unparseable vs directory
    (p / "active-00000000.npz").write_bytes(b"stale")        # <= save_seq: deleted
    (p / "valid-00000000.npz").write_bytes(b"stale")         # <= save_seq: deleted
    (p / "seg-00000099.npz").write_bytes(b"future")          # > file_seq: kept
    (p / "seg-abc.npz").write_bytes(b"weird")                # unparseable: kept
    (p / "seg-001.npz").write_bytes(b"shortdigits")          # seg w/ !=8 digits: kept
    (p / "notes.txt").write_bytes(b"user file")              # unparseable: kept
    (p / "subdir").mkdir()                                   # directory: skipped
    (p / "state.json123.tmp").write_bytes(b"tmp")            # manifest tmp: deleted
    (p / "active-00000000.npz.123.tmp").write_bytes(b"tmp")  # stale data tmp: deleted
    (p / "seg-00000099.npz.456.tmp").write_bytes(b"tmp")     # in-flight tmp: kept
    idx = DeviceNphdIndex(p)
    try:
        assert idx.size == 1100
        names = {f.name for f in p.iterdir()}
        assert "active-00000000.npz" not in names
        assert "valid-00000000.npz" not in names
        assert "state.json123.tmp" not in names
        assert "active-00000000.npz.123.tmp" not in names
        assert {"seg-00000099.npz", "seg-abc.npz", "seg-001.npz", "notes.txt",
                "subdir", "seg-00000099.npz.456.tmp"} <= names
    finally:
        idx.close()


def test_drain_rotations_noop_and_close_idempotent(tmp_path):
    idx = DeviceNphdIndex(tmp_path / "d")
    idx.drain_rotations()  # nothing queued: 784 False immediately
    idx.close()
    idx.close()  # 791 True
    idx.drain_rotations()  # after close: still a no-op


# ------------------------------------------------------------- host store


def test_putmulti_empty(tmp_path):
    s = HostStore(tmp_path / "s")
    try:
        assert s.putmulti("db", []) == 0   # kv.py:322 True
        assert s.dup_putmulti("db", []) == 0  # kv.py:310 True
    finally:
        s.close()


def test_last_error_empty_and_closed(tmp_path):
    s = HostStore(tmp_path / "s")
    assert s._last_error() == ""  # no error recorded: msg NULL (271 False)
    s.close()
    assert s._last_error() == ""  # closed store: RuntimeError arm


def test_parse_helpers_empty_buffer():
    buf = (kv.ctypes.c_uint8 * 1)()
    assert kv._parse_pairs(buf, 0) == []   # 164 never-entered arm
    assert kv._parse_values(buf, 0) == []  # 182 never-entered arm


def test_nested_session_notify_arm(tmp_path):
    """A nested _use inside a session leaves inflight > 0 on exit
    (kv.py:245 False arm)."""
    s = HostStore(tmp_path / "s")
    try:
        with s.session():
            s.put("db", b"k", b"v")
            assert s.get("db", b"k") == b"v"
    finally:
        s.close()


def test_close_waits_for_inflight_reader(tmp_path):
    """close() blocks until in-flight native calls drain (kv.py:509 True)."""
    s = HostStore(tmp_path / "s")
    s.put("db", b"k", b"v" * 100)
    entered = threading.Event()
    release = threading.Event()

    real_lib = s._lib
    real_get = real_lib.ts_get

    def hold(*args):
        entered.set()
        release.wait(5)
        return real_get(*args)

    class SlowLib:
        def __getattr__(self, name):
            if name == "ts_get":
                return hold
            return getattr(real_lib, name)

    s._lib = SlowLib()
    t = threading.Thread(target=lambda: s.get("db", b"k"))
    t.start()
    assert entered.wait(5)
    closer = threading.Thread(target=s.close)
    closer.start()
    time.sleep(0.1)
    assert closer.is_alive()  # close is parked on the inflight reader
    release.set()
    closer.join(5)
    t.join(5)
    assert not closer.is_alive()


def test_build_library_paths(tmp_path, monkeypatch):
    """_build_library arms: missing lib path (33 True) and the built-while-
    waiting re-check (56 True)."""
    # Arm 1: lib path missing -> not fresh -> make runs (idempotent no-op)
    monkeypatch.setattr(kv, "_LIB_PATH", tmp_path / "nope.so")
    calls = {"n": 0}

    def fake_run(*a, **k):
        calls["n"] += 1
        return None

    monkeypatch.setattr(kv.subprocess, "run", fake_run)
    kv._build_library()
    assert calls["n"] == 1
    # Arm 2: another process built it while we waited for the lock
    seq = iter([False, True])
    monkeypatch.setattr(kv, "_lib_is_fresh", lambda: next(seq))
    kv._build_library()
    assert calls["n"] == 1  # inner re-check returned before make


