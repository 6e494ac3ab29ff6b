"""
Incremental-compaction suite for the native store (store.cpp ts_compact):
log rotation, sliced snapshot streaming under concurrent traffic, rotated-log
(store.log.0) crash-residue recovery, and the Python background trigger.
The design replaces the full-lock compaction that stalled a 1M-asset
aggregator ingest for 15.5s (measured by benchmarks/aggregator_ingest.py).
"""

import shutil
import threading
import time

import pytest

from iscc_search_tpu.store.kv import HostStore


def fill(s, n, prefix=b"k", vbytes=200, db="db"):
    for i in range(n):
        s.put(db, prefix + str(i).encode(), bytes([i % 256]) * vbytes)


def check(s, n, prefix=b"k", vbytes=200, db="db"):
    for i in range(0, n, max(1, n // 64)):
        assert s.get(db, prefix + str(i).encode()) == bytes([i % 256]) * vbytes


def test_compact_under_concurrent_traffic(tmp_path):
    """Writers and readers run THROUGH a compaction; every record (old,
    overwritten, and mid-compaction) survives a reopen."""
    s = HostStore(tmp_path / "s")
    fill(s, 3000)
    for i in range(500):  # dupsort data too
        s.dup_put("dup", b"key", str(i).encode())
    stop = threading.Event()
    errors = []

    def writer():
        i = 0
        while not stop.is_set():
            s.put("db", b"live" + str(i % 100).encode(), str(i).encode() * 30)
            s.dup_put("dup", b"key2", str(i).encode())
            i += 1

    def reader():
        while not stop.is_set():
            if s.get("db", b"k100") != bytes([100]) * 200:
                errors.append("stale read")  # pragma: no cover
                return

    threads = [threading.Thread(target=writer), threading.Thread(target=reader)]
    for t in threads:
        t.start()
    try:
        for _ in range(3):
            s.compact()
    finally:
        stop.set()
        for t in threads:
            t.join(10)
    assert not errors
    assert not (tmp_path / "s" / "store.log.0").exists()
    live42 = s.get("db", b"live42")
    s.close()

    s = HostStore(tmp_path / "s")
    try:
        check(s, 3000)
        assert len(s.get_dups("dup", b"key")) == 500
        assert s.get("db", b"live42") == live42
    finally:
        s.close()


def test_overwrites_and_deletes_across_compaction(tmp_path):
    """Values overwritten/deleted after the compaction's snapshot capture
    win over the captured state on replay (idempotent-replay contract)."""
    p = tmp_path / "s"
    s = HostStore(p)
    fill(s, 1000)
    s.compact()
    # Post-compaction mutations land in the fresh log
    s.put("db", b"k10", b"NEW" * 100)
    s.delete("db", b"k20")
    s.dup_put("dup", b"dk", b"v1")
    s.compact()  # second rotation: captured state + empty log again
    s.put("db", b"k10", b"NEWER" * 100)
    s.close()

    s = HostStore(p)
    try:
        assert s.get("db", b"k10") == b"NEWER" * 100
        assert s.get("db", b"k20") is None
        assert s.get_dups("dup", b"dk") == [b"v1"]
        check(s, 1000, vbytes=200)
    finally:
        s.close()


def test_rotated_log_residue_replays_in_order(tmp_path):
    """A crash between rotation and snapshot commit leaves store.log.0 +
    store.log; open replays snapshot -> log.0 -> log (older first) and
    retires the residue."""
    a = tmp_path / "a"
    s = HostStore(a)
    s.put("db", b"k1", b"OLD" * 50)  # >= ext_min: externalized ref
    s.put("db", b"gone", b"x" * 100)
    s.close()
    # Simulate the crash: the committed log becomes the rotated residue.
    (a / "store.log").rename(a / "store.log.0")
    # A "newer" log: build it in a scratch store (records are dir-agnostic).
    b = tmp_path / "b"
    s2 = HostStore(b)
    s2.put("db", b"k1", b"NEW" * 50)  # supersedes log.0's value
    s2.put("db", b"gone", b"x" * 100)  # present so the delete is logged
    s2.delete("db", b"gone")
    s2.put("db", b"k2", b"fresh")
    s2.close()
    shutil.copy(b / "store.log", a / "store.log")

    s = HostStore(a)
    try:
        assert s.get("db", b"k1") == b"NEW" * 50  # log replayed after log.0
        assert s.get("db", b"gone") is None
        assert s.get("db", b"k2") == b"fresh"
        # Open-time compaction retired the residue
        assert not (a / "store.log.0").exists()
        assert (a / "store.snap").exists()
    finally:
        s.close()


def test_background_autocompact_trigger(tmp_path):
    """flush() past AUTO_COMPACT_BYTES spawns one background compaction that
    truncates the log without blocking the flushing thread."""
    s = HostStore(tmp_path / "s")
    s.AUTO_COMPACT_BYTES = 64 * 1024  # instance override: tiny threshold
    fill(s, 2000, vbytes=100)
    t0 = time.perf_counter()
    s.flush()
    trigger_s = time.perf_counter() - t0
    assert trigger_s < 2.0  # flush returns without paying the full compact
    thread = s._compact_thread
    assert thread is not None
    thread.join(30)
    assert not thread.is_alive()
    with s._use() as h:
        assert s._lib.ts_log_bytes(h) <= s.AUTO_COMPACT_BYTES
    assert (tmp_path / "s" / "store.snap").exists()
    check(s, 2000, vbytes=100)
    # Below the threshold: no new thread spawns
    s.flush()
    assert s._compact_thread is thread
    s.close()


def test_compact_while_compacting_waits_then_compacts(tmp_path):
    """A second compact during an in-flight one waits it out and then runs
    its own pass (the postcondition — snapshot + truncated log reflecting at
    least call-time state — must hold for every caller, not just the first)."""
    s = HostStore(tmp_path / "s")
    fill(s, 5000, vbytes=300)
    done = threading.Event()

    def bg():
        s.compact()
        done.set()

    t = threading.Thread(target=bg)
    t.start()
    s.compact()  # waits for bg's pass if mid-flight, then compacts; no hang
    t.join(30)
    assert done.is_set()
    # Nothing was written after the second compact returned, so ITS pass
    # (not merely bg's) must have left the log empty.
    with s._use() as h:
        assert s._lib.ts_log_bytes(h) == 0
    check(s, 5000, vbytes=300)
    s.close()
