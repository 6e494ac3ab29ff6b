"""Branch coverage round 15: device-index engine arms — control-hook
passthrough, add_packed validation, body_at bounds, empty-search short
circuits, save coalescing/sequencing, crash-residue GC sequence guard, and
device rebuilds after compaction."""

import os
import time

import numpy as np
import pytest

from iscc_search_tpu.engine import DeviceNphdIndex
from iscc_search_tpu.engine import device_index as di


@pytest.fixture
def rng():
    return np.random.default_rng(15)


def bodies_of(rng, n, nbytes=32):
    return [rng.integers(0, 256, nbytes, dtype=np.uint8).tobytes() for _ in range(n)]


# ------------------------------------------------------ control-hook arms


def test_control_hook_passthrough_all_ops(tmp_path, rng):
    idx = DeviceNphdIndex(tmp_path / "i")
    ops = []
    idx.control_hook = lambda op, args, local: (ops.append(op), local())[1]
    bodies = bodies_of(rng, 8)
    idx.add(list(range(8)), bodies)
    packed = np.frombuffer(bodies[0], dtype=">u4").astype(np.uint32)[None, :]
    key_arr = np.zeros((1, idx.key_bytes), np.uint8)
    key_arr[0, -1] = 99
    idx.add_packed(key_arr, packed, 8)
    res = idx.search([bodies[0]], 3)
    assert len(res) == 1 and len(res[0][1]) > 0
    removed = idx.remove([3])
    assert removed == 1
    assert ops == ["add", "add_packed", "search", "remove"]
    idx.close()


# ------------------------------------------------- add_packed validation


def test_add_packed_validation_arms(tmp_path, rng):
    idx = DeviceNphdIndex(tmp_path / "i")
    good_keys = np.zeros((2, idx.key_bytes), np.uint8)
    good_keys[:, -1] = [1, 2]
    packed = rng.integers(0, 2**32, (2, 8), dtype=np.uint32)
    idx.add_packed(np.zeros((0, idx.key_bytes), np.uint8), np.zeros((0, 8), np.uint32), 8)  # n=0
    with pytest.raises(ValueError, match="keys must be"):
        idx.add_packed(np.zeros((2, 3), np.uint8), packed, 8)
    with pytest.raises(ValueError, match="packed must be"):
        idx.add_packed(good_keys, rng.integers(0, 2**32, (3, 8), dtype=np.uint32), 8)
    with pytest.raises(ValueError, match="nlanes must be"):
        idx.add_packed(good_keys, packed, np.array([8, 8, 8], np.int32))
    with pytest.raises(ValueError, match="out of range"):
        idx.add_packed(good_keys, packed, np.array([8, 99], np.int32))
    idx.add_packed(good_keys, packed, np.array([8, 8], np.int32))  # array nlanes arm
    assert len(idx) == 2
    idx.close()


def test_add_packed_updates_materialized_key_map(tmp_path, rng):
    idx = DeviceNphdIndex(tmp_path / "i")
    idx.add([1], bodies_of(rng, 1))
    assert idx.get(1) is not None  # materializes the key->row map
    keys = np.zeros((1, idx.key_bytes), np.uint8)
    keys[0, -1] = 5
    idx.add_packed(keys, rng.integers(0, 2**32, (1, 8), dtype=np.uint32), 8)
    assert len(idx) == 2
    idx.close()


# ----------------------------------------------------------- body_at arms


def test_body_at_bounds_and_tombstone(tmp_path, rng):
    idx = DeviceNphdIndex(tmp_path / "i")
    idx.add([1, 2], bodies_of(rng, 2))
    assert idx.body_at(-1) is None
    assert idx.body_at(99) is None
    assert idx.body_at(0) is not None
    idx.remove([1])
    assert idx.body_at(0) is not None  # tombstones keep bytes (scoring loops)
    idx._nlanes[0] = 0  # junk row (allocated, never written)
    assert idx.body_at(0) is None
    idx.close()


# -------------------------------------------------- empty-search shortcuts


def test_search_short_circuits(tmp_path, rng):
    idx = DeviceNphdIndex(tmp_path / "i")
    assert idx.search([], 5) == []
    assert idx.search([b"\x00" * 32], 5)[0][1].size == 0  # rows == 0
    idx.add([1], bodies_of(rng, 1))
    idx.remove([1])
    out = idx.search([b"\x00" * 32], 5, return_rows=True)  # live == 0
    assert out[0][2].size == 0
    idx.close()


def test_shard_count_arms(tmp_path, rng):
    idx = DeviceNphdIndex(tmp_path / "i", shard_size=4 * 1024)
    assert idx.shard_count == 1  # empty: the active segment counts
    rows_per_shard = idx.shard_rows
    idx.add(list(range(rows_per_shard)), bodies_of(rng, rows_per_shard))
    idx.save()
    idx.drain_rotations()
    assert idx.shard_count >= 1  # sealed segments, active empty
    idx.close()


def test_key_map_built_by_racing_thread(tmp_path, rng):
    """The double-checked key->row map: another thread wins the build."""
    idx = DeviceNphdIndex(tmp_path / "i")
    idx.add([1], bodies_of(rng, 1))
    idx._key_to_row = None
    real_lock = idx._lock

    class InjectingLock:
        def __enter__(self):
            real_lock.__enter__()
            if idx._key_to_row is None:
                idx._key_to_row = {}  # the "other thread" built it first
            return self

        def __exit__(self, *exc):
            return real_lock.__exit__(*exc)

    idx._lock = InjectingLock()
    try:
        assert idx.get(1) is None  # resolved through the injected (empty) map
    finally:
        idx._lock = real_lock
        idx.close()


# --------------------------------------------------------- atomic write


def test_atomic_write_failure_cleans_tmp(tmp_path, monkeypatch):
    target = tmp_path / "f.bin"
    monkeypatch.setattr(os, "replace", lambda a, b: (_ for _ in ()).throw(OSError("boom")))
    with pytest.raises(OSError, match="boom"):
        di._atomic_write(target, b"data")
    assert not target.exists()
    assert not list(tmp_path.glob("*.tmp"))
    # unlink failing too must not mask the original error
    monkeypatch.setattr(os, "unlink", lambda p: (_ for _ in ()).throw(OSError("x")))
    with pytest.raises(OSError, match="boom"):
        di._atomic_write(target, b"data")


# ------------------------------------------------- save plan / coalescing


def test_save_disabled_is_noop(tmp_path, rng):
    idx = DeviceNphdIndex(tmp_path / "i")
    idx.add([1], bodies_of(rng, 1))
    idx.save_enabled = False
    idx.save()
    assert not (tmp_path / "i" / "state.json").exists()
    idx.save_enabled = True
    idx.close()


def test_second_save_skips_confirmed_seals(tmp_path, rng):
    idx = DeviceNphdIndex(tmp_path / "i", shard_size=4 * 1024)
    n = idx.shard_rows
    idx.add(list(range(n)), bodies_of(rng, n))
    idx.save()
    idx.drain_rotations()
    idx.add([n + 1], bodies_of(rng, 1))
    idx.save()  # sealed file already confirmed: not re-emitted
    idx.drain_rotations()
    idx.close()


def test_enqueue_save_coalescing_arms(tmp_path, rng, monkeypatch):
    idx = DeviceNphdIndex(tmp_path / "i")
    idx.add([1], bodies_of(rng, 1))
    written_before = idx._written_seq
    monkeypatch.setattr(idx, "_save_worker", lambda: None)  # inert worker
    idx._written_seq = 99
    # stale + wait=True: dropped AND the wait loop is skipped (nothing queued)
    idx._enqueue_save({"seq": 1}, wait=True)
    assert idx._save_queue is None
    idx._enqueue_save({"seq": 100}, wait=False)
    assert idx._save_queue == {"seq": 100}
    idx._enqueue_save({"seq": 100}, wait=False)  # not newer than queued: dropped
    idx._enqueue_save({"seq": 101}, wait=False)  # newer: replaces
    assert idx._save_queue == {"seq": 101}
    idx._save_queue = None
    idx._written_seq = written_before
    monkeypatch.undo()
    idx.close()


def test_drain_rotations_waits_for_inflight(tmp_path, rng, monkeypatch):
    idx = DeviceNphdIndex(tmp_path / "i")
    idx.add([1], bodies_of(rng, 1))
    idx.drain_rotations()  # idle: skip arm
    real_write = di._atomic_write

    def slow_write(path, data, sync_dir=True):
        time.sleep(0.3)
        return real_write(path, data, sync_dir)

    monkeypatch.setattr(di, "_atomic_write", slow_write)
    idx.add([2], bodies_of(rng, 1))
    idx.save(wait=False)
    idx.drain_rotations()  # wait arm
    idx.close()


# -------------------------------------------------------- GC sequence guard


def test_crash_residue_gc_sequence_arms(tmp_path, rng):
    idx = DeviceNphdIndex(tmp_path / "i", shard_size=4 * 1024)
    idx.add(list(range(32)), bodies_of(rng, 32))
    idx.save()
    idx.drain_rotations()
    idx.close()
    p = tmp_path / "i"
    residue = {
        "seg-0001.npz": True,  # seg but digits != 8 wide -> unparseable, kept
        "seg-99999999.npz": True,  # higher file_seq: another writer's, kept
        "active-99999999.npz": True,  # higher save_seq: kept
        "active-00000000.npz": False,  # committed-or-older: reclaimed
        "bogus-xy.npz": True,  # no digits: kept
        "seg-00000000.npz.tmp": False,  # old tmp residue: reclaimed
        "seg-99999999.npz.tmp": True,  # in-flight writer's tmp: kept
    }
    for name in residue:
        (p / name).write_bytes(b"x")
    idx2 = DeviceNphdIndex(p)
    for name, kept in residue.items():
        assert (p / name).exists() is kept, name
    assert len(idx2) == 32
    idx2.close()


# ----------------------------------------------- device rebuild after compaction


def _filled(tmp_path, rng, nbytes, n, name="i", **kw):
    idx = DeviceNphdIndex(tmp_path / name, **kw)
    packed = rng.integers(0, 2**32, (n, nbytes // 4), dtype=np.uint32)
    keys = np.zeros((n, idx.key_bytes), np.uint8)
    keys[:, :8] = np.frombuffer(np.arange(n, dtype=">u8").tobytes(), np.uint8).reshape(n, 8)
    idx.add_packed(keys, packed, nbytes // 4)
    return idx


def test_full_rebuild_after_compaction_shrinks_rows(tmp_path, rng):
    """Row-space shrinks reach the device via _partitions=None (every
    shrinking path nulls it — _sync_device needs no rows<synced clause)."""
    idx = _filled(tmp_path, rng, 32, 16384)
    idx._sync_device()
    keys = np.zeros((4, idx.key_bytes), np.uint8)
    keys[:, :8] = np.frombuffer(np.arange(4, dtype=">u8").tobytes(), np.uint8).reshape(4, 8)
    idx.remove([keys[i].tobytes() for i in range(4)])
    idx.compact()
    assert idx._partitions is None  # the shrink path's contract
    parts = idx._sync_device()
    assert parts[8].count == idx._rows == 16384 - 4
    idx.close()
