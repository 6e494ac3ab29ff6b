"""Branch coverage round 19: device-index save-pipeline multi-iteration
waits and mesh+recall-target routing."""

import os
import threading
import time

import numpy as np
import pytest

from iscc_search_tpu.engine import DeviceNphdIndex
from iscc_search_tpu.engine import device_index as di
# ------------------------------------------------- device_index save arms


@pytest.fixture
def rng():
    return np.random.default_rng(94)


def bodies_of(rng, n):
    return [rng.integers(0, 256, 32, dtype=np.uint8).tobytes() for _ in range(n)]


def test_save_wait_true_with_slow_write(tmp_path, rng, monkeypatch):
    idx = DeviceNphdIndex(tmp_path / "i")
    idx.add([1], bodies_of(rng, 1))
    real = di._atomic_write

    def slow(path, data, sync_dir=True):
        time.sleep(0.15)
        return real(path, data, sync_dir)

    monkeypatch.setattr(di, "_atomic_write", slow)
    idx.save(wait=True)  # waiter sees queue -> inflight -> done transitions
    idx.close()


def test_drain_with_two_queued_saves(tmp_path, rng, monkeypatch):
    idx = DeviceNphdIndex(tmp_path / "i", shard_size=4 * 1024)
    n = idx.shard_rows
    idx.add(list(range(n)), bodies_of(rng, n))
    real = di._atomic_write

    def slow(path, data, sync_dir=True):
        time.sleep(0.1)
        return real(path, data, sync_dir)

    monkeypatch.setattr(di, "_atomic_write", slow)
    idx.save(wait=False)  # seals the segment; worker starts writing
    idx.add([n + 1], bodies_of(rng, 1))
    idx.save(wait=False)  # queues a second snapshot behind the in-flight one
    idx.drain_rotations()  # multi-iteration wait through both saves
    idx.close()


def test_unconfirmed_seal_reemitted_while_first_save_inflight(tmp_path, rng, monkeypatch):
    """A second snapshot taken before the first (sealing) save confirms must
    re-include the sealed file — without the resave_all hammer."""
    idx = DeviceNphdIndex(tmp_path / "i", shard_size=4 * 1024)
    n = idx.shard_rows
    idx.add(list(range(n)), bodies_of(rng, n))
    gate = threading.Event()
    real = di._atomic_write

    def gated(path, data, sync_dir=True):
        gate.wait(10)
        return real(path, data, sync_dir)

    monkeypatch.setattr(di, "_atomic_write", gated)
    idx.save(wait=False)  # seals in memory; write blocked on the gate
    time.sleep(0.1)
    idx.add([n + 1], bodies_of(rng, 1))
    idx.save(wait=False)  # snapshot while the seal is still unconfirmed
    gate.set()
    idx.drain_rotations()
    monkeypatch.undo()
    idx.close()
    idx2 = DeviceNphdIndex(tmp_path / "i")
    assert len(idx2) == n + 1
    idx2.close()


def test_mesh_with_recall_target_routes_to_pm1(tmp_path, monkeypatch):
    from iscc_search_tpu.parallel import make_mesh

    rng = np.random.default_rng(96)
    mesh = make_mesh(8)
    n = 8 * 4096
    packed = rng.integers(0, 2**32, (n, 8), dtype=np.uint32)
    keys = np.zeros((n, 8), np.uint8)
    keys[:, :8] = np.frombuffer(np.arange(n, dtype=">u8").tobytes(), np.uint8).reshape(-1, 8)
    idx = DeviceNphdIndex(tmp_path / "i", mesh=mesh, recall_target=0.99, shard_size=1 << 30)
    idx.add_packed(keys, packed, 8)
    res = idx.search([packed[3].astype(">u4").tobytes()], 3)
    assert res[0][1][0] == pytest.approx(1.0, abs=1e-3)
    idx.close()


def test_add_packed_3d_and_zero_d_array_nlanes(tmp_path):
    rng = np.random.default_rng(97)
    idx = DeviceNphdIndex(tmp_path / "i")
    keys = np.zeros((2, idx.key_bytes), np.uint8)
    keys[:, -1] = [1, 2]
    with pytest.raises(ValueError, match="packed must be"):
        idx.add_packed(keys, rng.integers(0, 2**32, (2, 8, 1), dtype=np.uint32), 8)
    idx.add_packed(keys, rng.integers(0, 2**32, (2, 8), dtype=np.uint32), np.array(8))  # 0-d ndarray
    assert len(idx) == 2
    idx.close()
