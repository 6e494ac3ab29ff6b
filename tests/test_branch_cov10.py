"""Branch coverage round 10: parallel modules — mesh row placement (the
multi-process arms the subprocess cluster tests can't surface in-process),
SPMD control-plane edges, distributed-init arms, sharded unpack chunk
fallbacks."""

import pickle
import socket
import threading

import jax
import numpy as np
import pytest

from iscc_search_tpu.parallel.mesh import make_mesh, place_rows, process_row_block
from iscc_search_tpu.parallel.service import _LEN, MultihostService, _recv_exact


class _Dev:
    def __init__(self, p):
        self.process_index = p


class _StubMesh:
    """Duck-typed mesh: process_row_block only reads .devices."""

    def __init__(self, procs):
        self.devices = np.array([_Dev(p) for p in procs], dtype=object)


# ------------------------------------------------------ mesh.process_row_block


def test_row_block_rejects_interleaved_processes():
    with pytest.raises(ValueError, match="not grouped"):
        process_row_block(_StubMesh([0, 1, 0, 1]), 8)


def test_row_block_rejects_unequal_process_counts():
    with pytest.raises(ValueError, match="unequal"):
        process_row_block(_StubMesh([0, 0, 0, 1]), 8)


def test_row_block_rejects_indivisible_rows():
    with pytest.raises(ValueError, match="not divisible"):
        process_row_block(_StubMesh([0, 0, 1, 1]), 7)


def test_row_block_rank_slices(monkeypatch):
    mesh = _StubMesh([3, 3, 7, 7])
    monkeypatch.setattr(jax, "process_index", lambda: 7)
    assert process_row_block(mesh, 8) == (4, 8)
    monkeypatch.setattr(jax, "process_index", lambda: 3)
    assert process_row_block(mesh, 8) == (0, 4)


def test_place_rows_process_local_feed(monkeypatch):
    """The multi-process arm of place_rows: single-process degenerate case
    (every device on one process -> that process feeds the whole block), but
    through make_array_from_process_local_data rather than device_put."""
    mesh = make_mesh(2)
    arr = np.arange(32, dtype=np.uint32).reshape(8, 4)
    monkeypatch.setattr(jax, "process_count", lambda: 2)
    out = place_rows(mesh, arr)
    assert out.shape == (8, 4)
    assert np.array_equal(np.asarray(out), arr)


# --------------------------------------------------- service control channel


def test_recv_exact_zero_bytes():
    a, b = socket.socketpair()
    try:
        assert _recv_exact(a, 0) == b""
    finally:
        a.close()
        b.close()


def test_broadcast_bad_ack_raises():
    a, b = socket.socketpair()
    svc = object.__new__(MultihostService)
    svc._conns = [a]
    b.sendall(b"\x00")  # follower answers a non-ACK byte
    try:
        with pytest.raises(RuntimeError, match="follower reported failure"):
            svc._broadcast(("add", "idx", [], []), want_ack=True)
    finally:
        a.close()
        b.close()


def test_stop_follower_closes_socket():
    a, b = socket.socketpair()
    svc = object.__new__(MultihostService)
    svc.is_coordinator = False
    svc._stopped = False
    svc._sock = a
    svc.stop()
    assert a.fileno() == -1
    b.close()


def test_stop_follower_without_socket_is_noop():
    svc = object.__new__(MultihostService)
    svc.is_coordinator = False
    svc._stopped = False
    svc._sock = None
    svc.stop()
    assert svc._stopped


def test_follow_applies_add_packed_and_matching_check():
    a, b = socket.socketpair()
    svc = object.__new__(MultihostService)
    svc.is_coordinator = False
    svc._stopped = False
    svc._sock = a

    calls = []

    class Stub:
        save_enabled = True
        _rows = 3
        _live = 3

        def _add_packed_impl(self, *args):
            calls.append(args)

    ops = [("add_packed", "idx", [1], b"xx", 64), ("check", "idx", 3, 3), ("stop",)]

    def feed():
        for op in ops:
            payload = pickle.dumps(op)
            b.sendall(_LEN.pack(len(payload)) + payload)

    t = threading.Thread(target=feed)
    t.start()
    try:
        svc.follow(lambda name: Stub())
        t.join(timeout=10)
        assert calls == [([1], b"xx", 64)]
        assert b.recv(2) == b"\x01\x01"  # acks for the two non-search ops
    finally:
        a.close()
        b.close()


# ------------------------------------------------------------ distributed init


def test_init_distributed_numhosts_without_coordinator_initializes(monkeypatch):
    from iscc_search_tpu.parallel import distributed

    seen = {}

    def fake_init(coordinator_address=None, num_processes=None, process_id=None):
        seen.update(c=coordinator_address, n=num_processes, p=process_id)

    monkeypatch.setattr(jax.distributed, "initialize", fake_init)
    monkeypatch.delenv("ISCC_SEARCH_COORDINATOR", raising=False)
    distributed.init_distributed(None, 2, 0)
    assert seen == {"c": None, "n": 2, "p": 0}


def test_init_distributed_explicit_single_host_short_circuits(monkeypatch):
    from iscc_search_tpu.parallel import distributed

    def boom(**_kw):  # pragma: no cover - must not be reached
        raise AssertionError("initialize must not run in single-host mode")

    monkeypatch.setattr(jax.distributed, "initialize", boom)
    for var in ("ISCC_SEARCH_COORDINATOR", "ISCC_SEARCH_NUM_HOSTS", "ISCC_SEARCH_HOST_ID"):
        monkeypatch.delenv(var, raising=False)
    distributed.init_distributed(None, 1, None)  # explicit NUM_HOSTS=1
    distributed.init_distributed(None, None, None)  # nothing configured


