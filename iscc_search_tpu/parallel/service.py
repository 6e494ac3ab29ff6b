"""
Multi-host SPMD control plane: one index served by every process of a
``jax.distributed`` cluster.

The device side of multi-host search is pure SPMD: every process must launch
the same jitted collective program (the hierarchical scan in parallel/merge)
in the same order, or the cluster deadlocks. JAX provides no control channel
for WHEN to launch — that is this module. Process 0 (the coordinator) owns
the product surface (HTTP server, store enrichment, write path) and fans
every device-relevant engine operation out to follower processes over a tiny
length-prefixed pickle protocol on TCP; followers run a `follow()` loop that
applies each operation to their local replica of the engine state, joining
the collectives the coordinator launches.

Consistency model (store-is-truth, derived-state mirrored):

- The coordinator serializes ALL hooked operations under one lock — the lock
  order IS the global SPMD program order on every process.
- Mutations (``add``/``remove``) are mirrored at the ENGINE call level with
  the exact arguments, so every process appends identical rows in identical
  order and the next device sync rebuilds identical partition shapes
  everywhere. Followers acknowledge mutations before the coordinator applies
  its own copy and releases the lock; searches need no ack — the collective
  rendezvous itself is the synchronization.
- Followers never persist (``save_enabled = False``): the coordinator's
  store + segment directory is the single durable truth.

The reference explicitly refuses this topology
(/root/reference/iscc_search/indexes/usearch/manager.py:43-47 — "multiple
processes" unsupported); this is the accelerator-native answer (SURVEY §2.3,
BASELINE config 5).
"""

from __future__ import annotations

import pickle
import socket
import struct
import threading

from iscc_search_tpu.utils import get_logger

logger = get_logger(__name__)

_LEN = struct.Struct(">I")
_ACK = b"\x01"
_MAX_OP_BYTES = 1 << 30


def _send_msg(sock, payload):
    # type: (socket.socket, bytes) -> None
    sock.sendall(_LEN.pack(len(payload)) + payload)


def _recv_exact(sock, n):
    # type: (socket.socket, int) -> bytes
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("control channel closed")
        buf.extend(chunk)
    return bytes(buf)


def _recv_msg(sock):
    # type: (socket.socket) -> bytes
    (n,) = _LEN.unpack(_recv_exact(sock, _LEN.size))
    if n > _MAX_OP_BYTES:
        raise ValueError(f"control message of {n} bytes exceeds limit")
    return _recv_exact(sock, n)


class MultihostService:
    """
    Coordinator/follower glue for one multi-host index.

    Coordinator (process 0): listens on ``port``, accepts one connection per
    follower, and exposes :meth:`hook` to wrap an engine index's device
    operations. Followers connect and run :meth:`follow` with a resolver
    that maps an index name to their local engine replica.
    """

    def __init__(self, is_coordinator, n_followers=0, host="0.0.0.0",
                 coordinator_host="localhost", port=7801, timeout=120.0):
        # type: (bool, int, str, str, int, float) -> None
        self.is_coordinator = is_coordinator
        self._lock = threading.RLock()  # global SPMD op order
        self._conns = []  # type: list[socket.socket]
        self._sock = None  # type: socket.socket | None
        self._stopped = False
        if is_coordinator:
            srv = socket.create_server((host, port))
            srv.settimeout(timeout)
            try:
                for _ in range(n_followers):
                    conn, addr = srv.accept()
                    conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                    self._conns.append(conn)
                    logger.info(f"multihost control: follower connected from {addr}")
            finally:
                srv.close()
        else:
            deadline = timeout
            import time

            t0 = time.monotonic()
            while True:
                try:
                    self._sock = socket.create_connection((coordinator_host, port), timeout=5.0)
                    break
                except OSError:
                    if time.monotonic() - t0 > deadline:
                        raise
                    time.sleep(0.2)
            self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            self._sock.settimeout(None)
            logger.info(f"multihost control: connected to coordinator at {coordinator_host}:{port}")

    # ------------------------------------------------------------ coordinator

    def _broadcast(self, op, want_ack):
        # type: (tuple, bool) -> None
        payload = pickle.dumps(op, protocol=pickle.HIGHEST_PROTOCOL)
        for conn in self._conns:
            _send_msg(conn, payload)
        if want_ack:
            for conn in self._conns:
                if _recv_exact(conn, 1) != _ACK:
                    raise RuntimeError("follower reported failure applying control op")

    def run_op(self, op, local):
        # type: (tuple, ...) -> ...
        """
        Execute one SPMD operation cluster-wide: broadcast the op, then run
        the local half under the global order lock.

        Mutations (acked) complete on every follower before the local copy
        applies and the lock releases; searches rendezvous in the collective.
        """
        want_ack = op[0] != "search"
        with self._lock:
            self._broadcast(op, want_ack)
            return local()

    def hook(self, name, index):
        # type: (str, ...) -> None
        """Wrap ``index``'s device ops so they execute cluster-wide (coordinator)."""

        def control_hook(op_name, args, local):
            return self.run_op((op_name, name) + args, local)

        index.control_hook = control_hook

    def stop(self):
        # type: () -> None
        """Tell followers to exit their follow loop and close the channel."""
        if self._stopped:
            return
        self._stopped = True
        if self.is_coordinator:
            try:
                with self._lock:
                    self._broadcast(("stop",), want_ack=False)
            except OSError:  # pragma: no cover - followers already gone
                pass
            for conn in self._conns:
                conn.close()
        elif self._sock is not None:
            self._sock.close()

    # --------------------------------------------------------------- follower

    def check(self, name, rows, live):
        # type: (str, int, int) -> None
        """Coordinator: assert a follower replica matches before serving."""
        self.run_op(("check", name, rows, live), lambda: None)

    def follow(self, resolve):
        # type: (...) -> None
        """
        Follower loop: apply operations until a ``stop`` op or channel close.

        :param resolve: callable(name) -> engine index replica (created on
            demand; must produce identical configuration to the coordinator's)
        """
        while True:
            try:
                op = pickle.loads(_recv_msg(self._sock))
            except (ConnectionError, OSError):
                logger.info("multihost control: channel closed, follower exiting")
                return
            kind = op[0]
            if kind == "stop":
                return
            try:
                index = resolve(op[1])
                index.save_enabled = False  # coordinator owns persistence
                if kind == "search":
                    index._search_impl(op[2], op[3])
                elif kind == "add":
                    index._add_impl(op[2], op[3])
                elif kind == "add_packed":
                    index._add_packed_impl(op[2], op[3], op[4])
                elif kind == "remove":
                    index._remove_impl(op[2])
                elif kind == "check":
                    rows, live = op[2], op[3]
                    if index._rows != rows or index._live != live:
                        raise RuntimeError(
                            f"replica state mismatch for '{op[1]}': coordinator has "
                            f"rows={rows} live={live}, this process has "
                            f"rows={index._rows} live={index._live}"
                        )
                else:
                    raise ValueError(f"unknown control op: {kind!r}")
            except BaseException:
                # A diverged follower must fail LOUDLY, not answer the ack —
                # the coordinator sees the dead channel instead of silently
                # wrong merged results.
                logger.exception(f"multihost follower failed applying {kind!r}")
                self._sock.close()
                raise
            if kind != "search":
                self._sock.sendall(_ACK)
