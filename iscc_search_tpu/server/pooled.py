"""
Pooled keep-alive HTTP/1.1 WSGI server.

wsgiref's ThreadingMixIn spawns a thread per connection and speaks
HTTP/1.0 (connection-per-request), which caps the transport at ~1.8k QPS
with a stub app on this host (benchmarks/http_stack.py) — far below the
engine's capability. This server keeps the same synchronous WSGI contract
(server/wsgi.py apps run unchanged) on a faster transport:

- one accept thread + an epoll "parking lot" for idle keep-alive
  connections (no thread pinned to an idle socket),
- a fixed worker pool that pops a READABLE connection, parses one
  request, runs the WSGI app, writes the response, and parks the
  connection again (pipelined bytes stay in the per-connection buffer),
- HTTP/1.1 persistent connections with Content-Length framing.

The reference deploys FastAPI on uvicorn's event loop
(/root/reference/docs/howto/deployment.md); this is the equivalent
transport upgrade for the hand-rolled stack (the environment ships no
ASGI server), sized for the device engine's batched throughput.
"""

from __future__ import annotations

import io
import queue
import select
import socket
import threading
import time
from urllib.parse import unquote, urlsplit

from iscc_search_tpu.utils import get_logger

logger = get_logger(__name__)

_LIMIT_HEADER = 65536
_LIMIT_BODY = 512 * 1024 * 1024
_STATUS_WITH_NO_BODY = {204, 304}


class _Conn:
    __slots__ = ("sock", "fd", "addr", "buf", "closed", "parked_at", "queued_at")

    def __init__(self, sock, addr):
        self.sock = sock
        self.fd = sock.fileno()
        self.addr = addr
        self.buf = b""
        self.closed = False
        self.parked_at = 0.0
        self.queued_at = 0.0


class PooledHTTPServer:
    """Thread-pool keep-alive HTTP/1.1 server for synchronous WSGI apps."""

    def __init__(self, host, port, app, threads=16, backlog=512, sock=None, idle_timeout=120.0,
                 request_timeout=30.0, max_pending=64, queue_deadline=0.5, overload_probe=None,
                 sweep_interval=5.0):
        # type: (str, int, ..., int, int, socket.socket | None, float, float, int, float, ..., float) -> None
        self.app = app
        # How often the park loop reaps idle keep-alive connections; a
        # constructor knob so tests can drive both sweep outcomes without
        # real multi-second waits.
        self.sweep_interval = sweep_interval
        # Optional zero-arg callable consulted at admission: True sheds the
        # request BEFORE any parse/app work (scale-out workers pass the
        # engine-RPC overload breaker, so requests the engine would reject
        # anyway never cost a parse + RPC round trip).
        self.overload_probe = overload_probe
        self.threads = threads
        self.idle_timeout = idle_timeout
        # Whole-request read budget: per-recv timeouts alone let a trickling
        # client renew 30 s per byte and pin a pool worker indefinitely.
        self.request_timeout = request_timeout
        # Overload policy: past saturation the server SHEDS (503 +
        # Retry-After) instead of queueing unboundedly — without this, 2x
        # offered load measured 12.3 s p50 with zero errors, every response
        # arriving after the client gave up. Two independent guards:
        # - max_pending bounds the ready-request queue depth (admission),
        # - queue_deadline bounds how stale a queued request may get before
        #   a worker answers it (p50 at overload stays ~deadline, not
        #   unbounded). 0 disables either guard.
        self.max_pending = max_pending
        self.queue_deadline = queue_deadline
        self.shed_count = 0  # observability: requests shed since start
        self._pending = 0
        self._pending_lock = threading.Lock()
        if sock is not None:
            # Pre-bound (SO_REUSEPORT worker) socket: already bound+listening
            self._sock = sock
        else:
            self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            self._sock.bind((host, port))
            self._sock.listen(backlog)
        self.server_address = self._sock.getsockname()
        self.server_port = self.server_address[1]
        self._queue = queue.SimpleQueue()  # type: queue.SimpleQueue
        self._parked = {}  # type: dict[int, _Conn]
        self._parked_lock = threading.Lock()
        self._epoll = select.epoll()
        # Self-pipe wakes the parking loop for shutdown and new parks
        self._wr, self._rd = socket.socketpair()
        self._epoll.register(self._rd.fileno(), select.EPOLLIN)
        self._shutdown = threading.Event()
        self._done = threading.Event()
        self._workers = []  # type: list[threading.Thread]
        self._accept_thread = None  # type: threading.Thread | None
        self._park_thread = None  # type: threading.Thread | None

    # ------------------------------------------------------------ lifecycle

    def serve_forever(self):
        # type: () -> None
        self._accept_thread = threading.Thread(target=self._accept_loop, name="http-accept", daemon=True)
        self._park_thread = threading.Thread(target=self._park_loop, name="http-park", daemon=True)
        self._accept_thread.start()
        self._park_thread.start()
        for i in range(self.threads):
            t = threading.Thread(target=self._worker_loop, name=f"http-worker-{i}", daemon=True)
            t.start()
            self._workers.append(t)
        # Block until shutdown() — matches wsgiref's serve_forever contract.
        self._done.wait()

    def shutdown(self):
        # type: () -> None
        self._shutdown.set()
        try:
            self._wr.send(b"x")
        except OSError:  # pragma: no cover
            pass
        # Unblock workers
        for _ in self._workers:
            self._queue.put(None)
        for t in self._workers:
            t.join(5)
        self._done.set()

    def server_close(self):
        # type: () -> None
        if not self._shutdown.is_set():
            self.shutdown()
        try:
            self._sock.close()
        finally:
            with self._parked_lock:
                conns = list(self._parked.values())
                self._parked.clear()
            for conn in conns:
                self._close_conn(conn, unregister=False)
            self._epoll.close()
            self._wr.close()
            self._rd.close()

    # ------------------------------------------------------------- plumbing

    def _accept_loop(self):
        # type: () -> None
        self._sock.settimeout(0.5)
        # `while True` + explicit check: a while-condition would be compiled
        # as entry + loop-bottom test copies, and the bottom copy's
        # "shutdown observed exactly between accept-return and re-check"
        # outcome is pure thread timing; the single `if` is deterministic.
        while True:
            if self._shutdown.is_set():
                return
            try:
                sock, addr = self._sock.accept()
            except socket.timeout:
                continue
            except OSError as exc:
                # Transient accept errors (ECONNABORTED: peer reset between
                # SYN-ACK and accept; EMFILE/ENFILE: fd pressure) must NOT
                # kill the accept thread — that would silently stop serving
                # new connections forever. Only a closed listener (shutdown)
                # ends the loop.
                if self._shutdown.is_set() or self._sock.fileno() < 0:
                    return
                logger.warning(f"accept() error (continuing): {exc}")
                time.sleep(0.05)
                continue
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            sock.settimeout(30.0)
            # Park new connections until their first request bytes arrive:
            # handing an idle socket straight to a blocking worker lets
            # `threads` zero-byte connections pin the whole pool for
            # request_timeout each (slowloris). Parked sockets cost one
            # epoll slot and are reaped by the idle sweep; a worker only
            # runs once the fd is readable. (A header-trickle attacker is
            # still bounded by the per-request deadline.)
            self._park(_Conn(sock, addr))

    def _park(self, conn):
        # type: (_Conn) -> None
        """Wait for the connection's next request bytes in epoll."""
        with self._parked_lock:
            conn.parked_at = time.monotonic()
            self._parked[conn.fd] = conn
            try:
                self._epoll.register(conn.fd, select.EPOLLIN | select.EPOLLRDHUP)
            except (OSError, ValueError):  # pragma: no cover - fd raced closed
                self._parked.pop(conn.fd, None)
                self._close_conn(conn, unregister=False)

    def _park_loop(self):
        # type: () -> None
        last_sweep = time.monotonic()
        while not self._shutdown.is_set():
            try:
                events = self._epoll.poll(1.0)
            except (OSError, ValueError):  # pragma: no cover - epoll closed
                return
            for fd, _mask in events:
                if fd == self._rd.fileno():
                    try:
                        self._rd.recv(64)
                    except OSError:  # pragma: no cover
                        pass
                    continue
                with self._parked_lock:
                    conn = self._parked.pop(fd, None)
                    if conn is not None:
                        try:
                            self._epoll.unregister(fd)
                        except (OSError, ValueError):  # pragma: no cover
                            pass
                if conn is not None:
                    self._enqueue_ready(conn)
            # Reap idle keep-alive connections: each parked socket holds an
            # fd; without a sweep, idle clients accumulate until EMFILE.
            now = time.monotonic()
            if now - last_sweep >= self.sweep_interval:
                last_sweep = now
                stale = []
                with self._parked_lock:
                    for fd, conn in list(self._parked.items()):
                        if now - conn.parked_at > self.idle_timeout:
                            self._parked.pop(fd, None)
                            try:
                                self._epoll.unregister(fd)
                            except (OSError, ValueError):  # pragma: no cover
                                pass
                            stale.append(conn)
                for conn in stale:
                    self._close_conn(conn, unregister=False)

    def _close_conn(self, conn, unregister=True):
        # type: (_Conn, bool) -> None
        if conn.closed:
            return
        conn.closed = True
        try:
            conn.sock.close()
        except OSError:  # pragma: no cover
            pass

    # -------------------------------------------------------------- workers

    def _enqueue_ready(self, conn):
        # type: (_Conn) -> None
        """Admit a ready request to the worker queue, or shed with 503.

        The 503 write happens on the park/accept thread, so it must never
        block: a single non-blocking send (the ~120-byte response fits any
        healthy socket buffer; a peer that cannot take it is closed)."""
        if self.overload_probe is not None and self.overload_probe():
            self.shed_count += 1
            self._shed(conn, blocking=False)
            return
        if self.max_pending:
            with self._pending_lock:
                if self._pending >= self.max_pending:
                    shed = True
                else:
                    self._pending += 1
                    shed = False
            if shed:
                self.shed_count += 1
                self._shed(conn, blocking=False)
                return
        else:
            with self._pending_lock:
                self._pending += 1
        conn.queued_at = time.monotonic()
        self._queue.put(conn)

    def _shed(self, conn, blocking):
        # type: (_Conn, bool) -> None
        payload = b'{"detail": "Server overloaded, retry later"}'
        head = (
            f"HTTP/1.1 503 Service Unavailable\r\nContent-Type: application/json\r\n"
            f"Content-Length: {len(payload)}\r\nRetry-After: 1\r\nConnection: close\r\n\r\n"
        ).encode("latin-1")
        try:
            if blocking:
                conn.sock.settimeout(5.0)
                conn.sock.sendall(head + payload)
                conn.sock.shutdown(socket.SHUT_WR)
                # Drain the UNREAD request bytes: closing with data in the
                # receive buffer makes the kernel RST the connection, which
                # can discard the 503 before the client reads it. Drain what
                # has ARRIVED without blocking, then wait one short recv for
                # the peer's FIN. The old 64 x 0.5s-timeout drain could pin a
                # pool worker for seconds PER SHED — under deep overload the
                # whole pool sat in drain waits (the 1600-QPS open-loop step's
                # 2.9 s p90 was drain stalls, not service time).
                conn.sock.setblocking(False)
                try:
                    while conn.sock.recv(65536):
                        pass
                except (BlockingIOError, OSError):
                    pass
                conn.sock.settimeout(0.05)
                try:
                    conn.sock.recv(65536)
                except (OSError, BlockingIOError):
                    pass
            else:
                # Park/accept thread: one non-blocking send + drain; a peer
                # that can't take ~170 bytes is closed (possibly RST).
                conn.sock.setblocking(False)
                conn.sock.send(head + payload)
                try:
                    conn.sock.shutdown(socket.SHUT_WR)
                    while conn.sock.recv(65536):
                        pass
                except (OSError, BlockingIOError):
                    pass
        except (OSError, BlockingIOError):
            pass
        self._close_conn(conn)

    def _worker_loop(self):
        # type: () -> None
        while True:
            conn = self._queue.get()
            if conn is None:
                return
            with self._pending_lock:
                self._pending -= 1
            try:
                # conn.queued_at == 0 means the conn skipped admission
                # (direct queue puts in tests) — never deadline-shed those.
                if (
                    self.queue_deadline
                    and conn.queued_at
                    and time.monotonic() - conn.queued_at > self.queue_deadline
                ):
                    # Stale in queue past the deadline: the client has likely
                    # timed out — shed instead of burning engine time on it.
                    self.shed_count += 1
                    self._shed(conn, blocking=True)
                    continue
                keep = self._handle_one(conn)
            except Exception:
                logger.exception("HTTP worker error")
                keep = False
            if not keep:
                self._close_conn(conn)
            elif conn.buf:
                # Pipelined next request already buffered: stay hot (subject
                # to the same admission bound as fresh arrivals)
                self._enqueue_ready(conn)
            else:
                self._park(conn)

    def _read_until(self, conn, marker, limit, deadline):
        # type: (_Conn, bytes, int, float) -> bytes | None
        while marker not in conn.buf:
            if len(conn.buf) > limit:
                return None
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                return None
            conn.sock.settimeout(min(30.0, remaining))
            data = conn.sock.recv(65536)
            if not data:
                return None
            conn.buf += data
        head, conn.buf = conn.buf.split(marker, 1)
        return head

    def _handle_one(self, conn):
        # type: (_Conn) -> bool
        """Parse one request, run the app, write the response.

        :return: True to keep the connection alive.
        """
        deadline = time.monotonic() + self.request_timeout
        try:
            head = self._read_until(conn, b"\r\n\r\n", _LIMIT_HEADER, deadline)
        except (OSError, socket.timeout):
            return False
        if head is None:
            return False
        lines = head.split(b"\r\n")
        try:
            method, target, version = lines[0].decode("latin-1").split(" ", 2)
        except ValueError:
            self._write_simple(conn, 400, b'{"detail": "Bad Request"}')
            return False
        headers = {}
        for raw in lines[1:]:
            name, sep, value = raw.decode("latin-1").partition(":")
            if sep:
                # RFC 7230 §3.2.2: repeated field names combine with ", " —
                # last-wins would silently drop earlier Cookie/XFF values.
                key = name.strip().lower()
                val = value.strip()
                headers[key] = headers[key] + ", " + val if key in headers else val

        if "transfer-encoding" in headers:
            # Reject ANY Transfer-Encoding, not just the exact "chunked":
            # "gzip, chunked" (or any parameterized variant) is still
            # chunked-framed per RFC 7230 §3.3.3, and framing the body by
            # Content-Length while the peer frames by chunks desyncs the
            # keep-alive stream (request smuggling behind a TE-forwarding
            # proxy). This server never supports TE; always answer 411 and
            # close so unread chunk bytes can't become the "next request".
            self._write_simple(conn, 411, b'{"detail": "Length Required"}')
            return False
        try:
            length = int(headers.get("content-length") or 0)
        except ValueError:
            # An unparseable Content-Length desyncs keep-alive framing if
            # treated as 0 (the actual body bytes would parse as the next
            # request) — RFC 7230 §3.3.2: respond 400 and close.
            self._write_simple(conn, 400, b'{"detail": "Invalid Content-Length"}')
            return False
        if length < 0 or length > _LIMIT_BODY:
            self._write_simple(conn, 413, b'{"detail": "Payload Too Large"}')
            return False
        if length and headers.get("expect", "").lower() == "100-continue" and len(conn.buf) < length:
            # Conforming clients wait for the interim response before
            # sending the body; without it they stall out their expect
            # timeout while a pool worker sits in the body read.
            try:
                conn.sock.sendall(b"HTTP/1.1 100 Continue\r\n\r\n")
            except (OSError, socket.timeout):
                return False
        try:
            while len(conn.buf) < length:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return False
                conn.sock.settimeout(min(30.0, remaining))
                data = conn.sock.recv(65536)
                if not data:
                    return False
                conn.buf += data
        except (OSError, socket.timeout):
            return False
        body, conn.buf = conn.buf[:length], conn.buf[length:]

        parts = urlsplit(target)
        environ = {
            "REQUEST_METHOD": method.upper(),
            "PATH_INFO": unquote(parts.path),
            "QUERY_STRING": parts.query,
            "SERVER_NAME": self.server_address[0],
            "SERVER_PORT": str(self.server_port),
            "SERVER_PROTOCOL": version,
            "REMOTE_ADDR": conn.addr[0],
            "wsgi.version": (1, 0),
            "wsgi.url_scheme": "http",
            "wsgi.input": io.BytesIO(body),
            "wsgi.errors": io.StringIO(),
            "wsgi.multithread": True,
            "wsgi.multiprocess": False,
            "wsgi.run_once": False,
        }
        if "content-type" in headers:
            environ["CONTENT_TYPE"] = headers["content-type"]
        if length:
            environ["CONTENT_LENGTH"] = str(length)
        for name, value in headers.items():
            key = "HTTP_" + name.upper().replace("-", "_")
            if key not in ("HTTP_CONTENT_TYPE", "HTTP_CONTENT_LENGTH"):
                environ[key] = value

        keep = version == "HTTP/1.1"
        if headers.get("connection", "").lower() == "close":
            keep = False
        elif version == "HTTP/1.0" and headers.get("connection", "").lower() == "keep-alive":
            keep = True

        status_headers = []  # type: list

        def start_response(status, response_headers, exc_info=None):
            status_headers[:] = [status, response_headers]
            return lambda data: None  # write() callable (unused by our apps)

        try:
            chunks = self.app(environ, start_response)
            payload = b"".join(chunks)
            if hasattr(chunks, "close"):  # pragma: no cover - generator apps
                chunks.close()
        except Exception:
            logger.exception("WSGI app error")
            self._write_simple(conn, 500, b'{"detail": "Internal Server Error"}')
            return False
        if not status_headers:  # pragma: no cover - misbehaving app
            self._write_simple(conn, 500, b'{"detail": "Internal Server Error"}')
            return False
        status, response_headers = status_headers
        code = int(status.split(" ", 1)[0])
        out = [f"HTTP/1.1 {status}\r\n".encode("latin-1")]
        has_length = False
        for name, value in response_headers:
            if name.lower() == "content-length":
                has_length = True
            out.append(f"{name}: {value}\r\n".encode("latin-1"))
        if not has_length and code not in _STATUS_WITH_NO_BODY:
            out.append(f"Content-Length: {len(payload)}\r\n".encode("latin-1"))
        out.append(b"Connection: keep-alive\r\n" if keep else b"Connection: close\r\n")
        out.append(b"\r\n")
        if environ["REQUEST_METHOD"] != "HEAD":
            out.append(payload)
        try:
            # Reset from any shortened deadline-read timeout before writing
            conn.sock.settimeout(30.0)
            conn.sock.sendall(b"".join(out))
        except (OSError, socket.timeout):
            return False
        return keep

    def _write_simple(self, conn, code, payload):
        # type: (_Conn, int, bytes) -> None
        text = {400: "Bad Request", 411: "Length Required", 413: "Payload Too Large", 500: "Internal Server Error"}
        head = (
            f"HTTP/1.1 {code} {text.get(code, 'Error')}\r\n"
            f"Content-Type: application/json\r\nContent-Length: {len(payload)}\r\n"
            f"Connection: close\r\n\r\n"
        ).encode("latin-1")
        try:
            conn.sock.sendall(head + payload)
        except (OSError, socket.timeout):  # pragma: no cover
            pass
