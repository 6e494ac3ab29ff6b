"""
Threaded WSGI HTTP server with lifespan management.

Serves the WSGI app with a thread-per-request model (stdlib
wsgiref + ThreadingMixIn). Protocol methods are synchronous, so this matches
the reference's FastAPI-threadpool concurrency model. In aggregator mode the
transparency-log poller runs on a dedicated asyncio thread, with a clean
stop/flush sequence on shutdown (lifespan parity with reference
server/__init__.py:75-135).
"""

from __future__ import annotations

import asyncio
import threading
from socketserver import ThreadingMixIn
from wsgiref.simple_server import WSGIRequestHandler, WSGIServer, make_server

from iscc_search_tpu.schema import IsccIndex
from iscc_search_tpu.utils import get_logger, configure_logging

logger = get_logger(__name__)


class ThreadingWSGIServer(ThreadingMixIn, WSGIServer):
    """Thread-per-request WSGI server."""

    daemon_threads = True
    # The socketserver default listen backlog is 5. Clients without
    # keep-alive (one TCP connect per request) overflow that under modest
    # concurrency, and a dropped SYN retransmits after exactly 1s, which
    # shows up as a ~1 s p99 under 16 clients.
    request_queue_size = 128


class QuietHandler(WSGIRequestHandler):
    """Route request logs through the application logger."""

    def log_message(self, format, *args):  # noqa: A002
        logger.info("%s - %s" % (self.address_string(), format % args))


class AggregatorRunner:
    """Owns the poller's asyncio loop on a dedicated thread."""

    def __init__(self, index, opts, status):
        # type: (..., ..., dict) -> None
        self.index = index
        self.opts = opts
        self.status = status
        self._thread = None  # type: threading.Thread | None
        self._loop = None  # type: asyncio.AbstractEventLoop | None
        self._stop_event = None  # type: asyncio.Event | None

    def start(self):
        # type: () -> None
        from iscc_search_tpu.aggregator import poller

        # Ensure the aggregator index exists so reads don't 404 on a fresh deploy
        try:
            self.index.create_index(IsccIndex(name=self.opts.aggregator_index_name))
            logger.info(f"Created aggregator index '{self.opts.aggregator_index_name}'")
        except FileExistsError:
            pass

        ready = threading.Event()

        def run_loop():
            self._loop = asyncio.new_event_loop()
            asyncio.set_event_loop(self._loop)
            self._stop_event = asyncio.Event()
            ready.set()
            try:
                self._loop.run_until_complete(poller.run(self.index, self.opts, self._stop_event, self.status))
            except Exception:  # pragma: no cover
                logger.exception("Aggregator poller crashed")
            finally:
                self._loop.close()

        self._thread = threading.Thread(target=run_loop, name="aggregator-poller", daemon=True)
        self._thread.start()
        ready.wait()
        logger.info(f"Aggregator mode active: network={self.opts.aggregator_network}")

    def stop(self, timeout=30.0):
        # type: (float) -> None
        if self._loop is None or self._stop_event is None:
            return
        try:
            self._loop.call_soon_threadsafe(self._stop_event.set)
        except RuntimeError:
            # Loop already closed: the poller crashed earlier. stop() must
            # not raise — serve()'s finally still has to close the index.
            logger.warning("Aggregator poller was already stopped (earlier crash?)")
        if self._thread is not None:
            self._thread.join(timeout)
            if self._thread.is_alive():  # pragma: no cover - needs a wedged poller
                logger.warning(
                    f"Aggregator poller did not stop within {timeout}s; "
                    "proceeding to close the index (an in-flight ingest may fail)"
                )


def _multihost_index_name(opts):
    # type: (...) -> str | None
    return opts.multihost_index or (opts.aggregator_index_name if opts.aggregator_mode else None)


def _serve_follower(opts):
    # type: (...) -> None
    """Non-zero process of a multi-host cluster: no HTTP — open the replica
    and join the coordinator's SPMD search program until released."""
    configure_logging(level=opts.log_level)
    from iscc_search_tpu.options import get_index

    name = _multihost_index_name(opts)
    if not name:
        raise ValueError(
            "multi-host follower needs ISCC_SEARCH_MULTIHOST_INDEX (the index this cluster serves)"
        )
    index = get_index(opts.index_uri)
    if not hasattr(index, "follow_index"):
        raise ValueError(f"backend {opts.index_uri!r} does not support multi-host serving (use tpu://)")
    logger.info(f"Multi-host follower: serving index '{name}' (coordinator: {opts.multihost_coordinator})")
    try:
        index.follow_index(name)
    finally:
        index.close()


def serve(opts=None, on_ready=None):
    # type: (..., ...) -> None
    """Run the API server until interrupted (index lifecycle managed here).

    :param on_ready: called with the bound HTTP server just before it starts
        serving; a caller that runs ``serve`` on a thread keeps it to call
        ``shutdown()``, which returns ``serve`` through its normal cleanup.
    """
    from iscc_search_tpu.options import get_index, search_opts
    from iscc_search_tpu.server.app import create_app

    opts = opts or search_opts
    if opts.distributed:
        # Multi-host cluster (SURVEY §2.3; BASELINE config 5): initialize the
        # jax.distributed runtime (deployments set JAX_COORDINATOR_ADDRESS/
        # JAX_NUM_PROCESSES/JAX_PROCESS_ID), then split roles: process 0
        # serves HTTP as the coordinator, the rest run the follower loop.
        import jax

        jax.distributed.initialize()
        if jax.process_index() > 0:
            _serve_follower(opts)
            return
    if opts.workers and opts.workers > 1:
        # Multi-process scale-out: SO_REUSEPORT HTTP workers + this process
        # as the engine (single writer). Aggregator mode stays single-process
        # (one poller); the CLI rejects that combination.
        from iscc_search_tpu.server.scaleout import serve_scaleout

        serve_scaleout(opts)
        return
    configure_logging(level=opts.log_level)
    index = get_index(opts.index_uri)
    if opts.distributed:
        # Coordinator must open the served index BEFORE traffic: followers
        # connect to its control plane during TpuIndex construction.
        name = _multihost_index_name(opts)
        if not name or not hasattr(index, "open_index"):
            index.close()
            raise ValueError(
                "multi-host serving needs ISCC_SEARCH_MULTIHOST_INDEX and a tpu:// backend"
            )
        index.open_index(name)
    app = create_app(index=index, opts=opts)

    # Bind the socket FIRST: if the port is taken, nothing else must have
    # started (a poller spawned before a failed bind would be killed
    # mid-ingest with no flush when the process exits).
    try:
        if opts.http_backend == "wsgiref":
            httpd = make_server(
                opts.host, opts.port, app, server_class=ThreadingWSGIServer, handler_class=QuietHandler
            )
        else:
            from iscc_search_tpu.server.pooled import PooledHTTPServer

            httpd = PooledHTTPServer(
                opts.host,
                opts.port,
                app,
                threads=opts.http_threads,
                max_pending=opts.http_max_pending,
                queue_deadline=opts.http_queue_deadline_ms / 1000.0,
            )
    except OSError:
        index.close()
        raise
    runner = None
    if opts.aggregator_mode:
        try:
            runner = AggregatorRunner(index, opts, app.state.aggregator_status)
            runner.start()
        except BaseException:
            # Same cleanup contract as a failed bind: nothing may leak the
            # bound socket or an unflushed index.
            httpd.server_close()
            index.close()
            raise
    logger.info(f"Serving on http://{opts.host}:{opts.port} (backend: {opts.index_uri})")
    if on_ready is not None:
        on_ready(httpd)

    # Graceful SIGTERM (Docker/k8s stop): drain the server loop, then flush
    # and close the index in the finally block — parity with the reference's
    # stop_grace_period guidance (docs/howto/deployment.md). shutdown() must
    # run off the serving thread, so the handler hands it to a helper thread.
    import signal

    def _term(_signum, _frame):  # pragma: no cover - signal delivery timing
        logger.info("SIGTERM received: draining connections and saving state...")
        threading.Thread(target=httpd.shutdown, daemon=True).start()

    previous = None
    try:
        previous = signal.signal(signal.SIGTERM, _term)
    except ValueError:  # pragma: no cover - non-main thread (tests/embedding)
        pass

    try:
        httpd.serve_forever()
    except KeyboardInterrupt:  # pragma: no cover
        pass
    finally:
        logger.info("Shutting down: stopping poller and closing index...")
        if runner is not None:
            runner.stop()
        index.close()
        httpd.server_close()
        if previous is not None:
            try:
                signal.signal(signal.SIGTERM, previous)
            except ValueError:  # pragma: no cover
                pass
