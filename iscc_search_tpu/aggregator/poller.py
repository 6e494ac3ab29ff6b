"""
Transparency-log poller (async I/O shell over the Sans-IO cores).

Behavioral parity with reference aggregator/poller.py — cover new records
with bundle fetches, isolate per-hub and per-bundle failures, re-backfill
from leaf 0 on checkpoint regression, publish per-hub status for /status —
plus two additions: durable per-hub cursors (aggregator.cursors) so restarts
resume instead of re-backfilling, and a store-durability barrier before each
cursor advance is persisted (a cursor must never claim records the backend
could still lose in a crash; add_assets alone only reaches the OS page
cache). At-least-once delivery with idempotent upserts keeps every path safe.
"""

from __future__ import annotations

import asyncio
import contextlib
import os
import subprocess
import sys
import threading
import time
from collections import Counter
from dataclasses import dataclass, field
from typing import TYPE_CHECKING

import httpx

from iscc_search_tpu.aggregator import convert_worker, hublist, tlog
from iscc_search_tpu.aggregator.entry import REASONS, convert_group, entry_from_fields
from iscc_search_tpu.utils import get_logger

if TYPE_CHECKING:  # pragma: no cover
    from iscc_search_tpu.options import SearchOptions  # noqa: F401

logger = get_logger(__name__)

HTTP_TIMEOUT = 30.0


@dataclass(frozen=True)
class PollResult:
    """Outcome of one hub poll: new cursor, per-reason counts, bundle error."""

    last_size: int
    counts: dict
    error: str | None = None


@dataclass
class HubStatus:
    """Mutable per-hub ingestion status shared with the /status endpoint."""

    hub_id: int
    url: str
    cursor: int = 0
    last_poll: float | None = None
    ok: bool = True
    error: str | None = None
    counts: dict = field(default_factory=dict)


def plan_bundles(last_size, tree_size):
    # type: (int, int) -> list[tuple[int, int]]
    """
    Entry-bundle fetch plan covering records [last_size, tree_size).

    Walks the cursor bundle by bundle: each step emits (bundle_index, width)
    where width 0 requests a full bundle and width > 0 the in-progress
    partial bundle (``.p/<width>``). Empty when the tree has not grown
    (regression handled by the caller).
    """
    plan = []
    cursor = last_size
    while cursor < tree_size:
        bundle = cursor // tlog.TILE_WIDTH
        bundle_end = (bundle + 1) * tlog.TILE_WIDTH
        if bundle_end <= tree_size:
            plan.append((bundle, 0))
            cursor = bundle_end
        else:
            plan.append((bundle, tree_size - bundle * tlog.TILE_WIDTH))
            cursor = tree_size
    return plan


def _index_fields(index, index_name, fields):
    # type: (..., str, list[tuple]) -> int
    """
    Build wire entries from primitive fields and index them (one thread hop).

    Entry construction is guarded per record: a field set the wire model
    rejects (e.g. a code decomposing to a single unit, below IsccEntry's
    units min_length) is dropped and counted, never allowed to fail the
    group — one poison record from an untrusted log would otherwise stall
    the hub's cursor forever, re-fetching and re-crashing every poll.

    :return: number of records dropped by wire-model validation
    """
    entries = []
    dropped = 0
    for f in fields:
        try:
            entries.append(entry_from_fields(f))
        except Exception:
            dropped += 1
    index.add_assets(index_name, entries)
    return dropped


def _log_skips(group_tally, hub_url):
    # type: (dict, str) -> None
    """One aggregated warning per non-benign skip reason in a converted group."""
    for reason, count in group_tally.items():
        if count and reason not in ("ok", "deletion"):
            logger.warning(f"aggregator: {hub_url}: skipped {count} record(s) ({reason})")


#: Bundles per indexing cycle. 256-record cycles leave half the ingest rate
#: on the table in fixed per-call costs (convert dispatch + add_assets
#: store-commit overhead); ~4096-record groups measured ~2x faster on the
#: benchmark (benchmarks/aggregator_ingest.py) with the same crash-retry
#: contract, just at group granularity (re-backfill is idempotent either way).
GROUP_BUNDLES = 16

#: PYTHONPATH entries with a path COMPONENT equal to this name are stripped
#: from conversion-worker subprocess environments, for hosts whose PYTHONPATH
#: carries an interpreter start-up hook that a pure host-side codec worker
#: must not inherit. Matching is on whole path segments, not substrings — an
#: unrelated entry that merely CONTAINS the token is kept. Set via
#: ISCC_SEARCH_WORKER_PYTHONPATH_EXCLUDE; unset or empty disables the filter.
WORKER_PYTHONPATH_EXCLUDE = os.environ.get("ISCC_SEARCH_WORKER_PYTHONPATH_EXCLUDE", "")


def _path_has_component(path, name):
    # type: (str, str) -> bool
    """True when ``name`` equals a whole segment of ``path``."""
    return name in path.replace(os.altsep or os.sep, os.sep).split(os.sep)


def _worker_env():
    # type: () -> dict
    """
    Private, hermetic env dict for a conversion-worker subprocess.

    Strips PYTHONPATH entries matching WORKER_PYTHONPATH_EXCLUDE (see above)
    and keeps the worker off any accelerator (JAX_PLATFORMS=cpu). Snapshot-and-edit of a private dict (the
    scaleout.py worker-spawn pattern) — never a mutation of os.environ, which
    other threads of the server process read concurrently.
    """
    env = dict(os.environ)
    parts = [
        p
        for p in env.get("PYTHONPATH", "").split(os.pathsep)
        if p and not (WORKER_PYTHONPATH_EXCLUDE and _path_has_component(p, WORKER_PYTHONPATH_EXCLUDE))
    ]
    pkg_parent = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    if pkg_parent not in parts:
        parts.insert(0, pkg_parent)
    env["PYTHONPATH"] = os.pathsep.join(parts)
    env["JAX_PLATFORMS"] = "cpu"
    return env


def _log_orphan_convert(task):
    # type: (asyncio.Task) -> None
    """Consume the outcome of a conversion roundtrip orphaned by cancellation."""
    if task.cancelled():
        return
    exc = task.exception()
    if exc is not None:
        logger.debug(f"aggregator: cancelled conversion finished with {exc!r} (benign during shutdown)")


def _reap(proc):
    # type: (subprocess.Popen) -> None
    """Close one worker: EOF its stdin (clean exit), escalate to kill."""
    with contextlib.suppress(OSError):
        proc.stdin.close()
    try:
        proc.wait(timeout=5)
    except subprocess.TimeoutExpired:  # pragma: no cover - kill escalation
        proc.kill()
        proc.wait()


class ConvertPool:
    """
    Record-conversion offload: hermetic worker subprocesses, inline fallback.

    Conversion (JSON + codec, pure Python) and indexing (add_assets) each
    sustain ~24k records/s but serialize behind the GIL when run in threads
    of one process; a worker process lets the poller pipeline convert group
    N+1 while group N indexes (benchmarks/aggregator_ingest.py). Workers
    spawn on demand from the calling worker thread — never the event loop —
    as plain subprocesses with a private env dict (``convert_worker`` frames
    over stdio). ``workers=0`` converts inline in a thread (the pre-pipeline
    behavior); any pool failure (spawn, worker death, protocol error)
    degrades to inline permanently and logs once — correctness never
    depends on the pool.
    """

    def __init__(self, workers):
        # type: (int) -> None
        self.workers = workers
        self._broken = workers <= 0
        self._lock = threading.Lock()
        self._idle = []  # type: list[subprocess.Popen]
        self._procs = []  # type: list[subprocess.Popen]

    @property
    def active(self):
        # type: () -> bool
        """Whether converts may still go through a worker process."""
        return not self._broken

    def _spawn(self):
        # type: () -> subprocess.Popen
        return subprocess.Popen(
            [sys.executable, "-m", "iscc_search_tpu.aggregator.convert_worker"],
            stdin=subprocess.PIPE,
            stdout=subprocess.PIPE,
            env=_worker_env(),
        )

    def _checkout(self):
        # type: () -> subprocess.Popen | None
        with self._lock:
            if self._idle:
                return self._idle.pop()
            if len(self._procs) < self.workers:
                proc = self._spawn()
                self._procs.append(proc)
                return proc
        return None

    def _roundtrip(self, records, skip, network):
        # type: (list[bytes], int, str) -> tuple[list[tuple], dict]
        proc = self._checkout()
        if proc is None:  # every worker busy: convert in this thread
            return convert_group(records, skip, network)
        try:
            convert_worker.write_frame(proc.stdin, (records, skip, network))
            result = convert_worker.read_frame(proc.stdout)
            if result is None:
                raise EOFError("conversion worker exited")
        except BaseException:
            with self._lock:
                if proc in self._procs:
                    self._procs.remove(proc)
            _reap(proc)
            raise
        with self._lock:
            self._idle.append(proc)
        return result

    async def convert(self, records, skip, network):
        # type: (list[bytes], int, str) -> tuple[list[tuple], dict]
        """Convert one group's records, preferring a worker process."""
        if not self._broken:
            task = asyncio.ensure_future(asyncio.to_thread(self._roundtrip, records, skip, network))
            try:
                return await asyncio.shield(task)
            except asyncio.CancelledError:
                # Caller cancelled (shutdown, or a prefetched group discarded
                # after its predecessor failed). The worker thread cannot be
                # interrupted — shield lets it finish its roundtrip in the
                # background so the checked-out subprocess returns to the idle
                # pool, and the done-callback consumes its outcome so a
                # post-close() EOFError never surfaces as an un-retrieved
                # task exception.
                task.add_done_callback(_log_orphan_convert)
                raise
            except Exception as exc:
                self._broken = True
                logger.warning(f"aggregator: conversion pool failed, converting inline from now on: {exc}")
        return await asyncio.to_thread(convert_group, records, skip, network)

    def close(self):
        # type: () -> None
        with self._lock:
            procs, self._procs, self._idle = list(self._procs), [], []
        for proc in procs:
            _reap(proc)


async def poll_hub_once(client, hub, last_size, index, index_name, network, stop_event, convert=None):
    # type: (httpx.AsyncClient, hublist.Hub, int, ..., str, str, asyncio.Event, ConvertPool | None) -> PollResult
    """
    One poll of one hub: read the checkpoint, then ingest the planned bundles
    in groups of up to GROUP_BUNDLES. With an active ``convert`` pool the
    groups run as a two-stage pipeline: while group N indexes (add_assets in
    a worker thread), group N+1 is already fetching and converting in a
    worker process, so the two Python-bound halves genuinely overlap instead
    of serializing behind the GIL. Without a pool (workers=0 / single-core
    hosts) the groups run strictly sequentially — prefetching a CPU-bound
    conversion onto the same core only adds GIL-handoff overhead (measured
    ~15% slower at 1M records on a 1-core host).

    A tree-size regression resets the cursor to 0 for re-backfill. A failing
    group (fetch, short bundle, or indexing error) ends the poll but keeps
    the cursor progress already made and surfaces the failure via
    ``PollResult.error`` (a prefetched successor group is discarded and
    re-fetched next poll — at-least-once + idempotent upserts make that safe).
    """
    tally = Counter({reason: 0 for reason in REASONS})

    checkpoint = await client.get(f"{hub.url}/log/checkpoint")
    checkpoint.raise_for_status()
    tree_size = tlog.parse_checkpoint(checkpoint.text)
    if tree_size < last_size:
        logger.warning(
            f"aggregator: {hub.url}: checkpoint regression {last_size} -> {tree_size}, re-backfilling"
        )
        return PollResult(last_size=0, counts=dict(tally))

    async def fetch(bundle, width):
        # type: (int, int) -> list[bytes]
        """Fetch + length-validate one bundle's records."""
        path = tlog.entries_path(bundle, width)
        response = await client.get(f"{hub.url}/log/{path}")
        response.raise_for_status()
        records = tlog.parse_entry_bundle(response.content)
        want = width or tlog.TILE_WIDTH
        if len(records) != want:
            raise ValueError(f"{path} has {len(records)} records, expected {want}")
        return records

    async def produce(group):
        # type: (list[tuple[int, int]]) -> tuple[list, dict]
        """Fetch (concurrently) and convert one bundle group to entries."""
        fetched = await asyncio.gather(*(fetch(bundle, width) for bundle, width in group))
        records = [record for bundle_records in fetched for record in bundle_records]
        already_done = max(last_size - group[0][0] * tlog.TILE_WIDTH, 0)
        if convert is not None:
            fields, group_tally = await convert.convert(records, already_done, network)
        else:
            fields, group_tally = await asyncio.to_thread(convert_group, records, already_done, network)
        return fields, group_tally

    cursor = last_size
    plan = plan_bundles(last_size, tree_size)
    groups = [plan[g : g + GROUP_BUNDLES] for g in range(0, len(plan), GROUP_BUNDLES)]
    next_task = None  # type: asyncio.Task | None
    try:
        for i, group in enumerate(groups):
            if stop_event.is_set():
                break
            task = next_task if next_task is not None else asyncio.ensure_future(produce(group))
            pipelined = convert is not None and convert.active
            next_task = asyncio.ensure_future(produce(groups[i + 1])) if pipelined and i + 1 < len(groups) else None
            try:
                # Tally per group and merge only after add_assets COMMITS: a
                # failed group is retried next poll, and pre-counting its
                # records would double-count the cumulative /status totals.
                fields, group_tally = await task
                # Entry rebuild happens in the SAME worker thread as the add:
                # the event loop stays free to drive the next group's fetch.
                dropped = await asyncio.to_thread(_index_fields, index, index_name, fields)
                if dropped:
                    group_tally["ok"] -= dropped
                    group_tally["malformed"] += dropped
            except Exception as exc:
                first = group[0][0]
                logger.warning(f"aggregator: {hub.url}: bundles {first}+ failed, retrying next poll: {exc}")
                return PollResult(last_size=cursor, counts=dict(tally), error=f"bundle {first} failed: {exc}")
            _log_skips(group_tally, hub.url)
            tally.update(group_tally)
            last_bundle, last_width = group[-1]
            cursor = min((last_bundle + 1) * tlog.TILE_WIDTH, tree_size)
    finally:
        if next_task is not None:
            next_task.cancel()
            with contextlib.suppress(asyncio.CancelledError, Exception):
                await next_task
    return PollResult(last_size=cursor, counts=dict(tally))


def _sync_backend(index, index_name):
    # type: (..., str) -> None
    """
    Durability barrier before persisting an advanced cursor: flush + fsync
    the backend if it exposes a sync hook, so a persisted cursor never points
    past data the store could lose on power loss (add_assets alone leaves
    the log in the OS page cache).
    """
    sync = getattr(index, "sync", None)
    if callable(sync):
        sync(index_name)


class _Roster:
    """Hub list with last-known-good semantics and timed refresh."""

    def __init__(self, opts):
        # type: (SearchOptions) -> None
        self._opts = opts
        self.hubs = []  # type: list[hublist.Hub]
        self._due = 0.0

    async def refresh(self, client, status):
        # type: (httpx.AsyncClient, dict[int, HubStatus]) -> None
        """
        Refresh when due. A failed fetch keeps the previous list and retries
        at the short poll interval; an empty list is benign idle; hubs absent
        from a NON-empty refreshed list are pruned from status (an empty
        refresh prunes nothing, so cursors survive transient hub outages).
        """
        now = time.monotonic()
        if now < self._due:
            return
        opts = self._opts
        try:
            self.hubs = await hublist.fetch_hub_list(
                opts.aggregator_hub_list_source, opts.aggregator_network, client
            )
        except Exception as exc:
            logger.warning(f"aggregator: hub-list refresh failed, keeping previous list: {exc}")
            self._due = now + opts.aggregator_poll_interval
            return
        if not self.hubs:
            logger.warning("aggregator: hub list is empty, nothing to poll")
            self._due = now + opts.aggregator_poll_interval
            return
        current = {hub.hub_id for hub in self.hubs}
        for gone in [hub_id for hub_id in status if hub_id not in current]:
            del status[gone]
        self._due = now + opts.aggregator_hub_refresh_interval


async def _poll_one_hub(client, hub, state, index, opts, stop_event, cursor_store, durable, convert=None):
    # type: (...) -> None
    """Poll one hub and fold the outcome into its mutable status row.

    ``durable`` is the persistent hub->cursor map: it keeps entries for hubs
    pruned from the live roster (a registry flap must not regress their
    saved progress) and is the exact payload written to the cursor store."""
    state.url = hub.url  # a refresh may relocate a hub
    state.last_poll = time.time()
    try:
        result = await poll_hub_once(
            client,
            hub,
            state.cursor,
            index,
            opts.aggregator_index_name,
            opts.aggregator_network,
            stop_event,
            convert=convert,
        )
    except Exception as exc:
        state.ok = False
        state.error = str(exc)
        logger.warning(f"aggregator: poll of {hub.url} failed: {exc}")
        return
    advanced = result.last_size != state.cursor
    state.cursor = result.last_size
    durable[hub.hub_id] = state.cursor
    # Build-then-assign: /status copies state.counts from another thread, and
    # inserting new reason keys into the live dict could race that copy.
    merged = dict(state.counts)
    for reason, count in result.counts.items():
        merged[reason] = merged.get(reason, 0) + count
    state.counts = merged
    state.ok = result.error is None
    state.error = result.error
    if advanced and cursor_store is not None:
        try:
            # Barrier first: only durably-stored records may move the saved cursor.
            await asyncio.to_thread(_sync_backend, index, opts.aggregator_index_name)
            await asyncio.to_thread(cursor_store.save, dict(durable))
        except Exception as exc:
            # A failed barrier/save must not kill the poll loop: the in-memory
            # cursor stays ahead, the persisted one stays behind — safe with
            # idempotent upserts (restart re-backfills the gap). Retry next poll.
            logger.warning(f"aggregator: cursor persistence failed for {hub.url}: {exc}")
    if result.counts["ok"]:
        logger.info(
            f"aggregator: {hub.url}: indexed {result.counts['ok']} records, cursor {result.last_size}"
        )


async def poll_loop(index, opts, stop_event, client, status, cursor_store=None):
    # type: (..., SearchOptions, asyncio.Event, httpx.AsyncClient, dict[int, HubStatus], ...) -> None
    """
    Refresh the hub roster and poll every hub until stopped.

    With a durable backend, cursors seed from and persist to ``cursor_store``
    so restarts resume from the last ingested bundle; without one the loop
    re-backfills from leaf 0 like the reference (idempotent upserts make
    both safe).
    """
    durable = cursor_store.load() if cursor_store is not None else {}
    roster = _Roster(opts)
    convert = ConvertPool(opts.aggregator_convert_workers)
    try:
        while not stop_event.is_set():
            await roster.refresh(client, status)
            for hub in roster.hubs:
                if stop_event.is_set():
                    break
                state = status.get(hub.hub_id)
                if state is None:
                    # Seed from the LIVE durable map (not a process-start
                    # snapshot): a hub pruned by a roster flap and re-added must
                    # resume from its latest saved cursor, not an old one.
                    state = status[hub.hub_id] = HubStatus(
                        hub_id=hub.hub_id, url=hub.url, cursor=durable.get(hub.hub_id, 0)
                    )
                await _poll_one_hub(
                    client, hub, state, index, opts, stop_event, cursor_store, durable, convert=convert
                )
            try:
                await asyncio.wait_for(stop_event.wait(), timeout=opts.aggregator_poll_interval)
            except (TimeoutError, asyncio.TimeoutError):
                pass
    finally:
        convert.close()


async def run(index, opts, stop_event, status):
    # type: (..., SearchOptions, asyncio.Event, dict[int, HubStatus]) -> None
    """Poller entry point owning the HTTP client."""
    from iscc_search_tpu.aggregator.cursors import cursor_store_for

    cursor_store = cursor_store_for(opts)
    async with httpx.AsyncClient(timeout=HTTP_TIMEOUT, follow_redirects=True) as client:
        await poll_loop(index, opts, stop_event, client, status, cursor_store=cursor_store)
