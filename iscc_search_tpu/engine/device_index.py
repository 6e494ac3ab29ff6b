"""
Device-resident packed-code indexes — the accelerator replacement for the
reference's HNSW engine (iscc-usearch ShardedNphdIndex / ShardedIndex128,
SURVEY §2.2).

Design (exhaustive scan, not a graph translation):

- Codes live as a bit-packed ``(N, 8) uint32`` lane matrix. Index *build* is
  streaming pack-and-append (no graph construction), so ingest throughput is
  memcpy-bound instead of HNSW-insert-bound.
- *Search* is an exhaustive scan via the ±1 matmul identity
  (:mod:`iscc_search_tpu.ops.pm1_scan`) with exact two-phase block-max
  top-k over the packed rows, left to XLA — giving exact results (recall
  1.0); the reference's expansion/connectivity quality knobs become
  unnecessary.
- *Mutability*: updates tombstone the old row and append a new one (mirrors
  the remove-before-add semantics at reference usearch/index.py:417-445);
  a validity bitmap masks tombstones inside the kernel. Compaction reclaims
  space once tombstones dominate.
- *Persistence*: sealed immutable segments at ``shard_size`` bytes plus a
  rewritable active segment and a global validity bitmap, each written
  atomically (tmp + fsync + rename), mirroring the reference's bounded
  crash-loss model (flush_interval + shard rotation, SURVEY §5). ``dirty``
  counts unsaved key mutations like the upstream engine. Saves snapshot the
  arrays under the lock and write on a background worker (the reference's
  background shard rotation, CHANGELOG 0.2.2: no multi-second ingest stalls
  at flush boundaries); queued snapshots coalesce so at most one write is
  pending behind the one in flight, and ``drain_rotations()``/``close()``
  join the worker.

Keys are fixed-width byte strings: 8 bytes (uint64 ISCC-ID body) for the NPHD
index, 16 bytes (iscc_id_body + offset + size) for the simprint index.
"""

from __future__ import annotations

import itertools
import json
import math
import os
import tempfile
import threading
from pathlib import Path

import numpy as np

from iscc_search_tpu.ops.packing import MAX_LANES, pack_codes, unpack_code
from iscc_search_tpu.utils import get_logger

logger = get_logger(__name__)

_MIN_DEVICE_ROWS = 8192  # device partition capacity floor
_DEFAULT_CHUNK_ROWS = 32768  # top-k scan chunk size (rows per matmul tile)


def _pow2ceil(n):
    # type: (int) -> int
    p = 1
    while p < n:
        p <<= 1
    return p


_CAP_QUANTUM = 65536  # single-device partition capacity granularity

# Row-space generations are unique ACROSS instances (not per-instance
# counters): a rebuild that swaps in a fresh index must also invalidate row
# ids captured against the old object, not just compactions of the same one.
_ROW_GEN_COUNTER = itertools.count(1)


def _cap_rows(n):
    # type: (int) -> int
    """Single-device partition capacity for ``n`` rows.

    Small partitions keep the pow2 sizing; large ones round 12.5% headroom up
    to a 65536 multiple instead of the next power of two — pow2ceil doubled
    the scan work of a 4.2M-row partition (cap 8.4M), and with four mixed
    length partitions (BASELINE config 3) the padding alone cost ~1.7x the
    live rows. 65536 keeps every divisibility the scan needs: the 32768
    scan chunk and the 128-row block."""
    if n <= _CAP_QUANTUM:
        return max(_MIN_DEVICE_ROWS, _pow2ceil(n))
    return -(-(n + n // 8) // _CAP_QUANTUM) * _CAP_QUANTUM


def _mesh_size(mesh):
    # type: (...) -> int
    return int(np.prod(list(mesh.shape.values())))


class _Partition:
    """Device mirror of one code-length partition."""

    __slots__ = ("packed_dev", "valid_dev", "row_map", "cap", "count")

    def __init__(self, packed_dev, valid_dev, row_map, cap, count):
        self.packed_dev = packed_dev
        self.valid_dev = valid_dev
        self.row_map = row_map  # (cap,) int32 global row per device row (junk rows -> 0, invalid)
        self.cap = cap
        self.count = count  # real rows uploaded


_FUSED_SCAN = None


def _fused_scan_fn():
    """ONE jitted program scanning every length partition back-to-back.

    Tracing all partitions into a single program makes the whole
    variable-length sweep one dispatch + one readback instead of one program
    chain per partition; XLA schedules the partition scans back-to-back on
    the device. Static cache key: the spec tuple (nbits, k, chunk,
    recall_target) per partition plus the buffer shapes/treedef jit already
    keys on. ``recall_target`` None selects the exact two-phase block-max
    scan, a float the recall-targeted per-chunk top-k.
    """
    global _FUSED_SCAN
    if _FUSED_SCAN is None:
        import jax

        from iscc_search_tpu.ops.pm1_scan import (
            pm1_blockmax_topk_packedq_impl,
            pm1_topk_packedq_impl,
        )

        def run(q_codes, q_lanes, buffers, specs):
            outs = []
            for (nbits, k, chunk, recall), (packed, valid) in zip(specs, buffers):
                if recall is None:
                    outs.append(pm1_blockmax_topk_packedq_impl(
                        q_codes, q_lanes, packed, valid, k, nbits, chunk_size=chunk
                    ))
                else:
                    outs.append(pm1_topk_packedq_impl(
                        q_codes, q_lanes, packed, valid, k, nbits, chunk_size=chunk, recall_target=recall
                    ))
            return tuple(outs)

        _FUSED_SCAN = jax.jit(run, static_argnames=("specs",))
    return _FUSED_SCAN


def _device_append(buf, new, start):
    # type: (...) -> ...
    """
    Functional device append (device-side copy, NO donation): a concurrent
    search snapshot may still reference the old buffer, and donation would
    invalidate it mid-flight. The copy runs at device-memory speed (~ms for 10M rows).
    """
    import jax

    if not hasattr(_device_append, "_fn"):
        _device_append._fn = jax.jit(lambda b, n, s: jax.lax.dynamic_update_slice(b, n, (s, 0)))
    return _device_append._fn(buf, new, start)


def _fsync_dir(path):
    # type: (Path) -> None
    dfd = os.open(str(path), os.O_RDONLY)
    try:
        os.fsync(dfd)
    finally:
        os.close(dfd)


def _atomic_write(path, data, sync_dir=True):
    # type: (Path, bytes, bool) -> None
    """Write bytes durably: temp file + fsync + rename + DIRECTORY fsync.

    Without the directory fsync the rename itself is neither durable nor
    ordered across power loss — a later rename (the manifest) could survive
    while an earlier one (a segment) is lost, leaving the manifest
    referencing a missing file. Batch writers pass sync_dir=False per file
    and issue ONE directory fsync before the manifest instead (the required
    ordering is only data-renames-durable-before-manifest-rename)."""
    fd, tmp = tempfile.mkstemp(dir=str(path.parent), prefix=path.name, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as fh:
            fh.write(data)
            fh.flush()
            os.fsync(fh.fileno())
        os.replace(tmp, path)
        if sync_dir:
            _fsync_dir(path.parent)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def _npz_bytes(**arrays):
    # type: (...) -> bytes
    import io

    buf = io.BytesIO()
    np.savez(buf, **arrays)
    return buf.getvalue()


class PackedCodeIndex:
    """
    Shared core: packed host arrays + device mirror + segment persistence.

    Subclasses fix the metric ("nphd" or "hamming") and key width.
    """

    metric = "nphd"
    key_bytes = 8

    @property
    def ROW_BYTES(self):
        # type: () -> int
        """Per-row storage estimate for shard sizing: key + lanes + nlanes + valid.

        Derived from key_bytes — DeviceHammingIndex rows carry 16-byte
        composite keys, not 8."""
        return self.key_bytes + MAX_LANES * 4 + 4 + 1

    def __init__(
        self,
        path,
        max_dim=256,
        shard_size=512 * 1024 * 1024,
        ndim=None,
        recall_target=None,
        mesh=None,
    ):
        # type: (str | Path, int, int, int | None, float | None, ...) -> None
        """
        Create or open a packed-code index directory.

        :param path: Segment directory (created on demand)
        :param max_dim: Maximum code width in bits (NPHD variable-length cap)
        :param shard_size: Seal an immutable segment after this many bytes
        :param ndim: Fixed code width in bits for the hamming metric
        :param recall_target: None = exact two-phase block-max scan; float
            in (0,1) = per-chunk ``lax.approx_max_k`` with that recall
        :param mesh: optional jax.sharding.Mesh — partitions row-shard over
            its single axis and searches run the sharded scan with an
            all-gather top-k merge (multi-chip capacity scaling)
        """
        self.path = Path(path)
        self.max_dim = max_dim
        self.ndim = ndim
        self.max_lanes = MAX_LANES
        self.shard_rows = max(1024, shard_size // self.ROW_BYTES)
        self.recall_target = recall_target if (recall_target is None or recall_target < 1.0) else None
        # Scan chunk rows (rows per matmul tile); a chunk that does not
        # divide a partition's capacity shrinks to their gcd at search time.
        self.chunk_rows = _DEFAULT_CHUNK_ROWS
        self.mesh = mesh if mesh is not None and _mesh_size(mesh) > 1 else None
        # Multi-host SPMD hook (parallel/service.py): set on the coordinator's
        # indexes to fan device-relevant ops out to follower processes; None
        # everywhere else (single-process) and on follower replicas.
        self.control_hook = None
        # Followers never persist — the coordinator's directory is the truth.
        self.save_enabled = True
        self._lock = threading.RLock()

        cap = _MIN_DEVICE_ROWS
        self._keys = np.zeros((cap, self.key_bytes), dtype=np.uint8)
        self._codes = np.zeros((cap, self.max_lanes), dtype=np.uint32)
        self._nlanes = np.zeros((cap,), dtype=np.int32)
        self._valid = np.zeros((cap,), dtype=bool)
        self._rows = 0  # appended rows (including tombstoned)
        # Row-space generation: bumped whenever existing row ids are
        # renumbered or dropped (_compact_locked/_load/reset). Rows are
        # otherwise append-only, so a matching generation proves a captured
        # row id still names the same key.
        self._row_gen = next(_ROW_GEN_COUNTER)
        self._key_to_row = {}  # type: dict[bytes, int] | None  # None = lazy (built by _keymap)
        self._live = 0  # live (non-tombstoned) key count; size/search need no map
        self.dirty = 0  # unsaved key mutations since last save
        self._segments = []  # type: list[dict]  # {"file", "start", "rows"} sealed on disk
        # Device mirror: rows partitioned by code length (lane count) so the
        # NPHD prefix scale is a per-query broadcast inside each partition
        # (see ops/pm1_scan.py). {lanes: _Partition}
        self._partitions = None  # type: dict[int, tuple] | None
        self._device_stale = True
        # Incremental sync bookkeeping: host rows already mirrored on device
        # and whether tombstones changed since the last sync.
        self._synced_rows = 0
        self._valid_dirty = False
        self._closed = False
        # Background save worker: latest snapshot pending (coalesced) + the
        # one in flight; drain_rotations()/close() join both.
        self._save_cv = threading.Condition()
        self._save_queue = None  # type: dict | None
        self._save_inflight = False
        self._save_stop = False
        self._save_thread = None  # type: threading.Thread | None
        self._written_seq = 0  # highest snapshot seq successfully on disk
        self._resave_all = False  # a failed write must re-emit sealed files
        # Sealed segments not yet confirmed written (queued snapshots can be
        # coalesced away; their seals must ride the NEXT snapshot instead).
        self._unconfirmed_seals = set()  # type: set[str]
        # Monotonic counters: every snapshot gets a sequence number (older
        # snapshots must never replace newer ones in the coalescing queue)
        # and every emitted data file gets a unique name (the old manifest
        # keeps referencing the OLD files until the new manifest commits).
        self._save_seq = 0
        self._file_seq = 0
        # Files no manifest-to-be references anymore; unlinked by the save
        # worker only AFTER a newer manifest commits (never eagerly — the
        # on-disk manifest may still reference them).
        self._pending_deletes = set()  # type: set[str]

        if (self.path / "state.json").exists():
            self._load()

    # -- public API (parity surface with ShardedNphdIndex/ShardedIndex128) ---

    def __len__(self):
        # type: () -> int
        return self._live

    @property
    def size(self):
        # type: () -> int
        """Number of live (non-tombstoned) keys."""
        return self._live

    def __contains__(self, key):
        # type: (bytes | int) -> bool
        return self._key(key) in self._keymap

    @property
    def _keymap(self):
        # type: () -> dict[bytes, int]
        """
        key -> row map, built lazily after a snapshot load.

        Opening a 10M snapshot spent ~10 s in the eager build loop, yet a
        restarted *serving* process only searches — which never consults the
        map (``_live`` answers the emptiness/size questions). Mutation paths
        (add/remove/get/contains) pay the one-time build on first use.
        """
        km = self._key_to_row
        if km is None:
            with self._lock:
                km = self._key_to_row
                if km is None:
                    rows = self._rows
                    width = self.key_bytes
                    buf = self._keys[:rows].tobytes()
                    km = {}
                    for i in np.flatnonzero(self._valid[:rows]).tolist():
                        off = i * width
                        km[buf[off : off + width]] = i
                    self._key_to_row = km
        return km

    @property
    def shard_count(self):
        # type: () -> int
        active_rows = self._rows - (self._segments[-1]["start"] + self._segments[-1]["rows"] if self._segments else 0)
        return len(self._segments) + (1 if active_rows > 0 or not self._segments else 0)

    @property
    def serialized_length(self):
        # type: () -> int
        """Estimated serialized bytes of live state (monitoring)."""
        return self._rows * self.ROW_BYTES

    @property
    def tombstone_fraction(self):
        # type: () -> float
        if self._rows == 0:
            return 0.0
        return 1.0 - self._live / self._rows

    def add(self, keys, vectors):
        # type: (list, list[bytes]) -> None
        """
        Append codes; an existing key is updated (old row tombstoned).

        :param keys: row keys (int for 8-byte indexes, bytes otherwise)
        :param vectors: code bodies (bytes, multiples of 4 bytes)
        """
        if not keys:
            return
        if self.control_hook is not None:
            # Mirror the EXACT engine-level call on every cluster process so
            # replicas append identical rows in identical order (bytes are
            # pickle-friendly; ndarray vectors normalize to bytes first).
            vectors = [self._vector_bytes(v) for v in vectors]
            return self.control_hook("add", (list(keys), vectors), lambda: self._add_impl(keys, vectors))
        return self._add_impl(keys, vectors)

    def _add_impl(self, keys, vectors):
        # type: (list, list[bytes]) -> None
        with self._lock:
            kbs = [self._key(k) for k in keys]
            packed, nlanes = pack_codes([self._vector_bytes(v) for v in vectors], self.max_lanes)
            n = len(kbs)
            self._ensure_capacity(self._rows + n)
            start = self._rows
            keymap = self._keymap
            batch_dup_rows = []  # rows within THIS batch superseded by a later duplicate key
            for i, kb in enumerate(kbs):
                old = keymap.get(kb)
                if old is None:
                    self._live += 1
                else:
                    self._valid[old] = False
                    self._valid_dirty = True  # tombstone must reach the device mirror
                    if old >= start:
                        # Intra-batch duplicate: the blanket validity assignment
                        # below would resurrect this row — re-tombstone it after.
                        batch_dup_rows.append(old)
                row = start + i
                self._keys[row] = np.frombuffer(kb, dtype=np.uint8)
                keymap[kb] = row
            self._codes[start : start + n] = packed
            self._nlanes[start : start + n] = nlanes
            self._valid[start : start + n] = True
            for row in batch_dup_rows:
                self._valid[row] = False
            self._rows += n
            self.dirty += n
            self._device_stale = True

    def add_packed(self, keys, packed, nlanes):
        # type: (np.ndarray, np.ndarray, np.ndarray | int) -> None
        """
        Vectorized bulk append of pre-packed rows (the bulk-ingest fast path).

        The per-item ``add()`` loop (key normalization + dict upsert per row)
        dominates bulk builds — ~28K rows/s at SIMPRINT scale, an hour for
        the 100M-chunk BASELINE config 4. This path appends whole arrays.

        CONTRACT: ``keys`` must be unique within the batch AND not already
        present in the index — the dedup/update semantics of ``add()`` are
        skipped (a violated contract leaves duplicate live rows, exactly as
        documented for the reference's raw batch loaders,
        /root/reference/iscc_search/indexes/simprint/usearch_core.py:85-108
        — its in-batch dedup also trusts the store for cross-batch keys).
        Rebuild-from-truth and bulk benchmark loaders satisfy this by
        construction.

        :param keys: (n, key_bytes) uint8 key matrix
        :param packed: (n, L) uint32 packed codes, L <= max_lanes
        :param nlanes: (n,) int32 lane counts, or a scalar applied to all rows
        """
        keys = np.ascontiguousarray(keys, dtype=np.uint8)
        packed = np.ascontiguousarray(packed, dtype=np.uint32)
        n = keys.shape[0]
        if n == 0:
            return
        if keys.ndim != 2 or keys.shape[1] != self.key_bytes:
            raise ValueError(f"keys must be (n, {self.key_bytes}) uint8, got {keys.shape}")
        if packed.shape[0] != n or packed.ndim != 2 or packed.shape[1] > self.max_lanes:
            raise ValueError(f"packed must be (n, <= {self.max_lanes}) uint32, got {packed.shape}")
        if np.isscalar(nlanes) or getattr(nlanes, "ndim", 1) == 0:
            nlanes = np.full(n, int(nlanes), np.int32)
        else:
            nlanes = np.ascontiguousarray(nlanes, dtype=np.int32)
            if nlanes.shape != (n,):
                raise ValueError(f"nlanes must be (n,), got {nlanes.shape}")
        # Bound by the PROVIDED width, not just max_lanes: a row claiming
        # more lanes than packed carries would silently treat the zero-filled
        # trailing lanes as real code bits (corrupt stored body + wrong NPHD
        # scores) instead of raising.
        if int(nlanes.max(initial=0)) > packed.shape[1] or int(nlanes.min(initial=1)) < 1:
            raise ValueError("nlanes out of range")
        if self.control_hook is not None:
            return self.control_hook(
                "add_packed", (keys, packed, nlanes), lambda: self._add_packed_impl(keys, packed, nlanes)
            )
        return self._add_packed_impl(keys, packed, nlanes)

    def _add_packed_impl(self, keys, packed, nlanes):
        # type: (np.ndarray, np.ndarray, np.ndarray) -> None
        n = keys.shape[0]
        with self._lock:
            self._ensure_capacity(self._rows + n)
            start = self._rows
            self._keys[start : start + n] = keys
            self._codes[start : start + n, : packed.shape[1]] = packed
            if packed.shape[1] < self.max_lanes:
                self._codes[start : start + n, packed.shape[1] :] = 0
            self._nlanes[start : start + n] = nlanes
            self._valid[start : start + n] = True
            km = self._key_to_row
            if km is not None:
                # Keep the materialized map coherent (mutation paths rely on
                # it); when it is still lazy (None) the bulk rows ride the
                # one-time rebuild instead — the common bulk-load case.
                width = self.key_bytes
                buf = keys.tobytes()
                for i in range(n):
                    km[buf[i * width : (i + 1) * width]] = start + i
            self._rows += n
            self._live += n
            self.dirty += n
            self._device_stale = True

    def remove(self, keys):
        # type: (list) -> int
        """Tombstone keys; returns the number of keys actually removed."""
        if self.control_hook is not None:
            return self.control_hook("remove", (list(keys),), lambda: self._remove_impl(keys))
        return self._remove_impl(keys)

    def _remove_impl(self, keys):
        # type: (list) -> int
        removed = 0
        with self._lock:
            keymap = self._keymap
            for k in keys:
                kb = self._key(k)
                row = keymap.pop(kb, None)
                if row is not None:
                    self._valid[row] = False
                    self._live -= 1
                    removed += 1
                    self.dirty += 1
            if removed:
                self._device_stale = True
                self._valid_dirty = True
        return removed

    def get(self, key):
        # type: (bytes | int) -> bytes | None
        """Stored code body for a key, or None."""
        with self._lock:
            row = self._keymap.get(self._key(key))
            if row is None:
                return None
            return unpack_code(self._codes[row], int(self._nlanes[row]))

    @property
    def row_generation(self):
        # type: () -> int
        """Current row-space generation (see :meth:`body_at`). Capture it
        BEFORE a ``search(return_rows=True)`` sweep; any compact/reload/reset
        between the capture and the ``body_at`` reads bumps it, so a mismatch
        proves the captured row ids are stale."""
        with self._lock:
            return self._row_gen

    def body_at(self, row, gen=None):
        # type: (int, int | None) -> bytes | None
        """Stored code body at a ROW returned by ``search(return_rows=True)``,
        or None when the row no longer exists (a rebuild/reset raced the
        search snapshot — callers keep the query bytes as fallback, matching
        the historical get()-miss behavior).

        :param gen: row-space generation captured via :attr:`row_generation`
            before the search that produced ``row``. A compact() racing the
            search renumbers the row space — an in-range stale row would
            silently return a DIFFERENT key's body; the generation check
            (atomic with the read, both under the lock) turns that into the
            safe None fallback.

        O(1) array access — unlike :meth:`get`, this never materializes the
        key->row map (a 100M-row map costs ~15 GB host RAM and minutes to
        build; per-candidate ``get`` calls in the simprint scoring loop were
        the host-side ping-pong SURVEY §7 warns about)."""
        with self._lock:
            if gen is not None and gen != self._row_gen:
                return None
            if row < 0 or row >= self._rows or self._nlanes[row] <= 0:
                return None
            return unpack_code(self._codes[row], int(self._nlanes[row]))

    def search(self, query_bodies, count, return_rows=False):
        # type: (list[bytes], int, bool) -> list[tuple]
        """
        Top-``count`` scan for a batch of queries (exact unless a
        recall_target was configured).

        Each length partition is scanned with the ±1 matmul kernel; per-query
        candidates from all partitions merge on the host (<= 4 partitions x k
        candidates each).

        :param query_bodies: query code bodies
        :param count: results per query
        :param return_rows: also return each candidate's host row id (for
            O(1) ``body_at`` lookups in scoring loops)
        :return: per query a (keys (m, key_bytes) uint8 array, scores (m,)
            float32 array) pair — plus a rows (m,) int array when
            ``return_rows`` — sorted by score descending; m <= count
        """
        if not query_bodies or self._rows == 0 or self._live == 0:
            empty = [
                (np.zeros((0, self.key_bytes), np.uint8), np.zeros(0, np.float32), np.zeros(0, np.int64))
                for _ in query_bodies
            ]
            return empty if return_rows else [e[:2] for e in empty]
        if self.control_hook is not None:
            bodies = [self._vector_bytes(b) for b in query_bodies]
            return self.control_hook(
                "search", (bodies, count), lambda: self._search_impl(bodies, count, return_rows)
            )
        return self._search_impl(query_bodies, count, return_rows)

    def _search_impl(self, query_bodies, count, return_rows=False):
        # type: (list[bytes], int, bool) -> list[tuple]
        import jax.numpy as jnp

        with self._lock:
            synced = self._sync_device()
            # Snapshot partition buffers under the lock: a concurrent sync may
            # rebind partition attributes, and a consistent (buffer, validity,
            # row_map) triple must be used per partition.
            partitions = {
                lanes: (p.packed_dev, p.valid_dev, p.row_map, p.cap) for lanes, p in synced.items()
            }
            # Reference snapshot is race-safe: rows are append-only (keys of
            # existing rows never mutate; capacity growth rebinds self._keys
            # to a new array, leaving this reference intact).
            keys_snapshot = self._keys[: self._rows]

        q_codes, q_lanes = pack_codes([self._vector_bytes(b) for b in query_bodies], self.max_lanes)
        nq = len(query_bodies)
        q_pad = max(8, _pow2ceil(nq))
        if q_pad > nq:
            q_codes = np.pad(q_codes, ((0, q_pad - nq), (0, 0)))
            q_lanes = np.pad(q_lanes, (0, q_pad - nq), constant_values=1)
        # One upload of the 32 B/query packed codes; per-partition unpack +
        # prefix-mask + scale run on device (prepare_queries_device) instead
        # of shipping a host-built (Q, nbits) float matrix per partition.
        q_codes_dev = jnp.asarray(q_codes)
        q_lanes_dev = jnp.asarray(q_lanes)

        # Scan every partition. Single device: ALL partitions trace into ONE
        # jitted program (one dispatch + one readback for the whole
        # variable-length sweep — see _fused_scan_fn). Mesh: per-partition
        # sharded dispatches, still issued asynchronously before collecting.
        pending = []  # type: list[tuple[np.ndarray, object, object]]
        if self.mesh is None:
            buffers, specs, row_maps = self._fused_scan_inputs(partitions, count)
            outs = _fused_scan_fn()(q_codes_dev, q_lanes_dev, buffers, specs)
            pending = [(rm, s, i) for rm, (s, i) in zip(row_maps, outs)]
            return self._collect_results(
                pending, nq, count, keys_snapshot, return_rows
            )

        from iscc_search_tpu.ops.pm1_scan import prepare_queries_device
        from iscc_search_tpu.parallel.pm1_sharded import sharded_pm1_topk

        n_shards = _mesh_size(self.mesh)
        for lanes, (packed_dev, valid_dev, row_map, cap) in partitions.items():
            nbits = lanes * 32
            k, chunk = self._scan_k_chunk(count, cap // n_shards)
            # Mesh merges gather n_shards * k candidates; a count above the
            # per-shard k needs a WIDER global top-k or rows that exist
            # across shards are silently dropped from the merged result.
            merge_k = min(_pow2ceil(max(1, count)), k * n_shards)
            # Mesh paths take prepared queries (replicated); prep runs as
            # its own device program.
            q_pm1, q_scale = prepare_queries_device(q_codes_dev, q_lanes_dev, nbits)
            scores, idx = sharded_pm1_topk(
                self.mesh,
                q_pm1,
                q_scale,
                packed_dev,
                valid_dev,
                k,
                nbits,
                chunk_size=chunk,
                recall_target=self.recall_target,
                merge_k=merge_k,
            )
            pending.append((row_map, scores, idx))
        return self._collect_results(pending, nq, count, keys_snapshot, return_rows)

    def _fused_scan_inputs(self, partitions, count):
        # type: (dict, int) -> tuple[tuple, tuple, list]
        """(buffers, specs, row_maps) of the single-device fused scan over
        ``partitions`` ({lanes: (packed_dev, valid_dev, row_map, cap)}), in
        lane order — the arguments :func:`_fused_scan_fn` takes after the
        queries, so a caller can also lower and inspect the program."""
        buffers, specs, row_maps = [], [], []
        for lanes in sorted(partitions):
            packed_dev, valid_dev, row_map, cap = partitions[lanes]
            k, chunk = self._scan_k_chunk(count, cap)
            specs.append((lanes * 32, k, chunk, self.recall_target))
            buffers.append((packed_dev, valid_dev))
            row_maps.append(row_map)
        return tuple(buffers), tuple(specs), row_maps

    def _scan_k_chunk(self, count, rows):
        # type: (int, int) -> tuple[int, int]
        """(k, chunk) of the scan over ``rows`` device rows (one partition,
        or one shard of it) for a ``count``-result search.

        k buckets to a power of two so user-supplied limits don't each
        trigger a fresh compile (results trim to ``count`` on the host). The
        chunk must divide ``rows``: the configured chunk shrinks to their gcd
        when it does not. A k past the chunk grows the chunk so the per-chunk
        top-k can hold k candidates; a grown chunk that no longer divides the
        (65536-quantized) capacity scans the whole partition as one chunk —
        k == all rows is then still exact."""
        chunk = min(rows, self.chunk_rows)
        if rows % chunk:
            chunk = math.gcd(rows, chunk)
        k = _pow2ceil(max(1, count))
        if k > chunk:
            chunk = min(rows, k)
            if rows % chunk:
                chunk = rows
            k = min(k, chunk)
        return k, chunk

    def _collect_results(self, pending, nq, count, keys_snapshot, return_rows):
        # type: (list, int, int, np.ndarray, bool) -> list[tuple]
        """Read back every partition's (scores, idx), map device rows to
        global rows, and merge the per-query candidates on the host."""
        # Start every device->host copy before blocking on any of them: the
        # transfers overlap each other and the tail of the device work, so the
        # whole collect pays ONE link round-trip instead of 2 x partitions
        # serial ones (dominant when the device link has fixed latency).
        # Every pending entry comes out of a jitted program (_fused_scan_fn or
        # the sharded mesh ops), so these are always jax Arrays and the async
        # copy API is part of their contract — no hasattr guard needed.
        for _, scores_dev, idx_dev in pending:
            scores_dev.copy_to_host_async()
            idx_dev.copy_to_host_async()

        cand_scores = [[] for _ in range(nq)]  # type: list[list[np.ndarray]]
        cand_rows = [[] for _ in range(nq)]  # type: list[list[np.ndarray]]
        for row_map, scores_dev, idx_dev in pending:
            scores = np.asarray(scores_dev)[:nq, :count]
            idx = np.asarray(idx_dev)[:nq, :count]
            for qi in range(nq):
                sel = idx[qi] >= 0
                cand_scores[qi].append(scores[qi][sel])
                cand_rows[qi].append(row_map[idx[qi][sel]])

        results = []
        for qi in range(nq):
            if not cand_scores[qi]:  # pragma: no cover - every live partition appends per query
                empty = (np.zeros((0, self.key_bytes), np.uint8), np.zeros(0, np.float32), np.zeros(0, np.int64))
                results.append(empty if return_rows else empty[:2])
                continue
            s = np.concatenate(cand_scores[qi])
            r = np.concatenate(cand_rows[qi])
            order = np.argsort(-s, kind="stable")[:count]
            rr = r[order]
            if return_rows:
                results.append((keys_snapshot[rr], s[order].astype(np.float32), rr))
            else:
                results.append((keys_snapshot[rr], s[order].astype(np.float32)))
        return results

    def save(self, wait=True):
        # type: (bool) -> None
        """
        Persist sealed segments (write-once), the active segment, the validity
        bitmap, and the state manifest. Atomic per file; the manifest rename is
        the commit point. Compacts first when tombstones dominate.

        The arrays are snapshotted under the lock (a memcpy) and written by a
        background worker, so concurrent ``add``/``search`` never stall on
        file I/O. ``wait=False`` returns after scheduling; queued snapshots
        coalesce (a newer snapshot's manifest supersedes an older one), so at
        most one write queues behind the one in flight.
        """
        if not self.save_enabled:
            return
        with self._lock:
            if self.tombstone_fraction > 0.5 and self._rows > _MIN_DEVICE_ROWS:
                self._compact_locked()
            snapshot = self._snapshot_locked()
            self.dirty = 0
        self._enqueue_save(snapshot, wait=wait)

    def _snapshot_locked(self):
        # type: () -> dict
        """Copy everything one save needs; caller holds the lock.

        Every sealed segment whose write has not been CONFIRMED on disk is
        (re-)included: a queued snapshot may be superseded by a newer one
        before the worker writes it (coalescing), and a manifest must never
        reference a seg file that only a dropped or failed snapshot carried.
        """
        writes = []  # (descriptor, keys, codes, nlanes) per segment file
        emitted = set()
        sealed_rows = self._segments[-1]["start"] + self._segments[-1]["rows"] if self._segments else 0
        if self._resave_all:
            # A previous write failed after sealing in memory: re-emit every
            # sealed file so the next manifest never references a missing one.
            for seg in self._segments:
                writes.append(self._segment_snapshot(seg))
                emitted.add(seg["file"])
            self._resave_all = False
        else:
            # emitted is empty on this branch and segment files are unique,
            # so membership in _unconfirmed_seals alone decides re-emission.
            for seg in self._segments:
                if seg["file"] in self._unconfirmed_seals:
                    writes.append(self._segment_snapshot(seg))
                    emitted.add(seg["file"])
        while self._rows - sealed_rows >= self.shard_rows:
            self._file_seq += 1
            seg = {
                "file": f"seg-{self._file_seq:08d}.npz",  # unique, never reused
                "start": sealed_rows,
                "rows": self.shard_rows,
            }
            self._segments.append(seg)
            writes.append(self._segment_snapshot(seg))
            emitted.add(seg["file"])
            sealed_rows += self.shard_rows
        self._unconfirmed_seals.update(emitted)
        # Fresh names for the rewritable files on EVERY save: overwriting
        # active.npz/valid.npy in place would invalidate the data the
        # still-committed OLD manifest references — a crash between the data
        # write and the manifest rename must leave the old state loadable.
        self._save_seq += 1
        seq = self._save_seq
        active = {"file": f"active-{seq:08d}.npz", "start": sealed_rows, "rows": self._rows - sealed_rows}
        valid_file = f"valid-{seq:08d}.npz"
        writes.append(self._segment_snapshot(active))
        state = {
            "rows": self._rows,
            "max_dim": self.max_dim,
            "ndim": self.ndim,
            "key_bytes": self.key_bytes,
            "segments": list(self._segments),
            "active": active,
            "valid_file": valid_file,
            "save_seq": seq,
            "file_seq": self._file_seq,
        }
        # Previous active/valid files are unreferenced once THIS manifest
        # commits; queue them for post-commit deletion (the worker unlinks
        # only after the rename, and a superseding snapshot inherits them).
        self._pending_deletes.add(f"active-{seq - 1:08d}.npz")
        self._pending_deletes.add(f"valid-{seq - 1:08d}.npz")
        self._pending_deletes.update({"active.npz", "valid.npy"})  # legacy fixed names
        self._pending_deletes.discard(active["file"])
        self._pending_deletes.discard(valid_file)
        return {
            "seq": seq,
            "writes": writes,
            "valid": self._valid[: self._rows].copy(),
            "valid_file": valid_file,
            "state": state,
            "sealed_files": sorted(emitted),
            "delete_after": sorted(self._pending_deletes),
        }

    def _segment_snapshot(self, seg):
        # type: (dict) -> tuple
        s, n = seg["start"], seg["rows"]
        return (
            seg,
            self._keys[s : s + n].copy(),
            self._codes[s : s + n].copy(),
            self._nlanes[s : s + n].copy(),
        )

    def _enqueue_save(self, snapshot, wait):
        # type: (dict, bool) -> None
        with self._save_cv:
            if self._save_thread is None or not self._save_thread.is_alive():
                self._save_stop = False
                self._save_thread = threading.Thread(
                    target=self._save_worker, name=f"save-{self.path.name}", daemon=True
                )
                self._save_thread.start()
            # Coalesce by SEQUENCE: an older snapshot (taken before, enqueued
            # after — snapshot and enqueue are not atomic) must never replace
            # a newer one in the queue, NOR be written after a newer one that
            # the worker already dequeued/committed (the written-seq
            # watermark): snapshots are full-state, so newer subsumes older.
            if snapshot["seq"] > self._written_seq and (
                self._save_queue is None or snapshot["seq"] > self._save_queue["seq"]
            ):
                self._save_queue = snapshot
            self._save_cv.notify_all()
            if wait:
                # wait_for keeps the retest-after-wakeup loop in threading.py
                # (a hand-written while compiles an extra loop-bottom test
                # copy that only a spurious wakeup could exercise).
                self._save_cv.wait_for(lambda: self._save_queue is None and not self._save_inflight)

    def _save_worker(self):
        # type: () -> None
        while True:
            with self._save_cv:
                self._save_cv.wait_for(lambda: self._save_queue is not None or self._save_stop)
                if self._save_queue is None:
                    return
                snapshot = self._save_queue
                self._save_queue = None
                if snapshot["seq"] <= self._written_seq:  # pragma: no cover - enqueue guard
                    self._save_cv.notify_all()
                    continue
                self._save_inflight = True
            try:
                self._write_snapshot(snapshot)
                with self._save_cv:
                    self._written_seq = max(self._written_seq, snapshot["seq"])
                with self._lock:
                    if snapshot.get("sealed_files"):
                        self._unconfirmed_seals.difference_update(snapshot["sealed_files"])
                    self._pending_deletes.difference_update(snapshot.get("delete_after", ()))
            except Exception:
                logger.exception(f"background save failed for {self.path}")
                with self._lock:
                    self._resave_all = True
                    self.dirty += 1  # state on disk is stale again
            finally:
                with self._save_cv:
                    self._save_inflight = False
                    self._save_cv.notify_all()

    def _write_snapshot(self, snapshot):
        # type: (dict) -> None
        self.path.mkdir(parents=True, exist_ok=True)
        for seg, keys, codes, nlanes in snapshot["writes"]:
            payload = _npz_bytes(keys=keys, codes=codes, nlanes=nlanes)
            _atomic_write(self.path / seg["file"], payload, sync_dir=False)
        _atomic_write(self.path / snapshot["valid_file"], _npz_bytes(valid=snapshot["valid"]), sync_dir=False)
        # ONE directory fsync makes all the data renames above durable
        # BEFORE the manifest rename can be (ordering is all that matters;
        # per-file dir fsyncs would pay N+2 disk barriers for the same
        # guarantee).
        _fsync_dir(self.path)
        # The manifest rename is the commit point: every file above has a
        # fresh name, so a crash anywhere before this line leaves the OLD
        # manifest with all of ITS files intact.
        _atomic_write(self.path / "state.json", json.dumps(snapshot["state"]).encode())
        # Only now are the superseded files unreferenced by the on-disk state.
        for name in snapshot.get("delete_after", ()):
            try:
                (self.path / name).unlink()
            except OSError:
                pass

    def compact(self):
        # type: () -> None
        """Drop tombstoned rows and rewrite all segments on next save."""
        with self._lock:
            self._compact_locked()

    def reset(self):
        # type: () -> None
        """Release in-memory and device resources (files untouched)."""
        with self._lock:
            cap = _MIN_DEVICE_ROWS
            self._keys = np.zeros((cap, self.key_bytes), dtype=np.uint8)
            self._codes = np.zeros((cap, self.max_lanes), dtype=np.uint32)
            self._nlanes = np.zeros((cap,), dtype=np.int32)
            self._valid = np.zeros((cap,), dtype=bool)
            self._rows = 0
            self._row_gen = next(_ROW_GEN_COUNTER)
            self._key_to_row = {}
            self._live = 0
            self._segments = []
            self._unconfirmed_seals = set()
            self._partitions = None
            self._device_stale = True
            self._synced_rows = 0
            self._valid_dirty = False
            self.dirty = 0

    def drain_rotations(self):
        # type: () -> None
        """Block until every queued/in-flight background save is on disk."""
        with self._save_cv:
            self._save_cv.wait_for(lambda: self._save_queue is None and not self._save_inflight)

    def close(self):
        # type: () -> None
        """Drain background saves, save if dirty, release device memory. Idempotent."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
        self.drain_rotations()
        # Read dirty only AFTER the drain: a background write that failed
        # during the drain re-marks the index dirty (_resave_all), and that
        # state must not be lost at shutdown.
        with self._lock:
            dirty = self.dirty
        if dirty:
            self.save(wait=True)
        with self._save_cv:
            self._save_stop = True
            self._save_cv.notify_all()
        if self._save_thread is not None:
            self._save_thread.join(timeout=60)
        with self._lock:
            self._partitions = None

    # -- internals ------------------------------------------------------------

    def _key(self, key):
        # type: (bytes | int) -> bytes
        if isinstance(key, (int, np.integer)):
            return int(key).to_bytes(self.key_bytes, "big")
        key = bytes(key)
        if len(key) != self.key_bytes:
            raise ValueError(f"key must be {self.key_bytes} bytes, got {len(key)}")
        return key

    def _vector_bytes(self, vec):
        # type: (bytes | np.ndarray) -> bytes
        if isinstance(vec, np.ndarray):
            vec = vec.tobytes()
        return bytes(vec)

    def _ensure_capacity(self, needed):
        # type: (int) -> None
        cap = self._keys.shape[0]
        if needed <= cap:
            return
        new_cap = _pow2ceil(needed)

        # Grow by allocate+copy, NOT np.resize: np.resize fills the tail by
        # *tiling* the old data (then we'd zero it again) — measured 9.5 s of
        # pure waste opening a 10M snapshot.
        def grow(arr, shape):
            out = np.zeros(shape, dtype=arr.dtype)
            out[: self._rows] = arr[: self._rows]
            return out

        self._keys = grow(self._keys, (new_cap, self.key_bytes))
        self._codes = grow(self._codes, (new_cap, self.max_lanes))
        self._nlanes = grow(self._nlanes, (new_cap,))
        self._valid = grow(self._valid, (new_cap,))

    def _sync_device(self):
        # type: () -> dict[int, tuple]
        """
        Upload host arrays to the device as per-length partitions.

        Rows group by lane count; each partition is padded to a pow2 capacity
        (invalid padding rows) and carries a row_map back to global rows.
        """
        import jax
        import jax.numpy as jnp

        if not self._device_stale and self._partitions is not None:
            return self._partitions

        rows = self._rows
        try:
            # Full (re)build on first sync or mesh placement (sharded arrays
            # are rebuilt whole). Row-space SHRINKS need no clause of their
            # own: every shrinking path (_compact_locked, _load, reset) nulls
            # _partitions, so a live partitions dict implies rows only grew
            # since _synced_rows (appends are the sole other mutation).
            if self._partitions is None or self.mesh is not None:
                self._partitions = {}
                nlanes = self._nlanes[:rows]
                for lanes in np.unique(nlanes):
                    lanes = int(lanes)
                    row_map = np.flatnonzero(nlanes == lanes).astype(np.int32)
                    self._partitions[lanes] = self._build_partition(lanes, row_map)
            else:
                # Incremental: append only rows added since the last sync; a
                # partition whose capacity overflows is rebuilt alone.
                new_lanes = self._nlanes[self._synced_rows : rows]
                for lanes in np.unique(new_lanes):
                    lanes = int(lanes)
                    new_rows = (
                        self._synced_rows + np.flatnonzero(new_lanes == lanes)
                    ).astype(np.int32)
                    part = self._partitions.get(lanes)
                    if part is None or part.count + len(new_rows) > part.cap:
                        row_map = np.flatnonzero(self._nlanes[:rows] == lanes).astype(np.int32)
                        self._partitions[lanes] = self._build_partition(lanes, row_map)
                    else:
                        self._append_to_partition(part, lanes, new_rows)
                if self._valid_dirty:
                    for lanes, part in self._partitions.items():
                        valid = np.zeros((part.cap,), bool)
                        live = part.row_map[: part.count]
                        valid[: part.count] = self._valid[live]
                        part.valid_dev = jax.device_put(jnp.asarray(valid))
        except BaseException:
            # A partial incremental sync (one partition appended, another
            # failed) with stale _synced_rows would re-append the same rows
            # on retry — duplicate valid device rows. Force a full rebuild.
            self._partitions = None
            self._synced_rows = 0
            self._device_stale = True
            raise

        self._synced_rows = rows
        self._valid_dirty = False
        self._device_stale = False
        return self._partitions

    def _build_partition(self, lanes, row_map):
        # type: (int, np.ndarray) -> _Partition
        """Upload one partition from scratch (pow2 capacity + headroom)."""
        import jax
        import jax.numpy as jnp

        n_shards = _mesh_size(self.mesh) if self.mesh is not None else 1
        n = len(row_map)
        if n_shards > 1:
            # Mesh partitions stay pow2 per shard (equal shard_map blocks).
            per_shard = max(_MIN_DEVICE_ROWS, _pow2ceil(-(-n // n_shards)))
            cap = per_shard * n_shards
        else:
            cap = _cap_rows(n)
        packed = np.zeros((cap, lanes), np.uint32)
        packed[:n] = self._codes[row_map][:, :lanes]
        valid = np.zeros((cap,), bool)
        valid[:n] = self._valid[row_map]
        full_map = np.zeros((cap,), np.int32)
        full_map[:n] = row_map
        if self.mesh is not None:
            from iscc_search_tpu.parallel.pm1_sharded import shard_pm1_database

            # numpy in: place_rows uploads each process's own block directly
            # (a jnp.asarray here would commit the FULL array to local device 0
            # first — wrong under multi-process, wasteful on a single chip).
            packed_dev, valid_dev = shard_pm1_database(self.mesh, packed, valid)
        else:
            packed_dev = jax.device_put(jnp.asarray(packed))
            valid_dev = jax.device_put(jnp.asarray(valid))
        return _Partition(packed_dev, valid_dev, full_map, cap, n)

    def _append_to_partition(self, part, lanes, new_rows):
        # type: (_Partition, int, np.ndarray) -> None
        """Device append of new rows (no full re-upload)."""
        import jax
        import jax.numpy as jnp

        m = len(new_rows)
        start = part.count
        new_packed = jnp.asarray(self._codes[new_rows][:, :lanes])
        part.packed_dev = _device_append(part.packed_dev, new_packed, start)
        valid = np.zeros((part.cap,), bool)
        # In-place row_map growth is reader-safe: a concurrent search snapshot
        # pairs this map with the OLD validity mask, which marks rows >= its
        # count invalid, so the mutated tail is never dereferenced by it.
        live_map = part.row_map
        live_map[start : start + m] = new_rows
        part.count = start + m
        valid[: part.count] = self._valid[live_map[: part.count]]
        part.valid_dev = jax.device_put(jnp.asarray(valid))

    def _compact_locked(self):
        # type: () -> None
        live = np.flatnonzero(self._valid[: self._rows])
        n = len(live)
        cap = max(_MIN_DEVICE_ROWS, _pow2ceil(max(1, n)))
        keys = np.zeros((cap, self.key_bytes), dtype=np.uint8)
        codes = np.zeros((cap, self.max_lanes), dtype=np.uint32)
        nlanes = np.zeros((cap,), dtype=np.int32)
        valid = np.zeros((cap,), dtype=bool)
        keys[:n] = self._keys[live]
        codes[:n] = self._codes[live]
        nlanes[:n] = self._nlanes[live]
        valid[:n] = True
        self._keys, self._codes, self._nlanes, self._valid = keys, codes, nlanes, valid
        self._rows = n
        self._row_gen = next(_ROW_GEN_COUNTER)  # live rows renumbered
        self._key_to_row = {self._keys[i].tobytes(): i for i in range(n)}
        self._live = n
        # All previously sealed segments are invalidated by the rewrite —
        # but the committed manifest still references them, so deletion must
        # wait until a NEW manifest lands (a crash before that must reload
        # the old, pre-compaction state intact).
        for seg in self._segments:
            self._pending_deletes.add(seg["file"])
        self._segments = []
        self._unconfirmed_seals = set()
        self._partitions = None  # row space rewritten: full device rebuild
        self._synced_rows = 0
        self._valid_dirty = False
        self._device_stale = True
        self.dirty += 1  # force persistence of the rewritten layout

    def _load(self):
        # type: () -> None
        state = json.loads((self.path / "state.json").read_text())
        if state.get("key_bytes") != self.key_bytes:
            raise ValueError(
                f"index at {self.path} has key_bytes={state.get('key_bytes')}, expected {self.key_bytes}"
            )
        self.max_dim = state["max_dim"]
        self.ndim = state.get("ndim")
        rows = state["rows"]
        self._save_seq = state.get("save_seq", 0)
        self._file_seq = state.get("file_seq", 0)
        active_name = state["active"]["file"]
        self._ensure_capacity(max(rows, 1))
        pos = 0
        self._segments = []
        for seg in state["segments"] + [state["active"]]:
            f = self.path / seg["file"]
            if not f.exists():
                # Crash between segment write and manifest commit can't happen
                # (manifest is written last), but a deleted file is tolerated
                # by truncating the load at the gap.
                break
            with np.load(f) as z:
                n = z["keys"].shape[0]
                self._keys[pos : pos + n] = z["keys"]
                self._codes[pos : pos + n] = z["codes"]
                self._nlanes[pos : pos + n] = z["nlanes"]
            if seg["file"] != active_name:
                self._segments.append(seg)
            pos += n
        self._rows = pos
        self._row_gen = next(_ROW_GEN_COUNTER)  # row space rebuilt from disk
        # Versioned valid file (legacy stores used a fixed "valid.npy")
        valid_f = self.path / state.get("valid_file", "valid.npy")
        if valid_f.exists():
            with np.load(valid_f) as z:
                v = z["valid"]
                self._valid[: min(len(v), pos)] = v[: min(len(v), pos)]
        else:  # pragma: no cover - the valid file is written with state.json
            self._valid[:pos] = True
        # Key map is rebuilt lazily (first mutation/get) — see _keymap. The
        # persisted validity bitmap already encodes supersession, so the live
        # count is just its popcount.
        self._key_to_row = None
        self._live = int(np.count_nonzero(self._valid[:pos]))
        self._partitions = None
        self._synced_rows = 0
        self._valid_dirty = False
        self._device_stale = True
        self._gc_unreferenced(state)

    def _gc_unreferenced(self, state):
        # type: (dict) -> None
        """Delete data files the committed manifest does not reference.

        A crash after the manifest rename but before the worker's deferred
        deletions leaves superseded files (and *.tmp residue) behind; they
        are garbage and reclaimed here. SEQUENCE GUARD: only files whose
        parsed sequence is <= the committed counters are deleted — files
        with a HIGHER sequence belong to another live instance's in-flight
        save (a probe opening the directory mid-save must not delete the
        writer's fresh data before its manifest commits)."""
        referenced = {seg["file"] for seg in state["segments"]}
        referenced.add(state["active"]["file"])
        referenced.add(state.get("valid_file", "valid.npy"))
        save_seq = state.get("save_seq", 0)
        file_seq = state.get("file_seq", 0)

        def committed_seq(name):
            # "active-00000007.npz" -> (7, save counter); "seg-00000003.npz"
            # -> (3, file counter); unparseable -> None (never deleted here)
            stem = name.split(".", 1)[0]
            prefix, _, digits = stem.partition("-")
            if not digits.isdigit():
                return None
            n = int(digits)
            if prefix in ("active", "valid"):
                return n <= save_seq
            if prefix == "seg" and len(digits) == 8:
                return n <= file_seq
            return None

        for f in self.path.iterdir():
            name = f.name
            if name in referenced or not f.is_file():
                continue
            if name.endswith(".tmp"):
                # Crash residue from _atomic_write. Data-file tmps are
                # seq-guarded via their target-name prefix (an in-flight
                # writer's files carry a higher seq); manifest tmps
                # (state.jsonXXX.tmp) are always safe to reclaim — deleting
                # an in-flight one merely fails that save, which retries.
                if committed_seq(name) is True or name.startswith("state.json"):
                    try:
                        f.unlink()
                    except OSError:  # pragma: no cover
                        pass
                continue
            if name.endswith(".npz") and committed_seq(name) is True:
                try:
                    f.unlink()
                except OSError:  # pragma: no cover
                    pass


class DeviceNphdIndex(PackedCodeIndex):
    """
    Variable-length NPHD index over uint64 keys.

    Replaces iscc-usearch ShardedNphdIndex (constructor parity with reference
    usearch/index.py:1617-1625; add/remove/search/contains parity with
    usearch/index.py:417-445, 2024-2045). Search is exact.
    """

    metric = "nphd"
    key_bytes = 8

    def search_one(self, query_body, count):
        # type: (bytes, int) -> dict[int, float]
        """Top-``count`` matches for one query as {uint64 key: score}."""
        (keys, scores), = self.search([query_body], count)
        return {int.from_bytes(keys[i].tobytes(), "big"): float(scores[i]) for i in range(len(scores))}


class DeviceHammingIndex(PackedCodeIndex):
    """
    Fixed-width Hamming index over 16-byte composite keys
    (iscc_id_body(8) + offset(4) + size(4)).

    Replaces iscc-usearch ShardedIndex128 as used by the simprint engine
    (reference indexes/simprint/usearch_core.py:73-83).
    """

    metric = "hamming"
    key_bytes = 16

    def __init__(self, path, ndim=128, shard_size=512 * 1024 * 1024):
        # type: (str | Path, int, int) -> None
        super().__init__(path, max_dim=ndim, shard_size=shard_size, ndim=ndim)
