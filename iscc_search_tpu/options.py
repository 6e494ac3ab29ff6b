"""
Configuration options for iscc-search-tpu.

Mirrors the reference's dual-config split (reference options.py:9-27):

1. This module — server deployment configuration from ``ISCC_SEARCH_*``
   environment variables (12-factor style), consumed by the API server.
2. :mod:`iscc_search_tpu.config` — persistent CLI multi-index management.

pydantic-settings is not available in this environment, so env loading is a
small explicit shim over a plain pydantic model (same env variable names and
defaults as the reference where the knob carries over; HNSW-specific knobs
like connectivity/expansion have no meaning for an exact scan engine and are
replaced by scan/batching knobs).
"""

from __future__ import annotations

import os
from pathlib import Path
from urllib.parse import urlparse

from pydantic import BaseModel, Field, field_validator

import iscc_search_tpu
from iscc_search_tpu.aggregator import NETWORKS

__all__ = ["SearchOptions", "search_opts", "get_index"]

ENV_PREFIX = "ISCC_SEARCH_"

#: Variables of options that were removed; a deployment still setting one is
#: refused at start-up instead of silently running without what it asked for.
REMOVED_ENV = {
    "ISCC_SEARCH_SCAN_KERNEL": "the exact scan has one implementation (the XLA block-max scan)",
    "ISCC_SEARCH_UNPACKED_MAX_BYTES": "no unpacked device layout is kept; rows stay bit-packed",
}


class SearchOptions(BaseModel):
    """Runtime options, overridable via ISCC_SEARCH_* environment variables."""

    model_config = {"validate_assignment": True}

    index_uri: str = Field(
        default_factory=lambda: f"tpu:///{Path(iscc_search_tpu.dirs.user_data_dir).as_posix()}",
        description="ISCC_SEARCH_INDEX_URI - index backend URI (memory://, kv:///path, tpu:///path; "
        "lmdb:// and usearch:// are accepted as compatibility aliases)",
    )
    api_secret: str | None = Field(None, description="ISCC_SEARCH_API_SECRET - API key (unset = public)")
    cors_origins: str = Field("*", description="ISCC_SEARCH_CORS_ORIGINS - comma-separated origins")
    host: str = Field("0.0.0.0", description="ISCC_SEARCH_HOST")
    port: int = Field(8000, description="ISCC_SEARCH_PORT")
    workers: int | None = Field(None, description="ISCC_SEARCH_WORKERS - worker processes")
    http_backend: str = Field(
        "pooled",
        pattern="^(pooled|wsgiref)$",
        description="ISCC_SEARCH_HTTP_BACKEND - serving transport: pooled (keep-alive HTTP/1.1 "
        "thread-pool, ~11x wsgiref throughput) or wsgiref (stdlib reference server)",
    )
    http_threads: int = Field(
        16, ge=1, description="ISCC_SEARCH_HTTP_THREADS - worker threads for the pooled HTTP server"
    )
    http_max_pending: int = Field(
        64,
        ge=0,
        description="ISCC_SEARCH_HTTP_MAX_PENDING - ready-request queue depth bound for the pooled "
        "server; requests past it are shed with 503 + Retry-After instead of queueing unboundedly "
        "(0 disables admission control). Added queue wait at overload ~= depth / capacity-QPS, so "
        "64 keeps p50 within ~3x the at-saturation p50 on a ~600 QPS host",
    )
    http_queue_deadline_ms: float = Field(
        500.0,
        ge=0.0,
        description="ISCC_SEARCH_HTTP_QUEUE_DEADLINE_MS - a request queued longer than this is shed "
        "with 503 instead of served (bounds at-overload latency to ~deadline; 0 disables)",
    )
    scaleout_breaker_ms: float = Field(
        50.0,
        ge=0.0,
        description="ISCC_SEARCH_SCALEOUT_BREAKER_MS - after the engine rejects a search as "
        "overloaded, scale-out workers fail searches fast locally (and shed new requests at "
        "admission, before parsing) for this window instead of paying a doomed RPC round trip "
        "per request; refreshed by every fresh rejection (0 disables)",
    )

    # Segment sizes (MB) — bounded crash-loss windows, parity with shard_size_*
    shard_size_units: int = Field(512, ge=1, description="ISCC_SEARCH_SHARD_SIZE_UNITS - segment seal size MB")
    shard_size_simprints: int = Field(512, ge=1, description="ISCC_SEARCH_SHARD_SIZE_SIMPRINTS - segment seal size MB")

    # Match thresholds / scoring (same semantics as the reference)
    match_threshold_units: float = Field(0.75, ge=0.0, le=1.0, description="ISCC_SEARCH_MATCH_THRESHOLD_UNITS")
    match_threshold_simprints: float = Field(0.75, ge=0.0, le=1.0, description="ISCC_SEARCH_MATCH_THRESHOLD_SIMPRINTS")
    confidence_exponent: int = Field(4, ge=1, description="ISCC_SEARCH_CONFIDENCE_EXPONENT")
    oversampling_factor: int = Field(20, ge=1, description="ISCC_SEARCH_OVERSAMPLING_FACTOR")

    # Flush control (auto-save derived indexes after N dirty mutations)
    flush_interval: int = Field(100000, ge=0, description="ISCC_SEARCH_FLUSH_INTERVAL - 0 disables")

    # Device/scan knobs (the scan engine's replacements for the HNSW quality knobs)
    scan_chunk_rows: int = Field(32768, ge=128, description="ISCC_SEARCH_SCAN_CHUNK_ROWS - top-k scan chunk size")
    query_batch_max: int = Field(
        512,
        ge=1,
        description="ISCC_SEARCH_QUERY_BATCH_MAX - max fused query batch",
    )
    scan_recall_target: float | None = Field(
        None,
        gt=0.0,
        le=1.0,
        description="ISCC_SEARCH_SCAN_RECALL_TARGET - per-chunk top-k recall target; unset/1.0 = exact scan "
        "(recall 1.0); values < 1.0 trade a little recall for throughput (lax.approx_max_k)",
    )
    mesh_devices: int = Field(
        0,
        ge=0,
        description="ISCC_SEARCH_MESH_DEVICES - shard NPHD partitions over this many devices "
        "(0 = single device; >1 enables the sharded scan with all-gather top-k merge). "
        "With mesh_hosts > 1 this is chips PER HOST (0 = all local devices)",
    )
    mesh_hosts: int = Field(
        0,
        ge=0,
        description="ISCC_SEARCH_MESH_HOSTS - host (process) count of the 2-D (dcn x ici) search "
        "mesh; 0 = auto (jax.process_count() under jax.distributed, else single-host). >1 row-shards "
        "NPHD partitions across hosts and merges hierarchically (ICI within a host, then DCN)",
    )
    multihost_coordinator: str = Field(
        "localhost",
        description="ISCC_SEARCH_MULTIHOST_COORDINATOR - hostname of process 0 for the multi-host "
        "control channel (followers connect here; coordinator listens on all interfaces)",
    )
    multihost_control_port: int = Field(
        7801,
        ge=1,
        le=65535,
        description="ISCC_SEARCH_MULTIHOST_CONTROL_PORT - TCP port of the multi-host SPMD control "
        "channel (distinct from the HTTP port and the jax.distributed coordinator port)",
    )
    distributed: bool = Field(
        False,
        description="ISCC_SEARCH_DISTRIBUTED - call jax.distributed.initialize() before serving "
        "(set JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES / JAX_PROCESS_ID). Process 0 serves HTTP; "
        "other processes run the follower loop",
    )
    multihost_index: str | None = Field(
        None,
        description="ISCC_SEARCH_MULTIHOST_INDEX - index name follower processes open and serve "
        "(required on followers when the backend manages multiple indexes)",
    )
    compile_cache_dir: str | None = Field(
        None,
        description="ISCC_SEARCH_COMPILE_CACHE_DIR - persistent XLA compile cache directory "
        "(unset = JAX_COMPILATION_CACHE_DIR when set, else .jax_cache/ beside the package; 'off' "
        "disables). Restart cold-start fix: compiled scan programs are reloaded instead of recompiled",
    )
    search_batching: bool = Field(
        True,
        description="ISCC_SEARCH_SEARCH_BATCHING - coalesce concurrent searches into fused device sweeps "
        "(adaptive: batches whatever queued while the previous sweep ran)",
    )
    search_batching_window_ms: float = Field(
        0.0,
        ge=0.0,
        description="ISCC_SEARCH_SEARCH_BATCHING_WINDOW_MS - extra wait to fill a batch after the first "
        "request (0 = adaptive only)",
    )

    # Aggregator mode
    aggregator_network: str | None = Field(None, description="ISCC_SEARCH_AGGREGATOR_NETWORK - testnet or mainnet")
    aggregator_hub_list_url: str | None = Field(None, description="ISCC_SEARCH_AGGREGATOR_HUB_LIST_URL")
    aggregator_poll_interval: int = Field(60, ge=1, description="ISCC_SEARCH_AGGREGATOR_POLL_INTERVAL - seconds")
    aggregator_hub_refresh_interval: int = Field(3600, ge=1, description="ISCC_SEARCH_AGGREGATOR_HUB_REFRESH_INTERVAL")
    aggregator_convert_workers: int = Field(
        # sched_getaffinity respects cgroup/affinity limits (a 1-CPU-quota
        # container reports its quota, not the host core count — a worker
        # there is ~15% SLOWER than inline); os.cpu_count() is the fallback.
        default_factory=lambda: 1 if len(getattr(os, "sched_getaffinity", lambda _: range(os.cpu_count() or 1))(0)) > 1 else 0,
        ge=0,
        le=8,
        description="ISCC_SEARCH_AGGREGATOR_CONVERT_WORKERS - record-conversion worker processes "
        "(0 = convert inline; both halves of the ingest pipeline are Python-bound, so on a "
        "multi-core host a worker process lets conversion overlap indexing instead of "
        "serializing behind the GIL; default 1 when >1 core is available, else 0 — on a "
        "single core a worker only adds pickling overhead)",
    )

    # Logging
    log_level: str = Field("info", description="ISCC_SEARCH_LOG_LEVEL")

    # Error tracking (optional; requires sentry-sdk to be installed)
    sentry_dsn: str | None = Field(None, description="ISCC_SEARCH_SENTRY_DSN - disabled when unset")
    sentry_traces_sample_rate: float = Field(
        0.05, ge=0.0, le=1.0, description="ISCC_SEARCH_SENTRY_TRACES_SAMPLE_RATE"
    )

    @field_validator("aggregator_network")
    @classmethod
    def validate_aggregator_network(cls, value):
        # type: (str | None) -> str | None
        if not value:
            return None
        if value not in NETWORKS:
            raise ValueError(f"aggregator_network must be one of {sorted(NETWORKS)}, got: '{value}'")
        return value

    @classmethod
    def from_env(cls, env=None):
        # type: (dict | None) -> SearchOptions
        """Build options from ISCC_SEARCH_* env vars (unset fields use defaults)."""
        env = os.environ if env is None else env
        removed = [f"{name} ({why})" for name, why in REMOVED_ENV.items() if env.get(name)]
        if removed:
            raise ValueError("removed options are still set; unset them: " + "; ".join(removed))
        kwargs = {}
        for name in cls.model_fields:
            raw = env.get(ENV_PREFIX + name.upper())
            if raw is not None and raw != "":
                kwargs[name] = raw
        return cls(**kwargs)

    @property
    def cors_origins_list(self):
        # type: () -> list[str]
        return [origin.strip() for origin in self.cors_origins.split(",")]

    @property
    def aggregator_mode(self):
        # type: () -> bool
        return self.aggregator_network is not None

    @property
    def aggregator_index_name(self):
        # type: () -> str
        return NETWORKS[self.aggregator_network]["index"]

    @property
    def aggregator_hub_list_source(self):
        # type: () -> str
        if self.aggregator_hub_list_url:
            return self.aggregator_hub_list_url
        return f"https://raw.githubusercontent.com/iscc/iscc-hub/main/hubs/{self.aggregator_network}.yaml"

    def override(self, update=None):
        # type: (dict | None) -> SearchOptions
        """Validated deep copy with per-field updates (parity with reference override())."""
        update = update or {}
        options = self.model_copy(deep=True)
        for field, value in update.items():
            setattr(options, field, value)
        return options


search_opts = SearchOptions.from_env()


def _normalize_uri_path(path):
    # type: (str) -> str
    import sys

    if sys.platform == "win32" and path.startswith("/") and len(path) > 2 and path[2] == ":":  # pragma: no cover
        return path[1:]
    if path.startswith("//"):  # pragma: no cover - URI with extra slashes
        return path[1:]
    return path


def get_index(uri=None):
    # type: (str | None) -> ...
    """
    Backend factory by URI scheme.

    - memory:// -> MemoryIndex (no persistence)
    - kv:///path (alias lmdb://) -> KvIndexManager (host-store exact/prefix search)
    - tpu:///path (alias usearch://) -> TpuIndexManager (device scan engine)
    """
    uri = uri if uri is not None else search_opts.index_uri

    if uri == "memory://" or uri.startswith("memory://"):
        from iscc_search_tpu.indexes.memory import MemoryIndex

        return MemoryIndex()

    if "://" not in uri:
        supported = ["memory://", "kv:///path", "tpu:///path"]
        raise ValueError(
            f"ISCC_SEARCH_INDEX_URI requires explicit scheme, got: '{uri}'. Supported schemes: {', '.join(supported)}"
        )

    parsed = urlparse(uri)
    path = _normalize_uri_path(parsed.path)
    return manager_for(parsed.scheme, path, uri=uri)


def manager_for(scheme, path, uri=None):
    # type: (str, str, str | None) -> ...
    """Scheme -> backend manager over a filesystem path (shared with the CLI,
    which passes configured paths directly — no URI round-trip)."""
    if scheme in ("kv", "lmdb"):
        from iscc_search_tpu.indexes.kv import KvIndexManager

        return KvIndexManager(path)

    if scheme in ("tpu", "usearch"):
        # Configure the persistent compile cache before the backend import
        # pulls in the ops modules (first ensure_compile_cache call wins).
        from iscc_search_tpu.compile_cache import ensure_compile_cache

        ensure_compile_cache(search_opts.compile_cache_dir)

        from iscc_search_tpu.indexes.tpu import TpuIndexManager

        return TpuIndexManager(path)

    supported = ["memory://", "kv://", "tpu://"]
    raise ValueError(
        f"Unsupported ISCC_SEARCH_INDEX_URI scheme: '{uri or scheme}'. Supported schemes: {', '.join(supported)}."
    )
