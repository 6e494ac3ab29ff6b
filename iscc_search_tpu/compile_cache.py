"""
Persistent XLA compilation cache — the cold-start fix for production restarts.

A restarted process would otherwise recompile every scan program before its
first query. The compiles are identical across restarts, so JAX's persistent
compilation cache (serialized executables keyed by HLO fingerprint) is
written once and loaded on every later start.

Where the cache lives, first match wins:

1. ``JAX_COMPILATION_CACHE_DIR`` when set — JAX reads it itself, and this
   module sets no other directory;
2. an explicit ``path`` (``SearchOptions.compile_cache_dir``), then
   ``ISCC_SEARCH_COMPILE_CACHE_DIR``;
3. the fixed ``.jax_cache/`` directory beside the package (git-ignored in a
   checkout). The path is part of the cache key, so it never depends on a
   temp name, a pid or the time.

``"off"`` (or empty) disables the cache, whichever source set it.

Call precedence: ops modules invoke :func:`ensure_compile_cache` with no
argument at import time; backends created through
``SearchOptions.compile_cache_dir`` pass that value explicitly. An explicit
call overrides an earlier implicit one (importing any ops module before
``manager_for()`` must not swallow the configured option); among explicit
calls the first wins. JAX consults the setting on each compile, so a
post-import reconfiguration still applies to every not-yet-compiled program.
"""

from __future__ import annotations

import os

from iscc_search_tpu.utils import get_logger

logger = get_logger(__name__)

_DISABLED = {"off", "none", "0", "disabled"}
_configured = None  # type: str | None  # "implicit" | "explicit" once set


def default_cache_dir():
    # type: () -> str
    """The fixed in-checkout cache directory: ``.jax_cache/`` beside the package."""
    return os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache")


def ensure_compile_cache(path=None):
    # type: (str | None) -> str | None
    """
    Point JAX's persistent compilation cache at the directory the module
    docstring's precedence picks. ``"off"`` (or empty) disables persistence.
    Explicit paths override an earlier implicit (env/default) configuration;
    the first explicit path wins.

    Returns the directory in use, or None when disabled/unavailable.
    """
    global _configured
    explicit = path is not None
    if _configured == "explicit" or (_configured is not None and not explicit):
        return _current()

    if path is None:
        path = os.environ.get("ISCC_SEARCH_COMPILE_CACHE_DIR")
    if path is not None and (not path or str(path).strip().lower() in _DISABLED):
        _configured = "explicit" if explicit else "implicit"
        _disable()
        return None
    jax_dir = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    path = str(jax_dir or path or default_cache_dir())
    try:
        os.makedirs(path, exist_ok=True)
        import jax

        jax.config.update("jax_compilation_cache_dir", path)
        # Cache everything: the scan programs recompile per shape bucket, and
        # entries are tiny compared to the index itself.
        jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
        jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    except Exception as exc:  # pragma: no cover - platform-specific
        # Do NOT latch _configured on failure: a transient error (read-only
        # FS, jax state) would otherwise permanently disable the cache for
        # this process — a later call with a valid path must still work.
        logger.warning(f"persistent compile cache unavailable at {path}: {exc}")
        return None
    _configured = "explicit" if explicit else "implicit"
    return path


def _disable():
    # type: () -> None
    """Clear any cache dir a prior implicit call installed ('off' override)."""
    try:
        import jax

        if jax.config.jax_compilation_cache_dir:
            jax.config.update("jax_compilation_cache_dir", None)
    except Exception:  # pragma: no cover - jax absent/misconfigured
        pass


def _current():
    # type: () -> str | None
    try:
        import jax

        value = jax.config.jax_compilation_cache_dir
        return value or None
    except Exception:  # pragma: no cover
        return None
