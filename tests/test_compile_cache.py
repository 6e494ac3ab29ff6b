"""Persistent XLA compile cache configuration (compile_cache.py)."""

import os
import subprocess
import sys
from pathlib import Path

import jax
import pytest

import iscc_search_tpu
from iscc_search_tpu import compile_cache

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True)
def _no_jax_cache_var(monkeypatch):
    # The JAX variable outranks every other source; tests that want it set
    # set it themselves.
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)


def _reset(monkeypatch):
    monkeypatch.setattr(compile_cache, "_configured", None)


def test_default_dir_is_platform_cache():
    """The default is the fixed .jax_cache/ beside the package, never a
    per-user, per-process or per-run path."""
    expected = Path(iscc_search_tpu.__file__).resolve().parent.parent / ".jax_cache"
    assert compile_cache.default_cache_dir() == str(expected)
    assert compile_cache.default_cache_dir() == compile_cache.default_cache_dir()


def test_jax_variable_outranks_option_and_env(monkeypatch, tmp_path):
    _reset(monkeypatch)
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "jaxdir"))
    monkeypatch.setenv("ISCC_SEARCH_COMPILE_CACHE_DIR", str(tmp_path / "envdir"))
    assert compile_cache.ensure_compile_cache(str(tmp_path / "optdir")) == str(tmp_path / "jaxdir")
    assert jax.config.jax_compilation_cache_dir == str(tmp_path / "jaxdir")
    assert not (tmp_path / "envdir").exists() and not (tmp_path / "optdir").exists()


_PLACEMENT_CHILD = """
import sys
import iscc_search_tpu.compile_cache as cc
cc.default_cache_dir = lambda: sys.argv[1]
import jax, jax.numpy as jnp
import iscc_search_tpu.ops.pm1_scan  # configures the cache at import
print(jax.jit(lambda x: jnp.sin(x) * 3 + 1)(jnp.arange(7.0)).sum())
"""


@pytest.mark.parametrize("case", ["jax_variable_set", "unset", "off"])
def test_cache_entries_land_where_configured(case, tmp_path):
    """A real compile in a fresh process: entries land only in the JAX
    variable's directory when it is set, only in the fixed default when
    nothing is set, and nowhere when the cache is off."""
    jax_dir, default_dir = tmp_path / "jax", tmp_path / "default"
    env = {k: v for k, v in os.environ.items() if k not in ("JAX_COMPILATION_CACHE_DIR", "ISCC_SEARCH_COMPILE_CACHE_DIR")}
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    if case == "jax_variable_set":
        env["JAX_COMPILATION_CACHE_DIR"] = str(jax_dir)
    elif case == "off":
        env["ISCC_SEARCH_COMPILE_CACHE_DIR"] = "off"
    proc = subprocess.run(
        [sys.executable, "-c", _PLACEMENT_CHILD, str(default_dir)],
        env=env, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr

    def entries(d):
        return [p for p in d.rglob("*") if p.is_file()] if d.exists() else []

    expected = {"jax_variable_set": (True, False), "unset": (False, True), "off": (False, False)}[case]
    assert (bool(entries(jax_dir)), bool(entries(default_dir))) == expected


def test_explicit_path_configures_jax(monkeypatch, tmp_path):
    _reset(monkeypatch)
    target = tmp_path / "xlacache"
    got = compile_cache.ensure_compile_cache(str(target))
    assert got == str(target)
    assert target.is_dir()
    assert jax.config.jax_compilation_cache_dir == str(target)


def test_disabled_values(monkeypatch, tmp_path):
    for value in ("off", "OFF", "none", "0", ""):
        _reset(monkeypatch)
        assert compile_cache.ensure_compile_cache(value) is None


def test_env_fallback(monkeypatch, tmp_path):
    _reset(monkeypatch)
    target = tmp_path / "envcache"
    monkeypatch.setenv("ISCC_SEARCH_COMPILE_CACHE_DIR", str(target))
    assert compile_cache.ensure_compile_cache() == str(target)


def test_first_explicit_caller_wins(monkeypatch, tmp_path):
    _reset(monkeypatch)
    first = tmp_path / "first"
    compile_cache.ensure_compile_cache(str(first))
    # A later explicit call is a no-op reporting the active dir.
    assert compile_cache.ensure_compile_cache(str(tmp_path / "second")) == str(first)


def test_explicit_overrides_implicit(monkeypatch, tmp_path):
    # Importing an ops module configures the env/default path implicitly;
    # the user's SearchOptions.compile_cache_dir must still take effect.
    _reset(monkeypatch)
    monkeypatch.setenv("ISCC_SEARCH_COMPILE_CACHE_DIR", str(tmp_path / "envdir"))
    compile_cache.ensure_compile_cache()  # implicit (ops import)
    chosen = tmp_path / "chosen"
    assert compile_cache.ensure_compile_cache(str(chosen)) == str(chosen)
    assert jax.config.jax_compilation_cache_dir == str(chosen)


def test_explicit_off_overrides_implicit(monkeypatch, tmp_path):
    _reset(monkeypatch)
    monkeypatch.setenv("ISCC_SEARCH_COMPILE_CACHE_DIR", str(tmp_path / "envdir"))
    compile_cache.ensure_compile_cache()  # implicit: installs envdir
    assert compile_cache.ensure_compile_cache("off") is None
    assert not jax.config.jax_compilation_cache_dir


def test_implicit_never_overrides(monkeypatch, tmp_path):
    _reset(monkeypatch)
    chosen = tmp_path / "chosen"
    compile_cache.ensure_compile_cache(str(chosen))
    assert compile_cache.ensure_compile_cache() == str(chosen)  # implicit no-op


def test_default_fallback_uses_platform_dir(monkeypatch, tmp_path):
    _reset(monkeypatch)
    monkeypatch.delenv("ISCC_SEARCH_COMPILE_CACHE_DIR", raising=False)
    monkeypatch.setattr(
        compile_cache, "default_cache_dir", lambda: str(tmp_path / "plat")
    )
    assert compile_cache.ensure_compile_cache() == str(tmp_path / "plat")


def test_failed_configuration_does_not_latch(tmp_path, monkeypatch):
    """A transient failure must not permanently disable the cache: a later
    call with a valid path still configures it."""
    import iscc_search_tpu.compile_cache as cc

    monkeypatch.setattr(cc, "_configured", None)
    blocker = tmp_path / "file"
    blocker.write_text("x")  # makedirs below a FILE fails
    assert cc.ensure_compile_cache(str(blocker / "sub")) is None
    good = tmp_path / "cache"
    assert cc.ensure_compile_cache(str(good)) == str(good)
