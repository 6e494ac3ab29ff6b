"""The stdlib XDG data directory that replaced platformdirs."""

import os
import subprocess
import sys
from pathlib import Path

import pytest

import iscc_search_tpu

REPO = Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("xdg", ["set", "unset", "empty"])
def test_user_data_dir_follows_xdg(xdg, monkeypatch, tmp_path):
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    if xdg == "set":
        monkeypatch.setenv("XDG_DATA_HOME", str(tmp_path / "xdg"))
        expected = tmp_path / "xdg" / "iscc-search-tpu"
    else:
        if xdg == "empty":
            monkeypatch.setenv("XDG_DATA_HOME", "")
        else:
            monkeypatch.delenv("XDG_DATA_HOME", raising=False)
        expected = tmp_path / "home" / ".local" / "share" / "iscc-search-tpu"
    assert Path(iscc_search_tpu.dirs.user_data_dir) == expected


def test_default_index_uri_uses_data_dir(monkeypatch, tmp_path):
    from iscc_search_tpu.options import SearchOptions

    monkeypatch.setenv("XDG_DATA_HOME", str(tmp_path))
    assert SearchOptions().index_uri == f"tpu:///{(tmp_path / 'iscc-search-tpu').as_posix()}"


def test_package_imports_without_platformdirs():
    code = (
        "import sys\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name == 'platformdirs': raise ImportError('blocked')\n"
        "sys.meta_path.insert(0, Block())\n"
        "import iscc_search_tpu, iscc_search_tpu.options, iscc_search_tpu.config\n"
        "print(iscc_search_tpu.dirs.user_data_dir)\n"
    )
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("iscc-search-tpu")
