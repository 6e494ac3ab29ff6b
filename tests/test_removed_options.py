"""Options whose implementation was removed are refused at start-up, and
engine constructors no longer take them."""

import os
import subprocess
import sys
from pathlib import Path

import pytest

from iscc_search_tpu.engine import DeviceHammingIndex, DeviceNphdIndex
from iscc_search_tpu.options import REMOVED_ENV, SearchOptions

REPO = Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("name", sorted(REMOVED_ENV))
@pytest.mark.parametrize("value", ["auto", "xla", "1"])
def test_removed_variable_refused(name, value):
    with pytest.raises(ValueError, match=name):
        SearchOptions.from_env({name: value})


@pytest.mark.parametrize("name", sorted(REMOVED_ENV))
def test_empty_removed_variable_is_unset(name):
    assert SearchOptions.from_env({name: ""}).port == 8000


def test_removed_variable_stops_start_up():
    env = dict(os.environ, ISCC_SEARCH_SCAN_KERNEL="pallas", JAX_PLATFORMS="cpu")
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run([sys.executable, "-c", "import iscc_search_tpu.options"], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert "ISCC_SEARCH_SCAN_KERNEL" in proc.stderr


@pytest.mark.parametrize("cls", [DeviceNphdIndex, DeviceHammingIndex])
def test_engines_take_no_scan_kernel(cls, tmp_path):
    with pytest.raises(TypeError):
        cls(tmp_path / "i", scan_kernel="pallas")


def test_options_have_no_scan_kernel():
    assert "scan_kernel" not in SearchOptions.model_fields
