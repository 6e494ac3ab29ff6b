"""chip_smoke.py rehearsed on the CPU: its reference, its checks, every phase
at a tiny size, and its refusal to report a result without a GPU."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import chip_smoke as cs

REPO = Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("tombstones", [False, True])
def test_brute_force_matches_pairwise_popcount(tombstones):
    """The blocked numpy reference against a per-pair bit count."""
    rng = np.random.default_rng(11)
    packed, lanes = cs.mixed_rows(rng, 300)
    valid = np.ones(300, bool)
    if tombstones:
        valid[rng.choice(300, 20, replace=False)] = False
    q_packed, q_lanes = cs.mixed_rows(rng, 4)
    got = cs.brute_force_nphd(q_packed, q_lanes, packed, lanes, valid, block_rows=128)
    for qi in range(4):
        for r in range(300):
            m = min(int(q_lanes[qi]), int(lanes[r]))
            ham = sum(bin(int(a) ^ int(b)).count("1") for a, b in zip(q_packed[qi, :m], packed[r, :m]))
            assert got[qi, r] == (1.0 - ham / (32 * m) if valid[r] else -1.0)


def _fake_results(ref, count):
    out = []
    for qi in range(ref.shape[0]):
        rows = np.argsort(-ref[qi], kind="stable")[: min(count, int((ref[qi] >= 0).sum()))]
        keys = cs._keys8(1, ref.shape[1])[rows]
        out.append((keys, ref[qi][rows].astype(np.float32)))
    return out


@pytest.mark.parametrize("fault", ["none", "wrong_score", "tombstoned_row", "missing_row"])
def test_check_topk_catches_faults(fault):
    rng = np.random.default_rng(12)
    packed, lanes = cs.mixed_rows(rng, 500)
    valid = np.ones(500, bool)
    valid[:50] = False
    ref = cs.brute_force_nphd(packed[100:102], lanes[100:102], packed, lanes, valid)
    res = _fake_results(ref, 10)
    keys, scores = res[0]
    if fault == "wrong_score":
        scores = scores.copy()
        scores[3] += 1e-4
    elif fault == "tombstoned_row":
        keys = keys.copy()
        keys[-1] = cs._keys8(1, 1)[0]  # row 0 is tombstoned
    elif fault == "missing_row":
        keys, scores = keys[:-1], scores[:-1]
    res[0] = (keys, scores)
    if fault == "none":
        cs.check_topk("t", res, ref, 10, cs._rows_of_keys8)
    else:
        with pytest.raises(AssertionError):
            cs.check_topk("t", res, ref, 10, cs._rows_of_keys8)


def test_phase_env_reports_card_and_packages(monkeypatch, capsys):
    monkeypatch.setattr(cs, "card_line", lambda: "Test Card, 123.00 W")
    assert cs.phase_env() == "Test Card, 123.00 W"
    out = capsys.readouterr().out
    assert "phase0 card: Test Card, 123.00 W" in out
    assert "phase0 compile cache dir:" in out
    for mod in ("pydantic", "platformdirs", "click", "rich", "httpx", "yaml"):
        assert f"phase0 package {mod}:" in out


def test_phase_engine_tiny(capsys):
    cs.phase_engine("cpu", 0, n=30000, n_append=512, batches=(8, 16), big_k=100,
                    chunk_sweep=(2048, 4096), runs=1)
    out = capsys.readouterr().out
    assert "phase1 OK" in out and "appended 512 rows in place" in out
    assert "[cpu] phase1 warm sweep Q=16 k=10" in out


def test_phase_simprint_tiny(capsys):
    cs.phase_simprint("cpu", 0, n=20000, q=8, runs=1)
    assert "phase2 OK" in capsys.readouterr().out


def test_phase_served_tiny(capsys):
    cs.phase_served("cpu", 0, n=600, batch=200, n_queries=3, limit=10)
    out = capsys.readouterr().out
    assert "phase3 added 600 assets over HTTP" in out and "phase3 OK" in out


def test_check_served_rejects_wrong_unit_score():
    rng = np.random.default_rng(13)
    assets, codes = cs.make_assets(rng, 4)
    from iscc_search_tpu.options import SearchOptions

    opts = SearchOptions(index_uri="memory://")
    ids = [a["iscc_id"] for a in assets]
    index_of = {iscc_id: i for i, iscc_id in enumerate(ids)}
    good = {
        "global_matches": [{"iscc_id": ids[0], "score": 1.0,
                            "types": {"CONTENT_TEXT_V0": 1.0, "DATA_NONE_V0": 1.0, "INSTANCE_NONE_V0": 1.0}}],
        "chunk_matches": [{"iscc_id": ids[0]}],
    }
    cs.check_served(good, ids[0], index_of, codes, opts)
    bad = json.loads(json.dumps(good))
    bad["global_matches"][0]["types"]["DATA_NONE_V0"] = 0.9375
    with pytest.raises(AssertionError):
        cs.check_served(bad, ids[0], index_of, codes, opts)


def test_phase_four_cards_tiny_on_virtual_devices(capsys):
    cs.phase_four_cards("cpu", 0, n=40000, q=8, runs=1)
    out = capsys.readouterr().out
    assert "four-cards OK" in out and out.count("padding:") == 2


def test_phase_gpu_tests_fail_when_they_skip(monkeypatch):
    """Without a card every gpu-marked test skips, which the phase must
    count as a failure, not a pass."""
    seen = {}

    def fake_main(args, plugins):
        seen["args"] = args
        plugins[0].counts["skipped"] = 3
        return 0

    monkeypatch.setattr("pytest.main", fake_main)
    with pytest.raises(AssertionError, match="did not all pass"):
        cs.phase_gpu_tests()
    assert "-m" in seen["args"] and "gpu" in seen["args"]


def _run(cwd, script, *args):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["JAX_PLATFORMS"] = "cpu"
    return subprocess.run([sys.executable, str(script), *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


@pytest.mark.parametrize("args", [(), ("--four-cards",)])
def test_main_refuses_without_gpu(args):
    proc = _run(REPO, REPO / "chip_smoke.py", *args)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
    assert "needs an NVIDIA GPU" in proc.stderr


def test_main_fails_alone(tmp_path):
    """In a directory holding chip_smoke.py and nothing else of the repo."""
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    proc = _run(tmp_path, tmp_path / "chip_smoke.py")
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
