"""bench.py's trace reduction and work counts, checked on a CPU trace; the
timings themselves come only from a run on the card."""

import glob
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import bench
from iscc_search_tpu.ops.pm1_scan import PHASE_SCOPES, pm1_blockmax_topk, prepare_queries_device

REPO = Path(__file__).resolve().parent.parent


def test_phase_work_counts():
    work = bench.phase_work(n=1 << 20, q=512, k=10, nbits=256)
    assert work["blockmax_phase1_scan"][0] == 2.0 * 512 * (1 << 20) * 256
    assert work["blockmax_phase1_scan"][1] >= (1 << 20) * 32  # the packed rows at least
    assert work["blockmax_phase3_rescore"][0] == 2.0 * 512 * 10 * 128 * 256
    assert set(work) == set(PHASE_SCOPES)


def test_hlo_scopes_resolves_fusions_to_their_root():
    text = """HloModule m

%fused_computation.2 (p: f32[4]) -> f32[4] {
  %p = f32[4]{0} parameter(0)
  ROOT %sine.1 = f32[4]{0} sine(%p), metadata={op_name="jit(f)/blockmax_phase1_scan/sin"}
}

ENTRY %main (x: f32[4]) -> f32[4] {
  %x = f32[4]{0} parameter(0)
  %fusion.2 = f32[4]{0} fusion(%x), kind=kLoop, calls=%fused_computation.2
  ROOT %cosine.3 = f32[4]{0} cosine(%fusion.2), metadata={op_name="jit(f)/blockmax_final_topk/cos"}
}
"""
    scopes = bench.hlo_scopes(text)
    assert "blockmax_phase1_scan" in scopes["fusion.2"]
    assert "blockmax_final_topk" in scopes["cosine.3"]


@pytest.fixture(scope="module")
def cpu_trace(tmp_path_factory):
    d = tmp_path_factory.mktemp("trace")
    n = 16384
    db = jax.random.bits(jax.random.PRNGKey(0), (n, 8), jnp.uint32)
    valid = jnp.ones((n,), bool)
    q_pm1, q_scale = prepare_queries_device(db[:8], jnp.full((8,), 8, jnp.int32), 256)
    args = (q_pm1, q_scale, db, valid, 4, 256)

    def sweep():
        np.asarray(pm1_blockmax_topk(*args, chunk_size=4096)[0])

    sweep()
    jax.profiler.start_trace(str(d))
    sweep()
    jax.profiler.stop_trace()
    path = sorted(glob.glob(os.path.join(str(d), "plugins", "profile", "*", "*.xplane.pb")))[-1]
    return path, pm1_blockmax_topk.lower(*args, chunk_size=4096).compile().as_text()


def test_reduce_trace_charges_every_phase(cpu_trace):
    path, hlo = cpu_trace
    out = bench.reduce_trace(path, bench.hlo_scopes(hlo), PHASE_SCOPES, plane_prefix="/host:CPU")
    assert out["events"] > 0
    for name in PHASE_SCOPES:
        assert out["phase_ns"][name] > 0, name
    assert 0 < out["busy_ns"] <= out["window_ns"]


def test_reduce_trace_ignores_other_planes(cpu_trace):
    path, hlo = cpu_trace
    out = bench.reduce_trace(path, bench.hlo_scopes(hlo), PHASE_SCOPES)  # no device plane on the CPU
    assert out["events"] == 0 and out["busy_ns"] == 0


def test_bench_refuses_without_gpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, str(REPO / "bench.py")], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert "needs an NVIDIA GPU" in proc.stderr and proc.stdout == ""
