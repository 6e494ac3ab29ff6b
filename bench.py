"""
Kernel benchmark: the exact block-max NPHD scan over uniform 10,485,760 x
256-bit codes at Q=512, top-10, on one NVIDIA GPU.

It times warm sweeps (each ending in the results read back on the host),
then records a ``jax.profiler`` trace of a few sweeps and reduces it to
device time per scan phase (the named scopes in
``iscc_search_tpu.ops.pm1_scan.PHASE_SCOPES``), with each phase's roofline
share against the card's published peaks. In the same process it measures
what a large plain bf16 matrix product and a large device copy reach, so
each share can also be read against what the card delivers.

    python bench.py [--rows N] [--queries Q] [--k K] [--trace-dir DIR]

The last line of the output is one JSON object; every figure in it names
the card (nvidia-smi name and power limit) and the JAX device. It exits
non-zero when JAX finds no GPU.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import re
import subprocess
import sys
import time

import numpy as np

#: Published dense peaks per device kind: NVIDIA H100 SXM data sheet
#: (989 TFLOP/s bf16, 1,979 TOP/s int8, 3.35 TB/s HBM3). A device that is
#: not listed is an error, not a default.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"bf16_flops": 989e12, "int8_ops": 1979e12, "hbm_bytes_s": 3.35e12},
}


def card_line():
    # type: () -> str
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def phase_work(n, q, k, nbits, block=128):
    # type: (int, int, int, int, int) -> dict[str, tuple[float, float]]
    """(operations, bytes) each block-max phase needs at these shapes —
    the algorithm's own counts, not what XLA happened to move."""
    lanes = nbits // 32
    cand = k * block  # rescored rows per query
    return {
        "blockmax_phase1_scan": (2.0 * q * n * nbits, n * lanes * 4 + n + q * (n // block) * 4),
        "blockmax_phase2_top_blocks": (0.0, q * (n // block) * 4),
        "blockmax_phase3_rescore": (2.0 * q * cand * nbits, q * cand * (lanes * 4 + 1)),
        "blockmax_final_topk": (0.0, q * cand * 4),
    }


def hlo_scopes(hlo_text):
    # type: (str) -> dict[str, str]
    """HLO instruction name -> op_name metadata, from a compiled module's
    text. An instruction without metadata (a fusion, as a rule) takes the
    op_name of the ROOT of the computation it calls."""
    op_name = {}  # type: dict[str, str]
    calls = {}  # type: dict[str, str]
    roots = {}  # type: dict[str, str]
    comp = None
    for line in hlo_text.splitlines():
        head = re.match(r"^(?:ENTRY )?%?([\w.\-]+) .*\{\s*$", line)
        if head and not line.startswith(" "):
            comp = head.group(1)
            continue
        m = re.match(r"^\s*(ROOT )?%?([\w.\-]+) = ", line)
        if not m:
            continue
        name = m.group(2)
        meta = re.search(r'op_name="([^"]*)"', line)
        if meta:
            op_name[name] = meta.group(1)
            if m.group(1) and comp:
                roots[comp] = meta.group(1)
        called = re.search(r"calls=%?([\w.\-]+)", line)
        if called:
            calls[name] = called.group(1)
    for name, comp_name in calls.items():
        if name not in op_name and comp_name in roots:
            op_name[name] = roots[comp_name]
    return op_name


def reduce_trace(xplane_path, scopes, names, plane_prefix="/device:"):
    # type: (str, dict[str, str], tuple[str, ...], str) -> dict
    """Device time per named scope from one trace: every event on a device
    plane that carries an ``hlo_op`` stat is charged to the first scope in
    ``names`` found in that op's metadata (else "other"). Also returns the
    device busy time (union of event intervals) and the window."""
    import jax

    data = jax.profiler.ProfileData.from_file(xplane_path)
    per = {name: 0 for name in names}
    per["other"] = 0
    spans = []
    for plane in data.planes:
        if not plane.name.startswith(plane_prefix):
            continue
        for line in plane.lines:
            for ev in line.events:
                stats = dict(ev.stats)
                hlo_op = stats.get("hlo_op")
                if hlo_op is None:
                    continue
                # Kernels inside a command buffer carry the buffer's hlo_op;
                # their own name is the HLO name with "." spelled "_".
                op = scopes.get(str(hlo_op)) or scopes.get(re.sub(r"_(\d+)$", r".\1", ev.name), "")
                hit = next((name for name in names if name in op), "other")
                per[hit] += int(ev.duration_ns)
                spans.append((int(ev.start_ns), int(ev.start_ns + ev.duration_ns)))
    spans.sort()
    busy, end = 0, None
    for s, e in spans:
        if end is None or s > end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    window = (spans[-1][1] - spans[0][0]) if spans else 0
    return {"phase_ns": per, "busy_ns": busy, "window_ns": window, "events": len(spans)}


def _median_ms(fn, runs):
    # type: (..., int) -> float
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1000.0)
    return float(np.median(times))


def main(argv=None):
    # type: (list[str] | None) -> int
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--rows", type=int, default=10_485_760)
    parser.add_argument("--queries", type=int, default=512)
    parser.add_argument("--k", type=int, default=10)
    parser.add_argument("--chunk", type=int, default=32768)
    parser.add_argument("--runs", type=int, default=10)
    parser.add_argument("--trace-dir", default=os.path.join("build", "bench_trace"))
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)

    import jax
    import jax.numpy as jnp

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"bench: needs an NVIDIA GPU, JAX found {dev.platform}", file=sys.stderr)
        return 2
    if dev.device_kind not in PEAKS:
        print(f"bench: no published peaks for {dev.device_kind!r}", file=sys.stderr)
        return 2
    peaks = PEAKS[dev.device_kind]
    card = card_line()

    from iscc_search_tpu.ops.pm1_scan import PHASE_SCOPES, pm1_blockmax_topk, prepare_queries_device

    n = args.rows // args.chunk * args.chunk
    q, k, nbits = args.queries, args.k, 256
    db = jax.jit(lambda key: jax.random.bits(key, (n, 8), jnp.uint32))(jax.random.PRNGKey(args.seed))
    valid = jnp.ones((n,), bool)
    q_idx = np.arange(q, dtype=np.int64) * (n // q)
    q_pm1, q_scale = prepare_queries_device(db[q_idx], jnp.full((q,), 8, jnp.int32), nbits)

    def sweep():
        s, i = pm1_blockmax_topk(q_pm1, q_scale, db, valid, k, nbits, chunk_size=args.chunk)
        return np.asarray(s), np.asarray(i)

    t0 = time.perf_counter()
    s, i = sweep()
    compile_s = time.perf_counter() - t0
    if not (np.array_equal(i[:, 0], q_idx) and np.allclose(s[:, 0], 1.0)):
        raise AssertionError("self-match failed: each query row must come back first with score 1.0")
    sweep_ms = _median_ms(sweep, args.runs)

    # What the card delivers on plain work, measured in this process.
    a = jnp.ones((8192, 8192), jnp.bfloat16)
    mm = jax.jit(lambda x: x @ x)
    mm(a).block_until_ready()
    mm_ms = _median_ms(lambda: mm(a).block_until_ready(), args.runs)
    big = jnp.ones((1 << 30,), jnp.float32)  # 4 GiB
    cp = jax.jit(lambda x: x + 1.0)
    cp(big).block_until_ready()
    cp_ms = _median_ms(lambda: cp(big).block_until_ready(), args.runs)
    del big
    matmul_flops = 2.0 * 8192**3 / (mm_ms / 1e3)
    copy_bytes_s = 2.0 * 4 * (1 << 30) / (cp_ms / 1e3)

    os.makedirs(args.trace_dir, exist_ok=True)
    jax.profiler.start_trace(args.trace_dir)
    for _ in range(3):
        sweep()
    jax.profiler.stop_trace()
    path = sorted(glob.glob(os.path.join(args.trace_dir, "plugins", "profile", "*", "*.xplane.pb")))[-1]
    compiled = pm1_blockmax_topk.lower(q_pm1, q_scale, db, valid, k, nbits, chunk_size=args.chunk).compile()
    trace = reduce_trace(path, hlo_scopes(compiled.as_text()), PHASE_SCOPES)

    work = phase_work(n, q, k, nbits)
    phases = {}
    for name in PHASE_SCOPES:
        t = trace["phase_ns"][name] / 3 / 1e9  # per sweep
        ops, nbytes = work[name]
        bound_s = max(ops / peaks["bf16_flops"], nbytes / peaks["hbm_bytes_s"])
        phases[name] = {
            "kernel_ms": t * 1e3,
            "bound": "compute (bf16)" if ops / peaks["bf16_flops"] >= nbytes / peaks["hbm_bytes_s"] else "memory",
            "roofline_share": bound_s / t if t else None,
            "share_of_measured_plain": (max(ops / matmul_flops, nbytes / copy_bytes_s) / t) if t else None,
        }
    phases["other"] = {"kernel_ms": trace["phase_ns"]["other"] / 3 / 1e6}
    stats = dev.memory_stats() or {}
    result = {
        "metric": f"exact NPHD top-{k} sweep, {n} x {nbits}-bit, Q={q}, one GPU",
        "value": sweep_ms,
        "unit": "ms",
        "card": card,
        "device": {"platform": dev.platform, "kind": dev.device_kind, "count": len(jax.devices())},
        "xla_flags": os.environ.get("XLA_FLAGS", ""),
        "compile_and_first_sweep_s": compile_s,
        "qps": q / (sweep_ms / 1e3),
        "plain_bf16_matmul_tflops": matmul_flops / 1e12,
        "plain_copy_tb_s": copy_bytes_s / 1e12,
        "trace": {"busy_ms_per_sweep": trace["busy_ns"] / 3 / 1e6, "window_ms": trace["window_ns"] / 1e6,
                  "events": trace["events"], "path": path},
        "phases": phases,
        "peak_bytes_in_use": stats.get("peak_bytes_in_use"),
        "peaks": peaks,
    }
    print(f"card: {card}")
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
