"""
Cold-start benchmark: open a persisted 10M x 256-bit DeviceNphdIndex and run
the first query (VERDICT r2 item 4: restart of a production 10M index must
not mean minutes of downtime).

Phases reported:
  build_s    one-time snapshot construction (excluded from cold start)
  open_s     DeviceNphdIndex(path): manifest + segment np.load into host RAM
  first_q_s  first search(8 queries): device upload + twin build + compile + sweep
  warm_q_ms  second search (steady state)

Run: PYTHONPATH=. python benchmarks/coldstart_10m.py [n]
Snapshot is cached under $ISCC_BENCH_DIR (default /tmp/coldstart_idx) and
reused across runs.
"""

import json
import os
import shutil
import sys
import time
from pathlib import Path

import numpy as np

N_DEFAULT = 10_485_760


def build_snapshot(path, n):
    # type: (Path, int) -> float
    from iscc_search_tpu.engine.device_index import DeviceNphdIndex

    t0 = time.perf_counter()
    idx = DeviceNphdIndex(path)
    rng = np.random.default_rng(7)
    batch = 1 << 20
    for start in range(0, n, batch):
        m = min(batch, n - start)
        vecs = rng.integers(0, 256, (m, 32), dtype=np.uint8)
        idx.add(list(range(start, start + m)), [v.tobytes() for v in vecs])
        print(f"  built {start + m:,}/{n:,}", flush=True)
    idx.save()
    idx.close()
    return time.perf_counter() - t0


def main():
    n = int(float(sys.argv[1])) if len(sys.argv) > 1 else N_DEFAULT
    base = Path(os.environ.get("ISCC_BENCH_DIR", "/tmp/coldstart_idx"))
    path = base / f"n{n}"
    marker = path / "BUILD_OK"
    build_s = None
    if not marker.exists():
        if path.exists():
            shutil.rmtree(path)
        print(f"building {n:,}-row snapshot at {path}...", flush=True)
        build_s = build_snapshot(path, n)
        marker.write_text("ok")
        print(f"built in {build_s:.0f}s", flush=True)

    from iscc_search_tpu.engine.device_index import DeviceNphdIndex

    t0 = time.perf_counter()
    idx = DeviceNphdIndex(path)
    open_s = time.perf_counter() - t0
    assert idx.size == n, idx.size

    rng = np.random.default_rng(11)
    qs = [rng.integers(0, 256, 32, dtype=np.uint8).tobytes() for _ in range(8)]
    t0 = time.perf_counter()
    res = idx.search(qs, 10)
    first_q_s = time.perf_counter() - t0
    assert len(res) == 8 and len(res[0][1]) == 10

    t0 = time.perf_counter()
    idx.search(qs, 10)
    warm_q_ms = (time.perf_counter() - t0) * 1e3

    result = {
        "n": n,
        "build_s": round(build_s, 1) if build_s else "cached",
        "open_s": round(open_s, 2),
        "first_query_s": round(first_q_s, 2),
        "cold_start_s": round(open_s + first_q_s, 2),
        "warm_query_ms": round(warm_q_ms, 1),
        "backend": str(__import__("jax").devices()[0]),
    }
    idx.close()
    print(json.dumps(result, indent=1))
    with open("benchmarks/COLDSTART_10M.json", "w") as f:
        json.dump(result, f, indent=1)


if __name__ == "__main__":
    main()
