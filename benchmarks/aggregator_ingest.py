"""
Aggregator-path ingest benchmark: >=1M records through the REAL pipeline.

The reference's aggregator exists for 100M-record networks
(/root/reference/iscc_search/aggregator/poller.py:6-10); this measures what
this repo's poller actually sustains end to end: FakeLog hub (in-process
httpx MockTransport serving tlog-tiles bundles) -> poll_loop -> bundle fetch
+ parse -> record_to_entry -> index.add_assets (real tpu:// engine: native
store + device NPHD partitions) -> store-durability barrier -> durable
cursor save. Reports assets/s plus a stall profile (slowest bundle batches).

Run: [PYTHONPATH=.] python benchmarks/aggregator_ingest.py [n_records]
(CPU JAX works too: JAX_PLATFORMS=cpu for the host-side number.)
"""

import asyncio
import hashlib
import json
import os
import struct
import sys
import tempfile
import time

import httpx

from iscc_search_tpu import codec as ic
from iscc_search_tpu.aggregator import entry as entry_mod
from iscc_search_tpu.aggregator import poller, tlog
from iscc_search_tpu.aggregator.cursors import cursor_store_for
from iscc_search_tpu.options import SearchOptions, get_index

HUBS_YAML = """\
version: 1
network: testnet
hubs:
  - hub_id: 0
    url: https://hub0.example
    active: true
"""


def gen_records(n):
    # type: (int) -> list[bytes]
    """Synthetic declaration records (valid, unique, minimal codec work)."""
    records = []
    t0 = time.perf_counter()
    for i in range(1, n + 1):
        iscc_id = ic.gen_iscc_id_v1(timestamp_us=i, server_id=i % 4096, realm_id=0)["iscc"]
        body = hashlib.blake2b(str(i).encode(), digest_size=8).digest()
        data_unit = "ISCC:" + ic.encode_base32(
            ic.encode_header(ic.MT.DATA, 0, ic.VS.V0, ic.encode_length(ic.MT.DATA, 64)) + body
        )
        datahash = "1e20" + hashlib.sha256(str(i).encode()).hexdigest()
        code = ic.gen_iscc_code_v0(
            [data_unit, "ISCC:" + ic.encode_component(ic.MT.INSTANCE, 0, 0, 64, bytes.fromhex(datahash[4:]))],
            wide=False,
        )["iscc"]
        note = {"$schema": entry_mod.DECLARATION_SCHEMA, "iscc_code": code, "datahash": datahash}
        records.append(json.dumps({"iscc_id": iscc_id, "note": note}).encode())
    return records, time.perf_counter() - t0


class FakeLog:
    """In-memory tlog-tiles hub server (mirrors tests/test_aggregator.py)."""

    def __init__(self, records):
        self.records = records
        self.bundle_times = []  # (bundle_index, seconds) per entries fetch gap

    def handler(self, request):
        path = request.url.path
        if path == "/hubs.yaml":
            return httpx.Response(200, text=HUBS_YAML)
        if path == "/log/checkpoint":
            return httpx.Response(200, text=f"origin\n{len(self.records)}\nhash\n")
        if path.startswith("/log/tile/entries/"):
            seg = path[len("/log/tile/entries/") :]
            if ".p/" in seg:
                idx_s, width_s = seg.split(".p/")
                width = int(width_s)
            else:
                idx_s, width = seg, 0
            index = int(idx_s.replace("x", "").replace("/", ""))
            start = index * tlog.TILE_WIDTH
            count = width or tlog.TILE_WIDTH
            chunk = self.records[start : start + count]
            body = b"".join(struct.pack(">H", len(r)) + r for r in chunk)
            self.bundle_times.append((index, time.perf_counter()))
            return httpx.Response(200, content=body)
        return httpx.Response(404)


def main():
    n = int(float(sys.argv[1])) if len(sys.argv) > 1 else 1_000_000
    print(f"generating {n:,} records...", flush=True)
    records, gen_s = gen_records(n)
    print(f"generated in {gen_s:.1f}s ({n/gen_s:,.0f} rec/s)", flush=True)

    tmp = tempfile.mkdtemp(prefix="agg_bench_")
    opts = SearchOptions(
        index_uri=f"tpu://{tmp}",
        aggregator_mode=True,
        aggregator_network="testnet",
        aggregator_hub_list_url="https://hub0.example/hubs.yaml",
        aggregator_poll_interval=3600,  # one pass, then idle -> we stop
    )
    index = get_index(opts.index_uri)
    from iscc_search_tpu.schema import IsccIndex

    index.create_index(IsccIndex(name=opts.aggregator_index_name))

    fake = FakeLog(records)
    client = httpx.AsyncClient(transport=httpx.MockTransport(fake.handler))
    status = {}
    stop = asyncio.Event()
    cursor_store = cursor_store_for(opts)

    async def drive():
        t0 = time.perf_counter()
        task = asyncio.create_task(
            poller.poll_loop(index, opts, stop, client, status, cursor_store=cursor_store)
        )
        # Wait until the single hub's cursor reaches the full log, then stop.
        while True:
            await asyncio.sleep(0.5)
            state = status.get(0)
            done = state is not None and state.cursor >= n
            if done or task.done():
                break
            el = time.perf_counter() - t0
            if state and state.cursor:
                print(
                    f"  cursor {state.cursor:,}/{n:,}  {state.cursor/el:,.0f} assets/s", flush=True
                )
        stop.set()
        await task
        return time.perf_counter() - t0

    ingest_s = asyncio.run(drive())
    state = status[0]
    assert state.cursor >= n, f"poller stalled at {state.cursor}"
    assert state.counts.get("ok") == n, state.counts

    # Stall profile: per-bundle wall-clock gaps (fetch-to-fetch ~ one
    # convert+add_assets+barrier cycle each)
    gaps = []
    times = fake.bundle_times
    for (b0, t0), (b1, t1) in zip(times, times[1:]):
        gaps.append((round((t1 - t0) * 1e3, 1), b0))
    gaps.sort(reverse=True)
    stats = index.get_index(opts.aggregator_index_name)

    result = {
        "n_records": n,
        "gen_s": round(gen_s, 1),
        "ingest_s": round(ingest_s, 1),
        "assets_per_s": round(n / ingest_s),
        "bundles": len(times),
        "slowest_bundles_ms": gaps[:10],
        "median_bundle_ms": sorted(g for g, _ in gaps)[len(gaps) // 2] if gaps else None,
        "indexed_assets": stats.assets,
        "durability": "store sync barrier + durable cursor save per advanced poll",
        "convert_workers": opts.aggregator_convert_workers,
        "host_cores": os.cpu_count(),
    }
    index.close()
    print(json.dumps(result, indent=1))
    with open("benchmarks/AGGREGATOR_INGEST.json", "w") as f:
        json.dump(result, f, indent=1)


if __name__ == "__main__":
    main()
