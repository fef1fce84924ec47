#!/usr/bin/env python3
"""Where a batch of the out-of-core IVF-Flat search spends its time.

    python3 tools/torch_ooc_profile.py [--batches 8] [--trace-batches 3]

Builds ``chip_smoke.py``'s ``serve_ann_ooc_1M`` index (the 1M x 128
mixture in 2048 lists, train_rows 65,536, seed 0), demotes it to the
out-of-core form, and takes the tile pool and hot set of an
``ANNService(ooc=True)`` at a quarter of the store (threadless, warmed).
Then, for 128-row batches of mixture queries at nprobe 8 and k 100,
double-buffered and synchronous, it prints by the host clock (each batch
ends in a synchronise): the batch's milliseconds, its tiles, and the
default profiler's ``ooc.scan`` and ``ooc.prefetch`` spans (stage and
take); then a ``torch.profiler`` trace of ``--trace-batches`` batches:
the device's busy share, and the top operators by host time and by
device time.  One JSON line, with the card (``nvidia-smi``).
"""

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--batches", type=int, default=8)
    ap.add_argument("--trace-batches", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_ooc_profile: no CUDA device")
    from raft_tpu_torch import ANNService, DistanceType, IVFFlatParams, ivf_flat_build
    from raft_tpu_torch.core import default_profiler
    from raft_tpu_torch.ops import _build
    from raft_tpu_torch.spatial.ooc import ivf_flat_to_ooc, ooc_ivf_flat_search

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    _build.build()
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    centers = torch.randn(256, 128, device=dev, generator=gen) * 4.0

    def mixture(m):
        b = torch.randint(0, 256, (m,), device=dev, generator=gen)
        return centers[b] + torch.randn(m, 128, device=dev, generator=gen) * 0.35

    X = mixture(1_000_000)
    index = ivf_flat_build(X, IVFFlatParams(nlist=2048, nprobe=8), DistanceType.L2SqrtExpanded,
                           seed=0, train_rows=65_536, device=dev)
    budget = int(index.slot_vecs.numel() * 4 * 0.25)
    ooc = ivf_flat_to_ooc(index)
    del index, X
    torch.cuda.empty_cache()
    svc = ANNService(ooc, 100, nprobe=8, nprobe_ladder=(4, 8), bucket_rungs=(8, 32, 64, 128),
                     max_batch_rows=128, compact_rows=0, device_budget_bytes=budget,
                     start=False, device=dev, name="ooc_profile").warmup()
    st = svc._ann_state
    queries = [mixture(128) for _ in range(args.batches + args.trace_batches + 1)]
    out = {"card": card, "ooc": svc.stats()["ooc"]}

    def search(q, overlap):
        return ooc_ivf_flat_search(st.index, q, 100, 8, pool=svc._ooc_pool, hot=st.ooc_hot,
                                   overlap=overlap, device=dev)

    for overlap in (True, False):
        arm = "overlap" if overlap else "sync"
        search(queries[0], overlap)
        torch.cuda.synchronize()
        prof = default_profiler()
        prof.reset()
        staged0 = svc._ooc_pool.n_staged
        times = []
        for q in queries[1:args.batches + 1]:
            t0 = time.perf_counter()
            search(q, overlap)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        scan = prof.tree()["ooc.scan"]
        prefetch = scan.get("children", {}).get("ooc.prefetch", {"total_s": 0.0, "count": 0})
        out[arm] = {"batch_ms": statistics.median(times), "batch_ms_all": times,
                    "tiles_per_batch": (svc._ooc_pool.n_staged - staged0) / args.batches,
                    "scan_span_ms_per_batch": scan["total_s"] * 1e3 / args.batches,
                    "prefetch_span_ms_per_batch": prefetch["total_s"] * 1e3 / args.batches,
                    "prefetch_calls_per_batch": prefetch["count"] / args.batches}
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as tp:
            t0 = time.perf_counter()
            for q in queries[args.batches + 1:]:
                search(q, overlap)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        trace = ROOT / "build" / "ooc_profile_trace.json"
        trace.parent.mkdir(exist_ok=True)
        tp.export_chrome_trace(str(trace))
        events = json.loads(trace.read_text())["traceEvents"]
        trace.unlink()
        # device busy: the union of the kernel, copy and set intervals
        device = [e for e in events if e.get("ph") == "X"
                  and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
        busy, end = 0.0, float("-inf")
        for a, b in sorted((e["ts"], e["ts"] + e["dur"]) for e in device):
            if b > end:
                busy += b - max(a, end)
                end = b
        by_name = {}
        for e in device:
            entry = by_name.setdefault(e["name"][:80], [0.0, 0])
            entry[0] += e["dur"] / 1e3
            entry[1] += 1
        host = tp.key_averages()
        out[arm]["trace"] = {
            "batches": args.trace_batches, "wall_ms": wall, "device_busy_ms": busy / 1e3,
            "device_idle_share": 1.0 - busy / 1e3 / wall, "device_ops": len(device),
            "top_host": [(e.key, e.count, e.self_cpu_time_total / 1e3)
                         for e in sorted(host, key=lambda e: -e.self_cpu_time_total)[:12]],
            "top_device": sorted(([n, ms, c] for n, (ms, c) in by_name.items()),
                                 key=lambda r: -r[1])[:8]}
    svc.close()
    print(json.dumps(out))


if __name__ == "__main__":
    main()
