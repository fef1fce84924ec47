#!/usr/bin/env python3
"""Where the time of the IVF-Flat paths of raft_tpu_torch goes on the card.

    python3 tools/torch_ivf_profile.py [--out build/ivf_profile] [--widths 64,32,16]
        [--serve-ann] [--ann-nprobe 4,8]

Draws the Gaussian mixture of ``chip_smoke.py`` on the card (1M x 128,
256 blobs, spread 0.35, seed 0; the last 1024 rows are the queries), then
for ``ivf_flat_build`` (nlist 1024, train_rows 131,072) and
``ivf_flat_search`` (k=100, nprobe 32):

- the time of a warm call without the profiler (host clock, up to a
  synchronize);
- a ``torch.profiler`` trace of one build and of five searches.  From the
  trace alone: the traced window, the device's busy time in it (the union
  of its kernel, copy and fill intervals) and so its idle share, and the
  device time by kernel.  The stages are the named ranges that the entry
  points open: the build's (``ivf_flat_build.*``, ``kmeans.*``) and the
  search's probe (``ivf_flat_search.probe``) and the three steps of K3
  (``fused_ivf_scan.work_list``, the inversion of the scan lists by torch
  ops; ``.kernel``; ``.merge``, K2 and the id gather).  For each: the
  host time of the range, the device busy time of the work launched
  inside it, and its span (range start to the end of the later of the
  range and its last device interval); the search's are per search.  The
  profiler slows the host side, so the traced stages are longer than in
  an untraced run.

Then, by CUDA events (median of 5 after a warm-up): the whole
``fused_ivf_scan`` at the search's scan lists, and K4 at the build's
assignment (the training rows against the centroids); and for each
work-item width of ``--widths`` (the entries of the scan lists a K3 item
holds: the search's scan lists cut by ``scan_work_list`` at that width),
K3's kernel alone at k = 100 and at k = 1 (where the selection costs
next to nothing), with the item count.

With ``--serve-ann``, one more line: ``ANNService`` over the same index
at the settings of ``chip_smoke.py``'s ``serve_ann_1M`` (k 100, rungs
8/32/64/128), served threadless: the host and device time of one
128-row search at each ``--ann-nprobe`` (a host clock up to a
synchronize, the host clock of the enqueue alone, and CUDA events), then
a trace of 20 full batches of 128 rows formed and dispatched by the
worker (``worker.run_once``): the device's busy and idle share, time by
kernel, and the stages as above.

Prints the card (``nvidia-smi``) and one JSON line per path and per
width; the traces go to ``--out``.  Needs a CUDA device; imports nothing
of JAX.
"""

import argparse
import json
import statistics
import subprocess
import sys
import time
from collections import defaultdict
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from raft_tpu_torch import (ANNService, IVFFlatParams, approx_knn_search,  # noqa: E402
                            ivf_flat_build, ivf_flat_search)
from raft_tpu_torch.ops import _build  # noqa: E402
from raft_tpu_torch.ops.ivf_tile import fused_ivf_scan, ivf_items, scan_work_list  # noqa: E402
from raft_tpu_torch.ops.nn_tile import fused_nn_tile  # noqa: E402
from raft_tpu_torch.spatial.ann import _probe_compact  # noqa: E402

N, NQ, D, K = 1_000_000, 1024, 128, 100
NLIST, NPROBE, TRAIN_ROWS = 1024, 32, 131_072
STAGE_PREFIXES = ("ivf_flat_build.", "kmeans.", "ivf_flat_search.", "fused_ivf_scan.")
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def wall_ms(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def events_ms(fn, reps=5):
    """Median milliseconds of ``fn`` on the card, by CUDA events."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def union_ms(spans):
    """Milliseconds covered by the union of (start, end) microsecond spans."""
    busy, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy / 1e3


def traced(fn, trace_path):
    """Trace one run of ``fn``: (window ms, device busy ms, top kernels
    [(name, device ms, count)], stages {name: {host_ms, device_busy_ms,
    span_ms}}), all from the one traced run."""
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, window = wall_ms(fn)
    prof.export_chrome_trace(str(trace_path))
    events = [e for e in json.loads(trace_path.read_text())["traceEvents"]
              if e.get("ph") == "X"]
    device = [e for e in events if e.get("cat") in DEVICE_CATS]
    by_kernel = defaultdict(lambda: [0.0, 0])
    for e in device:
        if e["cat"] == "kernel":
            by_kernel[e["name"][:80]][0] += e["dur"] / 1e3
            by_kernel[e["name"][:80]][1] += 1
    top = sorted(([name, ms, n] for name, (ms, n) in by_kernel.items()),
                 key=lambda r: -r[1])[:8]
    # a device interval belongs to the stage whose range holds its launch
    launch_ts = {e["args"]["correlation"]: e["ts"] for e in events
                 if e.get("cat") == "cuda_runtime" and "correlation" in e.get("args", {})}
    ranges = [e for e in events if e.get("cat") == "user_annotation"
              and e["name"].startswith(STAGE_PREFIXES)]
    spans = defaultdict(list)
    for e in device:
        ts = launch_ts.get(e.get("args", {}).get("correlation"))
        owner = next((r["name"] for r in ranges
                      if ts is not None and r["ts"] <= ts <= r["ts"] + r["dur"]), "other")
        spans[owner].append((e["ts"], e["ts"] + e["dur"]))
    stages = {}
    for r in sorted(ranges, key=lambda r: r["ts"]):
        own = spans.get(r["name"], [])
        end = max([r["ts"] + r["dur"]] + [b for _, b in own])
        s = stages.setdefault(r["name"], {"host_ms": 0.0, "device_busy_ms": 0.0, "span_ms": 0.0})
        s["host_ms"] += r["dur"] / 1e3
        s["span_ms"] += (end - r["ts"]) / 1e3
    for name, s in stages.items():
        s["device_busy_ms"] = union_ms(spans.get(name, []))
    if spans.get("other"):
        stages["other"] = {"device_busy_ms": union_ms(spans["other"])}
    busy = union_ms([(e["ts"], e["ts"] + e["dur"]) for e in device])
    return window, busy, top, stages


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="build/ivf_profile")
    ap.add_argument("--widths", default="64,32,16",
                    help="comma-separated work-item widths for K3")
    ap.add_argument("--serve-ann", action="store_true",
                    help="also profile ANNService's served batches")
    ap.add_argument("--ann-nprobe", default="4,8",
                    help="comma-separated probe counts of the served batches")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("torch_ivf_profile: no CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    _build.build()
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    centers = torch.randn(256, D, device=dev, generator=gen) * 4.0
    blob = torch.randint(0, 256, (N + NQ,), device=dev, generator=gen)
    mixture = centers[blob] + torch.randn(N + NQ, D, device=dev, generator=gen) * 0.35
    X, q = mixture[:N], mixture[N:]
    params = IVFFlatParams(nlist=NLIST, nprobe=NPROBE)

    def build():
        return ivf_flat_build(X, params, train_rows=TRAIN_ROWS, device=dev)

    index, first_ms = wall_ms(build)            # loads the kernels
    _, build_ms = wall_ms(build)
    fused_nn_tile.launches = 0
    window, busy, top, stages = traced(build, out / "build.json")
    # K4 runs every k-means assignment: the first, then one per Lloyd iteration
    print(json.dumps({"path": "ivf_build_1M", "first_ms": first_ms, "ms": build_ms,
                      "lloyd_iters": fused_nn_tile.launches - 1,
                      "traced_ms": window, "device_busy_ms": busy,
                      "device_idle_share": 1.0 - busy / window,
                      "stages_traced": stages, "top_kernels": top}))

    def search5():
        for _ in range(5):
            ivf_flat_search(index, q, K, device=dev)

    search5()
    _, search_ms = wall_ms(search5)
    window, busy, top, stages = traced(search5, out / "search.json")
    per_search = {name: {key: v / 5 for key, v in st.items()} for name, st in stages.items()}
    print(json.dumps({"path": "ivf_search_1M", "ms_per_search": search_ms / 5,
                      "traced_ms_per_search": window / 5, "device_busy_ms_per_search": busy / 5,
                      "device_idle_share": 1.0 - busy / window,
                      "stages_traced_per_search": per_search, "top_kernels": top}))

    slots, _ = _probe_compact(q, index.centroids, index.cent_slots, NPROBE)
    scan_args = (q, index.slot_vecs, index.slot_norms, index.slot_ids, slots, K)
    S, cap = index.slot_ids.shape
    xs = X[:TRAIN_ROWS]
    print(json.dumps({"k3_whole_ms": events_ms(lambda: fused_ivf_scan(*scan_args)),
                      "k4_ms": events_ms(lambda: fused_nn_tile(xs, index.centroids))}))
    n_out = NQ * slots.shape[1]
    for width in [int(w) for w in args.widths.split(",")]:
        work = scan_work_list(slots, S, cap, width)
        store = (q, index.slot_vecs.reshape(S * cap, D), index.slot_norms.reshape(-1),
                 index.slot_ids.reshape(-1), work, cap)
        print(json.dumps({"width": width, "k3_items": int(work.n_items),
                          "k3_kernel_ms": events_ms(lambda: ivf_items(*store, K, n_out)),
                          # k = 1: the selection's share is the difference
                          "k3_kernel_k1_ms": events_ms(lambda: ivf_items(*store, 1, n_out))}))
    if args.serve_ann:
        serve_ann(index, X, gen, [int(p) for p in args.ann_nprobe.split(",")], out)


def serve_ann(index, X, gen, cells, out):
    """Time and trace ANNService's batches of 128 rows (module doc)."""
    rows, riders, batches = 128, 8, 20
    dev = X.device
    pool = X[torch.randint(0, N, (batches * rows,), device=dev, generator=gen)]
    pool = pool + torch.randn(pool.shape, device=dev, generator=gen) * 0.35
    for nprobe in cells:
        svc = ANNService(index, K, nprobe=nprobe, nprobe_ladder=(nprobe,),
                         bucket_rungs=(8, 32, 64, 128), max_batch_rows=rows, max_wait_ms=2.0,
                         compact_rows=0, start=False, device=dev)
        svc.warmup()
        q = pool[:rows]
        _, search_ms = wall_ms(lambda: approx_knn_search(index, q, K, nprobe=nprobe, device=dev))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        approx_knn_search(index, q, K, nprobe=nprobe, device=dev)
        enqueue_ms = (time.perf_counter() - t0) * 1e3
        device_ms = events_ms(lambda: approx_knn_search(index, q, K, nprobe=nprobe, device=dev))

        def serve_batches():
            for b in range(batches):
                futs = [svc.submit(x) for x in pool[b * rows:(b + 1) * rows].split(rows // riders)]
                assert svc.worker.run_once()
                for f in futs:
                    f.result(timeout=60)

        serve_batches()
        _, served_ms = wall_ms(serve_batches)
        window, busy, top, stages = traced(serve_batches, out / ("serve_ann_%d.json" % nprobe))
        svc.close()
        per_batch = {name: {key: v / batches for key, v in st.items()}
                     for name, st in stages.items()}
        print(json.dumps({"path": "serve_ann_1M batches", "nprobe": nprobe, "rows": rows,
                          "search_ms": search_ms, "search_enqueue_ms": enqueue_ms,
                          "search_events_ms": device_ms, "served_ms_per_batch": served_ms / batches,
                          "traced_ms_per_batch": window / batches,
                          "device_busy_ms_per_batch": busy / batches,
                          "device_idle_share": 1.0 - busy / window,
                          "stages_traced_per_batch": per_batch, "top_kernels": top}))

if __name__ == "__main__":
    main()
