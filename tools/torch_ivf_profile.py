#!/usr/bin/env python3
"""Where the time of the IVF-Flat paths of raft_tpu_torch goes on the card.

    python3 tools/torch_ivf_profile.py [--out build/ivf_profile]

Draws the Gaussian mixture of ``chip_smoke.py`` on the card (1M x 128,
256 blobs, spread 0.35, seed 0; the last 1024 rows are the queries), then
for ``ivf_flat_build`` (nlist 1024, train_rows 131,072) and
``ivf_flat_search`` (k=100, nprobe 32):

- the time of a warm call without the profiler (host clock, up to a
  synchronize);
- a ``torch.profiler`` trace of one build and of five searches.  From the
  trace alone: the traced window, the device's busy time in it (the union
  of its kernel, copy and fill intervals) and so its idle share, and the
  device time by kernel.  The build's stages are the named ranges that
  ``ivf_flat_build`` and ``kmeans`` open (``ivf_flat_build.*``,
  ``kmeans.*``): for each, the host time of the range, the device busy
  time of the work launched inside it, and its span (range start to the
  end of the later of the range and its last device interval).  The
  profiler slows the host side, so the traced stages are longer than in
  an untraced build.

Prints the card (``nvidia-smi``) and one JSON line per path; the traces go
to ``--out``.  Needs a CUDA device; imports nothing of JAX.
"""

import argparse
import json
import subprocess
import sys
import time
from collections import defaultdict
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from raft_tpu_torch import IVFFlatParams, ivf_flat_build, ivf_flat_search  # noqa: E402
from raft_tpu_torch.ops import _build  # noqa: E402
from raft_tpu_torch.ops.nn_tile import fused_nn_tile  # noqa: E402

N, NQ, D, K = 1_000_000, 1024, 128, 100
NLIST, NPROBE, TRAIN_ROWS = 1024, 32, 131_072
STAGE_PREFIXES = ("ivf_flat_build.", "kmeans.")
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def wall_ms(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


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
    window, busy, top, _ = traced(search5, out / "search.json")
    print(json.dumps({"path": "ivf_search_1M", "ms_per_search": search_ms / 5,
                      "traced_ms_per_search": window / 5, "device_busy_ms_per_search": busy / 5,
                      "device_idle_share": 1.0 - busy / window,
                      "top_kernels": top}))


if __name__ == "__main__":
    main()
