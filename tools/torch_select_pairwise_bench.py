#!/usr/bin/env python3
"""K2 (select_tile) at every shape the paths of ``chip_smoke.py`` launch
it at, and K5 (pairwise_tile) at the L1 path's shape, timed on the card
beside their PyTorch yardsticks, for comparing two trees in one run.

    python3 tools/torch_select_pairwise_bench.py [--root DIR] [--label NAME]

Imports ``raft_tpu_torch`` from DIR (default: this checkout), so that an
older tree unpacked beside this one is timed by the same script on the
same card: run it as parent, change, change, parent.  K2's shapes are the
merges of K1's index splits at every served batch size (rows 8 to 1024,
over the 1M index), of four partitions, of K3's 160 steps and of K6's 489
tiles, on concatenated sorted runs of k (of 128 for K6), and the IVF
probe and the L1 select on normal keys; K5 runs L1, L2Unexpanded and
Linf on 1024 x 128 against 100,000 x 128.  The inputs are drawn on the
card from seed 0, the same in every tree.

Prints the card (``nvidia-smi``) and one JSON line: milliseconds by CUDA
events, the median of 20 (K2) or 5 (K5) single calls after a warm-up,
and for K2 also ``queued_ms``: 20 calls enqueued while the card spins,
then run back to back (a call's device time, which a single call's
launch on the host hides for kernels of tens of microseconds); with
``torch.topk`` / ``torch.cdist(p=1)`` beside, and the SM clock and power
right after the K5 timing.  Needs a CUDA device; imports nothing of JAX.
"""

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

import torch

# (rows, width, k, run of the sorted runs or None for normal keys): the
# shapes the paths launch K2 at (PERF.md section 4)
K2_SHAPES = [(8, 13_200, 100, 100), (64, 13_200, 100, 100), (128, 6_600, 100, 100),
             (256, 3_300, 100, 100), (512, 1_600, 100, 100), (1024, 800, 100, 100),
             (1024, 400, 100, 100), (1024, 1_024, 32, None), (1024, 16_000, 100, 100),
             (1024, 62_592, 100, 128), (1024, 100_000, 100, None)]
K5_SHAPE = (1024, 100_000, 128)


def smi(query):
    return subprocess.run(["nvidia-smi", "--query-gpu=" + query, "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()


def time_ms(fn, reps):
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def queued_ms(fn, calls=20):
    fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(8_000_000)
    a.record()
    for _ in range(calls):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / calls


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--label", default="tree")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("no CUDA device")
    sys.path.insert(0, args.root)
    from raft_tpu_torch import DistanceType as D
    from raft_tpu_torch.ops import _build
    from raft_tpu_torch.ops.pairwise_tile import pairwise_tile
    from raft_tpu_torch.ops.select_tile import select_tile

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    _build.build(["select_tile", "pairwise_tile"])
    out = {"label": args.label, "root": args.root, "card": smi("name,power.limit"),
           "select_tile": [], "pairwise_tile": {}}
    for m, w, k, run in K2_SHAPES:
        if run:
            keys = torch.sort(torch.randn(m, w // run, run, device=dev, generator=gen),
                              dim=2).values.reshape(m, w)
        else:
            keys = torch.randn(m, w, device=dev, generator=gen)

        def topk():
            return torch.topk(keys, k, dim=1, largest=False)

        out["select_tile"].append({
            "rows": m, "width": w, "k": k, "keys": "sorted runs of %d" % run if run else "normal",
            "ms": time_ms(lambda: select_tile(keys, k), 20),
            "queued_ms": queued_ms(lambda: select_tile(keys, k)),
            "library_ms": time_ms(topk, 20), "library_queued_ms": queued_ms(topk)})
    m, n, d = K5_SHAPE
    x = torch.randn(m, d, device=dev, generator=gen)
    y = torch.randn(n, d, device=dev, generator=gen)
    for metric in (D.L1, D.L2Unexpanded, D.Linf):
        out["pairwise_tile"][metric.name] = time_ms(lambda: pairwise_tile(x, y, metric), 5)
    out["pairwise_tile"]["clocks_sm_power_after"] = smi("clocks.sm,power.draw")
    out["pairwise_tile"]["library_ms"] = time_ms(lambda: torch.cdist(x, y, p=1), 5)
    print(out["card"])
    print(json.dumps(out))


if __name__ == "__main__":
    main()
