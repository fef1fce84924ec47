#!/usr/bin/env python3
"""Time the host side of the out-of-core tier's tile staging.

    python3 tools/torch_ooc_gather_bench.py [--slots 3309] [--cap 496] [--dim 128]

A store the shape of ``chip_smoke.py``'s ``serve_ann_ooc_1M`` index
(3,309 slots of 496 x 128 float32, 840 MB, random values) and 32-slot
tiles of random slots.  It times, by the host clock (median of 20), the
ways of gathering a tile into a pinned host block:

- ``index_select_3d``: ``torch.index_select`` over the (slots, cap, d)
  store, as ``mr/tile_pool.py`` gathers today;
- ``index_select_2d``: the same over the store viewed (slots, cap * d);
- ``copy_loop``: one ``Tensor.copy_`` a slot;
- ``numpy_take``: ``np.take(..., out=)`` into the pinned block's numpy view;
- ``threads_N``: the slots split over N threads, a ``copy_`` each;

and, with CUDA events, the pinned block's copy to the card.  Prints one
JSON line with the card (``nvidia-smi``), the CPU count and torch's
thread count.
"""

import argparse
import json
import os
import statistics
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

TILE = 32


def host_ms(fn, reps=20):
    fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--slots", type=int, default=3309)
    ap.add_argument("--cap", type=int, default=496)
    ap.add_argument("--dim", type=int, default=128)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_ooc_gather_bench: no CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    gen = torch.Generator().manual_seed(0)
    src = torch.randn(args.slots, args.cap, args.dim, generator=gen)
    store = src.numpy()
    rows = torch.randperm(args.slots, generator=gen)[:TILE]
    rows_np = rows.numpy()
    block = torch.empty((TILE, args.cap, args.dim), pin_memory=True)
    flat_src, flat_block = src.view(args.slots, -1), block.view(TILE, -1)
    want = src[rows]
    out = {"card": card, "cpus": os.cpu_count(), "torch_threads": torch.get_num_threads(),
           "tile_bytes": block.numel() * 4, "store_bytes": src.numel() * 4}

    def loop(lo=0, hi=TILE):
        for j in range(lo, hi):
            block[j].copy_(src[int(rows_np[j])])

    variants = {
        "index_select_3d": lambda: torch.index_select(src, 0, rows, out=block),
        "index_select_2d": lambda: torch.index_select(flat_src, 0, rows, out=flat_block),
        "copy_loop": loop,
        "numpy_take": lambda: np.take(store, rows_np, axis=0, out=block.numpy()),
    }
    pools = {n: ThreadPoolExecutor(n) for n in (2, 4, 8)}
    for n, pool in pools.items():
        cuts = np.linspace(0, TILE, n + 1).astype(int)

        def threaded(pool=pool, cuts=cuts):
            list(pool.map(lambda lo_hi: loop(*lo_hi), zip(cuts[:-1], cuts[1:])))

        variants["threads_%d" % n] = threaded
    gather = {}
    for name, fn in variants.items():
        block.zero_()
        fn()
        assert torch.equal(block, want), name
        ms = host_ms(fn)
        gather[name] = {"ms": ms, "gb_per_s": block.numel() * 4 / ms / 1e6}
    out["gather"] = gather
    dev = torch.device("cuda", 0)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    block.to(dev, non_blocking=True)
    torch.cuda.synchronize()
    times = []
    for _ in range(20):
        start.record()
        block.to(dev, non_blocking=True)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    h2d = statistics.median(times)
    out["h2d"] = {"ms": h2d, "gb_per_s": block.numel() * 4 / h2d / 1e6}
    for pool in pools.values():
        pool.shutdown()
    print(json.dumps(out))


if __name__ == "__main__":
    main()
