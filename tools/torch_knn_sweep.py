#!/usr/bin/env python3
"""Where K1's time goes on the card: the fused kNN kernel of
raft_tpu_torch at the main-path size, swept over k and over the number
of index splits, beside a plain float32 matmul of the same product; and
the two-phase kernel K6 at k=100 over block_n 1024, 2048 and 4096 beside
K1 at the same shape, with its phase 1 (the per-tile top-128) and its
merge (K2 over the candidates, plus the id gather) timed apart.

    python3 tools/torch_knn_sweep.py [--n 1000000] [--nq 1024] [--d 128]

Prints the card (``nvidia-smi``) and one JSON line per measurement:
milliseconds by CUDA events (median of 5 after a warm-up).  Needs a CUDA
device; imports nothing of JAX.
"""

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from raft_tpu_torch.ops import knn_tile  # noqa: E402
from raft_tpu_torch.ops.select_tile import select_tile  # noqa: E402


def time_ms(fn, reps=5):
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


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--nq", type=int, default=1024)
    ap.add_argument("--d", type=int, default=128)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("torch_knn_sweep: no CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(args.n, args.d, device="cuda", generator=gen)
    q = torch.randn(args.nq, args.d, device="cuda", generator=gen)
    base = {"n": args.n, "nq": args.nq, "d": args.d}
    print(json.dumps({**base, "what": "matmul_f32", "ms": time_ms(lambda: q @ x.T)}))
    for k in (1, 32, 64, 100, 128):
        print(json.dumps({**base, "what": "knn_tile", "k": k,
                          "blocks_per_sm": knn_tile.BLOCKS_PER_SM,
                          "ms": time_ms(lambda: knn_tile.fused_knn_tile(x, q, k))}))
    default = knn_tile.BLOCKS_PER_SM
    try:
        for bps in (1, 2, 8, 16):
            knn_tile.BLOCKS_PER_SM = bps
            print(json.dumps({**base, "what": "knn_tile", "k": 100, "blocks_per_sm": bps,
                              "ms": time_ms(lambda: knn_tile.fused_knn_tile(x, q, 100))}))
    finally:
        knn_tile.BLOCKS_PER_SM = default
    rows = knn_tile.split_rows(args.nq, args.n,
                               torch.cuda.get_device_properties(0).multi_processor_count)
    splits = -(-args.n // rows)
    parts = torch.randn(args.nq, splits * 100, device="cuda", generator=gen)
    parts = torch.sort(parts.view(args.nq, splits, 100), dim=2).values.view(args.nq, -1)
    print(json.dumps({**base, "what": "merge_select_tile", "w": splits * 100, "k": 100,
                      "ms": time_ms(lambda: select_tile(parts, 100))}))
    del parts
    # K6 beside K1: does the carry-free tile (every tile's buffer starts
    # cold) or K1's running buffer cost less on this card?
    for block_n in (1024, 2048, 4096):
        bn, n_tiles = knn_tile.twophase_geometry(args.n, block_n)
        part_d, part_i = knn_tile.twophase_tiles(x, q, bn)
        print(json.dumps({
            **base, "what": "knn_twophase", "k": 100, "block_n": block_n, "bn": bn,
            "n_tiles": n_tiles, "candidates": n_tiles * knn_tile.TWOPHASE_PAD,
            "ms": time_ms(lambda: knn_tile.fused_knn_twophase(x, q, 100, block_n=block_n)),
            "phase1_ms": time_ms(lambda: knn_tile.twophase_tiles(x, q, bn)),
            "merge_ms": time_ms(lambda: knn_tile._twophase_merge(part_d, part_i, 100, args.n)),
            "knn_tile_ms": time_ms(lambda: knn_tile.fused_knn_tile(x, q, 100))}))
        del part_d, part_i


if __name__ == "__main__":
    main()
