#!/usr/bin/env python3
"""Where K1's and K6's time goes on the card: the fused kNN kernel of
raft_tpu_torch at the main-path size, swept over k and over the number
of index splits, beside a plain float32 matmul of the same product; and
the two-phase kernel K6 at k=100 over block_n 1024, 2048 and 4096 beside
K1 at the same shape, with its phase 1 (the per-tile top-128) and its
merge (K2 over the candidates, plus the id gather) timed apart.  Every
row carries the float32-faithful bound of the distance work in 3xTF32 on
the tensor cores and in float32 FFMA; k=1 against k=100 gives the
selection's share of K1.  ``--depths`` instead times K1 alone at k=100
over several depths, with the query tile the kernel takes at each.

    python3 tools/torch_knn_sweep.py [--n 1000000] [--nq 1024] [--d 128]
    python3 tools/torch_knn_sweep.py --n 100000 --depths 300,1000,2000,4096

Prints the card (``nvidia-smi``), the compiler's report of each
instantiation of the fused kNN body (``-Xptxas -v``: registers, spills,
the warnings), K1's and K6's and the work-list instances of K3 and K4,
with the dynamic shared memory a block takes, and one JSON line per
measurement: milliseconds by CUDA events (median of 5 after a warm-up).
Needs a CUDA device; imports nothing of JAX.
"""

import argparse
import json
import re
import statistics
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from raft_tpu_torch.ops import _build, knn_tile  # noqa: E402
from raft_tpu_torch.ops.select_tile import select_tile  # noqa: E402

# the modes of csrc/knn_tile.cuh, by their number
MODES = ("splits (K1)", "tile parts (K6)", "IVF items (K3)", "1-NN items (K4)")
# H100 SXM dense peaks (NVIDIA data sheet)
PEAK_TF32_FLOPS = 495e12
PEAK_FP32_FLOPS = 67e12


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


def ptxas_summary(name):
    """One line per kernel instantiation of ``csrc/<name>.cu``:
    template arguments, registers and spills; then the compiler's
    warnings."""
    log = _build.ptxas_log(name)
    lines, current = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function "
                      r"'.*knn_tile_kernelILi(\d+)ELi(\d+)ELi(\d+)ELb(\d)E", line)
        if m:
            current = tuple(int(v) for v in m.groups())
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and current:
            spills = m.groups()
        m = re.search(r"Used (\d+) registers", line)
        if m and current:
            n_q, nr, mode, bf16 = current
            lines.append("%s N=%d NR=%d mode=%s%s: %s registers at launch, spill stores %s "
                         "bytes, loads %s bytes" % (name, n_q, nr, MODES[mode],
                                                    " bf16" if bf16 else "", m.group(1), *spills))
            current = None
    warnings = sorted({re.sub(r" in the function .*|for the function .*", "", l.strip())
                       for l in log.splitlines() if "warning" in l or re.search(r"C75\d\d", l)
                       and "C7519" not in l})
    return lines + ["%s: %s" % (name, w) for w in warnings]


def depth_sweep(n, nq, depths):
    """K1 at k=100 over ``depths``: the query tile, the time, a float32
    matmul of the same product, and the 3xTF32 bound."""
    _build.build(["knn_tile", "select_tile"])
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    for d in depths:
        x = torch.randn(n, d, device="cuda", generator=gen)
        q = torch.randn(nq, d, device="cuda", generator=gen)
        dp = -(-d // knn_tile.DEPTH_UNIT) * knn_tile.DEPTH_UNIT
        ops = 2.0 * n * nq * d
        print(json.dumps({"n": n, "nq": nq, "d": d, "what": "knn_tile", "k": 100,
                          "block_q": knn_tile.block_q(dp),
                          "bound_tf32x3_ms": 3.0 * ops / PEAK_TF32_FLOPS * 1e3,
                          "matmul_f32_ms": time_ms(lambda: q @ x.T),
                          "ms": time_ms(lambda: knn_tile.fused_knn_tile(x, q, 100))}))
        del x, q


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--nq", type=int, default=1024)
    ap.add_argument("--d", type=int, default=128)
    ap.add_argument("--depths", default="", help="comma-separated depths: K1 alone at each")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("torch_knn_sweep: no CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    if args.depths:
        depth_sweep(args.n, args.nq, [int(d) for d in args.depths.split(",")])
        return
    _build.build(["knn_tile", "knn_twophase", "select_tile", "ivf_tile", "nn_tile"])
    for name in ("knn_tile", "knn_twophase", "ivf_tile", "nn_tile"):
        for line in ptxas_summary(name):
            print(line)
    dp = -(-args.d // knn_tile.DEPTH_UNIT) * knn_tile.DEPTH_UNIT
    print("d=%d: %d queries a block (K1, K6; K4's rows an item); dynamic shared memory a "
          "block %s bytes (K4: k 1, K6: k 128)"
          % (args.d, knn_tile.block_q(dp),
             ", ".join("k %d %d" % (k, knn_tile.smem_bytes(dp, k)) for k in (1, 32, 64, 128))))
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(args.n, args.d, device="cuda", generator=gen)
    q = torch.randn(args.nq, args.d, device="cuda", generator=gen)
    ops = 2.0 * args.n * args.nq * args.d
    base = {"n": args.n, "nq": args.nq, "d": args.d,
            "bound_tf32x3_ms": 3.0 * ops / PEAK_TF32_FLOPS * 1e3,
            "bound_fp32_ms": ops / PEAK_FP32_FLOPS * 1e3}
    print(json.dumps({**base, "what": "matmul_f32", "ms": time_ms(lambda: q @ x.T)}))
    for k in (1, 32, 64, 100, 128):
        print(json.dumps({**base, "what": "knn_tile", "k": k,
                          "blocks_per_sm": knn_tile.BLOCKS_PER_SM,
                          "ms": time_ms(lambda: knn_tile.fused_knn_tile(x, q, k))}))
    default = knn_tile.BLOCKS_PER_SM
    try:
        for bps in (2, 4):
            knn_tile.BLOCKS_PER_SM = bps
            print(json.dumps({**base, "what": "knn_tile", "k": 100, "blocks_per_sm": bps,
                              "ms": time_ms(lambda: knn_tile.fused_knn_tile(x, q, 100))}))
    finally:
        knn_tile.BLOCKS_PER_SM = default
    rows = knn_tile.split_rows(args.nq, args.n,
                               torch.cuda.get_device_properties(0).multi_processor_count,
                               knn_tile.block_q(dp))
    splits = -(-args.n // rows)
    parts = torch.randn(args.nq, splits * 100, device="cuda", generator=gen)
    parts = torch.sort(parts.view(args.nq, splits, 100), dim=2).values.view(args.nq, -1)
    print(json.dumps({**base, "what": "merge_select_tile", "splits": splits,
                      "w": splits * 100, "k": 100,
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
