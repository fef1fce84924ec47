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
``--splits`` instead times K1 alone at each of the given numbers of index
splits, over the query counts of ``--nqs`` and k 100 and 10, beside the
waves its blocks take and K2's merge of the splits, and fits the grid's
cost model (``ops/knn_tile.py:grid_time``) to the times.

    python3 tools/torch_knn_sweep.py [--n 1000000] [--nq 1024] [--d 128]
    python3 tools/torch_knn_sweep.py --n 100000 --depths 300,1000,2000,4096
    python3 tools/torch_knn_sweep.py --splits 1,2,3,4,5,6,7,8,16 --nqs 10000,1024

Prints the card (``nvidia-smi``), the compiler's report of each
instantiation of the fused kNN body (``-Xptxas -v``: registers, spills,
the warnings), K1's and K6's and the work-list instances of K3 and K4,
with the dynamic shared memory a block takes, and one JSON line per
measurement: milliseconds by CUDA events (median of 5 after a warm-up;
of 20 with ``--splits``).  Needs a CUDA device; imports nothing of JAX.
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

from raft_tpu_torch.core import tracing  # noqa: E402
from raft_tpu_torch.ops import _build, knn_tile  # noqa: E402
from raft_tpu_torch.ops.select_tile import select_tile  # noqa: E402

# the modes of csrc/knn_tile.cuh, by their number
MODES = ("splits (K1)", "tile parts (K6)", "IVF items (K3)", "1-NN items (K4)")
# H100 SXM dense peaks (NVIDIA data sheet)
PEAK_TF32_FLOPS = 495e12
PEAK_FP32_FLOPS = 67e12
# the SM clock at which the phase counters' cycles are read as seconds
SM_HZ = 1.98e9


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


def split_sweep(n, d, nqs, splits, ks, reps=20, phase_splits=(1, 5, 8)):
    """K1 alone at each number of index splits (the C entry at
    ``ceil(ceil(n / 64) / s) * 64`` rows a split), over the query counts
    ``nqs`` and ``ks``: its blocks, the waves they take, waves x the
    share of the index a block reads, the time, the time a block spends
    on each of its index tiles, and K2's merge of the partials with the
    gather of their ids.  At the first query count and k, the splits of
    ``phase_splits`` also run the phase-timed instance once: the
    multiplier's ring waits and the share of the SMs the blocks hold.
    Then the least-squares fit of a tile's seconds and a block's (what
    ``block_seconds`` gives at that k) to the times at each query count
    and k, and of the merge's seconds a column."""
    _build.build(["knn_tile", "select_tile"])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    slots = knn_tile.BLOCKS_PER_SM * sms
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(n, d, device="cuda", generator=gen)
    xp, _, _, xn = knn_tile.prepare_operands(x, x[:1])
    units = -(-n // knn_tile.BLOCK_N)
    rows_out, merges = [], []
    for nq in nqs:
        q = torch.randn(nq, d, device="cuda", generator=gen)
        _, qp, qn, _ = knn_tile.prepare_operands(x[:1], q)
        n_q = knn_tile.block_q(qp.shape[1])
        q_tiles = -(-nq // n_q)
        for k in ks:
            for s in splits:
                per = -(-units // s)
                rows = per * knn_tile.BLOCK_N
                got = -(-n // rows)
                blocks = q_tiles * got
                waves = -(-blocks // slots)

                def k1():
                    return knn_tile.split_partials(xp, qp, qn, xn, k, rows)
                part_d, part_i = k1()
                row = {"n": n, "nq": nq, "d": d, "k": k, "splits": got, "tiles_per_block": per,
                       "blocks": blocks, "waves": waves, "wave_fill": blocks / (waves * slots),
                       "waves_x_share": waves * per / units, "ms": time_ms(k1, reps),
                       "one_wave_rule_splits": min(units, max(1, slots // q_tiles))}
                row["ms_per_tile"] = row["ms"] / (waves * per)
                if got > 1:
                    def merge():
                        out_d, pos = select_tile(part_d, k)
                        return out_d, torch.gather(part_i, 1, pos.long())
                    row["merge_ms"] = time_ms(merge, reps)
                    merges.append((nq * got * k, row["merge_ms"]))
                if nq == nqs[0] and k == ks[0] and got in phase_splits:
                    with tracing.kernel_phases() as table:
                        k1()
                    (entry,) = table.values()
                    mma = entry["cycles"]["mma"]
                    row["mma_wait_load_pct"] = entry["shares"]["mma"]["wait_load"]
                    row["mma_issue_pct"] = entry["shares"]["mma"]["issue"]
                    row["sms_busy_pct"] = 100.0 * mma["total"] / 4 / SM_HZ / (
                        sms * entry["seconds"])
                print(json.dumps(row), flush=True)
                rows_out.append(row)
                del part_d, part_i
        del q, qp, qn
    for nq in nqs:
        for k in ks:
            mine = [r for r in rows_out if r["nq"] == nq and r["k"] == k]
            a = torch.tensor([[r["waves"] * r["tiles_per_block"], r["waves"]] for r in mine],
                             dtype=torch.float64)
            b = torch.tensor([[r["ms"] * 1e-3] for r in mine], dtype=torch.float64)
            tile_s, block_s = torch.linalg.lstsq(a, b).solution.flatten().tolist()
            print(json.dumps({"fit": "grid_time", "n": n, "nq": nq, "k": k, "tile_s": tile_s,
                              "block_s": block_s}))
    if merges:
        cols = torch.tensor([c for c, _ in merges], dtype=torch.float64)
        secs = torch.tensor([m * 1e-3 for _, m in merges], dtype=torch.float64)
        print(json.dumps({"fit": "merge", "column_s": float((cols @ secs) / (cols @ cols)),
                          "points": len(merges)}))


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--nq", type=int, default=1024)
    ap.add_argument("--d", type=int, default=128)
    ap.add_argument("--depths", default="", help="comma-separated depths: K1 alone at each")
    ap.add_argument("--splits", default="",
                    help="comma-separated index split counts: K1 alone at each")
    ap.add_argument("--nqs", default="10000,1024,4096,8192",
                    help="comma-separated query counts for --splits")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("torch_knn_sweep: no CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    if args.depths:
        depth_sweep(args.n, args.nq, [int(d) for d in args.depths.split(",")])
        return
    if args.splits:
        split_sweep(args.n, args.d, [int(v) for v in args.nqs.split(",")],
                    [int(v) for v in args.splits.split(",")], (100, 10))
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
                               knn_tile.block_q(dp), 100)
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
