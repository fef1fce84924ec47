#!/usr/bin/env python3
"""Smoke run of raft_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from ``raft_tpu_torch/ops/csrc`` with nvcc, holds
each kernel against its plain PyTorch version on the card, drives the
main path (exact brute-force kNN, 1M x 128 float32, 1024 queries, k=100)
through ``brute_force_knn(device="cuda")`` in one partition and in four,
and the L1 path (pairwise K5 + select K2) at 100k x 128; checks that each
path launched its kernels, and times every kernel beside its plain
version and a single-call PyTorch yardstick.  Any failure raises, and the
script exits non-zero without the final line.  It needs a CUDA device and
the repository beside it.

Output: the card (``nvidia-smi``), versions, build seconds, one line per
check, a ``paths`` JSON line (launches and end-to-end milliseconds per
path), a ``kernels`` JSON line, and last ``{"ok": true, "device": ...}``.
"""

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
SEED = 0
N_INDEX, N_QUERIES, DIM, K = 1_000_000, 1024, 128, 100
N_L1 = 100_000
N_CHECK = 128              # main-path queries held against the plain version
# H100 SXM peaks (NVIDIA data sheet): float32 outside the tensor cores, HBM3
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES = 3.35e12


def card_line():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps, warmup=1):
    """Median milliseconds of ``fn`` on the card, by CUDA events."""
    for _ in range(warmup):
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


def bound(ops, nbytes):
    """Least time (ms) for ``ops`` float32 operations and ``nbytes`` of
    device-memory traffic, and which of the two bounds it."""
    t_ops, t_bytes = ops / PEAK_FP32_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def check_knn(name, got_d, got_i, ref_d, ref_i, atol):
    """Distances within ``atol``; ids equal as per-row sets except at a
    tie (within ``atol``) with the k-th reference distance.  Returns the
    largest distance error."""
    assert got_d.shape == ref_d.shape and got_i.dtype == torch.int32, name
    assert torch.isfinite(got_d).all(), name
    err = (got_d - ref_d).abs().max().item()
    assert err <= atol, "%s: distance error %g > %g" % (name, err, atol)
    same = (torch.sort(got_i, dim=1).values == torch.sort(ref_i, dim=1).values).all(dim=1)
    for row in torch.nonzero(~same).flatten().tolist():
        extra = set(got_i[row].tolist()) - set(ref_i[row].tolist())
        kth = ref_d[row, -1].item()
        for col, idx in enumerate(got_i[row].tolist()):
            if idx in extra:
                assert abs(got_d[row, col].item() - kth) <= atol, (
                    "%s: row %d id %d is no tie at the k-th distance" % (name, row, idx))
    return err


def check_exact(name, got, ref):
    assert got.shape == ref.shape and got.dtype == ref.dtype, name
    assert torch.equal(got, ref), "%s: kernel and plain version differ" % name


def main():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device (torch.cuda.is_available() is False)")
    if not (ROOT / "raft_tpu_torch" / "ops" / "csrc").is_dir():
        sys.exit("chip_smoke: raft_tpu_torch not found beside %s" % __file__)
    sys.path.insert(0, str(ROOT))
    from raft_tpu_torch import DistanceType, brute_force_knn
    from raft_tpu_torch.ops import _build
    from raft_tpu_torch.ops.knn_tile import fused_knn_tile, knn_tile_plain
    from raft_tpu_torch.ops.pairwise_tile import (METRICS, pairwise_tile,
                                                  pairwise_tile_plain)
    from raft_tpu_torch.ops.select_tile import select_tile, select_tile_plain

    D = DistanceType
    wrappers = {"knn_tile": fused_knn_tile, "select_tile": select_tile,
                "pairwise_tile": pairwise_tile}

    def reset():
        for w in wrappers.values():
            w.launches = 0

    def counts():
        return {name: w.launches for name, w in wrappers.items()}

    card = card_line()
    print(card)
    print("torch %s, CUDA %s, %s, %d device(s)" % (
        torch.__version__, torch.version.cuda, torch.cuda.get_device_name(0),
        torch.cuda.device_count()))
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(SEED)

    def randn(*shape):
        return torch.randn(*shape, device=dev, generator=gen)

    # 1. build every kernel, one nvcc each, all at once
    t0 = time.perf_counter()
    secs = _build.build()
    print("build: %.1f s wall, per kernel %s" % (
        time.perf_counter() - t0, {k: round(v, 1) for k, v in secs.items()}), flush=True)

    errs = {"knn_tile": 0.0, "select_tile": 0.0, "pairwise_tile": 0.0}

    # 2. each kernel against its plain version
    for n, nq, d, k, dup in [(10_007, 77, 64, 1, False), (50_003, 300, 128, 100, False),
                             (3_001, 129, 300, 128, False), (4_000, 65, 128, 100, True)]:
        x, q = randn(n, d), randn(nq, d)
        if dup:                                  # exact ties: every row twice
            x = torch.cat([x[: n // 2], x[: n // 2]])
        got = fused_knn_tile(x, q, k)
        torch.cuda.synchronize()
        ref = knn_tile_plain(x, q, k)
        # expanded-form distances: float32 rounding of |q|^2 + |x|^2
        atol = 2e-6 * ((q * q).sum(1).max() + (x * x).sum(1).max()).item()
        err = check_knn("knn_tile n=%d nq=%d d=%d k=%d" % (len(x), nq, d, k),
                        *got, *ref, atol)
        print("check knn_tile n=%d nq=%d d=%d k=%d: max err %.3g (atol %.3g)"
              % (len(x), nq, d, k, err, atol), flush=True)

    for m, w, k in [(1000, 3333, 1), (517, 10_001, 100), (64, 129, 128)]:
        keys = randn(m, w)
        keys[0] = float("inf")                   # a row with no finite key
        keys[1, 5:] = float("inf")               # a row with 5
        got = select_tile(keys, k)
        torch.cuda.synchronize()
        ref = select_tile_plain(keys, k)
        check_exact("select_tile values m=%d w=%d k=%d" % (m, w, k), got[0], ref[0])
        check_exact("select_tile ids m=%d w=%d k=%d" % (m, w, k), got[1], ref[1])
        print("check select_tile m=%d w=%d k=%d: exact" % (m, w, k), flush=True)

    for m, n, d in [(193, 257, 77), (130, 70, 300)]:
        x = torch.rand(m, d, device=dev, generator=gen)
        y = torch.rand(n, d, device=dev, generator=gen)
        for metric in METRICS:
            got = pairwise_tile(x, y, metric, 3.0)
            torch.cuda.synchronize()
            ref = pairwise_tile_plain(x, y, metric, 3.0)
            # float32 sums of d terms in another order
            torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5)
        print("check pairwise_tile %dx%dx%d: %d metrics agree (rtol 1e-5, atol 1e-5)"
              % (m, n, d, len(METRICS)), flush=True)

    # 3. the main path, through the public entry point
    index, queries = randn(N_INDEX, DIM), randn(N_QUERIES, DIM)
    paths = {}

    reset()
    t0 = time.perf_counter()
    dist, ids = brute_force_knn(index, queries, K, D.L2SqrtExpanded, device=dev)
    torch.cuda.synchronize()
    paths["bfknn_1M"] = {"launches": counts(), "first_call_ms": (time.perf_counter() - t0) * 1e3}
    assert paths["bfknn_1M"]["launches"]["knn_tile"] > 0, paths
    assert paths["bfknn_1M"]["launches"]["select_tile"] > 0, paths
    assert dist.shape == (N_QUERIES, K) and ids.dtype == torch.int32
    assert torch.isfinite(dist).all() and ids.min() >= 0 and ids.max() < N_INDEX
    ref_d, ref_i = knn_tile_plain(index, queries[:N_CHECK], K)
    atol = 2e-6 * ((queries * queries).sum(1).max() + (index * index).sum(1).max()).item()
    err = check_knn("bfknn 1M (squared)", dist[:N_CHECK] ** 2, ids[:N_CHECK],
                    ref_d, ref_i, atol)
    errs["knn_tile"] = max(errs["knn_tile"], err)
    print("main path 1M x 128, nq=1024, k=100: launches %s, first %d queries agree "
          "with the plain version (max err %.3g, atol %.3g)"
          % (paths["bfknn_1M"]["launches"], N_CHECK, err, atol), flush=True)

    parts = list(index.chunk(4))
    reset()
    dist4, ids4 = brute_force_knn(parts, queries, K, D.L2SqrtExpanded, device=dev)
    torch.cuda.synchronize()
    paths["bfknn_1M_4parts"] = {"launches": counts()}
    assert paths["bfknn_1M_4parts"]["launches"]["knn_tile"] >= 4, paths
    assert paths["bfknn_1M_4parts"]["launches"]["select_tile"] > 0, paths
    err = check_knn("bfknn 4 partitions vs 1", dist4 ** 2, ids4, dist ** 2, ids, atol)
    print("main path in 4 partitions: launches %s, agrees with one partition "
          "(max err %.3g)" % (paths["bfknn_1M_4parts"]["launches"], err), flush=True)

    index_l1 = index[:N_L1]
    reset()
    dist_l1, ids_l1 = brute_force_knn(index_l1, queries, K, D.L1, device=dev)
    torch.cuda.synchronize()
    paths["bfknn_L1_100k"] = {"launches": counts()}
    assert paths["bfknn_L1_100k"]["launches"]["pairwise_tile"] > 0, paths
    assert paths["bfknn_L1_100k"]["launches"]["select_tile"] > 0, paths
    ref_keys = pairwise_tile_plain(queries[:N_CHECK], index_l1, D.L1)
    ref_d, ref_i = select_tile_plain(ref_keys, K)
    err = check_knn("bfknn L1", dist_l1[:N_CHECK], ids_l1[:N_CHECK], ref_d, ref_i, 1e-3)
    errs["pairwise_tile"] = max(errs["pairwise_tile"], err)
    print("L1 path 100k x 128, nq=1024, k=100: launches %s, first %d queries agree "
          "(max err %.3g)" % (paths["bfknn_L1_100k"]["launches"], N_CHECK, err), flush=True)

    for name, fn in [("bfknn_1M", lambda: brute_force_knn(index, queries, K, D.L2SqrtExpanded, device=dev)),
                     ("bfknn_1M_4parts", lambda: brute_force_knn(parts, queries, K, D.L2SqrtExpanded, device=dev)),
                     ("bfknn_L1_100k", lambda: brute_force_knn(index_l1, queries, K, D.L1, device=dev))]:
        paths[name]["ms"] = time_ms(fn, reps=3)
        paths[name]["qps"] = N_QUERIES / paths[name]["ms"] * 1e3

    # 4. kernels at the main path's shapes: kernel, plain version, yardstick
    launches = {name: sum(p["launches"][name] for p in paths.values() if "launches" in p)
                for name in wrappers}
    rows = []

    def full_l2_topk():
        qn = (queries * queries).sum(1, keepdim=True)
        xn = (index * index).sum(1)
        return torch.topk(qn + xn - 2.0 * (queries @ index.T), K, dim=1, largest=False)

    b, by = bound(2.0 * N_QUERIES * N_INDEX * DIM,
                  4.0 * (N_INDEX + N_QUERIES) * DIM + 8.0 * N_QUERIES * K)
    rows.append({
        "name": "knn_tile", "route": "cuda", "source": "raft_tpu_torch/ops/csrc/knn_tile.cu",
        "replaces": "raft_tpu/ops/knn_tile.py:563",
        "shape": "index 1000000x128 f32, 1024 queries, k=100",
        "launches": launches["knn_tile"], "max_abs_err": errs["knn_tile"],
        "ms": time_ms(lambda: fused_knn_tile(index, queries, K), reps=5),
        "plain_ms": time_ms(lambda: knn_tile_plain(index, queries, K), reps=2),
        "bound_ms": b, "bound_by": by,
        "library_ms": time_ms(full_l2_topk, reps=3)})

    keys = pairwise_tile(queries, index_l1, D.L1)
    got, ref = select_tile(keys, K), select_tile_plain(keys, K)
    check_exact("select_tile main-path values", got[0], ref[0])
    check_exact("select_tile main-path ids", got[1], ref[1])
    b, by = bound(1.0 * N_QUERIES * N_L1, 4.0 * N_QUERIES * N_L1 + 8.0 * N_QUERIES * K)
    rows.append({
        "name": "select_tile", "route": "cuda", "source": "raft_tpu_torch/ops/csrc/select_tile.cu",
        "replaces": "raft_tpu/ops/select_tile.py:133",
        "shape": "keys 1024x100000 f32, k=100",
        "launches": launches["select_tile"], "max_abs_err": errs["select_tile"],
        "ms": time_ms(lambda: select_tile(keys, K), reps=5),
        "plain_ms": time_ms(lambda: select_tile_plain(keys, K), reps=3),
        "bound_ms": b, "bound_by": by,
        "library_ms": time_ms(lambda: torch.topk(keys, K, dim=1, largest=False), reps=5)})

    ref_keys = pairwise_tile_plain(queries, index_l1, D.L1)
    errs["pairwise_tile"] = max(errs["pairwise_tile"], (keys - ref_keys).abs().max().item())
    del ref_keys
    b, by = bound(2.0 * N_QUERIES * N_L1 * DIM,
                  4.0 * (N_QUERIES + N_L1) * DIM + 4.0 * N_QUERIES * N_L1)
    rows.append({
        "name": "pairwise_tile", "route": "cuda",
        "source": "raft_tpu_torch/ops/csrc/pairwise_tile.cu",
        "replaces": "raft_tpu/ops/pairwise_tile.py:133",
        "shape": "L1, x 1024x128, y 100000x128 f32",
        "launches": launches["pairwise_tile"], "max_abs_err": errs["pairwise_tile"],
        "ms": time_ms(lambda: pairwise_tile(queries, index_l1, D.L1), reps=5),
        "plain_ms": time_ms(lambda: pairwise_tile_plain(queries, index_l1, D.L1), reps=2),
        "bound_ms": b, "bound_by": by,
        "library_ms": time_ms(lambda: torch.cdist(queries, index_l1, p=1), reps=3)})

    print(json.dumps({"card": card, "paths": paths}))
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
