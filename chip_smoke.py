#!/usr/bin/env python3
"""Smoke run of raft_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from ``raft_tpu_torch/ops/csrc`` with nvcc, holds
each kernel against its plain PyTorch version on the card, and drives the
paths through the public entry points with ``device="cuda"``:

- exact brute-force kNN, 1M x 128 float32, 1024 queries, k=100
  (``brute_force_knn``), in one partition and in four, and the L1 path
  (pairwise K5 + select K2) at 100k x 128;
- the two-phase fused kNN (``fused_knn_twophase``, K6 then K2) on the
  same index and queries at ``block_n`` 2048, held against K1's result;
- IVF-Flat at the size of the repository's ``serve_ann_1m`` workload:
  ``ivf_flat_build`` of 1M x 128 rows from a Gaussian mixture into 1024
  lists, k-means trained on 131,072 sampled rows (K4 assigns), then
  ``ivf_flat_search`` of 1024 queries, k=100, nprobe=32 (K2 probes, K3
  scans the work list of the scan lists grouped by slot, K2 merges),
  held against the scan route, its recall@100 against brute force
  reported, and a full probe held equal to brute force;
- the serving layer: ``KNNService`` over the 1M index (k=100,
  L2SqrtExpanded, batches of up to 1024 rows) under 8 submitter threads,
  every response held bitwise equal to the unbatched ``brute_force_knn``
  of its rows, with no kernel build or load after warmup; and
  ``PairwiseService`` over 10,000 x 128 rows with L1 (K5, every response
  bitwise equal to the unbatched call) and L2SqrtExpanded (bitwise equal
  to the call on its padded batch, sliced), and the L1 service again,
  built on one side stream and fed from another;
- ``ANNService`` over the 1M IVF-Flat index (``serve_ann_1M``, the JAX
  ``serve_ann_1m`` rung: k=100, nprobe ladder 4/6/8/16, rungs
  8/32/64/128): warmup, then ``calibrate`` to recall@100 >= 0.9 on 32
  queries, a load of 16 threads x 48 requests of 16 rows (every response
  bitwise equal to the search of its padded batch, recall@100 against
  brute force, no kernel build after warmup), 2,048 inserts under
  traffic (each found at distance 0 with its own id before and after the
  automatic compaction; a fixed query set equal across the swap at a
  full probe), a manual brownout one ladder step down, and the delta arm
  against its padded batch and the request alone; the host runtime
  (``core/native.py``, built with g++) must pack the lists;
- the dense library at ``BASELINE.md`` config #2 (``linalg_4096``):
  ``gemm`` 4096^3 at ``precision="highest"`` and ``"default"`` (TF32),
  ``row_norm``, ``coalesced_reduction``, ``strided_reduction`` (and a
  maximum through the pairwise tree) and ``transpose`` of 4096 x 4096,
  each against float64 on the card, with TFLOP/s and the bytes bound,
  and the gemm again on a ``Handle``'s stream, bit for bit;
- Lanczos: the 8 smallest eigenpairs of the 64 x 64 grid Laplacian
  (dense 4096 x 4096), residuals and eigenvalues against the closed form.

It checks that each path launched its kernels, and times every kernel
beside its plain version and, where one exists, a single-call PyTorch
yardstick.  K1 and K6 are also held against their plain versions on
offset data (100 + N(0, 1)) and on uniform [0, 1) data at depth 128;
K1, K3, K4 and K6 (3xTF32 on the tensor
cores) carry the 3xTF32 bound beside the float32 FFMA one, and the card's
SM clock and power draw are read right after the K1 timing.  K3 is held
against its plain version as a whole and as the kernel alone on the same
work list, at every check store (one with a slot that every query
probes, so that it takes several items) and at the search's shape, and
its row times the inversion of the scan lists, the kernel and K2's merge
apart.  K4 is checked to d = 300 and m = 9,000, and on a row with no
finite distance.  K2 is held bit for bit against its plain version, and
its route against the Python mirror, on few wide rows, on rows of 4
distinct values (ties across every chunk, and rows that take the whole
row where the sampled bound keeps too many keys), on rows
all +inf, with NaN and fewer than k other keys and with signed zeros, at
w = k, and at every shape the paths launched it at with k = 1, 32, 64,
100 and 128; its row times each of those shapes on keys like the path's
beside ``torch.topk``, with their launch-weighted total.  K5 is held
against its plain version for every metric at ragged shapes, depths 1,
3, 77, 128, 300 and 4096 and rows off 16-byte alignment; its bound counts
the FP32 instructions a step issues at the SM clock read after its
timing.  ``ivf_flat_build`` runs twice with one seed and must give the
same index bit for bit.  Any failure raises, and the script exits
non-zero without the final line.  It needs a CUDA device and the
repository beside it.

Output: the card (``nvidia-smi``), versions, build seconds, one line per
check, a ``paths`` JSON line (launches and end-to-end milliseconds per
path), a ``kernels`` JSON line, and last ``{"ok": true, "device": ...}``.
"""

import itertools
import json
import statistics
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
SEED = 0
N_INDEX, N_QUERIES, DIM, K = 1_000_000, 1024, 128, 100
N_L1 = 100_000
N_CHECK = 128              # main-path queries held against the plain version
# IVF-Flat: bench.py serve_ann_1m (nlist 1024, train_rows 131,072), the
# nprobe of its _bench_ivf, and the Gaussian mixture of its make_blobs
# (256 blobs, spread 0.35)
NLIST, NPROBE, TRAIN_ROWS = 1024, 32, 131_072
N_BLOBS, BLOB_SPREAD = 256, 0.35
N_FULL_PROBE = 64          # queries searched at nprobe = nlist
# K6: the JAX knn_1m_twophase rung (bench.py:644-650) uses block_n 2048;
# the kernel checks cover the smallest rung too
TWOPHASE_BLOCK_N = 2048
# serving: 8 submitter threads x 32 requests of row counts drawn from
# SERVE_ROWS by seed 0; PairwiseService over N_PAIRWISE rows
SERVE_THREADS, SERVE_PER_THREAD, SERVE_ROWS = 8, 32, (1, 8, 64, 256)
N_PAIRWISE = 10_000
SPIN_CYCLES = 10_000_000   # card clock cycles spun before a side-stream payload is written
QUEUE_SPIN_CYCLES = 8_000_000  # spun while queued_ms enqueues its calls (4 ms at 1.98 GHz)
# H100 SXM peaks (NVIDIA data sheet): float32 outside the tensor cores, TF32
# on the tensor cores (dense), HBM3
# ANNService over the IVF-Flat index: the JAX serve_ann_1m rung
# (bench.py:1318-1375, 2909-2915): k 100, the nprobe ladder, the bucket
# rungs, 16 threads x 48 requests of 16 rows, 2,048 inserts under traffic
ANN_LADDER, ANN_RUNGS = (4, 6, 8, 16), (8, 32, 64, 128)
ANN_THREADS, ANN_PER_THREAD, ANN_ROWS = 16, 48, 16
ANN_CALIB, ANN_TARGET = 32, 0.9
ANN_DELTA_CAP, ANN_COMPACT, ANN_INSERT, ANN_CHUNK = 4096, 2048, 2048, 64
# linalg_4096 (BASELINE.md config #2) and the Lanczos check: 8 smallest
# eigenpairs of the 64 x 64 grid Laplacian (dense, 4096 x 4096)
N_LINALG, GRID, N_EIG = 4096, 64, 8
LANCZOS_TOL, LANCZOS_NCV, LANCZOS_MAXITER = 1e-6, 64, 30_000
EIG_ATOL = 1e-5            # |A v - lambda v| and |lambda - exact|, with |A| <= 8
GEMM_RTOL = {"highest": 2e-5, "default": 2e-3}   # of max (|A| @ |B|)
SUM_RTOL = 1e-5            # a float32 sum of 4096 terms, of the sum of |terms|
PEAK_FP32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
PEAK_BYTES = 3.35e12
OFFSET = 100.0             # offset data for K1 and K6: the expanded form cancels most
K5_INSTR_PER_STEP = 2      # FP32 instructions a step of L1, L2Unexpanded and Linf


def card_line():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True)
    return out.stdout.strip().splitlines()[0]


def clocks_line():
    """The card's SM clock and power draw right now (``nvidia-smi``)."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
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


def queued_ms(fn, calls=20):
    """Milliseconds a call of ``fn`` keeps the card busy when calls queue
    up: the card spins while the host enqueues ``calls`` calls, then runs
    them back to back between two CUDA events.  For a kernel shorter than
    its host-side launch, ``time_ms`` times the host instead."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(QUEUE_SPIN_CYCLES)
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / calls


def bound(ops, nbytes):
    """Least time (ms) for ``ops`` float32 operations and ``nbytes`` of
    device-memory traffic, and which of the two bounds it."""
    t_ops, t_bytes = ops / PEAK_FP32_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def bound_tf32x3(ops, nbytes):
    """The same for a float32-faithful product in 3xTF32 on the tensor
    cores: three TF32 operations for each float32 one."""
    t_ops, t_bytes = 3.0 * ops / PEAK_TF32_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    if t_ops >= t_bytes:
        return t_ops, "operations, 3xTF32 on tensor cores"
    return t_bytes, "bytes"


def check_knn(name, got_d, got_i, ref_d, ref_i, atol):
    """Distances within ``atol``; ids equal as per-row sets except at a
    tie (within ``atol``) with the k-th reference distance; deficit slots
    (id -1, distance +inf, where a row had fewer than k candidates) at the
    same places.  Returns the largest distance error."""
    assert got_d.shape == ref_d.shape and got_i.dtype == torch.int32, name
    live = ref_i >= 0
    assert torch.equal(got_i >= 0, live), "%s: deficit slots differ" % name
    assert torch.isfinite(got_d[live]).all() and torch.isinf(got_d[~live]).all(), name
    assert (got_i[~live] == -1).all(), name
    srt = torch.sort(got_i, dim=1).values
    assert not ((srt[:, 1:] == srt[:, :-1]) & (srt[:, 1:] >= 0)).any(), "%s: duplicate ids" % name
    err = (got_d[live] - ref_d[live]).abs().max().item() if live.any() else 0.0
    assert err <= atol, "%s: distance error %g > %g" % (name, err, atol)
    same = (srt == torch.sort(ref_i, dim=1).values).all(dim=1)
    for row in torch.nonzero(~same).flatten().tolist():
        extra = set(got_i[row].tolist()) - set(ref_i[row].tolist())
        kth = ref_d[row][live[row]][-1].item()
        for col, idx in enumerate(got_i[row].tolist()):
            if idx in extra:
                assert abs(got_d[row, col].item() - kth) <= atol, (
                    "%s: row %d id %d is no tie at the k-th distance" % (name, row, idx))
    return err


def check_nn(name, got_v, got_i, ref_v, ref_i, x, y, atol):
    """1-NN values within ``atol``; an id that differs from the reference's
    must be a tie (within ``atol``) at the minimum.  Returns the largest
    value error."""
    assert got_v.shape == ref_v.shape and got_i.dtype == torch.int32, name
    err = (got_v - ref_v).abs().max().item()
    assert err <= atol, "%s: value error %g > %g" % (name, err, atol)
    bad = got_i != ref_i
    if bad.any():
        alt = ((x[bad] - y[got_i[bad].long()]) ** 2).sum(dim=1)
        assert ((alt - ref_v[bad]).abs() <= atol).all(), "%s: an id is no tie" % name
    return err


def l2_atol(a, b):
    """Tolerance of expanded-form squared L2 in float32: the rounding of
    |a|^2 + |b|^2 at the largest norms."""
    return 2e-6 * ((a * a).sum(-1).max() + (b * b).sum(-1).max()).item()


def check_exact(name, got, ref):
    assert got.shape == ref.shape and got.dtype == ref.dtype, name
    assert torch.equal(got, ref), "%s: kernel and plain version differ" % name


def serve_concurrently(svc, blocks, n_threads, drain=True):
    """Submit ``blocks`` to ``svc`` from ``n_threads`` threads (thread t
    takes blocks t, t + n_threads, ...), wait for every future, and drain
    unless told not to.  Returns the futures in block order and the wall
    milliseconds from the first submit to the last result."""
    futs = [None] * len(blocks)
    errors = []
    start = threading.Barrier(n_threads + 1)

    def submitter(t):
        try:
            start.wait(60)
            for i in range(t, len(blocks), n_threads):
                futs[i] = svc.submit(blocks[i])
        except Exception as e:  # noqa: BLE001 — re-raised below
            errors.append(e)

    threads = [threading.Thread(target=submitter, args=(t,)) for t in range(n_threads)]
    for th in threads:
        th.start()
    start.wait(60)
    t0 = time.perf_counter()
    for th in threads:
        th.join(120)
    assert not errors, errors
    assert not any(th.is_alive() for th in threads)
    for f in futs:
        f.result(timeout=120)
    wall_ms = (time.perf_counter() - t0) * 1e3
    if drain:
        assert svc.drain(timeout=60)
    return futs, wall_ms


def latencies_ms(futs):
    """Each request's latency (its ``resolved`` event), sorted."""
    lat = sorted(ev["latency_s"] * 1e3 for f in futs for ev in f.trace().timeline()
                 if ev["kind"] == "resolved")
    assert len(lat) == len(futs)
    return lat


def quantile(sorted_ms, q):
    return sorted_ms[min(len(sorted_ms) - 1, int(q * len(sorted_ms)))]


def grid_laplacian(n, dev):
    """The Laplacian of the n x n grid graph (4-neighbour, dense float32)
    and its 8 smallest eigenvalues in closed form (float64): the sums of
    two eigenvalues 2 - 2 cos(pi k / n) of the path graph's Laplacian."""
    path = 2.0 * torch.eye(n, dtype=torch.float64, device=dev)
    off = torch.ones(n - 1, dtype=torch.float64, device=dev)
    path -= torch.diag(off, 1) + torch.diag(off, -1)
    path[0, 0] = path[-1, -1] = 1.0
    eye = torch.eye(n, dtype=torch.float64, device=dev)
    lap = torch.kron(path, eye) + torch.kron(eye, path)
    mu = 2.0 - 2.0 * torch.cos(torch.pi * torch.arange(n, dtype=torch.float64, device=dev) / n)
    exact = torch.sort((mu[:, None] + mu[None, :]).reshape(-1)).values[:N_EIG]
    return lap, exact


def batch_order(flight, name):
    """The service's batches as lists of trace ids, riders in batch order:
    the worker records one ``resolved`` event a rider, in rider order."""
    batches = {}
    for ev in flight.default_recorder().events(service=name, kind="resolved"):
        batches.setdefault(ev.attrs["batch"], []).append(ev.trace_id)
    return list(batches.values())


def main():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device (torch.cuda.is_available() is False)")
    if not (ROOT / "raft_tpu_torch" / "ops" / "csrc").is_dir():
        sys.exit("chip_smoke: raft_tpu_torch not found beside %s" % __file__)
    sys.path.insert(0, str(ROOT))
    from raft_tpu_torch import (ANNService, DistanceType, IVFFlatParams, KNNService,
                                PairwiseService, approx_knn_search, brute_force_knn, config,
                                ivf_flat_build, ivf_flat_search, pairwise_distance)
    from raft_tpu_torch import linalg
    from raft_tpu_torch.core import flight, native, precision, tracing
    from raft_tpu_torch.core.handle import Handle
    from raft_tpu_torch.core.metrics import default_registry
    from raft_tpu_torch.distance.pairwise import expanded_sq_dists
    from raft_tpu_torch.ops import _build
    from raft_tpu_torch.ops.ivf_tile import (fused_ivf_scan, fused_ivf_scan_plain, item_queries,
                                             ivf_items, ivf_items_plain, scan_work_list)
    from raft_tpu_torch.ops.knn_tile import (fused_knn_tile, fused_knn_twophase, knn_tile_plain,
                                             knn_twophase_plain, twophase_geometry,
                                             twophase_tiles, twophase_tiles_plain)
    from raft_tpu_torch.ops.nn_tile import fused_nn_tile, nn_tile_plain
    from raft_tpu_torch.ops.pairwise_tile import (METRICS, pairwise_tile,
                                                  pairwise_tile_plain)
    from raft_tpu_torch.ops.select_tile import plan, select_tile, select_tile_plain, wide_chunks
    from raft_tpu_torch.serve import pad_rows
    from raft_tpu_torch.spatial.ann import _pack_lists, _pack_lists_numpy, _probe_compact

    # the serve_ann_1M checks read every batch of its load back from the
    # flight recorder: a ring that holds the whole run
    config.configure(flight_events="65536")
    D = DistanceType
    wrappers = {"knn_tile": fused_knn_tile, "select_tile": select_tile,
                "pairwise_tile": pairwise_tile, "nn_tile": fused_nn_tile,
                "ivf_tile": ivf_items, "knn_twophase": twophase_tiles}

    def reset():
        for w in wrappers.values():
            w.launches = 0
        select_tile.shapes.clear()

    k2_shapes = {}    # path: K2's launches by (rows, width, k)

    def counts(path=None):
        if path is not None:
            k2_shapes[path] = dict(select_tile.shapes)
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

    errs = {name: 0.0 for name in wrappers}

    # 2. each kernel against its plain version; K1 and K6 also on offset
    # data (index and queries OFFSET + N(0, 1)), where the expanded form
    # cancels most and 3xTF32 must keep float32's accuracy, on uniform
    # [0, 1) data at the main path's depth, where the tensor cores'
    # truncating sums drift one way, and at every query tile: 64 (depth
    # <= 128), 32 (300), 16 with the whole depth (1000) and in slabs (2000,
    # 4096), and a depth off the multiple of 8 (3, a zero-padded copy)
    for n, nq, d, k, data in [(10_007, 77, 64, 1, "normal"), (50_003, 300, 128, 100, "normal"),
                              (3_001, 129, 300, 128, "normal"), (4_000, 65, 128, 100, "dup"),
                              (4_000, 65, 16, 100, "offset"), (20_011, 33, 16, 64, "offset"),
                              (50_003, 300, 128, 100, "uniform"), (5_003, 40, 3, 10, "normal"),
                              (6_007, 37, 1000, 100, "normal"), (4_001, 21, 2000, 32, "normal"),
                              (3_003, 50, 4096, 100, "normal")]:
        if data == "uniform":
            x = torch.rand(n, d, device=dev, generator=gen)
            q = torch.rand(nq, d, device=dev, generator=gen)
        else:
            off = OFFSET if data == "offset" else 0.0
            x, q = randn(n, d) + off, randn(nq, d) + off
        if data == "dup":                        # exact ties: every row twice
            x = torch.cat([x[: n // 2], x[: n // 2]])
        got = fused_knn_tile(x, q, k)
        torch.cuda.synchronize()
        ref = knn_tile_plain(x, q, k)
        atol = l2_atol(q, x)
        err = check_knn("knn_tile n=%d nq=%d d=%d k=%d %s" % (len(x), nq, d, k, data),
                        *got, *ref, atol)
        errs["knn_tile"] = max(errs["knn_tile"], err)
        print("check knn_tile n=%d nq=%d d=%d k=%d %s: max err %.3g (atol %.3g)"
              % (len(x), nq, d, k, data, err, atol), flush=True)

        # K6 at the same shapes, at the smallest block_n and the main path's
        for block_n in (256, TWOPHASE_BLOCK_N):
            bn, n_tiles = twophase_geometry(len(x), block_n)
            part = twophase_tiles(x, q, bn)
            torch.cuda.synchronize()
            part_ref = twophase_tiles_plain(x, q, bn)
            name = "knn_twophase n=%d nq=%d d=%d bn=%d" % (len(x), nq, d, bn)
            assert part[0].shape == (nq, n_tiles * 128), name
            assert torch.equal(part[1] < 0, part_ref[1] < 0), "%s: deficit slots differ" % name
            live = part_ref[1] >= 0
            perr = (part[0][live] - part_ref[0][live]).abs().max().item()
            assert perr <= atol, "%s: tile distance error %g > %g" % (name, perr, atol)
            got = fused_knn_twophase(x, q, k, block_n=block_n)
            torch.cuda.synchronize()
            err = check_knn(name + " k=%d" % k, *got,
                            *knn_twophase_plain(x, q, k, block_n=block_n), atol)
            errs["knn_twophase"] = max(errs["knn_twophase"], err, perr)
            print("check %s k=%d %s: %d tiles, max err %.3g (tiles %.3g, atol %.3g)"
                  % (name, k, data, n_tiles, err, perr, atol), flush=True)

    n_sms = torch.cuda.get_device_properties(dev).multi_processor_count

    def check_select(name, keys, k):
        """K2 bit for bit against its plain version, and the kernel's route
        (the wide filter's blocks a row, 0 for the held route) against its
        mirror in ops/select_tile.py.  Returns the route."""
        m, w = keys.shape
        got = select_tile(keys, k)
        torch.cuda.synchronize()
        ref = select_tile_plain(keys, k)
        name = "select_tile %s m=%d w=%d k=%d" % (name, m, w, k)
        check_exact(name + " values", got[0].view(torch.int32), ref[0].view(torch.int32))
        check_exact(name + " ids", got[1], ref[1])
        chunks = plan(m, w, k)
        assert chunks == wide_chunks(m, w, n_sms), (name, chunks)
        return chunks

    for m, w, k in [(1000, 3333, 1), (517, 10_001, 100), (64, 129, 128)]:
        keys = randn(m, w)
        keys[0] = float("inf")                   # a row with no finite key
        keys[1, 5:] = float("inf")               # a row with 5
        check_select("inf rows", keys, k)
        print("check select_tile m=%d w=%d k=%d: exact" % (m, w, k), flush=True)
    # few wide rows (one served batch: the chunks fill the card), at every k
    for k in (1, 32, 64, 100, 128):
        chunks = check_select("few rows", randn(8, 13_200), k)
    print("check select_tile 8 x 13200 at k 1/32/64/100/128: exact, %d chunks a row" % chunks,
          flush=True)
    # rows of 4 distinct values, so that ties cross every chunk boundary;
    # the bound's bucket then holds a quarter of a row, more than a wide
    # row's candidate room past 16,384 keys, so those rows take the whole
    # row (the kernel's way where a sample misleads), and a held row of
    # over 2048 keys the same
    for m, w, k in [(8, 13_200, 100), (1024, 800, 100), (64, 62_592, 128),
                    (1024, 100_000, 128), (3, 600_000, 128), (5, 1_000, 1), (300, 5_000, 64)]:
        keys = torch.randint(0, 4, (m, w), device=dev, generator=gen).float()
        chunks = check_select("4 values", keys, k)
        print("check select_tile 4 values m=%d w=%d k=%d: exact, %d chunks a row"
              % (m, w, k, chunks), flush=True)
    # rows all +inf, rows with NaN and fewer than k other keys, signed
    # zeros, a NaN with its sign bit set, and w = k
    keys = randn(64, 5_000)
    keys[:8] = float("inf")
    keys[8:16, 40:] = float("nan")
    keys[16:24, ::3] = float("nan")
    keys[24:32] = torch.where(keys[24:32] > 0, 0.0, -0.0)
    keys[32:40, 7:] = -float("nan")
    keys[40:48, ::2] = float("inf")
    keys[40:48, 1::2] = float("nan")
    for k in (1, 64, 100, 128):
        check_select("inf/NaN/zeros", keys, k)
    for m, w in [(100, 128), (7, 1), (33, 100)]:
        keys = randn(m, w)
        keys[0, ::2] = float("nan")
        check_select("w = k", keys, w if w <= 128 else 128)
    print("check select_tile all +inf, NaN with fewer than k keys, signed zeros, w = k: exact",
          flush=True)

    # ragged tiles, depths of one slab, of a ragged last slab and of 256
    # slabs; scalar staging (d not a multiple of 4, or rows off 16 bytes)
    # and 128-bit staging
    for m, n, d, skew in [(193, 257, 77, False), (130, 70, 300, False), (131, 259, 1, False),
                          (67, 300, 3, False), (129, 130, 4096, False), (200, 333, 128, False),
                          (257, 129, 128, True)]:
        x = torch.rand(m, d, device=dev, generator=gen)
        y = torch.rand(n, d, device=dev, generator=gen)
        if skew:                                 # rows 4 bytes off 16-byte alignment
            x = torch.empty(m * d + 1, device=dev)[1:].view(m, d).copy_(x)
        for metric in METRICS:
            got = pairwise_tile(x, y, metric, 3.0)
            torch.cuda.synchronize()
            ref = pairwise_tile_plain(x, y, metric, 3.0)
            # float32 sums of d terms in another order
            torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5)
        print("check pairwise_tile %dx%dx%d%s: %d metrics agree (rtol 1e-5, atol 1e-5)"
              % (m, n, d, " skewed" if skew else "", len(METRICS)), flush=True)

    for m, n, d, dup in [(1000, 1024, 128, False), (77, 1, 16, False),
                         (1031, 3001, 300, False), (500, 2000, 33, True),
                         (9000, 4096, 300, False)]:
        x, y = randn(m, d), randn(n, d)
        if dup:                                  # exact ties: every row of y twice
            y = torch.cat([y[: n // 2], y[: n // 2]])
        got = fused_nn_tile(x, y)
        torch.cuda.synchronize()
        ref = nn_tile_plain(x, y)
        atol = l2_atol(x, y)
        err = check_nn("nn_tile m=%d n=%d d=%d" % (m, n, d), *got, *ref, x, y, atol)
        errs["nn_tile"] = max(errs["nn_tile"], err)
        print("check nn_tile m=%d n=%d d=%d%s: max err %.3g (atol %.3g)"
              % (m, n, d, " dup" if dup else "", err, atol), flush=True)
    # K4's own contract: a row with no finite distance (a NaN in x) keeps
    # (inf, IDX_SENTINEL), as the plain version does
    x, y = randn(300, 64), randn(700, 64)
    x[7, 3] = float("nan")
    got, ref = fused_nn_tile(x, y), nn_tile_plain(x, y)
    torch.cuda.synchronize()
    assert torch.isinf(got[0][7]) and int(got[1][7]) == int(ref[1][7]) == 2**31 - 1, got
    keep = torch.arange(300, device=dev) != 7
    errs["nn_tile"] = max(errs["nn_tile"], check_nn("nn_tile NaN row", got[0][keep], got[1][keep],
                                                    ref[0][keep], ref[1][keep], x[keep], y,
                                                    l2_atol(x[keep], y)))
    print("check nn_tile NaN row: (inf, IDX_SENTINEL), the other rows agree", flush=True)

    # slot stores: S slots of cap rows, the last `vacant` rows of each
    # vacant; scan lists with a short list, an empty one and pad steps; in
    # the last store every query with a list probes slot 0 first, so that
    # slot takes several items.  Each case holds the whole function and,
    # on the same work list, the kernel alone against their plain versions.
    for S, cap, d, k, nq, steps, vacant, bf16, crowded in [
            (6, 24, 10, 5, 7, 4, 3, False, False), (40, 100, 128, 100, 300, 20, 7, False, False),
            (40, 37, 300, 128, 65, 12, 0, False, False), (40, 37, 300, 128, 65, 12, 0, True, False),
            (10, 50, 16, 1, 33, 5, 0, False, False), (64, 984, 128, 100, 256, 48, 50, True, False),
            (16, 300, 128, 100, 500, 4, 9, False, True)]:
        sv = torch.rand(S, cap, d, device=dev, generator=gen)
        si = torch.arange(S * cap, dtype=torch.int32, device=dev).reshape(S, cap)
        si[:, cap - vacant:] = -1
        sv[:, cap - vacant:] = 0
        q = torch.rand(nq, d, device=dev, generator=gen)
        first = int(crowded)       # slot 0 first in every list, or a random order
        slots = torch.stack([torch.cat([torch.zeros(first, dtype=torch.int64, device=dev),
                                        first + torch.randperm(S - first, device=dev,
                                                               generator=gen)[:steps - first]])
                             for _ in range(nq)]).to(torch.int32)
        slots[0, 2:] = -1
        slots[1] = -1
        slots[2, 1::2] = -1
        args = (q, sv, (sv * sv).sum(-1), si, slots, k)
        got = fused_ivf_scan(*args, accum_bf16=bf16)
        torch.cuda.synchronize()
        ref = fused_ivf_scan_plain(*args, accum_bf16=bf16)
        atol = l2_atol(q, sv)
        name = "ivf_tile S=%d cap=%d d=%d k=%d nq=%d%s" % (S, cap, d, k, nq,
                                                          " bf16" if bf16 else "")
        err = check_knn(name, *got, *ref, atol)
        work = scan_work_list(slots, S, cap, item_queries(d, dev))
        flat = (q, sv.reshape(S * cap, d), args[2].reshape(-1), si.reshape(-1), work, cap, k,
                nq * steps, bf16)
        part, part_ref = ivf_items(*flat), ivf_items_plain(*flat)
        torch.cuda.synchronize()
        perr = check_knn(name + " kernel alone", *part, *part_ref, atol)
        errs["ivf_tile"] = max(errs["ivf_tile"], err, perr)
        print("check %s: max err %.3g, the kernel alone %.3g (atol %.3g), %d deficit slots, "
              "%d items of up to %d entries"
              % (name, err, perr, atol, int((ref[1] < 0).sum()), int(work.n_items), work.n_q),
              flush=True)

    # 3. the main path, through the public entry point
    index, queries = randn(N_INDEX, DIM), randn(N_QUERIES, DIM)
    paths = {}

    reset()
    t0 = time.perf_counter()
    dist, ids = brute_force_knn(index, queries, K, D.L2SqrtExpanded, device=dev)
    torch.cuda.synchronize()
    paths["bfknn_1M"] = {"launches": counts("bfknn_1M"),
                         "first_call_ms": (time.perf_counter() - t0) * 1e3}
    assert paths["bfknn_1M"]["launches"]["knn_tile"] > 0, paths
    assert paths["bfknn_1M"]["launches"]["select_tile"] > 0, paths
    assert dist.shape == (N_QUERIES, K) and ids.dtype == torch.int32
    assert torch.isfinite(dist).all() and ids.min() >= 0 and ids.max() < N_INDEX
    ref_d, ref_i = knn_tile_plain(index, queries[:N_CHECK], K)
    atol = l2_atol(queries, index)
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
    paths["bfknn_1M_4parts"] = {"launches": counts("bfknn_1M_4parts")}
    assert paths["bfknn_1M_4parts"]["launches"]["knn_tile"] >= 4, paths
    assert paths["bfknn_1M_4parts"]["launches"]["select_tile"] > 0, paths
    err = check_knn("bfknn 4 partitions vs 1", dist4 ** 2, ids4, dist ** 2, ids, atol)
    print("main path in 4 partitions: launches %s, agrees with one partition "
          "(max err %.3g)" % (paths["bfknn_1M_4parts"]["launches"], err), flush=True)

    index_l1 = index[:N_L1]
    reset()
    dist_l1, ids_l1 = brute_force_knn(index_l1, queries, K, D.L1, device=dev)
    torch.cuda.synchronize()
    paths["bfknn_L1_100k"] = {"launches": counts("bfknn_L1_100k")}
    assert paths["bfknn_L1_100k"]["launches"]["pairwise_tile"] > 0, paths
    assert paths["bfknn_L1_100k"]["launches"]["select_tile"] > 0, paths
    ref_keys = pairwise_tile_plain(queries[:N_CHECK], index_l1, D.L1)
    ref_d, ref_i = select_tile_plain(ref_keys, K)
    err = check_knn("bfknn L1", dist_l1[:N_CHECK], ids_l1[:N_CHECK], ref_d, ref_i, 1e-3)
    errs["pairwise_tile"] = max(errs["pairwise_tile"], err)
    print("L1 path 100k x 128, nq=1024, k=100: launches %s, first %d queries agree "
          "(max err %.3g)" % (paths["bfknn_L1_100k"]["launches"], N_CHECK, err), flush=True)

    reset()
    tp_d, tp_i = fused_knn_twophase(index, queries, K, block_n=TWOPHASE_BLOCK_N)
    torch.cuda.synchronize()
    paths["knn_twophase_1M"] = {"launches": counts("knn_twophase_1M"), "block_n": TWOPHASE_BLOCK_N}
    assert paths["knn_twophase_1M"]["launches"]["knn_twophase"] > 0, paths
    assert paths["knn_twophase_1M"]["launches"]["select_tile"] > 0, paths
    assert tp_d.shape == (N_QUERIES, K) and tp_i.dtype == torch.int32
    assert torch.isfinite(tp_d).all() and tp_i.min() >= 0 and tp_i.max() < N_INDEX
    k1_err = check_knn("knn_twophase 1M vs K1", tp_d, tp_i, *fused_knn_tile(index, queries, K),
                       atol)
    err = check_knn("knn_twophase 1M vs its plain version", tp_d[:N_CHECK], tp_i[:N_CHECK],
                    *knn_twophase_plain(index, queries[:N_CHECK], K, TWOPHASE_BLOCK_N), atol)
    errs["knn_twophase"] = max(errs["knn_twophase"], err)
    print("two-phase path 1M x 128, nq=1024, k=100, block_n=%d: launches %s, agrees with K1 "
          "(max err %.3g) and, on the first %d queries, with the plain version (max err %.3g)"
          % (TWOPHASE_BLOCK_N, paths["knn_twophase_1M"]["launches"], k1_err, N_CHECK, err),
          flush=True)

    for name, fn in [("bfknn_1M", lambda: brute_force_knn(index, queries, K, D.L2SqrtExpanded, device=dev)),
                     ("bfknn_1M_4parts", lambda: brute_force_knn(parts, queries, K, D.L2SqrtExpanded, device=dev)),
                     ("bfknn_L1_100k", lambda: brute_force_knn(index_l1, queries, K, D.L1, device=dev)),
                     ("knn_twophase_1M", lambda: fused_knn_twophase(index, queries, K,
                                                                    block_n=TWOPHASE_BLOCK_N))]:
        paths[name]["ms"] = time_ms(fn, reps=3)
        paths[name]["qps"] = N_QUERIES / paths[name]["ms"] * 1e3

    # 4. the IVF-Flat paths, on a Gaussian mixture drawn on the card (the
    # recipe of bench.py make_blobs): the index and 1024 queries
    centers = randn(N_BLOBS, DIM) * 4.0
    blob = torch.randint(0, N_BLOBS, (N_INDEX + N_QUERIES,), device=dev, generator=gen)
    mixture = centers[blob] + randn(N_INDEX + N_QUERIES, DIM) * BLOB_SPREAD
    X, ivf_q = mixture[:N_INDEX], mixture[N_INDEX:]
    del blob

    # the build packs its lists on the host runtime, not the numpy route
    assert native.native_available(), "the host runtime did not build (g++ missing)"
    reset()
    t0 = time.perf_counter()
    ivf = ivf_flat_build(X, IVFFlatParams(nlist=NLIST, nprobe=NPROBE), D.L2SqrtExpanded,
                         seed=SEED, train_rows=TRAIN_ROWS, device=dev)
    torch.cuda.synchronize()
    build_ms = (time.perf_counter() - t0) * 1e3
    launched = counts("ivf_build_1M")
    # K4 runs every k-means assignment: the first, then one per Lloyd iteration
    paths["ivf_build_1M"] = {"launches": launched, "ms": build_ms,
                             "kmeans_iters": launched["nn_tile"] - 1,
                             "n_slots": ivf.slot_ids.shape[0], "cap": ivf.slot_ids.shape[1],
                             "max_slots_per_list": ivf.cent_slots.shape[1]}
    assert launched["nn_tile"] > 0, paths
    stored = ivf.slot_ids[ivf.slot_ids >= 0]
    assert int(ivf.list_sizes.sum()) == N_INDEX and stored.numel() == N_INDEX
    assert torch.equal(torch.sort(stored).values,
                       torch.arange(N_INDEX, dtype=torch.int32, device=dev))
    print("ivf_build_1M: %.0f ms, launches %s, %d k-means iterations, %d slots of %d rows"
          % (build_ms, launched, launched["nn_tile"] - 1, *ivf.slot_ids.shape), flush=True)
    # one seed, one index: a second build gives the same centroids and lists
    again = ivf_flat_build(X, IVFFlatParams(nlist=NLIST, nprobe=NPROBE), D.L2SqrtExpanded,
                           seed=SEED, train_rows=TRAIN_ROWS, device=dev)
    for field in ("centroids", "slot_vecs", "slot_ids", "slot_centroid", "cent_slots",
                  "list_sizes", "slot_norms"):
        a, b = getattr(ivf, field), getattr(again, field)
        assert a.shape == b.shape and torch.equal(a.reshape(-1).view(torch.int32),
                                                  b.reshape(-1).view(torch.int32)), (
            "ivf_build_1M: a second build with seed %d differs in %s" % (SEED, field))
    del again
    paths["ivf_build_1M"]["second_build_bitwise_equal"] = True
    print("ivf_build_1M: a second build with seed %d is bitwise equal (centroids and lists)"
          % SEED, flush=True)

    reset()
    ivf_d, ivf_i = ivf_flat_search(ivf, ivf_q, K, device=dev)
    torch.cuda.synchronize()
    paths["ivf_search_1M"] = {"launches": counts("ivf_search_1M")}
    assert paths["ivf_search_1M"]["launches"]["ivf_tile"] > 0, paths
    assert paths["ivf_search_1M"]["launches"]["select_tile"] > 0, paths
    assert ivf_d.shape == (N_QUERIES, K) and ivf_i.dtype == torch.int32
    assert torch.isfinite(ivf_d).all() and ivf_i.min() >= 0 and ivf_i.max() < N_INDEX
    ivf_atol = l2_atol(ivf_q, X)
    scan_d, scan_i = ivf_flat_search(ivf, ivf_q[:N_CHECK], K, scan_impl="scan", device=dev)
    err = check_knn("ivf_search vs the scan route (squared)", ivf_d[:N_CHECK] ** 2,
                    ivf_i[:N_CHECK], scan_d ** 2, scan_i, ivf_atol)
    errs["ivf_tile"] = max(errs["ivf_tile"], err)
    bf_d, bf_i = brute_force_knn(X, ivf_q[:N_CHECK], K, D.L2SqrtExpanded, device=dev)
    recall = (ivf_i[:N_CHECK, :, None] == bf_i[:, None, :]).any(-1).float().mean().item()
    assert recall > 0.5, recall
    paths["ivf_search_1M"]["recall_at_100"] = recall
    fp_d, fp_i = ivf_flat_search(ivf, ivf_q[:N_FULL_PROBE], K, nprobe=NLIST, device=dev)
    fp_err = check_knn("ivf full probe vs brute force (squared)", fp_d ** 2, fp_i,
                       bf_d[:N_FULL_PROBE] ** 2, bf_i[:N_FULL_PROBE], ivf_atol)
    print("ivf_search_1M nq=%d k=%d nprobe=%d: launches %s, first %d queries agree with "
          "the scan route (max err %.3g, atol %.3g), recall@%d %.4f against brute force; "
          "nprobe=nlist equals brute force on %d queries (max err %.3g)"
          % (N_QUERIES, K, NPROBE, paths["ivf_search_1M"]["launches"], N_CHECK, err, ivf_atol,
             K, recall,
             N_FULL_PROBE, fp_err), flush=True)
    paths["ivf_search_1M"]["ms"] = time_ms(lambda: ivf_flat_search(ivf, ivf_q, K, device=dev),
                                           reps=5)
    paths["ivf_search_1M"]["qps"] = N_QUERIES / paths["ivf_search_1M"]["ms"] * 1e3

    # 5. the serving layer over the 1M index: 8 submitter threads
    draw = np.random.default_rng(SEED)
    req_rows = [int(r) for r in draw.choice(SERVE_ROWS, size=SERVE_THREADS * SERVE_PER_THREAD)]
    pool = randn(sum(req_rows), DIM)
    starts = np.cumsum([0] + req_rows)
    blocks = [pool[a:b] for a, b in zip(starts[:-1], starts[1:])]
    svc = KNNService(index, k=K, metric=D.L2SqrtExpanded, max_batch_rows=N_QUERIES,
                     device=dev, name="serve_knn_1M")
    svc.warmup()
    reset()
    futs, wall_ms = serve_concurrently(svc, blocks, SERVE_THREADS)
    torch.cuda.synchronize()
    launched = counts("serve_knn_1M")
    after_warmup = svc.kernel_libraries_after_warmup()
    svc.close()
    assert launched["knn_tile"] > 0 and launched["select_tile"] > 0, launched
    assert after_warmup == {"builds": 0, "loads": 0}, after_warmup
    for q, f in zip(blocks, futs):
        d, i = f.result(timeout=0)
        d0, i0 = brute_force_knn(index, q, K, D.L2SqrtExpanded, device=dev)
        assert torch.equal(d, d0) and torch.equal(i, i0), (
            "serve_knn_1M: a %d-row response differs from the unbatched call" % len(q))
    lat_ms = latencies_ms(futs)
    batches = sum(s.value for lbl, s in
                  default_registry().get("raft_tpu_serve_batches_total").series()
                  if lbl["service"] == "serve_knn_1M")
    paths["serve_knn_1M"] = {
        "launches": launched, "requests": len(futs), "rows": sum(req_rows),
        "batches": int(batches), "rows_per_batch": sum(req_rows) / batches,
        "wall_ms": wall_ms, "rows_per_s": sum(req_rows) / wall_ms * 1e3,
        "p50_ms": statistics.median(lat_ms), "p99_ms": quantile(lat_ms, 0.99),
        "kernel_libraries_after_warmup": after_warmup}
    print("serve_knn_1M: %s; every response bitwise equal to the unbatched call"
          % json.dumps(paths["serve_knn_1M"]), flush=True)

    y = randn(N_PAIRWISE, DIM)
    paths["serve_pairwise"] = {}
    for metric in (D.L1, D.L2SqrtExpanded):
        blocks = [randn(r, DIM) for r in req_rows[:16]]
        svc = PairwiseService(y, metric, max_batch_rows=N_QUERIES, device=dev,
                              name="serve_pairwise_%s" % metric.name)
        svc.warmup()
        reset()
        futs, wall_ms = serve_concurrently(svc, blocks, 4)
        torch.cuda.synchronize()
        launched = counts("serve_pairwise" if metric == D.L1 else None)
        svc.close()
        by_trace = {f.trace().trace_id: (b, f.result(timeout=0)) for b, f in zip(blocks, futs)}
        err = 0.0
        for riders in batch_order(flight, svc.name):
            batch = torch.cat([by_trace[tid][0] for tid in riders])
            whole = pairwise_distance(pad_rows(batch, svc.policy.bucket_for(len(batch))), y,
                                      metric, device=dev)
            at = 0
            for tid in riders:
                b, out = by_trace[tid]
                assert torch.equal(out, whole[at:at + len(b)]), (
                    "serve_pairwise %s: a response differs from its padded batch" % metric.name)
                at += len(b)
        for b, out in by_trace.values():
            alone = pairwise_distance(b, y, metric, device=dev)
            if metric == D.L1:      # K5's arithmetic is per pair
                assert torch.equal(out, alone), "serve_pairwise L1: differs from the unbatched call"
            else:
                err = max(err, (out - alone).abs().max().item())
                assert err <= l2_atol(b, y), (metric.name, err)
        if metric == D.L1:
            assert launched["pairwise_tile"] > 0, launched
            paths["serve_pairwise"]["launches"] = launched
        paths["serve_pairwise"][metric.name] = {"requests": len(futs), "wall_ms": wall_ms,
                                                "max_err_vs_unbatched": err}

    # the same L1 service built on a side stream and fed from another one,
    # each payload written there only after a spin of the card: a worker
    # that read it before the write would see zeros
    build_stream, feed_stream = torch.cuda.Stream(dev), torch.cuda.Stream(dev)
    blocks = [randn(r, DIM) for r in req_rows[:16]]
    with torch.cuda.stream(build_stream):
        svc = PairwiseService(y, D.L1, max_batch_rows=N_QUERIES, device=dev,
                              name="serve_pairwise_side_streams")
    assert svc.worker.stream == build_stream
    svc.warmup()
    feed_stream.wait_stream(torch.cuda.current_stream(dev))
    futs = []
    with torch.cuda.stream(feed_stream):
        for b in blocks:
            q = torch.zeros_like(b)
            torch.cuda._sleep(SPIN_CYCLES)
            q.copy_(b)
            futs.append(svc.submit(q))
            del q
    for b, f in zip(blocks, futs):
        assert torch.equal(f.result(timeout=60), pairwise_distance(b, y, D.L1, device=dev)), (
            "serve_pairwise on side streams: a response differs from the unbatched call")
    svc.close()
    paths["serve_pairwise"]["L1_side_streams"] = {"requests": len(futs)}
    print("serve_pairwise %d x %d: %s" % (N_PAIRWISE, DIM, json.dumps(paths["serve_pairwise"])),
          flush=True)

    # 5b. ANNService over the IVF-Flat index built above, the JAX
    # serve_ann_1m rung: warmup, then (counted as the path) calibrate, a
    # load of 16 threads, 2,048 inserts under traffic with the automatic
    # compaction, a manual brownout, and the delta arm alone
    def mixture(m):
        """Rows near the data: fresh draws of the same Gaussian mixture."""
        b = torch.randint(0, N_BLOBS, (m,), device=dev, generator=gen)
        return centers[b] + randn(m, DIM) * BLOB_SPREAD

    ann_name = "serve_ann_1M"

    def ann_calls():
        fam = default_registry().get("raft_tpu_serve_ann_calls_total")
        return {int(lbl["nprobe"]): s.value for lbl, s in fam.series()
                if lbl["service"] == ann_name} if fam is not None else {}

    def wait_all(futs):
        return [f.result(timeout=120) for f in futs]

    svc = ANNService(ivf, K, nprobe_ladder=ANN_LADDER, bucket_rungs=ANN_RUNGS,
                     max_batch_rows=ANN_RUNGS[-1], max_wait_ms=2.0, queue_cap=4096,
                     delta_cap=ANN_DELTA_CAP, compact_rows=ANN_COMPACT, device=dev,
                     name=ann_name)
    t0 = time.perf_counter()
    svc.warmup()
    ann = {"warmup_s": time.perf_counter() - t0}
    calib_q = mixture(ANN_CALIB)
    n_req = ANN_THREADS * ANN_PER_THREAD
    load_rows = mixture(n_req * ANN_ROWS)
    blocks = list(load_rows.split(ANN_ROWS))
    new_vecs = mixture(ANN_INSERT)
    new_ids = torch.arange(N_INDEX, N_INDEX + ANN_INSERT, dtype=torch.int32)
    fixed_q = torch.cat([new_vecs[:64], mixture(64)])
    delta_vecs, delta_qs = mixture(ANN_CHUNK), [mixture(ANN_ROWS) for _ in range(16)]
    torch.cuda.synchronize()
    reset()
    t_path = time.perf_counter()

    calib = svc.calibrate(calib_q, ANN_TARGET, measure_all=True)
    nprobe = calibrated = svc.nprobe
    assert calib["met_target"] and nprobe == calib["chosen_nprobe"], calib
    ann["calibrate"] = calib
    print("serve_ann_1M calibrate (%d queries, target recall@%d %.2f): chose nprobe %d; %s"
          % (ANN_CALIB, K, ANN_TARGET, nprobe, json.dumps(calib["table"])), flush=True)

    calls0 = ann_calls()
    futs, wall_ms = serve_concurrently(svc, blocks, ANN_THREADS, drain=False)
    load_batches = batch_order(flight, ann_name)
    calls1 = ann_calls()
    index0 = svc.index
    assert {c: calls1.get(c, 0) - calls0.get(c, 0) for c in calls1} == {
        **{c: 0 for c in calls1}, nprobe: len(load_batches)}, (calls0, calls1)
    lat_ms = latencies_ms(futs)
    ann.update({"requests": n_req, "rows": n_req * ANN_ROWS, "batches": len(load_batches),
                "rows_per_batch": n_req * ANN_ROWS / len(load_batches), "wall_ms": wall_ms,
                "rows_per_s": n_req * ANN_ROWS / wall_ms * 1e3, "nprobe": nprobe,
                "p50_ms": statistics.median(lat_ms), "p99_ms": quantile(lat_ms, 0.99)})

    # inserts under traffic: a thread keeps submitting load blocks while the
    # main thread inserts 64 rows at a time and asks for each chunk back
    stop, bg, bg_err = threading.Event(), [], []

    def background():
        try:
            for i in itertools.count():
                if stop.is_set():
                    return
                bg.append(svc.submit(blocks[i % len(blocks)]))
                time.sleep(0.001)
        except Exception as e:  # noqa: BLE001 — re-raised below
            bg_err.append(e)

    th = threading.Thread(target=background, daemon=True)
    th.start()
    before = []
    try:
        for c in range(0, ANN_INSERT, ANN_CHUNK):
            if c + ANN_CHUNK < ANN_INSERT:
                svc.insert(new_ids[c:c + ANN_CHUNK], new_vecs[c:c + ANN_CHUNK])
            else:
                # the last chunk fills the delta to compact_rows: hold the
                # swap back (the compaction lock) to read the snapshot it
                # replaces
                with svc._compact_lock:
                    svc.insert(new_ids[c:c + ANN_CHUNK], new_vecs[c:c + ANN_CHUNK])
                    pre_swap = svc._ann_state
            before.append(svc.submit(new_vecs[c:c + ANN_CHUNK]))
        assert pre_swap.delta_rows == ANN_INSERT
        t_wait = time.perf_counter()
        while svc.delta_rows and time.perf_counter() - t_wait < 300:
            time.sleep(0.01)
        assert svc.delta_rows == 0 and svc.index is not index0, "no compaction"
        post_swap = svc._ann_state
        after = [svc.submit(v) for v in new_vecs.split(ANN_CHUNK)]
        wait_all(after)
    finally:
        stop.set()
        th.join(60)
    assert not th.is_alive() and not bg_err, bg_err
    wait_all(bg)
    bg_lat = latencies_ms(bg)
    stats_now = svc.stats()
    ann.update({"inserted": ANN_INSERT, "compact_s": stats_now["last_compact_s"],
                "background_requests": len(bg),
                "background_p50_ms": statistics.median(bg_lat),
                "background_max_ms": bg_lat[-1]})

    # a manual brownout: one ladder step below the served cell, then back
    # (from the next cell up where calibration chose the lowest)
    ladder = svc.nprobe_ladder
    if nprobe == ladder[0]:
        nprobe = svc.set_nprobe(ladder[1])
    lower = ladder[ladder.index(nprobe) - 1]
    c0 = ann_calls()
    svc.degrade(1)
    wait_all([svc.submit(b) for b in blocks[:8]])
    c1 = ann_calls()
    svc.restore()
    wait_all([svc.submit(b) for b in blocks[8:16]])
    c2 = ann_calls()
    assert c1.get(lower, 0) > c0.get(lower, 0) and c2.get(nprobe, 0) > c1.get(nprobe, 0)
    assert c1.get(nprobe, 0) == c0.get(nprobe, 0) and c2.get(lower, 0) == c1.get(lower, 0)
    ann["degrade"] = {"served_nprobe": nprobe, "degraded_nprobe": lower,
                      "batches_degraded": c1.get(lower, 0) - c0.get(lower, 0),
                      "batches_restored": c2.get(nprobe, 0) - c1.get(nprobe, 0)}

    # the delta arm alone: 64 rows in the delta, one request a batch
    svc.insert(torch.arange(N_INDEX + ANN_INSERT, N_INDEX + ANN_INSERT + ANN_CHUNK), delta_vecs)
    delta_state = svc._ann_state
    delta_out = [svc.submit(q).result(timeout=120) for q in delta_qs]
    torch.cuda.synchronize()
    launched = counts(ann_name)
    ann["path_ms"] = (time.perf_counter() - t_path) * 1e3
    after_warmup = svc.kernel_libraries_after_warmup()
    svc.close()
    assert launched["ivf_tile"] > 0 and launched["select_tile"] > 0, launched
    assert launched["knn_tile"] > 0, launched           # calibrate's ground truth
    assert after_warmup == {"builds": 0, "loads": 0}, after_warmup
    ann["launches"] = launched
    ann["kernel_libraries_after_warmup"] = after_warmup

    # the checks, after the path's counts are read: every load response
    # bitwise equal to the port's unbatched search of its padded batch on
    # the same snapshot and nprobe (and counted against the request alone)
    by_trace = {f.trace().trace_id: (b, f) for b, f in zip(blocks, futs)}
    assert sum(len(r) for r in load_batches) == len(futs)
    for riders in load_batches:
        batch = torch.cat([by_trace[t][0] for t in riders])
        pd, pi = approx_knn_search(index0, pad_rows(batch, svc.policy.bucket_for(len(batch))),
                                   K, nprobe=calibrated, device=dev)
        at = 0
        for t in riders:
            b, f = by_trace[t]
            d, i = f.result(timeout=0)
            assert torch.equal(d, pd[at:at + len(b)]) and torch.equal(i, pi[at:at + len(b)]), (
                "serve_ann_1M: a response differs from the search of its padded batch")
            at += len(b)
    alone_equal = 0
    for b, f in zip(blocks, futs):
        ad, ai = approx_knn_search(index0, b, K, nprobe=calibrated, device=dev)
        d, i = f.result(timeout=0)
        alone_equal += int(torch.equal(d, ad) and torch.equal(i, ai))
    ann["responses_bitwise_equal_to_request_alone"] = alone_equal
    assert alone_equal == len(futs), (
        "serve_ann_1M: %d of %d responses differ from the search of the request alone"
        % (len(futs) - alone_equal, len(futs)))
    served_i = torch.cat([f.result(timeout=0)[1] for f in futs])
    _, bf_i = brute_force_knn(X, load_rows, K, D.L2SqrtExpanded, device=dev)
    ann["recall_at_100"] = (served_i[:, :, None] == bf_i[:, None, :]).any(-1).float().mean().item()
    assert ann["recall_at_100"] >= ANN_TARGET - 0.05, ann["recall_at_100"]

    # K3 against its plain version at the geometries this path gave it: a
    # served padded batch at the calibrated nprobe on the index it was
    # served from, and a padded batch of another rung on the index the
    # compaction rebuilt at the ladder's top cell
    first = torch.cat([by_trace[t][0] for t in load_batches[0]])
    k3_cases = [("served batch", index0, pad_rows(first, svc.policy.bucket_for(len(first))),
                 calibrated),
                ("after the swap", post_swap.index,
                 pad_rows(fixed_q[:40], svc.policy.bucket_for(40)), ladder[-1])]
    ann["ivf_tile_checks"] = []
    for what, idx, q, n_probe in k3_cases:
        slots, _ = _probe_compact(q, idx.centroids, idx.cent_slots, n_probe)
        S, cap = idx.slot_ids.shape
        atol = l2_atol(q, X)
        scan_args = (q, idx.slot_vecs, idx.slot_norms, idx.slot_ids, slots, K)
        name = "ivf_tile serve_ann_1M %s (%d rows, nprobe %d)" % (what, len(q), n_probe)
        e1 = check_knn(name, *fused_ivf_scan(*scan_args), *fused_ivf_scan_plain(*scan_args), atol)
        work = scan_work_list(slots, S, cap, item_queries(DIM, dev))
        flat = (q, idx.slot_vecs.reshape(S * cap, DIM), idx.slot_norms.reshape(-1),
                idx.slot_ids.reshape(-1), work, cap, K, len(q) * slots.shape[1])
        e2 = check_knn(name + " kernel alone", *ivf_items(*flat), *ivf_items_plain(*flat), atol)
        errs["ivf_tile"] = max(errs["ivf_tile"], e1, e2)
        ann["ivf_tile_checks"].append({"case": what, "rows": len(q), "nprobe": n_probe,
                                       "slots": S, "cap": cap, "max_err": max(e1, e2),
                                       "atol": atol})

    # the host packing of the 1M index's lists (the build's labels, read
    # back from its slots): the native route against the numpy route
    live = ivf.slot_ids >= 0
    labels = torch.empty(N_INDEX, dtype=torch.int64, device=dev)
    labels[ivf.slot_ids[live].long()] = ivf.slot_centroid[:, None].expand_as(live)[live].long()
    labels = labels.cpu().numpy()
    pack = {}
    for route, fn in (("native", _pack_lists), ("numpy", _pack_lists_numpy),
                      ("native_again", _pack_lists), ("numpy_again", _pack_lists_numpy)):
        t0 = time.perf_counter()
        table, max_len = fn(labels, NLIST)
        pack[route + "_ms"] = (time.perf_counter() - t0) * 1e3
        if route == "native":
            ref_table = table
        assert np.array_equal(table, ref_table), "pack_lists: the two routes differ"
    ann["pack_lists_1M"] = pack

    # each inserted vector at distance 0 (the expanded form's rounding) with
    # its own id, before the compaction (from the delta) and after it
    ins_tol = l2_atol(new_vecs, X) ** 0.5
    for name, outs in (("before", before), ("after", after)):
        d = torch.cat([f.result(timeout=0)[0] for f in outs])
        i = torch.cat([f.result(timeout=0)[1] for f in outs])
        assert torch.equal(i[:, 0].cpu(), new_ids), "serve_ann_1M: an insert lost its id " + name
        assert d[:, 0].max().item() <= ins_tol, (name, d[:, 0].max().item(), ins_tol)
        ann["insert_max_dist_" + name] = d[:, 0].max().item()
    # a fixed query set on the snapshots either side of the swap, at a full
    # probe: below it the slots miss neighbours the delta's brute force finds
    pre_d, pre_i = approx_knn_search(pre_swap.index, fixed_q, K, nprobe=NLIST,
                                     delta=(pre_swap.delta_vecs, pre_swap.delta_ids), device=dev)
    post_d, post_i = approx_knn_search(post_swap.index, fixed_q, K, nprobe=NLIST, device=dev)
    ann["swap_max_err"] = check_knn("serve_ann_1M across the swap (squared)", post_d ** 2,
                                    post_i, pre_d ** 2, pre_i, l2_atol(fixed_q, X))

    # the delta arm: bitwise to its padded batch; against the request alone
    # bitwise where cuBLAS picked the same product, else by tolerance and ids
    delta = (delta_state.delta_vecs, delta_state.delta_ids)
    d_alone_equal, d_err = 0, 0.0
    for q, (d, i) in zip(delta_qs, delta_out):
        pd, pi = approx_knn_search(delta_state.index, pad_rows(q, svc.policy.bucket_for(len(q))),
                                   K, nprobe=nprobe, delta=delta, device=dev)
        assert torch.equal(d, pd[:len(q)]) and torch.equal(i, pi[:len(q)]), (
            "serve_ann_1M: a delta-arm response differs from the search of its padded batch")
        ad, ai = approx_knn_search(delta_state.index, q, K, nprobe=nprobe, delta=delta, device=dev)
        d_alone_equal += int(torch.equal(d, ad) and torch.equal(i, ai))
        d_err = max(d_err, check_knn("serve_ann_1M delta arm vs alone (squared)", d ** 2, i,
                                     ad ** 2, ai, l2_atol(q, X)))
    ann["delta_arm"] = {"requests": len(delta_qs), "bitwise_equal_to_request_alone": d_alone_equal,
                        "max_err_vs_alone": d_err}
    paths[ann_name] = ann
    print("serve_ann_1M: %s; every response bitwise equal to the search of its padded batch"
          % json.dumps({k: v for k, v in ann.items() if k != "calibrate"}), flush=True)
    del svc, index0, pre_swap, post_swap, delta_state

    # 5c. the dense library at BASELINE.md config #2: gemm 4096^3 at both
    # precisions, row norm, the two reductions and the transpose, each held
    # against float64 on the card and timed with CUDA events
    reset()
    A, B = randn(N_LINALG, N_LINALG), randn(N_LINALG, N_LINALG)
    A64, B64 = A.double(), B.double()
    C64 = A64 @ B64
    scale = (A64.abs() @ B64.abs()).max().item()
    lin = {}
    gemm_ops = 2.0 * N_LINALG ** 3
    gemm_bytes = 3 * 4.0 * N_LINALG ** 2
    for prec, peak in (("highest", PEAK_FP32_FLOPS), ("default", PEAK_TF32_FLOPS)):
        err = (linalg.gemm(A, B, precision=prec, device=dev).double() - C64).abs().max().item()
        assert err <= GEMM_RTOL[prec] * scale, (prec, err, scale)
        # ms: one call between two events, the wrapper's host side before
        # the product included; queued_ms: calls enqueued behind a spin,
        # the card's time alone (the TFLOP/s)
        ms = time_ms(lambda: linalg.gemm(A, B, precision=prec, device=dev), reps=10)
        q_ms = queued_ms(lambda: linalg.gemm(A, B, precision=prec, device=dev), calls=10)
        lin["gemm_" + prec] = {"ms": ms, "queued_ms": q_ms, "tflops": gemm_ops / q_ms / 1e9,
                               "peak_tflops": peak / 1e12,
                               "bound_ms": max(gemm_ops / peak, gemm_bytes / PEAK_BYTES) * 1e3,
                               "max_err_over_abs_product": err / scale}
    lin["gemm_highest"]["library_ms"] = time_ms(lambda: torch.mm(A, B), reps=10)
    lin["gemm_highest"]["library_queued_ms"] = queued_ms(lambda: torch.mm(A, B), calls=10)
    # the wrapper's host cost a call (takes_handle, the precision pin, the
    # tracing range and timer): host seconds of calls on 64 x 64 operands,
    # whose products the card runs faster than the host issues them
    a64, b64 = A[:64, :64].contiguous(), B[:64, :64].contiguous()
    host_us, traced = {}, tracing.is_enabled()
    for name, fn in (("torch_mm", lambda: torch.mm(a64, b64)),
                     ("gemm", lambda: linalg.gemm(a64, b64, device=dev)),
                     ("gemm_tracing_off", lambda: linalg.gemm(a64, b64, device=dev)),
                     ("precision_matmul", lambda: precision.matmul(a64, b64)),
                     ("gemm_default", lambda: linalg.gemm(a64, b64, precision="default",
                                                          device=dev))):
        tracing.set_enabled(traced and name != "gemm_tracing_off")
        for _ in range(100):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(2000):
            fn()
        torch.cuda.synchronize()
        host_us[name] = (time.perf_counter() - t0) / 2000 * 1e6
    tracing.set_enabled(traced)
    lin["host_us_per_call_64"] = host_us
    # on a handle's own stream: ordered after this stream's writes of A and
    # B and before its next read, the same product bit for bit
    handle = Handle(dev)
    on_handle = linalg.gemm(A, B, handle=handle)
    handle.sync_stream()
    assert torch.equal(on_handle, linalg.gemm(A, B, device=dev)), "gemm on a handle's stream"
    lin["gemm_on_handle_stream_bitwise"] = True
    del on_handle
    A_abs_rows, A_abs_cols = A64.abs().sum(1), A64.abs().sum(0)
    in_bytes = 4.0 * N_LINALG ** 2
    for name, fn, ref, tol, nbytes in [
            ("row_norm_l2", lambda: linalg.row_norm(A, device=dev), (A64 * A64).sum(1),
             1e-6 * (A64 * A64).sum(1), in_bytes + 4.0 * N_LINALG),
            ("coalesced_reduction_sum", lambda: linalg.coalesced_reduction(A, device=dev),
             A64.sum(1), SUM_RTOL * A_abs_rows, in_bytes + 4.0 * N_LINALG),
            ("strided_reduction_sum", lambda: linalg.strided_reduction(A, device=dev),
             A64.sum(0), SUM_RTOL * A_abs_cols, in_bytes + 4.0 * N_LINALG),
            ("coalesced_reduction_max_tree",
             lambda: linalg.coalesced_reduction(A, reduce_op=torch.maximum,
                                                init=-float("inf"), device=dev),
             A64.amax(1), 0.0, in_bytes + 4.0 * N_LINALG),
            ("transpose", lambda: linalg.transpose(A, device=dev), A64.T, 0.0, 2 * in_bytes)]:
        err = (fn().double() - ref).abs()
        assert (err <= tol).all(), (name, err.max().item())
        # ms: one call, its host side included; queued_ms: the device time
        # of calls enqueued behind a spin
        ms, q_ms = time_ms(fn, reps=20), queued_ms(fn)
        bound_ms = nbytes / PEAK_BYTES * 1e3
        lin[name] = {"ms": ms, "queued_ms": q_ms, "bound_ms": bound_ms, "bound_by": "bytes",
                     "bound_share": bound_ms / q_ms, "max_err": err.max().item()}
    del A, B, A64, B64, C64
    torch.cuda.synchronize()
    lin["launches"] = counts()
    paths["linalg_4096"] = lin
    print("linalg_4096: %s" % json.dumps(lin), flush=True)

    # 5d. Lanczos: the 8 smallest eigenpairs of the 64 x 64 grid Laplacian
    lap64, exact = grid_laplacian(GRID, dev)
    lap = lap64.float()
    reset()
    t0 = time.perf_counter()
    vals, vecs, iters = linalg.compute_smallest_eigenvectors(
        lap, GRID * GRID, N_EIG, maxiter=LANCZOS_MAXITER, restart_iter=LANCZOS_NCV,
        tol=LANCZOS_TOL, seed=SEED, device=dev)
    torch.cuda.synchronize()
    lz_ms = (time.perf_counter() - t0) * 1e3
    v64 = vecs.double()
    resid = torch.linalg.vector_norm(lap64 @ v64 - v64 * vals.double()[None, :], dim=0)
    val_err = (vals.double() - exact).abs()
    assert resid.max().item() <= EIG_ATOL and val_err.max().item() <= EIG_ATOL, (resid, val_err)
    paths["lanczos_grid64"] = {"ms": lz_ms, "iters": iters, "launches": counts(),
                               "max_residual": resid.max().item(),
                               "max_eigenvalue_err": val_err.max().item(),
                               "eigenvalues": vals.tolist()}
    print("lanczos 64 x 64 grid Laplacian, 8 smallest: %.1f ms, %d iterations, residuals <= %.3g, "
          "eigenvalues within %.3g of the closed form (tolerance %g)"
          % (lz_ms, iters, resid.max().item(), val_err.max().item(), EIG_ATOL), flush=True)
    del lap64, lap, vecs, v64

    # 6. kernels at the main paths' shapes: kernel, plain version, yardstick
    launches = {name: sum(p["launches"][name] for p in paths.values() if "launches" in p)
                for name in wrappers}
    rows = []

    def full_l2_topk():
        qn = (queries * queries).sum(1, keepdim=True)
        xn = (index * index).sum(1)
        return torch.topk(qn + xn - 2.0 * (queries @ index.T), K, dim=1, largest=False)

    knn_ops = 2.0 * N_QUERIES * N_INDEX * DIM
    knn_bytes = 4.0 * (N_INDEX + N_QUERIES) * DIM + 8.0 * N_QUERIES * K
    b, by = bound_tf32x3(knn_ops, knn_bytes)
    k1_ms = time_ms(lambda: fused_knn_tile(index, queries, K), reps=5)
    k1_clocks = clocks_line()
    rows.append({
        "name": "knn_tile", "route": "cuda", "source": "raft_tpu_torch/ops/csrc/knn_tile.cu",
        "replaces": "raft_tpu/ops/knn_tile.py:563",
        "shape": "index 1000000x128 f32, 1024 queries, k=100",
        "launches": launches["knn_tile"], "max_abs_err": errs["knn_tile"],
        "ms": k1_ms, "clocks_sm_power_after": k1_clocks,
        "plain_ms": time_ms(lambda: knn_tile_plain(index, queries, K), reps=2),
        "bound_ms": b, "bound_by": by, "bound_fp32_ms": bound(knn_ops, knn_bytes)[0],
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
        "queued_ms": queued_ms(lambda: select_tile(keys, K)),
        "plain_ms": time_ms(lambda: select_tile_plain(keys, K), reps=3),
        "bound_ms": b, "bound_by": by,
        "library_ms": time_ms(lambda: torch.topk(keys, K, dim=1, largest=False), reps=5)})
    # K2 at every shape the paths launched it at (merges of K1's splits, of
    # partitions, of K3's steps and K6's tiles, the probe, the L1 select),
    # on keys like the path's: concatenated sorted runs of k (of 128 for
    # K6's tiles) for the merges, normal keys for the probe and the L1
    # select.  Each shape is held bit for bit against the plain version at
    # k = 1, 32, 64, 100 and 128, and timed at its own k beside torch.topk;
    # the launch-weighted total is what the paths spend in it.
    def k2_keys(m, w, run):
        if not run:
            return randn(m, w)
        return torch.sort(randn(m, w // run, run), dim=2).values.reshape(m, w)

    k2_all = {}
    for path, shp in k2_shapes.items():
        for (m, w, k), n_launch in shp.items():
            run = 128 if path == "knn_twophase_1M" else k
            # the L1 select, the IVF probes (k an nprobe) and the delta merge
            # (one sorted run of k, then the delta's keys) take normal keys
            normal = (path == "bfknn_L1_100k" or w % run
                      or (path in ("ivf_search_1M", "serve_ann_1M") and k != K))
            run = None if normal else run
            k2_all[(m, w, k, run)] = k2_all.get((m, w, k, run), 0) + n_launch
    k2_rows = []
    for (m, w, k, run), n_launch in sorted(k2_all.items(), key=lambda kv: kv[0][:3]):
        path_keys = k2_keys(m, w, run)
        for kk in (1, 32, 64, 100, 128):
            check_select("at a path's shape", path_keys, kk)
        chunks = plan(m, w, k)
        topk = lambda: torch.topk(path_keys, k, dim=1, largest=False)  # noqa: E731
        k2_rows.append({"rows": m, "width": w, "k": k, "launches": n_launch,
                        "keys": "sorted runs of %d" % run if run else "normal",
                        "route": "wide, %d blocks a row" % chunks if chunks else "held",
                        "ms": time_ms(lambda: select_tile(path_keys, k), reps=20),
                        "queued_ms": queued_ms(lambda: select_tile(path_keys, k)),
                        "bound_ms": (4.0 * m * w + 8.0 * m * k) / PEAK_BYTES * 1e3,
                        "bound_by": "bytes",
                        "library_ms": time_ms(topk, reps=20),
                        "library_queued_ms": queued_ms(topk)})
        del path_keys
    print("check select_tile at the paths' %d shapes, k 1/32/64/100/128: exact" % len(k2_rows),
          flush=True)
    rows[-1]["shapes"] = k2_rows
    rows[-1]["launch_weighted_ms"] = sum(r["launches"] * r["ms"] for r in k2_rows)
    rows[-1]["launch_weighted_queued_ms"] = sum(r["launches"] * r["queued_ms"] for r in k2_rows)
    rows[-1]["launch_weighted_bound_ms"] = sum(r["launches"] * r["bound_ms"] for r in k2_rows)
    rows[-1]["launch_weighted_library_ms"] = sum(r["launches"] * r["library_ms"]
                                                 for r in k2_rows)
    rows[-1]["launch_weighted_library_queued_ms"] = sum(r["launches"] * r["library_queued_ms"]
                                                         for r in k2_rows)

    ref_keys = pairwise_tile_plain(queries, index_l1, D.L1)
    errs["pairwise_tile"] = max(errs["pairwise_tile"], (keys - ref_keys).abs().max().item())
    del ref_keys
    # K5's bound: issued FP32 instructions, K5_INSTR_PER_STEP a step, 128 a
    # clock on each SM at the SM clock read right after the timing
    k5_ms = time_ms(lambda: pairwise_tile(queries, index_l1, D.L1), reps=5)
    k5_clocks = clocks_line()
    k5_metric_ms = {metric.name: time_ms(lambda: pairwise_tile(queries, index_l1, metric), reps=3)
                    for metric in (D.L2Unexpanded, D.Linf)}
    sm_hz = float(k5_clocks.split(",")[0].split()[0]) * 1e6
    t_ops = (1.0 * N_QUERIES * N_L1 * DIM * K5_INSTR_PER_STEP / (128.0 * n_sms * sm_hz) * 1e3)
    t_bytes = (4.0 * (N_QUERIES + N_L1) * DIM + 4.0 * N_QUERIES * N_L1) / PEAK_BYTES * 1e3
    rows.append({
        "name": "pairwise_tile", "route": "cuda",
        "source": "raft_tpu_torch/ops/csrc/pairwise_tile.cu",
        "replaces": "raft_tpu/ops/pairwise_tile.py:133",
        "shape": "L1, x 1024x128, y 100000x128 f32",
        "launches": launches["pairwise_tile"], "max_abs_err": errs["pairwise_tile"],
        "ms": k5_ms, "clocks_sm_power_after": k5_clocks, "metric_ms": k5_metric_ms,
        "plain_ms": time_ms(lambda: pairwise_tile_plain(queries, index_l1, D.L1), reps=2),
        "bound_ms": max(t_ops, t_bytes), "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "bound_note": "%d FP32 instructions a step (L1, L2Unexpanded, Linf), 128 a clock on "
                      "each of %d SMs at %.0f MHz" % (K5_INSTR_PER_STEP, n_sms, sm_hz / 1e6),
        "library_ms": time_ms(lambda: torch.cdist(queries, index_l1, p=1), reps=3)})
    del keys

    # K4 at the build's assignment: the training rows against the centroids
    xs, cents = X[:TRAIN_ROWS], ivf.centroids
    got, ref = fused_nn_tile(xs, cents), nn_tile_plain(xs, cents)
    errs["nn_tile"] = max(errs["nn_tile"], check_nn("nn_tile at the build's shape", *got, *ref,
                                                    xs, cents, l2_atol(xs, cents)))

    def l2_min():
        xn, cn = (xs * xs).sum(1), (cents * cents).sum(1)
        return torch.min(xn[:, None] + cn[None, :] - 2.0 * (xs @ cents.T), dim=1)

    m, n = xs.shape[0], cents.shape[0]
    nn_ops, nn_bytes = 2.0 * m * n * DIM, 4.0 * (m + n) * DIM + 8.0 * m
    b, by = bound_tf32x3(nn_ops, nn_bytes)
    rows.append({
        "name": "nn_tile", "route": "cuda", "source": "raft_tpu_torch/ops/csrc/nn_tile.cu",
        "replaces": "raft_tpu/ops/nn_tile.py:151",
        "shape": "x %dx%d f32 against %d centroids" % (m, DIM, n),
        "launches": launches["nn_tile"], "max_abs_err": errs["nn_tile"],
        "ms": time_ms(lambda: fused_nn_tile(xs, cents), reps=10),
        "plain_ms": time_ms(lambda: nn_tile_plain(xs, cents), reps=5),
        "bound_ms": b, "bound_by": by, "bound_fp32_ms": bound(nn_ops, nn_bytes)[0],
        "library_ms": time_ms(l2_min, reps=5),
        "library": "composition: expanded-L2 matmul + torch.min(dim=1)"})

    # K2 at the search's probe: the query-to-centroid keys, k = nprobe
    probe_keys = expanded_sq_dists(ivf_q, ivf.centroids)
    got, ref = select_tile(probe_keys, NPROBE), select_tile_plain(probe_keys, NPROBE)
    check_exact("select_tile probe values", got[0], ref[0])
    check_exact("select_tile probe ids", got[1], ref[1])
    print("check select_tile at the probe, keys %dx%d k=%d: exact"
          % (*probe_keys.shape, NPROBE), flush=True)

    # K3 at the search's scan lists: the whole function, and its three
    # steps apart (the inversion into a work list, the kernel, K2's merge)
    slots, _ = _probe_compact(ivf_q, ivf.centroids, ivf.cent_slots, NPROBE)
    scan_args = (ivf_q, ivf.slot_vecs, ivf.slot_norms, ivf.slot_ids, slots, K)
    got, ref = fused_ivf_scan(*scan_args), fused_ivf_scan_plain(*scan_args)
    errs["ivf_tile"] = max(errs["ivf_tile"], check_knn("ivf_tile at the search's shape",
                                                       *got, *ref, ivf_atol))
    S, cap = ivf.slot_ids.shape
    n_steps = slots.shape[1]
    n_q = item_queries(DIM, dev)
    work = scan_work_list(slots, S, cap, n_q)
    flat = (ivf_q, ivf.slot_vecs.reshape(S * cap, DIM), ivf.slot_norms.reshape(-1),
            ivf.slot_ids.reshape(-1), work, cap, K, N_QUERIES * n_steps)
    part = ivf_items(*flat)
    errs["ivf_tile"] = max(errs["ivf_tile"], check_knn("ivf_tile kernel alone at the search's "
                                                       "shape", *part, *ivf_items_plain(*flat),
                                                       ivf_atol))

    def merge():
        d, pos = select_tile(part[0].view(N_QUERIES, -1), K)
        return d, torch.gather(part[1].view(N_QUERIES, -1), 1, pos.long())

    # the work these lists need: every stored row of each listed slot, once
    # per query (operations); the distinct slots of the batch, each read
    # once (least bytes), beside the bytes of reading them per query and
    # once per item
    rows_in_slot = (ivf.slot_ids >= 0).sum(dim=1)
    live = slots >= 0
    rows_scanned = int(rows_in_slot[slots[live].long()].sum())
    rows_distinct = int(rows_in_slot[torch.unique(slots[live].long())].sum())
    row_bytes = 4.0 * DIM + 8.0                  # vector, norm, id
    io_bytes = 4.0 * N_QUERIES * DIM + 4.0 * slots.numel() + 8.0 * N_QUERIES * K
    n_items = int(work.n_items)
    scan_ops = 2.0 * DIM * rows_scanned
    b, by = bound_tf32x3(scan_ops, rows_distinct * row_bytes + io_bytes)
    rows.append({
        "name": "ivf_tile", "route": "cuda", "source": "raft_tpu_torch/ops/csrc/ivf_tile.cu",
        "replaces": "raft_tpu/ops/ivf_tile.py:230",
        "shape": "%d queries x %d scan steps (%d live at most, %d live in all), slots of %d x %d "
                 "f32, k=%d; %d items of up to %d entries"
                 % (N_QUERIES, n_steps, int(live.sum(1).max()), int(live.sum()), cap, DIM, K,
                    n_items, n_q),
        "launches": launches["ivf_tile"], "max_abs_err": errs["ivf_tile"],
        "ms": time_ms(lambda: fused_ivf_scan(*scan_args), reps=5),
        "glue_ms": time_ms(lambda: scan_work_list(slots, S, cap, n_q), reps=5),
        "kernel_ms": time_ms(lambda: ivf_items(*flat), reps=5),
        "merge_ms": time_ms(merge, reps=5),
        "plain_ms": time_ms(lambda: fused_ivf_scan_plain(*scan_args), reps=2),
        "bound_ms": b, "bound_by": by,
        "bound_fp32_ms": bound(scan_ops, rows_distinct * row_bytes + io_bytes)[0],
        "library_ms": None, "library": "none: no single PyTorch call scans an IVF list",
        "bf16_ms": time_ms(lambda: fused_ivf_scan(*scan_args, accum_bf16=True), reps=5),
        "bf16_kernel_ms": time_ms(lambda: ivf_items(*flat, accum_bf16=True), reps=5),
        "rows_scanned": rows_scanned, "least_bytes": rows_distinct * row_bytes + io_bytes,
        "item_bytes": n_items * cap * row_bytes + io_bytes,
        "per_query_bytes": rows_scanned * row_bytes + io_bytes})

    # K6 at the two-phase path's shape: the whole call and phase 1 alone
    bn, n_tiles = twophase_geometry(N_INDEX, TWOPHASE_BLOCK_N)
    b, by = bound_tf32x3(knn_ops, knn_bytes)
    rows.append({
        "name": "knn_twophase", "route": "cuda",
        "source": "raft_tpu_torch/ops/csrc/knn_twophase.cu",
        "replaces": "raft_tpu/ops/knn_tile.py:474",
        "shape": "index 1000000x128 f32, 1024 queries, k=100, block_n %d (%d tiles)"
                 % (bn, n_tiles),
        "launches": launches["knn_twophase"], "max_abs_err": errs["knn_twophase"],
        "ms": time_ms(lambda: fused_knn_twophase(index, queries, K, block_n=TWOPHASE_BLOCK_N),
                      reps=5),
        "phase1_ms": time_ms(lambda: twophase_tiles(index, queries, bn), reps=5),
        "plain_ms": time_ms(lambda: knn_twophase_plain(index, queries, K, TWOPHASE_BLOCK_N),
                            reps=2),
        "bound_ms": b, "bound_by": by, "bound_fp32_ms": bound(knn_ops, knn_bytes)[0],
        "phase1_bytes": 4.0 * (N_INDEX + N_QUERIES) * DIM + 8.0 * N_QUERIES * n_tiles * 128,
        "library_ms": time_ms(full_l2_topk, reps=3),
        "library": "composition: expanded-L2 matmul + torch.topk, as K1's"})

    print(json.dumps({"card": card, "paths": paths}))
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
