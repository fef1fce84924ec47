#!/usr/bin/env python3
"""Smoke run of raft_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from ``raft_tpu_torch/ops/csrc`` with nvcc, holds
each kernel against its plain PyTorch version on the card, and drives the
paths through the public entry points with ``device="cuda"``:

- exact brute-force kNN, 1M x 128 float32, 1024 queries, k=100
  (``brute_force_knn``), in one partition and in four, and the L1 path
  (pairwise K5 + select K2) at 100k x 128; K1 also at the benchmark's
  batch of 10,000 queries, k 100 and 10, against its plain version, with
  K2's merge of its index splits bit for bit and K6 beside it;
- the two-phase fused kNN (``fused_knn_twophase``, K6 then K2) on the
  same index and queries at ``block_n`` 2048, held against K1's result;
- the kNN's reduced-precision and approximate modes on the same data
  (``precision_paths``): ``bfknn_1M_bf16`` (``precision="default"``, K1's
  bfloat16 instance, held to the tile scan at "default", recall@100
  against float32), ``knn_twophase_1M_bf16`` (K6's), ``knn_rerank_1M``
  (``rerank_ratio=4``), ``knn_approx95_1M`` (the tile scan under
  ``select_impl="approx95"``, its bins and folds) with recall@100
  against exact, and ``serve_knn_1M_bf16`` (``KNNService`` at "default",
  4 threads, bitwise its unbatched calls);
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
  (dense 4096 x 4096), residuals and eigenvalues against the closed form;
- K3's bounded partial buffers (``ivf_full_probe_1M``): a full probe of
  the 1M index with 1024 queries, chunked and in one chunk, their peak
  allocations, recall@100 against brute force, the two bitwise equal
  (and at 128 queries, 4 chunks against one);
- spectral partitioning on CSR (``BASELINE.md`` config #4), on the graph
  of ``bench.py:two_community_graph`` (a copy in numpy, deduplicated by
  the port's ``max_duplicates``): ``partition`` at 100,000 vertices (the
  JAX rung) and at 1,000,000, ARI against the planted halves above 0.95,
  the edge cut at most 3 x 40, a second solve bitwise equal to the
  first, the SpMV against float64 and queued beside its bytes bound, and
  the device's busy share of a third solve from a trace;
  ``modularity_maximization`` at 100k (Q against float64); and
  ``fit_embedding`` on the 2,048-vertex graph of ``bench.py:_bench_spectral``,
  its span against the float64 eigenvectors;
- single linkage (``sparse.hierarchy.single_linkage``) on the blobs of
  ``bench.py:make_blobs`` (a numpy copy): the JAX rung at 50,000 x 2
  (``single_linkage_50k``) and 1,000,000 x 16 (``single_linkage_1M``),
  3 clusters, kNN graph with c = 15 (K1): three labels, ARI above 0.99
  against the blobs and against scipy's single linkage on a 2,000-point
  subsample, two runs bitwise equal, each stage's time, the peak
  allocation, and at 1M the device's busy share of a traced run; K1 at
  the kNN graph's shape against its plain version, and at 50k the host
  runtime's cut timed beside the port's, the labels equal;
- the sparse engine at the 20 newsgroups shape (``sparse_l1_newsgroups``,
  11,314 x 130,107, 150 Zipf terms a row drawn on the card): the L1
  ``sparse.distance.pairwise_distance`` (column-tiled, K5 without its
  epilog over two column tiles) against scipy in float64 on 4,096 pairs,
  and ``sparse.selection.brute_force_knn`` (k = 10, K5 then K2) against
  the pairwise matrix's top-k, each twice bitwise equal, with K5's share
  of each call from a trace; K5 against its plain version on the path's
  own densified blocks (the kNN's, at the whole depth with the epilog;
  the pairwise engine's, over each column tile without it);
- IVF-PQ and IVF-SQ on the IVF-Flat path's mixture, nlist and metric
  (``ivf_pq_1M``: M 16, 8 bits, refine ratio 4, built in stages, searched
  at k 10 and nprobe 32 refined and unrefined, the unrefined ADC
  distances held in float64 to the vectors the returned codes decode to,
  and the decoded vectors' own exact top-10 as the quantizer's ceiling;
  ``ivf_sq_1M``: QT_8bit of the residuals), recall@10 against brute
  force and the index bytes; K7 (``ops/pq_scan.py``, the ADC scan both
  searches take) against its plain version at ivf_pq_1M's shape (kk 40
  and 10, and the served arm's 400) and at
  the benchmark's ``sift1m_ivfpq`` shape (an M-64 index of the same
  mixture, 10,000 queries at nprobe 50, kk 200), timed beside its
  bounds, the plain version and a gather-and-sum yardstick; their
  ``ANNService`` arms under the ``serve_ann_1M`` traffic
  (``serve_ann_pq_1M``, ``serve_ann_sq_1M``: every response bitwise equal
  to its padded batch's search, ``compact()`` raising, each of 2,048
  inserts found by a query of itself); ``persist_ann_1M``: for the three
  kinds a persist directory under ``build/``, a snapshot on the
  maintenance tick, a WAL tail, a crash and the restore from the
  directory alone, served answers bitwise equal, then a flipped byte
  refused with ``DataCorruptionError``;
- the random ball cover: all-points kNN (k 8) of 1,000,000 uniform
  lat/lon points under Haversine (``rbc_haversine_1M``) and 65,536
  queries (k 16) against 1,000,000 uniform 3-D points
  (``rbc_l2_3d_1M``), each exact on 1,024 rows against a float64 scan or
  brute force, with the loop steps, chunks and peak bytes;
- the out-of-core IVF-Flat tier (``serve_ann_ooc_1M``, the JAX
  ``serve_ann_ooc`` rung, ``bench.py:1399-1520``): the mixture in 2048
  lists (train_rows 65,536), served by ``ANNService`` at k 100 and
  nprobe 8 (ladder 4/8, rungs 8/32/64/128) under 8 threads of 16-row
  requests in a closed loop, in three arms over one index: resident
  (2 s), out-of-core double-buffered (4 s; ``ivf_flat_to_ooc``, the
  resident slot vectors freed first) and out-of-core synchronous
  (``ooc_overlap=False``, 4 s), each under a device budget of a quarter
  of the slot store.  The JAX rung selects approximately
  (``select_impl="approx"``, which the port has no counterpart for: its
  selects, K2 and the stable sort, are exact); every arm here selects
  exactly.  Per arm rows/s and p50/p99; per out-of-core arm the tile hit
  rate, H2D MB, the hidden share of the transfer (1 - stall / h2d), the
  staged-bytes high water beside the pool's budget, the hot set, the
  peak allocation above the arm's start; ``overlap_speedup`` and
  ``qps_vs_resident``; one 32-slot tile's pinned copy (GB/s) and host
  gather.  1,024 fixed queries (8 requests of 128 rows, a batch each)
  through every arm: the out-of-core distances bitwise the resident
  arm's, the ids equal except among ties, recall@100 (256 rows, against
  K1) equal; the staged high water within the pool's budget, the peak
  under half the store; K3 held at a staged tile's geometry (32 slots, a
  128-row batch);
- the multi-GPU session on worlds of rank slots on the card (queue 1
  item 6; ranks that share one card measure the cost of the merge, not
  scaling): ``comms_selftest_4`` (the self-test battery on a world of 4,
  the status test, and a ring of 1 MB rows by the device, ppermute and
  host routes: zero host-staged bytes on the first two, the host route's
  counted); ``mnmg_knn_1M`` (``BASELINE.md`` config #5 at config #3's
  shape: the 1M index sharded over 4 ranks, allgather, ring and
  hierarchical (group 2) and a world of 1, each held to
  ``brute_force_knn``, the three bitwise equal, ms each and the merge's
  share beside the local searches alone, K1 at a shard's shape, K2 bit
  for bit on the merges' own keys); ``mnmg_ivf_1M`` (the IVF-Flat index
  slot-sharded over 4 ranks at nprobe 32: distances within 1e-4 of
  ``ivf_flat_search``, ids equal but for rows that differ among ties,
  counted; a full probe against brute force; K3 at a rank's slots);
  ``serve_knn_sharded_500k`` (the JAX serve_sharded rung,
  ``bench.py:1167-1247``: 500,000 x 128, k 100, a closed loop of 16
  threads sending 16-row requests from the rung's query pool (index rows
  plus noise), rungs 8/32/64/128, a 4 s window for each of worlds 1, 2,
  4 and 8 hierarchical and 2 s for each other topology at 8; every
  response bitwise equal to the unbatched sharded call of its rows, no
  kernel build after warmup);
  ``session_recover`` (a session on a world of 4 serving a sharded
  ``KNNService`` over the 500k rows and a sharded ``ANNService`` over the
  IVF index with 2,048 inserts; rank 3 lost through the fault seam,
  ``health_check`` flags it and verbs fail fast; ``RecoveryManager``
  onto ranks 0-2: the self-tests pass on 3, both services re-partitioned,
  fixed queries against the single-device answers, every insert found at
  distance 0 with its own id; each phase's seconds); and
  ``serve_knn_replicas`` (two replicas of two ranks, a fixed hedge of
  25 ms, the same pool and loop for 4 s unfaulted and 4 s with replica 1
  delayed 0.1 s: hedges fire and
  win, every response bitwise equal to the unbatched call, p50 and p99
  and the hedge and failover counters).  Where the machine shows more
  than one card, ``mnmg_knn_1M`` also runs over distinct cards.
- the multi-process session (queue 1 item 8, ``mp_paths``): two child
  processes of ``python -m raft_tpu_torch.comms.mp_selftest``, two rank
  slots each on ``cuda:0``, one session over ``torch.distributed`` (a
  world of 4 spanning 2 processes; both on one card, so the backend rule
  picks gloo): ``mp_comms_selftest_4`` (the 14 self-tests in each child,
  a split by process, ``health_check``, the registry, the backend, the
  host-staged bytes, no kernel built in a child); ``mp_mnmg_knn_1M``
  (config #5 at config #3's shape, 1M x 128 drawn by numpy from seed 7
  in each child and here, 1024 queries, k 100, each merge) and
  ``mp_mnmg_ivf_1M`` (this script's IVF index written once with the
  port's snapshot under ``build/mp/`` and restored by each child, its
  digest held to this one's; nprobe 32): every child's answer bitwise
  equal to this process's world of 4 (SHA-256 of the distance and id
  bytes), each child's median ms a topology, the exchange's share and
  bytes a search, K1 and K3 held against their plain versions in each
  child; ``mp_bootstrap`` (a session aimed at a coordinator nobody serves
  raises ``CommError`` after 3 attempts within its bound; child 1 starts
  3 s after child 0's store answers, so child 0's bootstrap retries,
  then succeeds).  The children's K1, K2 and K3 launches join the
  ``kernels`` line.  Where the machine shows two or more cards the NCCL
  route runs too (a child a card); otherwise a line says it was not run.
  ``build/mp/`` is removed after; no child outlives the phase.
- the fleet (queue 1 item 7), a ``Router`` in this process and worker
  processes (``python -m raft_tpu_torch.fleet.worker``) on ``cuda:0``:
  ``fleet_ann_1M`` (the 1M x 128 mixture of ``fleet/worker.py:_synth``,
  seed 5, 64 clusters, k 100, 512 lists a shard at nprobe 32, the WAL
  fsync'd before every ack) as one worker holding the whole index and
  as two holding 500,000 rows each: time to ready, 8 client threads of
  16-row requests for 5 s (rows/s, p50/p99, errors), recall@100 on 256
  queries against K1's exact top 100 in this process, the router's
  answers bitwise equal to the merge of each worker's own ``/search``,
  every ops-plane endpoint of each worker (K2, K3 and K4 in its
  inventory with their counts, no kernel build or load after warmup)
  and the router's, and w0's device idle share from a ``torch.profiler``
  window inside the load (``POST /debug/profile``); then the chaos arm
  on the two workers (query threads and 8-row WAL-acked inserts while
  w1 takes a ``SIGKILL`` and restarts from snapshot + WAL: the fleet
  reads degraded and the router's sentinel trips ``worker_dead``, then
  both clear after the rejoin; every acked id answers at distance 0
  under its own id; every admitted request has one terminal flight
  event; four fixed requests answer bitwise alike before the kill and
  after the rejoin; the restore's seconds and replayed records, the
  rows/s before and after); and ``fleet_replicated_200k`` (two workers
  each holding 200,000 rows, a hedge of 60 ms, one tenant's primary
  hung through ``/chaos`` for 1 s: every request answered, hedges and
  wins counted).  The kernels' launches on these paths are read from
  the workers' inventories.  No worker outlives its fleet.
- the load generator's scenarios (queue 1 item 9, ``loadgen_paths``):
  ``tools/torch_loadgen.py``'s ``run_*`` functions in this process, 4 s
  windows of 16-row requests: ``loadgen_chaos_1M`` (``KNNService`` over
  the 1M index, k 100, 4 threads, seeds 0 and 1: transient faults at p
  0.05 at the serve seam, a 0.8 s outage at 35% of the window,
  ``RecoveryManager``), ``loadgen_kill_shard_1M`` (the same on a world
  of 4 rank slots that loses its last: re-partitioned over 3, the
  post-heal answer equal to ``brute_force_knn``), ``loadgen_hedge_chaos_1M``
  (2 replicas, a 25 ms hedge, replica 0 held 0.4 s a batch for half the
  window: hedges win), ``loadgen_tenants_1M`` (weights interactive:4,
  bulk:1, bulk 300 qps of 32 rows: every shed typed),
  ``loadgen_ooc_chaos_1M`` (the chaos arm on the out-of-core
  ``ANNService`` over the 1M IVF-Flat index at a quarter of its store),
  ``loadgen_crash_restart_1M`` (a persistent ``ANNService`` over a fresh
  1M x 128 build into 1024 lists under queries and 8-row inserts, dropped
  with no final snapshot and restored from ``build/loadgen/``: no acked
  insert lost, answers bitwise, nothing built after the restore's
  warmup), ``loadgen_ops_scrape_1M`` (``ANNService``, 8 threads, two
  windows, the second scraped at 1 Hz) and ``loadgen_fleet_200k`` (two
  sharded workers of 100,000 rows, cut from 1M for the spawn and rejoin
  time, under the seeded schedule of ``FLEET_SEED``: a kill and
  restart, frame faults; no acked row lost, one terminal a request,
  healed); the ANN arms at the nprobe ``serve_ann_1M`` calibrated.  Each
  prints rows/s, p50/p99, its invariants and ``ok``, recovery or restore
  seconds and K1, K2 and K3 launches (the fleet's from the workers'
  inventories).  Then ``reports``: ``tools/torch_trace_report.py`` renders
  the chaos arm's flight dump (summary, a waterfall, Chrome JSON) and a
  fleet request's joined trace (no problems), and
  ``tools/torch_metrics_report.py`` this process's ``metrics_snapshot()``
  (its sections and line counts).
- the tuning half (queue 1 item 7b, ``tuning``): the checked-in table of
  this card's fingerprint (``raft_tpu_torch/tuning/``, written by
  ``tools/torch_autotune.py``; where none matches, a line says so and
  ``torch_autotune --smoke`` sweeps this card in this process), installed
  for this path only and cleared before the next, so every other path
  runs the untuned dispatch.  At the main path's cell of each tuned knob
  (``select_k`` of 1024 x 100,000 keys at k 100, ``brute_force_knn`` at
  1M x 128, ``fused_knn_twophase`` there with ``block_n`` unset,
  ``ivf_flat_search`` of the 1M index): the resolved impl and
  its rung, the tuned answer against the untuned one (bitwise where the
  routes are the same or both select exactly, else within the tolerance
  with id sets equal but for ties), ``tuned_vs_default`` with
  ``_build.stats()`` unchanged through its timed loops, the table's hit,
  miss and discarded lookups.  The script's first step is
  ``specializations.warmup()`` on the build directory (``nvcc`` for the
  six at once, each library loaded, the hot configurations run); this
  path warms a fresh process from the same directory (no build: the
  libraries are the persistent cache), its load seconds beside the
  first step's build seconds.

It checks that each path launched its kernels, and times every kernel
beside its plain version and, where one exists, a single-call PyTorch
yardstick; K1, K4 and K6 at both precisions (their rows add the
bfloat16 instance's ``bf16_*`` times and bounds beside ``torch.mm`` of
bfloat16 operands to float32), and K3 at "default" bitwise its
``accum_bf16``.  K1 and K6 are also held against their plain versions on
offset data (100 + N(0, 1)) and on uniform [0, 1) data at depth 128;
K1, K3, K4 and K6 (3xTF32 on the tensor
cores) carry the 3xTF32 bound beside the float32 FFMA one, and the card's
SM clock and power draw are read right after the K1 timing.  K3 is held
against its plain version as a whole and as the kernel alone on the same
work list, at every check store (one with a slot that every query
probes, so that it takes several items) and at the search's shape, and
its row times the inversion of the scan lists, the kernel and K2's merge
apart.  K4 is checked to d = 300 and m = 9,000, on a row with no
finite distance, and at a PQ codebook's shape (1M x 8 against 256).  K2 is held bit for bit against its plain version, and
its route against the Python mirror, on few wide rows, on rows of 4
distinct values (ties across every chunk, and rows that take the whole
row where the sampled bound keeps too many keys), on rows
all +inf, with NaN and fewer than k other keys and with signed zeros, at
w = k, and at every shape the paths launched it at with k = 1, 32, 64,
100 and 128; its row times each of those shapes on keys like the path's
beside ``torch.topk``, with their launch-weighted total.  K5 is held
against its plain version for every metric at ragged shapes, depths 1,
3, 77, 128, 300 and 4096 and rows off 16-byte alignment, with and without
its epilog (the accumulate-only mode, also timed at the column-tiled
engine's 1024 x 1024 x 65,536); its bound counts
the FP32 instructions a step issues at the SM clock read after its
timing.  ``ivf_flat_build`` runs twice with one seed and must give the
same index bit for bit.  Any failure raises, and the script exits
non-zero without the final line.  It needs a CUDA device and the
repository beside it.

Output: the card (``nvidia-smi``), versions, build seconds, one line per
check, a ``paths`` JSON line (launches and end-to-end milliseconds per
path), a ``kernels`` JSON line, and last ``{"ok": true, "device": ...}``.
"""

import ast
import contextlib
import itertools
import json
import statistics
import subprocess
import sys
import threading
import time
import types
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
SEED = 0
N_INDEX, N_QUERIES, DIM, K = 1_000_000, 1024, 128, 100
N_L1 = 100_000
N_CHECK = 128              # main-path queries held against the plain version
N_BATCH = 10_000           # queries a call of the benchmark's brute-force cells (k 100 and 10)
# IVF-Flat: bench.py serve_ann_1m (nlist 1024, train_rows 131,072), the
# nprobe of its _bench_ivf, and the Gaussian mixture of its make_blobs
# (256 blobs, spread 0.35)
NLIST, NPROBE, TRAIN_ROWS = 1024, 32, 131_072
N_BLOBS, BLOB_SPREAD = 256, 0.35
N_FULL_PROBE = 64          # queries searched at nprobe = nlist
# K6: the JAX knn_1m_twophase rung (bench.py:644-650) uses block_n 2048;
# the kernel checks cover the smallest rung too
TWOPHASE_BLOCK_N = 2048
# the precisions of K1, K3, K4 and K6: 3xTF32, and the bfloat16 instance
PRECISIONS = ("highest", "default")
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
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12
OFFSET = 100.0             # offset data for K1 and K6: the expanded form cancels most
# spectral partitioning on CSR (BASELINE.md config #4): the graph of
# bench.py:two_community_graph with 40 bridges at the JAX rung's size
# (bench.py:2598-2621, 100,000 vertices) and at 1,000,000, with the stored
# entries it has after the dedup; the rung's solver; the 2,048-vertex
# graph and the fit_embedding call of bench.py:2624-2648
SPECTRAL_CROSS = 40
SPECTRAL_SIZES = {"100k": (50_000, 600_034), "1M": (500_000, 6_000_046)}
SPECTRAL_SOLVER = dict(n_eig_vecs=2, max_iter=6000, restart_iter=80, tol=1e-3, seed=42)
EMBED_N, EMBED_COMPONENTS = 2048, 4
EMBED_TOLS = (0.01, 1e-5)  # the rung's tol (timed), and one that resolves the span
SPMV_RTOL = 1e-5           # float32 sum of a row's terms, of the sum of their |.|
CUMSUM_RTOL = 1e-4         # the "cumsum" SpMV: a float32 running sum of up to 6M terms
# the SpMV's least bytes: a column id, a value and a gathered x element an
# entry; an indptr entry, an x and a y element a row
SPMV_BYTES_PER_NNZ, SPMV_BYTES_PER_ROW = 12, 12
# single linkage: the JAX rung (bench.py:2576-2595: make_blobs at 50,000 x
# 2, 3 blobs, seed 0, kNN graph with c = 15) and the same generator at
# 1,000,000 x 16; the checks of tests/test_scale_stress.py:42-70
LINKAGE_SIZES = {"50k": (50_000, 2), "1M": (1_000_000, 16)}
LINKAGE_BLOBS, LINKAGE_SUBSAMPLE, LINKAGE_MIN_ARI = 3, 2_000, 0.99
# the sizes at which the host runtime's cut (rt_extract_clusters, a walk
# from every leaf to its root) is timed beside the port's and must give
# the same labels; it grows with m times the tree's depth
LINKAGE_HOST_CUT_SIZES = ("50k",)
# the sparse engine at the shape of scikit-learn's
# fetch_20newsgroups_vectorized train split (synthetic data, Zipf s = 1)
NEWS_ROWS, NEWS_COLS, NEWS_TERMS, NEWS_ZIPF = 11_314, 130_107, 150, 1.0
NEWS_K, NEWS_PAIRS, NEWS_PAIR_RTOL, NEWS_KNN_RTOL = 10, 4096, 1e-4, 1e-5
# the row blocks of sparse pairwise_distance and brute_force_knn (their
# defaults), at which K5 is held against its plain version on the path's
# own densified blocks
NEWS_PAIRWISE_BLOCK, NEWS_KNN_BLOCK = 1024, 2048
# K5's accumulate-only launch of the column-tiled engine at that shape,
# and its tolerance against the plain version, of the largest sum
K5_RAW_SHAPE, K5_RAW_RTOL = (1024, 1024, 65_536), 1e-4
# IVF-PQ and IVF-SQ on the IVF-Flat path's data, nlist, train_rows and
# metric: the JAX ivf_pq rung (bench.py:2463-2477: M 16, 8 bits, refine
# ratio 4), searched at k 10 and nprobe 32 (bench.py:_bench_ivf); the
# served arms take the serve_ann_1M traffic at its k of 100
PQ_M, PQ_BITS, PQ_REFINE, QK = 16, 8, 4, 10
# the ADC distances against the decoded vectors' own, in float64, of the
# largest squared distance, on the first PQ_DECODE_ROWS queries
PQ_DECODE_TOL, PQ_DECODE_ROWS = 1e-4, 256
# K7 at the benchmark's sift1m_ivfpq shape (10,000 queries, nprobe 50, M 64
# x 8 bits, k 100 x refine 2 = kk 200) on the path's mixture and nlist, and
# at ivf_pq_1M's (the 1024 queries, nprobe 32, M 16, kk 40 and 10, and the
# serve_ann_pq_1M arm's k 100 x refine 4 = kk 400); its
# plain version runs in chunks of PQ_PLAIN_CHUNK queries (a query's tables
# are 3.3 MB at the cell's shape), the library yardstick in chunks of
# PQ_LIBRARY_CHUNK; ids agree as sets but for ADC ties of the kk-th within
# PQ_TIE_RTOL, distances within PQ_DIST_RTOL of the row's largest; the
# lookup bound at 32 shared-memory reads a clock an SM at the H100 SXM's
# boost clock
PQ_CELL_QUERIES, PQ_CELL_NPROBE, PQ_CELL_M, PQ_CELL_KK = 10_000, 50, 64, 200
PQ_PLAIN_CHUNK, PQ_LIBRARY_CHUNK = 1000, 16
PQ_TIE_RTOL, PQ_DIST_RTOL = 1e-6, 1e-5
SM_CLOCK_HZ, SMEM_LOOKUPS_PER_CLOCK = 1.98e9, 32
# the ball cover: 1,000,000 uniform lat/lon points (tests/test_ann.py:299-302)
# with all-points k 8, and 1,000,000 x 3 uniform points (tests/test_ann.py:318-319)
# with 65,536 queries at k 16; L = sqrt(m) landmarks; exactness on 1024 rows
RBC_M, RBC_HAV_K, RBC_L2_K, RBC_L2_QUERIES, RBC_CHECK = 1_000_000, 8, 16, 65_536, 1024
RBC_HAV_ATOL = 1e-5
# the out-of-core tier (serve_ann_ooc_1M): the JAX serve_ann_ooc rung
# (bench.py:1399-1520, called at :2792-2794): the 1M x 128 mixture into
# 2048 lists (train_rows 65,536), k 100 at nprobe 8, the serve_ann rungs,
# 8 threads of 16-row requests in a closed loop, a device budget of a
# quarter of the slot store; 1024 fixed queries (8 requests of 128 rows,
# one batch each) held across the arms, 256 of them against K1's top-100
OOC_NLIST, OOC_TRAIN_ROWS, OOC_NPROBE, OOC_BUDGET_FRAC = 2048, 65_536, 8, 0.25
OOC_THREADS, OOC_ROWS, OOC_RESIDENT_S, OOC_ARM_S = 8, 16, 2.0, 4.0
OOC_FIXED, OOC_RECALL_ROWS, OOC_PEAK_FRAC = 1024, 256, 0.5
# the multi-GPU session (queue 1 item 6): a world of 4 rank slots on the
# card for BASELINE.md config #5 at config #3's shape; the p2p ring's rows
# (1 MB); the sharded distances' tolerance against the unsharded search
# (tests/test_mnmg.py:216-229); the JAX serve_sharded rung
# (bench.py:1167-1247, called at :2907-2908: 500,000 x 128, k 100, 16
# threads of 16-row requests, rungs 8/32/64/128, merge hierarchical) at
# worlds of 1, 2, 4 and 8; the session's inserts and fixed queries; the
# replicas' fixed hedge threshold and the delay injected on replica 1
MNMG_WORLD, SELFTEST_P2P_FLOATS, IVF_ATOL = 4, 262_144, 1e-4
MP_PROCESSES, MP_SLOTS, MP_SEED = 2, 2, 7
MP_REPS = 5                # timed searches a topology in each child
MP_LATE_S = 3.0            # child 1 starts this long after child 0's store answers
MP_BOOT_TIMEOUT_S = 2.0    # child 0's bootstrap attempts (their waits end at 1.6 s)
MP_DEAD_TIMEOUT_S = 1.0    # each attempt at a coordinator nobody serves
MP_CHILD_TIMEOUT_S = 300.0
SHARDED_N, SHARDED_THREADS, SHARDED_ROWS, SHARDED_SECONDS = 500_000, 16, 16, 4.0
SHARDED_RUNGS = (8, 32, 64, 128)
SHARDED_POOL, SHARDED_NOISE = 32, 0.1   # tools/loadgen.py:make_query_pool's defaults
SESSION_INSERT, SESSION_FIXED = 2048, 256
REPLICA_HEDGE_MS, REPLICA_DELAY_S = 25.0, 0.1
# the fleet (queue 1 item 7): the JAX serve_fleet rung's drill
# (bench.py:1713-1830) at the width of the serve_ann_1m configuration (1M x
# 128 float32, k 100), the data the JAX fleet's (fleet/worker.py:_synth,
# seed 5, 64 clusters), nlist 512 a shard at nprobe 32; 8 client threads of
# 16-row requests a window; recall@100 on 256 queries; a snapshot interval
# long enough that a restore replays the WAL since the bootstrap snapshot;
# the chaos arm's query threads and 8-row inserts; the replicated fleet's
# depth (cut to 200,000 rows for the script's time) and hedge
FLEET_ROWS, FLEET_SEED, FLEET_CLUSTERS, FLEET_NLIST, FLEET_NPROBE = 1_000_000, 5, 64, 512, 32
FLEET_THREADS, FLEET_ROWS_A_REQ, FLEET_SECONDS, FLEET_RECALL_Q = 8, 16, 5.0, 256
FLEET_SNAPSHOT_S, FLEET_READY_S = 30.0, 600.0
FLEET_SERVICE_OPTS = {"delta_cap": 8192, "max_batch_rows": 128, "bucket_rungs": [8, 32, 64, 128],
                      "nprobe_ladder": [8, 16, 32]}
CHAOS_QUERY_THREADS, CHAOS_INSERT_ROWS, CHAOS_MAX_INSERTS = 4, 8, 400
CHAOS_BEFORE_S, CHAOS_OUTAGE_S, CHAOS_AFTER_S = 3.0, 1.0, 3.0
REPL_ROWS, REPL_NLIST, REPL_HEDGE_MS, REPL_HANG_S = 200_000, 256, 60.0, 1.0
# the K2 shapes of these paths are timed on normal keys (their merges
# re-order candidates by global id first, so no sorted runs survive; the
# re-rank selects from fresh distances of its candidates)
NORMAL_KEY_PATHS = ("knn_rerank_1M", "mnmg_", "serve_knn_sharded_500k", "session_recover",
                    "serve_knn_replicas", "loadgen_kill_shard_1M", "loadgen_hedge_chaos_1M")
# the paths whose K2 probes (k = nprobe) take the query-to-centroid keys
PROBE_PATHS = ("ivf_search_1M", "serve_ann_1M", "loadgen_ooc_chaos_1M",
               "loadgen_crash_restart_1M", "loadgen_ops_scrape_1M")
QUANTIZED_PATHS = ("ivf_pq_1M", "ivf_sq_1M", "serve_ann_pq_1M", "serve_ann_sq_1M",
                   "persist_ann_1M", "rbc_haversine_1M", "rbc_l2_3d_1M")


def bf16_mm(a, b):
    """One PyTorch product of bfloat16 operands to float32 sums, the
    yardstick of the bfloat16 instances."""
    return torch.mm(a, b, out_dtype=torch.float32)


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


def bound_tf32x3(ops, nbytes, passes=3):
    """The same for a float32-faithful product in 3xTF32 on the tensor
    cores: three TF32 operations for each float32 one (``passes``: one
    for the bfloat16 instances as built, a TF32 wgmma of bfloat16 values)."""
    t_ops, t_bytes = passes * ops / PEAK_TF32_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    if t_ops >= t_bytes:
        return t_ops, "operations, %s on tensor cores" % ("3xTF32" if passes == 3 else "TF32")
    return t_bytes, "bytes"


def bound_bf16(ops, nbytes):
    """The least time of a product of bfloat16 operands: its operations at
    the tensor cores' bfloat16 rate, or its bytes."""
    t_ops, t_bytes = ops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    if t_ops >= t_bytes:
        return t_ops, "operations, bfloat16 on tensor cores"
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


def check_nn(name, got_v, got_i, ref_v, ref_i, x, y, atol, prec="highest"):
    """1-NN values within ``atol``; an id that differs from the reference's
    must be a tie (within ``atol``) at the minimum, in the arithmetic of
    ``prec`` (at "default" the expanded form of the bfloat16 single pass).
    Returns the largest value error."""
    assert got_v.shape == ref_v.shape and got_i.dtype == torch.int32, name
    err = (got_v - ref_v).abs().max().item()
    assert err <= atol, "%s: value error %g > %g" % (name, err, atol)
    bad = got_i != ref_i
    if bad.any():
        xb, yb = x[bad], y[got_i[bad].long()]
        if prec == "highest":
            alt = ((xb - yb) ** 2).sum(dim=1)
        else:
            rnd = lambda t: t.to(torch.bfloat16).to(torch.float32)  # noqa: E731
            alt = (xb * xb).sum(1) + (yb * yb).sum(1) - 2.0 * (rnd(xb) * rnd(yb)).sum(1)
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


def community_graph(n_half, n_cross, dev):
    """The graph of bench.py:two_community_graph (2545-2573), a copy in
    numpy drawn from seed 0: two rings of n_half vertices, 2 n_half random
    edges inside each, n_cross bridges, both directions of every edge,
    deduplicated by the port's max_duplicates on the card, as a CSR."""
    from raft_tpu_torch.sparse import COO
    from raft_tpu_torch.sparse.convert import coo_to_csr
    from raft_tpu_torch.sparse.op import max_duplicates

    rng = np.random.default_rng(SEED)
    n = 2 * n_half
    src = np.concatenate([
        np.arange(n_half), n_half + np.arange(n_half),
        rng.integers(0, n_half, 2 * n_half),
        n_half + rng.integers(0, n_half, 2 * n_half),
        rng.integers(0, n_half, n_cross)])
    dst = np.concatenate([
        (np.arange(n_half) + 1) % n_half,
        n_half + (np.arange(n_half) + 1) % n_half,
        rng.integers(0, n_half, 2 * n_half),
        n_half + rng.integers(0, n_half, 2 * n_half),
        n_half + rng.integers(0, n_half, n_cross)])
    keep = src != dst
    src, dst = src[keep], dst[keep]
    rows = np.concatenate([src, dst]).astype(np.int32)
    cols = np.concatenate([dst, src]).astype(np.int32)
    coo = max_duplicates(COO(rows, cols, np.ones(rows.size, np.float32), (n, n), device=dev),
                         device=dev)
    return coo_to_csr(coo, assume_sorted=True)


def ring_graph(n):
    """The COO arrays of bench.py:_bench_spectral (2624-2648): a ring of n
    vertices and 2n random edges, both directions, duplicates kept."""
    rng = np.random.default_rng(SEED)
    src = np.arange(n, dtype=np.int64)
    dst = (src + 1) % n
    extra = rng.integers(0, n, size=(2 * n, 2), dtype=np.int64)
    extra = extra[extra[:, 0] != extra[:, 1]]
    rows = np.concatenate([src, dst, extra[:, 0], extra[:, 1]]).astype(np.int32)
    cols = np.concatenate([dst, src, extra[:, 1], extra[:, 0]]).astype(np.int32)
    return rows, cols, np.ones(rows.shape[0], dtype=np.float32)


def adjusted_rand_index(a, b):
    """The adjusted Rand index of two labellings (the contingency formula
    of tests/test_scale_stress.py)."""
    a, b = np.asarray(a).ravel(), np.asarray(b).ravel()
    _, ai = np.unique(a, return_inverse=True)
    _, bi = np.unique(b, return_inverse=True)
    c = np.zeros((ai.max() + 1, bi.max() + 1), np.int64)
    np.add.at(c, (ai, bi), 1)

    def comb2(x):
        return x * (x - 1) / 2.0

    sum_ij = comb2(c.astype(np.float64)).sum()
    sum_a = comb2(c.sum(axis=1).astype(np.float64)).sum()
    sum_b = comb2(c.sum(axis=0).astype(np.float64)).sum()
    expected = sum_a * sum_b / comb2(float(a.size))
    top = 0.5 * (sum_a + sum_b)
    return 1.0 if top == expected else float((sum_ij - expected) / (top - expected))


def max_principal_angle(u, v):
    """The largest principal angle (radians) between the column spans of
    u and v, in float64 on their device."""
    qu = torch.linalg.qr(u.double()).Q
    qv = torch.linalg.qr(v.double()).Q
    s = torch.linalg.svdvals(qu.T @ qv)
    return float(torch.arccos(torch.clamp(s.min(), -1.0, 1.0)))


def traced_busy(fn, trace_path):
    """One run of ``fn`` under torch.profiler: (wall ms, device busy ms,
    the six kernels of most device time as [name, ms, launches]), busy the
    union of the kernel, copy and set intervals in the trace (written to
    ``trace_path``, read, and deleted)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    prof.export_chrome_trace(str(trace_path))
    events = json.loads(Path(trace_path).read_text())["traceEvents"]
    Path(trace_path).unlink()
    device = [e for e in events
              if e.get("ph") == "X" and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
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
    top = sorted(([name, ms, n] for name, (ms, n) in by_name.items()), key=lambda r: -r[1])[:6]
    return wall, busy / 1e3, top


def make_blobs(rng, m, d, n_blobs, spread=0.15):
    """(X, labels): Gaussian blobs, a numpy copy of ``bench.py:make_blobs``
    (the generator of the JAX linkage rung and tests/test_scale_stress.py)."""
    centers = rng.standard_normal((n_blobs, d)) * 4.0
    labels = rng.integers(0, n_blobs, m)
    X = (centers[labels] + rng.standard_normal((m, d)) * spread).astype(np.float32)
    return X, labels


def purity(labels, truth, n_clusters):
    """Each cluster's majority share of the planted labels (bench.py:2590-2594)."""
    correct = sum(np.bincount(truth[labels == c]).max()
                  for c in range(n_clusters) if (labels == c).any())
    return float(correct) / len(labels)


def same_bits(a, b):
    return a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()


def linkage_path(size, dev, reset, counts, mods, trace_path=None):
    """``single_linkage`` of make_blobs at LINKAGE_SIZES[size], twice (the
    second traced when ``trace_path`` is given): stage times, peak bytes
    above the call's start, the checks of tests/test_scale_stress.py:42-70
    (three labels, ARI against the blobs and against scipy's single
    linkage on a 2,000-point subsample), purity, the two runs bitwise
    equal.  Then K1 at the kNN graph's shape against its plain version,
    and at LINKAGE_HOST_CUT_SIZES the host runtime's cut beside the
    port's.  ``mods``: the port's functions this path calls."""
    import scipy.cluster.hierarchy as sch

    single_linkage = mods["single_linkage"]

    m, d = LINKAGE_SIZES[size]
    name = "single_linkage_" + size
    X_np, truth = make_blobs(np.random.default_rng(SEED), m, d, LINKAGE_BLOBS)
    X = torch.from_numpy(X_np).to(dev)
    out = {"rows": m, "dim": d, "blobs": LINKAGE_BLOBS, "k": int(np.log2(m)) + 15}
    runs = []
    for run in range(2):
        stages = {} if run == 0 else None
        reset()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        if run == 1 and trace_path is not None:
            box = []
            wall, busy, top = traced_busy(
                lambda: box.append(single_linkage(X, LINKAGE_BLOBS, device=dev)), trace_path)
            res = box[0]
            out.update({"traced_ms": wall, "traced_device_busy_ms": busy,
                        "traced_device_idle_share": 1.0 - busy / wall,
                        "traced_top_kernels": top})
        else:
            t0 = time.perf_counter()
            try:
                res = single_linkage(X, LINKAGE_BLOBS, stages=stages, device=dev)
            except Exception:
                # where it stopped: the stages and fix-ups it reached
                print("%s stopped: %s" % (name, json.dumps(stages)), flush=True)
                raise
            torch.cuda.synchronize()
            out["ms" if run == 0 else "second_ms"] = (time.perf_counter() - t0) * 1e3
        peak = torch.cuda.max_memory_allocated(dev) - base
        out["peak_bytes" if run == 0 else "second_peak_bytes"] = peak
        launched = counts(name)
        if run == 0:
            out["launches"], out["stages"] = launched, stages
        runs.append(res)
    res, res2 = runs
    labels = np.asarray(res.labels)
    assert labels.shape == (m,) and len(np.unique(labels)) == LINKAGE_BLOBS, (name, labels)
    assert res.children.shape == (m - 1, 2) and res.sizes[-1] == m, name
    assert np.isfinite(res.deltas).all() and (np.diff(res.deltas) >= 0).all(), name
    for field in ("labels", "children", "deltas", "sizes"):
        assert same_bits(getattr(res, field), getattr(res2, field)), (
            "%s: a second run differs in %s" % (name, field))
    assert out["launches"]["knn_tile"] > 0, (name, out["launches"])
    ari_truth = adjusted_rand_index(labels, truth)
    sub = np.random.default_rng(SEED).choice(m, LINKAGE_SUBSAMPLE, replace=False)
    scipy_labels = sch.fcluster(sch.linkage(X_np[sub], method="single"), t=LINKAGE_BLOBS,
                                criterion="maxclust")
    ari_scipy = adjusted_rand_index(labels[sub], scipy_labels)
    assert ari_truth > LINKAGE_MIN_ARI and ari_scipy > LINKAGE_MIN_ARI, (
        name, ari_truth, ari_scipy)
    out.update({"second_run_bitwise_equal": True, "ari_truth": ari_truth,
                "ari_scipy_subsample": ari_scipy,
                "purity": purity(labels, truth, LINKAGE_BLOBS),
                "max_delta": float(res.deltas[-1]), "median_delta": float(np.median(res.deltas))})
    # K1 at the path's shape: knn_graph's call (every row against X, k =
    # log2(m) + 15), its first N_CHECK rows against the plain version
    dist, ids = mods["knn"]([X], X, out["k"], mods["metric"], device=dev)
    torch.cuda.synchronize()
    ref_d, ref_i = mods["knn_plain"](X, X[:N_CHECK], out["k"])
    atol = l2_atol(X, X)
    out["k1_check"] = {"rows": N_CHECK, "atol": atol, "max_abs_err": check_knn(
        name + " K1 vs its plain version (squared)", dist[:N_CHECK] ** 2, ids[:N_CHECK],
        ref_d, ref_i, atol)}
    del dist, ids, ref_d, ref_i
    if size in LINKAGE_HOST_CUT_SIZES:
        t0 = time.perf_counter()
        ours = mods["cut"](res.children, LINKAGE_BLOBS, m)
        cut_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        host = mods["native"].extract_clusters(res.children, LINKAGE_BLOBS, m)
        host_ms = (time.perf_counter() - t0) * 1e3
        assert host is not None, "%s: the host runtime is not built" % name
        assert np.array_equal(host, ours), "%s: the two cuts differ" % name
        out["cut_vs_host_runtime"] = {"pointer_jumping_ms": cut_ms, "host_runtime_ms": host_ms,
                                      "labels_equal": True}
    return out


def newsgroups_csr(dev, gen, CSR):
    """A synthetic CSR at the shape of scikit-learn's
    ``fetch_20newsgroups_vectorized`` train split: NEWS_ROWS x NEWS_COLS,
    NEWS_TERMS distinct terms a row drawn on the card from a Zipf law over
    the columns, tf-idf-like values (tf 1 + floor(Exp(1)), idf 1 + s
    log(rank)), rows L1-normalised."""
    rank = torch.arange(1, NEWS_COLS + 1, device=dev, dtype=torch.float64)
    probs = (rank ** -NEWS_ZIPF / (rank ** -NEWS_ZIPF).sum()).float()
    cols = torch.cat([torch.multinomial(probs.expand(min(1024, NEWS_ROWS - r0), -1), NEWS_TERMS,
                                        replacement=False, generator=gen)
                      for r0 in range(0, NEWS_ROWS, 1024)])
    cols = torch.sort(cols, dim=1).values
    tf = 1.0 + torch.floor(torch.empty(cols.shape, device=dev).exponential_(generator=gen))
    vals = tf * (1.0 + NEWS_ZIPF * torch.log(rank.float()))[cols]
    vals = vals / vals.sum(dim=1, keepdim=True)
    indptr = torch.arange(0, (NEWS_ROWS + 1) * NEWS_TERMS, NEWS_TERMS, dtype=torch.int32,
                          device=dev)
    return CSR(indptr, cols.reshape(-1).to(torch.int32), vals.reshape(-1),
               (NEWS_ROWS, NEWS_COLS), device=dev)


def k5_share(top):
    """Device milliseconds of K5 among a trace's top kernels."""
    return sum(ms for name, ms, _ in top if "pairwise_tile" in name)


def sparse_l1_path(csr, dev, reset, counts, sdist, ssel, L1, trace_path, k5, k5_plain):
    """The sparse engine at the newsgroups shape: ``pairwise_distance``
    (L1, column-tiled: K5 in accumulate-only mode over two column tiles)
    and ``brute_force_knn`` (k = NEWS_K, full width: K5 on densified
    2048-row blocks, then K2), each twice (the second traced, bitwise
    equal to the first); sampled pairs against scipy in float64, the kNN
    against the top-k of the pairwise matrix; K5 (``k5``) against its
    plain version (``k5_plain``) on blocks of both calls."""
    import scipy.sparse as sps

    n = csr.n_rows
    out = {"rows": n, "cols": csr.n_cols, "stored_entries": int(csr.nnz),
           "column_tile": sdist.column_tile(n, n, csr.n_cols, 1024, 1024, None)}
    # the column-tiled engine, over more than one column tile
    assert out["column_tile"] is not None and out["column_tile"] < csr.n_cols, out
    calls = {"pairwise": lambda: sdist.pairwise_distance(csr, csr, L1, device=dev),
             "knn": lambda: ssel.brute_force_knn(csr, csr, NEWS_K, L1, device=dev)}
    got = {}
    for name, fn in calls.items():
        path = "sparse_l1_newsgroups_" + name
        reset()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        first = fn()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        launched = counts(path)
        peak = torch.cuda.max_memory_allocated(dev) - base
        box = []
        wall, busy, top = traced_busy(lambda: box.append(fn()), trace_path)
        firsts = first if isinstance(first, tuple) else (first,)
        seconds = box[0] if isinstance(box[0], tuple) else (box[0],)
        for a, b in zip(firsts, seconds):
            assert torch.equal(a.reshape(-1).view(torch.int32), b.reshape(-1).view(torch.int32)), (
                "%s: a second call differs" % path)
        assert launched["pairwise_tile"] > 0, (path, launched)
        out[name] = {"launches": launched, "ms": ms, "peak_bytes": peak,
                     "second_call_bitwise_equal": True, "traced_ms": wall,
                     "traced_device_busy_ms": busy, "k5_device_ms": k5_share(top),
                     "k5_share_of_traced_wall": k5_share(top) / wall, "traced_top_kernels": top}
        got[name] = first
    assert out["knn"]["launches"]["select_tile"] > 0, out["knn"]["launches"]
    out["launches"] = {k: out["pairwise"]["launches"][k] + out["knn"]["launches"][k]
                       for k in out["knn"]["launches"]}
    # sampled pairs against scipy in float64
    host = sps.csr_matrix((csr.data.double().cpu().numpy(), csr.indices.cpu().numpy(),
                           csr.indptr.cpu().numpy()), shape=(n, csr.n_cols))
    rng = np.random.default_rng(SEED)
    i, j = rng.integers(0, n, NEWS_PAIRS), rng.integers(0, n, NEWS_PAIRS)
    ref = np.asarray(abs(host[i] - host[j]).sum(axis=1)).ravel()
    pw = got["pairwise"]
    err = np.abs(pw[torch.from_numpy(i).to(dev), torch.from_numpy(j).to(dev)].double().cpu().numpy()
                 - ref)
    assert (err <= NEWS_PAIR_RTOL * ref).all(), (err / np.maximum(ref, 1e-30)).max()
    out["pairwise"]["max_rel_err_sampled_pairs"] = float((err / np.maximum(ref, 1e-30)).max())
    # the kNN: the top-k of the pairwise matrix, as sets up to ties
    ref_d, ref_i = torch.topk(pw, NEWS_K, dim=1, largest=False)
    d, ids = got["knn"]
    atol = NEWS_KNN_RTOL * ref_d.max().item()
    out["knn"]["max_err_vs_pairwise_topk"] = check_knn(
        "sparse_l1_newsgroups knn vs the pairwise top-k", d, ids, ref_d, ref_i.to(torch.int32),
        atol)
    del pw, ref_d, ref_i
    # K5 on the path's own blocks, against its plain version: the kNN's
    # launch of query block 0 against index block 1 (the whole depth, with
    # the epilog), and the pairwise engine's launch of row block 0 against
    # row block 1 over each column tile (without it), of the largest value
    ent = sdist.unique_entries(csr)
    bq = NEWS_KNN_BLOCK
    xq = sdist.densify(ent, 0, bq, 0, csr.n_cols)
    xi = sdist.densify(ent, bq, bq, 0, csr.n_cols)
    got, ref = k5(xq, xi, L1), k5_plain(xq, xi, L1)
    err, scale = (got - ref).abs().max().item(), ref.abs().max().item()
    assert err <= NEWS_PAIR_RTOL * scale, ("K5 at the kNN's block", err, scale)
    out["knn"]["k5_check"] = {"shape": "%dx%d, %dx%d" % (bq, csr.n_cols, bq, csr.n_cols),
                              "max_abs_err": err, "max_rel_err": err / scale}
    del xq, xi, got, ref
    bm, bk = NEWS_PAIRWISE_BLOCK, out["column_tile"]
    out["pairwise"]["k5_raw_checks"] = []
    for c0 in range(0, csr.n_cols, bk):
        cols = min(bk, csr.n_cols - c0)
        width = -(-cols // 4) * 4        # as the engine pads a tile
        xa = sdist.densify(ent, 0, bm, c0, cols, width)
        xb = sdist.densify(ent, bm, bm, c0, cols, width)
        got, ref = k5(xa, xb, L1, epilog=False), k5_plain(xa, xb, L1, epilog=False)
        err, scale = (got - ref).abs().max().item(), ref.abs().max().item()
        assert err <= K5_RAW_RTOL * scale, ("K5 raw at a column tile", c0, err, scale)
        out["pairwise"]["k5_raw_checks"].append({
            "shape": "%dx%d, %dx%d" % (bm, width, bm, width), "max_abs_err": err,
            "max_rel_err": err / scale})
        del xa, xb, got, ref
    return out


def batch_order(flight, name):
    """The service's batches as lists of trace ids, riders in batch order:
    the worker records one ``resolved`` event a rider, in rider order."""
    batches = {}
    for ev in flight.default_recorder().events(service=name, kind="resolved"):
        batches.setdefault(ev.attrs["batch"], []).append(ev.trace_id)
    return list(batches.values())


def index_bytes(index):
    """Device bytes of an index's tensors (a tensor shared by two fields
    counted once)."""
    seen = {}
    for v in index:
        if isinstance(v, torch.Tensor):
            seen[v.data_ptr()] = v.numel() * v.element_size()
    return sum(seen.values())


def build_labels(index, n_rows, dev):
    """Each row's list, read back from an IVF index's slots."""
    live = index.slot_ids >= 0
    labels = torch.empty(n_rows, dtype=torch.int64, device=dev)
    labels[index.slot_ids[live].long()] = index.slot_centroid[:, None].expand_as(live)[live].long()
    return labels


def pq_decode(pq, n_rows, ids, dtype=torch.float32):
    """The vectors that an IVF-PQ index's codes stand for, of the rows
    ``ids`` (of ``n_rows``): each row's list centroid plus the codewords
    its codes pick."""
    M, _, dsub = pq.codebooks.shape
    cap = pq.slot_ids.shape[1]
    flat = pq.slot_ids.reshape(-1)
    live = flat >= 0
    pos = torch.empty(n_rows, dtype=torch.int64, device=flat.device)
    pos[flat[live].long()] = torch.nonzero(live)[:, 0]
    pos = pos[ids.long()]
    codes = pq.slot_codes.reshape(-1, M)[pos].long()                       # (n, M)
    words = pq.codebooks.to(dtype)[torch.arange(M, device=flat.device)[None, :], codes]
    cent = pq.centroids.to(dtype)[pq.slot_centroid[pos // cap].long()]
    return cent + words.reshape(len(ids), M * dsub)


def quantized_paths(X, q, bf_i, dev, reset, counts, m):
    """``ivf_pq_1M`` and ``ivf_sq_1M``: the builds (PQ's by stage), the
    searches (PQ with and without its refinement), recall@10 against brute
    force and against the decoded vectors' own exact top-10 (the
    quantizer's ceiling), the index bytes and the launches.  The ADC
    distances are held, in float64, to the distances of the vectors that
    the returned codes decode to.  Returns (paths, the PQ index, the SQ index, the codebook check's
    operands for K4)."""
    D = m.D
    out = {}
    reset()
    stages = {}
    t0 = time.perf_counter()
    pq = m.ivf_pq_build(X, m.IVFPQParams(nlist=NLIST, nprobe=NPROBE, M=PQ_M, n_bits=PQ_BITS,
                                         refine_ratio=PQ_REFINE),
                        D.L2SqrtExpanded, seed=SEED, train_rows=TRAIN_ROWS, device=dev,
                        stages=stages)
    torch.cuda.synchronize()
    build_ms = (time.perf_counter() - t0) * 1e3
    n_q = len(q)
    runs = {}
    for name, kw in (("refined", {}), ("unrefined", {"refine_ratio": 1})):
        runs[name] = m.ivf_pq_search(pq, q, QK, **kw, device=dev)
    torch.cuda.synchronize()
    launched = counts("ivf_pq_1M")
    assert launched["nn_tile"] > 0 and launched["select_tile"] > 0, launched
    assert launched["pq_scan"] == 2, launched           # K7: one chunk a search
    for name, (d, i) in runs.items():
        assert d.shape == (n_q, QK) and i.dtype == torch.int32, name
        assert torch.isfinite(d).all() and i.min() >= 0 and i.max() < len(X), name
    # the unrefined ADC distances against the returned rows' decoded
    # vectors, in float64: a wrong table, probe rank or code layout shows
    ud, ui = runs["unrefined"]
    qs = q[:PQ_DECODE_ROWS].double()
    dec64 = pq_decode(pq, len(X), ui[:PQ_DECODE_ROWS].reshape(-1),
                      torch.float64).reshape(len(qs), QK, -1)
    ref2 = ((qs[:, None, :] - dec64) ** 2).sum(-1)
    adc_tol = PQ_DECODE_TOL * ref2.max().item()
    adc_err = (ud[:PQ_DECODE_ROWS].double() ** 2 - ref2).abs().max().item()
    assert adc_err <= adc_tol, ("ivf_pq_1M: ADC distances off the decoded vectors'", adc_err,
                                adc_tol)
    del dec64
    # the quantizer's ceiling: the exact top-10 over the decoded vectors
    every = torch.arange(len(X), device=dev)
    _, dec_i = m.brute_force_knn(pq_decode(pq, len(X), every), q, QK, D.L2SqrtExpanded,
                                 device=dev)
    recall = {name: (i[:, :, None] == bf_i[:, None, :QK]).any(-1).float().mean().item()
              for name, (_, i) in runs.items()}
    recall["decoded_exact"] = (dec_i[:, :, None] == bf_i[:, None, :QK]).any(-1).float().mean().item()
    recall["unrefined_of_decoded_exact"] = (
        ui[:, :, None] == dec_i[:, None, :]).any(-1).float().mean().item()
    assert recall["refined"] >= recall["unrefined"] > 0.0, recall
    ms = {"refined": time_ms(lambda: m.ivf_pq_search(pq, q, QK, device=dev), reps=3),
          "unrefined": time_ms(lambda: m.ivf_pq_search(pq, q, QK, refine_ratio=1, device=dev),
                               reps=3)}
    codes_bytes = pq.slot_codes.numel() * pq.slot_codes.element_size()
    out["ivf_pq_1M"] = {
        "launches": launched, "build_ms": build_ms, "build_stages_ms": stages,
        "kmeans_assigns": launched["nn_tile"], "M": PQ_M, "n_bits": PQ_BITS,
        "refine_ratio": PQ_REFINE, "k": QK, "nprobe": NPROBE,
        "n_slots": pq.slot_ids.shape[0], "cap": pq.slot_ids.shape[1],
        "search_ms": ms, "qps": {k: n_q / v * 1e3 for k, v in ms.items()},
        "recall_at_10": recall, "adc_decoded_max_err": adc_err, "adc_decoded_tol": adc_tol,
        "index_bytes": index_bytes(pq), "codes_bytes": codes_bytes,
        "index_bytes_without_vectors": index_bytes(pq._replace(vectors=None))}
    # K4 at a codebook's shape: subspace 0 of the residuals against its
    # 256 codewords (depth 8), as the build's k-means assigns it
    labels = build_labels(pq, len(X), dev)
    dsub = X.shape[1] // PQ_M
    sub = (X[:, :dsub] - pq.centroids[labels][:, :dsub]).contiguous()
    codebook = (sub, pq.codebooks[0].contiguous())
    del labels, runs, dec_i, every

    reset()
    t0 = time.perf_counter()
    sq = m.ivf_sq_build(X, m.IVFSQParams(nlist=NLIST, nprobe=NPROBE, qtype="QT_8bit",
                                         encode_residual=True),
                        D.L2SqrtExpanded, seed=SEED, train_rows=TRAIN_ROWS, device=dev)
    torch.cuda.synchronize()
    sq_build_ms = (time.perf_counter() - t0) * 1e3
    d, i = m.ivf_sq_search(sq, q, QK, device=dev)
    torch.cuda.synchronize()
    launched = counts("ivf_sq_1M")
    assert launched["nn_tile"] > 0 and launched["select_tile"] > 0, launched
    assert sq.slot_q.dtype == torch.uint8 and sq.slot_q.device == X.device
    assert d.shape == (n_q, QK) and torch.isfinite(d).all() and i.min() >= 0
    sq_ms = time_ms(lambda: m.ivf_sq_search(sq, q, QK, device=dev), reps=3)
    out["ivf_sq_1M"] = {
        "launches": launched, "build_ms": sq_build_ms, "qtype": "QT_8bit",
        "encode_residual": True, "k": QK, "nprobe": NPROBE, "search_ms": sq_ms,
        "qps": n_q / sq_ms * 1e3,
        "recall_at_10": (i[:, :, None] == bf_i[:, None, :QK]).any(-1).float().mean().item(),
        "index_bytes": index_bytes(sq),
        "codes_bytes": sq.slot_q.numel() * sq.slot_q.element_size()}
    return out, pq, sq, codebook


def pq_compare(name, got, ref):
    """K7's answers against its plain version's: the largest distance
    error over its row's largest distance, the rows whose id sets differ
    and those where a differing id is not an ADC tie of the kk-th; raises
    past PQ_DIST_RTOL, on an id that is no tie, or where the two leave
    different slots unfilled."""
    gd, gi, rd, ri = (t.cpu() for t in (*got, *ref))
    assert torch.equal(gi < 0, ri < 0), "%s: unfilled slots differ" % name
    fin = ri >= 0
    scale = rd.where(fin, 0.0).amax(dim=1, keepdim=True).clamp(min=1e-30)
    err = float(((gd - rd).abs() / scale).where(fin, 0.0).max())
    assert err <= PQ_DIST_RTOL, (name, err)
    differ = 0
    for r in range(len(gi)):
        a, b = set(gi[r][gi[r] >= 0].tolist()), set(ri[r][ri[r] >= 0].tolist())
        assert len(a) == int((gi[r] >= 0).sum()), "%s: row %d returns an id twice" % (name, r)
        if a == b:
            continue
        differ += 1
        kth = float(rd[r][fin[r]][-1])
        for i in a ^ b:
            dist = float(gd[r][gi[r] == i][0]) if i in a else float(rd[r][ri[r] == i][0])
            assert abs(dist - kth) <= PQ_TIE_RTOL * kth, (name, r, i, dist, kth)
    return {"max_rel_err": err, "rows_ids_differ": differ}


def pq_scan_shape(name, pq, q, nprobe, kk, dev, m):
    """K7 at one shape against its plain version, with its time, the
    plain version's, the library yardstick's (the plain version's tables,
    then each chunk's probed rows' table values gathered by their codes
    at once, summed over M, and ``torch.topk``) and the bounds: FP32
    operations and least bytes (``ops/cost.py:pq_scan_cost``), and the
    table lookups at SMEM_LOOKUPS_PER_CLOCK a clock an SM."""
    M, ksub, _ = pq.codebooks.shape
    _, probes = m.select_k(m.expanded_sq_dists(q, pq.centroids), nprobe, select_min=True,
                           device=dev)
    codes = m.narrow_codes(pq.slot_codes)
    args = (pq.centroids, pq.codebooks)
    tail = (pq.slot_ids, pq.cent_slots)

    def kernel():
        return m.ivf_pq_scan(q, *args, codes, *tail, probes, kk)

    def plain():
        parts = [m.ivf_pq_scan_plain(q[c:c + PQ_PLAIN_CHUNK], *args, pq.slot_codes, *tail,
                                     probes[c:c + PQ_PLAIN_CHUNK], kk)
                 for c in range(0, len(q), PQ_PLAIN_CHUNK)]
        return torch.cat([d for d, _ in parts]), torch.cat([i for _, i in parts])

    def library():
        inf = float("inf")
        for c in range(0, len(q), PQ_LIBRARY_CHUNK):
            qc, pc = q[c:c + PQ_LIBRARY_CHUNK], probes[c:c + PQ_LIBRARY_CHUNK]
            lut = m.pq_tables(qc, *args, pc)
            slots, prank, _ = m.probe_compact(qc, pq.centroids, pq.cent_slots, nprobe, pc,
                                              ranks=True)
            sl = slots.clamp(min=0).long()
            rows = torch.arange(len(qc), device=dev)[:, None]
            vals = torch.gather(lut[rows, prank.long()], 3,
                                pq.slot_codes[sl].transpose(2, 3).long()).sum(dim=2)
            ids = torch.where((slots >= 0)[:, :, None], pq.slot_ids[sl], -1)
            dist = torch.where(ids >= 0, vals, inf).reshape(len(qc), -1)
            torch.topk(dist, min(kk, dist.shape[1]), dim=1, largest=False)

    got = kernel()
    torch.cuda.synchronize()
    out = pq_compare(name, got, plain())
    ops, nbytes = m.scan_cost(pq.slot_ids, pq.cent_slots, probes, q.shape[1], ksub, M, kk)
    lookups = ops - 2.0 * q.shape[1] * len(q) * nprobe * ksub
    b, by = bound(ops, nbytes)
    n_sms = torch.cuda.get_device_properties(dev).multi_processor_count
    out.update({
        "shape": "%d queries, nprobe %d, M %d x %d codewords, d %d, kk %d; %d rows scanned"
                 % (len(q), nprobe, M, ksub, q.shape[1], kk, lookups // M),
        "ms": time_ms(kernel, reps=5), "bound_ms": b, "bound_by": by,
        "lookup_bound_ms": lookups / (SMEM_LOOKUPS_PER_CLOCK * n_sms * SM_CLOCK_HZ) * 1e3,
        "plain_ms": time_ms(plain, reps=1),
        "library_ms": time_ms(library, reps=1),
        "library": "the plain version's tables, torch.gather of every probed row's table "
                   "values by its codes and sum over M, %d queries at a time, torch.topk"
                   % PQ_LIBRARY_CHUNK})
    return out


def pq_scan_row(X, pq, q_smoke, q_cell, dev, m):
    """K7's row of the kernels line: at the benchmark's sift1m_ivfpq shape
    (an index of M PQ_CELL_M built on the path's mixture, 10,000 queries)
    and at ivf_pq_1M's: the served arm's kk 400 (K7's 512-key top list),
    refined (kk 40) and unrefined (kk 10); and the search at the cell's
    shape, its kernel and step counts."""
    cell = m.ivf_pq_build(X, m.IVFPQParams(nlist=NLIST, nprobe=PQ_CELL_NPROBE, M=PQ_CELL_M,
                                           n_bits=PQ_BITS, refine_ratio=2),
                          m.D.L2SqrtExpanded, seed=SEED, train_rows=TRAIN_ROWS, device=dev)
    row = {"name": "pq_scan", "route": "cuda", "source": "raft_tpu_torch/ops/csrc/pq_scan.cu",
           "replaces": "none: raft_tpu/spatial/ann.py scans PQ codes in its XLA loop"}
    row.update(pq_scan_shape("pq_scan at sift1m_ivfpq's shape", cell, q_cell, PQ_CELL_NPROBE,
                             PQ_CELL_KK, dev, m))
    for kk in (K * PQ_REFINE, QK * PQ_REFINE, QK):
        row["ivf_pq_1M_kk%d" % kk] = pq_scan_shape("pq_scan at ivf_pq_1M's shape, kk %d" % kk,
                                                  pq, q_smoke, NPROBE, kk, dev, m)
    names = m.PQ_COUNTERS + (m.PQ_KERNEL_CHUNKS,)
    before = [m.tracing.get_counter(c) for c in names]
    launched = m.inventory.snapshot()
    search_ms = time_ms(lambda: m.ivf_pq_search(cell, q_cell, K, PQ_CELL_NPROBE, device=dev),
                        reps=3)
    counted = dict(zip(names, (m.tracing.get_counter(c) - b for c, b in zip(names, before))))
    assert counted[m.PQ_KERNEL_CHUNKS] > 0 and counted[m.PQ_COUNTERS[1]] == 0, counted
    row["cell_search"] = {"ms": search_ms, "queries_per_s": len(q_cell) / search_ms * 1e3,
                          "counters": counted,
                          "k7_launches": sum(m.inventory.launches_since(launched)
                                             .get("pq_scan", {}).values())}
    return row


def serve_quantized(kind, index, X, ann_load, dev, reset, counts, m):
    """``serve_ann_pq_1M`` / ``serve_ann_sq_1M``: the ``serve_ann_1M``
    traffic over an IVF-PQ or IVF-SQ index (warmup, calibrate, a load of
    16 threads, 2,048 inserts under traffic, no compaction).  Every load
    response is held bitwise to the search of its padded batch, each
    insert must be found by a query of itself, and ``compact()`` must
    raise."""
    name = "serve_ann_%s_1M" % kind
    calib_q, blocks, new_vecs, new_ids, load_rows = ann_load
    svc = m.ANNService(index, K, nprobe_ladder=ANN_LADDER, bucket_rungs=ANN_RUNGS,
                       max_batch_rows=ANN_RUNGS[-1], max_wait_ms=2.0, queue_cap=4096,
                       delta_cap=ANN_DELTA_CAP, compact_rows=ANN_COMPACT, device=dev, name=name)
    out = {"compact_rows": svc.stats()["compact_rows"]}
    assert out["compact_rows"] == 0, out            # never compacts
    t0 = time.perf_counter()
    svc.warmup()
    out["warmup_s"] = time.perf_counter() - t0
    torch.cuda.synchronize()
    reset()
    t_path = time.perf_counter()
    # IVF-SQ keeps no vectors: the ground truth reads the data
    calib = svc.calibrate(calib_q, ANN_TARGET, reference=X if kind == "sq" else None,
                          measure_all=True)
    nprobe = svc.nprobe
    out["calibrate"] = calib
    futs, wall_ms = serve_concurrently(svc, blocks, ANN_THREADS, drain=False)
    load_batches = batch_order(m.flight, name)
    index0 = svc.index
    lat_ms = latencies_ms(futs)
    n_rows = len(blocks) * ANN_ROWS
    out.update({"requests": len(blocks), "rows": n_rows, "batches": len(load_batches),
                "rows_per_batch": n_rows / len(load_batches), "wall_ms": wall_ms,
                "rows_per_s": n_rows / wall_ms * 1e3, "nprobe": nprobe,
                "p50_ms": statistics.median(lat_ms), "p99_ms": quantile(lat_ms, 0.99)})
    stop, bg, bg_err, before = threading.Event(), [], [], []

    def background():
        try:
            for j in itertools.count():
                if stop.is_set():
                    return
                bg.append(svc.submit(blocks[j % len(blocks)]))
                time.sleep(0.001)
        except Exception as e:  # noqa: BLE001 — re-raised below
            bg_err.append(e)

    th = threading.Thread(target=background, daemon=True)
    th.start()
    try:
        for c in range(0, ANN_INSERT, ANN_CHUNK):
            svc.insert(new_ids[c:c + ANN_CHUNK], new_vecs[c:c + ANN_CHUNK])
            before.append(svc.submit(new_vecs[c:c + ANN_CHUNK]))
        [f.result(timeout=120) for f in before]
    finally:
        stop.set()
        th.join(60)
    assert not th.is_alive() and not bg_err, bg_err
    [f.result(timeout=120) for f in bg]
    assert svc.delta_rows == ANN_INSERT and svc.index is index0, "the delta moved"
    try:
        svc.compact()
        raise AssertionError("%s: compact() did not raise" % name)
    except m.LogicError:
        out["compact_raises"] = True
    torch.cuda.synchronize()
    launched = counts(name)
    out["path_ms"] = (time.perf_counter() - t_path) * 1e3
    after_warmup = svc.kernel_libraries_after_warmup()
    svc.close()
    assert launched["select_tile"] > 0 and launched["knn_tile"] > 0, launched
    assert kind != "pq" or launched["pq_scan"] > 0, launched  # K7 at kk 400
    assert after_warmup == {"builds": 0, "loads": 0}, after_warmup
    out.update({"launches": launched, "kernel_libraries_after_warmup": after_warmup,
                "inserted": ANN_INSERT, "background_requests": len(bg)})
    # the checks, after the counts: every load response bitwise equal to
    # the search of its padded batch on the same index and nprobe
    by_trace = {f.trace().trace_id: (b, f) for b, f in zip(blocks, futs)}
    for riders in load_batches:
        batch = torch.cat([by_trace[t][0] for t in riders])
        pd, pi = m.approx_knn_search(index0, m.pad_rows(batch, svc.policy.bucket_for(len(batch))),
                                     K, nprobe=nprobe, device=dev)
        at = 0
        for t in riders:
            b, f = by_trace[t]
            d, i = f.result(timeout=0)
            assert torch.equal(d, pd[at:at + len(b)]) and torch.equal(i, pi[at:at + len(b)]), (
                "%s: a response differs from the search of its padded batch" % name)
            at += len(b)
    served_i = torch.cat([f.result(timeout=0)[1] for f in futs])
    _, gt_i = m.brute_force_knn(X, load_rows, K, m.D.L2SqrtExpanded, device=dev)
    out["recall_at_100"] = (served_i[:, :, None] == gt_i[:, None, :]).any(-1).float().mean().item()
    got_i = torch.cat([f.result(timeout=0)[1] for f in before]).cpu()
    found = (got_i == new_ids[:, None]).any(dim=1)
    assert bool(found.all()), "%s: %d inserts not found by a query of themselves" % (
        name, int((~found).sum()))
    out["inserts_found"] = int(found.sum())
    out["inserts_found_first"] = int((got_i[:, 0] == new_ids).sum())
    return out


def closed_loop(svc, blocks, n_threads, seconds, served=None):
    """``n_threads`` threads each submit a block of ``blocks`` (in turn),
    wait for its answer and submit the next, until ``seconds`` pass.
    With a ``served`` list, every answer is appended to it as (block
    index, answer).  Returns (rows answered, wall ms, request latencies
    in ms, sorted)."""
    stop_at = [0.0]
    lat, rows, errors = [[] for _ in range(n_threads)], [0] * n_threads, []
    got = [[] for _ in range(n_threads)]
    start = threading.Barrier(n_threads + 1)

    def client(t):
        try:
            start.wait(60)
            i = t
            while time.perf_counter() < stop_at[0]:
                b = blocks[i % len(blocks)]
                t0 = time.perf_counter()
                out = svc.submit(b).result(timeout=120)
                lat[t].append((time.perf_counter() - t0) * 1e3)
                rows[t] += len(b)
                if served is not None:
                    got[t].append((i % len(blocks), out))
                i += n_threads
        except Exception as e:  # noqa: BLE001 — re-raised below
            errors.append(e)

    threads = [threading.Thread(target=client, args=(t,), daemon=True)
               for t in range(n_threads)]
    for th in threads:
        th.start()
    stop_at[0] = time.perf_counter() + seconds
    t0 = time.perf_counter()
    start.wait(60)
    for th in threads:
        th.join(seconds + 180)
    wall_ms = (time.perf_counter() - t0) * 1e3
    assert not errors, errors
    assert not any(th.is_alive() for th in threads)
    if served is not None:
        served.extend(x for per in got for x in per)
    return sum(rows), wall_ms, sorted(x for per in lat for x in per)


def pool_value(name, pool, attr="value"):
    """A pool-labelled series of the default registry (0 when absent)."""
    from raft_tpu_torch.core.metrics import default_registry

    fam = default_registry().get(name)
    if fam is not None:
        for labels, series in fam.series():
            if labels.get("pool") == pool:
                return float(getattr(series, attr))
    return 0.0


def ooc_path(X, mixture, dev, reset, counts, m):
    """``serve_ann_ooc_1M``: an IVF-Flat index of the 1M mixture in 2048
    lists served by three ``ANNService`` arms at nprobe 8 (module doc):
    resident, out-of-core double-buffered and out-of-core synchronous,
    each under a closed loop of 8 threads, then the fixed queries held
    across the arms and K3 held at a staged tile's geometry.  The JAX
    rung's approximate select (``select_impl="approx"``) has no
    counterpart in the port: every arm here selects exactly."""
    D = m.D
    out = {}
    reset()
    t0 = time.perf_counter()
    index = m.ivf_flat_build(X, m.IVFFlatParams(nlist=OOC_NLIST, nprobe=OOC_NPROBE),
                             D.L2SqrtExpanded, seed=SEED, train_rows=OOC_TRAIN_ROWS, device=dev)
    torch.cuda.synchronize()
    out["build_ms"] = (time.perf_counter() - t0) * 1e3
    n_slots, cap = index.slot_ids.shape
    store_bytes = index.slot_vecs.numel() * index.slot_vecs.element_size()
    budget = int(store_bytes * OOC_BUDGET_FRAC)
    out.update({"slots": n_slots, "cap": cap, "store_bytes": store_bytes,
                "budget_bytes": budget})
    fixed = mixture(OOC_FIXED)
    load = list(mixture(OOC_THREADS * 64 * OOC_ROWS).split(OOC_ROWS))
    _, gt_i = m.brute_force_knn(X, fixed[:OOC_RECALL_ROWS], K, D.L2SqrtExpanded, device=dev)
    opts = dict(nprobe=OOC_NPROBE, nprobe_ladder=(4, OOC_NPROBE), bucket_rungs=ANN_RUNGS,
                max_batch_rows=ANN_RUNGS[-1], max_wait_ms=2.0, queue_cap=4096, compact_rows=0,
                device=dev)

    def run_arm(name, svc_index, seconds, **kw):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        base_bytes = torch.cuda.memory_allocated(dev)
        svc = m.ANNService(svc_index, K, name=name, **opts, **kw)
        t0 = time.perf_counter()
        svc.warmup()
        arm = {"warmup_s": time.perf_counter() - t0}
        names = ("raft_tpu_tile_hits_total", "raft_tpu_tile_misses_total",
                 "raft_tpu_h2d_bytes_total")
        before = {n: pool_value(n, name) for n in names}
        h2d0 = pool_value("raft_tpu_h2d_seconds", name, "total")
        stall0 = pool_value("raft_tpu_h2d_stall_seconds", name, "total")
        try:
            rows, wall_ms, lat = closed_loop(svc, load, OOC_THREADS, seconds)
            arm.update({"rows": rows, "wall_ms": wall_ms, "rows_per_s": rows / wall_ms * 1e3,
                        "requests": len(lat), "p50_ms": statistics.median(lat),
                        "p99_ms": quantile(lat, 0.99)})
            if kw.get("ooc"):
                hits, miss, h2d_b = (pool_value(n, name) - before[n] for n in names)
                h2d_s = pool_value("raft_tpu_h2d_seconds", name, "total") - h2d0
                stall_s = pool_value("raft_tpu_h2d_stall_seconds", name, "total") - stall0
                st = svc.stats()["ooc"]
                arm.update({
                    "tile_hit_rate": hits / max(hits + miss, 1), "h2d_mb": h2d_b / 1e6,
                    "h2d_s": h2d_s, "stall_s": stall_s,
                    "hidden_transfer_frac": 1.0 - stall_s / h2d_s if h2d_s else 0.0,
                    "staged_high_water_bytes": pool_value("raft_tpu_tile_staged_bytes", name,
                                                          "high_water"),
                    "pool_budget_bytes": st["pool_budget_bytes"], "tile_slots": st["tile_slots"],
                    "hot_slots": st["hot_slots"],
                    "hot_bytes": st["hot_slots"] * cap * DIM * 4})
            # the fixed queries: 128-row requests, one at a time, so that
            # each is one batch of the top rung in every arm
            answers = [svc.submit(q).result(timeout=120) for q in fixed.split(ANN_RUNGS[-1])]
            torch.cuda.synchronize()
        finally:
            svc.close()
        arm["peak_above_start_bytes"] = torch.cuda.max_memory_allocated(dev) - base_bytes
        fd = torch.cat([a[0] for a in answers])
        fi = torch.cat([a[1] for a in answers])
        arm["recall_at_100"] = (fi[:OOC_RECALL_ROWS, :, None] == gt_i[:, None, :]).any(
            -1).float().mean().item()
        return arm, fd, fi

    out["resident"], res_d, res_i = run_arm("serve_ann_ooc_1M_resident", index, OOC_RESIDENT_S)
    # the out-of-core index: the store to the host, the resident slot
    # vectors freed before the streamed arms
    ooc_index = m.ivf_flat_to_ooc(index)
    del index
    torch.cuda.empty_cache()
    out["ooc"], ooc_d, ooc_i = run_arm("serve_ann_ooc_1M_ooc", ooc_index, OOC_ARM_S, ooc=True,
                                       device_budget_bytes=budget)
    out["sync"], sync_d, sync_i = run_arm("serve_ann_ooc_1M_sync", ooc_index, OOC_ARM_S,
                                          ooc=True, device_budget_bytes=budget,
                                          ooc_overlap=False)
    torch.cuda.synchronize()
    out["launches"] = counts("serve_ann_ooc_1M")
    for kernel in ("ivf_tile", "select_tile", "nn_tile", "knn_tile"):
        assert out["launches"][kernel] > 0, (kernel, out["launches"])

    # the fixed queries: every out-of-core distance bitwise the resident
    # arm's, the ids equal except among distances tied at the k-th place
    for arm, d, i in (("ooc", ooc_d, ooc_i), ("sync", sync_d, sync_i)):
        assert torch.equal(d, res_d), "serve_ann_ooc_1M: %s distances differ" % arm
        kth = d[:, -1:]
        below = d < kth
        a = torch.where(below, i, -1).sort(dim=1).values
        b = torch.where(below, res_i, -1).sort(dim=1).values
        assert torch.equal(a, b), "serve_ann_ooc_1M: %s ids differ below the k-th" % arm
        out[arm]["ids_equal"] = int((i == res_i).all(dim=1).sum())
        assert out[arm]["recall_at_100"] == out["resident"]["recall_at_100"], (arm, out)
        assert out[arm]["staged_high_water_bytes"] <= out[arm]["pool_budget_bytes"], out[arm]
        assert out[arm]["peak_above_start_bytes"] < OOC_PEAK_FRAC * store_bytes, out[arm]
    out["overlap_speedup"] = out["ooc"]["rows_per_s"] / out["sync"]["rows_per_s"]
    out["qps_vs_resident"] = out["ooc"]["rows_per_s"] / out["resident"]["rows_per_s"]

    # the host link: one tile of 32 slots from pinned memory to the card
    # (CUDA events), and the host gather of a tile from the store, as the
    # pool gathers it (host clock)
    tile = torch.empty((32, cap, DIM), dtype=torch.float32, pin_memory=True)
    out["h2d_tile_bytes"] = tile.numel() * 4
    h2d_ms = time_ms(lambda: tile.to(dev, non_blocking=True), reps=20)
    out["h2d_tile_ms"], out["h2d_gb_per_s"] = h2d_ms, tile.numel() * 4 / h2d_ms / 1e6
    src = torch.from_numpy(ooc_index.store).view(n_slots, -1)
    rows = torch.randperm(n_slots, generator=torch.Generator().manual_seed(SEED))[:32]
    gathers = []
    for _ in range(10):
        t0 = time.perf_counter()
        torch.index_select(src, 0, rows, out=tile.view(32, -1))
        gathers.append((time.perf_counter() - t0) * 1e3)
    out["gather_tile_ms"] = statistics.median(gathers)

    # K3 at a staged tile's geometry: 32 slots that a 128-row batch probes,
    # the batch's positions in the tile, as the out-of-core scan passes them
    q = fixed[:ANN_RUNGS[-1]]
    slots, _ = m.probe_compact(q, ooc_index.centroids, ooc_index.cent_slots, OOC_NPROBE)
    part = torch.unique(slots[slots >= 0])[:32].to(torch.int32)
    n_live = int(torch.isin(slots, part).sum(dim=1).max())
    sp, _ = m.part_positions(slots, part, n_slots, n_live)
    pl = part.long()
    vecs = torch.from_numpy(ooc_index.store[pl.cpu().numpy()]).to(dev)
    args = (q, vecs, ooc_index.slot_norms[pl], ooc_index.slot_ids[pl], sp, K)
    atol = l2_atol(q, X)
    err = check_knn("ivf_tile at a staged tile (32 slots, 128 rows)",
                    *m.fused_ivf_scan(*args), *m.fused_ivf_scan_plain(*args), atol)
    rows_scanned = int((ooc_index.slot_ids[pl] >= 0).sum(1)[sp[sp >= 0].long()].sum())
    ops = 2.0 * DIM * rows_scanned
    nbytes = vecs.numel() * 4 + 8.0 * vecs.shape[0] * cap + 4.0 * q.numel() + 8.0 * len(q) * K
    b, by = bound_tf32x3(ops, nbytes)
    out["k3_tile"] = {
        "shape": "%d queries x %d positions, a tile of 32 slots of %d x %d f32, k=%d"
                 % (len(q), n_live, cap, DIM, K),
        "launches": out["launches"]["ivf_tile"], "max_abs_err": err, "atol": atol,
        "ms": time_ms(lambda: m.fused_ivf_scan(*args), reps=10),
        "plain_ms": time_ms(lambda: m.fused_ivf_scan_plain(*args), reps=2),
        "bound_ms": b, "bound_by": by, "rows_scanned": rows_scanned}
    del ooc_index, src, tile, vecs
    torch.cuda.empty_cache()
    return out


def persist_path(indexes, dev, reset, counts, m):
    """``persist_ann_1M``: for IVF-Flat, IVF-PQ and IVF-SQ, a threadless
    service with a persist directory (under ``build/``) on a stepped
    clock: the bootstrap snapshot, 1,024 inserts, the maintenance tick's
    interval snapshot that holds them, 1,024 more in the WAL alone, a crash
    (no last snapshot), the restore from the directory alone
    (``index=None``), whose served answers are bitwise those served before
    the crash, then one flipped byte of an array file and the restore
    raising ``DataCorruptionError``."""
    import shutil

    out = {}
    base = ROOT / "build" / "persist_ann_1M"
    shutil.rmtree(base, ignore_errors=True)
    gen = torch.Generator(device=dev).manual_seed(SEED + 7)
    now = [0.0]
    reset()

    def serve(svc, rows):
        """Each block of at most ANN_RUNGS[-1] rows as a batch of its own,
        through submit and one worker step."""
        got_d, got_i = [], []
        for c in range(0, len(rows), ANN_RUNGS[-1]):
            fut = svc.submit(rows[c:c + ANN_RUNGS[-1]])
            now[0] += 1.0
            assert svc.worker.run_once()
            d, i = fut.result(timeout=0)
            got_d.append(d)
            got_i.append(i)
        return torch.cat(got_d), torch.cat(got_i)

    for kind, index in indexes.items():
        root = base / kind
        dim = index.centroids.shape[1]
        q = torch.randn(N_CHECK, dim, device=dev, generator=gen)
        vecs = torch.randn(ANN_INSERT, dim, device=dev, generator=gen)
        ids = torch.arange(N_INDEX, N_INDEX + ANN_INSERT, dtype=torch.int32)
        kw = dict(nprobe=NPROBE, nprobe_ladder=(NPROBE,), bucket_rungs=ANN_RUNGS,
                  max_batch_rows=ANN_RUNGS[-1], max_wait_ms=2.0, delta_cap=ANN_DELTA_CAP,
                  compact_rows=0, snapshot_interval_s=10.0, scrub_chunks=0, start=False,
                  clock=lambda: now[0], device=dev)
        t0 = time.perf_counter()
        svc = m.ANNService(index, K, persist_dir=str(root), name="persist_" + kind, **kw)
        bootstrap_s = time.perf_counter() - t0
        bootstrap_bytes = svc.stats()["persist"]["snapshot_bytes"]
        half = ANN_INSERT // 2
        t0 = time.perf_counter()
        for c in range(0, half, ANN_CHUNK):
            svc.insert(ids[c:c + ANN_CHUNK], vecs[c:c + ANN_CHUNK])
        wal_s = time.perf_counter() - t0
        # the interval snapshot, through the worker's maintenance seam
        # (scrub_chunks=0: the tick writes the snapshot and nothing else)
        now[0] += 11.0
        t0 = time.perf_counter()
        svc.worker.run_maintenance()
        snapshot_s = time.perf_counter() - t0
        ps = svc.stats()["persist"]
        assert ps["snapshot_seq"] == 2, ps
        snapshot_bytes = ps["snapshot_bytes"]
        for c in range(half, ANN_INSERT, ANN_CHUNK):
            svc.insert(ids[c:c + ANN_CHUNK], vecs[c:c + ANN_CHUNK])
        ref = serve(svc, q)
        found_ref = serve(svc, vecs)
        wal_bytes = svc.stats()["persist"]["wal_bytes"]
        svc.close(snapshot=False)                   # a crash: the WAL holds the tail
        del svc
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        again = m.ANNService(None, K, persist_dir=str(root), name="restore_" + kind, **kw)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        ps = again.stats()["persist"]
        assert ps["replayed_records"] == half // ANN_CHUNK, ps
        assert again.delta_rows == ANN_INSERT, again.delta_rows
        got = serve(again, q)
        found = serve(again, vecs)
        for a, b in ((got, ref), (found, found_ref)):
            assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1]), (
                "persist_ann_1M %s: the restored service answers otherwise" % kind)
        hit = (found[1].cpu() == ids[:, None]).any(dim=1)
        assert bool(hit.all()), "persist_ann_1M %s: an acknowledged insert is lost" % kind
        again.close(snapshot=False)
        del again
        # one flipped byte of one array file: the restore refuses it
        snap = sorted((root / "snapshots").iterdir())[-1]
        victim = snap / "slot_ids.bin"
        with open(victim, "r+b") as f:
            f.seek(4096)
            byte = f.read(1)
            f.seek(4096)
            f.write(bytes([byte[0] ^ 0xFF]))
        try:
            m.ANNService(None, K, persist_dir=str(root), name="corrupt_" + kind, **kw)
            raise AssertionError("persist_ann_1M %s: a corrupt snapshot restored" % kind)
        except m.DataCorruptionError as e:
            assert e.path == str(victim) and e.offset is not None, e
            corrupt = {"file": victim.name, "offset": e.offset}
        out[kind] = {"bootstrap_write_s": bootstrap_s, "bootstrap_bytes": bootstrap_bytes,
                     "wal_append_s": wal_s, "wal_records": half // ANN_CHUNK,
                     "wal_bytes": wal_bytes, "snapshot_write_s": snapshot_s,
                     "snapshot_bytes": snapshot_bytes, "restore_s": restore_s,
                     "replayed_records": ps["replayed_records"],
                     "restored_answers_bitwise_equal": True,
                     "inserts_found": int(hit.sum()), "corruption_raised": corrupt}
        shutil.rmtree(root, ignore_errors=True)
    torch.cuda.synchronize()
    out["launches"] = counts("persist_ann_1M")
    shutil.rmtree(base, ignore_errors=True)
    return out


def haversine64(a, b):
    """Haversine distances in float64 (the exactness reference)."""
    a, b = a.double(), b.double()
    sin_lat = torch.sin(0.5 * (a[:, None, 0] - b[None, :, 0]))
    sin_lon = torch.sin(0.5 * (a[:, None, 1] - b[None, :, 1]))
    r = sin_lat ** 2 + torch.cos(a[:, None, 0]) * torch.cos(b[None, :, 0]) * sin_lon ** 2
    return 2.0 * torch.arcsin(torch.sqrt(torch.clamp(r, 0.0, 1.0)))


def rbc_path(kind, dev, reset, counts, m):
    """``rbc_haversine_1M`` (all points, k 8) and ``rbc_l2_3d_1M`` (65,536
    queries, k 16): the ball cover's build and query, each query held
    exact on 1024 sampled rows, with the loop steps, chunks and peak
    bytes."""
    D = m.D
    rng = np.random.default_rng(0 if kind == "haversine" else 2)
    if kind == "haversine":
        lat = rng.uniform(-np.pi / 2, np.pi / 2, RBC_M)
        lon = rng.uniform(-np.pi, np.pi, RBC_M)
        pts = np.stack([lat, lon], 1).astype(np.float32)
        metric, k, queries = D.Haversine, RBC_HAV_K, None
    else:
        pts = rng.random((RBC_M, 3)).astype(np.float32)
        metric, k = D.L2SqrtExpanded, RBC_L2_K
        queries = torch.from_numpy(rng.random((RBC_L2_QUERIES, 3)).astype(np.float32)).to(dev)
    X = torch.from_numpy(pts).to(dev)
    name = "rbc_%s_1M" % ("haversine" if kind == "haversine" else "l2_3d")
    torch.cuda.synchronize()
    reset()
    t0 = time.perf_counter()
    idx = m.rbc_build_index(X, metric=metric, device=dev)
    torch.cuda.synchronize()
    build_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.reset_peak_memory_stats(dev)
    start_bytes = torch.cuda.memory_allocated(dev)
    stats = {}
    t0 = time.perf_counter()
    if queries is None:
        dd, ii = m.rbc_all_knn_query(idx, k, device=dev, stats=stats)
    else:
        dd, ii = m.rbc_knn_query(idx, k, queries, device=dev, stats=stats)
    torch.cuda.synchronize()
    query_ms = (time.perf_counter() - t0) * 1e3
    peak = torch.cuda.max_memory_allocated(dev)
    launched = counts(name)
    assert launched["select_tile"] > 0, launched
    q_all = X if queries is None else queries
    assert dd.shape == (len(q_all), k) and ii.dtype == torch.int32
    rows = torch.from_numpy(np.sort(np.random.default_rng(1).choice(
        len(q_all), RBC_CHECK, replace=False))).to(dev)
    qs = q_all[rows]
    if kind == "haversine":
        ref_d, ref_i = [], []
        for s in range(0, RBC_CHECK, 128):
            v, i = torch.topk(haversine64(qs[s:s + 128], X), k, dim=1, largest=False)
            ref_d.append(v.float())
            ref_i.append(i.to(torch.int32))
        ref_d, ref_i = torch.cat(ref_d), torch.cat(ref_i)
        assert torch.equal(ii[rows, 0], rows.to(torch.int32)), "%s: a self is not first" % name
        err = check_knn(name + " against float64 haversine", dd[rows], ii[rows], ref_d, ref_i,
                        RBC_HAV_ATOL)
        atol = RBC_HAV_ATOL
    else:
        ref_d, ref_i = m.brute_force_knn(X, qs, k, D.L2SqrtExpanded, device=dev)
        atol = l2_atol(qs, X)
        err = check_knn(name + " against brute force (squared)", dd[rows] ** 2, ii[rows],
                        ref_d ** 2, ref_i, atol)
    L, gmax = idx.groups.shape
    return {"launches": launched, "points": RBC_M, "queries": len(q_all), "k": k,
            "landmarks": L, "gmax": gmax, "build_ms": build_ms, "query_ms": query_ms,
            "queries_per_s": len(q_all) / query_ms * 1e3, "chunk_rows": stats["chunk_rows"],
            "chunks": stats["chunks"], "steps_per_chunk": stats["steps"],
            "budget_bytes": m.ball_cover.BUDGET_BYTES, "peak_bytes": peak,
            "peak_above_start_bytes": peak - start_bytes, "checked_rows": RBC_CHECK,
            "max_err": err, "atol": atol}


# --------------------------------------------------------------------- #
# the multi-GPU session (queue 1 item 6): a world of rank slots on the card
# --------------------------------------------------------------------- #
def query_pool(index, rows, seed=1):
    """``SHARDED_POOL`` query blocks near the data, as
    ``tools/loadgen.py:make_query_pool`` draws them: ``rows`` index rows
    a block (numpy picks from ``seed``) plus ``SHARDED_NOISE`` N(0, 1),
    summed in float64, then float32."""
    rng = np.random.default_rng(seed)
    picks = rng.integers(0, index.shape[0], (SHARDED_POOL, rows))
    return [(index[torch.from_numpy(p).to(index.device)].double()
             + torch.from_numpy(SHARDED_NOISE * rng.standard_normal((rows, index.shape[1])))
             .to(index.device)).float() for p in picks]


def assert_served_unbatched(name, served, blocks, unbatched):
    """Every served answer, ``served`` as (block index, (d, i)), bitwise
    equal to ``unbatched(block)``: one call a pool block, then one
    comparison a block over all of its answers stacked."""
    for b in sorted({j for j, _ in served}):
        d0, i0 = unbatched(blocks[b])
        got = [out for j, out in served if j == b]
        ds, ids = torch.stack([d for d, _ in got]), torch.stack([i for _, i in got])
        assert torch.equal(ds, d0.expand_as(ds)) and torch.equal(ids, i0.expand_as(ids)), (
            "%s: an answer to pool block %d differs from the unbatched call" % (name, b))


def service_counter(name, service):
    """A service-labelled counter's total in the default registry (0 when absent)."""
    from raft_tpu_torch.core.metrics import default_registry

    fam = default_registry().get(name)
    if fam is None:
        return 0.0
    return float(sum(s.value for labels, s in fam.series() if labels.get("service") == service))


def staged_bytes():
    from raft_tpu_torch.core.metrics import default_registry

    fam = default_registry().get("raft_tpu_comms_host_staged_bytes")
    return 0.0 if fam is None else float(sum(s.value for _, s in fam.series()))


def tie_rows(name, got_d, got_i, ref_d, ref_i, atol):
    """Rows whose ids differ from the reference's, each held to differ
    only among ties: at a differing position the distance is shared with
    another position of the row (within ``atol``) or with the k-th.
    Returns (rows that differ, rows that differ only among exact ties)."""
    rows = torch.nonzero((got_i != ref_i).any(dim=1)).flatten().tolist()
    exact = 0
    for r in rows:
        d = ref_d[r]
        only_exact = True
        for p in torch.nonzero(got_i[r] != ref_i[r]).flatten().tolist():
            near = ((d - d[p]).abs() <= atol).sum().item()
            assert near >= 2 or abs(d[p].item() - d[-1].item()) <= atol, (
                "%s: row %d position %d differs off a tie" % (name, r, p))
            only_exact &= bool((d == d[p]).sum().item() >= 2 or d[p].item() == d[-1].item())
        exact += int(only_exact)
    return len(rows), exact


def session_paths(ctx, m):
    """The multi-GPU session on the card (queue 1 item 6): the paths
    ``comms_selftest_4``, ``mnmg_knn_1M``, ``mnmg_ivf_1M``,
    ``serve_knn_sharded_500k``, ``session_recover`` and
    ``serve_knn_replicas`` (module doc).  A world of N is N rank slots on
    ``ctx.dev``; ranks that share one card measure the cost of the merge,
    not scaling.  Returns (paths, kernel rows' extra entries)."""
    dev, D, reset, counts = ctx.dev, m.D, ctx.reset, ctx.counts
    paths, extra = {}, {}
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)

    def world(n):
        return m.Mesh([dev] * n, ("ranks",))

    # comms_selftest_4: the battery on a world of 4, the status test, and
    # the three p2p routes' host-staged bytes on a ring of 1 MB rows
    mesh4 = world(MNMG_WORLD)
    t0 = time.perf_counter()
    battery = m.selftest.run_all(m.HostComms(mesh4))
    battery_ms = (time.perf_counter() - t0) * 1e3
    assert all(battery.values()), battery
    assert m.selftest.test_sync_stream_status(m.HostComms(mesh4))
    comms = m.HostComms(mesh4)
    staged = {}
    for route in ("device", "ppermute", "host"):
        sends = [torch.full((SELFTEST_P2P_FLOATS,), float(r), device=dev)
                 for r in range(MNMG_WORLD)]
        recvs = []
        for r in range(MNMG_WORLD):
            comms.isend(sends[r], rank=r, dest=(r + 1) % MNMG_WORLD, tag=3)
            recvs.append(comms.irecv(rank=r, source=(r - 1) % MNMG_WORLD, tag=3))
        before = staged_bytes()
        t0 = time.perf_counter()
        comms.waitall(staging=route)
        sync()
        staged[route] = {"ms": (time.perf_counter() - t0) * 1e3,
                         "host_staged_bytes": staged_bytes() - before}
        for r in range(MNMG_WORLD):
            got = recvs[r].result
            assert got.device == dev and bool((got == float((r - 1) % MNMG_WORLD)).all()), route
    row_bytes = 4 * SELFTEST_P2P_FLOATS
    assert staged["device"]["host_staged_bytes"] == 0, staged
    assert staged["ppermute"]["host_staged_bytes"] == 0, staged
    assert staged["host"]["host_staged_bytes"] == MNMG_WORLD * row_bytes, staged
    paths["comms_selftest_4"] = {"ranks": MNMG_WORLD, "tests": battery, "battery_ms": battery_ms,
                                 "p2p_row_bytes": row_bytes, "p2p": staged}
    print("comms_selftest_4: %s" % json.dumps(paths["comms_selftest_4"]), flush=True)

    # mnmg_knn_1M (BASELINE.md config #5 at config #3's shape): the index
    # sharded over a world of 4, each topology, and a world of 1
    index, queries = ctx.index, ctx.queries
    n, nq = index.shape[0], queries.shape[0]
    rows = -(-n // MNMG_WORLD)
    atol = ctx.l2_atol(queries, index)
    cases = [("allgather", mesh4, "allgather", None), ("ring", mesh4, "ring", None),
             ("hierarchical", mesh4, "hierarchical", 2), ("world1", world(1), "allgather", None)]
    out = {"ranks": MNMG_WORLD, "shard_rows": rows, "runs": {}}
    results = {}
    reset()
    for name, mesh, merge, g in cases:
        c0 = counts()
        d, i = m.mnmg_knn(index, queries, K, D.L2SqrtExpanded, mesh=mesh, axis="ranks",
                          merge=merge, group_size=g)
        sync()
        c1 = counts()
        results[name] = (d, i)
        err = ctx.check_knn("mnmg_knn_1M %s vs brute_force_knn (squared)" % name, d ** 2, i,
                            ctx.bf_d ** 2, ctx.bf_i, atol)
        out["runs"][name] = {"launches": {k: c1[k] - c0[k] for k in c1}, "max_err": err,
                             "ranks": mesh.size, "merge": merge, "group_size": g}
    out["launches"] = counts("mnmg_knn_1M")
    assert out["launches"]["knn_tile"] >= 3 * MNMG_WORLD + 1, out["launches"]
    assert out["launches"]["select_tile"] > 0, out["launches"]
    ref = results["allgather"]
    for name in ("ring", "hierarchical"):
        assert torch.equal(results[name][0], ref[0]) and torch.equal(results[name][1], ref[1]), (
            "mnmg_knn_1M: %s differs from allgather" % name)
    out["topologies_bitwise_equal"] = True
    shards = list(index.split(rows))
    local_ms = ctx.time_ms(lambda: [m.fused_knn_tile(s, queries, K) for s in shards], reps=5)
    out["local_search_ms"] = local_ms
    for name, mesh, merge, g in cases:
        ms = ctx.time_ms(lambda: m.mnmg_knn(index, queries, K, D.L2SqrtExpanded, mesh=mesh,
                                            axis="ranks", merge=merge, group_size=g), reps=5)
        out["runs"][name]["ms"] = ms
        if mesh.size == MNMG_WORLD:
            out["runs"][name]["merge_share"] = max(0.0, 1.0 - local_ms / ms)
    # K1 at a shard's shape, and K2 bit for bit on the merges' own keys
    k1 = m.fused_knn_tile(shards[0], queries, K)
    k1_ref = m.knn_tile_plain(shards[0], queries[:N_CHECK], K)
    k1_err = ctx.check_knn("knn_tile at a shard's shape", k1[0][:N_CHECK], k1[1][:N_CHECK],
                           *k1_ref, atol)
    local = [m.fused_knn_tile(s, queries, K) for s in shards]
    cand = [(d, (ii + j * rows).to(torch.int32)) for j, (d, ii) in enumerate(local)]

    def by_id(parts):
        ids = torch.cat([p[1] for p in parts], dim=1)
        ids, order = torch.sort(ids, dim=1, stable=True)
        return torch.gather(torch.cat([p[0] for p in parts], dim=1), 1, order)

    merge_keys = {"allgather": by_id(cand), "hierarchical group": by_id(cand[:2]),
                  "ring step": by_id([cand[1], cand[0]])}
    for what, keys in merge_keys.items():
        got, want = m.select_tile(keys, K), m.select_tile_plain(keys, K)
        ctx.check_exact("select_tile mnmg merge %s values" % what, got[0], want[0])
        ctx.check_exact("select_tile mnmg merge %s ids" % what, got[1], want[1])
    out["k2_merge_checks"] = {what: list(keys.shape) for what, keys in merge_keys.items()}
    knn_ops, knn_bytes = m.cost.knn_cost(nq, rows, DIM, K)
    b, by = bound_tf32x3(knn_ops, knn_bytes)

    def shard_topk():
        return torch.topk((queries * queries).sum(1, keepdim=True) + (shards[0] * shards[0]).sum(1)
                          - 2.0 * (queries @ shards[0].T), K, dim=1, largest=False)

    extra["k1_shard"] = {
        "shape": "shard %dx%d f32, %d queries, k=%d" % (rows, DIM, nq, K),
        "launches": out["launches"]["knn_tile"], "max_abs_err": k1_err,
        "ms": ctx.time_ms(lambda: m.fused_knn_tile(shards[0], queries, K), reps=5),
        "plain_ms": ctx.time_ms(lambda: m.knn_tile_plain(shards[0], queries, K), reps=1),
        "bound_ms": b, "bound_by": by, "library_ms": ctx.time_ms(shard_topk, reps=3)}
    ctx.errs["knn_tile"] = max(ctx.errs["knn_tile"], k1_err)
    if torch.cuda.device_count() > 1:
        cards = m.Mesh([torch.device("cuda", c)
                        for c in range(min(MNMG_WORLD, torch.cuda.device_count()))], ("ranks",))
        d, i = m.mnmg_knn(index, queries, K, D.L2SqrtExpanded, mesh=cards, axis="ranks")
        out["distinct_cards"] = {
            "cards": cards.size,
            "max_err": ctx.check_knn("mnmg_knn_1M on distinct cards", d ** 2, i,
                                     ctx.bf_d ** 2, ctx.bf_i, atol),
            "ms": ctx.time_ms(lambda: m.mnmg_knn(index, queries, K, D.L2SqrtExpanded,
                                                 mesh=cards, axis="ranks"), reps=5)}
    del shards, local, cand, merge_keys, results
    paths["mnmg_knn_1M"] = out
    print("mnmg_knn_1M: %s" % json.dumps(out), flush=True)

    # mnmg_ivf_1M: the IVF-Flat index slot-sharded over the world of 4
    ivf, ivf_q = ctx.ivf, ctx.ivf_q
    sharded = m.shard_ivf_flat_index(ivf, mesh4, "ranks")
    out = {"ranks": MNMG_WORLD, "nprobe": NPROBE,
           "slots_per_rank": [int(v.shape[0]) for v in sharded.slot_vecs], "runs": {}}
    results = {}
    reset()
    for merge in ("allgather", "ring", "hierarchical"):
        c0 = counts()
        d, i = m.mnmg_ivf_flat_search(sharded, ivf_q, K, nprobe=NPROBE, merge=merge)
        sync()
        c1 = counts()
        results[merge] = (d, i)
        assert (d - ctx.ivf_d).abs().max().item() <= IVF_ATOL, (merge, (d - ctx.ivf_d).abs().max())
        err = ctx.check_knn("mnmg_ivf_1M %s vs ivf_flat_search (squared)" % merge, d ** 2, i,
                            ctx.ivf_d ** 2, ctx.ivf_i, ctx.l2_atol(ivf_q, ctx.X))
        differ, exact = tie_rows("mnmg_ivf_1M " + merge, d, i, ctx.ivf_d, ctx.ivf_i, IVF_ATOL)
        out["runs"][merge] = {"launches": {k: c1[k] - c0[k] for k in c1}, "max_err": err,
                              "max_abs_dist_diff": (d - ctx.ivf_d).abs().max().item(),
                              "rows_differing_among_ties": differ,
                              "of_which_exact_ties": exact}
    out["launches"] = counts("mnmg_ivf_1M")
    assert out["launches"]["ivf_tile"] >= MNMG_WORLD and out["launches"]["select_tile"] > 0
    for merge in ("ring", "hierarchical"):
        assert torch.equal(results[merge][0], results["allgather"][0]) and torch.equal(
            results[merge][1], results["allgather"][1]), "mnmg_ivf_1M: %s differs" % merge
    out["topologies_bitwise_equal"] = True
    fp_d, fp_i = m.mnmg_ivf_flat_search(sharded, ivf_q[:N_FULL_PROBE], K, nprobe=NLIST)
    bf_d, bf_i = m.brute_force_knn(ctx.X, ivf_q[:N_FULL_PROBE], K, D.L2SqrtExpanded, device=dev)
    out["full_probe_max_err"] = ctx.check_knn("mnmg_ivf_1M full probe vs brute force (squared)",
                                              fp_d ** 2, fp_i, bf_d ** 2, bf_i,
                                              ctx.l2_atol(ivf_q, ctx.X))
    for merge in ("allgather", "ring", "hierarchical"):
        out["runs"][merge]["ms"] = ctx.time_ms(
            lambda: m.mnmg_ivf_flat_search(sharded, ivf_q, K, nprobe=NPROBE, merge=merge), reps=5)
    # K3 at a shard's shape: rank 0's slots, its probe scan lists
    sv, sn, si = sharded.slot_vecs[0], sharded.slot_norms[0], sharded.slot_ids[0]
    slots, _ = m.probe_compact(ivf_q, sharded.centroids[0], sharded.cent_slots_local[0], NPROBE)
    slots = slots[:, :min(slots.shape[1], sv.shape[0])].contiguous()
    args = (ivf_q, sv, sn, si, slots, K)
    k3_err = ctx.check_knn("ivf_tile at a shard's shape", *m.fused_ivf_scan(*args),
                           *m.fused_ivf_scan_plain(*args), ctx.l2_atol(ivf_q, ctx.X))
    ctx.errs["ivf_tile"] = max(ctx.errs["ivf_tile"], k3_err)
    rows_in_slot = (si >= 0).sum(dim=1)
    live = slots >= 0
    scanned = int(rows_in_slot[slots[live].long()].sum())
    distinct = int(rows_in_slot[torch.unique(slots[live].long())].sum())
    b, by = bound_tf32x3(*m.cost.ivf_scan_cost(nq, DIM, K, slots.numel(), scanned, distinct))
    extra["k3_shard"] = {
        "shape": "%d queries x %d scan steps over rank 0's %d slots of %d x %d f32, k=%d"
                 % (nq, slots.shape[1], sv.shape[0], sv.shape[1], DIM, K),
        "launches": out["launches"]["ivf_tile"], "max_abs_err": k3_err,
        "ms": ctx.time_ms(lambda: m.fused_ivf_scan(*args), reps=5),
        "plain_ms": ctx.time_ms(lambda: m.fused_ivf_scan_plain(*args), reps=1),
        "bound_ms": b, "bound_by": by, "library_ms": None}
    del sharded, results, slots, args
    paths["mnmg_ivf_1M"] = out
    print("mnmg_ivf_1M: %s" % json.dumps(out), flush=True)

    # serve_knn_sharded_500k: the JAX rung bench.py:1167-1247 (500,000 x
    # 128, k 100, 16 threads of 16-row requests drawn from its query pool,
    # a 4 s closed loop a world), worlds 1-8 hierarchical, the other two
    # topologies at the top world for 2 s each
    index500 = index[:SHARDED_N]
    blocks = query_pool(index500, SHARDED_ROWS)
    out = {"index_rows": SHARDED_N, "runs": {}, "launches": None,
           "query_pool": "%d blocks of %d index rows + %.1f N(0, 1), numpy seed 1"
                         % (SHARDED_POOL, SHARDED_ROWS, SHARDED_NOISE),
           "note": "ranks that share one card measure the cost of the merge, not scaling"}
    total = None
    for w, merge, seconds in [(1, "hierarchical", SHARDED_SECONDS),
                              (2, "hierarchical", SHARDED_SECONDS),
                              (4, "hierarchical", SHARDED_SECONDS),
                              (8, "hierarchical", SHARDED_SECONDS),
                              (8, "allgather", SHARDED_SECONDS / 2),
                              (8, "ring", SHARDED_SECONDS / 2)]:
        name = "serve_knn_sharded_500k_w%d_%s" % (w, merge)
        svc = m.KNNService(index500, K, D.L2SqrtExpanded, mesh=world(w), axis="ranks",
                           merge=merge, max_batch_rows=SHARDED_RUNGS[-1],
                           bucket_rungs=list(SHARDED_RUNGS), max_wait_ms=2.0, queue_cap=4096,
                           device=dev, name=name)
        svc.warmup()
        reset()
        served = []
        rows_served, wall_ms, lat = closed_loop(svc, blocks, SHARDED_THREADS, seconds, served)
        sync()
        launched = counts(name)
        after = svc.kernel_libraries_after_warmup()
        batches = service_counter("raft_tpu_serve_batches_total", name)
        spmd = svc._spmd
        svc.close()
        assert after == {"builds": 0, "loads": 0}, (name, after)
        assert launched["knn_tile"] > 0 and launched["select_tile"] > 0, launched
        assert_served_unbatched(name, served, blocks, lambda q: m.mnmg_knn(
            spmd.index, q, K, D.L2SqrtExpanded, mesh=spmd.mesh, axis="ranks",
            n_rows=spmd.n_rows, merge=merge))
        total = launched if total is None else {k: total[k] + launched[k] for k in total}
        out["runs"]["w%d_%s" % (w, merge)] = {
            "ranks": w, "merge": merge, "seconds": seconds, "requests": len(served),
            "batches": int(batches),
            "rows_per_batch": rows_served / max(batches, 1), "wall_ms": wall_ms,
            "rows_per_s": rows_served / wall_ms * 1e3, "p50_ms": statistics.median(lat),
            "p99_ms": quantile(lat, 0.99), "launches": launched,
            "kernel_libraries_after_warmup": after}
        del svc, spmd, served
    out["launches"] = total
    out["every_response_bitwise_equal_to_unbatched"] = True
    paths["serve_knn_sharded_500k"] = out
    print("serve_knn_sharded_500k: %s" % json.dumps(out), flush=True)

    # session_recover: a session on a world of 4 serving a sharded
    # KNNService and a sharded ANNService; rank 3 lost through the fault
    # seam; RecoveryManager onto ranks 0-2
    phases = {}
    t0 = time.perf_counter()
    sess = m.Comms(mesh=world(MNMG_WORLD)).init()
    common = dict(max_batch_rows=SHARDED_RUNGS[-1], bucket_rungs=list(SHARDED_RUNGS),
                  max_wait_ms=2.0, queue_cap=4096)
    try:
        knn = sess.serve("knn", index=index500, k=K, metric=D.L2SqrtExpanded, axis="ranks",
                         merge="hierarchical", name="session_knn", **common)
        ann = sess.serve("ann", index=ivf, k=K, nprobe=NPROBE, nprobe_ladder=[NPROBE],
                         axis="ranks", merge="hierarchical", delta_cap=SESSION_INSERT * 2,
                         compact_rows=0, name="session_ann", **common)
        knn.warmup()
        ann.warmup()
        sync()
        phases["serve_and_warmup_s"] = time.perf_counter() - t0
        reset()
        new_vecs = ctx.mixture(SESSION_INSERT)
        new_ids = torch.arange(N_INDEX, N_INDEX + SESSION_INSERT, dtype=torch.int32)
        t0 = time.perf_counter()
        for c in range(0, SESSION_INSERT, ANN_CHUNK):
            ann.insert(new_ids[c:c + ANN_CHUNK], new_vecs[c:c + ANN_CHUNK])
        phases["insert_s"] = time.perf_counter() - t0
        fq_knn, fq_ann = queries[:SESSION_FIXED], ivf_q[:SESSION_FIXED]
        pre = [f.result(timeout=120) for f in [knn.submit(b) for b in fq_knn.split(64)]]
        with m.faults.inject(sess.comms, m.faults.Abort(rank=MNMG_WORLD - 1)):
            t0 = time.perf_counter()
            health = sess.health_check()
            phases["health_check_s"] = time.perf_counter() - t0
            assert not health["ok"], health
            assert health["ranks"] == {r: r != MNMG_WORLD - 1 for r in range(MNMG_WORLD)}, health
            assert health["services"]["session_knn"]["mesh_ok"], health["services"]
            t0 = time.perf_counter()
            try:
                sess.comms.allreduce(torch.ones((MNMG_WORLD, 1), device=dev))
                raise AssertionError("a verb on the aborted communicator ran")
            except m.CommAbortedError:
                phases["fail_fast_ms"] = (time.perf_counter() - t0) * 1e3
            t0 = time.perf_counter()
            rep = m.RecoveryManager(sess).recover(devices=list(range(MNMG_WORLD - 1)))
            phases["recover_s"] = time.perf_counter() - t0
        phases["recovery_report_s"] = rep["recovery_s"]
        assert rep["comms_recovered"] and rep["quiesced"], rep
        t0 = time.perf_counter()
        after_tests = m.selftest.run_all(sess.comms)
        phases["selftest_after_s"] = time.perf_counter() - t0
        assert sess.comms.get_size() == MNMG_WORLD - 1 and all(after_tests.values()), after_tests
        survivors = tuple(range(MNMG_WORLD - 1))
        assert knn.mesh.rank_ids() == survivors and ann.mesh.rank_ids() == survivors
        assert knn.stats()["shard_devices"] == ann.stats()["shard_devices"] == MNMG_WORLD - 1
        assert sess.health_check()["ok"]
        t0 = time.perf_counter()
        post = [f.result(timeout=120) for f in [knn.submit(b) for b in fq_knn.split(64)]]
        ann_out = [f.result(timeout=120) for f in [ann.submit(b) for b in fq_ann.split(64)]]
        found = [f.result(timeout=120) for f in [ann.submit(v) for v in new_vecs.split(128)]]
        sync()
        phases["post_queries_s"] = time.perf_counter() - t0
        launched = counts("session_recover")
        after_warmup = {s.name: s.kernel_libraries_after_warmup() for s in (knn, ann)}
        st = ann._ann_state
    finally:
        sess.destroy()
    assert launched["knn_tile"] > 0 and launched["ivf_tile"] > 0 and launched["select_tile"] > 0
    for name, a in after_warmup.items():
        assert a == {"builds": 0, "loads": 0}, (name, a)
    kd = torch.cat([d for d, _ in post])
    ki = torch.cat([i for _, i in post])
    bf_d, bf_i = m.brute_force_knn(index500, fq_knn, K, D.L2SqrtExpanded, device=dev)
    knn_err = ctx.check_knn("session_recover knn vs brute force (squared)", kd ** 2, ki,
                            bf_d ** 2, bf_i, ctx.l2_atol(fq_knn, index500))
    pre_equal = all(torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
                    for a, b in zip(pre, post))
    ad = torch.cat([d for d, _ in ann_out])
    ai = torch.cat([i for _, i in ann_out])
    rd, ri = m.ivf_flat_search(ivf, fq_ann, K, nprobe=NPROBE,
                               delta=(st.delta_vecs, st.delta_ids), device=dev)
    ann_err = ctx.check_knn("session_recover ann vs ivf_flat_search (squared)", ad ** 2, ai,
                            rd ** 2, ri, ctx.l2_atol(fq_ann, ctx.X))
    fd = torch.cat([d for d, _ in found])
    fi = torch.cat([i for _, i in found])
    ins_tol = ctx.l2_atol(new_vecs, ctx.X) ** 0.5
    assert torch.equal(fi[:, 0].cpu(), new_ids), "session_recover: an insert lost its id"
    assert fd[:, 0].max().item() <= ins_tol, (fd[:, 0].max().item(), ins_tol)
    paths["session_recover"] = {
        "ranks_before": MNMG_WORLD, "ranks_after": MNMG_WORLD - 1, "phases_s": phases,
        "health_ranks": {str(k): v for k, v in health["ranks"].items()},
        "health_tests_passed": sum(health["tests"].values()),
        "selftests_after": sum(after_tests.values()), "launches": launched,
        "knn_max_err": knn_err, "knn_answers_equal_to_pre_fault": pre_equal,
        "ann_max_err": ann_err, "inserted": SESSION_INSERT,
        "insert_max_dist": fd[:, 0].max().item(), "kernel_libraries_after_warmup": after_warmup}
    print("session_recover: %s" % json.dumps(paths["session_recover"]), flush=True)
    del knn, ann, st

    # serve_knn_replicas: two replicas of two ranks over the world of 4, a
    # fixed hedge threshold, unfaulted and then with replica 1 delayed
    name = "serve_knn_replicas"
    svc = m.KNNService(index500, K, D.L2SqrtExpanded, mesh=world(MNMG_WORLD), axis="ranks",
                       replicas=2, hedge_ms=REPLICA_HEDGE_MS, merge="hierarchical",
                       device=dev, name=name, **common)
    svc.warmup()
    reset()
    out = {"replicas": 2, "ranks_per_replica": MNMG_WORLD // 2, "hedge_ms": REPLICA_HEDGE_MS,
           "delay_s": REPLICA_DELAY_S, "seconds_per_arm": SHARDED_SECONDS}
    served = []
    counters = ("raft_tpu_serve_hedges_total", "raft_tpu_serve_hedge_wins_total",
                "raft_tpu_serve_hedge_cancelled_total", "raft_tpu_serve_replica_failovers_total",
                "raft_tpu_serve_replica_errors_total")
    try:
        for arm in ("unfaulted", "replica1_delayed"):
            c0 = {c: service_counter(c, name) for c in counters}
            with (m.inject_replica(svc, 1, m.faults.Delay(REPLICA_DELAY_S))
                  if arm != "unfaulted" else contextlib.nullcontext()):
                got = []
                rows_served, wall_ms, lat = closed_loop(svc, blocks, SHARDED_THREADS,
                                                        SHARDED_SECONDS, got)
            sync()
            served += got
            out[arm] = {"requests": len(got), "wall_ms": wall_ms,
                        "rows_per_s": rows_served / wall_ms * 1e3,
                        "p50_ms": statistics.median(lat), "p99_ms": quantile(lat, 0.99),
                        **{c[len("raft_tpu_serve_"):]: service_counter(c, name) - c0[c]
                           for c in counters}}
        launched = counts(name)
        after = svc.kernel_libraries_after_warmup()
        state = svc._replica_set.replicas[0]
        rep_desc = svc.stats()["replicas"]
    finally:
        svc.close()
    assert after == {"builds": 0, "loads": 0}, after
    assert launched["knn_tile"] > 0 and launched["select_tile"] > 0, launched
    assert out["replica1_delayed"]["hedges_total"] >= 1, out
    assert out["replica1_delayed"]["hedge_wins_total"] >= 1, out
    sharded0, _ = m.shard_knn_index(index500, state.mesh, "ranks")
    assert_served_unbatched(name, served, blocks, lambda q: m.mnmg_knn(
        sharded0, q, K, D.L2SqrtExpanded, mesh=state.mesh, axis="ranks", merge="hierarchical"))
    out.update({"launches": launched, "kernel_libraries_after_warmup": after,
                "replica_ranks": [r["ranks"] for r in rep_desc["replicas"]],
                "every_response_bitwise_equal_to_unbatched": True})
    paths[name] = out
    print("%s: %s" % (name, json.dumps(out)), flush=True)
    return paths, extra


def free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def mp_children(root, tag, devices, extra, late_s=None):
    """Run one session of ``len(devices)`` processes of ``python -m
    raft_tpu_torch.comms.mp_selftest`` (process i on ``devices[i]``, its
    log under ``root``), bounded by ``MP_CHILD_TIMEOUT_S``; with
    ``late_s``, process 1 starts only once process 0's store answers and
    ``late_s`` more seconds have passed.  Every child is killed on the way
    out.  Returns the reports; raises if a child failed."""
    port = free_port()
    procs, logs, outs = [], [], []

    def start(i):
        outs.append(root / ("%s_p%d.json" % (tag, i)))
        logs.append(open(root / ("%s_p%d.log" % (tag, i)), "w"))
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "raft_tpu_torch.comms.mp_selftest", "--process-id", str(i),
             "--num-processes", str(len(devices)), "--coordinator", "127.0.0.1:%d" % port,
             "--slots", str(MP_SLOTS), "--device", devices[i], "--out", str(outs[i]),
             "--reps", str(MP_REPS), "--bootstrap-timeout", str(MP_BOOT_TIMEOUT_S),
             "--bootstrap-retries", "60", *extra],
            cwd=str(ROOT), stdout=logs[i], stderr=subprocess.STDOUT))

    t0 = time.perf_counter()
    try:
        start(0)
        if late_s is not None:
            import datetime

            probe = torch.distributed.TCPStore(
                "127.0.0.1", port, len(devices), False, wait_for_workers=False,
                timeout=datetime.timedelta(seconds=MP_CHILD_TIMEOUT_S))
            del probe
            time.sleep(late_s)
        for i in range(1, len(devices)):
            start(i)
        for p in procs:
            p.wait(timeout=max(1.0, MP_CHILD_TIMEOUT_S - (time.perf_counter() - t0)))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)
        for f in logs:
            f.close()
    reports = []
    for i, (p, out) in enumerate(zip(procs, outs)):
        tail = (root / ("%s_p%d.log" % (tag, i))).read_text()[-3000:]
        assert p.returncode == 0 and out.exists(), "%s process %d: rc %s\n%s%s" % (
            tag, i, p.returncode, tail, out.read_text()[-3000:] if out.exists() else "")
        reports.append(json.loads(out.read_text()))
    return reports, time.perf_counter() - t0


def mp_paths(ctx, m):
    """The multi-process session on the card (queue 1 item 8): two child
    processes of two rank slots each on ``ctx.dev`` (a world of 4 spanning
    2 processes; one card held by both, so the backend rule picks gloo):
    ``mp_comms_selftest_4``, ``mp_mnmg_knn_1M``, ``mp_mnmg_ivf_1M`` and
    ``mp_bootstrap`` (module doc).  Every child answer is held bitwise to
    this process's one-process world of 4 for the same merge (digests of
    the distance and id bytes).  The NCCL arm runs where the machine shows
    two or more cards.  The children live under ``build/mp/``, removed
    after.  Returns (paths, per-kernel launches inside the children)."""
    import shutil

    dev, D = ctx.dev, m.D
    root = ROOT / "build" / "mp"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    paths = {}
    world = MP_PROCESSES * MP_SLOTS
    merges = ("allgather", "ring", "hierarchical")
    try:
        # mp_bootstrap: a session aimed at a coordinator nobody serves
        policy = m.RetryPolicy(max_retries=2, base_delay=0.05, timeout=MP_DEAD_TIMEOUT_S)
        t0 = time.perf_counter()
        try:
            m.Comms(mesh=m.Mesh([dev] * MP_SLOTS, ("ranks",)),
                    coordinator_address="127.0.0.1:%d" % free_port(), num_processes=2,
                    process_id=1, bootstrap_retry_policy=policy).init()
            raise AssertionError("mp_bootstrap: a session with no coordinator came up")
        except m.CommError as e:
            dead_s = time.perf_counter() - t0
            assert "after 3 attempts" in str(e), e
        dead_bound = 3 * MP_DEAD_TIMEOUT_S + sum(policy.schedule()) + 2.0
        assert dead_s <= dead_bound, (dead_s, dead_bound)

        # this process's one-process world of 4: the answers the children
        # are held to, on the children's data (numpy, from the seed)
        rng = np.random.default_rng(MP_SEED)
        index = torch.from_numpy(rng.standard_normal((N_INDEX, DIM), dtype=np.float32)).to(dev)
        queries = torch.from_numpy(rng.standard_normal((N_QUERIES, DIM),
                                                       dtype=np.float32)).to(dev)
        one = m.Mesh([dev] * world, ("ranks",))
        want_knn, want_ivf, one_ms = {}, {}, {}
        for merge in merges:
            g = MP_SLOTS if merge == "hierarchical" else None
            want_knn[merge] = m.digest(*m.mnmg_knn(index, queries, K, D.L2Expanded, mesh=one,
                                                   axis="ranks", merge=merge, group_size=g))
            one_ms[merge] = ctx.time_ms(lambda: m.mnmg_knn(
                index, queries, K, D.L2Expanded, mesh=one, axis="ranks", merge=merge,
                group_size=g), reps=5)
        del index, queries
        snap = root / "ivf"
        t0 = time.perf_counter()
        m.write_snapshot(str(snap), ctx.ivf, seq=1, wal_seq=0)
        np.save(snap / "queries.npy", ctx.ivf_q.cpu().numpy())
        snapshot_s = time.perf_counter() - t0
        ivf_digest = m.digest(ctx.ivf.centroids, ctx.ivf.slot_vecs, ctx.ivf.slot_ids,
                              ctx.ivf.cent_slots)
        sharded = m.shard_ivf_flat_index(ctx.ivf, one, "ranks")
        for merge in merges:
            g = MP_SLOTS if merge == "hierarchical" else None
            want_ivf[merge] = m.digest(*m.mnmg_ivf_flat_search(sharded, ctx.ivf_q, K,
                                                               nprobe=NPROBE, merge=merge,
                                                               group_size=g))
        del sharded

        # the two children: child 1 joins late, so child 0's bootstrap retries
        reports, wall_s = mp_children(
            root, "gloo", [str(dev)] * MP_PROCESSES,
            ["--knn", "%d,%d,%d,%d" % (N_INDEX, DIM, N_QUERIES, K), "--seed", str(MP_SEED),
             "--ivf", str(snap), "--nprobe", str(NPROBE), "--k", str(K)], late_s=MP_LATE_S)
        for r in reports:
            assert r["ok"], r["failures"]
            assert r["backend"] == "gloo" and r["build"]["builds"] == 0, (r["backend"], r["build"])
            assert r["process_indices"] == [p for p in range(MP_PROCESSES)
                                            for _ in range(MP_SLOTS)], r["process_indices"]
            assert r["axis_host_group_size"] == MP_SLOTS and r["remote_device_refused"]
        assert reports[0]["bootstrap_retries"] >= 1, reports[0]["bootstrap_retries"]
        launches = {part: {name: sum(r[part]["launches"].get(name, 0) for r in reports)
                           for name in ctx.wrappers} for part in ("knn", "ivf")}
        if dev.type == "cuda":      # (a rehearsal on the CPU runs the plain versions)
            assert launches["knn"]["knn_tile"] >= world and launches["knn"]["select_tile"] > 0
            assert launches["ivf"]["ivf_tile"] >= world and launches["ivf"]["select_tile"] > 0

        paths["mp_comms_selftest_4"] = {
            "processes": MP_PROCESSES, "slots_per_process": MP_SLOTS, "ranks": world,
            "backend": reports[0]["backend"],
            "tests": [r["selftests"] for r in reports],
            "health": [r["health"] for r in reports],
            "process_indices": reports[0]["process_indices"],
            "axis_host_group_size": reports[0]["axis_host_group_size"],
            "host_staged_bytes": [r["exchange"]["host_staged_bytes"] for r in reports],
            "bootstrap_s": [r["bootstrap_s"] for r in reports],
            "bootstrap_retries": [r["bootstrap_retries"] for r in reports],
            "kernel_builds_in_children": [r["build"]["builds"] for r in reports],
            "kernel_loads_in_children": [r["build"]["loads"] for r in reports],
            "children_wall_s": wall_s}
        print("mp_comms_selftest_4: %s" % json.dumps(paths["mp_comms_selftest_4"]), flush=True)
        for part, name, want in (("knn", "mp_mnmg_knn_1M", want_knn),
                                 ("ivf", "mp_mnmg_ivf_1M", want_ivf)):
            runs = {}
            for merge in merges:
                got = [r[part]["runs"][merge] for r in reports]
                assert all(g["digest"] == want[merge] for g in got), (
                    "%s %s: a child's answer differs from this process's world of %d"
                    % (name, merge, world))
                runs[merge] = {
                    "bitwise_equal_to_one_process_world": True,
                    "ms": [g["ms"] for g in got], "ms_all": [g["ms_all"] for g in got],
                    "exchange_ms": [g["exchange_ms"] for g in got],
                    "exchange_share": [g["exchange_share"] for g in got],
                    "bytes_exchanged_per_search": got[0]["bytes_exchanged_per_search"]}
                if part == "knn":
                    runs[merge]["one_process_world_ms"] = one_ms[merge]
            check = "k1_check" if part == "knn" else "k3_check"
            out = {"processes": MP_PROCESSES, "ranks": world, "backend": reports[0]["backend"],
                   "runs": runs, "launches": launches[part],
                   check: [r[part][check] for r in reports]}
            if part == "knn":
                out["shape"] = "index %dx%d f32 (numpy seed %d), %d queries, k=%d, L2Expanded" % (
                    N_INDEX, DIM, MP_SEED, N_QUERIES, K)
            else:
                out.update(nprobe=NPROBE, index_digest_equal=all(
                    r["ivf"]["index_digest"] == ivf_digest for r in reports),
                    snapshot_write_s=snapshot_s)
                assert out["index_digest_equal"], "mp_mnmg_ivf_1M: a child restored another index"
            paths[name] = out
            print("%s: %s" % (name, json.dumps(out)), flush=True)
        paths["mp_bootstrap"] = {
            "dead_coordinator": {"attempts": 3, "attempt_timeout_s": MP_DEAD_TIMEOUT_S,
                                 "seconds": dead_s, "bound_s": dead_bound},
            "late_join": {"delay_s": MP_LATE_S, "attempt_timeout_s": MP_BOOT_TIMEOUT_S,
                          "retries": [r["bootstrap_retries"] for r in reports],
                          "bootstrap_s": [r["bootstrap_s"] for r in reports]}}
        print("mp_bootstrap: %s" % json.dumps(paths["mp_bootstrap"]), flush=True)

        # the NCCL route: one card a process
        cards = torch.cuda.device_count() if dev.type == "cuda" else 0
        if cards >= MP_PROCESSES:
            nreports, nwall = mp_children(
                root, "nccl", ["cuda:%d" % i for i in range(MP_PROCESSES)],
                ["--knn", "%d,%d,%d,%d" % (N_INDEX, DIM, N_QUERIES, K), "--seed", str(MP_SEED)])
            for r in nreports:
                assert r["ok"] and r["backend"] == "nccl", (r["backend"], r["failures"])
                for merge in merges:
                    assert r["knn"]["runs"][merge]["digest"] == want_knn[merge], merge
            paths["mp_nccl"] = {
                "cards": MP_PROCESSES, "backend": "nccl", "wall_s": nwall,
                "ms": {mg: [r["knn"]["runs"][mg]["ms"] for r in nreports] for mg in merges},
                "launches": {name: sum(r["knn"]["launches"].get(name, 0) for r in nreports)
                             for name in ctx.wrappers}}
            print("mp_nccl: %s" % json.dumps(paths["mp_nccl"]), flush=True)
        else:
            print("mp_nccl: not run: this machine shows %d card(s), and NCCL needs a card for "
                  "each of the %d processes (two processes on one card is a duplicate GPU)"
                  % (cards, MP_PROCESSES), flush=True)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return paths


def http_json(url, body=None, timeout=30.0):
    """(status, parsed body) of a GET (``body`` None) or a JSON POST; a
    status of 400 or more is returned, not raised."""
    import urllib.error
    import urllib.request

    data = None if body is None else json.dumps(body).encode("utf-8")
    req = urllib.request.Request(url, data=data, method="GET" if body is None else "POST",
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            code, raw = resp.status, resp.read().decode("utf-8")
    except urllib.error.HTTPError as e:
        code, raw = e.code, e.read().decode("utf-8")
    try:
        return code, json.loads(raw)
    except ValueError:
        return code, raw


def fleet_traffic(router, blocks, n_threads, stop, records, tenant=None):
    """``n_threads`` clients, each sending ``blocks`` in turn to
    ``router.search`` until ``stop`` is set and appending (end time,
    rows, latency ms, outcome) to ``records``: outcome ``"ok"``,
    ``"degraded"`` (a partial answer) or the error's class name.  The
    threads are daemons: the caller sets ``stop`` and joins them in a
    ``finally``."""
    def client(t):
        i = t
        while not stop.is_set():
            b = blocks[i % len(blocks)]
            t0 = time.perf_counter()
            try:
                out = router.search(b, tenant=tenant, timeout_s=30.0)
                outcome = "degraded" if out["degraded"] else "ok"
            except Exception as e:  # noqa: BLE001 — counted: the fleet's errors
                outcome = type(e).__name__
            t1 = time.perf_counter()
            records.append((t1, len(b), (t1 - t0) * 1e3, outcome))
            i += n_threads

    threads = [threading.Thread(target=client, args=(t,), daemon=True) for t in range(n_threads)]
    for th in threads:
        th.start()
    return threads


def stop_threads(stop, threads, timeout=120.0):
    stop.set()
    for th in threads:
        th.join(timeout)
    assert not any(th.is_alive() for th in threads), "a client thread did not stop"


def window_stats(records, t0, t1):
    """Rows/s of the answered requests, p50/p99 ms and the outcome
    counts of the requests that ended in [t0, t1)."""
    sel = [r for r in records if t0 <= r[0] < t1]
    lat = sorted(r[2] for r in sel)
    outcomes = {}
    for r in sel:
        outcomes[r[3]] = outcomes.get(r[3], 0) + 1
    answered = sum(r[1] for r in sel if r[3] in ("ok", "degraded"))
    return {"rows_per_s": answered / (t1 - t0), "window_s": t1 - t0,
            "p50_ms": quantile(lat, 0.5) if lat else None,
            "p99_ms": quantile(lat, 0.99) if lat else None,
            "requests": len(sel), "outcomes": outcomes,
            "errors": sum(n for k, n in outcomes.items() if k not in ("ok", "degraded"))}


def wait_for(cond, timeout, what):
    """Poll ``cond`` every 50 ms; the seconds it took, or raise."""
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < timeout:
        if cond():
            return time.perf_counter() - t0
        time.sleep(0.05)
    raise TimeoutError("fleet: %s within %.0f s" % (what, timeout))


def search_in_requests(router, rows):
    """``router.search`` of ``rows`` (a list of lists) in requests of
    ``FLEET_ROWS_A_REQ``: (distances, ids), row-major lists."""
    d, i = [], []
    for at in range(0, len(rows), FLEET_ROWS_A_REQ):
        out = router.search(rows[at:at + FLEET_ROWS_A_REQ], timeout_s=60.0)
        assert not out["degraded"], "fleet: a partial answer on a healthy fleet"
        d += out["distances"]
        i += out["ids"]
    return d, i


def scrape_worker(ops_url, service, built=True):
    """The worker's ops plane, every read endpoint: each answers, and the
    inventory holds K2 and K3 (and K4, where the worker ``built`` its
    index rather than restoring it) with their counts.  Returns (the
    inventory's per-kernel summary, the kernel build counts)."""
    code, text = http_json(ops_url + "/metrics")
    assert code == 200 and "raft_tpu_serve_requests_total" in text, ("worker /metrics", code)
    code, body = http_json(ops_url + "/healthz")
    assert code == 200 and body["ok"] and body["services"][service]["worker_alive"], body
    code, body = http_json(ops_url + "/statusz")
    assert code == 200 and service in body["services"] and body["tuning_table"] is None, code
    code, body = http_json(ops_url + "/debug/config")
    assert code == 200 and body["knobs"]["fleet_lease_interval_s"]["layer"], code
    code, inv = http_json(ops_url + "/debug/inventory")
    assert code == 200, code
    for kernel in ("select_tile", "ivf_tile") + (("nn_tile",) if built else ()):
        entries = inv["detail"].get(kernel, {}).values()
        assert entries, "worker inventory lacks %s" % kernel
        for e in entries:
            assert e["flops"] > 0 and e["bytes_accessed"] > 0 and e["hbm_bytes"] > 0 \
                and e["launches"] > 0, (kernel, e)
    code, snap = http_json(ops_url + "/debug/snapshot")
    assert code == 200 and set(snap) >= {"metrics", "kernel_builds", "flight", "inventory"}
    return inv["summary"]["per_fn"], snap["kernel_builds"]


def request_breakdown(router, pool, data_url, ops_url, n=20):
    """Where a request's time goes: the median ms of ``n`` requests sent
    one at a time through the router and straight to the worker, beside
    the worker's serve timers over everything it served so far (a
    request's wait for its batch, a batch's device call, a batch's
    rows)."""
    out = {}
    for how in ("router", "direct"):
        lat = []
        for i in range(n):
            t0 = time.perf_counter()
            if how == "router":
                router.search(pool[i % len(pool)], timeout_s=60.0)
            else:
                code, _ = http_json(data_url + "/search", {"vectors": pool[i % len(pool)]})
                assert code == 200, code
            lat.append((time.perf_counter() - t0) * 1e3)
        out["sequential_%s_ms" % how] = statistics.median(lat)
    metrics = http_json(ops_url + "/debug/snapshot")[1]["metrics"]
    for name, key, scale in (("raft_tpu_serve_wait_seconds", "wait_ms_a_request", 1e3),
                             ("raft_tpu_serve_exec_seconds", "exec_ms_a_batch", 1e3),
                             ("raft_tpu_serve_batch_rows", "rows_a_batch", 1.0)):
        series = metrics[name]["series"]
        count = sum(x["count"] for x in series)
        out[key] = scale * sum(x["total"] for x in series) / count
        out[name[len("raft_tpu_serve_"):] + "_count"] = count
    return out


def profiled_window(router, pool, data_url):
    """The device's idle share in a worker under the load's traffic: a
    ``torch.profiler`` window of 2 s (its kernels only) taken inside a
    window of its own, after every gate, since tracing slows the worker
    it traces.  Returns the profile beside that window's rows/s."""
    records, stop = [], threading.Event()
    t0 = time.perf_counter()
    threads = fleet_traffic(router, pool, FLEET_THREADS, stop, records)
    try:
        time.sleep(0.5)
        code, prof = http_json(data_url + "/debug/profile", {"seconds": 2.0}, timeout=120)
        time.sleep(0.5)
    finally:
        stop_threads(stop, threads)
    assert code == 200 and 0.0 <= prof["device_idle_share"] <= 1.0, (code, prof)
    prof["window_rows_per_s"] = window_stats(records, t0, time.perf_counter())["rows_per_s"]
    return prof


def worker_launches(per_fn, wrappers):
    return {name: int(per_fn.get(name, {}).get("launches", 0)) for name in wrappers}


def fleet_paths(ctx, m):
    """The fleet on the card (queue 1 item 7): ``fleet_ann_1M`` (a fleet
    of one worker holding the 1M index, then of two holding 500,000 rows
    each, both on ``cuda:0``; the chaos arm on the two), and
    ``fleet_replicated_200k`` (hedged dispatch).  The router runs in this
    process, each worker in its own (``python -m
    raft_tpu_torch.fleet.worker``); the kernels' launches are read from
    the workers' inventories.  Fleets run in ``with`` blocks and no
    worker outlives its fleet."""
    import shutil

    dev, wrappers = ctx.dev, ctx.wrappers
    base = ROOT / "build" / "fleet"
    shutil.rmtree(base, ignore_errors=True)
    paths = {}
    full = m.synth(FLEET_ROWS, DIM, FLEET_SEED, FLEET_CLUSTERS)
    rng = np.random.default_rng(9)

    def near_rows(n):
        picks = rng.integers(0, FLEET_ROWS, n)
        return (full[picks] + SHARDED_NOISE * rng.standard_normal((n, DIM))).astype(np.float32)

    # the exact top-100 of 256 queries near the data, by K1 on the same
    # regenerated rows (the ground truth: not the fleet's path)
    queries = near_rows(FLEET_RECALL_Q)
    ctx.reset()
    X = torch.from_numpy(full).to(dev)
    _, gt_ids = m.fused_knn_tile(X, torch.from_numpy(queries).to(dev), K)
    gt_ids = gt_ids.cpu().numpy()
    gt_launches = ctx.counts()["knn_tile"]
    del X
    torch.cuda.empty_cache()
    q_rows = queries.tolist()
    pool = [near_rows(FLEET_ROWS_A_REQ).tolist() for _ in range(SHARDED_POOL)]
    fixed = [near_rows(FLEET_ROWS_A_REQ).tolist() for _ in range(4)]
    out = {"rows": FLEET_ROWS, "dim": DIM, "k": K, "nlist_a_shard": FLEET_NLIST,
           "nprobe": FLEET_NPROBE, "threads": FLEET_THREADS, "rows_a_request": FLEET_ROWS_A_REQ,
           "ground_truth_k1_launches": gt_launches, "fleets": {}}
    launches = dict.fromkeys(wrappers, 0)
    try:
        for n in (1, 2):
            t0 = time.perf_counter()
            with m.Fleet(n, root=str(base / ("ann%d" % n)), index_rows=FLEET_ROWS, dim=DIM, k=K,
                         seed=FLEET_SEED, clusters=FLEET_CLUSTERS, nlist=FLEET_NLIST,
                         nprobe=FLEET_NPROBE, persist_fsync="always",
                         snapshot_interval_s=FLEET_SNAPSHOT_S,
                         service_opts=FLEET_SERVICE_OPTS, device="cuda") as f:
                f.wait_ready(timeout=FLEET_READY_S)
                res = {"ready_s": time.perf_counter() - t0}
                router = f.router
                reg = router.registry()
                ops = {w: "http://127.0.0.1:%d" % p["ops_port"] for w, p in reg.items()}
                data_urls = {w: "http://127.0.0.1:%d" % p["data_port"] for w, p in reg.items()}
                builds_ready = {w: http_json(u + "/debug/snapshot")[1]["kernel_builds"]
                                for w, u in ops.items()}
                assert all(b["builds"] == 0 for b in builds_ready.values()), (
                    "a worker built a kernel: the supervisor builds them", builds_ready)

                # the load: 8 clients, 16-row requests, 5 s
                records, stop = [], threading.Event()
                t_load = time.perf_counter()
                threads = fleet_traffic(router, pool, FLEET_THREADS, stop, records)
                try:
                    time.sleep(FLEET_SECONDS)
                finally:
                    stop_threads(stop, threads)
                res["load"] = window_stats(records, t_load, t_load + FLEET_SECONDS)
                load = res["load"]
                assert load["errors"] == 0 and not load["outcomes"].get("degraded"), load

                # recall@100 against K1's exact top-100
                _, ids = search_in_requests(router, q_rows)
                hits = sum(len(set(a) & set(b.tolist())) for a, b in zip(ids, gt_ids))
                res["recall_at_100"] = hits / (FLEET_RECALL_Q * K)
                assert res["recall_at_100"] >= 0.9, res["recall_at_100"]

                # the router's merge: its answer to each fixed request equals
                # the merge of each worker's own /search answer, bit for bit
                for block in fixed:
                    got = router.search(block, timeout_s=60.0)
                    parts = []
                    for w in sorted(data_urls):
                        code, rep = http_json(data_urls[w] + "/search", {"vectors": block})
                        assert code == 200, (w, code, rep)
                        parts.append((rep["distances"], rep["ids"]))
                    want = m.protocol.merge_topk(parts, K)
                    assert (got["distances"], got["ids"]) == want, "fleet: the router's merge"
                res["merge_check_requests"] = len(fixed)
                res["w0_breakdown"] = request_breakdown(router, pool, data_urls["w0"],
                                                        ops["w0"])

                # the ops plane: every endpoint of each worker, no kernel
                # built or loaded after warmup; the router's scrape surface
                per_worker = {}
                for w, u in sorted(ops.items()):
                    per_fn, builds = scrape_worker(u, "ann_%s" % w)
                    assert builds == builds_ready[w], ("kernel build or load after warmup",
                                                       w, builds_ready[w], builds)
                    per_worker[w] = worker_launches(per_fn, wrappers)
                res["worker_launches"] = per_worker
                for path in ("/metrics", "/healthz", "/fleet/statusz", "/debug/snapshot"):
                    code, body = http_json(router.url + path)
                    assert code == 200, (path, code)
                assert 'worker="w%d"' % (n - 1) in http_json(router.url + "/metrics")[1]
                if n == 2:
                    res["chaos"] = chaos_arm(f, m, pool, fixed)
                    # the launches of the whole run: w0's, the killed w1's
                    # (read above) and the restarted w1's
                    w1_ops = "http://127.0.0.1:%d" % router.registry()["w1"]["ops_port"]
                    per_worker["w1_restarted"] = worker_launches(
                        scrape_worker(w1_ops, "ann_w1", built=False)[0], wrappers)
                    per_worker["w0"] = worker_launches(
                        scrape_worker(ops["w0"], "ann_w0")[0], wrappers)
                res["w0_profile"] = profiled_window(router, pool, data_urls["w0"])
                for counts in per_worker.values():
                    for name in wrappers:
                        launches[name] += counts[name]
                for name in ("select_tile", "ivf_tile", "nn_tile"):
                    assert sum(c[name] for c in per_worker.values()) > 0, (n, name)
                res["workers"] = n
                out["fleets"]["workers_%d" % n] = res
                wids = sorted(reg)
            assert not any(f.proc_alive(w) for w in wids), "a worker outlived its fleet"
            print("fleet_ann_1M, %d worker(s): %s" % (n, json.dumps(res)), flush=True)
        out["launches"] = launches
        paths["fleet_ann_1M"] = out
        paths["fleet_replicated_200k"] = replicated_path(m, base / "repl", wrappers)
    finally:
        shutil.rmtree(base, ignore_errors=True)
    return paths


def chaos_arm(f, m, pool, fixed):
    """The JAX serve_fleet rung's drill on the two-worker fleet: query
    traffic and 8-row WAL-acked inserts while w1 takes a SIGKILL; its
    restart restores from snapshot + WAL and rejoins.  Gates: the fleet
    reads degraded during the outage and healthy after the rejoin (the
    router's sentinel trips ``worker_dead`` and clears), every acked id
    answers at distance 0 (within the expanded form's rounding) under its
    own id, every admitted request has exactly one terminal flight event
    at the router, and the fixed requests' answers are bitwise equal
    before the kill and after the rejoin."""
    import signal

    router = f.router
    rec = m.flight.default_recorder()
    rec.clear()
    rng = np.random.default_rng(23)
    acked, lock, ins_stop = {}, threading.Lock(), threading.Event()
    ins_errors = []

    def inserter():
        # N(0, 1) rows: far from the mixture's clusters, so no fixed
        # query's top 100 changes; ids above the base rows
        for n in range(CHAOS_MAX_INSERTS):
            if ins_stop.is_set():
                return
            ids = list(range(FLEET_ROWS + n * CHAOS_INSERT_ROWS,
                             FLEET_ROWS + (n + 1) * CHAOS_INSERT_ROWS))
            vecs = rng.standard_normal((CHAOS_INSERT_ROWS, DIM)).astype(np.float32)
            try:
                rep = router.insert(ids, vecs.tolist(), timeout_s=5.0)
            except Exception as e:  # noqa: BLE001 — an unacked batch is the outcome
                ins_errors.append(type(e).__name__)
                continue
            with lock:
                for i, v in zip(ids, vecs):
                    if i in set(rep["acked_ids"]):
                        acked[i] = v
            time.sleep(0.005)

    # the fixed requests alone, before any traffic and after it all
    before = [router.search(b, timeout_s=60.0) for b in fixed]
    records, stop = [], threading.Event()
    res = {}
    threads = fleet_traffic(router, pool, CHAOS_QUERY_THREADS, stop, records)
    th_ins = threading.Thread(target=inserter, daemon=True)
    th_ins.start()
    try:
        t_start = time.perf_counter()
        time.sleep(CHAOS_BEFORE_S)
        gen_before = router.registry()["w1"]["generation"]
        t_kill = time.perf_counter()
        f.kill("w1", signal.SIGKILL)
        res["to_degraded_s"] = wait_for(lambda: router.fleet_health()[1]["degraded"], 30.0,
                                        "/fleet/healthz degraded after the kill")
        code, body = http_json(router.url + "/fleet/healthz")
        assert body["degraded"] and body["ok"], ("degraded, still serving", code, body)

        def tripped():
            router.sentinel.tick(force=True)
            return any(a["rule"] == "worker_dead" for a in router.sentinel.active())

        res["sentinel_worker_dead_s"] = wait_for(tripped, 30.0, "worker_dead trips")
        time.sleep(CHAOS_OUTAGE_S)       # ingestion against the survivor
        t_restart = time.perf_counter()
        f.restart("w1")
        res["rejoin_s"] = wait_for(
            lambda: router.registry()["w1"]["state"] == "active"
            and router.registry()["w1"]["generation"] > gen_before, FLEET_READY_S, "w1 rejoins")

        def healed():
            router.sentinel.tick(force=True)
            return (not router.fleet_health()[1]["degraded"]
                    and not any(a["rule"] == "worker_dead" for a in router.sentinel.active()))

        res["to_healthy_after_rejoin_s"] = wait_for(healed, 60.0, "the fleet heals")
        t_healed = time.perf_counter()
        code, body = http_json(router.url + "/fleet/healthz")
        assert code == 200 and body["ok"] and not body["degraded"], ("healed", code, body)
        time.sleep(CHAOS_AFTER_S)
        t_end = time.perf_counter()
    finally:
        ins_stop.set()
        stop_threads(stop, threads)
        th_ins.join(120)
    assert not th_ins.is_alive(), "the inserter did not stop"
    res["before"] = window_stats(records, t_start + 0.5, t_kill)
    res["outage"] = window_stats(records, t_kill, t_healed)
    res["after"] = window_stats(records, t_healed, t_end)
    assert res["before"]["errors"] == 0 and res["after"]["errors"] == 0, res
    res["restart_to_healthy_s"] = t_healed - t_restart
    w1 = router.registry()["w1"]
    code, info = http_json("http://127.0.0.1:%d/info" % w1["data_port"])
    assert code == 200 and info["restore"]["restored"], info
    res["restore"] = info["restore"]
    res["insert_batches_acked"] = len(acked) // CHAOS_INSERT_ROWS
    res["insert_errors"] = len(ins_errors)
    res["rows_acked"] = len(acked)
    assert acked, "the drill needs acked inserts"

    # every acked id answers from the healed fleet at distance 0 under
    # its own id: 1e-5 of |x|^2, the expanded form's float32 rounding
    items = sorted(acked.items())
    d, ids = search_in_requests(router, [v.tolist() for _, v in items])
    for (i, v), drow, irow in zip(items, d, ids):
        assert irow[0] == i, ("acked row lost or not first", i, irow[:3])
        assert 0.0 <= drow[0] <= 1e-5 * max(1.0, float((v.astype(np.float64) ** 2).sum())), (
            i, drow[0])
    # exactly one terminal flight event for every admitted request
    admitted = [e.attrs["rid"] for e in rec.events(kind="fleet_admitted")]
    terminals = {}
    for kind in ("fleet_resolved", "fleet_failed", "fleet_expired"):
        for e in rec.events(kind=kind):
            terminals[e.attrs["rid"]] = terminals.get(e.attrs["rid"], 0) + 1
    assert len(rec) < rec.capacity, "the flight ring wrapped: raise flight_events"
    bad = [rid for rid in admitted if terminals.get(rid, 0) != 1]
    assert admitted and not bad, ("requests without exactly one terminal", bad[:5])
    res["admitted_requests"] = len(admitted)
    # the fixed requests: bitwise equal before the kill and after the rejoin
    # (the inserted rows lie far from every fixed query's top 100)
    after = [router.search(b, timeout_s=60.0) for b in fixed]
    for a, b in zip(before, after):
        assert not a["degraded"] and not b["degraded"]
        assert a["ids"] == b["ids"] and a["distances"] == b["distances"], (
            "fixed answers differ across the kill")
    res["fixed_requests_equal"] = len(fixed)
    return res


def replicated_path(m, root, wrappers):
    """``fleet_replicated_200k``: two workers each holding the whole
    200,000-row index, queries placed by rendezvous on their tenant; the
    primary of one tenant hangs (``/chaos``) for less than the lease, so
    only the hedges (after ``REPL_HEDGE_MS``) answer in time."""
    res = {"rows": REPL_ROWS, "nlist": REPL_NLIST, "hedge_ms": REPL_HEDGE_MS,
           "hang_s": REPL_HANG_S}
    data = m.synth(REPL_ROWS, DIM, FLEET_SEED, FLEET_CLUSTERS)
    picks = list(range(0, REPL_ROWS, REPL_ROWS // 64))[:64]
    router = m.Router(mode="replicated", shard_count=1, hedge_ms=REPL_HEDGE_MS, timeout_s=10.0)
    t0 = time.perf_counter()
    with m.Fleet(2, root=str(root), index_rows=REPL_ROWS, dim=DIM, k=K, mode="replicated",
                 seed=FLEET_SEED, clusters=FLEET_CLUSTERS, nlist=REPL_NLIST, nprobe=FLEET_NPROBE,
                 persist=False, service_opts=FLEET_SERVICE_OPTS, router=router,
                 device="cuda") as f:
        f.wait_ready(timeout=FLEET_READY_S)
        res["ready_s"] = time.perf_counter() - t0
        tenant = "hedged"
        primary = m.protocol.rendezvous_rank(tenant, router.active_workers())[0]
        reg = router.registry()
        hedges0 = m.default_registry().family_total("raft_tpu_fleet_hedges_total")
        wins0 = m.default_registry().family_total("raft_tpu_fleet_hedge_wins_total")
        code, _ = http_json("http://127.0.0.1:%d/chaos" % reg[primary]["data_port"],
                            {"fault": "hang", "duration_s": REPL_HANG_S})
        assert code == 200, code
        answers, errors = [], []

        def client(rows):
            try:
                answers.append((rows, router.search([data[r].tolist() for r in rows],
                                                    tenant=tenant, timeout_s=8.0)))
            except Exception as e:  # noqa: BLE001 — re-raised below
                errors.append(e)

        t_hang = time.perf_counter()
        threads = [threading.Thread(target=client, args=(picks[i:i + 8],), daemon=True)
                   for i in range(0, len(picks), 8)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(60)
        res["answered_s"] = time.perf_counter() - t_hang
        assert not errors and len(answers) == len(threads), errors
        for rows, out in answers:
            assert [r[0] for r in out["ids"]] == rows, "a hedged answer is wrong"
        res["requests"] = len(answers)
        res["hedged_answers"] = sum(1 for _, out in answers if out["hedged"])
        reg_now = m.default_registry()
        res["hedges"] = reg_now.family_total("raft_tpu_fleet_hedges_total") - hedges0
        res["hedge_wins"] = reg_now.family_total("raft_tpu_fleet_hedge_wins_total") - wins0
        assert res["hedges"] >= 1 and res["hedge_wins"] >= 1, res
        time.sleep(REPL_HANG_S + 0.5)      # the hang expires before teardown
        per_worker = {}
        for w, p in sorted(router.registry().items()):
            per_fn, _ = scrape_worker("http://127.0.0.1:%d" % p["ops_port"], "ann_%s" % w)
            per_worker[w] = worker_launches(per_fn, wrappers)
        res["worker_launches"] = per_worker
        wids = sorted(reg)
    assert not any(f.proc_alive(w) for w in wids), "a worker outlived its fleet"
    res["launches"] = {name: sum(c[name] for c in per_worker.values()) for name in wrappers}
    print("fleet_replicated_200k: %s" % json.dumps(res), flush=True)
    return res


# the load generator's scenarios (queue 1 item 9): tools/torch_loadgen.py's
# run_* functions on this script's data, a window of LG_SECONDS each, 16-row
# requests (the serving paths' size) from 4 closed-loop threads; the chaos
# arm's seeds and fault rates are the JAX tool's defaults; a sharded world of
# 4 slots for the shard kill, 2 replicas at the replicas' fixed hedge for the
# straggler; the JAX tool's tenant defaults; the ops plane scraped through
# two windows of 8 threads; the fleet cut to 200,000 rows, as
# fleet_replicated_200k is, for the workers' spawn and rejoin time, with a
# schedule (FLEET_SEED's) that kills and restarts a worker
LG_SECONDS, LG_ROWS, LG_THREADS, LG_POOL = 4.0, 16, 4, 16
LG_RUNGS = (8, 32, 64, 128)
LG_CHAOS_SEEDS, LG_TRANSIENT_P, LG_OUTAGE_AT, LG_OUTAGE_S = (0, 1), 0.05, 0.35, 0.8
LG_WORLD, LG_REPLICAS = 4, 2
LG_TENANT_WEIGHTS, LG_BULK_QPS, LG_BULK_ROWS = "interactive:4,bulk:1", 300.0, 32
LG_OOC_THREADS, LG_SCRAPE_THREADS = 3, 8
LG_FLEET_ROWS, LG_FLEET_SECONDS, LG_FLEET_INSERT_ROWS = 200_000, 6.0, 8
LG_SHOWN = ("knn_tile", "select_tile", "ivf_tile")


def lg_window(t):
    """Rows/s, p50 and p99 ms of a scenario's answered requests (its
    ``timings``)."""
    lat = sorted(x * 1e3 for x in t["latencies_s"])
    return {"rows_per_s": t["rows"] / t["window_s"] if t["window_s"] else 0.0,
            "p50_ms": quantile(lat, 0.5) if lat else None,
            "p99_ms": quantile(lat, 0.99) if lat else None, "answered": len(lat)}


def loadgen_paths(ctx, m):
    """The load generator's scenarios on the card (queue 1 item 9):
    ``tools/torch_loadgen.py``'s ``run_*`` functions in this process over
    the script's 1M x 128 index (``KNNService`` arms) and its 1M IVF-Flat
    index at the nprobe ``serve_ann_1M`` calibrated (``ANNService`` arms),
    then the report tools (queue 1 item 10) on what they left.  Each path
    prints rows/s, p50 and p99, the scenario's invariants and its ``ok``,
    recovery or restore seconds, and K1, K2 and K3 launches; any failed
    invariant raises.  Persist directories, the fleet's root and the dumps
    live under ``build/loadgen/``, removed after."""
    import contextlib
    import io
    import shutil

    lg, dev, wrappers = m.lg, ctx.dev, ctx.wrappers
    base = ROOT / "build" / "loadgen"
    shutil.rmtree(base, ignore_errors=True)
    base.mkdir(parents=True)
    paths = {}
    knn_opts = dict(max_batch_rows=LG_RUNGS[-1], bucket_rungs=LG_RUNGS, max_wait_ms=1.0,
                    device=dev)
    ann_opts = dict(knn_opts, nprobe=ctx.nprobe, nprobe_ladder=ANN_LADDER)
    knn_pool = lg.make_query_pool(ctx.index, LG_ROWS, n=LG_POOL, seed=1)
    ann_pool = lg.make_query_pool(ctx.X, LG_ROWS, n=LG_POOL, seed=2)
    rec = m.flight.default_recorder()
    dump = base / ("chaos_seed%d.json" % LG_CHAOS_SEEDS[0])

    def done(name, res, launches=None):
        res["launches"] = ctx.counts(name) if launches is None else launches
        res["k1_k2_k3_launches"] = {w: res["launches"][w] for w in LG_SHOWN}
        paths[name] = res
        print("%s: %s" % (name, json.dumps(res, default=str)), flush=True)

    def serve(svc, scenario, **kw):
        """Warm ``svc``, run ``scenario`` on it and close it; (report,
        timings, kernel libraries built or loaded after the warmup)."""
        t = {}
        try:
            svc.warmup()
            rep = scenario(svc, timings=t, **kw)
            built = svc.kernel_libraries_after_warmup()
        finally:
            svc.close()
        assert built == {"builds": 0, "loads": 0}, ("a kernel built after warmup", built)
        return rep, t

    try:
        # the serve-seam chaos: transient faults, an outage, recovery
        ctx.reset()
        res = {"seeds": {}}
        for seed in LG_CHAOS_SEEDS:
            if seed == LG_CHAOS_SEEDS[0]:
                rec.clear()          # the dump holds this run alone
            svc = m.KNNService(ctx.index, K, name="lg_chaos%d" % seed, **knn_opts)
            rep, t = serve(svc, lg.run_chaos, duration=LG_SECONDS, concurrency=LG_THREADS,
                           seed=seed, transient_p=LG_TRANSIENT_P, outage_at=LG_OUTAGE_AT,
                           outage_s=LG_OUTAGE_S, query_pool=knn_pool,
                           manager=m.RecoveryManager(services=[svc]))
            if seed == LG_CHAOS_SEEDS[0]:
                rec.dump_to(str(dump))
            assert rep["chaos_ok"] and rep["exactly_once"] and rep["typed_only"], rep
            assert rep["breaker_trips"] >= 1 and rep["recoveries"] == 1, rep
            res["seeds"][seed] = dict(rep, recovery_s=t["recovery_s"], **lg_window(t))
        done("loadgen_chaos_1M", res)

        # the shard kill: a world of 4 slots loses its last one mid-run
        ctx.reset()
        svc = m.KNNService(ctx.index, K, mesh=lg.world_mesh(LG_WORLD, dev), axis="ranks",
                           name="lg_kill_shard", **knn_opts)
        rep, t = serve(svc, lg.run_chaos, duration=LG_SECONDS, concurrency=LG_THREADS, seed=0,
                       transient_p=LG_TRANSIENT_P, outage_at=LG_OUTAGE_AT, outage_s=LG_OUTAGE_S,
                       query_pool=knn_pool, manager=m.RecoveryManager(services=[svc]),
                       kill_shard=True)
        assert rep["chaos_ok"] and rep["shard_devices"] == LG_WORLD - 1, rep
        assert rep["post_recovery_exact"] is True, rep
        done("loadgen_kill_shard_1M", dict(rep, recovery_s=t["recovery_s"], **lg_window(t)))

        # the hedge chaos: replica 0 straggles, hedges to replica 1 win
        ctx.reset()
        svc = m.KNNService(ctx.index, K, mesh=lg.world_mesh(LG_REPLICAS, dev), axis="ranks",
                           replicas=LG_REPLICAS, hedge_ms=REPLICA_HEDGE_MS, name="lg_hedge",
                           **knn_opts)
        rep, t = serve(svc, lg.run_hedge_chaos, duration=LG_SECONDS, concurrency=LG_THREADS,
                       rows=LG_ROWS, seed=0, query_pool=knn_pool)
        assert rep["chaos_ok"] and rep["hedge_wins"] > 0, rep
        done("loadgen_hedge_chaos_1M", dict(rep, hedge_ms=REPLICA_HEDGE_MS, **lg_window(t)))

        # the mixed tenants: interactive clients beside a bulk flood
        ctx.reset()
        svc = m.KNNService(ctx.index, K, tenant_weights=LG_TENANT_WEIGHTS, name="lg_tenants",
                           **knn_opts)
        try:
            svc.warmup()
            rep = lg.run_mixed_tenants(svc, duration=LG_SECONDS,
                                       interactive_concurrency=LG_THREADS,
                                       bulk_qps=LG_BULK_QPS, interactive_rows=LG_ROWS,
                                       bulk_rows=LG_BULK_ROWS, seed=0)
        finally:
            svc.close()
        assert rep["untyped_sheds"] == 0 and rep["post_warmup_compiles"] == 0, rep
        assert rep["tenants"]["interactive"]["requests_ok"] > 0, rep
        tenant_rows = {"interactive": LG_ROWS, "bulk": LG_BULK_ROWS}
        rep["rows_per_s"] = sum(rep["tenants"][tn]["qps"] * r for tn, r in tenant_rows.items())
        done("loadgen_tenants_1M", rep)

        # the out-of-core tier under chaos, a quarter of the store resident
        ctx.reset()
        store = int(ctx.ivf.slot_vecs.numel() * ctx.ivf.slot_vecs.element_size())
        svc = m.ANNService(ctx.ivf, K, ooc=True, device_budget_bytes=store // 4,
                           name="lg_ooc", **ann_opts)
        rep, t = serve(svc, lg.run_chaos, duration=LG_SECONDS, concurrency=LG_OOC_THREADS,
                       seed=0, transient_p=LG_TRANSIENT_P, outage_at=LG_OUTAGE_AT,
                       outage_s=LG_OUTAGE_S, query_pool=ann_pool,
                       manager=m.RecoveryManager(services=[svc]))
        assert rep["chaos_ok"] and rep["exactly_once"], rep
        del svc
        torch.cuda.empty_cache()
        done("loadgen_ooc_chaos_1M", dict(rep, recovery_s=t["recovery_s"],
                                          device_budget_bytes=store // 4, **lg_window(t)))

        # the crash and restart of a persistent ANNService
        ctx.reset()
        t = {}
        rep = lg.run_crash_restart(str(base / "persist"), k=K, seed=0, duration=LG_SECONDS,
                                   concurrency=LG_OOC_THREADS, rows=LG_ROWS, nlist=NLIST,
                                   insert_rows=8, device=dev, train_rows=TRAIN_ROWS,
                                   data=ctx.X, timings=t,
                                   svc_opts=dict(nprobe=ctx.nprobe, nprobe_ladder=ANN_LADDER))
        assert rep["crash_ok"], rep
        shutil.rmtree(base / "persist", ignore_errors=True)
        torch.cuda.empty_cache()
        done("loadgen_crash_restart_1M", dict(rep, warmup_s=t["warmup_s"], **lg_window(t)))

        # the ops plane scraped at 1 Hz through the second of two windows
        ctx.reset()
        t = {}
        svc = m.ANNService(ctx.ivf, K, name="lg_ops", **ann_opts)
        try:
            svc.warmup()
            rep = lg.run_ops_scrape(svc, port=0, duration=2 * LG_SECONDS,
                                    concurrency=LG_SCRAPE_THREADS, rows=LG_ROWS,
                                    query_pool=ann_pool, timings=t)
        finally:
            svc.close()
        assert rep["ops_ok"], rep
        for arm in ("baseline", "scraped"):
            rep[arm] = {key: t[arm][key] for key in ("query_qps", "p50_ms", "p99_ms")}
        rep["rows_per_s"] = t["scraped"]["query_qps"]
        done("loadgen_ops_scrape_1M", rep)

        # the fleet drill: a router here, two sharded workers on the card
        ctx.reset()
        seen = {}

        def inspect(f):
            # a request through the healed fleet and its joined trace, and
            # the live workers' launches from their inventories
            q = np.random.default_rng(3).standard_normal((LG_ROWS, DIM)).astype(np.float32)
            out = f.router.search(q.tolist(), timeout_s=60.0)
            code, joined = f.router.fleet_trace(out["request_id"])
            assert code == 200, (code, joined)
            seen["joined"] = joined
            seen["workers"] = {}
            for w, p in sorted(f.router.registry().items()):
                code, inv = http_json("http://127.0.0.1:%d/debug/inventory" % p["ops_port"])
                assert code == 200, code
                seen["workers"][w] = worker_launches(inv["summary"]["per_fn"], wrappers)

        rep = lg.run_fleet(str(base / "fleet"), n_workers=2, index_rows=LG_FLEET_ROWS, dim=DIM,
                           k=K, seed=FLEET_SEED, duration=LG_FLEET_SECONDS,
                           concurrency=LG_THREADS, rows=LG_ROWS, nlist=REPL_NLIST,
                           clusters=FLEET_CLUSTERS, insert_rows=LG_FLEET_INSERT_ROWS,
                           device=dev.type, service_opts=FLEET_SERVICE_OPTS, inspect=inspect)
        assert rep["fleet_ok"], rep
        assert "kill" in rep["chaos_applied"] and rep["rejoins"] >= 1, rep
        launches = {w: sum(c[w] for c in seen["workers"].values()) for w in wrappers}
        assert launches["ivf_tile"] > 0 and launches["select_tile"] > 0, seen["workers"]
        done("loadgen_fleet_200k", dict(rep, rows_per_s=rep["query_qps"],
                                        worker_launches=seen["workers"]), launches)

        # the report tools: the chaos arm's dump and the fleet's join through
        # torch_trace_report, this process's snapshot through
        # torch_metrics_report
        out = {}

        def run_tool(tool, argv):
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                rc = tool.main(argv)
            assert rc == 0, (argv, rc)
            return buf.getvalue()

        summary = run_tool(m.tr, [str(dump)])
        events = m.tr.load_events(json.loads(dump.read_text()))
        ids = m.tr.trace_ids(events)
        assert ids and "failed" in summary and "recovery_begin" in summary, summary[-2000:]
        wf = run_tool(m.tr, [str(dump), "--trace-id", str(ids[0])])
        chrome = base / "chaos_chrome.json"
        run_tool(m.tr, [str(dump), "--chrome", str(chrome)])
        joined = seen["joined"]
        assert joined["problems"] == [], joined["problems"]
        join_path = base / "fleet_join.json"
        join_path.write_text(json.dumps(joined))
        fleet_wf = run_tool(m.tr, [str(join_path)])
        assert "hop tiling" in fleet_wf and "!!" not in fleet_wf, fleet_wf
        snap_path = base / "snapshot.json"
        snap_path.write_text(json.dumps(m.metrics_snapshot(), default=str))
        report = run_tool(m.mr, [str(snap_path)])
        sections, head = {}, None
        for line in report.splitlines():
            if line.startswith("== "):
                head = line
                sections[head] = 0
            elif head is not None:
                sections[head] += 1
        for want in ("== serving", "== kernel inventory", "== SLO burn", "== timers"):
            assert any(h.startswith(want) for h in sections), (want, list(sections))
        out["trace_report"] = {
            "dump_events": len(events), "traces": len(ids),
            "summary_lines": len(summary.splitlines()), "waterfall_lines": len(wf.splitlines()),
            "chrome_events": len(json.loads(chrome.read_text())["traceEvents"]),
            "fleet_waterfall_lines": len(fleet_wf.splitlines()),
            "fleet_problems": joined["problems"]}
        out["metrics_report"] = {"lines": len(report.splitlines()), "sections": sections}
        paths["reports"] = out
        print("reports: %s" % json.dumps(out), flush=True)
    finally:
        shutil.rmtree(base, ignore_errors=True)
    return paths


# the tuning path: the main path's cell of each tuned knob
TUNING_CELLS = ("select_1M", "bfknn_1M", "twophase_1M", "ivf_search_1M")


def lookups_by_outcome(registry):
    """``{(outcome, knob): count}`` of the table's lookups so far."""
    fam = registry.get("raft_tpu_tuning_table_lookups_total")
    if fam is None:
        return {}
    return {(labels["outcome"], labels["knob"]): s.value for labels, s in fam.series()}


def tuning_path(ctx, m):
    """The tuning half (queue 1 item 7b): the checked-in table of this
    card (or, where no table's fingerprint matches, ``torch_autotune
    --smoke`` swept here, said on a line of its own), installed for this
    path only and cleared after, so every other path measures the
    untuned dispatch.  For the main path's cell of each tuned knob: the
    resolved impl and its rung, the tuned answer against the untuned one
    (bitwise where both routes select exactly or are the same, else
    within the tolerance with id sets equal but for ties),
    ``tuned_vs_default`` and the kernel builds and loads around its timed
    loops; the table's hits, misses and discarded lookups.  Then
    ``specializations.warmup()`` in a fresh process on the build directory
    that the script's first step warmed: no build, its load seconds
    beside the first step's build seconds (``ctx.warmup``)."""
    import importlib.util

    dev, config, tuning = ctx.dev, m.config, m.tuning
    t_path = time.perf_counter()
    spec = importlib.util.spec_from_file_location("torch_autotune",
                                                  ROOT / "tools" / "torch_autotune.py")
    autotune = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(autotune)
    fp = tuning.backend_fingerprint()
    found = config.discover_tuning_table()
    if found is None:
        print("tuning: no checked-in table matches this card's fingerprint %s; sweeping "
              "tools/torch_autotune.py --smoke on it" % json.dumps(fp), flush=True)
        table = autotune.run_sweep(smoke=True, device=dev, log=lambda *a: None)
        source = "torch_autotune --smoke, swept in this run"
    else:
        with open(found) as f:
            table = json.load(f)
        source = str(Path(found).relative_to(ROOT))

    keys = ctx.randn(N_QUERIES, 100_000)
    D = m.D
    calls = {
        "select_1M": ("select_impl", "select_k", {"n": 100_000, "k": K}, "exact",
                      lambda: m.select_k(keys, K, device=dev)),
        "bfknn_1M": ("fused_knn_impl", "fused_l2_knn", {"n": N_INDEX, "k": K}, "tolerance",
                     lambda: m.brute_force_knn(ctx.index, ctx.queries, K, D.L2SqrtExpanded,
                                               device=dev)),
        "twophase_1M": ("knn_block_n", "fused_knn_twophase", {"n": N_INDEX, "k": K, "d": DIM},
                        "tolerance", lambda: m.fused_knn_twophase(ctx.index, ctx.queries, K)),
        "ivf_search_1M": ("ivf_scan_impl", "ivf_flat_search",
                          {"n": int(ctx.ivf.slot_ids.numel()), "k": K, "d": DIM}, "tolerance",
                          lambda: m.ivf_flat_search(ctx.ivf, ctx.ivf_q, K, device=dev)),
    }
    atols = {"bfknn_1M": ctx.l2_atol(ctx.queries, ctx.index),
             "twophase_1M": ctx.l2_atol(ctx.queries, ctx.index),
             "ivf_search_1M": ctx.l2_atol(ctx.ivf_q, ctx.X)}
    # the cells whose answers are square-rooted (the L2Sqrt metrics)
    rooted = ("bfknn_1M", "ivf_search_1M")
    untuned = {name: c[4]() for name, c in calls.items()}
    torch.cuda.synchronize()
    registry = m.default_registry()
    before = lookups_by_outcome(registry)
    ctx.reset()
    out = {"table": source, "fingerprint": fp, "cells": {}}
    assert config.install_tuning_table(table, source=source), "the table did not install"
    try:
        info = config.tuning_table_info()
        out["table_cells"], out["table_knobs"] = info["cells"], info["knobs"]
        for name, (knob, op, dims, rule, call) in calls.items():
            value, rung = config.tuned(knob, op=op, dtype="float32", dims=dims)
            got = call()
            torch.cuda.synchronize()
            ref = untuned[name]
            if rule == "exact" or value is None or rung != "table":
                ctx.check_exact("tuning %s values" % name, got[0], ref[0])
                ctx.check_exact("tuning %s ids" % name, got[1], ref[1])
                held = "bitwise"
            else:
                p = 2 if name in rooted else 1
                err = ctx.check_knn("tuning %s" % name, got[0] ** p, got[1], ref[0] ** p,
                                    ref[1], atols[name])
                held = "within %.3g (max err %.3g), id sets" % (atols[name], err)
            out["cells"][name] = {"knob": knob, "resolved": value, "rung": rung,
                                  "class": tuning.shape_class(dims), "tuned_vs_untuned": held}
            print("tuning %s: %s resolves to %r from the %s rung (class %s); tuned answer "
                  "equal to the untuned one, %s" % (name, knob, value, rung,
                                                    tuning.shape_class(dims), held), flush=True)
        launches = ctx.counts("tuning")
        s0 = m.build_stats()
        # the checked-in table's main-path cells, or every cell swept here
        ab = autotune.tuned_vs_default(table, iters=5, device=dev,
                                       cells=TUNING_CELLS if found else None,
                                       log=lambda *a: None)
        s1 = m.build_stats()
        assert s0 == s1 and ab["post_warmup_compiles"] == 0, (s0, s1, ab)
        out["tuned_vs_default"] = ab
        out["build_stats_through_timed_loops"] = {"before": s0, "after": s1}
        for c in ab["cells"]:
            print("tuning %s: winner %s, default %s, default/tuned %.3fx%s"
                  % (c["cell"], c["winner"], c["default"], c["ratio"],
                     " (%s)" % c["note"] if "note" in c else ""), flush=True)
    finally:
        config.clear_tuning_table()
    assert config.tuning_table_info() is None

    # ANNService pinned to each select route: the same served answers, bit
    # for bit (K2 and the stable sort both keep the smaller column on ties)
    now = [0.0]
    served = {}
    for impl in ("kernel", "sort"):
        svc = m.ANNService(ctx.ivf, K, start=False, clock=lambda: now[0], max_wait_ms=1.0,
                           select_impl=impl, device=dev)
        try:
            futs = [svc.submit(ctx.ivf_q[r:r + 16]) for r in (0, 16)]
            now[0] += 1.0
            assert svc.worker.run_once()
            served[impl] = [f.result(timeout=0) for f in futs]
        finally:
            svc.close(drain=False)
    for (dk, ik), (ds, is_) in zip(served["kernel"], served["sort"]):
        ctx.check_exact("ANNService select_impl kernel/sort distances", dk, ds)
        ctx.check_exact("ANNService select_impl kernel/sort ids", ik, is_)
    out["ann_service_select_impl"] = "kernel and sort served bitwise equal (2 requests of 16)"
    print("tuning: ANNService(select_impl='kernel') and 'sort' serve 2 requests of 16 rows "
          "bitwise alike", flush=True)
    after = lookups_by_outcome(registry)
    out["lookups"] = {"%s/%s" % key: after[key] - before.get(key, 0.0) for key in after
                      if after[key] != before.get(key, 0.0)}
    print("tuning: table lookups %s; _build.stats() %s before and after the timed loops"
          % (json.dumps(out["lookups"]), json.dumps(s0)), flush=True)

    # the persistent cache: the script's first step ran
    # specializations.warmup() on the build directory (nvcc, then load); a
    # fresh process warming up from the same directory builds nothing
    code = ("import json, sys; sys.path.insert(0, %r); "
            "from raft_tpu_torch.core import specializations as s; r = {}; "
            "s.warmup(report=r); print(json.dumps(r))" % str(ROOT))
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=600)
    wall = time.perf_counter() - t0
    assert proc.returncode == 0, proc.stderr[-4000:]
    rep = json.loads(proc.stdout.strip().splitlines()[-1])
    assert rep["builds"] == 0 and rep["loads"] == len(rep["load_s"]), rep
    first = ctx.warmup
    out["warmup"] = {
        "first": {"build_s": first["build_s"], "build_wall_s": max(first["build_s"].values()),
                  "load_s": first["load_s"], "load_total_s": sum(first["load_s"].values()),
                  "run_s": first["run_s"], "builds": first["builds"]},
        "cached_process": {"process_s": wall, "build_s": rep["build_s"], "load_s": rep["load_s"],
                           "load_total_s": sum(rep["load_s"].values()), "run_s": rep["run_s"],
                           "builds": rep["builds"]}}
    print("tuning: specializations.warmup(): first (this script, %d libraries built) nvcc %.1f s "
          "wall, load %.3f s in all; a fresh process on the same build directory: %d built, "
          "load %.3f s in all (%s), specializations run %s, the process %.1f s"
          % (first["builds"], out["warmup"]["first"]["build_wall_s"],
             out["warmup"]["first"]["load_total_s"], rep["builds"],
             out["warmup"]["cached_process"]["load_total_s"],
             {k: round(v, 4) for k, v in rep["load_s"].items()},
             {k: round(v, 3) for k, v in rep["run_s"].items()}, wall), flush=True)
    out["launches"] = launches
    out["seconds"] = time.perf_counter() - t_path
    # each cell's kernel ran where its knob resolved to it (None: the
    # untuned dispatch, the kernel on the card at these shapes)
    assert launches["select_tile"] > 0, launches
    assert launches["knn_twophase"] > 0, launches
    for name, kernel in (("bfknn_1M", "knn_tile"), ("ivf_search_1M", "ivf_tile")):
        if out["cells"][name]["resolved"] in (None, "kernel"):
            assert launches[kernel] > 0, (name, launches)
    return out


# the kNN's speed-for-accuracy paths (precision_paths): the re-rank ratio of
# bench.py _bench_knn_rerank, the tile width of the scan (fused_l2_knn's
# tile_n), and KNNService at "default" under 4 threads x 16 requests
RERANK_RATIO = 4
SCAN_TILE = 8192
PREC_THREADS, PREC_PER_THREAD = 4, 16


def precision_paths(ctx, m):
    """The kNN layer's reduced-precision and approximate modes on the main
    path's data (the 1M x 128 index, 1024 queries, k 100), each through
    the public entry point:

    - ``bfknn_1M_bf16``: ``brute_force_knn(precision="default")``, K1's
      bfloat16 instance (K1 launched, and K2 once for its splits, not the
      tile scan's K2 a tile), held to the tile scan at "default" (distances
      within ``l2_atol``, ids as sets up to ties), recall@100 against the
      float32 path (``_bench_knn_bf16``);
    - ``knn_twophase_1M_bf16``: K6's at block_n 2048, held to the above;
    - ``knn_rerank_1M``: ``rerank_ratio=4`` (the scan at "default" for 400
      candidates, an exact float32 re-rank), recall@100 against exact;
    - ``knn_approx95_1M``: the tile scan with ``select_impl="approx95"``
      (``config.override`` around this path only), its tiles' bins and
      folds, recall@100 against exact;
    - ``serve_knn_1M_bf16``: ``KNNService(precision="default")`` under 4
      threads, every response bitwise its unbatched call, no kernel built
      after warmup.

    ``ctx`` carries dev, reset, counts, index, queries, exact_d (the
    float32 path's squared distances), exact_i, randn, l2_atol; ``m`` the
    port's names.  Returns ``{path: report}``."""
    dev, index, queries = ctx.dev, ctx.index, ctx.queries
    exact_d, exact_i = ctx.exact_d, ctx.exact_i
    atol = ctx.l2_atol(queries, index)
    L2 = m.D.L2Expanded
    out = {}

    def recall(got_i):
        return (got_i[:, :, None] == exact_i[:, None, :]).any(-1).float().mean().item()

    def no_better_than_exact(name, got_d):
        # the j-th of any K ids is no nearer than the exact j-th
        assert (got_d[:, 1:] >= got_d[:, :-1]).all(), name
        assert (got_d >= exact_d - atol).all(), "%s: nearer than the exact answer" % name

    def bf16_knn():
        return m.brute_force_knn(index, queries, K, L2, precision="default", device=dev)

    ctx.reset()
    t0 = time.perf_counter()
    bf_d, bf_i = bf16_knn()
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t0) * 1e3
    launched = ctx.counts("bfknn_1M_bf16")
    # K1, and K2 once to merge its splits; the tile scan launches K2 a tile
    assert launched["knn_tile"] == 1 and launched["select_tile"] <= 1, launched
    assert bf_d.shape == (N_QUERIES, K) and torch.isfinite(bf_d).all()
    assert bf_i.min() >= 0 and bf_i.max() < N_INDEX
    # the bfloat16 rounding moves a distance by far more than l2_atol: no
    # bound against the exact answer here, only recall
    scan_d, scan_i = m.fused_l2_knn(index, queries[:N_CHECK], K, precision="default",
                                    impl="scan", device=dev)
    err = check_knn("bfknn_1M_bf16 vs the scan at default", bf_d[:N_CHECK], bf_i[:N_CHECK],
                    scan_d, scan_i, atol)
    differ, exact_ties = tie_rows("bfknn_1M_bf16 vs the scan at default", bf_d[:N_CHECK],
                                  bf_i[:N_CHECK], scan_d, scan_i, atol)
    out["bfknn_1M_bf16"] = {
        "launches": launched, "first_call_ms": first_ms, "ms": time_ms(bf16_knn, reps=3),
        "max_err_vs_scan": err, "rows_checked": N_CHECK, "rows_differing_by_ties": differ,
        "rows_differing_by_exact_ties": exact_ties, "recall_at_100_vs_f32": recall(bf_i)}
    out["bfknn_1M_bf16"]["qps"] = N_QUERIES / out["bfknn_1M_bf16"]["ms"] * 1e3
    print("bfknn_1M_bf16: %s" % json.dumps(out["bfknn_1M_bf16"]), flush=True)

    def twophase():
        return m.fused_knn_twophase(index, queries, K, block_n=TWOPHASE_BLOCK_N,
                                    precision="default")

    ctx.reset()
    tp_d, tp_i = twophase()
    torch.cuda.synchronize()
    launched = ctx.counts("knn_twophase_1M_bf16")
    assert launched["knn_twophase"] == 1 and launched["select_tile"] == 1, launched
    err = check_knn("knn_twophase_1M_bf16 vs bfknn_1M_bf16", tp_d, tp_i, bf_d, bf_i, atol)
    out["knn_twophase_1M_bf16"] = {"launches": launched, "block_n": TWOPHASE_BLOCK_N,
                                   "max_err_vs_bfknn_1M_bf16": err,
                                   "ms": time_ms(twophase, reps=3)}
    out["knn_twophase_1M_bf16"]["qps"] = N_QUERIES / out["knn_twophase_1M_bf16"]["ms"] * 1e3
    print("knn_twophase_1M_bf16: %s" % json.dumps(out["knn_twophase_1M_bf16"]), flush=True)
    del tp_d, tp_i

    def rerank():
        return m.brute_force_knn(index, queries, K, L2, rerank_ratio=RERANK_RATIO, device=dev)

    ctx.reset()
    rr_d, rr_i = rerank()
    torch.cuda.synchronize()
    launched = ctx.counts("knn_rerank_1M")
    # stage 1 keeps 400 > 128 candidates: the tile scan with the sort, as
    # the JAX package pins it to its scan; the re-rank's select is K2
    assert launched["knn_tile"] == 0 and launched["select_tile"] >= 1, launched
    no_better_than_exact("knn_rerank_1M", rr_d)
    rr_recall = recall(rr_i)
    assert rr_recall >= 0.95, rr_recall
    out["knn_rerank_1M"] = {"launches": launched, "rerank_ratio": RERANK_RATIO,
                            "candidates": K * RERANK_RATIO, "recall_at_100_vs_exact": rr_recall,
                            "ms": time_ms(rerank, reps=2)}
    out["knn_rerank_1M"]["qps"] = N_QUERIES / out["knn_rerank_1M"]["ms"] * 1e3
    print("knn_rerank_1M: %s" % json.dumps(out["knn_rerank_1M"]), flush=True)
    del rr_d, rr_i

    def approx():
        return m.brute_force_knn(index, queries, K, L2, device=dev)

    bins, folds = m.approx_bins(SCAN_TILE, K)
    with m.config.override(fused_knn_impl="scan", select_impl="approx95"):
        ctx.reset()
        ap_d, ap_i = approx()
        torch.cuda.synchronize()
        launched = ctx.counts("knn_approx95_1M")
        ap_ms = time_ms(approx, reps=2)
    assert launched["knn_tile"] == 0 and launched["select_tile"] > 0, launched
    no_better_than_exact("knn_approx95_1M", ap_d)
    ap_recall = recall(ap_i)
    assert ap_recall >= 0.9, ap_recall
    out["knn_approx95_1M"] = {"launches": launched, "tile_n": SCAN_TILE, "bins": bins,
                              "folds": folds, "recall_target": m.APPROX_RECALL,
                              "recall_at_100_vs_exact": ap_recall, "ms": ap_ms,
                              "qps": N_QUERIES / ap_ms * 1e3}
    print("knn_approx95_1M: %s" % json.dumps(out["knn_approx95_1M"]), flush=True)
    del ap_d, ap_i

    draw = np.random.default_rng(SEED + 1)
    rows = [int(r) for r in draw.choice(SERVE_ROWS, size=PREC_THREADS * PREC_PER_THREAD)]
    pool = ctx.randn(sum(rows), DIM)
    starts = np.cumsum([0] + rows)
    blocks = [pool[a:b] for a, b in zip(starts[:-1], starts[1:])]
    svc = m.KNNService(index, k=K, metric=L2, precision="default", max_batch_rows=N_QUERIES,
                       device=dev, name="serve_knn_1M_bf16")
    try:
        svc.warmup()
        ctx.reset()
        futs, wall_ms = serve_concurrently(svc, blocks, PREC_THREADS)
        torch.cuda.synchronize()
        launched = ctx.counts("serve_knn_1M_bf16")
        after_warmup = svc.kernel_libraries_after_warmup()
    finally:
        svc.close()
    assert launched["knn_tile"] > 0, launched
    assert after_warmup == {"builds": 0, "loads": 0}, after_warmup
    for q, f in zip(blocks, futs):
        d, i = f.result(timeout=0)
        d0, i0 = m.brute_force_knn(index, q, K, L2, precision="default", device=dev)
        assert torch.equal(d, d0) and torch.equal(i, i0), (
            "serve_knn_1M_bf16: a %d-row response differs from the unbatched call" % len(q))
    lat_ms = latencies_ms(futs)
    out["serve_knn_1M_bf16"] = {
        "launches": launched, "requests": len(futs), "rows": sum(rows), "wall_ms": wall_ms,
        "rows_per_s": sum(rows) / wall_ms * 1e3, "p50_ms": statistics.median(lat_ms),
        "p99_ms": quantile(lat_ms, 0.99), "kernel_libraries_after_warmup": after_warmup,
        "bitwise_unbatched": True}
    print("serve_knn_1M_bf16: %s" % json.dumps(out["serve_knn_1M_bf16"]), flush=True)
    return out


def main():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device (torch.cuda.is_available() is False)")
    if not (ROOT / "raft_tpu_torch" / "ops" / "csrc").is_dir():
        sys.exit("chip_smoke: raft_tpu_torch not found beside %s" % __file__)
    sys.path.insert(0, str(ROOT))
    from raft_tpu_torch import (ANNService, DistanceType, IVFFlatParams, IVFPQParams, IVFSQParams,
                                KNNService, LogicError, PairwiseService, approx_knn_search,
                                brute_force_knn, config, ivf_flat_build, ivf_flat_search,
                                ivf_pq_build, ivf_pq_search, ivf_sq_build, ivf_sq_search,
                                pairwise_distance, rbc_all_knn_query, rbc_build_index,
                                rbc_knn_query)
    from raft_tpu_torch import linalg, spectral
    from raft_tpu_torch.core import flight, inventory, native, precision, tracing
    from raft_tpu_torch.core.error import DataCorruptionError
    from raft_tpu_torch.core.handle import Handle
    from raft_tpu_torch.core.metrics import default_registry
    from raft_tpu_torch.distance.pairwise import expanded_sq_dists
    from raft_tpu_torch.ops import _build, cost, ivf_tile
    from raft_tpu_torch.ops.ivf_tile import (fused_ivf_scan, fused_ivf_scan_plain, item_queries,
                                             ivf_items, ivf_items_plain, scan_work_list)
    from raft_tpu_torch.ops.knn_tile import (block_q, fused_knn_tile, fused_knn_twophase,
                                             knn_tile_plain, knn_twophase_plain, prepare_operands,
                                             split_partials, split_rows, twophase_geometry,
                                             twophase_tiles, twophase_tiles_plain)
    from raft_tpu_torch.ops.nn_tile import fused_nn_tile, nn_tile_plain
    from raft_tpu_torch.ops.pairwise_tile import (METRICS, pairwise_tile,
                                                  pairwise_tile_plain)
    from raft_tpu_torch.ops import pq_scan
    from raft_tpu_torch.ops.select_tile import plan, select_tile, select_tile_plain, wide_chunks
    from raft_tpu_torch.serve import pad_rows
    from raft_tpu_torch.sparse import COO, CSR
    from raft_tpu_torch.sparse import distance as sparse_distance
    from raft_tpu_torch.sparse import linalg as sparse_linalg
    from raft_tpu_torch.sparse import selection as sparse_selection
    from raft_tpu_torch.sparse.hierarchy import extract_flattened_clusters, single_linkage
    from raft_tpu_torch.sparse.spectral import fit_embedding
    from raft_tpu_torch.spatial import ball_cover
    from raft_tpu_torch.spatial import ann as ann_mod
    from raft_tpu_torch.spatial.ann import _pack_lists, _pack_lists_numpy, _probe_compact
    from raft_tpu_torch.spatial.ooc import _part_positions, ivf_flat_to_ooc
    from raft_tpu_torch.comms import HostComms, Mesh, faults, selftest
    from raft_tpu_torch.core.error import CommAbortedError
    from raft_tpu_torch.serve import RecoveryManager, inject_replica
    from raft_tpu_torch.session import Comms
    from raft_tpu_torch.spatial.mnmg_knn import (mnmg_ivf_flat_search, mnmg_knn,
                                                 shard_ivf_flat_index, shard_knn_index)

    # the serve_ann_1M checks read every batch of its load back from the
    # flight recorder: a ring that holds the whole run
    config.configure(flight_events="262144")
    D = DistanceType
    # the kernels a path reports its launches of: the cost inventory's
    # counts since the last reset()
    wrappers = _build.KERNELS
    since = {}

    def reset():
        nonlocal since
        since = inventory.snapshot()

    k2_shapes = {}    # path: K2's launches by (rows, width, k)

    def counts(path=None):
        launched = inventory.launches_since(since)
        if path is not None:
            k2_shapes[path] = {ast.literal_eval(key): n
                               for key, n in launched.get("select_tile", {}).items()}
        return {name: sum(launched.get(name, {}).values()) for name in wrappers}

    card = card_line()
    print(card)
    print("torch %s, CUDA %s, %s, %d device(s)" % (
        torch.__version__, torch.version.cuda, torch.cuda.get_device_name(0),
        torch.cuda.device_count()))
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(SEED)

    def randn(*shape):
        return torch.randn(*shape, device=dev, generator=gen)

    # 1. build every kernel, one nvcc each, all at once, load each and run
    # the hot configurations: specializations.warmup() on the checkout's
    # build directory (empty in a fresh checkout)
    from raft_tpu_torch.core import specializations

    t0 = time.perf_counter()
    warm = {}
    specializations.warmup(report=warm)
    warm["wall_s"] = time.perf_counter() - t0
    print("build: %.1f s wall (specializations.warmup), per kernel %s; load %s s; "
          "specializations run %s s" % (
              warm["wall_s"], {k: round(v, 1) for k, v in warm["build_s"].items()},
              {k: round(v, 4) for k, v in warm["load_s"].items()},
              {k: round(v, 3) for k, v in warm["run_s"].items()}), flush=True)

    errs = {name: 0.0 for name in wrappers}
    # the bfloat16 instances' (precision="default") against their plain versions
    errs_bf16 = {name: 0.0 for name in ("knn_tile", "knn_twophase", "nn_tile", "ivf_tile")}

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
        atol = l2_atol(q, x)
        # each at both precisions: 3xTF32, and the bfloat16 instance against
        # the plain version's bfloat16 single pass
        for prec in PRECISIONS:
            tag = "" if prec == "highest" else " default"
            errs_to = errs if prec == "highest" else errs_bf16
            got = fused_knn_tile(x, q, k, prec)
            torch.cuda.synchronize()
            ref = knn_tile_plain(x, q, k, prec)
            err = check_knn("knn_tile n=%d nq=%d d=%d k=%d %s%s" % (len(x), nq, d, k, data, tag),
                            *got, *ref, atol)
            errs_to["knn_tile"] = max(errs_to["knn_tile"], err)
            print("check knn_tile n=%d nq=%d d=%d k=%d %s%s: max err %.3g (atol %.3g)"
                  % (len(x), nq, d, k, data, tag, err, atol), flush=True)

            # K6 at the same shapes, at the smallest block_n and the main path's
            for block_n in (256, TWOPHASE_BLOCK_N):
                bn, n_tiles = twophase_geometry(len(x), block_n)
                part = twophase_tiles(x, q, bn, prec)
                torch.cuda.synchronize()
                part_ref = twophase_tiles_plain(x, q, bn, prec)
                name = "knn_twophase n=%d nq=%d d=%d bn=%d%s" % (len(x), nq, d, bn, tag)
                assert part[0].shape == (nq, n_tiles * 128), name
                assert torch.equal(part[1] < 0, part_ref[1] < 0), "%s: deficit slots differ" % name
                live = part_ref[1] >= 0
                perr = (part[0][live] - part_ref[0][live]).abs().max().item()
                assert perr <= atol, "%s: tile distance error %g > %g" % (name, perr, atol)
                got = fused_knn_twophase(x, q, k, block_n=block_n, precision=prec)
                torch.cuda.synchronize()
                err = check_knn(name + " k=%d" % k, *got,
                                *knn_twophase_plain(x, q, k, block_n=block_n, precision=prec),
                                atol)
                errs_to["knn_twophase"] = max(errs_to["knn_twophase"], err, perr)
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
            # the epilog form and the accumulate-only mode (the raw reduce)
            for epilog in (True, False):
                got = pairwise_tile(x, y, metric, 3.0, epilog=epilog)
                torch.cuda.synchronize()
                ref = pairwise_tile_plain(x, y, metric, 3.0, epilog=epilog)
                # float32 sums of d terms in another order
                torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5)
        print("check pairwise_tile %dx%dx%d%s: %d metrics agree, with and without the epilog "
              "(rtol 1e-5, atol 1e-5)" % (m, n, d, " skewed" if skew else "", len(METRICS)),
              flush=True)

    for m, n, d, dup in [(1000, 1024, 128, False), (77, 1, 16, False),
                         (1031, 3001, 300, False), (500, 2000, 33, True),
                         (9000, 4096, 300, False)]:
        x, y = randn(m, d), randn(n, d)
        if dup:                                  # exact ties: every row of y twice
            y = torch.cat([y[: n // 2], y[: n // 2]])
        atol = l2_atol(x, y)
        for prec in PRECISIONS:
            tag = "" if prec == "highest" else " default"
            got = fused_nn_tile(x, y, prec)
            torch.cuda.synchronize()
            ref = nn_tile_plain(x, y, prec)
            err = check_nn("nn_tile m=%d n=%d d=%d%s" % (m, n, d, tag), *got, *ref, x, y, atol,
                           prec)
            errs_to = errs if prec == "highest" else errs_bf16
            errs_to["nn_tile"] = max(errs_to["nn_tile"], err)
            print("check nn_tile m=%d n=%d d=%d%s%s: max err %.3g (atol %.3g)"
                  % (m, n, d, " dup" if dup else "", tag, err, atol), flush=True)
    # K4's own contract: a row with no finite distance (a NaN in x) keeps
    # (inf, IDX_SENTINEL), as the plain version does
    x, y = randn(300, 64), randn(700, 64)
    x[7, 3] = float("nan")
    keep = torch.arange(300, device=dev) != 7
    for prec in PRECISIONS:
        got, ref = fused_nn_tile(x, y, prec), nn_tile_plain(x, y, prec)
        torch.cuda.synchronize()
        assert torch.isinf(got[0][7]) and int(got[1][7]) == int(ref[1][7]) == 2**31 - 1, got
        errs_to = errs if prec == "highest" else errs_bf16
        errs_to["nn_tile"] = max(errs_to["nn_tile"], check_nn(
            "nn_tile NaN row " + prec, got[0][keep], got[1][keep], ref[0][keep], ref[1][keep],
            x[keep], y, l2_atol(x[keep], y), prec))
    print("check nn_tile NaN row at both precisions: (inf, IDX_SENTINEL), the other rows agree",
          flush=True)

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
        if bf16:
            # precision="default" is the same instance as accum_bf16
            dflt = fused_ivf_scan(*args, precision="default")
            assert torch.equal(dflt[0], got[0]) and torch.equal(dflt[1], got[1]), (
                "%s: precision='default' differs from accum_bf16" % name)
            errs_bf16["ivf_tile"] = max(errs_bf16["ivf_tile"], err)
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

    # 3b. the reduced-precision and approximate modes on the same data
    from raft_tpu_torch.spatial.fused_l2_knn import fused_l2_knn
    from raft_tpu_torch.spatial.select_k import APPROX_RECALL, approx_bins

    pctx = types.SimpleNamespace(dev=dev, reset=reset, counts=counts, index=index,
                                 queries=queries, exact_d=dist ** 2, exact_i=ids, randn=randn,
                                 l2_atol=l2_atol)
    pmods = types.SimpleNamespace(D=D, brute_force_knn=brute_force_knn, fused_l2_knn=fused_l2_knn,
                                  fused_knn_twophase=fused_knn_twophase, KNNService=KNNService,
                                  config=config, approx_bins=approx_bins,
                                  APPROX_RECALL=APPROX_RECALL)
    paths.update(precision_paths(pctx, pmods))

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

    # 4b. K3's partial buffers, bounded by ops/ivf_tile.py PARTIAL_BUDGET_BYTES:
    # a full probe (nprobe = nlist) of the 1M index with the 1024 queries,
    # chunked, then the same call in one chunk (the budget raised past the
    # batch: the scan as it was before the bound), each with its peak
    # allocation; recall@100 against brute force; and at 128 queries the
    # scan in 4 chunks bitwise equal to one chunk
    budget = ivf_tile.PARTIAL_BUDGET_BYTES
    n_steps = NLIST * ivf.cent_slots.shape[1]

    def full_probe(q, budget_bytes):
        ivf_tile.PARTIAL_BUDGET_BYTES = budget_bytes
        try:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            base = torch.cuda.memory_allocated(dev)
            t0 = time.perf_counter()
            out = ivf_flat_search(ivf, q, K, nprobe=NLIST, device=dev)
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated(dev)
            return out, {"ms": (time.perf_counter() - t0) * 1e3, "peak_bytes": peak,
                         "peak_above_start_bytes": peak - base}
        finally:
            ivf_tile.PARTIAL_BUDGET_BYTES = budget

    reset()
    (fp_d, fp_i), after = full_probe(ivf_q, budget)
    launched = counts("ivf_full_probe_1M")
    (one_d, one_i), before = full_probe(ivf_q, 1 << 62)
    chunk = ivf_tile.queries_per_chunk(n_steps, K, item_queries(DIM, dev))
    assert launched["ivf_tile"] == -(-N_QUERIES // chunk) > 1, (launched, chunk)
    assert torch.equal(fp_d, one_d) and torch.equal(fp_i, one_i), (
        "ivf_full_probe_1M: the chunked scan differs from one chunk")
    assert after["peak_bytes"] < before["peak_bytes"], (after, before)
    fpb_d, fpb_i = brute_force_knn(X, ivf_q, K, D.L2SqrtExpanded, device=dev)
    fp_recall = (fp_i[:, :, None] == fpb_i[:, None, :]).any(-1).float().mean().item()
    fp_err = check_knn("ivf full probe 1024 queries vs brute force (squared)", fp_d ** 2, fp_i,
                       fpb_d ** 2, fpb_i, ivf_atol)
    q_few = ivf_q[:N_CHECK]
    (c_d, c_i), _ = full_probe(q_few, (N_CHECK // 4) * n_steps * K * 8)
    (u_d, u_i), _ = full_probe(q_few, 1 << 62)
    assert torch.equal(c_d, u_d) and torch.equal(c_i, u_i), (
        "ivf_full_probe_1M: %d queries in 4 chunks differ from one chunk" % N_CHECK)
    paths["ivf_full_probe_1M"] = {
        "launches": launched, "queries": N_QUERIES, "nprobe": NLIST, "scan_steps": n_steps,
        "budget_bytes": budget, "queries_per_chunk": chunk,
        "partial_bytes_one_chunk": N_QUERIES * n_steps * K * 8,
        "chunked": after, "one_chunk": before, "recall_at_100": fp_recall,
        "max_err_vs_brute_force": fp_err, "chunked_equals_one_chunk_bitwise": True,
        "bitwise_at_%d_queries_in_4_chunks" % N_CHECK: True}
    print("ivf_full_probe_1M: %s" % json.dumps(paths["ivf_full_probe_1M"]), flush=True)
    del fp_d, fp_i, one_d, one_i, fpb_d, fpb_i

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
    labels = build_labels(ivf, N_INDEX, dev).cpu().numpy()
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
    ann_load = (calib_q, blocks, new_vecs, new_ids, load_rows)

    # 5h. IVF-PQ and IVF-SQ on the same data (the builds and searches),
    # their ANNService arms under the serve_ann_1M traffic, the durable
    # state of all three kinds, and the ball cover at 1M points
    qmods = types.SimpleNamespace(
        D=D, ivf_pq_build=ivf_pq_build, ivf_sq_build=ivf_sq_build, ivf_pq_search=ivf_pq_search,
        ivf_sq_search=ivf_sq_search, IVFPQParams=IVFPQParams, IVFSQParams=IVFSQParams,
        ANNService=ANNService, approx_knn_search=approx_knn_search, pad_rows=pad_rows,
        brute_force_knn=brute_force_knn, flight=flight, LogicError=LogicError,
        DataCorruptionError=DataCorruptionError, rbc_build_index=rbc_build_index,
        rbc_knn_query=rbc_knn_query, rbc_all_knn_query=rbc_all_knn_query,
        ball_cover=ball_cover, select_k=ann_mod.select_k,
        expanded_sq_dists=expanded_sq_dists, narrow_codes=pq_scan.narrow_codes,
        ivf_pq_scan=pq_scan.ivf_pq_scan, ivf_pq_scan_plain=pq_scan.ivf_pq_scan_plain,
        scan_cost=pq_scan.scan_cost, pq_tables=ann_mod._pq_tables, probe_compact=_probe_compact,
        PQ_COUNTERS=ann_mod.PQ_COUNTERS, PQ_KERNEL_CHUNKS=ann_mod.PQ_KERNEL_CHUNKS,
        tracing=tracing, inventory=inventory)
    _, bf10 = brute_force_knn(X, ivf_q, QK, D.L2SqrtExpanded, device=dev)
    qpaths, pq, sq, codebook = quantized_paths(X, ivf_q, bf10, dev, reset, counts, qmods)
    paths.update(qpaths)
    for name in qpaths:
        print("%s: %s" % (name, json.dumps(qpaths[name])), flush=True)
    paths["ivf_pq_1M"]["ivf_flat_index_bytes"] = index_bytes(ivf)
    # K7 at the benchmark's IVF-PQ shape and at this path's (the kernels line)
    # (its queries from a generator of their own: the later paths' draws stay as they were)
    k7_gen = torch.Generator(device=dev).manual_seed(SEED + 7)
    k7_q = centers[torch.randint(0, N_BLOBS, (PQ_CELL_QUERIES,), device=dev, generator=k7_gen)]
    k7_q = k7_q + torch.randn(PQ_CELL_QUERIES, DIM, device=dev, generator=k7_gen) * BLOB_SPREAD
    k7_row = pq_scan_row(X, pq, ivf_q, k7_q, dev, qmods)
    del k7_q
    print("pq_scan: %s" % json.dumps(k7_row), flush=True)
    for kind, qindex in (("pq", pq), ("sq", sq)):
        name = "serve_ann_%s_1M" % kind
        paths[name] = serve_quantized(kind, qindex, X, ann_load, dev, reset, counts, qmods)
        print("%s: %s" % (name, json.dumps(paths[name])), flush=True)
    paths["persist_ann_1M"] = persist_path({"flat": ivf, "pq": pq, "sq": sq}, dev, reset,
                                           counts, qmods)
    print("persist_ann_1M: %s" % json.dumps(paths["persist_ann_1M"]), flush=True)
    del pq, sq, qindex, bf10
    for kind in ("haversine", "l2_3d"):
        name = "rbc_%s_1M" % kind
        paths[name] = rbc_path(kind, dev, reset, counts, qmods)
        print("%s: %s" % (name, json.dumps(paths[name])), flush=True)

    # 5i. the out-of-core tier: resident, double-buffered and synchronous
    # arms of ANNService over one index of the mixture
    omods = types.SimpleNamespace(
        D=D, ivf_flat_build=ivf_flat_build, IVFFlatParams=IVFFlatParams, ANNService=ANNService,
        brute_force_knn=brute_force_knn, ivf_flat_to_ooc=ivf_flat_to_ooc,
        probe_compact=_probe_compact, part_positions=_part_positions,
        fused_ivf_scan=fused_ivf_scan, fused_ivf_scan_plain=fused_ivf_scan_plain)
    paths["serve_ann_ooc_1M"] = ooc_path(X, mixture, dev, reset, counts, omods)
    errs["ivf_tile"] = max(errs["ivf_tile"], paths["serve_ann_ooc_1M"]["k3_tile"]["max_abs_err"])
    print("serve_ann_ooc_1M: %s" % json.dumps(paths["serve_ann_ooc_1M"]), flush=True)

    # 5j. the multi-GPU session (queue 1 item 6): worlds of rank slots on
    # the card; K1, K2 and K3 at the sharded paths' shapes
    sctx = types.SimpleNamespace(
        dev=dev, reset=reset, counts=counts, index=index, queries=queries, bf_d=dist,
        bf_i=ids, X=X, ivf=ivf, ivf_q=ivf_q, ivf_d=ivf_d, ivf_i=ivf_i, mixture=mixture,
        randn=randn, errs=errs, check_knn=check_knn, check_exact=check_exact, l2_atol=l2_atol,
        time_ms=time_ms)
    smods = types.SimpleNamespace(
        D=D, Mesh=Mesh, HostComms=HostComms, selftest=selftest, faults=faults, Comms=Comms,
        RecoveryManager=RecoveryManager, KNNService=KNNService, mnmg_knn=mnmg_knn,
        mnmg_ivf_flat_search=mnmg_ivf_flat_search, shard_knn_index=shard_knn_index,
        shard_ivf_flat_index=shard_ivf_flat_index, inject_replica=inject_replica,
        brute_force_knn=brute_force_knn, ivf_flat_search=ivf_flat_search,
        fused_knn_tile=fused_knn_tile, knn_tile_plain=knn_tile_plain, select_tile=select_tile,
        select_tile_plain=select_tile_plain, fused_ivf_scan=fused_ivf_scan,
        fused_ivf_scan_plain=fused_ivf_scan_plain, probe_compact=_probe_compact,
        CommAbortedError=CommAbortedError, cost=cost)
    spaths, sextra = session_paths(sctx, smods)
    paths.update(spaths)

    # 5j'. the multi-process session (queue 1 item 8): two child processes
    # of two rank slots each, held bitwise to this process's world of 4;
    # the kernels' launches read from the children
    from raft_tpu_torch.comms import RetryPolicy
    from raft_tpu_torch.comms.mp_selftest import _digest
    from raft_tpu_torch.core.error import CommError
    from raft_tpu_torch.persist.snapshot import write_snapshot

    mctx = types.SimpleNamespace(dev=dev, ivf=ivf, ivf_q=ivf_q, time_ms=time_ms,
                                 wrappers=wrappers)
    mmods = types.SimpleNamespace(
        D=D, Mesh=Mesh, Comms=Comms, RetryPolicy=RetryPolicy, CommError=CommError,
        digest=_digest, mnmg_knn=mnmg_knn, mnmg_ivf_flat_search=mnmg_ivf_flat_search,
        shard_ivf_flat_index=shard_ivf_flat_index, write_snapshot=write_snapshot)
    paths.update(mp_paths(mctx, mmods))

    # 5k. the fleet (queue 1 item 7): a router in this process, worker
    # processes on the card; the kernels' launches read from the workers
    from raft_tpu_torch.fleet import Fleet, Router, protocol
    from raft_tpu_torch.fleet.worker import _synth

    fctx = types.SimpleNamespace(dev=dev, reset=reset, counts=counts, wrappers=wrappers)
    fmods = types.SimpleNamespace(synth=_synth, Fleet=Fleet, Router=Router, protocol=protocol,
                                  flight=flight, default_registry=default_registry,
                                  fused_knn_tile=fused_knn_tile)
    paths.update(fleet_paths(fctx, fmods))

    # 5k'. the load generator's scenarios and the report tools (queue 1
    # items 9 and 10): tools/torch_loadgen.py's run_* over this script's
    # data, then tools/torch_trace_report.py and torch_metrics_report.py
    from raft_tpu_torch.session import metrics_snapshot
    from tools import torch_loadgen, torch_metrics_report, torch_trace_report

    lctx = types.SimpleNamespace(dev=dev, reset=reset, counts=counts, wrappers=wrappers,
                                 index=index, X=X, ivf=ivf, nprobe=calibrated)
    lmods = types.SimpleNamespace(lg=torch_loadgen, tr=torch_trace_report,
                                  mr=torch_metrics_report, KNNService=KNNService,
                                  ANNService=ANNService, RecoveryManager=RecoveryManager,
                                  flight=flight, metrics_snapshot=metrics_snapshot)
    paths.update(loadgen_paths(lctx, lmods))

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

    # 5e. spectral partitioning on CSR (BASELINE.md config #4): partition of
    # the two-community graph at 100k vertices (the JAX rung, not cut) and
    # at 1M, with the rung's solver, twice each (the second solve bitwise
    # equal to the first); the SpMV held against float64 and timed queued
    # beside its bytes bound; the device's busy share of a third solve
    # from a trace; then modularity maximization at 100k and the
    # fit_embedding rung.  None of the six kernels is on these paths (the
    # k-means has 2 clusters, below FUSED_ASSIGN_MIN_K): they launch none.
    graphs = {}
    for size, (n_half, want_nnz) in SPECTRAL_SIZES.items():
        name = "spectral_partition_" + size
        n = 2 * n_half
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        csr = graphs[size] = community_graph(n_half, SPECTRAL_CROSS, dev)
        nnz = int(csr.nnz)
        graph_ms = (time.perf_counter() - t0) * 1e3
        assert nnz == want_nnz, (name, nnz, want_nnz)
        truth = (np.arange(n) >= n_half).astype(np.int32)
        runs = []
        reset()
        for _ in range(2):
            solver = spectral.LanczosSolver(spectral.EigenSolverConfig(**SPECTRAL_SOLVER))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = spectral.partition(csr, eigen_solver=solver, n_clusters=2, device=dev)
            torch.cuda.synchronize()
            runs.append(((time.perf_counter() - t0) * 1e3, res))
        launched = counts()
        (ms, res), (ms2, res2) = runs
        for field in ("clusters", "eig_vals", "eig_vecs"):
            a, b = getattr(res, field), getattr(res2, field)
            assert torch.equal(a.reshape(-1).view(torch.int32), b.reshape(-1).view(torch.int32)), (
                "%s: a second solve differs in %s" % (name, field))
        assert (res.iters_eig, res.iters_cluster) == (res2.iters_eig, res2.iters_cluster)
        labels = res.clusters.cpu().numpy()
        ari = adjusted_rand_index(labels, truth)
        edge_cut, ratio_cut = spectral.analyze_partition(csr, 2, res.clusters, device=dev)
        L = spectral.LaplacianMatrix(csr)
        resid = [float(torch.linalg.vector_norm(L.mv(v) - lam * v))
                 for lam, v in zip(res.eig_vals, res.eig_vecs.T.contiguous())]
        assert ari > 0.95, (name, ari)
        assert float(edge_cut) <= 3 * SPECTRAL_CROSS, (name, float(edge_cut))
        # the restarts the iteration count allows (linalg/lanczos.py): the
        # solve stopped on tol where it took fewer
        ncv = SPECTRAL_SOLVER["restart_iter"]
        k_eig = SPECTRAL_SOLVER["n_eig_vecs"]
        cap_iters = ncv + (SPECTRAL_SOLVER["max_iter"] // ncv - 1) * (ncv - k_eig)
        # the SpMV: against float64 on the card, then the Lanczos loop's
        # product (prepared once) and the public call, queued
        x = randn(n)
        rows = csr.row_ids()[:nnz].long()
        terms = csr.data[:nnz].double() * x.double()[csr.indices[:nnz].long()]
        ref = torch.zeros(n, dtype=torch.float64, device=dev).index_add_(0, rows, terms)
        scale = torch.zeros(n, dtype=torch.float64, device=dev).index_add_(0, rows, terms.abs())
        y = sparse_linalg.csr_spmv(csr, x, device=dev)
        spmv_err = float(((y.double() - ref).abs() / scale.clamp(min=1e-30)).max())
        assert spmv_err <= SPMV_RTOL, (name, spmv_err)
        # "sortscan" is the segment route's code; "cumsum" differences a
        # running sum over all entries, so its error scales with that sum
        # at the row (csr_spmv's caveat), not with the row's own terms
        assert torch.equal(sparse_linalg.csr_spmv(csr, x, "sortscan", device=dev), y)
        y_cs = sparse_linalg.csr_spmv(csr, x, "cumsum", device=dev)
        running = torch.cumsum(terms.abs(), 0)[(csr.indptr[1:].long() - 1).clamp(min=0)]
        cumsum_err = float(((y_cs.double() - ref).abs() / running.clamp(min=1e-30)).max())
        assert cumsum_err <= CUMSUM_RTOL, (name, cumsum_err)
        prepared = sparse_linalg.spmv_plan(csr)
        spmv_q = queued_ms(lambda: sparse_linalg.spmv(prepared, x))
        # the library yardstick: cuSPARSE through torch's sparse CSR tensor
        a_lib = torch.sparse_csr_tensor(csr.indptr, csr.indices[:nnz], csr.data[:nnz], (n, n),
                                        check_invariants=False)
        lib_err = float((((a_lib @ x[:, None])[:, 0].double() - ref).abs()
                         / scale.clamp(min=1e-30)).max())
        # the eigensolver alone, as the partition calls it
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        spectral.LanczosSolver(spectral.EigenSolverConfig(**SPECTRAL_SOLVER)) \
            .solve_smallest_eigenvectors(spectral.LaplacianMatrix(csr), n)
        torch.cuda.synchronize()
        lanczos_ms = (time.perf_counter() - t0) * 1e3
        bound_ms = (nnz * SPMV_BYTES_PER_NNZ + n * SPMV_BYTES_PER_ROW) / PEAK_BYTES * 1e3
        paths[name] = {
            "launches": launched, "vertices": n, "stored_entries": nnz, "graph_ms": graph_ms,
            "ms": ms, "second_ms": ms2, "second_solve_bitwise_equal": True,
            "lanczos_iters": res.iters_eig, "lanczos_iter_cap": cap_iters,
            "stopped_on_tol": res.iters_eig < cap_iters, "ritz_residuals": resid,
            "eig_vals": res.eig_vals.tolist(), "kmeans_iters": res.iters_cluster,
            "ari": ari, "edge_cut": float(edge_cut), "ratio_cut": float(ratio_cut),
            "lanczos_ms": lanczos_ms, "spmv_queued_ms": spmv_q,
            "spmv_library_queued_ms": queued_ms(lambda: a_lib @ x[:, None]),
            "spmv_library_max_rel_err": lib_err,
            "csr_spmv_queued_ms": queued_ms(lambda: sparse_linalg.csr_spmv(csr, x, device=dev)),
            "csr_spmv_ms": time_ms(lambda: sparse_linalg.csr_spmv(csr, x, device=dev), reps=20),
            "spmv_bound_ms": bound_ms, "spmv_bound_by": "bytes", "spmv_max_rel_err": spmv_err,
            "cumsum_max_err_of_running_sum": cumsum_err,
            "cumsum_max_rel_err": float(((y_cs.double() - ref).abs()
                                         / scale.clamp(min=1e-30)).max()),
            # the SpMV's device time over the solve's wall time: the busy
            # share of the product alone
            "spmv_share_of_wall": spmv_q * res.iters_eig / ms}
        trace = ROOT / "build" / ("%s_trace.json" % name)
        trace.parent.mkdir(exist_ok=True)
        wall, busy, top = traced_busy(lambda: spectral.partition(
            csr, eigen_solver=spectral.LanczosSolver(
                spectral.EigenSolverConfig(**SPECTRAL_SOLVER)), n_clusters=2, device=dev),
            trace)
        paths[name].update({"traced_ms": wall, "traced_device_busy_ms": busy,
                            "traced_device_idle_share": 1.0 - busy / wall,
                            "traced_top_kernels": top})
        print("%s: %s" % (name, json.dumps(paths[name])), flush=True)
        del L, prepared, a_lib, rows, terms, ref, scale, x, y, y_cs, running, res, res2, runs

    # modularity maximization on the 100k graph, the partition rung's solver
    csr = graphs["100k"]
    n = csr.n_rows
    reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mres = spectral.modularity_maximization(
        csr, eigen_solver=spectral.LanczosSolver(spectral.EigenSolverConfig(**SPECTRAL_SOLVER)),
        n_clusters=2, device=dev)
    torch.cuda.synchronize()
    mod_ms = (time.perf_counter() - t0) * 1e3
    launched = counts()
    q_mod = float(spectral.analyze_modularity(csr, 2, mres.clusters, device=dev))
    # Q in float64 from the graph's entries: sum over clusters of the
    # within-cluster weight minus (the cluster's degree sum)^2 / 2E, over 2E
    nnz = int(csr.nnz)
    rows = csr.row_ids()[:nnz].long()
    lab = mres.clusters.long()
    w = csr.data[:nnz].double()
    deg = torch.zeros(n, dtype=torch.float64, device=dev).index_add_(0, rows, w)
    two_e = deg.sum()
    within = (w * (lab[rows] == lab[csr.indices[:nnz].long()])).sum()
    vol = torch.zeros(2, dtype=torch.float64, device=dev).index_add_(0, lab, deg)
    q_ref = float((within - (vol * vol).sum() / two_e) / two_e)
    assert abs(q_mod - q_ref) <= 1e-4 * abs(q_ref), (q_mod, q_ref)
    assert set(np.unique(mres.clusters.cpu().numpy()).tolist()) == {0, 1}
    paths["modularity_100k"] = {
        "launches": launched, "ms": mod_ms, "modularity": q_mod, "modularity_float64": q_ref,
        "ari": adjusted_rand_index(mres.clusters.cpu().numpy(),
                                   (np.arange(n) >= n // 2).astype(np.int32)),
        "lanczos_iters": mres.iters_eig, "kmeans_iters": mres.iters_cluster,
        "eig_vals": mres.eig_vals.tolist()}
    print("modularity_100k: %s" % json.dumps(paths["modularity_100k"]), flush=True)
    del graphs, csr, rows, lab, w, deg, mres

    # fit_embedding on the bench's 2,048-vertex graph: the rung's call (tol
    # 0.01) timed after one warm call, and the span of [1, embedding]
    # against eigenvectors 1..5 of the float64 dense Laplacian (a subspace
    # check: the whitening mixes in the constant vector) within the
    # Davis-Kahan bound sqrt(5) tol lambda_max / (lambda_6 - lambda_5), at
    # the rung's tol (where the bound is above 1, so it holds trivially)
    # and at 1e-5, where it resolves the span
    e_rows, e_cols, e_vals = ring_graph(EMBED_N)
    coo = COO(e_rows, e_cols, e_vals, (EMBED_N, EMBED_N), device=dev)
    dense = coo.to_dense().double()
    lap64 = torch.diag(dense.sum(1)) - dense
    w64, v64 = torch.linalg.eigh(lap64)
    basis = v64[:, :EMBED_COMPONENTS + 1]
    gap = float(w64[EMBED_COMPONENTS + 1] - w64[EMBED_COMPONENTS])
    emb_out = {"vertices": EMBED_N, "stored_entries": int(coo.capacity),
               "n_components": EMBED_COMPONENTS, "eigenvalues_1_to_7": w64[:7].tolist()}
    reset()
    for tol in EMBED_TOLS:
        fit_embedding(coo, EMBED_COMPONENTS, tol=tol, device=dev)        # warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        emb = fit_embedding(coo, EMBED_COMPONENTS, tol=tol, device=dev)
        torch.cuda.synchronize()
        emb_ms = (time.perf_counter() - t0) * 1e3
        assert emb.shape == (EMBED_N, EMBED_COMPONENTS) and torch.isfinite(emb).all()
        angle = max_principal_angle(torch.cat([torch.ones_like(emb[:, :1]), emb], dim=1), basis)
        dk_bound = (EMBED_COMPONENTS + 1) ** 0.5 * tol * float(w64[-1]) / gap
        assert np.sin(angle) <= dk_bound, (tol, angle, dk_bound)
        emb_out["tol_%g" % tol] = {"ms": emb_ms, "max_principal_angle": angle,
                                   "sin_bound": dk_bound}
    emb_out["launches"] = counts()
    paths["fit_embedding_2k"] = emb_out
    print("fit_embedding_2k: %s" % json.dumps(emb_out), flush=True)
    del coo, dense, lap64, v64, basis, emb

    # 5f. single linkage (ROADMAP queue 1, item 3): the JAX rung at 50k x 2
    # and 1M x 16, twice each (bitwise equal); the 1M run's second call
    # traced for the device's busy share.  K1 builds the kNN graph; the
    # MST and the components fix-up are torch.
    linkage_mods = {"single_linkage": single_linkage, "knn": brute_force_knn,
                    "metric": D.L2SqrtExpanded, "knn_plain": knn_tile_plain,
                    "cut": extract_flattened_clusters, "native": native}
    for size in LINKAGE_SIZES:
        name = "single_linkage_" + size
        trace = ROOT / "build" / ("%s_trace.json" % name) if size == "1M" else None
        paths[name] = linkage_path(size, dev, reset, counts, linkage_mods, trace)
        errs["knn_tile"] = max(errs["knn_tile"], paths[name]["k1_check"]["max_abs_err"])
        print("%s: %s" % (name, json.dumps(paths[name])), flush=True)

    # 5g. the sparse engine at the 20 newsgroups shape: L1 pairwise
    # (column-tiled, K5 accumulate-only) and kNN (full width, K5 then K2)
    news = newsgroups_csr(dev, gen, CSR)
    trace = ROOT / "build" / "sparse_l1_newsgroups_trace.json"
    news_out = sparse_l1_path(news, dev, reset, counts, sparse_distance, sparse_selection, D.L1,
                              trace, pairwise_tile, pairwise_tile_plain)
    errs["pairwise_tile"] = max(errs["pairwise_tile"], news_out["knn"]["k5_check"]["max_abs_err"])
    paths["sparse_l1_newsgroups"] = news_out
    print("sparse_l1_newsgroups: %s" % json.dumps(news_out), flush=True)
    del news

    # 5l. the tuning half (queue 1 item 7b): the table installed for this
    # path only, each main-path cell tuned against untuned, the warmup
    from raft_tpu_torch.core import tuning
    from raft_tpu_torch.spatial.select_k import select_k

    tctx = types.SimpleNamespace(dev=dev, reset=reset, counts=counts, randn=randn, index=index,
                                 warmup=warm,
                                 queries=queries, ivf=ivf, ivf_q=ivf_q, X=X, l2_atol=l2_atol,
                                 check_knn=check_knn, check_exact=check_exact)
    tmods = types.SimpleNamespace(config=config, tuning=tuning, D=D, select_k=select_k,
                                  brute_force_knn=brute_force_knn,
                                  fused_knn_twophase=fused_knn_twophase, ANNService=ANNService,
                                  ivf_flat_search=ivf_flat_search,
                                  default_registry=default_registry, build_stats=_build.stats)
    paths["tuning"] = tuning_path(tctx, tmods)
    print("tuning: %s" % json.dumps(paths["tuning"]), flush=True)

    # 6. kernels at the main paths' shapes: kernel, plain version, yardstick
    def bf16_row(fn, plain, ops, nbytes, library, err, library_form):
        """The bfloat16 instance's entries of a kernel's row: its time,
        its plain version's, its bound at the bfloat16 rate and as built
        (one TF32 pass), and the library's product of bfloat16 operands."""
        b16, by16 = bound_bf16(ops, nbytes)
        return {"bf16_max_abs_err": err, "bf16_ms": time_ms(fn, reps=5),
                "bf16_plain_ms": time_ms(plain, reps=2),
                "bf16_bound_ms": b16, "bf16_bound_by": by16,
                "bf16_tf32_pass_bound_ms": bound_tf32x3(ops, nbytes,
                                                        cost.TENSOR_PASSES["default"])[0],
                "bf16_library_ms": time_ms(library, reps=3), "bf16_library": library_form}

    launches = {name: sum(p["launches"].get(name, 0) for p in paths.values()
                          if isinstance(p.get("launches"), dict))
                for name in wrappers}
    rows = []

    def full_l2_topk():
        qn = (queries * queries).sum(1, keepdim=True)
        xn = (index * index).sum(1)
        return torch.topk(qn + xn - 2.0 * (queries @ index.T), K, dim=1, largest=False)

    knn_ops, knn_bytes = cost.knn_cost(N_QUERIES, N_INDEX, DIM, K)
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
        "library_ms": time_ms(full_l2_topk, reps=3), "mnmg_shard": sextra["k1_shard"]})
    # the bfloat16 instance (precision="default") at the same shape: its
    # least time is the products at the bfloat16 rate; the instance as
    # built issues them as one TF32 pass (TF32 wgmma of bfloat16 values)
    q16, x16 = queries.to(torch.bfloat16), index.to(torch.bfloat16)

    def bf16_l2_topk():
        qn = (queries * queries).sum(1, keepdim=True)
        xn = (index * index).sum(1)
        return torch.topk(qn + xn - 2.0 * bf16_mm(q16, x16.T), K, dim=1, largest=False)

    rows[-1].update(bf16_row(lambda: fused_knn_tile(index, queries, K, "default"),
                             lambda: knn_tile_plain(index, queries, K, "default"), knn_ops,
                             knn_bytes, bf16_l2_topk, errs_bf16["knn_tile"],
                             "torch.mm(out_dtype=float32) of bfloat16 operands + torch.topk"))

    # K1 at the benchmark's batch (N_BATCH queries, k 100 and 10), where
    # the index splits fill whole waves: every query against the plain
    # version, and K2's merge of the splits bit for bit on K1's own
    # partials; K6 at the same queries against K1
    q_batch = randn(N_BATCH, DIM)
    batch_atol = l2_atol(q_batch, index)
    batch = {}
    for k in (K, 10):
        got = fused_knn_tile(index, q_batch, k)
        torch.cuda.synchronize()
        err = check_knn("knn_tile 1M nq=%d k=%d" % (N_BATCH, k), *got,
                        *knn_tile_plain(index, q_batch, k), batch_atol)
        errs["knn_tile"] = max(errs["knn_tile"], err)
        split = split_rows(N_BATCH, N_INDEX, n_sms, block_q(DIM), k)
        part_d, _ = split_partials(*prepare_operands(index, q_batch), k, split)
        check_select("K1 splits", part_d, k)
        batch["k%d" % k] = {"splits": -(-N_INDEX // split), "merge_w": part_d.shape[1],
                            "max_abs_err": err, "ms": time_ms(lambda: fused_knn_tile(
                                index, q_batch, k), reps=5)}
        del got, part_d
        print("check knn_tile 1M nq=%d k=%d: %s (atol %.3g), K2's merge exact"
              % (N_BATCH, k, json.dumps(batch["k%d" % k]), batch_atol), flush=True)
    tp = fused_knn_twophase(index, q_batch, K, block_n=TWOPHASE_BLOCK_N)
    torch.cuda.synchronize()
    batch["knn_twophase_k%d" % K] = {
        "block_n": TWOPHASE_BLOCK_N,
        "max_abs_err_vs_k1": check_knn("knn_twophase 1M nq=%d vs K1" % N_BATCH, *tp,
                                       *fused_knn_tile(index, q_batch, K), batch_atol),
        "ms": time_ms(lambda: fused_knn_twophase(index, q_batch, K, block_n=TWOPHASE_BLOCK_N),
                      reps=3)}
    del tp, q_batch
    rows[-1]["batch_%d" % N_BATCH] = batch
    print("knn_tile at nq=%d: %s" % (N_BATCH, json.dumps(batch)), flush=True)

    keys = pairwise_tile(queries, index_l1, D.L1)
    got, ref = select_tile(keys, K), select_tile_plain(keys, K)
    check_exact("select_tile main-path values", got[0], ref[0])
    check_exact("select_tile main-path ids", got[1], ref[1])
    b, by = bound(*cost.select_cost(N_QUERIES, N_L1, K))
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
    # k = 1, 32, 64, 100 and 128 (at most its width), and timed at its own
    # k beside torch.topk; the launch-weighted total is what the paths
    # spend in it.
    def k2_keys(m, w, run):
        if not run:
            return randn(m, w)
        return torch.sort(randn(m, w // run, run), dim=2).values.reshape(m, w)

    k2_all = {}
    for path, shp in k2_shapes.items():
        for (m, w, k), n_launch in shp.items():
            run = 128 if path.startswith("knn_twophase_1M") else k
            # the L1 select, the IVF probes (k an nprobe) and the delta merge
            # (one sorted run of k, then the delta's keys) take normal keys;
            # of the quantized and ball-cover paths only the ball cover's
            # merges (two sorted runs of k) are runs
            normal = (path == "bfknn_L1_100k" or w % run
                      or path.startswith(NORMAL_KEY_PATHS)
                      or (path in PROBE_PATHS and k != K)
                      or (path in QUANTIZED_PATHS and not (path.startswith("rbc_")
                                                           and w == 2 * k)))
            run = None if normal else run
            k2_all[(m, w, k, run)] = k2_all.get((m, w, k, run), 0) + n_launch
    k2_rows = []
    for (m, w, k, run), n_launch in sorted(k2_all.items(), key=lambda kv: kv[0][:3]):
        path_keys = k2_keys(m, w, run)
        for kk in sorted({min(kk, w) for kk in (1, 32, 64, 100, 128)}):
            check_select("at a path's shape", path_keys, kk)
        chunks = plan(m, w, k)
        topk = lambda: torch.topk(path_keys, k, dim=1, largest=False)  # noqa: E731
        k2_rows.append({"rows": m, "width": w, "k": k, "launches": n_launch,
                        "keys": "sorted runs of %d" % run if run else "normal",
                        "route": "wide, %d blocks a row" % chunks if chunks else "held",
                        "ms": time_ms(lambda: select_tile(path_keys, k), reps=20),
                        "queued_ms": queued_ms(lambda: select_tile(path_keys, k)),
                        "bound_ms": cost.select_cost(m, w, k)[1] / PEAK_BYTES * 1e3,
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
    # K5's bound: issued FP32 instructions, cost.K5_INSTR_PER_STEP a step,
    # 128 a clock on each SM at the SM clock read right after the timing
    k5_ms = time_ms(lambda: pairwise_tile(queries, index_l1, D.L1), reps=5)
    k5_clocks = clocks_line()
    k5_metric_ms = {metric.name: time_ms(lambda: pairwise_tile(queries, index_l1, metric), reps=3)
                    for metric in (D.L2Unexpanded, D.Linf)}
    sm_hz = float(k5_clocks.split(",")[0].split()[0]) * 1e6
    k5_ops, k5_bytes = cost.pairwise_cost(N_QUERIES, N_L1, DIM)
    t_ops = k5_ops / (128.0 * n_sms * sm_hz) * 1e3
    t_bytes = k5_bytes / PEAK_BYTES * 1e3
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
                      "each of %d SMs at %.0f MHz" % (cost.K5_INSTR_PER_STEP, n_sms, sm_hz / 1e6),
        "library_ms": time_ms(lambda: torch.cdist(queries, index_l1, p=1), reps=3)})
    del keys
    # K5's accumulate-only mode at the column-tiled engine's launch shape
    # (the newsgroups pairwise: 1024 x 1024 rows over a 65,536-column tile)
    rm, rn, rk = K5_RAW_SHAPE
    xa, xb = torch.rand(rm, rk, device=dev, generator=gen), torch.rand(rn, rk, device=dev,
                                                                         generator=gen)
    raw = pairwise_tile(xa, xb, D.L1, epilog=False)
    raw_ref = pairwise_tile_plain(xa, xb, D.L1, epilog=False)
    raw_err = (raw - raw_ref).abs().max().item()
    raw_scale = raw_ref.abs().max().item()
    # float32 sums of 65,536 terms in another order
    assert raw_err <= K5_RAW_RTOL * raw_scale, ("K5 raw", raw_err, raw_scale)
    del raw_ref
    # L1's epilog is the identity: the two modes store the same bits
    assert torch.equal(raw, pairwise_tile(xa, xb, D.L1)), "K5: raw and epilog L1 differ"
    del raw
    raw_ms = time_ms(lambda: pairwise_tile(xa, xb, D.L1, epilog=False), reps=5)
    raw_clocks = clocks_line()
    raw_hz = float(raw_clocks.split(",")[0].split()[0]) * 1e6
    r_ops, r_bytes = cost.pairwise_cost(rm, rn, rk)
    r_ops = r_ops / (128.0 * n_sms * raw_hz) * 1e3
    r_bytes = r_bytes / PEAK_BYTES * 1e3
    rows[-1]["raw_mode"] = {
        "shape": "L1 without the epilog, x %dx%d, y %dx%d f32" % (rm, rk, rn, rk),
        "max_abs_err": raw_err, "max_rel_err": raw_err / raw_scale, "ms": raw_ms,
        "clocks_sm_power_after": raw_clocks,
        "plain_ms": time_ms(lambda: pairwise_tile_plain(xa, xb, D.L1, epilog=False), reps=1),
        "bound_ms": max(r_ops, r_bytes), "bound_by": "operations" if r_ops >= r_bytes else "bytes",
        "library_ms": time_ms(lambda: torch.cdist(xa, xb, p=1), reps=1),
        "newsgroups_tiles": paths["sparse_l1_newsgroups"]["pairwise"]["k5_raw_checks"]}
    del xa, xb

    # K4 at the build's assignment: the training rows against the centroids
    xs, cents = X[:TRAIN_ROWS], ivf.centroids
    got, ref = fused_nn_tile(xs, cents), nn_tile_plain(xs, cents)
    errs["nn_tile"] = max(errs["nn_tile"], check_nn("nn_tile at the build's shape", *got, *ref,
                                                    xs, cents, l2_atol(xs, cents)))

    def l2_min():
        xn, cn = (xs * xs).sum(1), (cents * cents).sum(1)
        return torch.min(xn[:, None] + cn[None, :] - 2.0 * (xs @ cents.T), dim=1)

    m, n = xs.shape[0], cents.shape[0]
    nn_ops, nn_bytes = cost.nn_cost(m, n, DIM)
    b, by = bound_tf32x3(nn_ops, nn_bytes)
    got, ref = fused_nn_tile(xs, cents, "default"), nn_tile_plain(xs, cents, "default")
    errs_bf16["nn_tile"] = max(errs_bf16["nn_tile"], check_nn(
        "nn_tile at the build's shape, default", *got, *ref, xs, cents, l2_atol(xs, cents),
        "default"))
    xs16, cents16 = xs.to(torch.bfloat16), cents.to(torch.bfloat16)

    def bf16_l2_min():
        xn, cn = (xs * xs).sum(1), (cents * cents).sum(1)
        return torch.min(xn[:, None] + cn[None, :] - 2.0 * bf16_mm(xs16, cents16.T), dim=1)

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
    rows[-1].update(bf16_row(lambda: fused_nn_tile(xs, cents, "default"),
                             lambda: nn_tile_plain(xs, cents, "default"), nn_ops, nn_bytes,
                             bf16_l2_min, errs_bf16["nn_tile"],
                             "torch.mm(out_dtype=float32) of bfloat16 operands + torch.min"))
    del xs16, cents16
    # K4 at a PQ codebook's shape: the residuals' first subspace (depth 8)
    # against its 256 codewords, as each codebook's k-means assigns
    xs, cents = codebook
    got, ref = fused_nn_tile(xs, cents), nn_tile_plain(xs, cents)
    cb_err = check_nn("nn_tile at a codebook's shape", *got, *ref, xs, cents, l2_atol(xs, cents))
    errs["nn_tile"] = max(errs["nn_tile"], cb_err)
    m, n = xs.shape[0], cents.shape[0]
    cb_ops, cb_bytes = cost.nn_cost(m, n, xs.shape[1])
    b, by = bound_tf32x3(cb_ops, cb_bytes)
    rows[-1]["codebook"] = {
        "shape": "x %dx%d f32 against %d codewords" % (m, xs.shape[1], n), "max_abs_err": cb_err,
        "ms": time_ms(lambda: fused_nn_tile(xs, cents), reps=10),
        "plain_ms": time_ms(lambda: nn_tile_plain(xs, cents), reps=5),
        "bound_ms": b, "bound_by": by, "bound_fp32_ms": bound(cb_ops, cb_bytes)[0],
        "library_ms": time_ms(l2_min, reps=5)}
    del codebook, xs, cents

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
    scan_ops, least_bytes = cost.ivf_scan_cost(N_QUERIES, DIM, K, slots.numel(), rows_scanned,
                                               rows_distinct)
    b, by = bound_tf32x3(scan_ops, least_bytes)
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
        "bound_fp32_ms": bound(scan_ops, least_bytes)[0],
        "library_ms": None, "library": "none: no single PyTorch call scans an IVF list",
        "bf16_ms": time_ms(lambda: fused_ivf_scan(*scan_args, accum_bf16=True), reps=5),
        "bf16_kernel_ms": time_ms(lambda: ivf_items(*flat, accum_bf16=True), reps=5),
        "rows_scanned": rows_scanned, "least_bytes": least_bytes,
        "item_bytes": n_items * cap * row_bytes + io_bytes,
        "per_query_bytes": rows_scanned * row_bytes + io_bytes,
        "ooc_tile": paths["serve_ann_ooc_1M"]["k3_tile"], "mnmg_shard": sextra["k3_shard"]})

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
        "phase1_bytes": cost.knn_cost(N_QUERIES, N_INDEX, DIM, n_tiles * 128)[1],
        "library_ms": time_ms(full_l2_topk, reps=3),
        "library": "composition: expanded-L2 matmul + torch.topk, as K1's"})
    rows[-1].update(bf16_row(lambda: fused_knn_twophase(index, queries, K,
                                                        block_n=TWOPHASE_BLOCK_N,
                                                        precision="default"),
                             lambda: knn_twophase_plain(index, queries, K, TWOPHASE_BLOCK_N,
                                                        "default"),
                             knn_ops, knn_bytes, bf16_l2_topk, errs_bf16["knn_twophase"],
                             "as K1's bf16_library"))
    rows[-1]["bf16_phase1_ms"] = time_ms(lambda: twophase_tiles(index, queries, bn, "default"),
                                         reps=5)
    del q16, x16
    rows.append(dict(k7_row, launches=launches["pq_scan"]))

    print(json.dumps({"card": card, "paths": paths}))
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
