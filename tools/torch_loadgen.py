#!/usr/bin/env python3
"""Load generator for raft_tpu_torch's services.

The port's arm of ``tools/loadgen.py``: drives a
:class:`raft_tpu_torch.serve.KNNService`, ``PairwiseService`` or
``ANNService`` with synthetic traffic and reports client-observed
latency percentiles beside throughput, under the JAX report's keys
where they apply.

Two loops:

- **closed** (``--concurrency N``): N client threads each submit a
  request, wait for its future and submit the next: throughput is
  latency-bound.
- **open** (``--qps Q``): one pacing thread fires submits on a fixed
  schedule whatever the completions: at overload it measures the shed
  rate (``ServiceOverloadError``) instead of slowing down.

``--service ann`` fronts an IVF-Flat index and always reports
**recall@k** against a brute-force truth computed once a run (an
approximate index's rate means nothing without its quality);
``--recall`` adds the same scoring to the exact services.
``--recall-target`` calibrates ``nprobe`` first.  ``--ooc
--device-budget-mb N`` serves the out-of-core tier under an N-MiB device
budget.  ``--select-impl kernel|sort`` pins the ANN service's selections
(the registry's ``select_impl``); ``--tuned`` loads the tuning table
(``RAFT_TPU_TUNING_TABLE``'s rule: ``auto`` by default, or ``--table
PATH``) and ``--untuned`` runs with none, so two runs are an A/B of the
table.

``post_warmup_compiles`` counts the kernel libraries built or loaded
during the load window (``ops/_build.py:stats``), the port's analogue of
the JAX report's compile-cache misses: a warmed service reports 0.

Not in this arm yet (``ROADMAP.md``): the tenants, chaos, crash-restart,
hedge-chaos, ops-scrape and fleet scenarios of the JAX tool.

Usage:
    python3 tools/torch_loadgen.py --mode closed --concurrency 8 --duration 5
    python3 tools/torch_loadgen.py --service ann --clusters 64 --k 100 --tuned
    python3 tools/torch_loadgen.py --device cpu --index-rows 2000 --dim 16 --duration 1
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import threading
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

import numpy as np  # noqa: E402


def _percentile(sorted_vals, q):
    if not sorted_vals:
        return 0.0
    i = min(len(sorted_vals) - 1, max(0, int(round(q * (len(sorted_vals) - 1)))))
    return sorted_vals[i]


def _build_moves():
    from raft_tpu_torch.ops import _build

    st = _build.stats()
    return st["builds"] + st["loads"]


def synth_data(index_rows, dim, seed=0, clusters=0, cluster_std=0.3):
    """The JAX tool's reference matrix: i.i.d. Gaussian rows, or a
    Gaussian mixture of ``clusters`` centres."""
    rng = np.random.default_rng(seed)
    if clusters <= 0:
        return rng.standard_normal((index_rows, dim)).astype(np.float32)
    centers = rng.standard_normal((clusters, dim)).astype(np.float32)
    assign = rng.integers(0, clusters, index_rows)
    return (centers[assign] + cluster_std * rng.standard_normal((index_rows, dim))
            ).astype(np.float32)


def make_query_pool(ref, rows, n=32, seed=1, noise=0.1):
    """Query blocks drawn near the data (perturbed reference rows)."""
    rng = np.random.default_rng(seed)
    picks = rng.integers(0, ref.shape[0], (n, rows))
    return [(ref[p] + noise * rng.standard_normal((rows, ref.shape[1]))).astype(np.float32)
            for p in picks]


def build_service(kind, index_rows, dim, k, *, device, seed=0, clusters=0, nlist=None,
                  nprobe=None, train_rows=None, ooc=False, device_budget_mb=None,
                  select_impl=None, **opts):
    """A ready (not yet warmed) service over synthetic data, its reference
    matrix attached as ``loadgen_ref`` for the recall truth."""
    from raft_tpu_torch.serve import ANNService, KNNService, PairwiseService

    ref = synth_data(index_rows, dim, seed=seed, clusters=clusters)
    if kind == "knn":
        svc = KNNService(ref, k=k, device=device, **opts)
    elif kind == "pairwise":
        svc = PairwiseService(ref, device=device, **opts)
    elif kind == "ann":
        from raft_tpu_torch.spatial.ann import IVFFlatParams, ivf_flat_build

        if nlist is None:
            nlist = max(16, min(4096, int(round(index_rows ** 0.5))))
        params = IVFFlatParams(nlist=int(nlist), nprobe=int(nprobe) if nprobe else 8)
        index = ivf_flat_build(ref, params, train_rows=train_rows, device=device)
        if ooc:
            store = int(index.slot_vecs.numel() * index.slot_vecs.element_size())
            budget = int(device_budget_mb) << 20 if device_budget_mb else store // 4
            opts = dict(opts, ooc=True, device_budget_bytes=budget)
        svc = ANNService(index, k, select_impl=select_impl, device=device, **opts)
    else:
        raise SystemExit("unknown --service %r" % kind)
    svc.loadgen_ref = ref
    return svc


def _ground_truth(service, pool, k):
    """Exact neighbour ids of every pool block, once a run."""
    from raft_tpu_torch.spatial.knn import brute_force_knn

    cat = np.concatenate(pool, axis=0)
    _, ids = brute_force_knn(service.loadgen_ref, cat, k, device=service.device)
    ids = ids.cpu().numpy()
    n = pool[0].shape[0]
    return [ids[j * n:(j + 1) * n] for j in range(len(pool))]


def run_load(service, *, mode="closed", duration=5.0, concurrency=8, qps=100.0, rows=4,
             seed=0, deadline=None, recall=False, query_pool=None):
    """Drive ``service`` for ``duration`` seconds; returns the report.
    Rejected submits and expired deadlines are counted, not raised."""
    from raft_tpu_torch.core.error import ServiceOverloadError

    rng = np.random.default_rng(seed)
    if query_pool is not None:
        pool = list(query_pool)
        rows = int(pool[0].shape[0])
    else:
        pool = [rng.standard_normal((rows, service.dim)).astype(np.float32)
                for _ in range(32)]
    recall_k = getattr(service, "k", None)
    gt = _ground_truth(service, pool, recall_k) if recall else None
    lock = threading.Lock()
    latencies = []
    counts = {"ok": 0, "rejected": 0, "errors": 0}
    recall_acc = {"sum": 0.0, "n": 0}
    stop_t = time.monotonic() + duration

    def one_request(i):
        q = pool[i % len(pool)]
        t0 = time.monotonic()
        try:
            out = service.submit(q, timeout=deadline).result(timeout=max(30.0, duration))
        except ServiceOverloadError:
            with lock:
                counts["rejected"] += 1
            return
        except Exception:  # counted: the error rate is a reported number
            with lock:
                counts["errors"] += 1
            return
        dt = time.monotonic() - t0
        r = None
        if gt is not None:
            got = out[1].cpu().numpy()
            want = gt[i % len(pool)]
            r = float(np.mean([len(set(got[j]) & set(want[j])) / recall_k
                               for j in range(got.shape[0])]))
        with lock:
            counts["ok"] += 1
            latencies.append(dt)
            if r is not None:
                recall_acc["sum"] += r
                recall_acc["n"] += 1

    spawned = []
    if mode == "closed":
        def client(tid):
            i = tid
            while time.monotonic() < stop_t:
                one_request(i)
                i += concurrency

        threads = [threading.Thread(target=client, args=(t,), daemon=True)
                   for t in range(concurrency)]
    elif mode == "open":
        period = 1.0 / qps

        def pacer():
            i, next_t = 0, time.monotonic()
            while time.monotonic() < stop_t:
                t = threading.Thread(target=one_request, args=(i,), daemon=True)
                t.start()
                spawned.append(t)
                i += 1
                next_t += period
                delay = next_t - time.monotonic()
                if delay > 0:
                    time.sleep(delay)

        threads = [threading.Thread(target=pacer, daemon=True)]
    else:
        raise SystemExit("unknown --mode %r" % mode)

    moves0 = _build_moves()
    t_start = time.monotonic()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=duration + 60.0)
    for t in spawned:
        t.join(timeout=60.0)
    wall = time.monotonic() - t_start
    lat = sorted(latencies)
    report = {
        "mode": mode,
        "duration_s": round(wall, 3),
        "requests_ok": counts["ok"],
        "rejected": counts["rejected"],
        "errors": counts["errors"],
        "qps": round(counts["ok"] / wall, 2) if wall else 0.0,
        "query_qps": round(counts["ok"] * rows / wall, 2) if wall else 0.0,
        "p50_ms": round(_percentile(lat, 0.50) * 1e3, 3),
        "p95_ms": round(_percentile(lat, 0.95) * 1e3, 3),
        "p99_ms": round(_percentile(lat, 0.99) * 1e3, 3),
        "post_warmup_compiles": _build_moves() - moves0,
    }
    if gt is not None:
        report["recall_at_k"] = (round(recall_acc["sum"] / recall_acc["n"], 4)
                                 if recall_acc["n"] else 0.0)
        report["recall_k"] = int(recall_k)
    return report


def _apply_table(args):
    """``--tuned``: load the table (``--table PATH`` or discovery by
    fingerprint) and return its summary; ``--untuned``: clear any."""
    from raft_tpu_torch import config

    if args.untuned:
        config.clear_tuning_table()
        return None
    if not args.tuned:
        return config.tuning_table_info()
    path = args.table or config.discover_tuning_table()
    if path is None:
        raise SystemExit("--tuned: no tuning table matches this backend; sweep it with "
                         "tools/torch_autotune.py or pass --table PATH")
    if not config.load_tuning_table(path):
        raise SystemExit("--tuned: %s is not this backend's table" % path)
    return config.tuning_table_info()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--service", choices=("knn", "pairwise", "ann"), default="knn")
    p.add_argument("--mode", choices=("closed", "open"), default="closed")
    p.add_argument("--duration", type=float, default=5.0)
    p.add_argument("--concurrency", type=int, default=8)
    p.add_argument("--qps", type=float, default=100.0)
    p.add_argument("--rows", type=int, default=4)
    p.add_argument("--index-rows", type=int, default=50000)
    p.add_argument("--dim", type=int, default=64)
    p.add_argument("--k", type=int, default=10)
    p.add_argument("--clusters", type=int, default=0)
    p.add_argument("--nlist", type=int, default=None)
    p.add_argument("--nprobe", type=int, default=None)
    p.add_argument("--train-rows", type=int, default=None)
    p.add_argument("--recall", action="store_true")
    p.add_argument("--recall-target", type=float, default=None)
    p.add_argument("--ooc", action="store_true")
    p.add_argument("--device-budget-mb", type=int, default=None)
    p.add_argument("--select-impl", choices=("kernel", "sort"), default=None)
    table = p.add_mutually_exclusive_group()
    table.add_argument("--tuned", action="store_true")
    table.add_argument("--untuned", action="store_true")
    p.add_argument("--table", default=None, help="the table --tuned loads")
    p.add_argument("--deadline", type=float, default=None)
    p.add_argument("--max-batch-rows", type=int, default=256)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda")
    p.add_argument("--json", action="store_true")
    args = p.parse_args(argv)

    info = _apply_table(args)
    if args.select_impl is not None and args.service != "ann":
        raise SystemExit("--select-impl applies to the ANN service")
    service = build_service(args.service, args.index_rows, args.dim, args.k,
                            device=args.device, seed=args.seed, clusters=args.clusters,
                            nlist=args.nlist, nprobe=args.nprobe, train_rows=args.train_rows,
                            ooc=args.ooc, device_budget_mb=args.device_budget_mb,
                            select_impl=args.select_impl, max_batch_rows=args.max_batch_rows)
    want_recall = args.recall or args.service == "ann"
    t0 = time.monotonic()
    try:
        service.warmup()
        warmup_s = time.monotonic() - t0
        pool = make_query_pool(service.loadgen_ref, args.rows, seed=args.seed + 1) \
            if want_recall else None
        calibration = None
        if args.recall_target is not None and args.service == "ann":
            calibration = service.calibrate(np.concatenate(pool[:8], axis=0),
                                            args.recall_target)
        report = run_load(service, mode=args.mode, duration=args.duration,
                          concurrency=args.concurrency, qps=args.qps, rows=args.rows,
                          seed=args.seed, deadline=args.deadline, recall=want_recall,
                          query_pool=pool)
    finally:
        service.close()
    report["warmup_s"] = round(warmup_s, 3)
    report["buckets"] = list(service.policy.rungs)
    report["device"] = str(service.device)
    report["tuning_table"] = info
    if args.service == "ann":
        report["nprobe"] = service.nprobe
        report["select_impl"] = args.select_impl
    if calibration is not None:
        report["calibration"] = calibration
    if args.json:
        print(json.dumps(report, indent=2, sort_keys=True, default=str))
        return 0
    print("== torch_loadgen: %s %s on %s ==" % (args.service, args.mode, report["device"]))
    for key in ("duration_s", "requests_ok", "rejected", "errors", "qps", "query_qps",
                "recall_at_k", "recall_k", "nprobe", "select_impl", "p50_ms", "p95_ms",
                "p99_ms", "post_warmup_compiles", "warmup_s", "buckets", "tuning_table"):
        if key in report:
            val = report[key]
            print("  %-20s %s" % (key, "%.3f" % val if isinstance(val, float) else val))
    return 0


if __name__ == "__main__":
    sys.exit(main())
