#!/usr/bin/env python3
"""Load generator for raft_tpu_torch's services.

The port's arm of ``tools/loadgen.py``: drives a
:class:`raft_tpu_torch.serve.KNNService`, ``PairwiseService`` or
``ANNService`` with synthetic traffic and reports client-observed
latency percentiles beside the padding-waste and batch-fill numbers of
the metrics registry, under the JAX report's keys.

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
budget (``--ooc-sync``: the synchronous-prefetch arm).  ``--select-impl
kernel|sort`` pins the ANN service's selections (the registry's
``select_impl``); ``--tuned`` loads the tuning table
(``RAFT_TPU_TUNING_TABLE``'s rule: ``auto`` by default, or ``--table
PATH``) and ``--untuned`` runs with none, so two runs are an A/B of the
table.  ``--mesh N`` serves sharded over a world of N rank slots on
``--device`` (``--merge`` picks the cross-shard merge); ``--replicas R``
serves R replicas of the kNN index with hedged dispatch.

The scenarios (each exits 1 when its invariant fails):

- ``--chaos``: seeded transient faults at the serve seam for the whole
  run, a persistent outage mid-run (the simulated device loss) and
  recovery through :class:`~raft_tpu_torch.serve.resilience.RecoveryManager`;
  every submitted request resolves exactly once, with a result or a
  typed ``RaftError``.  ``--kill-shard`` (with ``--mesh N >= 2``) makes
  the outage the loss of the last rank slot: recovery re-partitions the
  index over the survivors, and a post-heal answer is held exactly to
  ``brute_force_knn``.
- ``--hedge-chaos`` (with ``--replicas >= 2``): one replica straggles
  under a persistent ``Delay``; hedges fire and win, losers are
  cancelled, and nothing is built after warmup.
- ``--tenants``: closed-loop interactive clients beside an open-loop
  bulk flood through weighted-fair admission (``--tenant-weights``,
  ``--bulk-qps``, ``--bulk-rows``); every shed is typed and carries
  ``retry_after_s``.
- ``--crash-restart`` (``--service ann``): a persistent ANN service (WAL
  ``fsync="always"``) under query and insert traffic dies with no final
  snapshot and is rebuilt from ``--persist-dir`` alone: no acknowledged
  insert lost, the search bitwise equal to a reference kept from the
  live service, typed errors only, no kernel built after the restore's
  warmup.
- ``--ops-port P``: a baseline window, then the same load with an
  :class:`~raft_tpu_torch.serve.opsplane.OpsPlane` on port P (0 =
  ephemeral) scraped at 1 Hz, ``/metrics`` parsed back.
- ``--fleet``: a router and ``--fleet-workers`` worker processes under a
  seeded :class:`~raft_tpu_torch.fleet.chaos.ChaosSchedule` (``--no-chaos``
  for steady traffic; ``--fleet-mode``): no acknowledged row lost, one
  terminal per admitted request, every worker active again.

``--trace [K]`` prints the K slowest requests' waterfalls (with
``--fleet``, the cross-process ones); ``--trace-dump PATH`` writes the
flight recorder for ``tools/torch_trace_report.py``.  A chaos scenario
that fails writes its black-box dump under ``build/loadgen/``.

``post_warmup_compiles`` counts the kernel libraries built or loaded
during the window (``ops/_build.py:stats``), the port's analogue of the
JAX report's compile-cache misses: a warmed service reports 0.
``host_staged_bytes`` counts the bytes staged through host memory during
the window (the JAX report reads the process's total).

Everything runs on the card unless ``--device cpu`` is given; without a
card the tool exits 2.  Importable: the ``run_*`` functions return the
report dicts (``chip_smoke.py``'s ``loadgen_paths`` and the tests call
them).

Usage:
    python3 tools/torch_loadgen.py --mode closed --concurrency 8 --duration 5
    python3 tools/torch_loadgen.py --service ann --clusters 64 --k 100 --tuned
    python3 tools/torch_loadgen.py --chaos --mesh 4 --kill-shard --duration 3
    python3 tools/torch_loadgen.py --device cpu --index-rows 2000 --dim 16 --duration 1
"""

from __future__ import annotations

import argparse
import heapq
import itertools
import json
import os
import shutil
import sys
import tempfile
import threading
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

import numpy as np  # noqa: E402

# where a failed scenario leaves its flight-recorder dump
DUMP_DIR = os.path.join(REPO, "build", "loadgen")


def _percentile(sorted_vals, q):
    if not sorted_vals:
        return 0.0
    i = min(len(sorted_vals) - 1, max(0, int(round(q * (len(sorted_vals) - 1)))))
    return sorted_vals[i]


def _np(x):
    """A result tensor (any device) or array as numpy."""
    return x.cpu().numpy() if hasattr(x, "cpu") else np.asarray(x)


def _build_moves():
    """Kernel libraries built or loaded so far (the steady-state proof:
    none new after warmup)."""
    from raft_tpu_torch.ops import _build

    st = _build.stats()
    return st["builds"] + st["loads"]


def _reg_total(name):
    from raft_tpu_torch.core.metrics import default_registry

    return default_registry().family_total(name)


def _staged_bytes():
    return int(_reg_total("raft_tpu_comms_host_staged_bytes"))


def _ooc_pool_totals(service_name):
    """Pool-labelled out-of-core counters of one service (pool name ==
    service name) and the host-staged bytes: the baseline the report
    subtracts, so warmup's tile streams do not count in the window."""
    from raft_tpu_torch.core.metrics import default_registry

    reg = default_registry()

    def series_for(name):
        fam = reg.get(name)
        if fam is None:
            return None
        for labels, series in fam.series():
            if labels.get("pool") == service_name:
                return series
        return None

    out = {}
    for key, name, attr in (
            ("hits", "raft_tpu_tile_hits_total", "value"),
            ("misses", "raft_tpu_tile_misses_total", "value"),
            ("h2d_bytes", "raft_tpu_h2d_bytes_total", "value"),
            ("h2d_s", "raft_tpu_h2d_seconds", "total"),
            ("stall_s", "raft_tpu_h2d_stall_seconds", "total")):
        s = series_for(name)
        out[key] = float(getattr(s, attr)) if s is not None else 0.0
    out["present"] = any(out[k] for k in ("hits", "misses", "h2d_bytes"))
    out["staged"] = _staged_bytes()
    return out


def _registry_serve_stats(service_name, ooc_base=None):
    """Padding waste and batch fill of one service, read back from the
    metrics registry (the server side; the loops measure the client
    side).  ``ooc_base`` (a pre-run :func:`_ooc_pool_totals`) turns the
    out-of-core counters and the staged bytes into window deltas."""
    from raft_tpu_torch.core.metrics import default_registry

    reg = default_registry()

    def _value(name):
        fam = reg.get(name)
        if fam is None:
            return 0.0
        for labels, series in fam.series():
            if labels.get("service") == service_name:
                return series.value
        return 0.0

    payload = _value("raft_tpu_serve_payload_rows_total")
    padded = _value("raft_tpu_serve_padded_rows_total")
    batches = _value("raft_tpu_serve_batches_total")
    total = payload + padded
    out = {
        "batches": int(batches),
        "payload_rows": int(payload),
        "padded_rows": int(padded),
        "padding_waste": (padded / total) if total else 0.0,
        "mean_batch_rows": (payload / batches) if batches else 0.0,
    }
    fam = reg.get("raft_tpu_serve_wait_seconds")
    if fam is not None:
        for labels, series in fam.series():
            if labels.get("service") == service_name:
                out["queue_wait_p50_ms"] = series.quantile(0.50) * 1e3
                out["queue_wait_p95_ms"] = series.quantile(0.95) * 1e3
    base = ooc_base or {}
    out["host_staged_bytes"] = _staged_bytes() - int(base.get("staged", 0))
    now = _ooc_pool_totals(service_name)
    if now["present"]:
        hits = now["hits"] - base.get("hits", 0.0)
        miss = now["misses"] - base.get("misses", 0.0)
        out["tile_hits"] = int(hits)
        out["tile_misses"] = int(miss)
        out["tile_hit_rate"] = hits / (hits + miss) if hits + miss else 0.0
        out["h2d_mb"] = round((now["h2d_bytes"] - base.get("h2d_bytes", 0.0)) / 1e6, 1)
        h2d_t = now["h2d_s"] - base.get("h2d_s", 0.0)
        stall_t = now["stall_s"] - base.get("stall_s", 0.0)
        out["hidden_transfer_frac"] = round(1.0 - stall_t / h2d_t, 3) if h2d_t else 0.0
    return out


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
    """Query blocks drawn near the data (perturbed reference rows), as
    float32 numpy arrays; ``ref`` may be a tensor on any device."""
    rng = np.random.default_rng(seed)
    picks = rng.integers(0, ref.shape[0], (n, rows))
    if hasattr(ref, "cpu"):
        import torch

        picked = ref[torch.from_numpy(picks.reshape(-1)).to(ref.device)].cpu().numpy()
        blocks = picked.reshape(n, rows, -1)
    else:
        base = np.asarray(ref)
        blocks = [base[p] for p in picks]
    return [(b + noise * rng.standard_normal((rows, ref.shape[1]))).astype(np.float32)
            for b in blocks]


def _gaussian_pool(rng, rows, dim, n):
    return [rng.standard_normal((rows, dim)).astype(np.float32) for _ in range(n)]


def world_mesh(n, device):
    """A 1-D mesh of ``n`` rank slots on ``device``: on one card, a world
    of N slots sharing it (``comms/mesh.py:default_mesh`` gives one slot
    a card)."""
    from raft_tpu_torch.comms.mesh import AXIS, Mesh
    from raft_tpu_torch.core.device import resolve_device

    return Mesh([resolve_device(device)] * int(n), (AXIS,))


def build_service(kind, index_rows, dim, k, *, device, seed=0, clusters=0, nlist=None,
                  nprobe=None, train_rows=None, mesh_devices=None, replicas=None, ooc=False,
                  device_budget_mb=None, select_impl=None, **opts):
    """A ready (not yet warmed) service over synthetic data, its reference
    matrix attached as ``loadgen_ref`` for the recall truth.

    ``mesh_devices=N`` serves sharded (kNN and ANN) over a world of N
    rank slots on ``device`` (``merge=`` in ``opts`` picks the merge);
    ``replicas=R`` (kNN) serves R replicas over disjoint sub-meshes of a
    world of ``mesh_devices`` slots (default R), hedged.  ``ooc=True``
    (ANN) serves the out-of-core tier under ``device_budget_mb`` (default
    a quarter of the slot store)."""
    from raft_tpu_torch.serve import ANNService, KNNService, PairwiseService

    if replicas is not None:
        if kind != "knn":
            raise SystemExit("--replicas applies to the replicated service (knn)")
        mesh = world_mesh(mesh_devices if mesh_devices is not None else replicas, device)
        opts = dict(opts, mesh=mesh, axis=mesh.axis_names[0], replicas=int(replicas))
    elif mesh_devices is not None:
        if kind not in ("knn", "ann"):
            raise SystemExit("--mesh applies to the sharded services (knn/ann)")
        mesh = world_mesh(mesh_devices, device)
        opts = dict(opts, mesh=mesh, axis=mesh.axis_names[0])
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


def _ground_truth_for_pool(service, pool, k):
    """Exact neighbour ids of every pool block, once a run, from the
    service's own content: ``loadgen_ref``, else the store and live delta
    (``ANNService.ground_truth_store``), else the pinned index."""
    from raft_tpu_torch.spatial.knn import brute_force_knn

    ref = getattr(service, "loadgen_ref", None)
    if ref is not None:
        vecs, ids = ref, None
    elif hasattr(service, "ground_truth_store"):
        vecs, ids = service.ground_truth_store()
    elif hasattr(service, "index"):
        vecs, ids = service.index, None
    else:
        raise SystemExit("recall requested but %s exposes no reference data" % service.name)
    cat = np.concatenate([_np(p) for p in pool], axis=0)
    _, rows_idx = brute_force_knn(vecs, cat, k, device=service.device)
    rows_idx = _np(rows_idx)
    gt = rows_idx if ids is None else np.asarray(ids)[rows_idx]
    n = pool[0].shape[0]
    return [gt[j * n:(j + 1) * n] for j in range(len(pool))]


def _join(threads, timeout):
    """Join every thread within ``timeout`` seconds in all; True when all
    ended."""
    end = time.monotonic() + timeout
    for t in threads:
        t.join(max(0.0, end - time.monotonic()))
    return not any(t.is_alive() for t in threads)


def _score(admitted, timeout=30.0):
    """Resolve every admitted future: ok, typed (``RaftError``), untyped,
    or lost (unresolved within ``timeout`` seconds in all)."""
    from raft_tpu_torch.core.error import RaftError

    results = {"ok": 0, "typed_errors": 0, "untyped_errors": 0, "lost": 0}
    end = time.monotonic() + timeout
    for fut in admitted:
        if not fut.wait(timeout=max(0.0, end - time.monotonic())):
            results["lost"] += 1
            continue
        err = fut.exception(timeout=0)
        if err is None:
            results["ok"] += 1
        elif isinstance(err, RaftError):
            results["typed_errors"] += 1
        else:
            results["untyped_errors"] += 1
    return results


def run_load(service, *, mode="closed", duration=5.0, concurrency=8, qps=100.0, rows=4,
             seed=0, deadline=None, recall=False, query_pool=None, tenant=None, trace_k=0):
    """Drive ``service`` for ``duration`` seconds; returns the report.
    Rejected submits and expired deadlines are counted, not raised.
    ``recall=True`` scores every answer against a brute-force truth;
    ``tenant`` tags every submit; ``trace_k > 0`` keeps the K slowest
    requests' timelines (``slow_traces``)."""
    from raft_tpu_torch.core.error import ServiceOverloadError

    rng = np.random.default_rng(seed)
    if query_pool is not None:
        pool = list(query_pool)
        row_counts = {int(p.shape[0]) for p in pool}
        if len(row_counts) != 1:
            raise SystemExit("query_pool blocks must share a row count")
        rows = row_counts.pop()
    else:
        pool = _gaussian_pool(rng, rows, service.dim, 32)
    recall_k = getattr(service, "k", None)
    gt = None
    if recall:
        if recall_k is None:
            raise SystemExit("recall requested but %s has no k (not a kNN-shaped service)"
                             % service.name)
        gt = _ground_truth_for_pool(service, pool, recall_k)
    lock = threading.Lock()
    latencies = []
    counts = {"ok": 0, "rejected": 0, "errors": 0}
    recall_acc = {"sum": 0.0, "n": 0}
    slow_heap, slow_seq = [], itertools.count()
    stop = threading.Event()
    stop_t = time.monotonic() + duration

    def running():
        return time.monotonic() < stop_t and not stop.is_set()

    def one_request(i):
        q = pool[i % len(pool)]
        t0 = time.monotonic()
        try:
            fut = service.submit(q, timeout=deadline, tenant=tenant)
            out = fut.result(timeout=max(30.0, duration))
        except ServiceOverloadError:
            with lock:
                counts["rejected"] += 1
            return
        except Exception:  # noqa: BLE001 — counted: the error rate is a reported number
            with lock:
                counts["errors"] += 1
            return
        dt = time.monotonic() - t0
        if trace_k:
            with lock:
                item = (dt, next(slow_seq), fut)
                if len(slow_heap) < trace_k:
                    heapq.heappush(slow_heap, item)
                elif dt > slow_heap[0][0]:
                    heapq.heapreplace(slow_heap, item)
        r = None
        if gt is not None:
            got = _np(out[1])
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
            while running():
                one_request(i)
                i += concurrency

        threads = [threading.Thread(target=client, args=(t,), daemon=True)
                   for t in range(concurrency)]
    elif mode == "open":
        period = 1.0 / qps

        def pacer():
            i, next_t = 0, time.monotonic()
            while running():
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
    ooc_base = _ooc_pool_totals(service.name)
    t_start = time.monotonic()
    try:
        for t in threads:
            t.start()
        _join(threads, duration + 60.0)
        _join(list(spawned), 60.0)
    finally:
        stop.set()
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
    if trace_k:
        slow = []
        for dt, _, fut in sorted(slow_heap, reverse=True):
            tr = fut.trace()
            slow.append({"latency_ms": round(dt * 1e3, 3),
                         "trace_id": tr.trace_id if tr is not None else None,
                         "timeline": tr.timeline() if tr is not None else []})
        report["slow_traces"] = slow
    report.update(_registry_serve_stats(service.name, ooc_base=ooc_base))
    return report


def run_ops_scrape(service, *, port=0, duration=6.0, concurrency=8, rows=4, seed=0,
                   query_pool=None, scrape_hz=1.0, timings=None):
    """Steady load with a live ops plane scraped: a baseline window, then
    the same load with an :class:`~raft_tpu_torch.serve.opsplane.OpsPlane`
    and a ``scrape_hz`` scraper pulling ``/metrics`` (parsed back: garbage
    counts as a failure) and ``/healthz``.  ``ops_ok``: every scrape
    succeeded, the scraped window built nothing, and its QPS held at
    >= 0.6x the baseline's.  ``timings`` gets both windows' full
    :func:`run_load` reports (``baseline``, ``scraped``)."""
    import urllib.error
    import urllib.request

    from raft_tpu_torch.core.metrics import parse_prometheus
    from raft_tpu_torch.serve.opsplane import OpsPlane

    per_window = max(1.0, duration / 2)
    baseline = run_load(service, mode="closed", duration=per_window, concurrency=concurrency,
                        rows=rows, seed=seed, query_pool=query_pool)
    scrape_stats = {"n": 0, "failures": 0, "latencies": []}
    stop = threading.Event()
    plane = OpsPlane(services={service.name: service}, port=port)
    bound_port = plane.port   # read before close() drops the socket

    def scraper():
        url = plane.url
        while not stop.is_set():
            t0 = time.monotonic()
            try:
                with urllib.request.urlopen(url + "/metrics", timeout=5) as resp:
                    parsed = parse_prometheus(resp.read().decode("utf-8"))
                if "raft_tpu_serve_requests_total" not in parsed:
                    raise ValueError("scrape missing serve families")
                try:
                    urllib.request.urlopen(url + "/healthz", timeout=5).close()
                except urllib.error.HTTPError:
                    pass    # 503 while degraded is still a served scrape
            except Exception:  # noqa: BLE001 — counted: a failed scrape is the outcome
                scrape_stats["failures"] += 1
            scrape_stats["n"] += 1
            scrape_stats["latencies"].append(time.monotonic() - t0)
            stop.wait(timeout=1.0 / scrape_hz)

    thread = threading.Thread(target=scraper, daemon=True)
    thread.start()
    try:
        scraped = run_load(service, mode="closed", duration=per_window,
                           concurrency=concurrency, rows=rows, seed=seed,
                           query_pool=query_pool)
    finally:
        stop.set()
        thread.join(timeout=10.0)
        plane.close()
    if timings is not None:
        timings.update(baseline=baseline, scraped=scraped)
    lat = sorted(scrape_stats["latencies"])
    ratio = scraped["qps"] / baseline["qps"] if baseline["qps"] else 0.0
    report = {
        "baseline_qps": baseline["qps"],
        "scraped_qps": scraped["qps"],
        "qps_ratio": round(ratio, 4),
        "scrapes": scrape_stats["n"],
        "scrape_failures": scrape_stats["failures"],
        "scrape_p95_ms": round(_percentile(lat, 0.95) * 1e3, 3),
        "post_warmup_compiles": scraped["post_warmup_compiles"],
        "p99_ms": scraped["p99_ms"],
        "ops_port": bound_port,
        "ops_ok": (scrape_stats["n"] > 0 and scrape_stats["failures"] == 0
                   and scraped["post_warmup_compiles"] == 0 and ratio >= 0.6),
    }
    report.update({k: v for k, v in scraped.items()
                   if k in ("host_staged_bytes", "requests_ok", "rejected", "errors")})
    return report


def run_mixed_tenants(service, *, duration=5.0, interactive_concurrency=4, bulk_qps=200.0,
                      interactive_rows=4, bulk_rows=32, seed=0,
                      interactive_tenant="interactive", bulk_tenant="bulk", deadline=None):
    """Closed-loop interactive clients beside an open-loop bulk flood
    through one weighted-fair service (construct it with
    ``tenant_weights`` naming both).  Reports per-tenant p50/p95/p99 and
    shed counts; ``untyped_sheds`` counts sheds that were not typed or
    carried no drain estimate (``retry_after_s``) or tenant."""
    from raft_tpu_torch.core.error import ServiceOverloadError, ServiceUnavailableError

    rng = np.random.default_rng(seed)
    pools = {interactive_tenant: _gaussian_pool(rng, interactive_rows, service.dim, 16),
             bulk_tenant: _gaussian_pool(rng, bulk_rows, service.dim, 16)}
    lock = threading.Lock()
    stats = {t: {"ok": 0, "rejected": 0, "unavailable": 0, "errors": 0, "latencies": []}
             for t in pools}
    untyped = {"sheds": 0}
    stop = threading.Event()
    stop_t = time.monotonic() + duration

    def running():
        return time.monotonic() < stop_t and not stop.is_set()

    def one_request(tenant, i):
        q = pools[tenant][i % 16]
        st = stats[tenant]
        t0 = time.monotonic()
        try:
            fut = service.submit(q, timeout=deadline, tenant=tenant)
            fut.result(timeout=max(30.0, duration))
        except (ServiceOverloadError, ServiceUnavailableError) as e:
            with lock:
                st["rejected" if isinstance(e, ServiceOverloadError) else "unavailable"] += 1
                # an overload shed carries a real drain estimate and names
                # its tenant; 0.0 means a shed site skipped the hint
                if isinstance(e, ServiceOverloadError) and (
                        e.retry_after_s <= 0.0 or e.tenant is None):
                    untyped["sheds"] += 1
            return
        except Exception:  # noqa: BLE001 — counted per tenant
            with lock:
                st["errors"] += 1
            return
        dt = time.monotonic() - t0
        with lock:
            st["ok"] += 1
            st["latencies"].append(dt)

    def interactive_client(tid):
        i = tid
        while running():
            one_request(interactive_tenant, i)
            i += interactive_concurrency

    spawned = []

    def bulk_pacer():
        period = 1.0 / bulk_qps
        i, next_t = 0, time.monotonic()
        while running():
            t = threading.Thread(target=one_request, args=(bulk_tenant, i), daemon=True)
            t.start()
            spawned.append(t)
            i += 1
            next_t += period
            delay = next_t - time.monotonic()
            if delay > 0:
                time.sleep(delay)

    threads = ([threading.Thread(target=interactive_client, args=(t,), daemon=True)
                for t in range(interactive_concurrency)]
               + [threading.Thread(target=bulk_pacer, daemon=True)])
    moves0 = _build_moves()
    ooc_base = _ooc_pool_totals(service.name)
    t_start = time.monotonic()
    try:
        for t in threads:
            t.start()
        _join(threads, duration + 60.0)
        _join(list(spawned), 60.0)
    finally:
        stop.set()
    wall = time.monotonic() - t_start
    report = {"mode": "mixed-tenants", "duration_s": round(wall, 3),
              "post_warmup_compiles": _build_moves() - moves0,
              "untyped_sheds": untyped["sheds"], "tenants": {}}
    for tenant, st in stats.items():
        lat = sorted(st["latencies"])
        report["tenants"][tenant] = {
            "requests_ok": st["ok"],
            "rejected": st["rejected"],
            "unavailable": st["unavailable"],
            "errors": st["errors"],
            "qps": round(st["ok"] / wall, 2) if wall else 0.0,
            "p50_ms": round(_percentile(lat, 0.50) * 1e3, 3),
            "p95_ms": round(_percentile(lat, 0.95) * 1e3, 3),
            "p99_ms": round(_percentile(lat, 0.99) * 1e3, 3),
        }
    report.update(_registry_serve_stats(service.name, ooc_base=ooc_base))
    return report


def _new_timings(timings):
    """The dict a scenario fills, beside its report, with what the JAX
    report leaves out: the rows answered, each answered request's client
    latency and the window's seconds (``timings=`` of the ``run_*``
    functions; ``chip_smoke.py`` reads rows/s, p50 and p99 from it)."""
    out = timings if timings is not None else {}
    out.update(rows=0, latencies_s=[], window_s=0.0)
    return out


def _closed_chaos_clients(service, pool, concurrency, stop, lock, admitted, counts,
                          shed_key, wait_s, timings):
    """The scenarios' closed-loop clients: submit, count a typed shed
    under ``shed_key(exc)`` and back off, or keep the future and wait for
    it (bounded) before the next; an answer within the wait adds its rows
    and latency to ``timings``.  Daemon threads, started."""
    from raft_tpu_torch.core.error import RaftError

    def client(tid):
        i = tid
        while not stop.is_set():
            q = pool[i % len(pool)]
            i += concurrency
            t0 = time.monotonic()
            try:
                fut = service.submit(q)
            except RaftError as e:
                key = shed_key(e)
                if key is None:
                    raise
                with lock:
                    counts[key] += 1
                time.sleep(0.01)    # shed: back off, as a client would
                continue
            with lock:
                counts["submitted"] += 1
                admitted.append(fut)
            if fut.wait(timeout=wait_s) and fut.exception(timeout=0) is None:
                dt = time.monotonic() - t0
                with lock:
                    timings["rows"] += int(q.shape[0])
                    timings["latencies_s"].append(dt)

    threads = [threading.Thread(target=client, args=(t,), daemon=True)
               for t in range(concurrency)]
    for t in threads:
        t.start()
    return threads


def _stop_after(stop, duration, t0):
    """A timer thread that sets ``stop`` ``duration`` seconds after
    ``t0`` (the clients' closed loop ends on the event)."""
    def fire():
        stop.wait(max(0.0, t0 + duration - time.monotonic()))
        stop.set()

    t = threading.Thread(target=fire, daemon=True)
    t.start()
    return t


def run_hedge_chaos(service, *, duration=5.0, concurrency=4, rows=4, seed=0, delay_s=0.4,
                    delay_at=0.25, delay_for=0.5, query_pool=None, timings=None):
    """Closed-loop traffic against a replicated service while replica 0
    straggles under a persistent ``Delay`` for the middle ``delay_for``
    of the run.  ``chaos_ok``: every admitted request resolved exactly
    once with a result or typed error, ``hedge_wins > 0``, nothing built
    after warmup, no bytes staged through the host."""
    from raft_tpu_torch.comms import faults
    from raft_tpu_torch.serve.replicas import ReplicaFaultInjector

    if getattr(service, "_replica_set", None) is None:
        raise SystemExit("--hedge-chaos needs a replicated service (--replicas >= 2)")
    rng = np.random.default_rng(seed)
    pool = (list(query_pool) if query_pool is not None
            else _gaussian_pool(rng, rows, service.dim, 16))
    timings = _new_timings(timings)
    lock = threading.Lock()
    admitted = []
    counts = {"submitted": 0, "sheds": 0}
    stop = threading.Event()
    hedges0 = _reg_total("raft_tpu_serve_hedges_total")
    wins0 = _reg_total("raft_tpu_serve_hedge_wins_total")
    cancelled0 = _reg_total("raft_tpu_serve_hedge_cancelled_total")
    moves0 = _build_moves()
    staged0 = _staged_bytes()
    t0 = time.monotonic()
    threads = _closed_chaos_clients(service, pool, concurrency, stop, lock, admitted, counts,
                                    lambda e: "sheds", 10.0, timings)
    threads.append(_stop_after(stop, duration, t0))
    injector = None
    try:
        time.sleep(max(0.0, duration * delay_at))
        # the straggling replica: every batch it carries stalls long past
        # the hedge threshold
        injector = ReplicaFaultInjector(service, 0, [faults.Delay(delay_s)])
        injector.activate()
        time.sleep(duration * delay_for)
        injector.deactivate()
        injector = None
        _join(threads, duration + 30.0)
    finally:
        stop.set()
        if injector is not None:
            injector.deactivate()
        _join(threads, 30.0)
    timings["window_s"] = time.monotonic() - t0
    service.drain(timeout=30.0)
    results = _score(admitted)
    resolved = results["ok"] + results["typed_errors"] + results["untyped_errors"]
    wins = int(_reg_total("raft_tpu_serve_hedge_wins_total") - wins0)
    report = {
        "seed": seed,
        "duration_s": duration,
        "delay_s": delay_s,
        **counts,
        **results,
        "resolved": resolved,
        "exactly_once": results["lost"] == 0 and resolved == counts["submitted"],
        "typed_only": results["untyped_errors"] == 0,
        "hedges_fired": int(_reg_total("raft_tpu_serve_hedges_total") - hedges0),
        "hedge_wins": wins,
        "hedge_cancelled": int(_reg_total("raft_tpu_serve_hedge_cancelled_total")
                               - cancelled0),
        "post_warmup_compiles": _build_moves() - moves0,
        "host_staged_bytes": _staged_bytes() - staged0,
    }
    report["chaos_ok"] = (report["exactly_once"] and report["typed_only"] and wins > 0
                          and report["post_warmup_compiles"] == 0
                          and report["host_staged_bytes"] == 0)
    return report


def run_chaos(service, *, duration=6.0, concurrency=4, rows=4, seed=0, transient_p=0.05,
              outage_at=0.35, outage_s=0.8, manager=None, query_pool=None, kill_shard=False,
              timings=None):
    """Drive ``service`` closed-loop under seeded serve-seam faults:
    ``RandomFail(transient_p, seed)`` for the whole run, and from
    ``outage_at`` of it a persistent ``FailNth`` for ``outage_s`` seconds
    (the simulated device loss: the breaker trips, admission sheds,
    in-flight riders are re-enqueued once).  At the outage's end the fault
    detaches and ``manager.recover()`` runs when a
    :class:`~raft_tpu_torch.serve.resilience.RecoveryManager` is passed
    (else the breaker's half-open probe re-closes alone).  With
    ``kill_shard`` (sharded services) the outage is the loss of the
    mesh's last rank slot: the index is re-partitioned over the
    survivors, and ``post_recovery_exact`` holds a post-heal answer to
    ``brute_force_knn`` over the whole index, ids exactly.

    ``chaos_ok``: every submitted request resolved exactly once (``ok +
    typed_errors + untyped_errors == submitted``, ``lost == 0``) and
    every error is typed.  Sheds at admission are counted apart: a shed
    request was never admitted.  ``timings`` also gets ``recovery_s``,
    the seconds from the outage's end to the re-admission."""
    from raft_tpu_torch.comms import faults
    from raft_tpu_torch.core.error import (RaftError, ServiceOverloadError,
                                           ServiceUnavailableError)
    from raft_tpu_torch.serve.resilience import ServeFaultInjector

    if kill_shard and getattr(service, "axis", None) is None:
        raise SystemExit("--kill-shard needs a sharded service (--mesh N)")
    if kill_shard and int(service.mesh.shape[service.axis]) < 2:
        raise SystemExit("--kill-shard: nothing to kill on a 1-slot mesh")
    rng = np.random.default_rng(seed)
    if query_pool is not None:
        pool = list(query_pool)
        rows = int(pool[0].shape[0])
    else:
        pool = _gaussian_pool(rng, rows, service.dim, 16)
    timings = _new_timings(timings)
    lock = threading.Lock()
    admitted = []
    counts = {"submitted": 0, "rejected": 0, "unavailable": 0}

    def shed_key(e):
        if isinstance(e, ServiceUnavailableError):
            return "unavailable"
        if isinstance(e, ServiceOverloadError):
            return "rejected"
        return None

    trips0 = _reg_total("raft_tpu_serve_breaker_trips_total")
    recov0 = _reg_total("raft_tpu_serve_recoveries_total")
    requeue0 = _reg_total("raft_tpu_serve_requeued_total")
    stop = threading.Event()
    transient = ServeFaultInjector(
        service.worker, [faults.RandomFail(transient_p, seed=seed)] if transient_p > 0 else [])
    transient.activate()
    outage = None
    t0 = time.monotonic()
    threads = _closed_chaos_clients(service, pool, concurrency, stop, lock, admitted, counts,
                                    shed_key, 5.0, timings)
    threads.append(_stop_after(stop, duration, t0))
    try:
        time.sleep(max(0.0, duration * outage_at))
        outage = ServeFaultInjector(service.worker, [faults.FailNth(1, persistent=True)])
        outage.activate()
        time.sleep(outage_s)
        outage.deactivate()         # the survivors work again
        outage = None
        t_rec = time.monotonic()
        if kill_shard:
            # the outage was a shard loss: drop the last rank slot and
            # re-partition over the survivors, quiesced (a swap must never
            # tear a batch)
            survivors = service.mesh.submesh(service.mesh.rank_list()[:-1],
                                             service.mesh.axis_names)
            service.pause()
            service.worker.quiesce(timeout=15.0)
            service.repartition(mesh=survivors)
            service.resume()
        if manager is not None:
            manager.recover()       # re-publish, re-warm, re-admit
        timings["recovery_s"] = time.monotonic() - t_rec
        _join(threads, duration + 30.0)
    finally:
        stop.set()
        if outage is not None:
            outage.deactivate()
        transient.deactivate()
        _join(threads, 30.0)
    timings["window_s"] = time.monotonic() - t0
    post_exact = None
    if kill_shard:
        from raft_tpu_torch.serve import KNNService
        from raft_tpu_torch.spatial.knn import brute_force_knn

        if isinstance(service, KNNService):
            # the re-partitioned service answers as single-device brute
            # force over the same whole index (no rows lost with the
            # shard); a still-cooling breaker may shed the first probe
            probe_q = pool[0]
            for _attempt in range(2):
                try:
                    out = service.submit(probe_q).result(timeout=30.0)
                    break
                except RaftError:
                    time.sleep(max(0.05, service.breaker.retry_after())
                               if service.breaker is not None else 0.3)
            else:
                out = service.submit(probe_q).result(timeout=30.0)
            _, i_ref = brute_force_knn(service.index, probe_q, service.k, metric=service.metric,
                                       device=service.device)
            post_exact = bool((_np(out[1]) == _np(i_ref)).all())
    service.drain(timeout=30.0)
    results = _score(admitted)
    resolved = results["ok"] + results["typed_errors"] + results["untyped_errors"]
    report = {
        "seed": seed,
        "duration_s": duration,
        "outage_s": outage_s,
        "transient_p": transient_p,
        **counts,
        **results,
        "resolved": resolved,
        "exactly_once": results["lost"] == 0 and resolved == counts["submitted"],
        "typed_only": results["untyped_errors"] == 0,
        "breaker_trips": int(_reg_total("raft_tpu_serve_breaker_trips_total") - trips0),
        "requeued": int(_reg_total("raft_tpu_serve_requeued_total") - requeue0),
        "recoveries": int(_reg_total("raft_tpu_serve_recoveries_total") - recov0),
        "breaker_state": (service.breaker.describe()["state"]
                          if service.breaker is not None else None),
        "chaos_ok": (results["lost"] == 0 and results["untyped_errors"] == 0
                     and resolved == counts["submitted"] and post_exact is not False),
    }
    if kill_shard:
        report["kill_shard"] = True
        report["post_recovery_exact"] = post_exact
        report["shard_devices"] = int(service.mesh.shape[service.axis])
    return report


def run_crash_restart(persist_dir, *, index_rows=4000, dim=16, k=5, seed=0, duration=4.0,
                      concurrency=3, rows=4, nlist=32, clusters=16, insert_rows=8,
                      svc_opts=None, device="cuda", train_rows=None, data=None, timings=None):
    """Drive a persistent ANNService (WAL ``fsync="always"``, short
    snapshot interval) with closed-loop queries and an insert stream,
    then drop it mid-traffic with NO final snapshot and rebuild it from
    ``persist_dir`` alone (``ANNService(None, persist_dir=...)``).

    ``crash_ok``: no acknowledged insert lost (every id whose ``insert()``
    returned is in the restored store); the restored service's answers
    bitwise equal to a reference kept from the live service; every
    admitted future resolved once with a result or a typed error; the
    restore replayed the WAL tail the scenario guarantees; no kernel
    built or loaded after the restore's warmup.  ``data`` (the reference
    matrix, numpy or a tensor) replaces the synthetic rows; ``timings``
    also gets the first warmup's seconds (``warmup_s``)."""
    from raft_tpu_torch.core.error import RaftError
    from raft_tpu_torch.serve import ANNService
    from raft_tpu_torch.spatial.ann import IVFFlatParams, ivf_flat_build

    rng = np.random.default_rng(seed)
    if data is None:
        data = synth_data(index_rows, dim, seed=seed, clusters=clusters)
    dim = int(data.shape[1])
    index = ivf_flat_build(data, IVFFlatParams(nlist=nlist, nprobe=8), train_rows=train_rows,
                           device=device)
    opts = dict(max_batch_rows=64, bucket_rungs=(8, 64), max_wait_ms=1.0, delta_cap=2048,
                compact_rows=512, nprobe_ladder=(4, 8))
    opts.update(svc_opts or {})
    svc = ANNService(index, k, persist_dir=persist_dir, persist_fsync="always",
                     snapshot_interval_s=max(0.5, duration / 4), device=device, **opts)
    svc2 = None
    timings = _new_timings(timings)
    try:
        t_warm = time.monotonic()
        svc.warmup()
        timings["warmup_s"] = time.monotonic() - t_warm
        pool = make_query_pool(data, rows, n=8, seed=seed + 1)
        lock = threading.Lock()
        admitted, acked_ids = [], []
        counts = {"submitted": 0, "sheds": 0}
        stop_inserts, stop_clients = threading.Event(), threading.Event()

        def inserter():
            base, n = 10_000_000, 0
            while not stop_inserts.is_set():
                ids = np.arange(base + n, base + n + insert_rows)
                vecs = rng.standard_normal((insert_rows, dim)).astype(np.float32)
                try:
                    svc.insert(ids, vecs)
                except RaftError:
                    time.sleep(0.02)
                    continue
                with lock:
                    acked_ids.extend(int(x) for x in ids)
                n += insert_rows
                time.sleep(0.002)

        ins = threading.Thread(target=inserter, daemon=True)
        ins.start()
        t_load = time.monotonic()
        clients = _closed_chaos_clients(svc, pool, concurrency, stop_clients, lock, admitted,
                                        counts, lambda e: "sheds", 5.0, timings)
        try:
            time.sleep(duration * 0.5)
            # quiesce inserts; freeze interval snapshots, take one catch-up
            # snapshot (the WAL drains to 0; it waits for an interval
            # snapshot the worker may still be writing), then append a
            # last acknowledged burst only the WAL holds: the crash lands
            # with a WAL tail, so the restore must replay it
            stop_inserts.set()
            ins.join(timeout=10.0)
            svc._persist.snapshot_interval_s = 1e9
            # fold the delta now: the restored service must not cross its
            # compact_rows threshold mid-probe
            svc.compact()
            svc._persist.snapshot(svc._ann_state)
            burst = np.arange(20_000_000, 20_000_000 + 2 * insert_rows)
            svc.insert(burst, rng.standard_normal((burst.size, dim)).astype(np.float32))
            with lock:
                acked_ids.extend(int(x) for x in burst)
            # the reference the restored service must reproduce bit for
            # bit (queries only from here on: the served state is frozen)
            reference = []
            for q in pool:
                out = svc.submit(q).result(timeout=30.0)
                reference.append((_np(out[0]).copy(), _np(out[1]).copy()))
            # keep querying, then die mid-traffic: no final snapshot
            time.sleep(duration * 0.25)
            svc.close(drain=False, timeout=2.0, snapshot=False)
        finally:
            stop_inserts.set()
            stop_clients.set()
            _join(clients + [ins], 15.0)
            timings["window_s"] = time.monotonic() - t_load
        results = _score(admitted, timeout=10.0)
        resolved = results["ok"] + results["typed_errors"] + results["untyped_errors"]

        t0 = time.monotonic()
        svc2 = ANNService(None, k, persist_dir=persist_dir, persist_fsync="always",
                          device=device, **opts)
        restore_s = time.monotonic() - t0
        pstats = svc2._persist.stats()
        svc2.warmup()
        moves0 = _build_moves()
        identical = True
        for q, (d_ref, i_ref) in zip(pool, reference):
            out = svc2.submit(q).result(timeout=30.0)
            if not ((_np(out[0]) == d_ref).all() and (_np(out[1]) == i_ref).all()):
                identical = False
        post_restore_compiles = _build_moves() - moves0
        _, gt_ids = svc2.ground_truth_store()
        missing = sorted(set(acked_ids) - set(int(x) for x in gt_ids))
    finally:
        svc.close(drain=False, timeout=2.0, snapshot=False)
        if svc2 is not None:
            svc2.close()
    report = {
        "seed": seed,
        "duration_s": duration,
        **counts,
        **results,
        "resolved": resolved,
        "exactly_once": results["lost"] == 0 and resolved == counts["submitted"],
        "typed_only": results["untyped_errors"] == 0,
        "acked_inserts": len(acked_ids),
        "lost_inserts": len(missing),
        "no_insert_loss": not missing,
        "bit_identical": identical,
        "restore_s": round(restore_s, 3),
        "restored_snapshot_seq": pstats["snapshot_seq"],
        "wal_replayed_records": pstats["replayed_records"],
        "wal_replay_records_per_s": round(pstats["replayed_records"] / max(restore_s, 1e-9), 1),
        "post_restore_compiles": post_restore_compiles,
    }
    report["crash_ok"] = (report["exactly_once"] and report["typed_only"]
                          and report["no_insert_loss"] and report["bit_identical"]
                          and report["wal_replayed_records"] > 0
                          and post_restore_compiles == 0)
    return report


# the router's counters the fleet scenario reads, by the label it sums over
FLEET_COUNTERS = (("raft_tpu_fleet_requests_total", "outcome"),
                  ("raft_tpu_fleet_rejoins_total", None),
                  ("raft_tpu_fleet_evictions_total", "reason"),
                  ("raft_tpu_fleet_retries_total", None),
                  ("raft_tpu_fleet_frame_errors_total", "kind"))


def _fleet_counters():
    """``{family: {label value: total}}`` of :data:`FLEET_COUNTERS` now."""
    from raft_tpu_torch.core.metrics import default_registry

    snap = default_registry().snapshot()
    out = {}
    for name, label in FLEET_COUNTERS:
        by = out[name] = {}
        for s in snap.get(name, {}).get("series", []):
            key = s["labels"].get(label) if label else "_"
            by[key] = by.get(key, 0) + int(s["value"])
    return out


def run_fleet(root, *, n_workers=2, mode="sharded", index_rows=2000, dim=16, k=5, seed=0,
              duration=6.0, concurrency=4, rows=4, nlist=16, clusters=8, insert_rows=8,
              chaos=True, trace_k=0, device="cuda", service_opts=None, inspect=None):
    """A router and ``n_workers`` worker processes on ``device`` under
    closed-loop search traffic plus (sharded) an insert stream, while a
    seeded :class:`~raft_tpu_torch.fleet.chaos.ChaosSchedule` injects
    process faults (SIGKILL and restart, hang, slow rejoin, dropped or
    garbled frames, fsync stall).  After the schedule and the heal,
    ``fleet_ok``: every acknowledged row found under its id; terminal
    outcomes equal admitted calls, no request id with two terminal
    flight events, no untyped error at a client; every worker active,
    and a process fault that fired produced a rejoin.  ``inspect(fleet)``,
    when given, runs once the report is complete, while the fleet still
    lives (a caller reads the workers' state through it).  The fleet is
    closed before returning: no worker outlives the call."""
    from raft_tpu_torch.core import flight
    from raft_tpu_torch.core.error import RaftError
    from raft_tpu_torch.fleet import Fleet, Router
    from raft_tpu_torch.fleet.chaos import ChaosHarness, ChaosSchedule, FrameFaults

    rng = np.random.default_rng(seed)
    frame = FrameFaults(seed + 1)
    router = Router(mode=mode, shard_count=(n_workers if mode == "sharded" else 1),
                    transport=frame)
    opts = {"delta_cap": 8192}
    opts.update(service_opts or {})
    t_ready = time.monotonic()
    fleet = Fleet(n_workers, root=root, index_rows=index_rows, dim=dim, k=k, mode=mode,
                  seed=seed, clusters=clusters, nlist=nlist, router=router,
                  service_opts=opts, device=device)
    report = {"seed": seed, "duration_s": duration, "mode": mode, "workers": n_workers}
    harness = None
    stop = threading.Event()
    threads = []
    try:
        fleet.wait_ready()
        report["ready_s"] = round(time.monotonic() - t_ready, 3)
        data = synth_data(index_rows, dim, seed=seed, clusters=clusters)
        q_idx = rng.integers(0, index_rows, size=(16, rows))
        qpool = [data[ix] for ix in q_idx]
        lock = threading.Lock()
        counts = {"calls": 0, "search_ok": 0, "degraded": 0, "typed_errors": 0,
                  "untyped_errors": 0, "insert_batches": 0, "insert_partial": 0}
        acked = {}
        latencies = []

        def client(tid):
            i = tid
            while not stop.is_set():
                q = qpool[i % len(qpool)]
                i += concurrency
                with lock:
                    counts["calls"] += 1
                t0 = time.monotonic()
                try:
                    out = router.search(q.tolist(), timeout_s=8.0)
                except RaftError:
                    with lock:
                        counts["typed_errors"] += 1
                    time.sleep(0.01)
                except Exception:  # noqa: BLE001 — counted: an untyped error fails the run
                    with lock:
                        counts["untyped_errors"] += 1
                    time.sleep(0.01)
                else:
                    with lock:
                        counts["search_ok"] += 1
                        latencies.append(time.monotonic() - t0)
                        if out["degraded"]:
                            counts["degraded"] += 1

        def inserter():
            base, n = max(1_000_000, index_rows * 10), 0
            while not stop.is_set():
                ids = list(range(base + n, base + n + insert_rows))
                vecs = rng.standard_normal((insert_rows, dim)).astype(np.float32)
                with lock:
                    counts["calls"] += 1
                    counts["insert_batches"] += 1
                try:
                    rep = router.insert(ids, [v.tolist() for v in vecs], timeout_s=8.0)
                except RaftError:
                    with lock:
                        counts["typed_errors"] += 1
                    time.sleep(0.05)
                    continue
                except Exception:  # noqa: BLE001 — counted: an untyped error fails the run
                    with lock:
                        counts["untyped_errors"] += 1
                    time.sleep(0.05)
                    continue
                ok_ids = set(rep["acked_ids"])
                with lock:
                    if not rep["ok"]:
                        counts["insert_partial"] += 1
                    for j, iid in enumerate(ids):
                        if iid in ok_ids:
                            acked[iid] = vecs[j]
                n += insert_rows
                time.sleep(0.03)

        threads = [threading.Thread(target=client, args=(t,), daemon=True)
                   for t in range(concurrency)]
        if mode == "sharded":
            threads.append(threading.Thread(target=inserter, daemon=True))
        if chaos:
            sched = ChaosSchedule.from_seed(seed, duration_s=duration, n_workers=n_workers)
            harness = ChaosHarness(fleet, sched, frame_faults=frame).start()
        base = _fleet_counters()
        t_load = time.monotonic()
        for t in threads:
            t.start()
        time.sleep(duration)
        stop.set()
        _join(threads, 30.0)
        wall = time.monotonic() - t_load
        if harness is not None:
            harness.join(timeout=30.0)
            harness.stop()
        frame.disarm()

        # heal: every worker active again before the accounting
        t_heal = time.monotonic()
        while (len(router.active_workers()) < n_workers
               and time.monotonic() - t_heal < 60.0):
            time.sleep(0.1)
        healed = len(router.active_workers()) == n_workers
        report["heal_s"] = round(time.monotonic() - t_heal, 3)

        # accounting before the verification traffic (its searches are
        # requests too), as deltas over this run: the process may have
        # routed other fleets' requests before
        now = _fleet_counters()
        delta = {name: {key: v - base[name].get(key, 0) for key, v in by.items()
                        if v - base[name].get(key, 0)} for name, by in now.items()}
        outcomes = delta["raft_tpu_fleet_requests_total"]
        sheds = outcomes.get("shed", 0)
        terminals = sum(v for o, v in outcomes.items() if o != "shed")
        admitted = counts["calls"] - sheds
        rejoins = sum(delta["raft_tpu_fleet_rejoins_total"].values())
        evictions = delta["raft_tpu_fleet_evictions_total"]
        retries = sum(delta["raft_tpu_fleet_retries_total"].values())
        frames = delta["raft_tpu_fleet_frame_errors_total"]

        # this run's terminal flight events (another router's request ids
        # may repeat these, but not after this run began)
        rec = flight.default_recorder()
        term_rids = {}
        for kind in ("fleet_resolved", "fleet_failed", "fleet_expired"):
            for ev in rec.events(kind=kind):
                rid = (ev.attrs or {}).get("rid")
                if rid is not None and ev.ts >= t_load:
                    term_rids[rid] = term_rids.get(rid, 0) + 1
        dup_terminals = sum(1 for v in term_rids.values() if v > 1)

        # every acknowledged insert's exact vector returns its id
        lost, verify_errors, verified = [], 0, 0
        items = sorted(acked.items())
        for off in range(0, len(items), 32):
            chunk = items[off:off + 32]
            try:
                out = router.search([v.tolist() for _, v in chunk], timeout_s=15.0)
            except Exception:  # noqa: BLE001 — a failed verification counts its rows lost
                verify_errors += 1
                lost.extend(iid for iid, _ in chunk)
                continue
            for (iid, _), row in zip(chunk, out["ids"]):
                verified += 1
                if iid not in row:
                    lost.append(iid)

        applied = harness.applied if harness is not None else []
        proc_faults = [e for e in applied if e["kind"] in ("kill", "hang") and "failed" not in e]
        lat = sorted(latencies)
        report.update(
            counts,
            sheds=sheds, outcomes=outcomes, admitted=admitted, terminals=terminals,
            exactly_once=(terminals == admitted and dup_terminals == 0),
            dup_terminals=dup_terminals,
            typed_only=counts["untyped_errors"] == 0,
            acked_inserts=len(acked), verified=verified,
            lost_inserts=len(lost), no_insert_loss=not lost,
            verify_errors=verify_errors, healed=healed,
            rejoins=rejoins, evictions=evictions, retries=retries,
            frame_errors=frames, frame_injected=dict(frame.injected),
            chaos_applied=[e["kind"] for e in applied],
            chaos_failed=[e["kind"] for e in applied if "failed" in e],
            rejoin_seen=(rejoins >= 1 or not proc_faults),
            query_qps=round(counts["search_ok"] * rows / wall, 2) if wall else 0.0,
            p50_ms=round(_percentile(lat, 0.50) * 1e3, 3),
            p99_ms=round(_percentile(lat, 0.99) * 1e3, 3))
        report["fleet_ok"] = (report["exactly_once"] and report["typed_only"]
                              and report["no_insert_loss"] and report["healed"]
                              and report["rejoin_seen"] and not report["chaos_failed"])
        # the cross-process waterfalls are joined while the fleet lives:
        # the join scrapes each owning worker's /debug/trace
        if trace_k:
            tid_to_rid = {}
            for fid in rec.fleet_trace_ids():
                for tr in rec.fleet_traces(fid):
                    tid_to_rid[tr.trace_id] = fid
            slow = []
            for ex in flight.exemplars_for("fleet").snapshot():
                rid = tid_to_rid.get(ex["trace_id"])
                if rid is None:
                    continue
                status, joined = router.fleet_trace(rid)
                if status == 200:
                    slow.append({"latency_ms": ex["latency_ms"], "rid": rid, "joined": joined})
                if len(slow) >= trace_k:
                    break
            report["slow_fleet_traces"] = slow
        offenders = sorted(rid for rid, v in term_rids.items() if v > 1)[:5]
        report["offending_rids"] = offenders
        if not report["fleet_ok"] and offenders:
            traces = {}
            for rid in offenders:
                try:
                    traces[rid] = router.fleet_trace(rid)[1]
                except Exception as e:  # noqa: BLE001 — best-effort postmortem dump
                    traces[rid] = {"error": str(e)}
            report["offender_traces"] = traces
        if inspect is not None:
            inspect(fleet)
        return report
    finally:
        stop.set()
        _join(threads, 30.0)
        if harness is not None:
            harness.stop()
        fleet.close()


def _dump_flight(path):
    """Write the flight recorder (ring and black boxes) to ``path``."""
    from raft_tpu_torch.core import flight

    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    flight.default_recorder().dump_to(path)
    print("flight recorder dumped to %s (render with tools/torch_trace_report.py)" % path,
          file=sys.stderr)


def _failure_dump(name, seed):
    _dump_flight(os.path.join(DUMP_DIR, "flight_%s_seed%d.json" % (name, seed)))


def _print_waterfalls(slow_traces):
    """The slowest-K waterfalls next to the p99 row (``--trace``)."""
    from tools.torch_trace_report import render_waterfall

    for entry in slow_traces:
        print("-- slow request: %.3fms (trace %s) --" % (entry["latency_ms"], entry["trace_id"]))
        if entry["timeline"]:
            print(render_waterfall(entry["timeline"]))


def _print_keys(report, keys, width=20):
    for key in keys:
        if key in report:
            val = report[key]
            print("  %-*s %s" % (width, key, "%.3f" % val if isinstance(val, float) else val))


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


def _parser():
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--service", choices=("knn", "pairwise", "ann"), default="knn")
    p.add_argument("--clusters", type=int, default=0,
                   help="Gaussian-mixture data with this many clusters (0: i.i.d.)")
    p.add_argument("--nlist", type=int, default=None, help="ann: IVF lists (~sqrt(rows))")
    p.add_argument("--nprobe", type=int, default=None, help="ann: served probe count")
    p.add_argument("--train-rows", type=int, default=None,
                   help="ann: subsampled k-means training rows")
    p.add_argument("--ooc", action="store_true", help="ann: serve the out-of-core tier")
    p.add_argument("--device-budget-mb", type=int, default=None, metavar="N",
                   help="ooc: device budget in MiB (default: a quarter of the store)")
    p.add_argument("--ooc-sync", action="store_true",
                   help="ooc: the synchronous-prefetch arm (no double buffering)")
    p.add_argument("--recall", action="store_true",
                   help="score recall@k against brute force (always for --service ann)")
    p.add_argument("--recall-target", type=float, default=None,
                   help="ann: calibrate nprobe to this recall@k before the run")
    p.add_argument("--chaos", action="store_true",
                   help="the chaos scenario: serve-seam faults, an outage, recovery")
    p.add_argument("--crash-restart", action="store_true",
                   help="the crash-restart scenario (--service ann)")
    p.add_argument("--persist-dir", default=None, metavar="DIR",
                   help="--crash-restart / --fleet directory (default: a temporary one)")
    p.add_argument("--fleet", action="store_true",
                   help="the fleet chaos scenario: a router and worker processes")
    p.add_argument("--fleet-workers", type=int, default=2, metavar="N")
    p.add_argument("--fleet-mode", default="sharded", choices=("sharded", "replicated"))
    p.add_argument("--no-chaos", action="store_true",
                   help="--fleet: steady traffic only, no fault schedule")
    p.add_argument("--transient-p", type=float, default=0.05,
                   help="chaos: per-batch transient fault probability")
    p.add_argument("--outage-s", type=float, default=0.8,
                   help="chaos: the simulated device loss's seconds")
    p.add_argument("--mesh", type=int, default=None, metavar="N",
                   help="serve sharded over a world of N rank slots on --device (knn/ann)")
    p.add_argument("--merge", default=None, choices=("allgather", "ring", "hierarchical"),
                   help="the sharded merge (default: the mnmg_merge knob)")
    p.add_argument("--kill-shard", action="store_true",
                   help="chaos: the outage kills the last rank slot (needs --mesh >= 2)")
    p.add_argument("--replicas", type=int, default=None, metavar="R",
                   help="serve R hedged replicas of the kNN index")
    p.add_argument("--hedge-ms", type=float, default=None,
                   help="fixed hedge threshold (default: the serve_hedge_ms knob)")
    p.add_argument("--hedge-chaos", action="store_true",
                   help="the hedge chaos scenario (needs --replicas >= 2)")
    p.add_argument("--tenants", action="store_true", help="the mixed-tenant scenario")
    p.add_argument("--tenant-weights", default="interactive:4,bulk:1",
                   help="tenant:weight spec for --tenants")
    p.add_argument("--bulk-qps", type=float, default=300.0,
                   help="--tenants: open-loop bulk arrival rate")
    p.add_argument("--bulk-rows", type=int, default=32,
                   help="--tenants: query rows a bulk request")
    p.add_argument("--ops-port", type=int, default=None, metavar="P",
                   help="the ops-scrape scenario on port P (0: ephemeral)")
    p.add_argument("--mode", choices=("closed", "open"), default="closed")
    p.add_argument("--qps", type=float, default=100.0, help="open-loop arrival rate")
    p.add_argument("--concurrency", type=int, default=8, help="closed-loop client threads")
    p.add_argument("--duration", type=float, default=5.0)
    p.add_argument("--rows", type=int, default=4, help="query rows a request")
    p.add_argument("--index-rows", type=int, default=50000)
    p.add_argument("--dim", type=int, default=64)
    p.add_argument("--k", type=int, default=10)
    p.add_argument("--max-batch-rows", type=int, default=256)
    p.add_argument("--max-wait-ms", type=float, default=None)
    p.add_argument("--queue-cap", type=int, default=None)
    p.add_argument("--deadline", type=float, default=None, help="per-request deadline seconds")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--trace", type=int, nargs="?", const=3, default=0, metavar="K",
                   help="print the K slowest requests' waterfalls (default 3)")
    p.add_argument("--trace-dump", metavar="PATH", default=None,
                   help="write the flight recorder to PATH after the run")
    p.add_argument("--select-impl", choices=("kernel", "sort"), default=None)
    table = p.add_mutually_exclusive_group()
    table.add_argument("--tuned", action="store_true")
    table.add_argument("--untuned", action="store_true")
    p.add_argument("--table", default=None, help="the table --tuned loads")
    p.add_argument("--device", default="cuda",
                   help="where the services run (default cuda; cpu runs the plain versions)")
    p.add_argument("--json", action="store_true", help="print the report as JSON")
    return p


def _check_flags(args):
    """The JAX tool's rules on which flags combine."""
    if args.select_impl is not None and args.service != "ann":
        raise SystemExit("--select-impl applies to the ANN service")
    if (args.ooc or args.device_budget_mb is not None or args.ooc_sync) \
            and args.service != "ann":
        raise SystemExit("--ooc/--device-budget-mb/--ooc-sync apply to the out-of-core ANN "
                         "tier (--service ann)")
    if (args.device_budget_mb is not None or args.ooc_sync) and not args.ooc:
        raise SystemExit("--device-budget-mb/--ooc-sync require --ooc")
    if args.ooc and args.mesh is not None:
        raise SystemExit("--ooc does not compose with --mesh (the tier trades device memory "
                         "for host streaming; shard the resident path instead)")
    if args.merge is not None and args.mesh is None and args.replicas is None:
        raise SystemExit("--merge is the sharded merge: it requires --mesh N or --replicas R")
    if args.kill_shard and (args.mesh is None or args.mesh < 2):
        raise SystemExit("--kill-shard requires --mesh >= 2")
    if args.trace and (args.chaos or args.hedge_chaos or args.tenants
                       or args.ops_port is not None):
        raise SystemExit("--trace applies to plain load runs; chaos/tenant scenarios capture "
                         "the whole recorder instead: use --trace-dump PATH (failed chaos "
                         "assertions dump it automatically)")
    if args.hedge_chaos and (args.replicas is None or args.replicas < 2):
        raise SystemExit("--hedge-chaos requires --replicas >= 2")
    if args.ops_port is not None and (args.chaos or args.hedge_chaos or args.tenants):
        raise SystemExit("--ops-port runs the steady ops-scrape scenario; it does not compose "
                         "with the chaos/tenant scenarios")
    if args.hedge_ms is not None and args.replicas is None:
        raise SystemExit("--hedge-ms requires --replicas")


def _service_opts(args):
    opts = {"max_batch_rows": args.max_batch_rows}
    if args.max_wait_ms is not None:
        opts["max_wait_ms"] = args.max_wait_ms
    if args.queue_cap is not None:
        opts["queue_cap"] = args.queue_cap
    return opts


def _main_fleet(args):
    root = args.persist_dir
    cleanup = root is None
    if root is None:
        root = tempfile.mkdtemp(prefix="raft_tpu_torch_fleet_")
    try:
        report = run_fleet(root, n_workers=args.fleet_workers, mode=args.fleet_mode,
                           index_rows=args.index_rows, dim=args.dim, k=args.k, seed=args.seed,
                           duration=args.duration, concurrency=args.concurrency,
                           rows=args.rows, nlist=args.nlist or 16,
                           clusters=args.clusters or 8, chaos=not args.no_chaos,
                           trace_k=args.trace, device=args.device)
    finally:
        if cleanup:
            shutil.rmtree(root, ignore_errors=True)
    if args.json:
        print(json.dumps(report, indent=2, sort_keys=True))
    else:
        print("== torch_loadgen: fleet %s x%d (seed=%d) =="
              % (report["mode"], report["workers"], args.seed))
        _print_keys(report, ("duration_s", "calls", "search_ok", "degraded", "typed_errors",
                             "untyped_errors", "sheds", "insert_batches", "acked_inserts",
                             "lost_inserts", "no_insert_loss", "admitted", "terminals",
                             "dup_terminals", "exactly_once", "typed_only", "retries",
                             "frame_errors", "frame_injected", "evictions", "rejoins",
                             "chaos_applied", "chaos_failed", "healed", "fleet_ok"), 24)
        if report.get("slow_fleet_traces"):
            from tools.torch_trace_report import render_fleet_waterfall

            for entry in report["slow_fleet_traces"]:
                print("-- slow fleet request: %.3fms (rid %s) --"
                      % (entry["latency_ms"], entry["rid"]))
                print(render_fleet_waterfall(entry["joined"]))
    if not report["fleet_ok"]:
        _failure_dump("fleet", args.seed)
        for rid, joined in sorted((report.get("offender_traces") or {}).items()):
            path = os.path.join(DUMP_DIR, "fleet_trace_seed%d_%s.json" % (args.seed, rid))
            with open(path, "w", encoding="utf-8") as f:
                json.dump(joined, f, indent=2, sort_keys=True)
            print("joined fleet trace for offending rid %s -> %s (render with "
                  "tools/torch_trace_report.py)" % (rid, path), file=sys.stderr)
    return 0 if report["fleet_ok"] else 1


def _main_crash_restart(args):
    if args.service != "ann":
        raise SystemExit("--crash-restart drives the persistent ANN service (--service ann)")
    pdir = args.persist_dir
    cleanup = pdir is None
    if pdir is None:
        pdir = tempfile.mkdtemp(prefix="raft_tpu_torch_persist_")
    try:
        report = run_crash_restart(pdir, index_rows=args.index_rows, dim=args.dim, k=args.k,
                                   seed=args.seed, duration=args.duration,
                                   concurrency=args.concurrency, rows=args.rows,
                                   nlist=args.nlist or 32, clusters=args.clusters or 16,
                                   svc_opts=_service_opts(args), device=args.device,
                                   train_rows=args.train_rows)
    finally:
        if cleanup:
            shutil.rmtree(pdir, ignore_errors=True)
    if args.json:
        print(json.dumps(report, indent=2, sort_keys=True))
    else:
        print("== torch_loadgen: ann crash-restart (seed=%d) ==" % args.seed)
        _print_keys(report, ("duration_s", "submitted", "ok", "typed_errors", "untyped_errors",
                             "lost", "sheds", "acked_inserts", "lost_inserts",
                             "no_insert_loss", "bit_identical", "exactly_once", "typed_only",
                             "restore_s", "restored_snapshot_seq", "wal_replayed_records",
                             "wal_replay_records_per_s", "post_restore_compiles",
                             "crash_ok"), 24)
    if not report["crash_ok"]:
        _failure_dump("crash_restart", args.seed)
    return 0 if report["crash_ok"] else 1


def _finish_chaos(args, report, name, keys):
    if args.json:
        print(json.dumps(report, indent=2, sort_keys=True))
    else:
        print("== torch_loadgen: %s %s (seed=%d) ==" % (args.service, name, args.seed))
        _print_keys(report, keys)
    if args.trace_dump:
        _dump_flight(args.trace_dump)
    elif not report["chaos_ok"]:
        _failure_dump(name.replace("-", "_"), args.seed)
    return 0 if report["chaos_ok"] else 1


def main(argv=None) -> int:
    args = _parser().parse_args(argv)
    import torch

    if args.device.startswith("cuda") and not torch.cuda.is_available():
        print("torch_loadgen: no CUDA device (pass --device cpu to run the plain versions "
              "on the CPU)", file=sys.stderr)
        return 2
    if args.fleet:
        return _main_fleet(args)
    if args.crash_restart:
        return _main_crash_restart(args)
    _check_flags(args)
    info = _apply_table(args)
    opts = _service_opts(args)
    if args.service == "ann":
        opts.update(nlist=args.nlist, nprobe=args.nprobe, train_rows=args.train_rows,
                    select_impl=args.select_impl)
        if args.ooc:
            opts.update(ooc=True, device_budget_mb=args.device_budget_mb)
            if args.ooc_sync:
                opts["ooc_overlap"] = False
    if args.merge is not None:
        opts["merge"] = args.merge
    if args.hedge_ms is not None:
        opts["hedge_ms"] = args.hedge_ms
    if args.tenants:
        opts["tenant_weights"] = args.tenant_weights
    service = build_service(args.service, args.index_rows, args.dim, args.k,
                            device=args.device, seed=args.seed, clusters=args.clusters,
                            mesh_devices=args.mesh, replicas=args.replicas, **opts)
    t0 = time.monotonic()
    try:
        service.warmup()
        warmup_s = time.monotonic() - t0
        if args.hedge_chaos:
            report = run_hedge_chaos(service, duration=args.duration,
                                     concurrency=args.concurrency, rows=args.rows,
                                     seed=args.seed)
        elif args.tenants:
            report = run_mixed_tenants(service, duration=args.duration,
                                       interactive_concurrency=args.concurrency,
                                       bulk_qps=args.bulk_qps, interactive_rows=args.rows,
                                       bulk_rows=args.bulk_rows, seed=args.seed,
                                       deadline=args.deadline)
        elif args.chaos:
            from raft_tpu_torch.serve.resilience import RecoveryManager

            report = run_chaos(service, duration=args.duration, concurrency=args.concurrency,
                               rows=args.rows, seed=args.seed, transient_p=args.transient_p,
                               outage_s=args.outage_s,
                               manager=RecoveryManager(services=[service]),
                               kill_shard=args.kill_shard)
        elif args.ops_port is not None:
            report = run_ops_scrape(service, port=args.ops_port, duration=args.duration,
                                    concurrency=args.concurrency, rows=args.rows,
                                    seed=args.seed)
        else:
            want_recall = args.recall or args.service == "ann"
            pool = (make_query_pool(service.loadgen_ref, args.rows, seed=args.seed + 1)
                    if want_recall else None)
            calibration = None
            if args.recall_target is not None and args.service == "ann":
                calibration = service.calibrate(np.concatenate(pool[:8], axis=0),
                                                args.recall_target)
            report = run_load(service, mode=args.mode, duration=args.duration,
                              concurrency=args.concurrency, qps=args.qps, rows=args.rows,
                              seed=args.seed, deadline=args.deadline, recall=want_recall,
                              query_pool=pool, trace_k=args.trace)
            if calibration is not None:
                report["calibration"] = calibration
    finally:
        service.close()
    report["warmup_s"] = round(warmup_s, 3)
    report["device"] = str(service.device)
    if args.hedge_chaos:
        return _finish_chaos(args, report, "hedge-chaos", (
            "duration_s", "delay_s", "submitted", "ok", "typed_errors", "untyped_errors",
            "lost", "sheds", "hedges_fired", "hedge_wins", "hedge_cancelled", "exactly_once",
            "typed_only", "post_warmup_compiles", "host_staged_bytes", "chaos_ok"))
    if args.chaos:
        return _finish_chaos(args, report, "chaos", (
            "duration_s", "outage_s", "transient_p", "submitted", "ok", "typed_errors",
            "untyped_errors", "lost", "rejected", "unavailable", "requeued", "breaker_trips",
            "recoveries", "breaker_state", "exactly_once", "typed_only",
            "kill_shard", "shard_devices", "post_recovery_exact", "chaos_ok"))
    if args.tenants:
        if args.json:
            print(json.dumps(report, indent=2, sort_keys=True))
        else:
            print("== torch_loadgen: %s mixed-tenants ==" % args.service)
            _print_keys(report, ("duration_s", "untyped_sheds", "post_warmup_compiles",
                                 "host_staged_bytes", "warmup_s"))
            for tenant, st in sorted(report["tenants"].items()):
                print("  [%s]" % tenant)
                for key in ("requests_ok", "rejected", "unavailable", "errors", "qps",
                            "p50_ms", "p95_ms", "p99_ms"):
                    print("    %-18s %s" % (key, st[key]))
        if args.trace_dump:
            _dump_flight(args.trace_dump)
        return 0 if report["untyped_sheds"] == 0 else 1
    if args.ops_port is not None:
        if args.json:
            print(json.dumps(report, indent=2, sort_keys=True))
        else:
            print("== torch_loadgen: %s ops-scrape ==" % args.service)
            _print_keys(report, ("baseline_qps", "scraped_qps", "qps_ratio", "scrapes",
                                 "scrape_failures", "scrape_p95_ms", "post_warmup_compiles",
                                 "host_staged_bytes", "p99_ms", "ops_port", "warmup_s",
                                 "ops_ok"))
        return 0 if report["ops_ok"] else 1
    if args.trace_dump:
        _dump_flight(args.trace_dump)
    report["buckets"] = list(service.policy.rungs)
    report["tuning_table"] = info
    if getattr(service, "axis", None) is not None:
        report["n_devices"] = int(service.mesh.shape[service.axis])
        report["merge"] = service.merge
    if getattr(service, "_replica_set", None) is not None:
        report["replicas"] = len(service._replica_set.replicas)
        report["hedges_fired"] = int(_reg_total("raft_tpu_serve_hedges_total"))
    if args.service == "ann":
        report["nprobe"] = service.nprobe
        report["delta_rows"] = service.delta_rows
        report["select_impl"] = args.select_impl
    if args.json:
        print(json.dumps(report, indent=2, sort_keys=True, default=str))
        return 0
    print("== torch_loadgen: %s %s on %s ==" % (args.service, args.mode, report["device"]))
    _print_keys(report, ("duration_s", "requests_ok", "rejected", "errors", "qps", "query_qps",
                         "n_devices", "merge", "recall_at_k", "recall_k", "nprobe",
                         "delta_rows", "select_impl", "tile_hit_rate", "h2d_mb",
                         "hidden_transfer_frac", "p50_ms", "p95_ms", "p99_ms",
                         "queue_wait_p50_ms", "queue_wait_p95_ms", "batches",
                         "mean_batch_rows", "padding_waste", "post_warmup_compiles",
                         "host_staged_bytes", "warmup_s", "buckets", "tuning_table"))
    if report.get("slow_traces"):
        _print_waterfalls(report["slow_traces"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
