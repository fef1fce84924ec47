#!/usr/bin/env python3
"""Render or produce raft_tpu_torch observability snapshots, with no JAX.

The port's arm of ``tools/metrics_report.py``: the same snapshot shape
(``Session.metrics_snapshot()``, a worker's or the router's
``/debug/snapshot``: ``{metrics, profiler_tree, event_counters, flight,
inventory}``) rendered section for section as the JAX tool renders it,
with three differences: the tuning line reads the port's
``raft_tpu_torch/config.py:tuning_table_info``; the inventory section
reads the port's kernel inventory (each kernel's shapes, launches,
operations and bytes from ``ops/cost.py``), where the JAX tool joins its
cost model to ``raft_tpu_jit_*`` timers; and there is no compile-cache
section, because the port has no compile cache (its kernel builds are
``ops/_build.py:stats``).

Usage:
    # pretty-print a dumped snapshot
    python3 tools/torch_metrics_report.py snapshot.json
    python3 tools/torch_metrics_report.py snapshot.json --format json

    # a tiny instrumented run of the port (pairwise + knn + allreduce +
    # buffer churn + a warmed KNNService) on the card, or the CPU
    python3 tools/torch_metrics_report.py --demo
    python3 tools/torch_metrics_report.py --demo --device cpu --out snapshot.json

    # live: a worker's or the router's ops plane (/debug/snapshot)
    python3 tools/torch_metrics_report.py --url http://127.0.0.1:9100 --watch 2
    python3 tools/torch_metrics_report.py --url http://127.0.0.1:9100 --format prom

Formats: ``report`` (default; tables and the span tree), ``json`` (the
raw snapshot), ``prom`` (Prometheus text of the registry: with --demo or
--url, since a dumped snapshot has already flattened it).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)


def _fmt_s(v: float) -> str:
    if v >= 1.0:
        return "%.3fs" % v
    if v >= 1e-3:
        return "%.3fms" % (v * 1e3)
    return "%.1fus" % (v * 1e6)


def render_report(snap: dict) -> str:
    lines = []
    metrics = snap.get("metrics", {})
    fleet = _fleet_summary(snap)
    if fleet:
        lines.append("== fleet (router aggregate; docs/FAULT_MODEL.md "
                     "\"Fleet fault domains\") ==")
        lines.extend(fleet)
    timers = {n: f for n, f in metrics.items() if f.get("type") == "timer"}
    if timers:
        lines.append("== timers (count / total / mean / p50 / p95 / max) ==")
        for name, fam in sorted(timers.items()):
            for s in fam["series"]:
                lbl = ",".join("%s=%s" % kv for kv in
                               sorted(s["labels"].items()))
                lines.append(
                    "  %-52s %-24s n=%-7d %s  %s  %s  %s  %s"
                    % (name, lbl, s["count"], _fmt_s(s["total"]),
                       _fmt_s(s["mean"]), _fmt_s(s["p50"]),
                       _fmt_s(s["p95"]), _fmt_s(s["max"])))
    others = {n: f for n, f in metrics.items() if f.get("type") != "timer"}
    if others:
        lines.append("== counters / gauges ==")
        for name, fam in sorted(others.items()):
            for s in fam["series"]:
                lbl = ",".join("%s=%s" % kv for kv in
                               sorted(s["labels"].items()))
                extra = ("  (peak %g)" % s["high_water"]
                         if "high_water" in s else "")
                lines.append("  %-52s %-24s %g%s"
                             % (name, lbl, s["value"], extra))
    serve = _serve_summary(metrics)
    if serve:
        lines.append("== serving (per service: traffic / batching / "
                     "waste / latency) ==")
        lines.extend(serve)
    slo = _serve_slo_summary(metrics, snap.get("flight", {}))
    if slo:
        lines.append("== SLO burn & exemplars (docs/OBSERVABILITY.md "
                     "\"Flight recorder & request tracing\") ==")
        lines.extend(slo)
    persist = _persist_summary(metrics)
    if persist:
        # standalone section (not nested under serving): a persistent
        # service that has not dispatched a batch yet still has
        # durable state worth one screen
        lines.append("== durability (docs/PERSISTENCE.md) ==")
        lines.extend(persist)
    tuning = _tuning_summary(metrics)
    if tuning:
        lines.append("== tuning (docs/TUNING.md \"Bench-driven "
                     "autotuning\") ==")
        lines.extend(tuning)
    inv = _inventory_summary(snap)
    if inv:
        lines.append("== kernel inventory (launches, operations and bytes "
                     "from ops/cost.py) ==")
        lines.extend(inv)
    ops = _ops_summary(metrics)
    if ops:
        lines.append("== ops plane & anomaly sentinel ==")
        lines.extend(ops)
    ev = snap.get("event_counters", {})
    if ev:
        lines.append("== event counters ==")
        for name, v in sorted(ev.items()):
            lines.append("  %-52s %d" % (name, v))
    report = snap.get("profiler_report")
    tree = snap.get("profiler_tree", {})
    if report:
        lines.append(report)
    elif tree:
        lines.append("== profiler span tree ==")

        def walk(name, node, depth):
            mean = (node["total_s"] / node["count"]) if node["count"] else 0
            lines.append("  %s%-*s n=%-6d total=%s mean=%s"
                         % ("  " * depth, max(1, 36 - 2 * depth), name,
                            node["count"], _fmt_s(node["total_s"]),
                            _fmt_s(mean)))
            for cn, c in sorted(node.get("children", {}).items()):
                walk(cn, c, depth + 1)

        for name, node in sorted(tree.items()):
            walk(name, node, 0)
    return "\n".join(lines) if lines else "(empty snapshot)"


def _fleet_summary(snap: dict) -> list:
    """Fleet digest from a router's ``/debug/snapshot`` payload: one
    row per worker (state / generation / WAL seq / serve digest) plus
    the fleet-wide rollup the router computes from its own end-to-end
    timer — per-worker p50/p95 come from each worker's reservoir; the
    true client p99 only the router sees."""
    fleet = snap.get("fleet")
    if not fleet:
        return []
    rollup = fleet.get("rollup", {})
    lines = ["  mode=%s shards=%s workers=%d (dead %d) uptime=%ss"
             % (fleet.get("mode"), fleet.get("shard_count"),
                rollup.get("workers_total", 0),
                rollup.get("workers_dead", 0),
                rollup.get("uptime_s", 0.0))]
    parts = ["requests=%d" % rollup.get("requests_total", 0),
             "qps=%g" % rollup.get("qps_lifetime", 0.0)]
    for key in sorted(rollup):
        if key.startswith(("p50_", "p99_")):
            parts.append("%s=%gms" % (key[:-3], rollup[key]))
    parts.append("slo_burn_max=%g" % rollup.get("slo_burn_max", 0.0))
    lines.append("  rollup: " + " ".join(parts))
    workers = fleet.get("workers", {})
    if workers:
        lines.append("  %-8s %-9s %-4s %-8s %-6s %-9s %-9s %-8s "
                     "%-10s %-10s %s"
                     % ("worker", "state", "gen", "wal_seq", "queue",
                        "requests", "rejected", "unavail",
                        "exec_p50", "exec_p95", "slo_burn"))
        for wid, d in sorted(workers.items()):
            lines.append(
                "  %-8s %-9s %-4s %-8s %-6s %-9s %-9s %-8s %-10s "
                "%-10s %g"
                % (wid, d.get("state"), d.get("generation", 0),
                   d.get("wal_seq", 0), d.get("queue_depth", 0),
                   d.get("requests_total", "-"),
                   d.get("rejected_total", "-"),
                   d.get("unavailable_total", "-"),
                   "%gms" % d.get("exec_p50_ms", 0.0),
                   "%gms" % d.get("exec_p95_ms", 0.0),
                   d.get("slo_burn", 0.0)))
    stats = fleet.get("stats", {})
    rj = stats.get("last_rejoin") or None
    if rj:
        lines.append("  last rejoin: %s gen=%s replayed=%s "
                     "restore=%ss"
                     % (rj.get("worker_id"), rj.get("generation"),
                        rj.get("replayed_records"),
                        rj.get("restore_s")))
    return lines


def _serve_summary(metrics: dict) -> list:
    """Per-service serving digest from the raw ``raft_tpu_serve_*``
    families: request/batch counts, mean fill, padding-waste ratio
    (padded / dispatched rows), queue-wait and device-call latency.
    The generic tables above still show every series; this section does
    the cross-family arithmetic a dashboard would."""

    def per_service(name):
        fam = metrics.get(name, {})
        out = {}
        for s in fam.get("series", []):
            svc = s["labels"].get("service")
            if svc is not None:
                out[svc] = s
        return out

    requests = per_service("raft_tpu_serve_requests_total")
    if not requests:
        return []
    batches = per_service("raft_tpu_serve_batches_total")
    payload = per_service("raft_tpu_serve_payload_rows_total")
    padded = per_service("raft_tpu_serve_padded_rows_total")
    rejected = per_service("raft_tpu_serve_rejected_total")
    expired = per_service("raft_tpu_serve_expired_total")
    waits = per_service("raft_tpu_serve_wait_seconds")
    execs = per_service("raft_tpu_serve_exec_seconds")
    shard_devs = per_service("raft_tpu_serve_shard_devices")
    reparts = per_service("raft_tpu_serve_repartitions_total")
    lines = []
    for svc in sorted(requests):
        nb = batches.get(svc, {}).get("value", 0)
        pay = payload.get(svc, {}).get("value", 0)
        pad = padded.get(svc, {}).get("value", 0)
        total = pay + pad
        sharded = ""
        if svc in shard_devs and shard_devs[svc].get("value", 0):
            sharded = "  shards=%d" % int(shard_devs[svc]["value"])
            nrep = reparts.get(svc, {}).get("value", 0)
            if nrep:
                sharded += " repartitions=%d" % int(nrep)
        lines.append(
            "  %-24s requests=%-8d batches=%-7d mean_fill=%-7.1f "
            "waste=%.1f%%  rejected=%d expired=%d%s"
            % (svc, requests[svc]["value"], nb,
               (pay / nb) if nb else 0.0,
               (100.0 * pad / total) if total else 0.0,
               rejected.get(svc, {}).get("value", 0),
               expired.get(svc, {}).get("value", 0), sharded))
        w, e = waits.get(svc), execs.get(svc)
        if w or e:
            lines.append(
                "  %-24s   queue wait p50=%s p95=%s   exec p50=%s "
                "p95=%s" % ("",
                            _fmt_s(w["p50"]) if w else "-",
                            _fmt_s(w["p95"]) if w else "-",
                            _fmt_s(e["p50"]) if e else "-",
                            _fmt_s(e["p95"]) if e else "-"))
    lines.extend(_serve_traffic_summary(metrics))
    lines.extend(_serve_resilience_summary(metrics))
    lines.extend(_serve_ann_summary(metrics))
    lines.extend(_serve_ooc_summary(metrics))
    return lines


def _persist_summary(metrics: dict) -> list:
    """Durability digest (docs/PERSISTENCE.md): per-service snapshot
    age/bytes/latency, WAL depth and replay history, scrub progress
    and corruption count — the one screen that answers "how much
    acknowledged work would a crash right now lose, and is the durable
    copy still intact"."""

    def per_service(name):
        fam = metrics.get(name, {})
        return {s["labels"].get("service"): s
                for s in fam.get("series", [])
                if s["labels"].get("service") is not None}

    snaps = per_service("raft_tpu_persist_snapshots_total")
    age = per_service("raft_tpu_persist_snapshot_age_seconds")
    sbytes = per_service("raft_tpu_persist_snapshot_bytes")
    stimer = per_service("raft_tpu_persist_snapshot_seconds")
    wal_rec = per_service("raft_tpu_persist_wal_records")
    wal_b = per_service("raft_tpu_persist_wal_bytes")
    replayed = per_service("raft_tpu_persist_wal_replayed_total")
    restores = per_service("raft_tpu_persist_restores_total")
    checked = per_service("raft_tpu_scrub_checked_total")
    corrupt = per_service("raft_tpu_scrub_corruption_total")
    rebuilt = per_service("raft_tpu_scrub_rebuilt_slots_total")
    progress = per_service("raft_tpu_scrub_progress")
    # union: a just-restored service may not have snapshotted yet but
    # its restore/replay rows still belong on this screen
    services = set(snaps) | set(restores) | set(wal_rec)
    if not services:
        return []
    lines = []
    for svc in sorted(services):
        st = stimer.get(svc)
        lines.append(
            "  %-24s snapshots=%-4d age=%-8s bytes=%-10d "
            "write_mean=%s  wal: records=%d bytes=%d"
            % (svc, int(snaps.get(svc, {}).get("value", 0)),
               "%.1fs" % age[svc]["value"] if svc in age else "-",
               int(sbytes.get(svc, {}).get("value", 0)),
               _fmt_s(st["mean"]) if st else "-",
               int(wal_rec.get(svc, {}).get("value", 0)),
               int(wal_b.get(svc, {}).get("value", 0))))
        nres = int(restores.get(svc, {}).get("value", 0))
        nchk = int(checked.get(svc, {}).get("value", 0))
        ncor = int(corrupt.get(svc, {}).get("value", 0))
        if nres or nchk or ncor:
            lines.append(
                "  %-24s   restores=%d replayed=%d  scrub: checked=%d "
                "progress=%.0f%% corruption=%d rebuilt_slots=%d"
                % ("", nres,
                   int(replayed.get(svc, {}).get("value", 0)), nchk,
                   100.0 * progress.get(svc, {}).get("value", 0.0),
                   ncor,
                   int(rebuilt.get(svc, {}).get("value", 0))))
    return lines


def _serve_slo_summary(metrics: dict, flight: dict) -> list:
    """SLO digest: per-(service, tenant) hit ratio, misses, and the
    multi-window burn rates from the ``raft_tpu_serve_slo_*`` gauges,
    plus the slowest-observation exemplars from the snapshot's
    ``flight`` section — each p99 complaint gets the trace_ids to pull
    with ``tools/torch_trace_report.py``."""
    hit = {}
    for s in metrics.get("raft_tpu_serve_slo_hit_ratio",
                         {}).get("series", []):
        key = (s["labels"].get("service"), s["labels"].get("tenant"))
        if key[0] is not None:
            hit[key] = s["value"]
    burns = {}
    for s in metrics.get("raft_tpu_serve_slo_burn_rate",
                         {}).get("series", []):
        key = (s["labels"].get("service"), s["labels"].get("tenant"))
        if key[0] is not None:
            burns.setdefault(key, []).append(
                (s["labels"].get("window"), s["value"]))
    misses = {}
    for s in metrics.get("raft_tpu_serve_slo_misses_total",
                         {}).get("series", []):
        key = (s["labels"].get("service"), s["labels"].get("tenant"))
        if key[0] is not None:
            misses[key] = int(s["value"])
    lines = []
    for key in sorted(set(hit) | set(burns) | set(misses)):
        svc, tenant = key
        burn_s = "  ".join(
            "burn[%s]=%.2f" % bw
            for bw in sorted(burns.get(key, []), key=lambda t: str(t[0])))
        lines.append(
            "  %-24s tenant=%-12s hit_ratio=%-8.4f misses=%-6d %s"
            % (svc, tenant, hit.get(key, 1.0), misses.get(key, 0),
               burn_s))
    for svc, exemplars in sorted((flight or {}).get("exemplars",
                                                    {}).items()):
        if exemplars:
            lines.append(
                "  %-24s   slowest: %s" % (svc, "  ".join(
                    "%.1fms(trace %d)" % (e["latency_ms"],
                                          e["trace_id"])
                    for e in exemplars[:5])))
    bbs = (flight or {}).get("blackboxes", [])
    if bbs:
        lines.append("  black boxes: %s" % "  ".join(
            "%s@%.1f(%s, %d events)"
            % (b["reason"], b["at"], b.get("service") or "-",
               b["n_events"]) for b in bbs))
    return lines


def _serve_traffic_summary(metrics: dict) -> list:
    """Traffic-shaping digest (docs/SERVING.md "Traffic shaping"):
    per-tenant served rows / requests / sheds, hedged-dispatch ledger
    (fired / won / cancelled / failovers), and replica rotation state
    — the one screen that answers "who got the machine, and did the
    tail-latency defenses fire"."""

    def by_tenant(name):
        out = {}
        for s in metrics.get(name, {}).get("series", []):
            key = (s["labels"].get("service"),
                   s["labels"].get("tenant"))
            if key[0] is not None and key[1] is not None:
                out[key] = int(s["value"])
        return out

    def by_service(name):
        out = {}
        for s in metrics.get(name, {}).get("series", []):
            svc = s["labels"].get("service")
            if svc is not None:
                out[svc] = int(s["value"])
        return out

    lines = []
    rows = by_tenant("raft_tpu_serve_tenant_rows_total")
    reqs = by_tenant("raft_tpu_serve_tenant_requests_total")
    sheds = by_tenant("raft_tpu_serve_tenant_rejected_total")
    tenant_keys = sorted(set(rows) | set(reqs) | set(sheds))
    tenants_by_svc = {}
    for svc, tenant in tenant_keys:
        tenants_by_svc.setdefault(svc, []).append(tenant)
    for svc, tenants in sorted(tenants_by_svc.items()):
        if tenants == ["default"]:
            # a lone default tenant is just the single-queue service
            # again — no shaping to report
            continue
        for tenant in tenants:
            key = (svc, tenant)
            lines.append(
                "  %-24s tenant=%-12s rows=%-8d requests=%-7d "
                "sheds=%d"
                % (svc, tenant, rows.get(key, 0), reqs.get(key, 0),
                   sheds.get(key, 0)))
    hedges = by_service("raft_tpu_serve_hedges_total")
    wins = by_service("raft_tpu_serve_hedge_wins_total")
    cancelled = by_service("raft_tpu_serve_hedge_cancelled_total")
    failovers = by_service("raft_tpu_serve_replica_failovers_total")
    healthy = by_service("raft_tpu_serve_replicas_healthy")
    for svc in sorted(set(hedges) | set(failovers) | set(healthy)):
        lines.append(
            "  %-24s hedges: fired=%-4d won=%-4d cancelled=%-4d "
            "failovers=%-3d replicas_healthy=%s"
            % (svc, hedges.get(svc, 0), wins.get(svc, 0),
               cancelled.get(svc, 0), failovers.get(svc, 0),
               healthy.get(svc, "-")))
    state_names = {0: "closed", 1: "OPEN", 2: "half-open"}
    rep_states = {}
    for s in metrics.get("raft_tpu_serve_replica_state",
                         {}).get("series", []):
        svc = s["labels"].get("service")
        rep = s["labels"].get("replica")
        if svc is not None and rep is not None:
            rep_states.setdefault(svc, []).append(
                (str(rep), state_names.get(int(s["value"]), "?")))
    for svc, reps in sorted(rep_states.items()):
        lines.append("  %-24s   rotation: %s" % (
            svc, "  ".join("r%s=%s" % r for r in sorted(reps))))
    # per-replica execution latency (the per-replica split the
    # adaptive hedge threshold anchors on — one slow replica must be
    # VISIBLE here, not averaged into the rung aggregate)
    rep_lat = {}
    for s in metrics.get("raft_tpu_serve_replica_exec_seconds",
                         {}).get("series", []):
        svc = s["labels"].get("service")
        rep = s["labels"].get("replica")
        if svc is not None and rep is not None and s["count"]:
            rep_lat.setdefault(svc, []).append(
                (str(rep), s["p50"], s["p95"], s["count"]))
    for svc, reps in sorted(rep_lat.items()):
        lines.append("  %-24s   replica exec: %s" % (
            svc, "  ".join(
                "r%s p50=%s p95=%s (n=%d)"
                % (r, _fmt_s(p50), _fmt_s(p95), n)
                for r, p50, p95, n in sorted(reps))))
    return lines


def _tuning_summary(metrics: dict) -> list:
    """Autotuner digest: the active table's fingerprint/source (live
    process only), per-knob table-hit vs miss lookup counts, and the
    tuned-vs-default margins the bench rung measured."""
    out = []
    # live table info — meaningful when rendering in-process (--demo /
    # Session.metrics_snapshot callers); a snapshot file rendered
    # elsewhere simply skips it
    try:
        from raft_tpu_torch import config as _config

        info = _config.tuning_table_info()
    except Exception:
        info = None
    if info:
        fp = info["fingerprint"]
        out.append("  table %s  fingerprint=%s/%s/%d  cells=%d"
                   % (info["source"], fp.get("platform"),
                      fp.get("device_kind"),
                      int(fp.get("device_count", 0)), info["cells"]))
    lookups = metrics.get("raft_tpu_tuning_table_lookups_total", {})
    by_knob = {}
    for s in lookups.get("series", []):
        lbl = s.get("labels", {})
        knob = lbl.get("knob", "?")
        d = by_knob.setdefault(knob,
                               {"hit": 0, "miss": 0, "discarded": 0})
        oc = lbl.get("outcome", "miss")
        d[oc] = d.get(oc, 0) + s.get("value", 0)
    for knob, d in sorted(by_knob.items()):
        total = d["hit"] + d["miss"]
        # effective coverage: a "discarded" answer (illegal for the
        # real call ctx) actually resolved to the default
        eff = d["hit"] - d["discarded"]
        line = ("  %-20s lookups=%-7d from_table=%-7d pinned/"
                "default=%d" % (knob, int(total), int(eff),
                                int(d["miss"] + d["discarded"])))
        if d["discarded"]:
            line += "  (discarded=%d)" % int(d["discarded"])
        out.append(line)
    ratios = metrics.get("raft_tpu_tuning_tuned_vs_default_ratio", {})
    for s in ratios.get("series", []):
        lbl = s.get("labels", {})
        out.append("  tuned_vs_default %-16s [%s] = %.2fx"
                   % (lbl.get("op", "?"), lbl.get("cell", "?"),
                      s.get("value", 0.0)))
    return out


def _inventory_summary(snap: dict) -> list:
    """Kernel inventory digest: per kernel, its shapes, launches, the
    largest shape's operations, the operations and bytes of every shape
    once, the summed footprint; and, where a device mean is known (the
    ops plane's join, or a ``raft_tpu_serve_device_seconds`` timer), the
    achieved rate it implies."""
    inv = snap.get("inventory") or {}
    per_fn = inv.get("per_fn") or {}
    if not per_fn:
        return []
    metrics = snap.get("metrics", {})
    device = {}
    for s in metrics.get("raft_tpu_serve_device_seconds",
                         {}).get("series", []):
        fn = s.get("labels", {}).get("fn")
        if fn and s.get("count"):
            agg = device.setdefault(fn, [0, 0.0])
            agg[0] += s["count"]
            agg[1] += s["count"] * s.get("mean", 0.0)
    lines = ["  shapes=%d  footprint (args+outs+scratch) = %.1f MB"
             % (inv.get("programs", 0),
                inv.get("total_hbm_bytes", 0.0) / 1e6)]
    for fn, st in sorted(per_fn.items()):
        line = ("  %-16s shapes=%-3d launches=%-8d max_flops=%.3g "
                "flops=%.3g bytes=%.3g hbm=%.1fMB"
                % (fn, st["programs"], st.get("launches", 0),
                   st["max_flops"], st.get("total_flops", 0.0),
                   st.get("total_bytes_accessed", 0.0),
                   st["total_hbm_bytes"] / 1e6))
        dev_mean = st.get("device_mean_s")
        if dev_mean is None:
            agg = device.get(fn)
            if agg and agg[0]:
                dev_mean = agg[1] / agg[0]
        if dev_mean:
            line += "  device mean=%s" % _fmt_s(dev_mean)
            if st["max_flops"] > 0:
                line += (" -> >=%.1f GFLOP/s (device-complete)"
                         % (st["max_flops"] / dev_mean / 1e9))
        lines.append(line)
    return lines


def _ops_summary(metrics: dict) -> list:
    """Ops-plane scrape traffic + anomaly-sentinel ledger."""
    lines = []
    by_ep = {}
    for s in metrics.get("raft_tpu_ops_requests_total",
                         {}).get("series", []):
        ep = s["labels"].get("endpoint", "?")
        d = by_ep.setdefault(ep, {"n": 0, "errors": 0})
        d["n"] += int(s["value"])
        if s["labels"].get("code", "200") not in ("200", "503"):
            d["errors"] += int(s["value"])
    lat = {}
    for s in metrics.get("raft_tpu_ops_request_seconds",
                         {}).get("series", []):
        ep = s["labels"].get("endpoint")
        if ep is not None and s.get("count"):
            lat[ep] = s
    for ep, d in sorted(by_ep.items()):
        line = "  %-32s requests=%-7d" % (ep, d["n"])
        if d["errors"]:
            line += " errors=%d" % d["errors"]
        if ep in lat:
            line += ("  handler p50=%s p95=%s"
                     % (_fmt_s(lat[ep]["p50"]), _fmt_s(lat[ep]["p95"])))
        lines.append(line)
    anomalies = {}
    for s in metrics.get("raft_tpu_anomaly_total",
                         {}).get("series", []):
        anomalies[s["labels"].get("rule", "?")] = int(s["value"])
    active = []
    for s in metrics.get("raft_tpu_anomaly_active",
                         {}).get("series", []):
        if s["value"]:
            active.append("%s/%s" % (s["labels"].get("service", "?"),
                                     s["labels"].get("rule", "?")))
    if anomalies:
        lines.append("  anomalies: %s%s" % (
            "  ".join("%s=%d" % kv for kv in sorted(anomalies.items())),
            ("  ACTIVE: " + " ".join(sorted(active))) if active
            else ""))
    return lines


def _serve_resilience_summary(metrics: dict) -> list:
    """Self-healing digest (docs/FAULT_MODEL.md "Serving failure
    model"): live breaker state plus the outage ledger — trips,
    unavailable sheds, requeued riders, worker restarts, recoveries,
    degraded (browned-out) batches — per service."""
    state = {}
    for s in metrics.get("raft_tpu_serve_breaker_state",
                         {}).get("series", []):
        svc = s["labels"].get("service")
        if svc is not None:
            state[svc] = int(s["value"])
    if not state:
        return []
    names = ("closed", "OPEN", "half-open")

    def per_service(name):
        out = {}
        for s in metrics.get(name, {}).get("series", []):
            svc = s["labels"].get("service")
            if svc is not None:
                out[svc] = int(s["value"])
        return out

    trips = per_service("raft_tpu_serve_breaker_trips_total")
    unavail = per_service("raft_tpu_serve_unavailable_total")
    requeued = per_service("raft_tpu_serve_requeued_total")
    restarts = per_service("raft_tpu_serve_worker_restarts_total")
    recoveries = per_service("raft_tpu_serve_recoveries_total")
    degraded = per_service("raft_tpu_serve_degraded_batches_total")
    maint = per_service("raft_tpu_serve_maintenance_errors_total")
    lines = []
    for svc in sorted(state):
        lines.append(
            "  %-24s breaker=%-9s trips=%-3d unavailable=%-5d "
            "requeued=%-4d recoveries=%d"
            % (svc, names[state[svc]], trips.get(svc, 0),
               unavail.get(svc, 0), requeued.get(svc, 0),
               recoveries.get(svc, 0)))
        extra = []
        if degraded.get(svc):
            extra.append("degraded_batches=%d" % degraded[svc])
        if restarts.get(svc):
            extra.append("worker_restarts=%d" % restarts[svc])
        if maint.get(svc):
            extra.append("maintenance_errors=%d" % maint[svc])
        if extra:
            lines.append("  %-24s   %s" % ("", " ".join(extra)))
    return lines


def _serve_ann_summary(metrics: dict) -> list:
    """ANN-service digest (``raft_tpu_serve_ann_*``): streaming-
    ingestion state (delta rows, inserts, compactions) and the
    per-nprobe dispatch mix, so an operator can see at a glance which
    recall cell traffic is actually served at."""
    delta = metrics.get("raft_tpu_serve_ann_delta_rows", {})
    services = {}
    for s in delta.get("series", []):
        svc = s["labels"].get("service")
        if svc is not None:
            services[svc] = {"delta_rows": s["value"]}
    if not services:
        return []

    def add(name, key):
        for s in metrics.get(name, {}).get("series", []):
            svc = s["labels"].get("service")
            if svc in services:
                services[svc][key] = s["value"]

    add("raft_tpu_serve_ann_inserts_total", "inserts")
    add("raft_tpu_serve_ann_compactions_total", "compactions")
    add("raft_tpu_serve_ann_compacted_rows_total", "compacted_rows")
    calls = {}
    for s in metrics.get("raft_tpu_serve_ann_calls_total",
                         {}).get("series", []):
        svc = s["labels"].get("service")
        if svc in services:
            calls.setdefault(svc, []).append(
                (s["labels"].get("nprobe"), int(s["value"])))
    lines = []
    for svc in sorted(services):
        st = services[svc]
        lines.append(
            "  %-24s ANN: delta_rows=%-6d inserts=%-7d "
            "compactions=%d (rows=%d)"
            % (svc, st.get("delta_rows", 0), st.get("inserts", 0),
               st.get("compactions", 0), st.get("compacted_rows", 0)))
        mix = sorted(calls.get(svc, []), key=lambda t: str(t[0]))
        if mix:
            lines.append("  %-24s   batches by nprobe: %s" % (
                "", "  ".join("nprobe=%s:%d" % t for t in mix)))
    return lines


def _serve_ooc_summary(metrics: dict) -> list:
    """Out-of-core tier digest (docs/SERVING.md "Out-of-core
    serving"): hot-set size, tile hit rate, H2D traffic, and the
    overlap-efficiency number — the *hidden-transfer fraction*
    ``1 - stall/h2d``: how much of the host-to-device copy time was
    buried under the scan by the double-buffered prefetch (1.0 =
    fully hidden, 0.0 = every transfer paid serially, which is what
    the synchronous-prefetch arm measures)."""

    def by_label(name, label):
        out = {}
        for s in metrics.get(name, {}).get("series", []):
            key = s["labels"].get(label)
            if key is not None:
                out[key] = s
        return out

    hits = by_label("raft_tpu_tile_hits_total", "pool")
    misses = by_label("raft_tpu_tile_misses_total", "pool")
    pools = sorted(set(hits) | set(misses))
    if not pools:
        return []
    evictions = by_label("raft_tpu_tile_evictions_total", "pool")
    h2d_bytes = by_label("raft_tpu_h2d_bytes_total", "pool")
    h2d = by_label("raft_tpu_h2d_seconds", "pool")
    stall = by_label("raft_tpu_h2d_stall_seconds", "pool")
    staged = by_label("raft_tpu_tile_staged_bytes", "pool")
    hot_slots = by_label("raft_tpu_ooc_hot_slots", "service")
    hot_bytes = by_label("raft_tpu_ooc_hot_bytes", "service")
    lines = []
    for pool in pools:
        h = hits.get(pool, {}).get("value", 0)
        m = misses.get(pool, {}).get("value", 0)
        rate = h / (h + m) if (h + m) else 0.0
        h2d_t = h2d.get(pool, {}).get("total", 0.0)
        stall_t = stall.get(pool, {}).get("total", 0.0)
        hidden = (1.0 - stall_t / h2d_t) if h2d_t else 0.0
        lines.append(
            "  %-24s OOC: hot_slots=%-6d hot_mb=%-8.1f "
            "tile_hit_rate=%.3f evictions=%d"
            % (pool, hot_slots.get(pool, {}).get("value", 0),
               hot_bytes.get(pool, {}).get("value", 0) / 1e6,
               rate, evictions.get(pool, {}).get("value", 0)))
        lines.append(
            "  %-24s   h2d=%.1fMB in %s (stall %s, hidden-transfer "
            "fraction %.2f)  staged_peak=%.1fMB"
            % ("", h2d_bytes.get(pool, {}).get("value", 0) / 1e6,
               _fmt_s(h2d_t), _fmt_s(stall_t), hidden,
               staged.get(pool, {}).get("high_water", 0) / 1e6))
    return lines


def run_demo(device="cuda") -> dict:
    """A tiny instrumented run of the port on ``device``: pairwise, kNN
    twice, two allreduces, a buffer, and a warmed ``KNNService``."""
    import numpy as np
    import torch

    from raft_tpu_torch.comms import HostComms
    from raft_tpu_torch.comms.mesh import default_mesh
    from raft_tpu_torch.distance.pairwise import pairwise_distance
    from raft_tpu_torch.mr.buffer import DeviceBuffer
    from raft_tpu_torch.serve import KNNService
    from raft_tpu_torch.session import metrics_snapshot
    from raft_tpu_torch.spatial.knn import brute_force_knn

    rng = np.random.default_rng(0)
    X = rng.standard_normal((256, 32)).astype(np.float32)
    Q = rng.standard_normal((32, 32)).astype(np.float32)
    pairwise_distance(Q, X, device=device)
    for _ in range(2):
        brute_force_knn(X, Q, k=4, device=device)
    comms = HostComms(default_mesh(device=device))
    size = comms.get_size()
    for _ in range(2):
        comms.allreduce(torch.ones((size, 4), device=comms.home))
    with DeviceBuffer((1024, 1024), device=device):
        pass
    svc = KNNService(X, k=4, max_batch_rows=32, max_wait_ms=1.0, device=device)
    try:
        svc.warmup()
        for f in svc.submit_many([Q[:3], Q[3:8], Q[8:12]]):
            f.result(timeout=30)
    finally:
        svc.close()
    return metrics_snapshot()


def _load_snapshot(args) -> dict:
    """One snapshot from whichever source the CLI named: the ops
    plane's ``/debug/snapshot`` (``--url``), a dumped JSON file, or
    the --demo workload."""
    if args.demo:
        return run_demo(args.device)
    if args.url:
        import urllib.request

        url = args.url.rstrip("/") + "/debug/snapshot"
        with urllib.request.urlopen(url, timeout=10) as resp:
            return json.load(resp)
    with open(args.snapshot, encoding="utf-8") as f:
        snap = json.load(f)
    # bench.py artifact? unwrap to its embedded snapshot
    for path in (("metrics_snapshot",), ("detail", "metrics_snapshot")):
        cur = snap
        for k in path:
            cur = cur.get(k, {}) if isinstance(cur, dict) else {}
        if cur:
            snap = cur
            break
    return snap


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("snapshot", nargs="?",
                    help="snapshot JSON (Session.dump_metrics or bench "
                         "output; bench files are unwrapped automatically)")
    ap.add_argument("--demo", action="store_true",
                    help="run a small instrumented workload instead of "
                         "reading a file")
    ap.add_argument("--url", metavar="URL",
                    help="poll a live ops plane (Session.serve_ops / "
                         "OpsPlane) at URL instead of reading a file — "
                         "fetches /debug/snapshot")
    ap.add_argument("--watch", type=float, default=None, metavar="N",
                    help="live mode: re-fetch (--url) or re-read (a "
                         "snapshot file) every N seconds and re-render "
                         "the digest in place; Ctrl-C exits")
    ap.add_argument("--format", choices=("report", "json", "prom"),
                    default="report")
    ap.add_argument("--out", help="also write the snapshot JSON here")
    ap.add_argument("--device", default="cuda",
                    help="--demo: where it runs (default cuda; cpu runs the "
                         "plain versions)")
    args = ap.parse_args(argv)

    n_sources = sum((args.demo, args.snapshot is not None,
                     args.url is not None))
    if n_sources != 1:
        ap.error("pass exactly one of: a snapshot file, --url, or "
                 "--demo")
    if args.demo and args.device.startswith("cuda"):
        import torch

        if not torch.cuda.is_available():
            print("torch_metrics_report: --demo found no CUDA device (pass "
                  "--device cpu to run the plain versions on the CPU)",
                  file=sys.stderr)
            return 2
    if args.watch is not None:
        if args.demo:
            ap.error("--watch needs a re-readable source: --url or a "
                     "snapshot file")
        if args.watch <= 0:
            ap.error("--watch N must be positive seconds")
        import time as _time

        try:
            while True:
                snap = _load_snapshot(args)
                # clear + home, then one full render — the digest
                # redraws in place like `watch(1)` would
                sys.stdout.write("\x1b[2J\x1b[H")
                print("[%s  every %gs  source: %s]" % (
                    _time.strftime("%H:%M:%S"), args.watch,
                    args.url or args.snapshot))
                print(render_report(snap))
                sys.stdout.flush()
                _time.sleep(args.watch)
        except KeyboardInterrupt:
            return 0

    snap = _load_snapshot(args)

    if args.out:
        with open(args.out, "w", encoding="utf-8") as f:
            json.dump(snap, f, indent=2, sort_keys=True)
            f.write("\n")

    if args.format == "json":
        print(json.dumps(snap, indent=2, sort_keys=True))
    elif args.format == "prom":
        if args.demo:
            from raft_tpu_torch.core.metrics import default_registry

            print(default_registry().to_prometheus(), end="")
        elif args.url:
            import urllib.request

            with urllib.request.urlopen(
                    args.url.rstrip("/") + "/metrics",
                    timeout=10) as resp:
                sys.stdout.write(resp.read().decode("utf-8"))
        else:
            print("--format prom needs a live registry; use --demo "
                  "or --url (a dumped snapshot is already flattened)",
                  file=sys.stderr)
            return 2
    else:
        print(render_report(snap))
    return 0


if __name__ == "__main__":
    sys.exit(main())
