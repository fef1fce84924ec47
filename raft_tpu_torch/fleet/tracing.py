"""Fleet trace aggregation: join router hop spans with worker
timelines into one clock-aligned cross-process waterfall.

Port of ``raft_tpu/fleet/tracing.py`` (host-side only).  This is the
read side of fleet tracing.  The write side is distributed: the router records its own
hops (``fleet_admitted`` → ``fleet_rpc_send``/``fleet_rpc_recv`` per
worker → ``fleet_merge`` → ``fleet_resolved``/``failed``/``expired``)
into a router-local flight ring under the fleet request id, while each
worker's :class:`~raft_tpu_torch.core.flight.FlightRecorder` indexes the
local traces created under the propagated context
(:func:`raft_tpu_torch.core.flight.trace_context`).  This module joins the
two halves:

- :func:`local_payload` — a worker's half of the join (its indexed
  traces for a fleet id, stamped with the worker's own clock), served
  by the worker's ``GET /debug/trace`` endpoint.
- :func:`join` — shift each worker's timestamps by the router's
  NTP-style clock-offset estimate for that worker (measured over the
  heartbeat ping: ``offset = router_mid - (t0 + t1) / 2``) and merge
  with the router's spans into one ordered span list plus per-hop
  summaries.
- :func:`hop_segments` — the gapless tiling of a request: router
  dispatch → network out → worker → network back → router merge, per
  hop.  Boundary monotonicity IS the gapless property.
- :func:`validate` — the waterfall invariants a healthy joined trace
  satisfies: exactly one router terminal, per-process monotonic
  timestamps, and every worker span nested inside its RPC bracket
  after alignment (within a tolerance floored by the ping RTT — clock
  alignment can never be better than half the round trip that
  measured it).

Everything here is stdlib-pure: the aggregation path never touches a
device or blocks a worker loop.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from raft_tpu_torch.core import flight

__all__ = [
    "ROUTER_TERMINALS", "local_payload", "align_events", "join",
    "hop_segments", "validate",
]

# the router-side terminal vocabulary (mirrors flight.TERMINAL_KINDS
# with the fleet_ prefix the router records under)
ROUTER_TERMINALS = frozenset(
    ("fleet_resolved", "fleet_failed", "fleet_expired"))

# default nesting tolerance floor, seconds: covers scheduling jitter
# between "event recorded" and "frame on the wire" on loopback
DEFAULT_TOL_S = 0.005


def local_payload(fleet_id: str, worker_id: Optional[str] = None,
                  generation: Optional[int] = None,
                  clock: Callable[[], float] = time.monotonic) -> dict:
    """One process's half of the cross-process join: every local trace
    indexed under ``fleet_id`` (each with its private event list, so
    this works after the global ring wrapped), stamped with this
    process's identity and monotonic clock ``now`` (all event
    timestamps in the payload are THIS clock's seconds — the router
    aligns them)."""
    traces = flight.fleet_traces(str(fleet_id))
    return {
        "fleet": str(fleet_id),
        "worker_id": worker_id,
        "generation": generation,
        "now": clock(),
        "traces": [t.to_dict() for t in traces],
    }


def align_events(events: List[dict], offset_s: float,
                 proc: str) -> List[dict]:
    """Shift a timeline into router-clock seconds (``ts + offset_s``)
    and stamp each event with the process it happened on."""
    out = []
    for ev in events:
        ev = dict(ev)
        ev["ts"] = float(ev["ts"]) + float(offset_s)
        ev["proc"] = proc
        out.append(ev)
    return out


def join(fleet_id: str, router_events: List[dict],
         workers: Dict[str, dict]) -> dict:
    """Join the router's span timeline with the owning workers'
    aligned timelines.

    Parameters
    ----------
    router_events:
        The router-local trace's event dicts for this fleet id
        (router clock).
    workers:
        ``worker_id -> {"offset_s", "rtt_s", "payload"}`` where
        ``payload`` is :func:`local_payload` output fetched from that
        worker and ``offset_s`` is the router's clock-offset estimate
        (router_clock - worker_clock; worker ts + offset = router ts).

    Returns the joined view: ``spans`` (every event, router clock,
    sorted, each stamped with ``proc``), ``hops`` (per-worker RPC
    bracket summaries), ``terminal`` (the router-side terminal kind or
    None), and per-worker alignment metadata.
    """
    spans = align_events(list(router_events), 0.0, "router")
    hops: Dict[str, dict] = {}
    for ev in router_events:
        wid = ev.get("worker")
        if wid is None:
            continue
        hop = hops.setdefault(str(wid), {
            "sends": [], "recvs": [], "late": [],
            "network_s": [], "server_s": []})
        if ev.get("kind") == "fleet_rpc_send":
            hop["sends"].append(float(ev["ts"]))
        elif ev.get("kind") == "fleet_rpc_recv":
            if ev.get("late"):
                # a hedged loser's reply after the terminal: keep it
                # out of the bracket timing (it would stretch the
                # merge segment past the terminal) but count it
                hop["late"].append(float(ev["ts"]))
                continue
            hop["recvs"].append(float(ev["ts"]))
            if ev.get("network_s") is not None:
                hop["network_s"].append(float(ev["network_s"]))
            if ev.get("server_s") is not None:
                hop["server_s"].append(float(ev["server_s"]))
    align: Dict[str, dict] = {}
    for wid, info in sorted(workers.items()):
        payload = info.get("payload") or {}
        offset = float(info.get("offset_s", 0.0) or 0.0)
        align[wid] = {
            "offset_s": round(offset, 6),
            "rtt_s": round(float(info.get("rtt_s", 0.0) or 0.0), 6),
            "traces": len(payload.get("traces", ())),
            "generation": payload.get("generation"),
        }
        for tr in payload.get("traces", ()):
            spans.extend(align_events(tr.get("events", []), offset,
                                      wid))
    spans.sort(key=lambda e: float(e["ts"]))
    terminal = None
    for ev in reversed(router_events):
        if ev.get("kind") in ROUTER_TERMINALS:
            terminal = ev["kind"]
            break
    return {"fleet": str(fleet_id), "terminal": terminal,
            "spans": spans, "hops": {
                wid: {
                    "attempts": len(h["recvs"]) + len(h["late"]),
                    "late_recvs": len(h["late"]),
                    "first_send": min(h["sends"]) if h["sends"] else None,
                    "last_recv": max(h["recvs"]) if h["recvs"] else None,
                    "network_s": round(sum(h["network_s"]), 6),
                    "server_s": round(sum(h["server_s"]), 6),
                } for wid, h in sorted(hops.items())},
            "align": align}


def _proc_events(joined: dict) -> Dict[str, List[dict]]:
    by_proc: Dict[str, List[dict]] = {}
    for ev in joined.get("spans", ()):
        by_proc.setdefault(ev.get("proc", "?"), []).append(ev)
    return by_proc


def hop_segments(joined: dict) -> List[dict]:
    """The gapless tiling of the request per hop, router clock: each
    segment is ``{"proc", "name", "t0", "t1"}`` and consecutive
    boundaries are shared — router dispatch ends exactly where the
    outbound network segment begins.  Rendered by
    ``tools/trace_report.py``; :func:`validate` checks the boundary
    ordering that makes the tiling real."""
    by_proc = _proc_events(joined)
    router = by_proc.get("router", [])
    admitted = next((float(e["ts"]) for e in router
                     if e.get("kind") == "fleet_admitted"), None)
    term_ts = next((float(e["ts"]) for e in reversed(router)
                    if e.get("kind") in ROUTER_TERMINALS), None)
    if admitted is None:
        return []
    segs: List[dict] = []
    sends, recvs = [], []
    for wid, hop in joined.get("hops", {}).items():
        send, recv = hop.get("first_send"), hop.get("last_recv")
        if send is None:
            continue
        sends.append(send)
        wevs = by_proc.get(wid, [])
        w0 = min((float(e["ts"]) for e in wevs), default=None)
        w1 = max((float(e["ts"]) for e in wevs), default=None)
        if w0 is not None and w1 is not None:
            segs.append({"proc": wid, "name": "network_out",
                         "t0": send, "t1": w0})
            segs.append({"proc": wid, "name": "worker",
                         "t0": w0, "t1": w1})
            if recv is not None:
                segs.append({"proc": wid, "name": "network_back",
                             "t0": w1, "t1": recv})
        if recv is not None:
            recvs.append(recv)
    if sends:
        segs.append({"proc": "router", "name": "dispatch",
                     "t0": admitted, "t1": min(sends)})
    if recvs and term_ts is not None:
        segs.append({"proc": "router", "name": "merge_relay",
                     "t0": max(recvs), "t1": term_ts})
    segs.sort(key=lambda s: (s["t0"], s["t1"]))
    return segs


def validate(joined: dict,
             tol_s: float = DEFAULT_TOL_S) -> List[str]:
    """The waterfall invariants (module doc).  Returns human-readable
    problem strings; empty = the joined trace is monotonic and gapless
    after clock alignment with exactly one terminal per process hop.
    The per-worker tolerance is ``tol_s + rtt/2`` — the offset
    estimator's own uncertainty bound."""
    problems: List[str] = []
    by_proc = _proc_events(joined)
    router = by_proc.get("router", [])
    terms = [e for e in router if e.get("kind") in ROUTER_TERMINALS]
    if len(terms) != 1:
        problems.append("router terminal events: %d (want exactly 1: %s)"
                        % (len(terms),
                           [e["kind"] for e in terms] or "none"))
    for proc, evs in sorted(by_proc.items()):
        last = None
        for ev in evs:
            ts = float(ev["ts"])
            if last is not None and ts < last - 1e-9:
                problems.append(
                    "%s: non-monotonic timeline at %r (%.6f < %.6f)"
                    % (proc, ev.get("kind"), ts, last))
                break
            last = ts
    admitted = next((float(e["ts"]) for e in router
                     if e.get("kind") == "fleet_admitted"), None)
    term_ts = float(terms[0]["ts"]) if len(terms) == 1 else None
    for wid, hop in sorted(joined.get("hops", {}).items()):
        send, recv = hop.get("first_send"), hop.get("last_recv")
        tol = tol_s + float(
            joined.get("align", {}).get(wid, {}).get("rtt_s", 0.0)) / 2.0
        if admitted is not None and send is not None \
                and send < admitted - 1e-9:
            problems.append("%s: rpc send %.6f before admission %.6f"
                            % (wid, send, admitted))
        if term_ts is not None and recv is not None \
                and recv > term_ts + tol:
            problems.append("%s: rpc recv %.6f after terminal %.6f"
                            % (wid, recv, term_ts))
        wevs = by_proc.get(wid, [])
        if not wevs:
            continue
        w_terms = [e for e in wevs
                   if e.get("kind") in flight.TERMINAL_KINDS]
        # one terminal per local trace on this hop (a retried hop
        # legitimately has several local traces, each with one)
        per_trace: Dict[Any, int] = {}
        for e in w_terms:
            per_trace[e.get("trace_id")] = per_trace.get(
                e.get("trace_id"), 0) + 1
        for tid, n in sorted(per_trace.items(), key=lambda kv: str(kv)):
            if n != 1:
                problems.append("%s: local trace %s has %d terminals"
                                % (wid, tid, n))
        w0 = min(float(e["ts"]) for e in wevs)
        w1 = max(float(e["ts"]) for e in wevs)
        if send is not None and w0 < send - tol:
            problems.append(
                "%s: worker span starts %.6f before rpc send %.6f "
                "(tol %.6f) — clock alignment gap" % (wid, w0, send, tol))
        if recv is not None and w1 > recv + tol:
            problems.append(
                "%s: worker span ends %.6f after rpc recv %.6f "
                "(tol %.6f) — clock alignment gap" % (wid, w1, recv, tol))
    return problems
