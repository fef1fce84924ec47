#!/usr/bin/env python3
"""Render raft_tpu_torch flight-recorder traces, with no JAX.

The port's arm of ``tools/trace_report.py``: the same renderings of the
same payloads, string for string, over the port's
``raft_tpu_torch/fleet/tracing.py:hop_segments`` (the JAX tool imports
the JAX package for it, and so JAX).

- **Chrome trace-event JSON** (``--chrome out.json``): the format
  chrome://tracing and Perfetto open directly.  Request brackets (queue
  wait = admitted to batch_formed, execute = execute_launch to
  execute_ready, total = admitted to terminal) become complete ("X")
  slices, one track per trace_id; everything else (hedges, requeues,
  breaker transitions, compactions) becomes instant events; system
  events without a trace_id land on a per-service ``system`` track.
- **Terminal waterfall** (``--trace-id N``): one request's timeline as
  an offset-annotated bar chart (``tools/torch_loadgen.py --trace``
  prints the same rendering for the slowest requests of a run).
- **Fleet waterfall**: a ``/fleet/debug/trace/<id>`` joined payload
  renders as one clock-aligned cross-process waterfall (router hops and
  worker timelines on the router's clock, plus the gapless hop tiling:
  dispatch, network out, worker, network back, merge).  ``--chrome``
  exports the same join as Perfetto tracks, one process track a hop.
  The payload shape is auto-detected.

Input is any flight dump JSON: ``FlightRecorder.dump_to()`` output
(``{"events": [...], "blackboxes": [...]}``), a single black-box dump
(``{"reason", "events"}``), a bare event list, or a fleet-join payload
(``{"fleet", "spans", ...}``).  Events are dicts with at least ``ts``
(monotonic seconds) and ``kind``.

Usage:
    python3 tools/torch_trace_report.py dump.json                # summary
    python3 tools/torch_trace_report.py dump.json --trace-id 17  # waterfall
    python3 tools/torch_trace_report.py dump.json --chrome trace.json
    python3 tools/torch_trace_report.py joined.json              # fleet view

Importable: :func:`to_chrome_trace`, :func:`render_waterfall`,
:func:`render_fleet_waterfall`, :func:`fleet_to_chrome_trace`,
:func:`trace_ids`, :func:`summarize`.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Dict, List, Optional

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

# bracket pairs rendered as complete slices: name -> (open kind, close
# kind); "total" additionally closes on any terminal kind
BRACKETS = {
    "queue": ("admitted", "batch_formed"),
    "execute": ("execute_launch", "execute_ready"),
}
TERMINALS = ("resolved", "expired", "failed")


def load_events(obj) -> List[dict]:
    """Events out of any flight dump shape (module doc)."""
    if isinstance(obj, list):
        return list(obj)
    if isinstance(obj, dict):
        if "events" in obj:
            return list(obj["events"])
        if "ring" in obj:
            return list(obj["ring"])
    raise SystemExit("unrecognized flight dump shape (want a list of "
                     "events, or a dict with 'events')")


def event_trace_ids(ev: dict) -> List[int]:
    """The trace ids an event belongs to: its own ``trace_id``, or —
    for a shared batch-level ring event — the rider list the recorder
    stamped as ``traces`` (empty = a system event)."""
    tid = ev.get("trace_id")
    if tid is not None:
        return [int(tid)]
    return [int(t) for t in ev.get("traces", ())]


def trace_ids(events: List[dict]) -> List[int]:
    """Distinct trace ids present, admission order."""
    seen: Dict[int, None] = {}
    for ev in events:
        for tid in event_trace_ids(ev):
            seen.setdefault(tid, None)
    return list(seen)


def _by_trace(events: List[dict]) -> Dict[int, List[dict]]:
    out: Dict[int, List[dict]] = {}
    for ev in events:
        for tid in event_trace_ids(ev):
            out.setdefault(tid, []).append(ev)
    return out


def to_chrome_trace(events: List[dict]) -> List[dict]:
    """Chrome trace-event JSON objects (the ``traceEvents`` array;
    Perfetto accepts the bare array too).  Timestamps are microseconds
    relative to the earliest event."""
    if not events:
        return []
    t0 = min(float(ev["ts"]) for ev in events)

    def us(ts: float) -> float:
        return round((float(ts) - t0) * 1e6, 1)

    out: List[dict] = []
    for tid, evs in sorted(_by_trace(events).items()):
        svc = next((e.get("service") for e in evs
                    if e.get("service")), "serve")
        track = "trace %d" % tid
        opens: Dict[str, float] = {}
        first_ts = float(evs[0]["ts"])
        for ev in evs:
            kind = ev["kind"]
            for name, (ko, kc) in BRACKETS.items():
                if kind == ko:
                    opens[name] = float(ev["ts"])
                elif kind == kc and name in opens:
                    start = opens.pop(name)
                    out.append({"name": name, "ph": "X", "pid": svc,
                                "tid": track, "ts": us(start),
                                "dur": round(
                                    (float(ev["ts"]) - start) * 1e6,
                                    1)})
            args = {k: v for k, v in ev.items()
                    if k not in ("ts", "kind")}
            out.append({"name": kind, "ph": "i", "s": "t", "pid": svc,
                        "tid": track, "ts": us(ev["ts"]), "args": args})
            if kind in TERMINALS:
                out.append({"name": "request", "ph": "X", "pid": svc,
                            "tid": track, "ts": us(first_ts),
                            "dur": round(
                                (float(ev["ts"]) - first_ts) * 1e6, 1),
                            "args": {"terminal": kind}})
    for ev in events:
        if not event_trace_ids(ev):
            svc = ev.get("service") or "system"
            args = {k: v for k, v in ev.items()
                    if k not in ("ts", "kind")}
            out.append({"name": ev["kind"], "ph": "i", "s": "g",
                        "pid": svc, "tid": "system",
                        "ts": us(ev["ts"]), "args": args})
    out.sort(key=lambda e: e["ts"])
    return out


def render_waterfall(timeline: List[dict], width: int = 48) -> str:
    """One trace's timeline as a terminal waterfall: per event, the
    offset from admission, a position marker scaled over the request's
    total duration, the kind, and the load-bearing attrs."""
    if not timeline:
        return "(empty trace)"
    t0 = float(timeline[0]["ts"])
    t1 = float(timeline[-1]["ts"])
    span = max(t1 - t0, 1e-9)
    head = timeline[0]
    lines = ["trace %s  service=%s tenant=%s  total=%.3fms"
             % (head.get("trace_id", "?"), head.get("service", "?"),
                head.get("tenant", "?"), span * 1e3)]
    for ev in timeline:
        off = float(ev["ts"]) - t0
        pos = min(width - 1, int(round(off / span * (width - 1))))
        bar = "·" * pos + "█"
        attrs = {k: v for k, v in ev.items()
                 if k not in ("ts", "kind", "service", "tenant",
                              "trace_id", "traces") and v is not None}
        attr_s = " ".join("%s=%s" % kv for kv in sorted(attrs.items()))
        lines.append("  %9.3fms  %-*s %-16s %s"
                     % (off * 1e3, width + 1, bar, ev["kind"], attr_s))
    return "\n".join(lines)


def is_fleet_join(obj) -> bool:
    """True when ``obj`` is a ``/fleet/debug/trace/<id>`` joined
    payload rather than a flat flight dump."""
    return (isinstance(obj, dict) and "fleet" in obj
            and "spans" in obj)


def _bar(t0: float, t1: float, lo: float, span: float,
         width: int) -> str:
    """A ``[t0, t1]`` extent as a fixed-width bar over ``[lo,
    lo+span]``."""
    p0 = min(width - 1, max(0, int((t0 - lo) / span * (width - 1))))
    p1 = min(width - 1, max(p0, int((t1 - lo) / span * (width - 1))))
    return "·" * p0 + "█" * (p1 - p0 + 1) + "·" * (width - 1 - p1)


def render_fleet_waterfall(joined: dict, width: int = 48) -> str:
    """A joined fleet trace as one terminal waterfall: alignment
    header, per-hop summary, the gapless hop tiling, then every span
    (router clock, process-labelled)."""
    from raft_tpu_torch.fleet import tracing

    spans = list(joined.get("spans") or ())
    if not spans:
        return ("fleet trace %s: no spans (expired from the ring, or "
                "never admitted)" % joined.get("fleet"))
    lo = min(float(e["ts"]) for e in spans)
    hi = max(float(e["ts"]) for e in spans)
    span = max(hi - lo, 1e-9)
    lines = ["fleet trace %s  terminal=%s  total=%.3fms  workers=%d%s"
             % (joined.get("fleet"), joined.get("terminal"),
                span * 1e3, len(joined.get("hops") or ()),
                "  [PARTIAL]" if joined.get("partial") else "")]
    for wid, a in sorted((joined.get("align") or {}).items()):
        lines.append("  align %-8s offset=%+.3fms rtt=%.3fms "
                     "traces=%s gen=%s"
                     % (wid, a.get("offset_s", 0.0) * 1e3,
                        a.get("rtt_s", 0.0) * 1e3,
                        a.get("traces"), a.get("generation")))
    for wid, hop in sorted((joined.get("hops") or {}).items()):
        lines.append("  hop   %-8s attempts=%d network=%.3fms "
                     "server=%.3fms"
                     % (wid, hop.get("attempts", 0),
                        hop.get("network_s", 0.0) * 1e3,
                        hop.get("server_s", 0.0) * 1e3))
    segs = tracing.hop_segments(joined)
    if segs:
        lines.append("  -- hop tiling (gapless boundaries) --")
        for seg in segs:
            lines.append(
                "  %9.3fms  %s %-8s %-12s %.3fms"
                % ((seg["t0"] - lo) * 1e3,
                   _bar(seg["t0"], seg["t1"], lo, span, width),
                   seg["proc"], seg["name"],
                   (seg["t1"] - seg["t0"]) * 1e3))
    lines.append("  -- spans (router clock) --")
    for ev in spans:
        off = float(ev["ts"]) - lo
        pos = min(width - 1, int(round(off / span * (width - 1))))
        bar = "·" * pos + "█"
        attrs = {k: v for k, v in ev.items()
                 if k not in ("ts", "kind", "service", "tenant",
                              "trace_id", "traces", "proc")
                 and v is not None}
        attr_s = " ".join("%s=%s" % kv for kv in sorted(attrs.items()))
        lines.append("  %9.3fms  %-*s %-8s %-16s %s"
                     % (off * 1e3, width + 1, bar,
                        ev.get("proc", "?"), ev["kind"], attr_s))
    for prob in joined.get("problems") or ():
        lines.append("  !! %s" % prob)
    return "\n".join(lines)


def fleet_to_chrome_trace(joined: dict) -> List[dict]:
    """A joined fleet trace as Chrome trace-event JSON: one Perfetto
    process track per hop (router + each worker), the gapless hop
    tiling as complete slices, every span as an instant event, and
    the request total on the router track."""
    from raft_tpu_torch.fleet import tracing

    spans = list(joined.get("spans") or ())
    if not spans:
        return []
    lo = min(float(e["ts"]) for e in spans)

    def us(ts: float) -> float:
        return round((float(ts) - lo) * 1e6, 1)

    out: List[dict] = []
    for seg in tracing.hop_segments(joined):
        out.append({"name": seg["name"], "ph": "X",
                    "pid": seg["proc"], "tid": "hops",
                    "ts": us(seg["t0"]),
                    "dur": round((seg["t1"] - seg["t0"]) * 1e6, 1)})
    admitted = None
    terminal_ts = None
    for ev in spans:
        proc = ev.get("proc", "?")
        track = ("trace %s" % ev["trace_id"]
                 if ev.get("trace_id") is not None else "events")
        args = {k: v for k, v in ev.items()
                if k not in ("ts", "kind", "proc")}
        out.append({"name": ev["kind"], "ph": "i", "s": "t",
                    "pid": proc, "tid": track, "ts": us(ev["ts"]),
                    "args": args})
        if proc == "router":
            if ev["kind"] == "fleet_admitted":
                admitted = float(ev["ts"])
            elif ev["kind"] == joined.get("terminal"):
                terminal_ts = float(ev["ts"])
    if admitted is not None and terminal_ts is not None:
        out.append({"name": "fleet request", "ph": "X",
                    "pid": "router", "tid": "hops",
                    "ts": us(admitted),
                    "dur": round((terminal_ts - admitted) * 1e6, 1),
                    "args": {"fleet": joined.get("fleet"),
                             "terminal": joined.get("terminal")}})
    out.sort(key=lambda e: e["ts"])
    return out


def summarize(events: List[dict]) -> str:
    """Per-trace one-liners plus the system-event tail — the index a
    postmortem starts from."""
    lines = []
    traces = _by_trace(events)
    if traces:
        lines.append("== traces (%d) ==" % len(traces))
        for tid, evs in sorted(traces.items()):
            term = next((e["kind"] for e in reversed(evs)
                         if e["kind"] in TERMINALS), "in-flight")
            dur = (float(evs[-1]["ts"]) - float(evs[0]["ts"])) * 1e3
            lines.append(
                "  trace %-8d %-10s %-9s %8.3fms  %d events"
                % (tid, evs[0].get("service", "?"), term, dur,
                   len(evs)))
    system = [e for e in events if not event_trace_ids(e)]
    if system:
        lines.append("== system events (%d) ==" % len(system))
        for ev in system[-40:]:
            attrs = {k: v for k, v in ev.items()
                     if k not in ("ts", "kind", "service")}
            lines.append("  %14.6f  %-18s %-10s %s"
                         % (float(ev["ts"]), ev["kind"],
                            ev.get("service", "-"),
                            " ".join("%s=%s" % kv
                                     for kv in sorted(attrs.items()))))
    return "\n".join(lines) if lines else "(no events)"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("dump", help="flight dump JSON "
                                 "(FlightRecorder.dump_to / black-box "
                                 "file / bare event list)")
    ap.add_argument("--trace-id", type=int, default=None,
                    help="render one trace's terminal waterfall")
    ap.add_argument("--chrome", metavar="OUT.json", default=None,
                    help="write Chrome trace-event JSON "
                         "(chrome://tracing / Perfetto)")
    args = ap.parse_args(argv)

    with open(args.dump, encoding="utf-8") as f:
        obj = json.load(f)

    if is_fleet_join(obj):
        if args.chrome:
            chrome = fleet_to_chrome_trace(obj)
            with open(args.chrome, "w", encoding="utf-8") as f:
                json.dump({"traceEvents": chrome}, f, indent=2,
                          sort_keys=True)
                f.write("\n")
            print("wrote %d chrome events to %s"
                  % (len(chrome), args.chrome))
            return 0
        print(render_fleet_waterfall(obj))
        return 0

    events = load_events(obj)

    if args.chrome:
        chrome = to_chrome_trace(events)
        with open(args.chrome, "w", encoding="utf-8") as f:
            json.dump({"traceEvents": chrome}, f, indent=2,
                      sort_keys=True)
            f.write("\n")
        print("wrote %d chrome events to %s"
              % (len(chrome), args.chrome))
        if args.trace_id is None:
            return 0
    if args.trace_id is not None:
        timeline = [e for e in events
                    if args.trace_id in event_trace_ids(e)]
        if not timeline:
            print("trace %d not in the dump (have: %s)"
                  % (args.trace_id,
                     ", ".join(map(str, trace_ids(events)[:20]))),
                  file=sys.stderr)
            return 1
        print(render_waterfall(timeline))
        return 0
    print(summarize(events))
    return 0


if __name__ == "__main__":
    sys.exit(main())
