"""Flight recorder: always-on bounded event capture + request tracing.

A copy of ``raft_tpu/core/flight.py`` (which holds no JAX) with its
imports re-pointed at this package.

The serving stack's aggregate metrics (docs/OBSERVABILITY.md) answer
"how is the fleet doing"; this module answers "what happened to THIS
request" and "what were the seconds before the outage".  Three pieces,
all in-process, all bounded, all cheap enough to leave on in
production (the ``serve_trace_overhead`` bench rung measures the cost
and asserts it ≤ 3% qps):

**FlightRecorder** — a lock-cheap ring buffer of typed structured
events (``ts, kind, service, tenant, trace_id, attrs``).  Every layer
of the serve pipeline records into one process-global ordered stream:
request lifecycle events (admitted → batch_formed → execute_launch →
execute_ready → resolved/expired/failed/requeued) *and* system events
(breaker transitions, recovery phases, repartitions, compactions,
hot-set promotions, worker restarts, tile-miss storms), so the stream
reads like a black box's tape — what the system did, in order.

**Request-scoped traces** — ``Service.submit`` assigns each admitted
request a process-unique ``trace_id`` and a :class:`Trace`; every
event recorded against the request lands BOTH in the global ring and
in the trace's own bounded list, so
:meth:`~raft_tpu_torch.serve.batcher.ServeFuture.trace` reconstructs the
complete per-request timeline after resolution even if the global
ring has since wrapped.  Batch-level events (the batch a request rode,
its bucket rung, the execute bracket, hedge arms/winner) attach to
every rider's trace via :func:`batch_scope` — the worker wraps the
device call in the scope and deeper layers (replica hedging) record
through :func:`record_scoped` without threading trace handles through
their signatures.

**Black-box dumps** — :meth:`FlightRecorder.blackbox` snapshots the
last N events under a reason; breaker trips and recoveries call it
automatically, so a chaos postmortem starts from the tape, not from
grepping logs.  Snapshots are kept in a bounded deque (and written as
JSON files when ``RAFT_TPU_FLIGHT_DUMP_DIR`` names a directory);
session ``health_check()`` and ``metrics_snapshot()`` surface them.

**SLO tracking + exemplars** — :class:`SLOTracker` (one per service,
fed per resolved/expired request) tracks a per-tenant latency target
and deadline-hit-rate with multi-window burn rates
(``burn = miss_rate / (1 - objective)``; > 1 means the error budget
is burning faster than it accrues), published as
``raft_tpu_serve_slo_*`` gauges and in ``Service.stats()``.
:class:`Exemplars` keeps the trace_ids of the slowest K observations
per service, so a p99 number links to the timelines that produced it.

``RAFT_TPU_FLIGHT=0`` (or :func:`set_enabled`) turns the whole
subsystem into a no-op: ``new_trace`` returns None, ``record`` returns
immediately, SLO/exemplar observation is skipped — the
``serve_trace_overhead`` rung's baseline arm.  Event kinds and the
trace_id contract are documented in docs/OBSERVABILITY.md ("Flight
recorder & request tracing").
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import json
import os
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from raft_tpu_torch.core import metrics as _metrics

__all__ = [
    "Event", "Trace", "FlightRecorder", "SLOTracker", "Exemplars",
    "TERMINAL_KINDS", "default_recorder", "record", "record_scoped",
    "batch_scope", "trace_context", "current_trace_context",
    "fleet_traces", "set_enabled", "is_enabled", "slo_for",
    "exemplars_for", "slo_snapshot", "exemplars_snapshot",
    "flight_snapshot", "reset",
]

_enabled = os.environ.get("RAFT_TPU_FLIGHT", "1") != "0"

# a request's lifecycle ends with exactly ONE of these (the invariant
# tests/test_flight.py asserts across every path)
TERMINAL_KINDS = frozenset(("resolved", "expired", "failed"))

# per-trace event cap: a single request's timeline is short by
# construction (admitted + batch + bracket + terminal, plus hedge /
# requeue noise); the cap only guards against a pathological producer
TRACE_MAX_EVENTS = 256

# black-box snapshots retained in memory (each is a bounded event list)
BLACKBOX_KEEP = 8

# distinct fleet trace ids whose local Trace objects the recorder
# indexes (FIFO-evicted).  Each entry holds at most a handful of
# traces (one per RPC attempt that landed here), so the bound is the
# memory contract for the fleet join path the same way ``capacity``
# is for the ring.
FLEET_TRACE_KEEP = 512

# local traces retained per fleet id (retries/hedges to the same
# process each open a fresh local trace under the same fleet id)
FLEET_TRACES_PER_ID = 8


def set_enabled(on: bool) -> None:
    """Globally enable/disable flight recording (RAFT_TPU_FLIGHT=0).
    Disabled: no events, no traces, no SLO/exemplar observation."""
    global _enabled
    _enabled = bool(on)


def is_enabled() -> bool:
    return _enabled


class Event:
    """One structured flight event (immutable by convention)."""

    __slots__ = ("ts", "kind", "service", "tenant", "trace_id", "attrs")

    def __init__(self, ts: float, kind: str, service: Optional[str],
                 tenant: Optional[str], trace_id: Optional[int],
                 attrs: Optional[dict]):
        self.ts = ts
        self.kind = kind
        self.service = service
        self.tenant = tenant
        self.trace_id = trace_id
        self.attrs = attrs

    def to_dict(self) -> dict:
        out = {"ts": self.ts, "kind": self.kind}
        if self.service is not None:
            out["service"] = self.service
        if self.tenant is not None:
            out["tenant"] = self.tenant
        if self.trace_id is not None:
            out["trace_id"] = self.trace_id
        if self.attrs:
            out.update(self.attrs)
        return out

    def __repr__(self) -> str:  # debugging aid only
        return "Event(%r, t=%.6f, trace=%r)" % (self.kind, self.ts,
                                                self.trace_id)


class Trace:
    """One request's private timeline (the half of tracing that
    survives ring wrap-around).  ``trace_id`` is a process-unique
    monotonically increasing int — two requests never share one, and
    a larger id was admitted later.  Event appends are list-append
    atomic under the GIL; the producers are already sequenced by the
    request lifecycle (submit → worker → resolve)."""

    __slots__ = ("trace_id", "service", "tenant", "events", "dropped",
                 "fleet")

    def __init__(self, trace_id: int, service: Optional[str],
                 tenant: Optional[str]):
        self.trace_id = trace_id
        self.service = service
        self.tenant = tenant
        self.events: List[Event] = []
        self.dropped = 0
        # fleet trace context this request rides under (propagated by
        # the router: {"id", "parent", "sent_at"}), or None for a
        # plain in-process request — see docs/OBSERVABILITY.md
        # "Fleet tracing"
        self.fleet: Optional[dict] = None

    def add(self, ev: Event) -> None:
        if len(self.events) >= TRACE_MAX_EVENTS:
            self.dropped += 1
            return
        self.events.append(ev)

    def timeline(self) -> List[dict]:
        """The ordered event dicts — the ``ServeFuture.trace()``
        payload ``tools/trace_report.py`` renders."""
        return [ev.to_dict() for ev in list(self.events)]

    def kinds(self) -> List[str]:
        return [ev.kind for ev in list(self.events)]

    def terminal(self) -> Optional[str]:
        """The terminal kind (resolved/expired/failed), or None while
        the request is still in flight."""
        for ev in reversed(list(self.events)):
            if ev.kind in TERMINAL_KINDS:
                return ev.kind
        return None

    def duration_s(self) -> Optional[float]:
        evs = list(self.events)
        if len(evs) < 2:
            return None
        return evs[-1].ts - evs[0].ts

    def to_dict(self) -> dict:
        out = {"trace_id": self.trace_id, "service": self.service,
               "tenant": self.tenant, "terminal": self.terminal(),
               "dropped": self.dropped, "events": self.timeline()}
        if self.fleet is not None:
            out["fleet"] = dict(self.fleet)
        return out


# -- batch scope: the worker binds the current batch's rider traces to
# its thread so deeper layers (replica hedging) can attach events
# without signature plumbing ------------------------------------------ #
_tls = threading.local()


@contextlib.contextmanager
def batch_scope(traces: Sequence[Optional[Trace]]):
    """Bind ``traces`` as the calling thread's current batch riders for
    the duration of the block (:func:`record_scoped` attaches to
    them).  Nestable; None entries (disabled recording) are skipped."""
    prev = getattr(_tls, "scope", None)
    _tls.scope = tuple(t for t in traces if t is not None)
    try:
        yield
    finally:
        _tls.scope = prev


def _scope_traces() -> Tuple[Trace, ...]:
    return getattr(_tls, "scope", None) or ()


@contextlib.contextmanager
def trace_context(ctx: Optional[dict]):
    """Bind a propagated fleet trace context (``{"id", "parent",
    "sent_at"}``) to the calling thread: every :meth:`new_trace` created
    inside the block is stamped with it and indexed by fleet id, so a
    worker process can later serve its half of the cross-process
    waterfall (docs/OBSERVABILITY.md "Fleet tracing").  ``ctx=None``
    is a no-op block, so callers can pass through whatever the wire
    carried without branching."""
    prev = getattr(_tls, "fleet_ctx", None)
    _tls.fleet_ctx = dict(ctx) if ctx else None
    try:
        yield
    finally:
        _tls.fleet_ctx = prev


def current_trace_context() -> Optional[dict]:
    """The calling thread's propagated fleet trace context, if any."""
    return getattr(_tls, "fleet_ctx", None)


class FlightRecorder:
    """Bounded, thread-safe, ordered event ring (module doc).

    Parameters
    ----------
    capacity:
        Ring size in events; None resolves the ``flight_events`` knob
        (:mod:`raft_tpu_torch.config`).  The bound is the memory contract:
        the recorder can never hold more than ``capacity`` events
        however long the process runs.
    clock:
        Monotonic-seconds source (the library's injectable-clock seam;
        event ``ts`` values are this clock's seconds).
    """

    def __init__(self, capacity: Optional[int] = None,
                 clock: Callable[[], float] = time.monotonic):
        if capacity is None:
            from raft_tpu_torch import config

            capacity = config.get_int("flight_events")
        if capacity < 1:
            raise ValueError("FlightRecorder: capacity=%d" % capacity)
        self._lock = threading.Lock()
        self._ring: "collections.deque[Event]" = collections.deque(
            maxlen=int(capacity))
        self._blackboxes: "collections.deque[dict]" = collections.deque(
            maxlen=BLACKBOX_KEEP)
        self._trace_seq = itertools.count(1)
        self._clock = clock
        self._dump_seq = itertools.count(1)
        # fleet id -> local Trace objects created under that context
        # (insertion-ordered; FIFO-evicted at FLEET_TRACE_KEEP ids).
        # This is what lets the worker answer /debug/trace for a fleet
        # id even after the global ring has wrapped.
        self._fleet: Dict[str, List[Trace]] = {}

    # ------------------------------------------------------------------ #
    # producers
    # ------------------------------------------------------------------ #
    def new_trace(self, service: Optional[str] = None,
                  tenant: Optional[str] = None, *,
                  fleet: Optional[dict] = None) -> Optional[Trace]:
        """A fresh request trace with a process-unique id, or None when
        recording is disabled (callers treat a None trace as 'no
        tracing' everywhere).  ``fleet`` (or, when absent, the calling
        thread's :func:`trace_context`) stamps the trace with a
        propagated fleet context and indexes it by fleet id for the
        cross-process join."""
        if not _enabled:
            return None
        tr = Trace(next(self._trace_seq), service, tenant)
        ctx = fleet if fleet is not None else current_trace_context()
        if ctx and ctx.get("id") is not None:
            tr.fleet = dict(ctx)
            self._index_fleet(tr)
        return tr

    def _index_fleet(self, trace: Trace) -> None:
        fid = str(trace.fleet["id"])  # type: ignore[index]
        with self._lock:
            lst = self._fleet.get(fid)
            if lst is None:
                while len(self._fleet) >= FLEET_TRACE_KEEP:
                    self._fleet.pop(next(iter(self._fleet)))
                lst = self._fleet[fid] = []
            if len(lst) < FLEET_TRACES_PER_ID:
                lst.append(trace)

    def record(self, kind: str, service: Optional[str] = None,
               tenant: Optional[str] = None,
               trace: Optional[Trace] = None,
               traces: Optional[Sequence[Optional[Trace]]] = None,
               **attrs: Any) -> Optional[Event]:
        """Record one event into the ring and onto the given trace(s).

        ``trace`` attaches to one request, ``traces`` to every rider of
        a batch (None entries skipped).  System events pass neither.
        Returns the event (None when disabled).
        """
        if not _enabled:
            return None
        if tenant is None and trace is not None:
            tenant = trace.tenant
        ring_attrs = attrs or None
        riders = ([t for t in traces if t is not None]
                  if traces else ())
        if riders:
            # the shared ring event names every rider, so a ring dump
            # alone (black box, trace-dump file) can reconstruct each
            # request's batch-level steps after the Trace objects are
            # gone (tools/trace_report.py reads `traces`)
            ring_attrs = dict(attrs or {},
                              traces=[t.trace_id for t in riders])
            fids = sorted({str(t.fleet["id"]) for t in riders
                           if t.fleet is not None
                           and t.fleet.get("id") is not None})
            if fids:
                ring_attrs["fleet"] = fids
        elif trace is not None and trace.fleet is not None:
            fid = trace.fleet.get("id")
            if fid is not None:
                ring_attrs = dict(attrs or {}, fleet=str(fid))
        ev = Event(self._clock(), kind, service, tenant,
                   trace.trace_id if trace is not None else None,
                   ring_attrs)
        with self._lock:
            self._ring.append(ev)
        if trace is not None:
            trace.add(ev)
        for t in riders:
            # per-rider view of a shared event: same ts/kind/attrs,
            # the rider's own trace_id
            t.add(Event(ev.ts, kind, service, t.tenant, t.trace_id,
                        attrs or None))
        return ev

    def record_scoped(self, kind: str, service: Optional[str] = None,
                      **attrs: Any) -> Optional[Event]:
        """Record one event attached to the calling thread's current
        :func:`batch_scope` riders (no-op scope = ring-only)."""
        return self.record(kind, service=service,
                           traces=_scope_traces(), **attrs)

    # ------------------------------------------------------------------ #
    # consumers
    # ------------------------------------------------------------------ #
    def events(self, last: Optional[int] = None,
               service: Optional[str] = None,
               kind: Optional[str] = None) -> List[Event]:
        """A filtered copy of the ring (oldest first)."""
        with self._lock:
            evs = list(self._ring)
        if service is not None:
            evs = [e for e in evs if e.service == service]
        if kind is not None:
            evs = [e for e in evs if e.kind == kind]
        if last is not None:
            evs = evs[-int(last):]
        return evs

    def fleet_traces(self, fleet_id: str) -> List[Trace]:
        """The local Trace objects created under the given fleet trace
        context (empty when unknown or evicted) — the worker's half of
        ``/fleet/debug/trace/<id>``.  Survives ring wrap: the Trace
        keeps its own bounded event list."""
        with self._lock:
            return list(self._fleet.get(str(fleet_id), ()))

    def fleet_trace_ids(self) -> List[str]:
        """Indexed fleet ids, oldest first."""
        with self._lock:
            return list(self._fleet)

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)

    @property
    def capacity(self) -> int:
        return self._ring.maxlen or 0

    # ------------------------------------------------------------------ #
    # black box
    # ------------------------------------------------------------------ #
    def blackbox(self, reason: str, service: Optional[str] = None,
                 last: int = 256) -> dict:
        """Snapshot the last ``last`` ring events under ``reason`` —
        the postmortem tape a breaker trip / recovery captures
        automatically.  Kept in a bounded deque (``blackboxes()``);
        written as a JSON file too when ``RAFT_TPU_FLIGHT_DUMP_DIR``
        names a directory.  Safe to call with recording disabled
        (snapshots whatever the ring still holds)."""
        with self._lock:
            evs = list(self._ring)[-int(last):]
        dump = {"reason": reason, "service": service,
                "at": self._clock(),
                "events": [e.to_dict() for e in evs]}
        with self._lock:
            self._blackboxes.append(dump)
        _metrics.default_registry().counter(
            "raft_tpu_flight_blackboxes_total",
            help="black-box event-buffer snapshots captured "
                 "(breaker trips, recoveries, manual dumps)").inc()
        dump_dir = os.environ.get("RAFT_TPU_FLIGHT_DUMP_DIR")
        if dump_dir:
            try:
                path = os.path.join(
                    dump_dir, "flight_%s_%d.json"
                    % (reason, next(self._dump_seq)))
                with open(path, "w", encoding="utf-8") as f:
                    json.dump(dump, f, indent=2, sort_keys=True)
                    f.write("\n")
            except OSError:
                pass  # a broken dump dir must never take serving down
        return dump

    def blackboxes(self) -> List[dict]:
        with self._lock:
            return list(self._blackboxes)

    def blackbox_summaries(self) -> List[dict]:
        """Header-only view (``health_check`` embeds this — the full
        event payload stays in :meth:`blackboxes` / the dump files)."""
        return [{"reason": b["reason"], "service": b["service"],
                 "at": b["at"], "n_events": len(b["events"])}
                for b in self.blackboxes()]

    def dump_to(self, path: str) -> dict:
        """Write the whole recorder state (ring + black boxes) as JSON
        — the chaos harness's on-failure dump."""
        with self._lock:
            state = {"capacity": self.capacity,
                     "events": [e.to_dict() for e in self._ring],
                     "blackboxes": list(self._blackboxes)}
        with open(path, "w", encoding="utf-8") as f:
            json.dump(state, f, indent=2, sort_keys=True)
            f.write("\n")
        return state

    def clear(self) -> None:
        """Drop every event, black box and fleet index entry (test
        isolation)."""
        with self._lock:
            self._ring.clear()
            self._blackboxes.clear()
            self._fleet.clear()


# ---------------------------------------------------------------------- #
# SLO tracking (per service, per tenant)
# ---------------------------------------------------------------------- #
class SLOTracker:
    """Per-tenant latency-target / deadline-hit-rate tracker with
    multi-window burn rates (module doc).

    Parameters
    ----------
    service:
        Metric label; one tracker per service.
    target_s:
        The latency objective per request; <= 0 means "deadline-only"
        (a request without a deadline is then always a hit).
    objective:
        The availability objective in (0, 1) — e.g. 0.99 means 1% of
        requests may miss before the error budget is spent.  Burn rate
        over a window = observed miss rate / (1 - objective); burn 1.0
        spends the budget exactly as fast as it accrues.
    windows_s:
        The burn-rate windows in seconds (multi-window alerting: a
        short window catches a fast burn, a long one a slow leak).
    clock:
        Shared with the owning service (deterministic tests drive it).
    """

    MAX_OUTCOMES = 4096   # per tenant: (ts, ok) pairs retained

    def __init__(self, service: str, target_s: float, objective: float,
                 windows_s: Sequence[float],
                 clock: Callable[[], float] = time.monotonic):
        if not 0.0 < objective < 1.0:
            raise ValueError("SLOTracker: objective=%r" % objective)
        self.service = service
        self.target_s = float(target_s)
        self.objective = float(objective)
        self.windows_s = tuple(float(w) for w in windows_s)
        self._clock = clock
        self._lock = threading.Lock()
        self._outcomes: Dict[str, collections.deque] = {}

    def clear(self) -> None:
        """Drop every recorded outcome (test isolation via
        :func:`reset`; the tracker object — and every cached reference
        to it — stays valid)."""
        with self._lock:
            self._outcomes.clear()

    def observe(self, tenant: Optional[str], latency_s: float,
                deadline_ok: bool = True) -> bool:
        """Record one finished request; returns whether it was an SLO
        hit.  A miss is a blown deadline, a failure (callers pass
        ``deadline_ok=False``), or latency over the target."""
        if not _enabled:
            return True
        ok = deadline_ok and (self.target_s <= 0.0
                              or latency_s <= self.target_s)
        tenant = tenant or "default"
        with self._lock:
            dq = self._outcomes.get(tenant)
            if dq is None:
                dq = self._outcomes[tenant] = collections.deque(
                    maxlen=self.MAX_OUTCOMES)
            dq.append((self._clock(), ok))
        if not ok:
            _metrics.default_registry().counter(
                "raft_tpu_serve_slo_misses_total",
                help="requests that missed the service's SLO (latency "
                     "target or deadline), per tenant",
                labels=("service", "tenant")).labels(
                    service=self.service, tenant=tenant).inc()
        return ok

    def snapshot(self, publish: bool = True) -> dict:
        """Per-tenant SLO state: totals, hit ratio, and the burn rate
        per configured window; publishes the gauges as a side effect
        (``publish=False`` for read-only callers)."""
        now = self._clock()
        with self._lock:
            per_tenant = {t: list(dq)
                          for t, dq in self._outcomes.items()}
        budget = 1.0 - self.objective
        out: dict = {"target_ms": self.target_s * 1e3,
                     "objective": self.objective,
                     "windows_s": list(self.windows_s), "tenants": {}}
        reg = _metrics.default_registry()
        for tenant, outcomes in sorted(per_tenant.items()):
            total = len(outcomes)
            misses = sum(1 for _, ok in outcomes if not ok)
            hit_ratio = (total - misses) / total if total else 1.0
            burns = {}
            for w in self.windows_s:
                in_w = [ok for ts, ok in outcomes if now - ts <= w]
                rate = (sum(1 for ok in in_w if not ok) / len(in_w)
                        if in_w else 0.0)
                burns["%gs" % w] = rate / budget
            # the retained-outcome bound (MAX_OUTCOMES) can truncate a
            # long window at high rates: coverage_s is how far back
            # the retained history actually reaches — a burn over a
            # window longer than this is a partial-window number, and
            # the snapshot must say so rather than imply full coverage
            coverage_s = (now - outcomes[0][0]) if outcomes else 0.0
            out["tenants"][tenant] = {
                "total": total, "misses": misses,
                "hit_ratio": round(hit_ratio, 6),
                "coverage_s": round(coverage_s, 3),
                "burn": {k: round(v, 4) for k, v in burns.items()},
            }
            if publish:
                reg.gauge(
                    "raft_tpu_serve_slo_hit_ratio",
                    help="fraction of recent requests meeting the SLO "
                         "(latency target + deadline), per tenant",
                    labels=("service", "tenant")).labels(
                        service=self.service, tenant=tenant).set(
                            hit_ratio)
                for wname, burn in burns.items():
                    reg.gauge(
                        "raft_tpu_serve_slo_burn_rate",
                        help="error-budget burn rate per window "
                             "(miss_rate / (1 - objective); > 1 burns "
                             "budget faster than it accrues)",
                        labels=("service", "tenant", "window")).labels(
                            service=self.service, tenant=tenant,
                            window=wname).set(burn)
        return out


class Exemplars:
    """The slowest-K (latency, trace_id) observations per service —
    the bridge from a p99 number to the timelines behind it."""

    def __init__(self, k: int = 8):
        self._k = int(k)
        self._lock = threading.Lock()
        # min-heap-by-latency semantics via a sorted list (k is tiny)
        self._worst: List[Tuple[float, int]] = []

    def clear(self) -> None:
        """Drop the reservoir (test isolation via :func:`reset`; the
        object — and every cached reference — stays valid)."""
        with self._lock:
            self._worst.clear()

    def observe(self, latency_s: float, trace_id: Optional[int]) -> None:
        if not _enabled or trace_id is None:
            return
        with self._lock:
            if (len(self._worst) < self._k
                    or latency_s > self._worst[0][0]):
                self._worst.append((float(latency_s), int(trace_id)))
                self._worst.sort()
                del self._worst[:-self._k]

    def snapshot(self) -> List[dict]:
        """Slowest first."""
        with self._lock:
            worst = list(self._worst)
        return [{"latency_ms": round(lat * 1e3, 3), "trace_id": tid}
                for lat, tid in sorted(worst, reverse=True)]


# ---------------------------------------------------------------------- #
# module-level singletons and registries
# ---------------------------------------------------------------------- #
_default: Optional[FlightRecorder] = None
_default_lock = threading.Lock()
_slo: Dict[str, SLOTracker] = {}
_exemplars: Dict[str, Exemplars] = {}


def default_recorder() -> FlightRecorder:
    """The process-wide recorder every raft_tpu layer records into
    (lazily constructed so the ``flight_events`` knob is honored)."""
    global _default
    if _default is None:
        with _default_lock:
            if _default is None:
                _default = FlightRecorder()
    return _default


def record(kind: str, **kwargs: Any) -> Optional[Event]:
    """``default_recorder().record(...)`` convenience."""
    if not _enabled:
        return None
    return default_recorder().record(kind, **kwargs)


def record_scoped(kind: str, **kwargs: Any) -> Optional[Event]:
    """``default_recorder().record_scoped(...)`` convenience."""
    if not _enabled:
        return None
    return default_recorder().record_scoped(kind, **kwargs)


def fleet_traces(fleet_id: str) -> List[Trace]:
    """``default_recorder().fleet_traces(...)`` convenience."""
    return default_recorder().fleet_traces(fleet_id)


def slo_for(service: str, target_s: float, objective: float,
            windows_s: Sequence[float],
            clock: Callable[[], float] = time.monotonic) -> SLOTracker:
    """Create-and-register the service's SLO tracker (latest
    registration wins — services are rebuilt freely in tests)."""
    tracker = SLOTracker(service, target_s, objective, windows_s,
                         clock=clock)
    with _default_lock:
        _slo[service] = tracker
    return tracker


def exemplars_for(service: str) -> Exemplars:
    """Get-or-create the service's slowest-K exemplar reservoir."""
    with _default_lock:
        ex = _exemplars.get(service)
        if ex is None:
            ex = _exemplars[service] = Exemplars()
        return ex


def slo_snapshot() -> Dict[str, dict]:
    with _default_lock:
        trackers = dict(_slo)
    return {name: t.snapshot() for name, t in sorted(trackers.items())}


def exemplars_snapshot() -> Dict[str, List[dict]]:
    with _default_lock:
        items = dict(_exemplars)
    snaps = {name: ex.snapshot() for name, ex in sorted(items.items())}
    return {name: snap for name, snap in snaps.items() if snap}


def flight_snapshot() -> dict:
    """The ``flight`` section of ``metrics_snapshot()`` — recorder
    occupancy, black-box headers, per-service SLO state, and the
    slowest-observation exemplars."""
    rec = default_recorder()
    return {
        "enabled": _enabled,
        "events": len(rec),
        "capacity": rec.capacity,
        "blackboxes": rec.blackbox_summaries(),
        "slo": slo_snapshot(),
        "exemplars": exemplars_snapshot(),
    }


def reset() -> None:
    """Drop all recorded state — the ring, black boxes, every SLO
    tracker's outcomes and every exemplar reservoir — for test
    isolation.  Objects are cleared IN PLACE and registrations are
    kept, so references cached by live services and workers (a
    ``ServeWorker``'s exemplar reservoir, a ``Service``'s SLO tracker)
    keep feeding the same objects the snapshots read — a reset must
    never silently orphan a live producer."""
    with _default_lock:
        for tracker in _slo.values():
            tracker.clear()
        for ex in _exemplars.values():
            ex.clear()
        rec = _default
    if rec is not None:
        rec.clear()
