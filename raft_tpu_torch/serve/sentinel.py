"""Anomaly sentinel: a resident watcher over the serving stack's vitals.

Port of ``raft_tpu/serve/sentinel.py``, which is host-side Python over
the metrics registry, the flight recorder and the services' stats: the
same rules, thresholds and side effects.  Every metric it reads exists
in the port under the JAX package's name (``raft_tpu_serve_exec_seconds``
and ``raft_tpu_serve_exec_rung_seconds`` from the serve worker,
``raft_tpu_serve_slo_burn_rate`` from the SLO tracker,
``raft_tpu_h2d_seconds`` and ``raft_tpu_h2d_stall_seconds`` from the
out-of-core tile pool, ``raft_tpu_fleet_network_seconds`` from the
fleet router).

- **Rolling-baseline watchers.**  Each rule reads an already-recorded
  signal and compares it against a fixed threshold knob or a rolling
  EWMA baseline that is FROZEN while the rule is breached: a fault
  cannot teach the baseline that slow is normal.
- **On breach** (inactive -> active, not per tick): an ``anomaly``
  flight event, ``raft_tpu_anomaly_total{rule=}``,
  ``raft_tpu_anomaly_active{rule=,service=}`` set to 1, and a black-box
  dump (reason ``anomaly_<rule>``).  On clearance an
  ``anomaly_cleared`` event and the gauge back to 0.
- **Degraded flag.**  :meth:`degraded` / :meth:`status` feed the ops
  plane's ``/healthz``.

Rules (knobs in :mod:`raft_tpu_torch.config`, all ``ops_sentinel_*``):

========================  ============================================
``exec_latency``          windowed MEAN exec latency (exact, from
                          the timer's lifetime count/total deltas
                          between ticks — a reservoir p99 full of
                          healthy history would need dozens of slow
                          batches to move; the window mean trips on
                          the first one) > ``latency_factor`` ×
                          rolling baseline (min ``min_samples``
                          lifetime batches before judging).  Watched
                          per service AND per (service, rung) — one
                          watch per shape bucket from the
                          ``raft_tpu_serve_exec_rung_seconds``
                          family, scoped ``<service>:r<rung>`` — so
                          a regression confined to one bucket
                          cannot hide inside a healthy traffic mix
``queue_depth``           queued requests > ``queue_frac`` × the
                          service's admission cap
``slo_burn``              any tenant's shortest-window burn rate >
                          ``burn`` (error budget vanishing)
``wal_depth``             un-snapshotted WAL records > ``wal_records``
                          (snapshots stopped containing the journal)
``snapshot_age``          persist layer reports a stale snapshot
                          (dirty state outliving 3 intervals)
``scrub_corruption``      unrepaired checksum corruption detected
``tile_stall``            exposed-stall fraction of H2D time over the
                          last window > ``stall_frac`` (the prefetch
                          stopped hiding transfers)
``worker_dead``           fleet only (the watched object exposes
                          ``fleet_stats``): any registered worker is
                          lease-evicted and not yet rejoined — the
                          fleet is serving degraded
``rejoin_lag``            fleet only: the last crash-rejoin's WAL
                          replay ran slower than
                          ``rejoin_ms_per_record`` per replayed
                          record — recovery time is outgrowing the
                          journal, snapshot cadence needs tightening.
                          Clears once the rejoin ages past
                          ``rejoin_hold_s`` (an incident, not a
                          latched state)
========================  ============================================

The sentinel is driven two ways, both cheap: every
:class:`~raft_tpu_torch.serve.scheduler.ServeWorker` pokes it on the
existing maintenance seam (between batch cycles — a loaded serving
process notices within one batch), and the ops plane runs a fallback
ticker thread so an *idle* process still notices (a wedged worker
cannot poke).  :meth:`tick` rate-limits itself to
``ops_sentinel_interval_s``, so redundant drivers cost one clock read.
Rule evaluation never raises — failures feed
``raft_tpu_ops_sentinel_errors_total`` (a broken watcher must not
take down the worker loop it rides).

This module imports nothing of the JAX package and no device library:
a scrape or a tick never touches the card.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional

from raft_tpu_torch import config
from raft_tpu_torch.core import flight
from raft_tpu_torch.core import metrics as _metrics

__all__ = ["AnomalySentinel", "register", "unregister", "poke"]

# EWMA weight for rolling baselines: slow enough that a few noisy
# ticks cannot drag the baseline up to a genuine regression
_BASELINE_ALPHA = 0.2


def _counter(name: str, help: str, **labels):
    return _metrics.default_registry().counter(
        name, help=help, labels=tuple(sorted(labels))).labels(**labels)


def _gauge(name: str, help: str, **labels):
    return _metrics.default_registry().gauge(
        name, help=help, labels=tuple(sorted(labels))).labels(**labels)


class _Watch:
    """One (rule, service) watcher's state."""

    __slots__ = ("baseline", "active", "since", "value", "threshold")

    def __init__(self):
        self.baseline: Optional[float] = None
        self.active = False
        self.since: Optional[float] = None
        self.value = 0.0
        self.threshold = 0.0


class AnomalySentinel:
    """Module-doc watcher.  ``services_fn`` returns the live
    ``{name: service}`` map each tick (a session's ``.services`` or a
    static dict) — services appearing/disappearing between ticks is
    normal (tests rebuild them freely)."""

    def __init__(self, services_fn: Callable[[], Dict[str, object]], *,
                 interval_s: Optional[float] = None,
                 clock: Callable[[], float] = time.monotonic):
        self._services_fn = services_fn
        self._interval = (config.get_float("ops_sentinel_interval_s")
                          if interval_s is None else float(interval_s))
        self._latency_factor = config.get_float(
            "ops_sentinel_latency_factor")
        self._min_samples = config.get_int("ops_sentinel_min_samples")
        self._queue_frac = config.get_float("ops_sentinel_queue_frac")
        self._burn = config.get_float("ops_sentinel_burn")
        self._wal_records = config.get_int("ops_sentinel_wal_records")
        self._stall_frac = config.get_float("ops_sentinel_stall_frac")
        self._rejoin_ms = config.get_float(
            "ops_sentinel_rejoin_ms_per_record")
        self._rejoin_hold = config.get_float(
            "ops_sentinel_rejoin_hold_s")
        self._clock = clock
        self._lock = threading.Lock()
        self._watches: Dict[tuple, _Watch] = {}
        self._last_tick: Optional[float] = None
        self._ticks = 0
        # per-service (count, total) / h2d cursors for window deltas
        self._exec_cursor: Dict[str, tuple] = {}
        self._h2d_cursor: Dict[str, tuple] = {}
        # per-(service, worker) cursors over the router's per-hop
        # network timer — the cross-hop rule's window deltas
        self._net_cursor: Dict[str, tuple] = {}

    # ------------------------------------------------------------------ #
    # driving
    # ------------------------------------------------------------------ #
    def tick(self, force: bool = False) -> bool:
        """Evaluate every rule once; rate-limited to the configured
        interval unless ``force``.  Returns whether an evaluation ran.
        Never raises (module doc)."""
        now = self._clock()
        with self._lock:
            if (not force and self._last_tick is not None
                    and now - self._last_tick < self._interval):
                return False
            self._last_tick = now
            self._ticks += 1
        try:
            services = dict(self._services_fn() or {})
        except Exception:
            _counter("raft_tpu_ops_sentinel_errors_total",
                     "sentinel rule-evaluation failures").inc()
            return True
        for name, svc in services.items():
            for rule_fn in (self._rule_latency, self._rule_queue,
                            self._rule_slo_burn, self._rule_persist,
                            self._rule_tile_stall, self._rule_fleet):
                try:
                    rule_fn(name, svc, now)
                except Exception:
                    _counter("raft_tpu_ops_sentinel_errors_total",
                             "sentinel rule-evaluation failures").inc()
        return True

    # ------------------------------------------------------------------ #
    # rule plumbing
    # ------------------------------------------------------------------ #
    def _watch(self, rule: str, service: str) -> _Watch:
        key = (rule, service)
        with self._lock:
            w = self._watches.get(key)
            if w is None:
                w = self._watches[key] = _Watch()
            return w

    def _judge(self, rule: str, service: str, value: float,
               threshold: float, now: float,
               breach: Optional[bool] = None) -> None:
        """Shared breach/clear state machine: fires the transition
        side effects exactly once per edge (module doc)."""
        w = self._watch(rule, service)
        w.value = value
        w.threshold = threshold
        if breach is None:
            breach = value > threshold
        if breach and not w.active:
            w.active = True
            w.since = now
            _counter("raft_tpu_anomaly_total",
                     "anomaly-sentinel rule breaches (inactive->"
                     "active transitions)", rule=rule).inc()
            _gauge("raft_tpu_anomaly_active",
                   "1 while the sentinel rule is breached for the "
                   "service", rule=rule, service=service).set(1)
            flight.record("anomaly", service=service, rule=rule,
                          value=round(float(value), 6),
                          threshold=round(float(threshold), 6))
            # the postmortem tape, captured at the moment of noticing:
            # the ring still holds the breaching batches' lifecycle
            flight.default_recorder().blackbox(
                "anomaly_%s" % rule, service=service)
        elif not breach and w.active:
            w.active = False
            w.since = None
            _gauge("raft_tpu_anomaly_active",
                   "1 while the sentinel rule is breached for the "
                   "service", rule=rule, service=service).set(0)
            flight.record("anomaly_cleared", service=service,
                          rule=rule, value=round(float(value), 6))

    def _judge_baseline(self, rule: str, service: str, value: float,
                        factor: float, now: float,
                        judge: bool = True) -> None:
        """Baseline-relative judgement: compare ``value`` against
        ``factor`` × the PRE-update baseline (judging against a
        baseline that already absorbed this window's spike would
        raise the bar exactly when it must not), then EWMA-update the
        baseline only while not breached — a fault cannot teach the
        baseline that slow is normal.  ``judge=False`` warms the
        baseline without judging (cold start)."""
        w = self._watch(rule, service)
        base = value if w.baseline is None else w.baseline
        if judge:
            self._judge(rule, service, value,
                        factor * max(base, 1e-9), now)
        if w.baseline is None:
            w.baseline = value
        elif not w.active:
            w.baseline += _BASELINE_ALPHA * (value - w.baseline)

    # ------------------------------------------------------------------ #
    # rules
    # ------------------------------------------------------------------ #
    def _series(self, metric: str, service: str,
                label: str = "service"):
        fam = _metrics.default_registry().get(metric)
        if fam is None:
            return None
        for labels, series in fam.series():
            if labels.get(label) == service:
                return series
        return None

    def _rule_latency(self, name: str, svc, now: float) -> None:
        # rungs first: their cursors must warm even on ticks where the
        # service-level cursor has nothing to judge (early returns)
        self._rule_latency_rungs(name, now)
        s = self._series("raft_tpu_serve_exec_seconds", name)
        if s is None:
            return
        count, total = int(s.count), float(s.total)
        prev = self._exec_cursor.get(name)
        self._exec_cursor[name] = (count, total)
        if prev is None or count <= prev[0]:
            return  # first sighting / quiet window: nothing to judge
        window_mean = (total - prev[1]) / (count - prev[0])
        # cold start warms the baseline without judging — the first
        # min_samples batches of a fresh service are allowed to be
        # weird (allocator, thread pools) without tripping alarms
        self._judge_baseline("exec_latency", name, window_mean,
                             self._latency_factor, now,
                             judge=count >= self._min_samples)

    def _rule_latency_rungs(self, name: str, now: float) -> None:
        """Per-(service, rung) exec_latency watches (module doc): each
        shape bucket gets its own cursor, baseline, and watch scoped
        ``<service>:r<rung>`` so a one-bucket regression is judged
        against that bucket's own history, not the mixed mean."""
        fam = _metrics.default_registry().get(
            "raft_tpu_serve_exec_rung_seconds")
        if fam is None:
            return
        for labels, s in fam.series():
            if labels.get("service") != name:
                continue
            scope = "%s:r%s" % (name, labels.get("rung"))
            count, total = int(s.count), float(s.total)
            prev = self._exec_cursor.get(scope)
            self._exec_cursor[scope] = (count, total)
            if prev is None or count <= prev[0]:
                continue
            window_mean = (total - prev[1]) / (count - prev[0])
            self._judge_baseline("exec_latency", scope, window_mean,
                                 self._latency_factor, now,
                                 judge=count >= self._min_samples)

    def _rule_queue(self, name: str, svc, now: float) -> None:
        batcher = getattr(svc, "batcher", None)
        cap = getattr(batcher, "queue_cap", None)
        if not cap:
            return
        depth = float(batcher.depth())
        self._judge("queue_depth", name, depth,
                    self._queue_frac * float(cap), now)

    def _rule_slo_burn(self, name: str, svc, now: float) -> None:
        slo = getattr(svc, "slo", None)
        if slo is None:
            return
        snap = slo.snapshot(publish=False)
        worst = 0.0
        for t in snap.get("tenants", {}).values():
            if t.get("total", 0) < self._min_samples:
                continue
            burns = t.get("burn", {})
            if burns:
                # shortest window = the fast-burn alarm; the snapshot
                # keys are "%gs" strings, sort numerically
                shortest = min(burns, key=lambda k: float(k[:-1]))
                worst = max(worst, burns[shortest])
        self._judge("slo_burn", name, worst, self._burn, now)

    def _rule_persist(self, name: str, svc, now: float) -> None:
        persist = getattr(svc, "_persist", None)
        if persist is None:
            return
        st = persist.stats()
        self._judge("wal_depth", name,
                    float(st.get("wal_records", 0)),
                    float(self._wal_records), now)
        self._judge("snapshot_age", name,
                    float(st.get("snapshot_age_s") or 0.0),
                    3.0 * float(st.get("snapshot_interval_s", 0.0)),
                    now, breach=bool(st.get("snapshot_stale")))
        self._judge("scrub_corruption", name,
                    1.0 if st.get("corruption_detected") else 0.0,
                    0.0, now,
                    breach=bool(st.get("corruption_detected")))

    def _rule_tile_stall(self, name: str, svc, now: float) -> None:
        h2d = self._series("raft_tpu_h2d_seconds", name, label="pool")
        stall = self._series("raft_tpu_h2d_stall_seconds", name,
                             label="pool")
        if h2d is None or stall is None:
            return
        h2d_t, stall_t = float(h2d.total), float(stall.total)
        prev = self._h2d_cursor.get(name)
        self._h2d_cursor[name] = (h2d_t, stall_t)
        if prev is None:
            # first sighting: the lifetime totals include warmup's
            # inherently-unhidden tile streams — judging them would
            # trip tile_stall on a healthy freshly-watched service
            # (the exec_latency cursor rule, applied here)
            return
        dh = h2d_t - prev[0]
        if dh <= 1e-6:
            return  # no transfers this window
        frac = max(0.0, stall_t - prev[1]) / dh
        self._judge("tile_stall", name, frac, self._stall_frac, now)

    def _rule_fleet(self, name: str, svc, now: float) -> None:
        stats_fn = getattr(svc, "fleet_stats", None)
        if stats_fn is None:
            return
        st = stats_fn()
        # worker_dead: edge-fires on the first eviction, clears when
        # the worker rejoins (or is replaced) — the degraded window
        self._judge("worker_dead", name,
                    float(st.get("workers_dead", 0)), 0.0, now)
        rj = st.get("last_rejoin") or {}
        replayed = int(rj.get("replayed_records") or 0)
        if replayed > 0:
            lag_ms = 1000.0 * float(rj.get("restore_s") or 0.0) / replayed
            # a slow restore is an incident about ONE rejoin, not a
            # steady state: judge it only while the rejoin is fresh
            # (``age_s`` from the router's stats), then clear — the
            # breach edge was already counted and flight-recorded
            age = rj.get("age_s")
            fresh = age is None or float(age) < self._rejoin_hold
            self._judge("rejoin_lag", name, lag_ms, self._rejoin_ms,
                        now, breach=fresh and lag_ms > self._rejoin_ms)
        self._rule_fleet_network(name, now)

    def _rule_fleet_network(self, name: str, now: float) -> None:
        """Cross-hop rule: each worker's router-measured network time
        (``raft_tpu_fleet_network_seconds{worker=...}`` — RPC elapsed
        minus the worker's self-reported server time) gets its own
        cursor, baseline, and watch scoped ``<service>:<worker>``, so
        one worker's degraded link is judged against that link's own
        history rather than hiding in the fleet mean (the exec_latency
        per-rung discipline, applied across the process boundary)."""
        fam = _metrics.default_registry().get(
            "raft_tpu_fleet_network_seconds")
        if fam is None:
            return
        for labels, s in fam.series():
            wid = labels.get("worker")
            if wid is None:
                continue
            scope = "%s:%s" % (name, wid)
            count, total = int(s.count), float(s.total)
            prev = self._net_cursor.get(scope)
            self._net_cursor[scope] = (count, total)
            if prev is None or count <= prev[0]:
                continue
            window_mean = (total - prev[1]) / (count - prev[0])
            self._judge_baseline("fleet_network", scope, window_mean,
                                 self._latency_factor, now,
                                 judge=count >= self._min_samples)

    # ------------------------------------------------------------------ #
    # consumers (the ops plane's /healthz and /statusz)
    # ------------------------------------------------------------------ #
    def degraded(self) -> bool:
        with self._lock:
            return any(w.active for w in self._watches.values())

    def active(self) -> List[dict]:
        with self._lock:
            return [{"rule": rule, "service": service,
                     "value": round(w.value, 6),
                     "threshold": round(w.threshold, 6),
                     "since": w.since}
                    for (rule, service), w in sorted(
                        self._watches.items()) if w.active]

    def status(self) -> dict:
        with self._lock:
            watches = {
                "%s/%s" % (rule, service): {
                    "active": w.active,
                    "value": round(w.value, 6),
                    "threshold": round(w.threshold, 6),
                    "baseline": (None if w.baseline is None
                                 else round(w.baseline, 6)),
                }
                for (rule, service), w in sorted(self._watches.items())}
            return {"ticks": self._ticks,
                    "interval_s": self._interval,
                    "degraded": any(w.active
                                    for w in self._watches.values()),
                    "watches": watches}


# ---------------------------------------------------------------------- #
# the maintenance-seam hook: ServeWorker.run_maintenance pokes every
# registered sentinel between batch cycles — noticing rides the serving
# loop itself; the ops plane's ticker is the idle-process fallback
# ---------------------------------------------------------------------- #
_registered: List[AnomalySentinel] = []
_reg_lock = threading.Lock()


def register(sentinel: AnomalySentinel) -> AnomalySentinel:
    with _reg_lock:
        if sentinel not in _registered:
            _registered.append(sentinel)
    return sentinel


def unregister(sentinel: AnomalySentinel) -> None:
    with _reg_lock:
        if sentinel in _registered:
            _registered.remove(sentinel)


def poke() -> None:
    """Tick every registered sentinel (rate-limited internally — a
    no-op costs one list read + one clock read per sentinel).  Never
    raises: the worker loop calling this must survive any watcher."""
    with _reg_lock:
        sentinels = list(_registered)
    for s in sentinels:
        try:
            s.tick()
        except Exception:  # noqa: BLE001 — counted, never loop-fatal
            _counter("raft_tpu_ops_sentinel_errors_total",
                     "sentinel rule-evaluation failures").inc()
