"""Serving resilience: fault seam and circuit breaker.

Port of ``raft_tpu/serve/resilience.py`` (host Python; its imports
re-pointed at this package).  Three pieces:

**Serve-seam fault injection** — :func:`inject_worker` patches
:attr:`ServeWorker._execute` with the seedable fault vocabulary of
:mod:`raft_tpu_torch.comms.faults` (``FailNth`` / ``Delay`` /
``RandomFail``), so serving failures are testable deterministically.
The injector sits *below* the worker's retry/breaker machinery: an
injected failure takes exactly the path a real device failure takes.

**Circuit breaker** — :class:`CircuitBreaker` tracks per-service batch
outcomes (consecutive and windowed failure counts; caller bugs —
``CALLER_BUG_ERRORS`` — are classified out: a shape error is the
rider's bug, not a service outage).  On trip, admission sheds fast with
:class:`~raft_tpu_torch.core.error.ServiceUnavailableError` instead of
queueing requests into a broken worker, the worker holds dispatch, and
after ``cooldown_s`` half-open probe traffic re-closes (or re-opens)
the breaker.

**Recovery orchestration** — :class:`RecoveryManager` owns the
sequence a persistent failure (a lost rank) needs: pause admission,
quiesce in-flight work, rebuild the communicator on the surviving ranks
(``session.recover()``), then per service ``post_recover()`` (an
``ANNService`` re-publishes its ``(index, delta)`` snapshot; a sharded
service re-partitions onto the rebuilt mesh, a replicated one re-cuts
its replica groups) and ``warmup()``, restart dead workers, and
re-admit.  Riders in flight at the failure were re-enqueued once by the
worker, never lost; the queued backlog serves out after re-admission.

Metrics (labels ``service=``): ``raft_tpu_serve_breaker_state`` gauge
(0=closed, 1=open, 2=half-open), ``raft_tpu_serve_breaker_trips_total``,
``raft_tpu_serve_breaker_probes_total``,
``raft_tpu_serve_unavailable_total`` (admission sheds),
``raft_tpu_serve_requeued_total`` (recovery re-enqueues, scheduler),
``raft_tpu_serve_recoveries_total`` and ``raft_tpu_serve_recovery_seconds``.
"""

from __future__ import annotations

import collections
import contextlib
import enum
import threading
import time
from typing import Callable, Dict, Iterator, List, Optional, Sequence

from raft_tpu_torch.comms.faults import Fault, FaultInjector
from raft_tpu_torch.core import flight
from raft_tpu_torch.core.error import CALLER_BUG_ERRORS, expects
from raft_tpu_torch.serve.scheduler import ServeWorker, _counter, _gauge, _timer

__all__ = ["BreakerState", "CircuitBreaker", "ServeFaultInjector",
           "inject_worker", "RecoveryManager"]


class BreakerState(enum.Enum):
    """Circuit-breaker state machine (the standard three states)."""

    CLOSED = 0       # healthy: admit + dispatch normally
    OPEN = 1         # tripped: shed admission, hold dispatch
    HALF_OPEN = 2    # cooled down: probe traffic decides close/re-open


_STATE_GAUGE = {BreakerState.CLOSED: 0, BreakerState.OPEN: 1,
                BreakerState.HALF_OPEN: 2}


class CircuitBreaker:
    """Per-service batch-failure tracker with trip / cool-down / probe.

    Parameters
    ----------
    name:
        Service name (the ``service=`` metric label).
    failure_threshold:
        Consecutive batch failures that trip the breaker (0 disables
        consecutive tracking).
    window / window_failures:
        Windowed tracking: trip when the last ``window`` outcomes
        contain ``window_failures`` failures — catches a flapping
        service whose failures never run consecutively
        (``window_failures=0`` disables).
    cooldown_s:
        How long OPEN sheds before HALF_OPEN probe traffic is let
        through.
    half_open_probes:
        Admissions allowed while HALF_OPEN (beyond them, submits shed
        until the probe outcome is known).
    close_after:
        Successful batches in HALF_OPEN needed to re-close.
    clock:
        Monotonic-seconds source; injectable for deterministic tests
        (the injectable-clock seam every serve component shares).

    Thread-safe; every transition lands on the
    ``raft_tpu_serve_breaker_*`` metric families.
    """

    def __init__(self, name: str, *,
                 failure_threshold: int = 5,
                 window: int = 16,
                 window_failures: int = 8,
                 cooldown_s: float = 0.25,
                 half_open_probes: int = 4,
                 close_after: int = 1,
                 clock: Callable[[], float] = time.monotonic):
        expects(failure_threshold >= 0,
                "CircuitBreaker: failure_threshold=%d", failure_threshold)
        expects(window >= 1, "CircuitBreaker: window=%d", window)
        expects(window_failures >= 0,
                "CircuitBreaker: window_failures=%d", window_failures)
        expects(window_failures <= window,
                "CircuitBreaker: window_failures=%d > window=%d",
                window_failures, window)
        expects(failure_threshold > 0 or window_failures > 0,
                "CircuitBreaker: both trip conditions disabled — the "
                "breaker could never open")
        expects(cooldown_s >= 0.0, "CircuitBreaker: cooldown_s=%r",
                cooldown_s)
        expects(half_open_probes >= 1,
                "CircuitBreaker: half_open_probes=%d", half_open_probes)
        expects(close_after >= 1, "CircuitBreaker: close_after=%d",
                close_after)
        self.name = name
        self.failure_threshold = int(failure_threshold)
        self.window = int(window)
        self.window_failures = int(window_failures)
        self.cooldown_s = float(cooldown_s)
        self.half_open_probes = int(half_open_probes)
        self.close_after = int(close_after)
        self._clock = clock
        self._lock = threading.Lock()
        self._state = BreakerState.CLOSED
        self._consecutive = 0
        self._outcomes: "collections.deque[bool]" = collections.deque(
            maxlen=self.window)
        self._opened_t = 0.0
        self._half_open_t = 0.0
        self._probes_admitted = 0
        self._half_open_successes = 0
        self._publish_locked()

    # ------------------------------------------------------------------ #
    # state plumbing
    # ------------------------------------------------------------------ #
    def _publish_locked(self) -> None:
        _gauge("raft_tpu_serve_breaker_state",
               "circuit breaker state (0=closed 1=open 2=half-open)",
               self.name).set(_STATE_GAUGE[self._state])

    def _trip_locked(self) -> None:
        self._state = BreakerState.OPEN
        self._opened_t = self._clock()
        self._probes_admitted = 0
        self._half_open_successes = 0
        _counter("raft_tpu_serve_breaker_trips_total",
                 "circuit breaker trips (closed/half-open -> open)",
                 self.name).inc()
        self._publish_locked()
        # the black box: the trip's postmortem tape is captured AT the
        # trip — the last N flight events include the tripping batch's
        # lifecycle (docs/OBSERVABILITY.md "Flight recorder & request
        # tracing").  The recorder's lock nests safely under ours (it
        # never takes a breaker lock).
        flight.record("breaker_open", service=self.name,
                      consecutive=self._consecutive)
        flight.default_recorder().blackbox("breaker_trip",
                                           service=self.name)

    def _to_half_open_locked(self) -> None:
        self._state = BreakerState.HALF_OPEN
        self._half_open_t = self._clock()
        self._probes_admitted = 0
        self._half_open_successes = 0
        self._publish_locked()
        flight.record("breaker_half_open", service=self.name)

    def _close_locked(self) -> None:
        was_open = self._state is not BreakerState.CLOSED
        self._state = BreakerState.CLOSED
        self._consecutive = 0
        self._outcomes.clear()
        self._publish_locked()
        if was_open:
            flight.record("breaker_closed", service=self.name)

    def _maybe_cooled_locked(self) -> None:
        if (self._state is BreakerState.OPEN
                and self._clock() - self._opened_t >= self.cooldown_s):
            self._to_half_open_locked()

    @property
    def state(self) -> BreakerState:
        with self._lock:
            self._maybe_cooled_locked()
            return self._state

    def describe(self) -> Dict:
        """Small state dict (``Service.stats()`` / health_check embed
        it)."""
        with self._lock:
            self._maybe_cooled_locked()
            failures_in_window = sum(1 for ok in self._outcomes
                                     if not ok)
            return {
                "state": self._state.name.lower(),
                "consecutive_failures": self._consecutive,
                "window_failures": failures_in_window,
                "window": self.window,
                "cooldown_s": self.cooldown_s,
                "retry_after_s": self._retry_after_locked(),
            }

    def _retry_after_locked(self) -> float:
        if self._state is BreakerState.OPEN:
            return max(0.0,
                       self._opened_t + self.cooldown_s - self._clock())
        if (self._state is BreakerState.HALF_OPEN
                and self._probes_admitted >= self.half_open_probes):
            # probe budget spent: it refreshes a cooldown after
            # entering half-open (the liveness rule in allow())
            return max(0.0, self._half_open_t + self.cooldown_s
                       - self._clock())
        return 0.0

    # ------------------------------------------------------------------ #
    # admission / dispatch gates
    # ------------------------------------------------------------------ #
    def allow(self) -> bool:
        """Admission gate: True when a submit may enter the queue.
        OPEN sheds (until the cooldown elapses), HALF_OPEN admits up to
        ``half_open_probes`` probe requests."""
        with self._lock:
            self._maybe_cooled_locked()
            if self._state is BreakerState.CLOSED:
                return True
            if self._state is BreakerState.OPEN:
                return False
            if (self._probes_admitted >= self.half_open_probes
                    and self._clock() - self._half_open_t
                    >= self.cooldown_s):
                # liveness: a probe that never produced a batch outcome
                # (expired in queue, shed at the cap, malformed) must
                # not wedge HALF_OPEN shut forever — each elapsed
                # cooldown grants a fresh probe budget
                self._half_open_t = self._clock()
                self._probes_admitted = 0
            if self._probes_admitted < self.half_open_probes:
                self._probes_admitted += 1
                _counter("raft_tpu_serve_breaker_probes_total",
                         "half-open probe admissions", self.name).inc()
                return True
            return False

    def retry_after(self) -> float:
        """Seconds until this breaker can admit again — the
        ``ServiceUnavailableError.retry_after_s`` hint: an OPEN
        breaker's remaining cooldown, or a HALF_OPEN breaker's time to
        its next probe-budget refresh (0.0 when admitting)."""
        with self._lock:
            return self._retry_after_locked()

    def dispatch_hold(self) -> float:
        """Dispatch gate for the worker loop: seconds to hold off batch
        formation (>0 only while OPEN and still cooling down; the
        transition to HALF_OPEN happens here, so the first call after
        the cooldown returns 0 and the held backlog probes)."""
        with self._lock:
            if self._state is not BreakerState.OPEN:
                return 0.0
            remaining = self._retry_after_locked()
            if remaining > 0.0:
                return remaining
            self._to_half_open_locked()
            return 0.0

    # ------------------------------------------------------------------ #
    # outcome recording (the worker calls these per batch)
    # ------------------------------------------------------------------ #
    def record_success(self) -> None:
        """One batch served; in HALF_OPEN, ``close_after`` of these
        re-close the breaker."""
        with self._lock:
            self._consecutive = 0
            self._outcomes.append(True)
            if self._state is BreakerState.HALF_OPEN:
                self._half_open_successes += 1
                if self._half_open_successes >= self.close_after:
                    self._close_locked()

    def record_failure(self, exc: BaseException) -> bool:
        """One batch failed.  Returns True when the failure is
        *service-level* — the breaker is now (or already was) open — so
        the worker re-enqueues the riders once instead of failing them;
        False for a caller-bug (classified out, never counts toward the
        trip) or a failure the breaker absorbed without tripping."""
        if isinstance(exc, CALLER_BUG_ERRORS):
            return False
        with self._lock:
            if self._state is BreakerState.HALF_OPEN:
                # the probe failed: straight back to OPEN, new cooldown
                self._trip_locked()
                return True
            if self._state is BreakerState.OPEN:
                return True
            self._consecutive += 1
            self._outcomes.append(False)
            failures_in_window = sum(1 for ok in self._outcomes
                                     if not ok)
            if ((self.failure_threshold
                 and self._consecutive >= self.failure_threshold)
                    or (self.window_failures
                        and failures_in_window >= self.window_failures)):
                self._trip_locked()
                return True
            return False

    # ------------------------------------------------------------------ #
    # manual levers (RecoveryManager / tests)
    # ------------------------------------------------------------------ #
    def trip(self) -> None:
        """Force OPEN (recovery pauses admission through the same shed
        path traffic already understands)."""
        with self._lock:
            if self._state is not BreakerState.OPEN:
                self._trip_locked()
            else:
                self._opened_t = self._clock()

    def reset(self) -> None:
        """Force CLOSED, clearing all failure history (post-recovery
        re-admission: warmup just proved the rebuilt executables run)."""
        with self._lock:
            self._close_locked()


# ---------------------------------------------------------------------- #
# serve-seam fault injection (the comms harness, retargeted)
# ---------------------------------------------------------------------- #
class ServeFaultInjector(FaultInjector):
    """Patch one :class:`ServeWorker`'s ``_execute`` seam with the
    comms fault vocabulary (:mod:`raft_tpu_torch.comms.faults`).

    The verb every fault matches is ``"serve.<worker name>"`` (pass
    ``verb=None`` faults to match unconditionally); the recorded key is
    ``(verb, padded_rows)`` so assertions can see which bucket a fault
    hit.  The patch sits below the worker's retry/breaker machinery —
    the layering contract of the comms seam, kept: injected failures
    are *seen* by the resilience layer, not bypassing it.

    ``FailNth`` / ``Delay`` / ``RandomFail`` compose as at the comms
    seam.  ``Abort`` is unsupported here (there is no communicator to
    latch — a persistent ``FailNth`` plays the dead-device role and the
    breaker plays the latch).
    """

    def __init__(self, worker: ServeWorker, faults_: List[Fault]):
        # the base class binds the patch target as self._comms; its
        # deactivate() restores self._comms._execute and is inherited
        # unchanged
        super().__init__(worker, faults_)
        self.verb = "serve.%s" % worker.name

    def activate(self) -> None:
        assert self._orig_execute is None, "injector already active"
        worker = self._comms
        self._orig_execute = worker._execute
        orig = self._orig_execute
        verb = self.verb

        def patched(padded):
            rows = int(getattr(padded, "shape", (0,))[0])
            self._fire(worker, verb, (verb, rows))
            return orig(padded)

        worker._execute = patched


@contextlib.contextmanager
def inject_worker(worker: ServeWorker,
                  *faults_: Fault) -> Iterator[ServeFaultInjector]:
    """Scoped serve-seam fault injection: patch ``worker._execute`` for
    the duration of the block, restore after (even on error)::

        with inject_worker(svc.worker,
                           faults.FailNth(1, persistent=True)):
            ...   # every batch fails until the block exits
    """
    injector = ServeFaultInjector(worker, list(faults_))
    injector.activate()
    try:
        yield injector
    finally:
        injector.deactivate()


# ---------------------------------------------------------------------- #
# recovery orchestration
# ---------------------------------------------------------------------- #
class RecoveryManager:
    """Orchestrate serving recovery after a persistent failure.

    One manager spans a set of services — either an explicit list or a
    session's registered services (``Comms.serve``) — plus, optionally,
    the session itself so a rank loss rebuilds the communicator on
    the surviving ranks before the services warm back up.

    :meth:`recover` is THE sequence :

    1. **pause** — every service stops forming batches
       (``MicroBatcher.pause``) and sheds new submits with
       :class:`~raft_tpu_torch.core.error.ServiceUnavailableError`
       (``reason="recovering"``); queued requests stay queued.
    2. **quiesce** — wait for in-flight batches to clear the workers
       (their riders resolved, or re-enqueued by the breaker path).
    3. **rebuild** — ``session.recover(devices=...)``: fresh
       communicator on the survivors, re-injected on every handle.
    4. **re-publish + warmup** — per service: ``post_recover()``
       (ANNService re-materializes its immutable ``(index, delta)``
       snapshot — inserted rows survive the failure; sharded services
       additionally **re-partition** the lost shard's rows/slots
       across the surviving sub-mesh via ``repartition()``, exactly —
       the pinned full index is the re-shard source), then
       ``warmup()`` runs every bucket rung on the new mesh, so no kernel
       library is built or loaded once traffic resumes.
    5. **re-admit** — restart a dead worker thread
       (:meth:`ServeWorker.restart`), resume batch formation, reset the
       breaker.  The queued backlog (including the riders re-enqueued
       at the moment of failure) serves out first.

    Call it from a supervising thread (an operator loop, a test, the
    chaos harness) — never from a worker thread: quiesce waits on the
    workers.  Serialized by an internal lock; concurrent calls queue.
    """

    def __init__(self, session=None,
                 services: Optional[Sequence] = None,
                 clock: Callable[[], float] = time.monotonic):
        expects(session is not None or services is not None,
                "RecoveryManager: pass a session and/or services")
        self._session = session
        self._explicit = list(services) if services is not None else None
        self._clock = clock
        self._lock = threading.Lock()

    def _services(self) -> List:
        svcs = list(self._explicit) if self._explicit is not None else []
        if self._session is not None:
            for svc in self._session.services.values():
                if svc not in svcs:
                    svcs.append(svc)
        return [s for s in svcs if s.is_open()]

    def recover(self, devices: Optional[Sequence] = None, mesh=None, *,
                recover_comms: Optional[bool] = None,
                warmup: bool = True,
                quiesce_timeout: float = 30.0) -> Dict:
        """Run the full recovery sequence (class doc); returns a report
        ``{"services": [names], "comms_recovered": bool,
        "recovery_s": float}``.

        ``devices`` / ``mesh`` name the survivors for the communicator
        rebuild (rank ids or ranks, forwarded to ``Comms.recover``);
        ``recover_comms`` defaults to True when the manager has an
        initialized session.  ``warmup=False`` skips the re-warm
        (transient faults where the mesh never changed).  ``"quiesced": False`` in the report flags a batch that
        was still wedged mid-dispatch past ``quiesce_timeout`` when the
        rebuild proceeded (its riders resolve against the old state —
        recovery cannot wait forever on a dead device call)."""
        if recover_comms is None:
            recover_comms = (self._session is not None
                             and getattr(self._session, "initialized",
                                         False))
        with self._lock:
            t0 = self._clock()
            svcs = self._services()
            # recovery phase events + the pre-recovery black box: the
            # tape of the seconds leading INTO the failure is captured
            # before the sequence mutates any state
            flight.record("recovery_begin",
                          services=[s.name for s in svcs],
                          comms=bool(recover_comms))
            flight.default_recorder().blackbox("recovery")
            for svc in svcs:
                svc.pause()
                flight.record("recovery_pause", service=svc.name)
            try:
                # materialized first: all() over a generator would stop
                # at the first wedged worker and leave later services
                # un-quiesced when the communicator rebuild starts
                quiesced = all([
                    svc.worker.quiesce(timeout=quiesce_timeout)
                    for svc in svcs])
                if recover_comms:
                    flight.record("recovery_rebuild_comms")
                    self._session.recover(devices=devices, mesh=mesh)
                for svc in svcs:
                    svc.post_recover()
                    if warmup:
                        svc.warmup()
                        flight.record("recovery_warmup",
                                      service=svc.name)
                    if (svc.worker.started()
                            and not svc.worker.is_alive()):
                        svc.worker.restart()
                    svc.resume()
                    flight.record("recovery_readmit", service=svc.name)
                    _counter("raft_tpu_serve_recoveries_total",
                             "completed serving recoveries",
                             svc.name).inc()
            except BaseException:
                # a FAILED recovery must not strand the queue behind a
                # paused batcher forever: un-pause (queued riders can
                # dispatch/expire/fail — each still resolves exactly
                # once) but leave each breaker in its tripped state —
                # the service is still broken and admission must keep
                # shedding until a later recovery succeeds
                for svc in svcs:
                    if svc.batcher.paused():
                        svc.batcher.resume()
                raise
            dt = self._clock() - t0
            for svc in svcs:
                _timer("raft_tpu_serve_recovery_seconds",
                       "pause-to-readmit recovery latency",
                       svc.name).observe(dt)
            flight.record("recovery_done",
                          services=[s.name for s in svcs],
                          quiesced=bool(quiesced),
                          recovery_s=round(dt, 6))
        return {"services": [s.name for s in svcs],
                "comms_recovered": bool(recover_comms),
                "quiesced": quiesced,
                "recovery_s": dt}

    def check_and_recover(self, **recover_kwargs) -> Dict:
        """Health-check the session and recover if anything is wrong:
        a failed ``health_check()`` (aborted communicator, dead rank,
        dead worker) runs the full :meth:`recover` sequence on the
        ranks the check reported live; an open breaker with an
        otherwise-healthy mesh takes the CHEAP path — re-admit without
        a communicator rebuild or re-warmup (the mesh and the warmed
        shapes are fine; the breaker would have probed its way closed in
        a cooldown anyway, so escalating a transient trip into a rebuild
        would be self-inflicted downtime).  Returns
        ``{"report": health report, "recovered": bool, "recovery":
        recover report or None}``."""
        expects(self._session is not None,
                "check_and_recover: manager has no session")
        report = self._session.health_check()
        breaker_open = any(
            getattr(getattr(svc, "breaker", None), "state", None)
            is BreakerState.OPEN for svc in self._services())
        if report["ok"] and not breaker_open:
            return {"report": report, "recovered": False,
                    "recovery": None}
        # the MESH verdict, not the overall one: health_check's ok also
        # fails on a tripped breaker / dead worker, which the cheap
        # path exists to handle without a communicator rebuild
        mesh_ok = (all(report["tests"].values())
                   and all(report["ranks"].values()))
        if mesh_ok:
            # comms + ranks healthy; only service-level trouble
            # (tripped breaker, dead worker): restart/re-admit without
            # rebuilding the communicator or re-warming
            recover_kwargs.setdefault("recover_comms", False)
            recover_kwargs.setdefault("warmup", False)
        if "devices" in recover_kwargs or "mesh" in recover_kwargs:
            survivors = recover_kwargs.pop("devices", None)
        else:
            survivors = [rank for rank, ok in report["ranks"].items()
                         if ok]
        recovery = self.recover(devices=survivors, **recover_kwargs)
        return {"report": report, "recovered": True,
                "recovery": recovery}
