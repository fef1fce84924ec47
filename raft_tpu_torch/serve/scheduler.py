"""Serving worker: batch formation -> padded device call -> split.

Port of ``raft_tpu/serve/scheduler.py``.  One :class:`ServeWorker` owns
one daemon thread per service.  The loop:

1. pull a batch from the :class:`~raft_tpu_torch.serve.batcher.MicroBatcher`;
2. expire requests whose deadline passed while queued — their futures
   fail with :class:`~raft_tpu_torch.core.error.CommTimeoutError`
   *before* any device work is spent on them;
3. coalesce the survivors' rows, pad to the
   :class:`~raft_tpu_torch.serve.bucketing.BucketPolicy` rung, run the
   service's device function — optionally under a
   :class:`~raft_tpu_torch.comms.resilience.RetryPolicy` (per-batch
   watchdog + retry; the device function is pure, so a retry is
   idempotent);
4. split result rows back per request and resolve the futures.  A batch
   failure fails every rider's future — riders resubmit independently.

**Execution contract.** ``execute(padded)`` returns a tensor or a tuple
of tensors, each with the padded batch's rows leading; a request's
result is the same structure sliced to its rows.

**Overlapped dispatch.** PyTorch returns before the device finishes, so
the worker splits each batch into a *start* half (expire, coalesce,
pad, launch the device call, record a ``torch.cuda.Event`` on the
stream right after it) and a *finish* half (``event.synchronize()``,
split, resolve).  The loop starts batch N+1's host-side pad/coalesce
and launch while batch N's kernels still run and blocks only at N's
split.  The worker thread coalesces, pads and launches on one stream,
:attr:`ServeWorker.stream`: the stream that was current for the
service's device when the worker was built.  A caller may submit from
any stream: ``Service.submit`` makes the worker's stream wait on the
caller's current stream and marks the payload as used there
(``record_stream``), and ``_finish`` marks each result as used on its
caller's stream.  A future resolves only after its batch's event has
completed, so the caller reads finished tensors.  On the CPU there is
no stream and no event: the call has finished
when ``execute`` returns.  A :class:`RetryPolicy` forces the
synchronous path (a retry must observe the failure before the next
batch is formed).  The JAX package's buffer donation has no
counterpart: PyTorch has no donation, and the worker never hands a
caller's tensor to anything that writes it.

Every step feeds the ``raft_tpu_serve_*`` metric families (labeled
``service=<name>``) and records the request lifecycle into the flight
recorder: batch formation (``batch_formed``), the execute bracket
(``execute_launch`` / ``execute_ready``), and exactly one terminal
event per admitted request (``resolved`` / ``expired`` / ``failed``; a
recovery re-enqueue records a non-terminal ``requeued``).  The device
call runs under :func:`raft_tpu_torch.core.flight.batch_scope`, and each
resolution feeds the service's SLO tracker and slowest-K exemplars.
The JAX package's per-executable device timer
(``raft_tpu_serve_device_seconds{fn=}``) keys on ``profiled_jit`` names,
which do not exist here; the port's cost inventory
(:mod:`raft_tpu_torch.core.inventory`) is keyed by kernel, and a
per-kernel device timer on the serving path is not built yet
(``ROADMAP.md``'s performance list), so the ops plane's roofline join
leaves its measured columns null.  Between batch cycles the worker
pokes the anomaly sentinel (:mod:`raft_tpu_torch.serve.sentinel`).
"""

from __future__ import annotations

import itertools
import threading
import time
from typing import Callable, List, Optional, Sequence

import torch

from raft_tpu_torch.core import flight
from raft_tpu_torch.core import metrics as _metrics
from raft_tpu_torch.core.error import CommTimeoutError, expects
from raft_tpu_torch.serve import sentinel as _sentinel
from raft_tpu_torch.serve.batcher import MicroBatcher, _Request
from raft_tpu_torch.serve.bucketing import BucketPolicy, coalesce, pad_rows

__all__ = ["ServeWorker"]

# process-global batch ids: unique across services, so one flight
# stream never shows two concurrent batches sharing an id
_batch_seq = itertools.count(1)


class _Inflight:
    """One launched-but-unsplit batch (the pipeline register between
    the worker's start and finish halves); ``done`` is the CUDA event
    recorded right after the launch (None on the CPU)."""

    __slots__ = ("live", "spans", "bucket", "payload_rows", "out",
                 "done", "t_launch", "batch_id")

    def __init__(self, live, spans, bucket, payload_rows, out, done,
                 t_launch, batch_id=None):
        self.live = live
        self.spans = spans
        self.bucket = bucket
        self.payload_rows = payload_rows
        self.out = out
        self.done = done
        self.t_launch = t_launch
        self.batch_id = batch_id


def _leaves(out) -> tuple:
    """The tensors of an execute result (a tensor or a tuple of them)."""
    return tuple(out) if isinstance(out, (tuple, list)) else (out,)


def _slice(out, start: int, stop: int):
    """One request's rows of an execute result, in its structure."""
    if isinstance(out, (tuple, list)):
        return tuple(leaf[start:stop] for leaf in out)
    return out[start:stop]


# -- registry helpers (resolved per use: cheap, and reset-proof — a test
# that resets the registry mid-life gets fresh families, not writes into
# orphans) ------------------------------------------------------------- #
def _counter(name: str, help: str, service: str):
    return _metrics.default_registry().counter(
        name, help=help, labels=("service",)).labels(service=service)


def _gauge(name: str, help: str, service: str):
    return _metrics.default_registry().gauge(
        name, help=help, labels=("service",)).labels(service=service)


def _timer(name: str, help: str, service: str):
    return _metrics.default_registry().timer(
        name, help=help, labels=("service",)).labels(service=service)


def _bucket_counter(service: str, bucket: int):
    return _metrics.default_registry().counter(
        "raft_tpu_serve_bucket_calls_total",
        help="padded device calls per shape bucket",
        labels=("service", "bucket")).labels(service=service,
                                             bucket=bucket)


def _rung_timer(service: str, bucket: int):
    return _metrics.default_registry().timer(
        "raft_tpu_serve_exec_rung_seconds",
        help="padded device call latency per shape-bucket rung",
        labels=("service", "rung")).labels(service=service,
                                           rung=bucket)


def _tenant_counter(name: str, help: str, service: str, tenant: str):
    return _metrics.default_registry().counter(
        name, help=help, labels=("service", "tenant")).labels(
            service=service, tenant=tenant)


class ServeWorker:
    """Single-consumer dispatch loop over a :class:`MicroBatcher`.

    Parameters
    ----------
    name:
        Service name (the ``service=`` metric label).
    batcher / policy:
        The request queue and the shape-bucket ladder.
    execute:
        ``execute(padded_batch) -> tensor or tuple of tensors``, each
        with the padded batch's rows as its leading dimension (the
        contract that makes per-request splitting mechanical).
    device:
        The device the service runs on (required: no default stands for
        the CPU).  For a CUDA device the worker coalesces, pads and
        launches on the stream that is current for it at construction
        (:attr:`stream`).
    retry_policy:
        Optional :class:`~raft_tpu_torch.comms.resilience.RetryPolicy` around
        each device call — per-attempt watchdog deadline + backoff
        retries.  Forces synchronous (non-overlapped) dispatch: a retry
        must see its attempt fail, so each attempt blocks until
        device-complete.
    maintenance:
        Optional zero-arg callback run ON the worker thread between
        batch cycles (and on an idle poll every
        ``maintenance_interval_s``): the serving loop's home for
        background index work, without a second thread to coordinate.
        It runs between dispatches, never mid-batch, so an
        index swap it performs can never tear a batch; exceptions are
        counted (``raft_tpu_serve_maintenance_errors_total``), captured
        as :attr:`last_maintenance_error` (surfaced through
        ``Service.stats()`` / session ``health_check()`` — a silently
        failing compactor is visible) and swallowed — a failing
        compactor must not kill the loop serving everyone.
    breaker:
        Optional :class:`~raft_tpu_torch.serve.resilience.CircuitBreaker`.
        The worker records every batch outcome into it; while it is
        OPEN the loop holds batch formation (no point burning queued
        riders against a broken device), and a batch failure that finds
        it open re-enqueues its riders **once** (``_Request.requeued``)
        instead of failing them — the in-flight-futures-survive-
        recovery guarantee.
    clock:
        Shared with the batcher for deadline math.
    """

    def __init__(self, name: str, batcher: MicroBatcher,
                 policy: BucketPolicy,
                 execute: Callable,
                 device,
                 retry_policy=None,
                 maintenance: Optional[Callable[[], None]] = None,
                 maintenance_interval_s: float = 0.05,
                 breaker=None,
                 slo=None,
                 clock: Callable[[], float] = time.monotonic):
        self.name = name
        self._batcher = batcher
        self._policy = policy
        self._execute = execute
        # the stream every batch is coalesced, padded and launched on
        # (None = the CPU: nothing runs asynchronously there)
        device = torch.device(device)
        self.stream = (torch.cuda.current_stream(device)
                       if device.type == "cuda" else None)
        self._retry_policy = retry_policy
        self._maintenance = maintenance
        self._maint_interval = float(maintenance_interval_s)
        self.breaker = breaker
        # per-service SLO tracker (raft_tpu/core/flight.py) — fed one
        # outcome per terminal request resolution; None = untracked
        # (bare workers constructed outside a Service facade)
        self.slo = slo
        # the slowest-K exemplar reservoir, resolved once (the
        # registry lookup must not ride the per-batch hot path)
        self._exemplars = flight.exemplars_for(name)
        # last maintenance failure, surfaced via Service.stats():
        # {"type", "message", "at"} — "at" is the worker clock's
        # monotonic seconds (the only clock the library may read)
        self.last_maintenance_error: Optional[dict] = None
        # payload rows launched but not yet split (worker-thread-only
        # state; the inflight gauge publishes it — a running sum, since
        # the pipelined loop can hold two launched batches briefly)
        self._inflight_rows = 0
        self._clock = clock
        self._thread: Optional[threading.Thread] = None
        self._state = threading.Condition()
        self._busy = False
        self._closed = False

    # ------------------------------------------------------------------ #
    # lifecycle
    # ------------------------------------------------------------------ #
    def start(self) -> "ServeWorker":
        """Spawn the daemon worker thread (idempotent)."""
        with self._state:
            expects(not self._closed, "ServeWorker %s is closed", self.name)
            if self._thread is None:
                self._thread = threading.Thread(
                    target=self._loop, daemon=True,
                    name="raft-tpu-serve-%s" % self.name)
                self._thread.start()
        return self

    def is_alive(self) -> bool:
        with self._state:
            return self._thread is not None and self._thread.is_alive()

    def started(self) -> bool:
        with self._state:
            return self._thread is not None

    def dead(self) -> bool:
        """True when the worker thread was started and has died — the
        hot-path admission check (one lock acquisition per submit)."""
        with self._state:
            return (self._thread is not None
                    and not self._thread.is_alive())

    def restart(self) -> bool:
        """Replace a dead worker thread — the health-repair lever
        (session ``health_check`` names dead workers;
        :class:`~raft_tpu_torch.serve.resilience.RecoveryManager` pulls
        this).  False while the current thread is alive or the worker
        was never started (nothing to repair); raises once closed."""
        with self._state:
            expects(not self._closed, "ServeWorker %s is closed",
                    self.name)
            t = self._thread
            if t is None or t.is_alive():
                return False
            self._thread = threading.Thread(
                target=self._loop, daemon=True,
                name="raft-tpu-serve-%s" % self.name)
            self._thread.start()
        _counter("raft_tpu_serve_worker_restarts_total",
                 "dead worker threads replaced", self.name).inc()
        flight.record("worker_restart", service=self.name)
        return True

    def quiesce(self, timeout: Optional[float] = None) -> bool:
        """Wait until no batch is mid-dispatch (worker idle between
        cycles, or dead).  Unlike :meth:`drain` this touches no
        admission state: queued requests stay queued — the recovery
        sequence pauses the batcher first, quiesces here, and serves
        the backlog out after re-admission.  True when quiet."""
        deadline = None if timeout is None else self._clock() + timeout
        with self._state:
            while self._busy:
                if not (self._thread and self._thread.is_alive()):
                    return True  # a dead thread holds no batch
                if deadline is not None and self._clock() >= deadline:
                    return False
                self._state.wait(timeout=0.05)
            return True

    def _loop(self) -> None:
        """Pipelined worker loop: dispatch batch N+1 while batch N's
        device call runs (module doc).  ``pending`` is the one in-flight
        batch; depth-1 pipelining bounds result latency at one batch
        while already hiding host-side batch formation behind the
        device.

        A :class:`RetryPolicy` disables the pipelining outright, not
        just the launch half: each retried attempt blocks through the
        device call (plus watchdog and backoff) inside ``_start``, so
        deferring the previous batch's ``_finish`` behind it would
        delay results that were already sitting ready by the whole of
        the next batch's (potentially retried) execution — pure loss,
        no overlap gained."""
        pipelined = self._retry_policy is None
        pending = None
        poll = (self._maint_interval if self._maintenance is not None
                else None)
        while True:
            hold = self._dispatch_hold()
            if hold > 0.0:
                # breaker open: stop forming batches — dispatching the
                # queued backlog against a broken device would only
                # burn every rider's single re-enqueue.  Finish the
                # in-flight batch (its results may already be sitting
                # ready), then idle-poll until the cooldown admits
                # half-open probes.  Drain overrides the hold (the
                # gate checks draining): close must serve out or fail,
                # never wait on a recovery that is not coming.
                if pending is not None:
                    try:
                        self._finish(pending)
                    finally:
                        pending = None
                        with self._state:
                            self._busy = False
                            self._state.notify_all()
                with self._state:
                    self._state.wait(timeout=min(hold, 0.05))
                self.run_maintenance()
                continue
            if pending is None:
                batch = self._batcher.wait_for_batch(timeout=poll)
                if batch is None:
                    return
                if not batch:
                    # idle maintenance poll — no work queued, so a
                    # long compaction delays nobody
                    self.run_maintenance()
                    continue
            else:
                # opportunistic, non-blocking: if the policy has a
                # batch ready NOW, start it before finishing the
                # in-flight one (the overlap); otherwise complete the
                # in-flight batch — its riders must not wait on an
                # idle queue
                batch = self._batcher.take()
                if not batch:
                    try:
                        self._finish(pending)
                    finally:
                        pending = None
                        with self._state:
                            self._busy = False
                            self._state.notify_all()
                    self.run_maintenance()
                    continue
            with self._state:
                self._busy = True
            nxt = None
            try:
                if pipelined:
                    nxt = self._start(batch)
                else:
                    self.dispatch(batch)
            finally:
                if pending is not None:
                    self._finish(pending)
                pending = nxt
                if pending is None:
                    with self._state:
                        self._busy = False
                        self._state.notify_all()
            # the maintenance seam: between batch cycles, never
            # mid-batch, and ALWAYS after the previous batch's riders
            # were resolved — a long compaction here overlaps at most
            # the just-launched batch's device compute, never withholds
            # results that are already sitting ready (the same argument
            # the retry path makes about deferring _finish).  Cheap
            # no-op when nothing is due.
            self.run_maintenance()

    def _dispatch_hold(self) -> float:
        """Seconds the breaker wants dispatch held (0.0 = go).  Drain
        wins over the hold: a draining queue must be served out (or
        failed onto futures) rather than held for a recovery."""
        if self.breaker is None or self._batcher.draining():
            return 0.0
        return self.breaker.dispatch_hold()

    def run_once(self) -> bool:
        """Manual stepping for threadless/deterministic operation: form
        and dispatch one batch if the policy allows (and the breaker
        does not hold); True if one ran."""
        if self._dispatch_hold() > 0.0:
            return False
        batch = self._batcher.take()
        if not batch:
            return False
        self.dispatch(batch)
        return True

    def run_maintenance(self) -> None:
        """Run the maintenance callback (if any) on the calling thread.

        The worker loop calls this between batch cycles; threadless
        services may step it manually.  ``_busy`` is held (and restored
        — a pipelined in-flight batch keeps it set) so ``drain``
        observes maintenance as work in progress: after ``drain()``
        returns, no compaction is mid-flight.  Never raises."""
        # the anomaly sentinel rides the maintenance seam: a loaded
        # serving process notices a breach within one batch cycle
        # (rate-limited and exception-proof inside; a no-op when no ops
        # plane registered a sentinel)
        _sentinel.poke()
        fn = self._maintenance
        if fn is None:
            return
        with self._state:
            was_busy = self._busy
            self._busy = True
        try:
            fn()
            self.last_maintenance_error = None
        except Exception as e:  # noqa: BLE001 — counted, never loop-fatal
            _counter("raft_tpu_serve_maintenance_errors_total",
                     "maintenance callback failures", self.name).inc()
            # a bare counter hides WHAT keeps failing: capture the last
            # failure for Service.stats() / session health_check
            self.last_maintenance_error = {
                "type": type(e).__name__,
                "message": str(e)[:500],
                "at": self._clock(),
            }
        finally:
            with self._state:
                self._busy = was_busy
                self._state.notify_all()

    def drain(self, timeout: Optional[float] = None) -> bool:
        """Stop admission and serve out everything queued/in flight.

        With a live worker thread this blocks (up to ``timeout``) until
        the queue is empty and the worker idle; threadless services are
        drained inline on the calling thread.  Returns True when fully
        drained.
        """
        self._batcher.begin_drain()
        if not self.started():
            while self.run_once():
                pass
            return self._batcher.empty()
        deadline = None if timeout is None else self._clock() + timeout
        with self._state:
            while not (self._batcher.empty() and not self._busy):
                if not (self._thread and self._thread.is_alive()):
                    break  # dead worker: inline fallback below
                if deadline is not None and self._clock() >= deadline:
                    return False
                self._state.wait(timeout=0.05)
        # a crashed worker thread must not strand queued requests
        while self.run_once():
            pass
        return self._batcher.empty()

    def close(self, drain: bool = True,
              timeout: Optional[float] = None) -> None:
        """Drain (by default), stop the queue, fail any leftovers, and
        join the worker thread.  Idempotent."""
        with self._state:
            if self._closed:
                return
            self._closed = True
        if drain:
            self.drain(timeout=timeout)
        leftovers = self._batcher.shutdown()
        for req in leftovers:
            flight.record("expired", service=self.name, trace=req.trace,
                          reason="close")
            if self.slo is not None:
                self.slo.observe(req.tenant,
                                 self._clock() - req.enqueue_t,
                                 deadline_ok=False)
            req.future._set_exception(CommTimeoutError(
                "service %s closed before the request was served"
                % self.name))
        if leftovers:
            _counter("raft_tpu_serve_expired_total",
                     "requests failed by deadline or close",
                     self.name).inc(len(leftovers))
        t = self._thread
        if t is not None and t.is_alive():
            t.join(timeout=5.0)

    # ------------------------------------------------------------------ #
    # dispatch
    # ------------------------------------------------------------------ #
    def _fail_batch(self, live: List[_Request],
                    exc: BaseException) -> None:
        """Relay one batch failure.  Classification first: the breaker
        ignores caller bugs and decides whether this failure is
        *service-level* (it is now, or already was, open).  Service-
        level failures re-enqueue each rider ONCE — at the moment of a
        trip the in-flight futures are put back to be served after
        recovery, not lost — while a rider on its second strike (or any
        non-service-level failure) gets the exception: riders resubmit.
        Never raises."""
        _counter("raft_tpu_serve_batch_errors_total",
                 "batches whose device call failed", self.name).inc()
        service_level = (self.breaker.record_failure(exc)
                         if self.breaker is not None else False)
        retry: List[_Request] = []
        err_name = type(exc).__name__
        for req in live:
            if service_level and not req.requeued:
                req.requeued = True
                retry.append(req)
            else:
                # terminal event before the future resolves (the
                # trace-complete-at-resolution contract)
                self._fail_terminal(req, err_name)
                req.future._set_exception(exc)
        if retry:
            if self._batcher.requeue(retry):
                _counter("raft_tpu_serve_requeued_total",
                         "riders re-enqueued once across a breaker "
                         "trip/recovery", self.name).inc(len(retry))
                flight.record("requeued", service=self.name,
                              traces=[r.trace for r in retry],
                              error=err_name)
            else:
                # queue already shut down: nobody will ever serve the
                # re-enqueue — the exception is the only resolution
                for req in retry:
                    self._fail_terminal(req, err_name)
                    req.future._set_exception(exc)

    def _fail_terminal(self, req: _Request, err_name: str) -> None:
        """One request's terminal ``failed`` event + SLO miss (the
        exactly-one-terminal contract's failure leg)."""
        flight.record("failed", service=self.name, trace=req.trace,
                      error=err_name,
                      latency_s=round(
                          max(0.0, self._clock() - req.enqueue_t), 6))
        if self.slo is not None:
            self.slo.observe(req.tenant,
                             self._clock() - req.enqueue_t,
                             deadline_ok=False)

    def _expire_locked_out(self, batch: List[_Request],
                           now: float) -> List[_Request]:
        live: List[_Request] = []
        expired = 0
        for req in batch:
            if req.deadline_t is not None and now >= req.deadline_t:
                expired += 1
                # terminal event before the future resolves (the
                # trace-complete-at-resolution contract)
                flight.record("expired", service=self.name,
                              trace=req.trace, reason="deadline",
                              waited_s=round(now - req.enqueue_t, 6))
                if self.slo is not None:
                    self.slo.observe(req.tenant, now - req.enqueue_t,
                                     deadline_ok=False)
                req.future._set_exception(CommTimeoutError(
                    "request exceeded its deadline after %.3fs in the "
                    "%s queue" % (now - req.enqueue_t, self.name)))
            else:
                live.append(req)
        if expired:
            _counter("raft_tpu_serve_expired_total",
                     "requests failed by deadline or close",
                     self.name).inc(expired)
        return live

    def dispatch(self, batch: Sequence[_Request]) -> None:
        """Run one formed batch to completion (never raises for
        Exception-class failures: they land on the riders' futures — a
        poisoned batch must not kill the loop serving everyone else.
        A worker-killing BaseException still propagates, but only
        after every rider was resolved or re-enqueued).  Synchronous
        start+finish — the manual-stepping (``run_once``) and drain
        entry point; the worker loop pipelines the two halves."""
        inflight = self._start(batch)
        if inflight is not None:
            self._finish(inflight)

    def _start(self, batch: Sequence[_Request]
               ) -> Optional["_Inflight"]:
        """Host half: expire, coalesce, pad, LAUNCH the device call
        (async dispatch — does not wait for the result).  Returns the
        in-flight record, or None if nothing survived / the launch
        failed (riders already resolved).  Never raises."""
        now = self._clock()
        _gauge("raft_tpu_serve_queue_depth", "requests queued",
               self.name).set(self._batcher.depth())
        live = self._expire_locked_out(list(batch), now)
        if not live:
            return None
        wait_t = _timer("raft_tpu_serve_wait_seconds",
                        "enqueue-to-dispatch queue wait", self.name)
        for req in live:
            wait_t.observe(max(0.0, now - req.enqueue_t))
        payload_rows = sum(r.rows for r in live)
        launched = False
        batch_id = next(_batch_seq)
        rider_traces = [r.trace for r in live]
        try:
            # coalesce, pad and launch all on the worker's stream
            # (None on the CPU: a no-op); submit made it wait on each
            # caller's stream, so every payload is written by then
            with torch.cuda.stream(self.stream):
                bucket = self._policy.bucket_for(payload_rows)
                flight.record("batch_formed", service=self.name,
                              traces=rider_traces, batch=batch_id,
                              rung=bucket, riders=len(live),
                              rows=payload_rows)
                stacked, spans = coalesce([r.payload for r in live])
                padded = pad_rows(stacked, bucket)
                # the gauge tracks a running SUM: under the pipelined loop
                # batch N+1 launches before batch N's _finish, so set/zero
                # per batch would read 0 while a call is actually in flight
                self._inflight_rows += payload_rows
                launched = True
                _gauge("raft_tpu_serve_inflight_rows",
                       "payload rows in launched, not-yet-split device "
                       "calls", self.name).set(self._inflight_rows)
                t_launch = self._clock()
                flight.record("execute_launch", service=self.name,
                              traces=rider_traces, batch=batch_id,
                              rung=bucket)
                # batch_scope: deeper layers attach their events to every
                # rider's trace without the execute signature carrying
                # trace handles
                with flight.batch_scope(rider_traces):
                    if self._retry_policy is not None:
                        # synchronous: each attempt must surface its own
                        # device failure INSIDE the retry loop, so block
                        # per attempt (module doc)
                        def attempt(p):
                            res, done = self._launch(p)
                            if done is not None:
                                done.synchronize()
                            return res, None

                        out, done = self._retry_policy.call(
                            attempt, padded, verb="serve.%s" % self.name)
                    else:
                        out, done = self._launch(padded)
                return _Inflight(live, spans, bucket, payload_rows, out, done,
                                 t_launch, batch_id)
        except BaseException as e:  # noqa: BLE001 — relayed/requeued per rider
            self._fail_batch(live, e)
            if launched:
                self._inflight_rows -= payload_rows
            _gauge("raft_tpu_serve_inflight_rows",
                   "payload rows in launched, not-yet-split device "
                   "calls", self.name).set(self._inflight_rows)
            if not isinstance(e, Exception):
                # worker-killing class (SystemExit & co.): the thread
                # is about to die — but only AFTER every rider was
                # resolved or re-enqueued above, so no future is lost
                # and restart() can serve the requeued backlog
                raise
            return None

    def _launch(self, padded):
        """Run ``execute`` (on the worker's stream, which ``_start`` has
        entered) and record the event that marks its end there (None on
        the CPU)."""
        out = self._execute(padded)
        if self.stream is None:
            return out, None
        done = torch.cuda.Event()
        done.record(self.stream)
        return out, done

    def _finish(self, inflight: "_Inflight") -> None:
        """Device half: block until the launched call completes, split
        rows per request, resolve futures, account.  Never raises."""
        live, spans, bucket = (inflight.live, inflight.spans,
                               inflight.bucket)
        payload_rows, out = inflight.payload_rows, inflight.out
        try:
            for leaf in _leaves(out):
                expects(leaf.shape[0] == bucket,
                        "serve execute contract: leaf leading dim %d != "
                        "padded batch rows %d", leaf.shape[0], bucket)
            # THE one block point: everything host-side for the next
            # batch already happened while this ran on device
            t_block = self._clock()
            if inflight.done is not None:
                inflight.done.synchronize()
            t_ready = self._clock()
            # launch→observed-ready is an UPPER bound on device
            # latency: under the overlapped loop the next batch's
            # host-side formation runs between launch and this block,
            # so a device call that finished during it is only
            # observed ready here.  block_seconds (time actually
            # spent blocked) is the matching lower bound on the
            # device work remaining at split time.
            _timer("raft_tpu_serve_exec_seconds",
                   "padded device call latency, launch to observed "
                   "result-ready (upper bound under the overlapped "
                   "loop)", self.name).observe(
                       max(0.0, t_ready - inflight.t_launch))
            # same latency, keyed by shape rung, so a regression in
            # one bucket cannot hide inside a healthy mix
            _rung_timer(self.name, bucket).observe(
                max(0.0, t_ready - inflight.t_launch))
            _timer("raft_tpu_serve_block_seconds",
                   "time the worker blocked on device results "
                   "(lower bound on device latency at split time)",
                   self.name).observe(max(0.0, t_ready - t_block))
            flight.record("execute_ready", service=self.name,
                          traces=[r.trace for r in live],
                          batch=inflight.batch_id,
                          exec_s=round(
                              max(0.0, t_ready - inflight.t_launch), 6),
                          block_s=round(max(0.0, t_ready - t_block), 6))
            exemplars = self._exemplars
            for req, (start, stop) in zip(live, spans):
                # terminal event + SLO/exemplar BEFORE the future
                # resolves (the admitted-event ordering rule, mirrored
                # at the other end): a caller woken by result() must
                # already see the complete timeline
                latency = max(0.0, t_ready - req.enqueue_t)
                flight.record("resolved", service=self.name,
                              trace=req.trace,
                              batch=inflight.batch_id,
                              latency_s=round(latency, 6))
                if self.slo is not None:
                    self.slo.observe(
                        req.tenant, latency,
                        deadline_ok=(req.deadline_t is None
                                     or t_ready <= req.deadline_t))
                if req.trace is not None:
                    exemplars.observe(latency, req.trace.trace_id)
                if req.stream is not None:
                    # the caller reads its rows on its own stream: the
                    # allocator must not hand the block back to this
                    # stream before that stream's reads have run
                    for leaf in _leaves(out):
                        leaf.record_stream(req.stream)
                req.future._set_result(_slice(out, start, stop))
        except BaseException as e:  # noqa: BLE001 — relayed/requeued per rider
            self._fail_batch(live, e)
            if not isinstance(e, Exception):
                raise  # worker-killing: die with every rider resolved
            return
        finally:
            self._inflight_rows -= inflight.payload_rows
            _gauge("raft_tpu_serve_inflight_rows",
                   "payload rows in launched, not-yet-split device "
                   "calls", self.name).set(self._inflight_rows)
        # accounting only after a successful dispatch
        if self.breaker is not None:
            self.breaker.record_success()
        # feed the admission layer's queue-drain estimate (the
        # ServiceOverloadError.retry_after_s hint)
        self._batcher.note_batch_seconds(
            max(1e-6, t_ready - inflight.t_launch))
        _counter("raft_tpu_serve_batches_total", "dispatched batches",
                 self.name).inc()
        _counter("raft_tpu_serve_requests_total", "served requests",
                 self.name).inc(len(live))
        per_tenant: dict = {}
        for req in live:
            rows_n, reqs_n = per_tenant.get(req.tenant, (0, 0))
            per_tenant[req.tenant] = (rows_n + req.rows, reqs_n + 1)
        for tenant, (rows_n, reqs_n) in per_tenant.items():
            _tenant_counter("raft_tpu_serve_tenant_rows_total",
                            "payload rows served, per tenant",
                            self.name, tenant).inc(rows_n)
            _tenant_counter("raft_tpu_serve_tenant_requests_total",
                            "requests served, per tenant",
                            self.name, tenant).inc(reqs_n)
        _counter("raft_tpu_serve_payload_rows_total",
                 "real (caller) rows dispatched", self.name).inc(
                     payload_rows)
        _counter("raft_tpu_serve_padded_rows_total",
                 "zero-pad rows dispatched (waste)", self.name).inc(
                     bucket - payload_rows)
        _timer("raft_tpu_serve_batch_rows",
               "payload rows per batch (a row-count histogram riding "
               "the timer type; seconds formatting does not apply)",
               self.name).observe(float(payload_rows))
        _bucket_counter(self.name, bucket).inc()
