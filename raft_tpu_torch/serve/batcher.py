"""Thread-safe micro-batching request queue with traffic shaping.

A copy of ``raft_tpu/serve/batcher.py`` (which holds no JAX) with its
imports re-pointed at this package.

One :class:`MicroBatcher` sits between many submitter threads and one
worker (:class:`raft_tpu_torch.serve.scheduler.ServeWorker`).  Submitters
enqueue :class:`_Request` objects and immediately get a
:class:`ServeFuture`; the worker pulls *batches* formed under a simple
coalescing policy:

- dispatch as soon as ``max_batch_rows`` payload rows are queued, or
- when the oldest queued request has waited ``max_wait_s`` (the
  micro-batching window: latency ceiling a lone request pays to give
  co-batched company a chance to arrive), or
- immediately while draining (flush — nobody new is coming).

**Multi-tenant weighted-fair shaping** (docs/SERVING.md "Traffic
shaping"): requests are tagged with a tenant name at ``submit``; each
tenant owns its own queue, and every coalesce window is formed by
**deficit round robin** — tenant *t* with weight ``w_t`` earns a
per-window quantum of ``max_batch_rows * w_t / W`` rows (W = total
weight of tenants *with queued work*, so an idle tenant's share is
redistributed by construction), carried as a deficit across windows
so a request bigger than one share never starves.  A backlogged bulk
tenant's service rate is therefore *bounded by its weight share per
window* — its surplus waits in its own queue instead of inflating the
shared batch's execution time, which is what keeps the interactive
class's latency near its solo value under bulk saturation.  Admission
splits the same way — each tenant's cap is its weight's share of
``queue_cap`` — so a flood sheds the flooding tenant, not everyone.

**Deadline-aware ordering**: within a tenant's share, requests
dispatch earliest-deadline-first (EDF) rather than FIFO — when
deadlines vary, EDF strictly dominates FIFO on deadline hit rate.  An
explicit priority ``tier`` overrides deadlines (lower tier = more
urgent; requests without a deadline order after all deadlines of their
tier, FIFO among themselves).

Admission control happens at ``submit``: beyond the tenant's share of
``queue_cap`` (or the global cap) the submitter gets
:class:`ServiceOverloadError` *now* — naming the tenant and carrying a
``retry_after_s`` queue-drain estimate — instead of a silently
unbounded queue (shed, don't buffer — the queue would otherwise absorb
the whole overload as latency).

**Request tracing** (docs/OBSERVABILITY.md "Flight recorder & request
tracing"): every admitted request is assigned a process-unique
``trace_id`` and a :class:`~raft_tpu_torch.core.flight.Trace` at admission —
the ``admitted`` event carries the tenant's DRR share context (weight,
queue depth, cap) so a later queue-wait number can be attributed to
the share that produced it — and
:meth:`ServeFuture.trace` hands the complete per-request timeline
back after resolution.

The clock is injectable (``clock=time.monotonic`` by default — note the
function object is the default, the library never calls a wall clock
ad hoc): deterministic tests drive a fake clock and the non-blocking
:meth:`MicroBatcher.take`; production workers block in
:meth:`MicroBatcher.wait_for_batch`.
"""

from __future__ import annotations

import collections
import heapq
import math
import threading
import time
from typing import Any, Callable, Dict, List, Optional

from raft_tpu_torch.core import flight
from raft_tpu_torch.core.error import (
    CommTimeoutError,
    LogicError,
    ServiceOverloadError,
    expects,
)

__all__ = ["ServeFuture", "MicroBatcher"]

DEFAULT_TENANT = "default"


class ServeFuture:
    """Completion handle for one submitted request.

    A minimal future (no cancellation, no callbacks): the worker thread
    resolves it exactly once with a result or an exception; any number
    of threads may :meth:`result` / :meth:`wait` on it.
    """

    __slots__ = ("_event", "_result", "_error", "_service", "_trace")

    def __init__(self, service: str = "serve", trace=None):
        self._event = threading.Event()
        self._result: Any = None
        self._error: Optional[BaseException] = None
        self._service = service
        self._trace = trace

    # -- worker side --------------------------------------------------- #
    def _set_result(self, value: Any) -> None:
        self._result = value
        self._event.set()

    def _set_exception(self, exc: BaseException) -> None:
        self._error = exc
        self._event.set()

    # -- caller side --------------------------------------------------- #
    def done(self) -> bool:
        return self._event.is_set()

    def wait(self, timeout: Optional[float] = None) -> bool:
        return self._event.wait(timeout)

    def _unresolved(self, timeout: Optional[float]) -> CommTimeoutError:
        # the deadline taxonomy everywhere else (queue expiry, watchdog,
        # close) raises CommTimeoutError — a caller-side wait blowing
        # its budget is the same failure class, not a bare TimeoutError
        return CommTimeoutError(
            "serve future for service %r unresolved after waiting %s"
            % (self._service,
               "%.3fs" % timeout if timeout is not None else "forever"))

    def result(self, timeout: Optional[float] = None) -> Any:
        """The request's result; raises the request's failure, or
        :class:`~raft_tpu_torch.core.error.CommTimeoutError` (naming the
        service and the wait) if unresolved within ``timeout``."""
        if not self._event.wait(timeout):
            raise self._unresolved(timeout)
        if self._error is not None:
            raise self._error
        return self._result

    def exception(self, timeout: Optional[float] = None
                  ) -> Optional[BaseException]:
        if not self._event.wait(timeout):
            raise self._unresolved(timeout)
        return self._error

    def trace(self):
        """The request's :class:`~raft_tpu_torch.core.flight.Trace` — the
        complete per-request timeline (admitted → queue wait → batch
        id/rung → hedge outcome → execute bracket → terminal), built
        as the request moves through the pipeline.  Complete once the
        future is resolved (``trace().terminal()`` names how); None
        when flight recording is disabled (``RAFT_TPU_FLIGHT=0``)."""
        return self._trace


class _Request:
    """One queued query block (rows of one submitter's array)."""

    __slots__ = ("payload", "rows", "enqueue_t", "deadline_t", "future",
                 "requeued", "tenant", "tier", "seq", "taken", "trace",
                 "stream")

    def __init__(self, payload, rows: int, enqueue_t: float,
                 deadline_t: Optional[float], service: str = "serve",
                 tenant: str = DEFAULT_TENANT, tier: int = 0,
                 stream=None):
        self.payload = payload
        self.rows = rows
        # the caller's CUDA stream when it is not the worker's (None
        # otherwise): the worker marks the results as used on it
        self.stream = stream
        self.enqueue_t = enqueue_t
        self.deadline_t = deadline_t
        # the request-scoped trace (None when flight recording is off):
        # assigned HERE so the trace_id exists before any queue state
        # does, and handed to the future for ServeFuture.trace()
        self.trace = flight.default_recorder().new_trace(service, tenant)
        self.future = ServeFuture(service, trace=self.trace)
        self.tenant = tenant
        self.tier = tier
        # FIFO tie-break within (tier, deadline); assigned at admission
        self.seq = 0
        # popped-from-queue mark, read by the lazy arrival-order sweep
        self.taken = False
        # the at-most-once recovery re-enqueue mark (scheduler._fail
        # _batch): a rider whose batch died while the breaker tripped is
        # put back exactly once; a second failure relays the error
        self.requeued = False


class _TenantQueue:
    """One tenant's queue: a requeued-first deque (recovery re-enqueues
    are served before fresh traffic) plus an EDF heap ordered by
    (tier, deadline, seq) — no deadline sorts after every deadline of
    its tier, and seq keeps FIFO among equals.  ``deficit`` is the
    tenant's deficit-round-robin credit: unused quota carried across
    windows (so a request bigger than one window's share is never
    starved), reset whenever the queue empties."""

    __slots__ = ("weight", "requeued", "heap", "rows", "depth",
                 "deficit")

    def __init__(self, weight: float):
        self.weight = float(weight)
        self.requeued: "collections.deque[_Request]" = collections.deque()
        self.heap: list = []
        self.rows = 0
        self.depth = 0
        self.deficit = 0.0

    def push(self, req: _Request) -> None:
        key = (req.tier,
               math.inf if req.deadline_t is None else req.deadline_t,
               req.seq)
        heapq.heappush(self.heap, (key, req))
        self.rows += req.rows
        self.depth += 1

    def push_front(self, req: _Request) -> None:
        self.requeued.appendleft(req)
        self.rows += req.rows
        self.depth += 1

    def peek(self) -> Optional[_Request]:
        if self.requeued:
            return self.requeued[0]
        return self.heap[0][1] if self.heap else None

    def pop(self) -> _Request:
        req = (self.requeued.popleft() if self.requeued
               else heapq.heappop(self.heap)[1])
        self.rows -= req.rows
        self.depth -= 1
        return req

    def clear(self) -> None:
        self.requeued.clear()
        self.heap = []
        self.rows = 0
        self.depth = 0


class MicroBatcher:
    """Coalescing request queue (see module doc for the policy).

    Parameters
    ----------
    max_batch_rows:
        Payload-row dispatch threshold AND per-request row cap (a
        request must fit one batch whole — results split per request,
        never mid-request).
    max_wait_s:
        Micro-batching window measured from the oldest queued request.
    queue_cap:
        Admission cap in *requests* (the reference point operators
        reason about: one queue slot = one caller waiting).  Under
        tenancy, each tenant's cap is its weight's share of this.
    clock:
        Monotonic-seconds source; injectable for deterministic tests.
    tenant_weights:
        Optional ``{tenant_name: weight}`` traffic-shaping spec
        (module doc).  None = single-queue serving: every request rides
        one implicit default tenant (full cap, full batch share —
        exactly the pre-tenancy behavior).  Tenants not named here
        (including the default tenant for untagged submits) register on
        first use at weight 1.0 — name production tenants explicitly so
        their shares are pinned.
    """

    def __init__(self, max_batch_rows: int, max_wait_s: float,
                 queue_cap: int,
                 clock: Callable[[], float] = time.monotonic,
                 name: str = "serve",
                 tenant_weights: Optional[Dict[str, float]] = None):
        expects(max_batch_rows >= 1,
                "MicroBatcher: max_batch_rows=%d", max_batch_rows)
        expects(max_wait_s >= 0.0,
                "MicroBatcher: max_wait_s=%r", max_wait_s)
        expects(queue_cap >= 1, "MicroBatcher: queue_cap=%d", queue_cap)
        self.max_batch_rows = int(max_batch_rows)
        self.max_wait_s = float(max_wait_s)
        self.queue_cap = int(queue_cap)
        self.name = str(name)
        self._clock = clock
        self._cond = threading.Condition()
        self._tenants: Dict[str, _TenantQueue] = {}
        if tenant_weights:
            for t, w in tenant_weights.items():
                expects(float(w) > 0.0,
                        "MicroBatcher: tenant %r weight %r must be > 0",
                        t, w)
                self._tenants[str(t)] = _TenantQueue(float(w))
        # arrival-order view across tenants (lazy-swept on pop): the
        # batching window is measured from the OLDEST queued request,
        # which EDF heaps cannot answer
        self._arrivals: "collections.deque[_Request]" = collections.deque()
        self._seq = 0
        self._depth = 0
        self._rows_queued = 0
        # EWMA of observed batch service time (worker feeds it via
        # note_batch_seconds) — the retry_after_s drain estimate's rate
        self._batch_s_ewma = 0.0
        self._paused = False
        self._draining = False
        self._stopped = False

    # ------------------------------------------------------------------ #
    # tenant plumbing
    # ------------------------------------------------------------------ #
    def _tenant_locked(self, name: str) -> _TenantQueue:
        tq = self._tenants.get(name)
        if tq is None:
            tq = self._tenants[name] = _TenantQueue(1.0)
        return tq

    def _tenant_cap_locked(self, name: str) -> int:
        tq = self._tenants.get(name)
        w = tq.weight if tq is not None else 1.0
        total = sum(t.weight for t in self._tenants.values())
        if tq is None:
            total += w
        return max(1, int(self.queue_cap * w / total))

    def tenant_cap(self, tenant: str) -> int:
        """The admission cap ``tenant`` currently gets: its weight's
        share of ``queue_cap`` (the full cap when it is alone)."""
        with self._cond:
            return self._tenant_cap_locked(str(tenant))

    def tenant_depths(self) -> Dict[str, int]:
        """Queued request count per registered tenant."""
        with self._cond:
            return {name: tq.depth
                    for name, tq in self._tenants.items()}

    def tenants(self) -> Dict[str, float]:
        """Registered tenant weights (declared + auto-registered)."""
        with self._cond:
            return {name: tq.weight
                    for name, tq in self._tenants.items()}

    # ------------------------------------------------------------------ #
    # submitter side
    # ------------------------------------------------------------------ #
    def _retry_after_locked(self) -> float:
        """Estimated queue-drain seconds — the
        ``ServiceOverloadError.retry_after_s`` hint: batches left to
        drain × the observed batch service time (the coalesce window
        when no batch has been timed yet)."""
        batches = max(1, -(-self._rows_queued // self.max_batch_rows))
        per = (self._batch_s_ewma if self._batch_s_ewma > 0.0
               else max(self.max_wait_s, 1e-3))
        return batches * per

    def note_batch_seconds(self, seconds: float) -> None:
        """Feed one observed batch service time into the drain-estimate
        EWMA (the worker calls this per finished batch)."""
        with self._cond:
            if self._batch_s_ewma <= 0.0:
                self._batch_s_ewma = float(seconds)
            else:
                self._batch_s_ewma = (0.7 * self._batch_s_ewma
                                      + 0.3 * float(seconds))

    def submit(self, payload, rows: int,
               deadline_t: Optional[float] = None,
               tenant: Optional[str] = None,
               tier: int = 0, stream=None) -> ServeFuture:
        """Enqueue one request; returns its future.

        ``tenant`` tags the request for weighted-fair shaping (None =
        the default tenant); ``tier`` is the priority override (lower =
        more urgent) applied before EDF within the tenant's share.
        ``stream`` is the caller's CUDA stream where it differs from the
        worker's (the results are marked as used on it).

        Raises :class:`ServiceOverloadError` — naming the tenant and
        carrying a ``retry_after_s`` drain estimate — at the tenant's
        (or the global) admission cap, and :class:`LogicError` once
        draining/stopped (a closed service must fail loudly, not buffer
        into a queue nobody serves).
        """
        expects(1 <= rows <= self.max_batch_rows,
                "submit: %d rows outside [1, max_batch_rows=%d] — a "
                "request must fit one batch whole", rows,
                self.max_batch_rows)
        tenant = DEFAULT_TENANT if tenant is None else str(tenant)
        req = _Request(payload, rows, self._clock(), deadline_t,
                       self.name, tenant, int(tier), stream)
        with self._cond:
            if self._draining or self._stopped:
                raise LogicError(
                    "submit: service is draining/closed and no longer "
                    "accepts requests")
            tq = self._tenant_locked(tenant)
            cap = self._tenant_cap_locked(tenant)
            if tq.depth >= cap:
                raise ServiceOverloadError(
                    "serve queue over tenant %r's admission share; "
                    "shed and retry with backoff" % tenant,
                    tq.depth, cap, tenant=tenant,
                    retry_after_s=self._retry_after_locked())
            if self._depth >= self.queue_cap:
                raise ServiceOverloadError(
                    "serve queue over admission cap; shed and retry "
                    "with backoff", self._depth, self.queue_cap,
                    tenant=tenant,
                    retry_after_s=self._retry_after_locked())
            req.seq = self._seq
            self._seq += 1
            # the admitted event is recorded BEFORE the request becomes
            # visible to the worker (push/notify below): once pushed,
            # an idle worker can form the batch and append
            # batch_formed/resolved to this trace immediately — the
            # timeline must already start with `admitted` or the
            # queue-wait bracket renders out of order.  DRR share
            # context is captured under the same lock the admission
            # decision used (docs/OBSERVABILITY.md); the recorder lock
            # is a leaf and nests safely under the cond lock.
            flight.record(
                "admitted", service=self.name, trace=req.trace,
                rows=rows, tier=int(tier),
                deadline_in_s=(None if deadline_t is None else
                               round(deadline_t - req.enqueue_t, 6)),
                depth=self._depth + 1, tenant_depth=tq.depth + 1,
                tenant_weight=tq.weight, cap=cap)
            tq.push(req)
            self._arrivals.append(req)
            self._depth += 1
            self._rows_queued += req.rows
            self._cond.notify_all()
        return req.future

    def depth(self) -> int:
        with self._cond:
            return self._depth

    def rows_queued(self) -> int:
        with self._cond:
            return self._rows_queued

    def empty(self) -> bool:
        with self._cond:
            return self._depth == 0

    def draining(self) -> bool:
        """Whether admission has stopped (drain/close in progress) —
        maintenance work (e.g. compaction) should not start once the
        service is winding down."""
        with self._cond:
            return self._draining

    def paused(self) -> bool:
        """Whether batch formation is paused (recovery in progress)."""
        with self._cond:
            return self._paused

    # ------------------------------------------------------------------ #
    # recovery seams (raft_tpu_torch/serve/resilience.py)
    # ------------------------------------------------------------------ #
    def pause(self) -> None:
        """Stop forming batches (recovery in progress): queued requests
        stay queued, the worker idles.  Unlike :meth:`begin_drain` this
        is reversible (:meth:`resume`); the service façade sheds *new*
        submits with ``ServiceUnavailableError`` while paused."""
        with self._cond:
            self._paused = True
            self._cond.notify_all()

    def resume(self) -> None:
        """Re-admit after a pause: batch formation restarts and the
        queued backlog (including recovery re-enqueues) dispatches."""
        with self._cond:
            self._paused = False
            self._cond.notify_all()

    def requeue(self, reqs: List[_Request]) -> bool:
        """Put already-admitted requests back at the FRONT of their
        tenants' queues (recovery re-enqueue: riders of a batch that
        died while the breaker tripped are served after recovery
        instead of lost).  Bypasses the admission cap and the drain
        gate — these requests were admitted once and must resolve
        exactly once.  Returns False (caller must fail the futures
        instead) once the queue is stopped: after :meth:`shutdown`
        nobody will ever serve them."""
        with self._cond:
            if self._stopped:
                return False
            for req in reversed(reqs):
                req.taken = False
                self._tenant_locked(req.tenant).push_front(req)
                self._arrivals.appendleft(req)
                self._depth += 1
                self._rows_queued += req.rows
            self._cond.notify_all()
        return True

    # ------------------------------------------------------------------ #
    # worker side
    # ------------------------------------------------------------------ #
    def _oldest_locked(self) -> Optional[_Request]:
        while self._arrivals and self._arrivals[0].taken:
            self._arrivals.popleft()
        return self._arrivals[0] if self._arrivals else None

    def _pop_from_locked(self, tq: _TenantQueue) -> _Request:
        req = tq.pop()
        req.taken = True
        self._depth -= 1
        self._rows_queued -= req.rows
        return req

    def _pop_batch_locked(self) -> List[_Request]:
        """Form one batch by deficit round robin across tenants with
        queued work, EDF within each tenant (module doc).

        Each active tenant's per-window quantum is its weight's share
        of ``max_batch_rows`` **over the tenants that currently have
        work** — an idle tenant's share is redistributed by
        construction.  The quantum adds to a per-tenant *deficit*
        carried across windows (capped at the window, reset when the
        queue empties), and the tenant pops whole requests while the
        head fits its deficit — so a request bigger than one window's
        share accumulates credit instead of starving, and a backlogged
        bulk tenant's service rate is *bounded by its weight share per
        window*.  Deliberately NOT work-conserving against an active
        tenant's backlog: backfilling the window from an over-quota
        tenant would inflate every batch's execution time and convert
        the bulk backlog into latency for the interactive class — the
        quota (docs/SERVING.md "Traffic shaping") is exactly the bound
        that keeps interactive p99 near its solo value while bulk
        saturates.  A round that pops nothing (every head larger than
        its tenant's deficit) grants another quantum and retries —
        liveness over strictness; deficits cap at the window so this
        terminates."""
        active = [tq for tq in self._tenants.values() if tq.depth]
        if not active:
            return []
        batch: List[_Request] = []
        remaining = self.max_batch_rows
        total_w = sum(tq.weight for tq in active)
        while True:
            for tq in active:
                tq.deficit = min(
                    float(self.max_batch_rows),
                    tq.deficit
                    + self.max_batch_rows * tq.weight / total_w)
                while remaining > 0:
                    head = tq.peek()
                    if (head is None or head.rows > tq.deficit
                            or head.rows > remaining):
                        break
                    req = self._pop_from_locked(tq)
                    batch.append(req)
                    tq.deficit -= req.rows
                    remaining -= req.rows
                if not tq.depth:
                    # DRR reset: an emptied queue banks no credit
                    tq.deficit = 0.0
            if batch or remaining <= 0:
                return batch
            # nothing popped: every active head is larger than its
            # tenant's deficit — grant another quantum rather than
            # returning an empty "ready" batch (deficits cap at the
            # full window, and every request fits a window, so at
            # most a few rounds run)
            if all(tq.deficit >= self.max_batch_rows
                   for tq in active):
                # capped deficits and still nothing fits ``remaining``
                # — cannot happen for a fresh batch, but guard the
                # loop anyway
                return batch

    def _ready_locked(self, now: float) -> bool:
        if not self._depth:
            return False
        if self._draining or self._stopped:
            return True
        if self._paused:
            return False
        if self._rows_queued >= self.max_batch_rows:
            return True
        head = self._oldest_locked()
        return (head is not None
                and (now - head.enqueue_t) >= self.max_wait_s)

    def take(self) -> Optional[List[_Request]]:
        """Non-blocking: a batch if the policy says dispatch now, else
        None.  The deterministic-test entry point (fake clock + manual
        worker stepping); also used by drain's inline fallback."""
        with self._cond:
            if not self._ready_locked(self._clock()):
                return None
            return self._pop_batch_locked()

    def wait_for_batch(self, timeout: Optional[float] = None
                       ) -> Optional[List[_Request]]:
        """Blocking: the next batch, or None once stopped and empty
        (the worker loop's exit signal).

        ``timeout`` bounds the wait: an empty list is returned when it
        elapses with no batch ready — the worker loop's maintenance
        poll (periodic compaction must get the thread even while the
        queue idles; ``[]`` is "no work yet", distinct from the None
        exit signal)."""
        deadline = None if timeout is None else self._clock() + timeout
        with self._cond:
            while True:
                if self._ready_locked(self._clock()):
                    return self._pop_batch_locked()
                if self._stopped and not self._depth:
                    return None
                poll = None
                if deadline is not None:
                    poll = deadline - self._clock()
                    if poll <= 0:
                        return []
                head = self._oldest_locked()
                if head is not None and not self._paused:
                    remaining = max(1e-3,
                                    head.enqueue_t + self.max_wait_s
                                    - self._clock())
                    self._cond.wait(timeout=remaining if poll is None
                                    else min(remaining, poll))
                else:
                    # empty — or paused for recovery: an overdue head
                    # request must not turn this into a 1 kHz spin;
                    # resume() notifies, so the wake-up is immediate
                    self._cond.wait(timeout=poll)

    # ------------------------------------------------------------------ #
    # lifecycle
    # ------------------------------------------------------------------ #
    def begin_drain(self) -> None:
        """Stop admitting; flush queued requests immediately (no point
        holding the micro-batch window open — nobody new is coming).
        Overrides a recovery pause: drain must serve (or fail) the
        queue out, never hold it hostage to a recovery that will not
        finish."""
        with self._cond:
            self._draining = True
            self._paused = False
            self._cond.notify_all()

    def shutdown(self) -> List[_Request]:
        """Stop the queue for good; returns any requests still queued
        (a non-draining close must fail them, never strand their
        futures).  After shutdown ``wait_for_batch`` returns None."""
        with self._cond:
            self._draining = True
            self._stopped = True
            # dedup by identity: a requeued request re-enters
            # _arrivals at the front while its popped-then-requeued
            # stale entry may still sit mid-deque (the lazy sweep only
            # trims the head) — listing it twice would fail its future
            # twice and over-count the expiry counter
            seen: set = set()
            leftovers = []
            for r in self._arrivals:
                if not r.taken and id(r) not in seen:
                    seen.add(id(r))
                    leftovers.append(r)
            self._arrivals.clear()
            for tq in self._tenants.values():
                tq.clear()
            self._depth = 0
            self._rows_queued = 0
            self._cond.notify_all()
        return leftovers
