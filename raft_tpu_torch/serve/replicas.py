"""Replica groups and hedged dispatch for the serving layer.

Port of ``raft_tpu/serve/replicas.py`` (host Python; its imports
re-pointed at this package).  Sharded serving removes the
single-device capacity cap; this module removes the single-*path*
tail-latency cap.  A :class:`ReplicaSet` holds R copies of a service's
pinned operand, each on a **disjoint sub-mesh** of rank slots
(:func:`split_mesh`; on one card the replicas are disjoint rank slots of
the same device), and dispatches every batch through three layers of
defense:

**Rotation with per-replica breakers.**  Batches round-robin across
replicas; each replica carries its own
:class:`~raft_tpu_torch.serve.resilience.CircuitBreaker`, so a persistently
failing replica *drops out of rotation* (and probes its way back in
through half-open) instead of tripping the whole service — the
service-level breaker only sees failures no replica could absorb.

**Hedged re-dispatch.**  A batch whose execution exceeds the hedge
threshold — fixed (``serve_hedge_ms``) or adaptive
(``serve_hedge_factor`` × the tracked per-bucket-rung p99, floored at
``serve_hedge_min_ms``) — is re-dispatched to a second replica.  First
successful result wins; the riders' futures resolve from the winner
exactly once (the worker thread is the only resolver, and the race
commits a single winner under a lock).

**Loser cancellation — the watchdog commit handshake.**  Each arm
runs on a runner thread carrying the same
``raft_tpu_abandon_lock`` / ``raft_tpu_abandoned`` /
``raft_tpu_dispatch_committed`` attributes the comms watchdog uses
(:class:`~raft_tpu_torch.comms.resilience.RetryPolicy`).  When the race
commits a winner, the loser is *abandoned under its lock*: a loser
still stalled host-side (an injected ``Delay``, a slow host stage)
checks the mark at the fault seam and bails **before dispatching its
program** — the same late-dispatch suppression that keeps an abandoned
comms attempt from racing its retry's collective.  A loser that already
committed its dispatch runs to completion and its result is discarded
(device work is not cancellable — the NCCL/watchdog stance), which is
why a hedge and a straggler can never both resolve the riders.

Streams: on the card each replica runs its arms on a stream of its own,
which waits (by an event) for the worker's stream, where the padded
batch was written; the batch is marked as used there
(``record_stream``), and an arm waits for its stream before it finishes,
as the JAX arm blocks until its result is ready.  The winner's result is
marked as used on the worker's stream, which waits for the winner's.  A
hedge can therefore overtake a straggler on the device, not only on the
host.

Metrics (labels ``service=`` plus ``replica=`` where noted):
``raft_tpu_serve_hedges_total`` (hedges fired),
``raft_tpu_serve_hedge_wins_total`` (hedge result used),
``raft_tpu_serve_hedge_cancelled_total`` (losers discarded/abandoned),
``raft_tpu_serve_replica_failovers_total`` (pre-hedge failure moved to
another replica), ``raft_tpu_serve_replica_errors_total{replica=}``,
``raft_tpu_serve_replica_exec_seconds{replica=}`` (per-replica
execution latency — the per-replica split of the adaptive hedge
threshold's signal; the traffic-shaping digest renders it),
``raft_tpu_serve_replica_state{replica=}`` (0=closed 1=open
2=half-open), ``raft_tpu_serve_replicas_healthy``.

Hedge decisions and winners are also recorded into the flight
recorder (``replica_dispatch`` / ``hedge`` / ``hedge_win`` /
``failover`` events, attached to every rider's trace via the worker's
batch scope — the flight recorder's request tracing).
"""

from __future__ import annotations

import collections
import contextlib
import threading
import time
from typing import Callable, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from raft_tpu_torch.comms.faults import Fault, FaultInjector
from raft_tpu_torch.comms.mesh import Mesh, as_mesh
from raft_tpu_torch.core import flight
from raft_tpu_torch.core import metrics as _metrics
from raft_tpu_torch.core.error import (
    CALLER_BUG_ERRORS,
    ServiceUnavailableError,
    expects,
)
from raft_tpu_torch.serve.resilience import BreakerState
from raft_tpu_torch.serve.scheduler import _leaves

__all__ = ["ReplicaSet", "split_mesh", "inject_replica",
           "ReplicaFaultInjector"]


def split_mesh(mesh: Mesh, axis: str, replicas: int) -> List[Mesh]:
    """Cut a 1-D mesh into ``replicas`` disjoint contiguous sub-meshes
    along ``axis`` (``np.array_split`` sizes: as even as the rank count
    allows).  Contiguous groups keep same-host ranks together, so a
    replica's internal sharded merge stays on fast intra-host links — the
    host-group decomposition argument.  The sub-meshes keep the rank
    slots (ids included): ranks that share a card stay distinct."""
    mesh = as_mesh(mesh)
    expects(axis in mesh.axis_names,
            "split_mesh: axis %r not in mesh axes %r", axis,
            tuple(mesh.axis_names))
    expects(len(mesh.axis_names) == 1,
            "split_mesh: replica groups need a 1-D mesh; got axes %r",
            tuple(mesh.axis_names))
    expects(replicas >= 2, "split_mesh: replicas=%d (need >= 2)",
            replicas)
    ranks = mesh.rank_list()
    expects(len(ranks) >= replicas,
            "split_mesh: %d ranks cannot host %d disjoint replicas",
            len(ranks), replicas)
    groups = np.array_split(np.arange(len(ranks)), replicas)
    return [mesh.submesh([ranks[i] for i in g], (axis,)) for g in groups]


def _labeled(kind: str, name: str, help: str, service: str, **extra):
    label_names = ("service",) + tuple(sorted(extra))
    fam = getattr(_metrics.default_registry(), kind)(
        name, help=help, labels=label_names)
    return fam.labels(service=service, **extra)


class _LatencyTracker:
    """Execution-latency windows for the adaptive hedge threshold,
    tracked BOTH per bucket rung (the aggregate) and per
    (replica, rung).  Thread-safe (losing arms record from their own
    threads); a rung with fewer than ``min_samples`` observations
    reports None — hedging stays off until the tracker has a real p99
    to multiply.

    The per-replica split exists because the aggregate alone is wrong
    under replica skew: one persistently slow replica inflates the
    shared rung p99, which *raises* the hedge threshold exactly when
    hedging should fire sooner.  :meth:`best_p99` — the minimum
    per-replica p99 at the rung — tracks what a *healthy* replica can
    do, so the threshold stays anchored to the latency a hedge could
    actually achieve."""

    def __init__(self, window: int = 64, min_samples: int = 5):
        self._lock = threading.Lock()
        self._window = int(window)
        self._min = int(min_samples)
        self._rungs: dict = {}
        self._replica_rungs: dict = {}   # (replica, rows) -> deque

    def observe(self, rows: int, seconds: float,
                replica: Optional[int] = None) -> None:
        with self._lock:
            dq = self._rungs.get(rows)
            if dq is None:
                dq = self._rungs[rows] = collections.deque(
                    maxlen=self._window)
            dq.append(float(seconds))
            if replica is not None:
                key = (int(replica), rows)
                rdq = self._replica_rungs.get(key)
                if rdq is None:
                    rdq = self._replica_rungs[key] = collections.deque(
                        maxlen=self._window)
                rdq.append(float(seconds))

    @staticmethod
    def _p99_of(dq) -> float:
        s = sorted(dq)
        return s[int(round(0.99 * (len(s) - 1)))]

    def p99(self, rows: int) -> Optional[float]:
        with self._lock:
            dq = self._rungs.get(rows)
            if dq is None or len(dq) < self._min:
                return None
            return self._p99_of(dq)

    def replica_p99(self, replica: int, rows: int) -> Optional[float]:
        with self._lock:
            dq = self._replica_rungs.get((int(replica), rows))
            if dq is None or len(dq) < self._min:
                return None
            return self._p99_of(dq)

    def best_p99(self, rows: int,
                 replicas: Optional[Sequence[int]] = None
                 ) -> Optional[float]:
        """The fastest replica's p99 at this rung (None until some
        replica has ``min_samples`` there) — the adaptive hedge
        threshold's anchor (class doc).

        ``replicas`` restricts the minimum to those indices — the
        caller passes the replicas currently IN ROTATION, because a
        dead replica's frozen fast window would otherwise anchor the
        threshold to a latency no survivor can meet (every batch would
        hedge, doubling device work, until the dead replica's stale
        window happened to be the slow one)."""
        with self._lock:
            allowed = None if replicas is None else set(replicas)
            best = None
            for (rep, r), dq in self._replica_rungs.items():
                if allowed is not None and rep not in allowed:
                    continue
                if r == rows and len(dq) >= self._min:
                    p = self._p99_of(dq)
                    if best is None or p < best:
                        best = p
            return best

    def samples(self, rows: int) -> int:
        with self._lock:
            dq = self._rungs.get(rows)
            return len(dq) if dq is not None else 0

    def per_replica(self) -> dict:
        """{replica: {rung: {"p99_ms", "samples"}}} — the
        traffic-shaping digest's per-replica latency table."""
        with self._lock:
            out: dict = {}
            for (rep, rows), dq in sorted(self._replica_rungs.items()):
                if not dq:
                    continue
                out.setdefault(rep, {})[rows] = {
                    "p99_ms": round(self._p99_of(dq) * 1e3, 3),
                    "samples": len(dq),
                }
            return out


def _ready(out) -> None:
    """Wait for the current stream, on which ``out`` was computed (the
    JAX arm's ``block_until_ready``); nothing to wait for on the CPU."""
    if any(isinstance(t, torch.Tensor) and t.device.type == "cuda" for t in _leaves(out)):
        torch.cuda.current_stream().synchronize()


def _mark(payload, replica) -> "Optional[torch.cuda.Event]":
    """On the card: mark the payload as used on the replica's stream and
    record an event on the current (dispatching) stream for that stream
    to wait on; None on the CPU."""
    if replica.stream is None:
        return None
    if isinstance(payload, torch.Tensor) and payload.device.type == "cuda":
        payload.record_stream(replica.stream)
    ev = torch.cuda.Event()
    ev.record(torch.cuda.current_stream(replica.stream.device))
    return ev


@contextlib.contextmanager
def _on_stream(replica, after):
    """Run the block on the replica's stream, after ``after`` (a no-op
    on the CPU)."""
    if replica.stream is None:
        yield
        return
    replica.stream.wait_event(after)
    with torch.cuda.stream(replica.stream):
        yield


def _adopt(out, replica) -> None:
    """Hand a replica's result to the current (worker's) stream: that
    stream waits for the replica's, and the result's memory is marked as
    used there."""
    if replica.stream is None:
        return
    cur = torch.cuda.current_stream(replica.stream.device)
    cur.wait_stream(replica.stream)
    for t in _leaves(out):
        if isinstance(t, torch.Tensor) and t.device.type == "cuda":
            t.record_stream(cur)


class _Replica:
    """One replica: a sub-mesh, its execute path, its breaker, and on the
    card a stream of its own (module doc)."""

    __slots__ = ("idx", "mesh", "execute", "breaker", "stream")

    def __init__(self, idx: int, mesh, execute: Callable, breaker):
        self.idx = idx
        self.mesh = mesh
        self.execute = execute
        self.breaker = breaker
        dev = mesh.ranks.flat[0].device
        self.stream = torch.cuda.Stream(dev) if dev.type == "cuda" else None


class _Race:
    """First-success-wins commit point shared by a batch's arms (the
    exactly-once half of the hedge contract): the first arm to finish
    *successfully* commits itself as winner under the lock; everything
    later is a loser whose result is discarded."""

    __slots__ = ("lock", "event", "winner")

    def __init__(self):
        self.lock = threading.Lock()
        self.event = threading.Event()
        self.winner = None

    def finish(self, arm: "_Arm") -> bool:
        """Record one arm's completion; True when it committed as the
        winner."""
        with self.lock:
            won = arm.error is None and self.winner is None
            if won:
                self.winner = arm
        arm.done.set()
        self.event.set()
        return won


class _Arm:
    """One replica dispatch running on its own runner thread, carrying
    the watchdog commit-handshake attributes (module doc) so a stalled
    loser can be abandoned host-side."""

    __slots__ = ("replica", "out", "error", "seconds", "done", "thread",
                 "_race", "_clock", "_payload", "_on_finish", "_after")

    def __init__(self, replica: _Replica, payload, clock, race: _Race,
                 name: str, on_finish: Callable[["_Arm", bool], None]):
        self.replica = replica
        # the point on the dispatching (worker's) stream the arm's stream
        # waits for: the padded batch is written by then
        self._after = _mark(payload, replica)
        self.out = None
        self.error: Optional[BaseException] = None
        self.seconds: Optional[float] = None
        self.done = threading.Event()
        self._race = race
        self._clock = clock
        self._payload = payload
        self._on_finish = on_finish
        self.thread = threading.Thread(
            target=self._run, daemon=True,
            name="raft-tpu-hedge-%s-r%d" % (name, replica.idx))
        # the commit handshake (comms/resilience.py): the fault
        # seam's Delay checks these under the lock, so abandon-vs-
        # commit resolves atomically for a stall straddling the hedge
        self.thread.raft_tpu_abandon_lock = threading.Lock()
        self.thread.start()

    def _run(self) -> None:
        t0 = self._clock()
        try:
            with _on_stream(self.replica, self._after):
                out = self.replica.execute(self._payload)
                _ready(out)
            self.out = out
            self.seconds = self._clock() - t0
        except BaseException as e:  # serve-exc-ok: relayed via the race
            # (run()/_settle_single re-raise losers' errors onto the
            # worker's batch-failure path; on_finish counts them into
            # raft_tpu_serve_replica_errors_total and the breaker)
            self.error = e
        won = self._race.finish(self)
        self._on_finish(self, won)

    def abandon(self) -> bool:
        """Cancel a losing arm host-side: mark its runner abandoned
        under the handshake lock.  A ``Delay``-stalled (or otherwise
        pre-dispatch) loser bails at the fault seam instead of
        dispatching its program late; a loser that already committed
        its dispatch runs to completion, result discarded.  Returns
        True when the loser had NOT yet committed (the cancellation
        actually suppressed a dispatch)."""
        with self.thread.raft_tpu_abandon_lock:
            committed = getattr(self.thread,
                                "raft_tpu_dispatch_committed", False)
            if not committed:
                self.thread.raft_tpu_abandoned = True
            return not committed


class ReplicaSet:
    """R replicas of one service operand over disjoint sub-meshes, with
    rotation, per-replica breakers, and hedged dispatch (module doc).

    Parameters
    ----------
    name:
        Service name (the ``service=`` metric label).
    members:
        ``[(mesh, execute), ...]`` — per replica, its sub-mesh and its
        ``execute(padded) -> pytree`` path (may launch asynchronously;
        the arm blocks until ready).
    hedge_s:
        Fixed hedge threshold in seconds; None = adaptive from the
        per-rung p99 tracker.
    hedge_factor / hedge_min_s:
        Adaptive threshold shape: ``max(factor * p99(rung), min_s)``.
    breakers:
        Optional per-replica breaker list (None entries = replica never
        drops out).
    clock:
        Monotonic-seconds source (the shared injectable-clock seam).
    """

    def __init__(self, name: str, members: List[Tuple],
                 *, hedge_s: Optional[float],
                 hedge_factor: float, hedge_min_s: float,
                 breakers: Optional[List] = None,
                 window: int = 64, min_samples: int = 5,
                 clock: Callable[[], float] = time.monotonic):
        expects(len(members) >= 2,
                "ReplicaSet: %d members (need >= 2 — one replica is "
                "just a service)", len(members))
        self.name = name
        self.replicas = [
            _Replica(i, mesh, fn,
                     breakers[i] if breakers is not None else None)
            for i, (mesh, fn) in enumerate(members)]
        self.hedge_s = None if hedge_s is None else float(hedge_s)
        self.hedge_factor = float(hedge_factor)
        self.hedge_min_s = float(hedge_min_s)
        self.tracker = _LatencyTracker(window, min_samples)
        self._clock = clock
        self._lock = threading.Lock()
        self._rr = 0
        self._publish_states()

    # ------------------------------------------------------------------ #
    # rotation
    # ------------------------------------------------------------------ #
    def _pick(self, exclude: Tuple[int, ...] = ()) -> Optional[_Replica]:
        """Next replica in rotation whose breaker admits (a half-open
        breaker's admission IS its probe), or None when every replica
        is excluded or tripped."""
        with self._lock:
            n = len(self.replicas)
            for off in range(n):
                r = self.replicas[(self._rr + off) % n]
                if r.idx in exclude:
                    continue
                if r.breaker is None or r.breaker.allow():
                    self._rr = (self._rr + off + 1) % n
                    return r
            return None

    def _publish_states(self) -> None:
        healthy = 0
        for r in self.replicas:
            state = (BreakerState.CLOSED if r.breaker is None
                     else r.breaker.state)
            if state is not BreakerState.OPEN:
                healthy += 1
            _labeled("gauge", "raft_tpu_serve_replica_state",
                     "per-replica breaker state (0=closed 1=open "
                     "2=half-open)", self.name,
                     replica=r.idx).set(state.value)
        _labeled("gauge", "raft_tpu_serve_replicas_healthy",
                 "replicas currently in rotation (breaker not open)",
                 self.name).set(healthy)

    def rank_ids(self) -> set:
        """All rank ids the replica set spans (the session's
        ``health_check`` validates them against the current mesh)."""
        return {rid for r in self.replicas for rid in r.mesh.rank_ids()}

    def describe(self) -> dict:
        per_replica_lat = self.tracker.per_replica()
        return {
            "replicas": [
                {"idx": r.idx,
                 "ranks": list(r.mesh.rank_ids()),
                 "state": ((BreakerState.CLOSED if r.breaker is None
                            else r.breaker.state).name.lower()),
                 # per-(replica, rung) latency window — the signal the
                 # adaptive hedge threshold anchors on (hedge_after)
                 "latency": per_replica_lat.get(r.idx, {})}
                for r in self.replicas],
            "hedge_ms": (None if self.hedge_s is None
                         else self.hedge_s * 1e3),
            "hedge_factor": self.hedge_factor,
            "hedge_min_ms": self.hedge_min_s * 1e3,
        }

    # ------------------------------------------------------------------ #
    # warmup
    # ------------------------------------------------------------------ #
    def warm(self, payload) -> None:
        """Run ``payload`` through EVERY replica's execute path, on the
        replica's stream (hedged dispatch may route any rung to any
        replica: warming one proves nothing about the others)."""
        for r in self.replicas:
            with _on_stream(r, _mark(payload, r)):
                _ready(r.execute(payload))

    # ------------------------------------------------------------------ #
    # dispatch
    # ------------------------------------------------------------------ #
    def hedge_after(self, rows: int) -> Optional[float]:
        """Seconds to wait on the primary before hedging a ``rows``-row
        batch (None = never hedge: no fixed threshold and the tracker
        has too few samples at this rung).

        Adaptive mode anchors on the FASTEST *in-rotation* replica's
        per-(replica, rung) p99 rather than the shared rung aggregate
        — one slow replica must not raise the threshold that decides
        when to hedge *away from it*, and a dead
        replica's frozen fast window must not anchor a threshold no
        survivor can meet.  The aggregate is the cold-start fallback
        until any single replica has enough samples at the rung."""
        if self.hedge_s is not None:
            return self.hedge_s
        in_rotation = [r.idx for r in self.replicas
                       if r.breaker is None
                       or r.breaker.state is not BreakerState.OPEN]
        p = self.tracker.best_p99(rows, replicas=in_rotation)
        if p is None:
            p = self.tracker.p99(rows)
        if p is None:
            return None
        return max(self.hedge_factor * p, self.hedge_min_s)

    def _on_arm_finish(self, arm: _Arm, won: bool) -> None:
        """Bookkeeping for EVERY arm — winners and losers alike — run
        on the arm's own thread: latency samples feed the tracker, and
        the replica's breaker sees its replica's true outcome even when
        the race already resolved the riders elsewhere."""
        r = arm.replica
        if arm.error is None:
            if arm.seconds is not None:
                self.tracker.observe(int(arm._payload.shape[0]),
                                     arm.seconds, replica=r.idx)
                _labeled("timer", "raft_tpu_serve_replica_exec_seconds",
                         "batch execution latency per replica (the "
                         "per-replica split of the hedge threshold's "
                         "latency signal)", self.name,
                         replica=r.idx).observe(arm.seconds)
            if r.breaker is not None:
                r.breaker.record_success()
        else:
            _labeled("counter", "raft_tpu_serve_replica_errors_total",
                     "batch executions that failed, per replica",
                     self.name, replica=r.idx).inc()
            if (r.breaker is not None
                    and not isinstance(arm.error, CALLER_BUG_ERRORS)):
                r.breaker.record_failure(arm.error)
        self._publish_states()

    def _shed_exhausted(self) -> None:
        raise ServiceUnavailableError(
            "%s: every replica's breaker is open — no replica can "
            "carry this batch; back off and retry" % self.name,
            self.name, "replicas_exhausted", 0.0)

    def run(self, padded):
        """Dispatch one padded batch: rotation-picked primary, hedge on
        straggle, failover-once on failure (class doc).  Returns the
        winning result pytree (already device-ready); raises when no
        replica could serve — the worker relays that to the riders
        through the normal batch-failure path."""
        rows = int(padded.shape[0])
        primary = self._pick()
        if primary is None:
            self._shed_exhausted()
        # attaches to every rider of the current batch (the worker's
        # flight.batch_scope) — the trace's "which replica carried me"
        flight.record_scoped("replica_dispatch", service=self.name,
                             replica=primary.idx, rows=rows)
        threshold = self.hedge_after(rows)
        if threshold is None:
            # hedging cannot fire (adaptive threshold still cold): no
            # point paying a runner thread per batch — execute inline
            # on the worker thread, keeping the failover path (and
            # feeding the tracker the samples that turn hedging on)
            return self._run_inline(primary, padded, rows)
        race = _Race()
        arm = _Arm(primary, padded, self._clock, race, self.name,
                   self._on_arm_finish)
        if arm.done.wait(threshold):
            return self._settle_single(arm, padded)
        hedge_rep = self._pick(exclude=(primary.idx,))
        if hedge_rep is None:
            # no spare replica in rotation: nothing to hedge to — wait
            # the straggler out (the pre-replica behavior)
            arm.done.wait()
            return self._settle_single(arm, padded)
        _labeled("counter", "raft_tpu_serve_hedges_total",
                 "hedged re-dispatches fired on straggling batches",
                 self.name).inc()
        flight.record_scoped("hedge", service=self.name,
                             primary=primary.idx, hedge=hedge_rep.idx,
                             threshold_s=round(threshold, 6))
        arm2 = _Arm(hedge_rep, padded, self._clock, race, self.name,
                    self._on_arm_finish)
        arms = (arm, arm2)
        while True:
            race.event.wait()
            race.event.clear()
            # winner and all-done must be read under ONE lock hold:
            # finish() commits the winner before setting done, so a
            # stale winner=None read paired with a later all-done
            # check would discard a valid result and raise instead
            with race.lock:
                winner = race.winner
                all_done = all(a.done.is_set() for a in arms)
            if winner is not None:
                break
            if all_done:
                # both arms failed: relay the hedge's error (the later
                # attempt — the primary's error already burned its
                # chance); per-replica breakers were fed by on_finish
                raise arm2.error if arm2.error is not None else arm.error
        _adopt(winner.out, winner.replica)
        loser = arm2 if winner is arm else arm
        # loser cancellation (module doc): abandon under the commit
        # handshake — a pre-dispatch loser never launches its program
        loser.abandon()
        _labeled("counter", "raft_tpu_serve_hedge_cancelled_total",
                 "hedge losers abandoned or discarded (exactly one per "
                 "fired hedge)", self.name).inc()
        if winner is arm2:
            _labeled("counter", "raft_tpu_serve_hedge_wins_total",
                     "hedged re-dispatches whose result beat the "
                     "straggling primary", self.name).inc()
        flight.record_scoped("hedge_win", service=self.name,
                             winner=winner.replica.idx,
                             loser=loser.replica.idx,
                             hedge_won=winner is arm2)
        return winner.out

    def _execute_blocking(self, replica: _Replica, padded, rows: int):
        """One inline replica execution on the calling thread, with the
        same bookkeeping an arm's on_finish does; raises on failure."""
        t0 = self._clock()
        try:
            with _on_stream(replica, _mark(padded, replica)):
                out = replica.execute(padded)
                _ready(out)
        except BaseException as e:
            _labeled("counter", "raft_tpu_serve_replica_errors_total",
                     "batch executions that failed, per replica",
                     self.name, replica=replica.idx).inc()
            if (replica.breaker is not None
                    and not isinstance(e, CALLER_BUG_ERRORS)):
                replica.breaker.record_failure(e)
            self._publish_states()
            raise
        seconds = self._clock() - t0
        self.tracker.observe(rows, seconds, replica=replica.idx)
        _labeled("timer", "raft_tpu_serve_replica_exec_seconds",
                 "batch execution latency per replica (the "
                 "per-replica split of the hedge threshold's "
                 "latency signal)", self.name,
                 replica=replica.idx).observe(seconds)
        if replica.breaker is not None:
            replica.breaker.record_success()
        self._publish_states()
        _adopt(out, replica)
        return out

    def _failover(self, failed_idx: int, padded, rows: int, err):
        """Move a failed batch to the next healthy replica ONCE (the
        tripped-replica-drops-out contract: one bad replica must not
        fail the batch while healthy replicas idle); re-raises ``err``
        when no other replica is in rotation."""
        alt = self._pick(exclude=(failed_idx,))
        if alt is None:
            raise err
        _labeled("counter", "raft_tpu_serve_replica_failovers_total",
                 "batches moved to another replica after a primary "
                 "failure", self.name).inc()
        flight.record_scoped("failover", service=self.name,
                             failed=failed_idx, to=alt.idx,
                             error=type(err).__name__)
        return self._execute_blocking(alt, padded, rows)

    def _run_inline(self, primary: _Replica, padded, rows: int):
        try:
            return self._execute_blocking(primary, padded, rows)
        except BaseException as e:
            if isinstance(e, CALLER_BUG_ERRORS) or not isinstance(
                    e, Exception):
                raise
            return self._failover(primary.idx, padded, rows, e)

    def _settle_single(self, arm: _Arm, padded):
        """Resolve an un-hedged arm: return its result, or fail over
        once (:meth:`_failover`)."""
        if arm.error is None:
            _adopt(arm.out, arm.replica)
            return arm.out
        err = arm.error
        if isinstance(err, CALLER_BUG_ERRORS) or not isinstance(
                err, Exception):
            raise err  # caller bugs and worker-killers take their path
        return self._failover(arm.replica.idx, padded,
                              int(padded.shape[0]), err)


# ---------------------------------------------------------------------- #
# per-replica fault injection (the chaos seam for hedging tests)
# ---------------------------------------------------------------------- #
class ReplicaFaultInjector(FaultInjector):
    """Patch ONE replica's execute seam with the comms fault vocabulary
    (:mod:`raft_tpu_torch.comms.faults`) — the seam the hedged-dispatch chaos
    scenario needs: a ``Delay`` on one replica makes it a straggler
    (hedge fires, the delayed loser is abandoned at this very seam via
    the commit handshake), a persistent ``FailNth`` makes it a dead
    replica (its breaker trips it out of rotation).  Verb:
    ``"serve.<service>.r<idx>"``; ``Abort`` is unsupported (no
    communicator to latch)."""

    def __init__(self, service, idx: int, faults_: List[Fault]):
        rs = getattr(service, "_replica_set", None)
        expects(rs is not None,
                "inject_replica: service %r is not replicated",
                getattr(service, "name", service))
        expects(0 <= idx < len(rs.replicas),
                "inject_replica: replica %d out of range (%d replicas)",
                idx, len(rs.replicas))
        self._replica = rs.replicas[idx]
        super().__init__(self._replica, faults_)
        self.verb = "serve.%s.r%d" % (rs.name, idx)

    def activate(self) -> None:
        assert self._orig_execute is None, "injector already active"
        rep = self._replica
        self._orig_execute = rep.execute
        orig = self._orig_execute
        verb = self.verb

        def patched(padded):
            rows = int(getattr(padded, "shape", (0,))[0])
            self._fire(rep, verb, (verb, rows))
            return orig(padded)

        rep.execute = patched

    def deactivate(self) -> None:
        if self._orig_execute is not None:
            self._replica.execute = self._orig_execute
            self._orig_execute = None


@contextlib.contextmanager
def inject_replica(service, idx: int,
                   *faults_: Fault) -> Iterator[ReplicaFaultInjector]:
    """Scoped per-replica fault injection: patch replica ``idx``'s
    execute seam for the duration of the block, restore after (even on
    error)::

        with inject_replica(svc, 0, faults.Delay(0.5)):
            ...   # replica 0 straggles; hedges fire to replica 1
    """
    injector = ReplicaFaultInjector(service, idx, list(faults_))
    injector.activate()
    try:
        yield injector
    finally:
        injector.deactivate()
