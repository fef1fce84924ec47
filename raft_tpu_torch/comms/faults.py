"""Deterministic, seedable fault injection for an execute seam.

A copy of ``raft_tpu/comms/faults.py`` with its imports re-pointed at
this package.  The harness wraps a communicator's ``_execute``
(:class:`~raft_tpu_torch.comms.host_comms.HostComms`: every eager
collective, the p2p ``waitall`` and the per-rank liveness probe funnel
through it) with :func:`inject`, and the same fault objects drive the
**serving** execute seam
(:func:`raft_tpu_torch.serve.resilience.inject_worker` patches
``ServeWorker._execute``) and a replica's
(:func:`raft_tpu_torch.serve.replicas.inject_replica`).  The injector
patches **below** the retry/abort and breaker machinery, so an injected
failure takes the path a real device failure takes.

Faults (compose freely, first match wins per call):

- :class:`FailNth` — raise on the nth matching call (transient by
  default; ``persistent=True`` keeps failing from then on).
- :class:`Delay` — sleep before executing a matching call (drives the
  watchdog timeout path); optionally scoped to calls whose static
  parameters involve a given rank.
- :class:`Abort` — from the nth matching call on, latch the target
  aborted and raise :class:`~raft_tpu_torch.core.error.CommAbortedError`
  (comms only: it needs a target with ``abort()``).  With ``rank=`` it
  is the loss of that rank: it matches every verb the rank takes part
  in (every collective, a p2p layer or a probe that names it), so the
  communicator aborts and the session's per-rank probe reports that rank
  dead while the others answer.  On a card whose rank slots share the
  device, this seam is how a rank is lost.
- :class:`RandomFail` — fail each matching call with probability ``p``
  from a private ``random.Random(seed)`` stream: deterministic for a
  given seed.

Usage::

    with faults.inject(comms, faults.FailNth(1, verb="allreduce")) as log:
        out = comms.allreduce(x)      # first execution fails, retry wins
    assert log.injected[0].verb == "allreduce"
"""

from __future__ import annotations

import contextlib
import enum
import random
import threading
import time
from typing import Iterator, List, NamedTuple, Optional, Tuple

from raft_tpu_torch.core import tracing
from raft_tpu_torch.core.error import CommAbortedError, CommError, CommTimeoutError


class InjectedError(CommError):
    """A transient failure raised by the injection harness (stands in
    for a device or transport error)."""


def _ranks_in_key(key: tuple) -> Tuple[int, ...]:
    """Static rank parameters mentioned by a verb's cache key: roots
    (bcast/gather*; reduce's key has no root — its result is replicated)
    and permutation/multicast endpoints.  Enum statics (Op/Status) are
    not ranks and are excluded."""
    ranks: List[int] = []
    for part in key[1:]:
        if (isinstance(part, int) and not isinstance(part, bool)
                and not isinstance(part, enum.Enum)):
            ranks.append(part)
        elif isinstance(part, tuple):
            for p in part:
                if isinstance(p, tuple):
                    ranks.extend(q for q in p if isinstance(q, int))
    return tuple(ranks)


class Fault:
    """Base fault: matching by verb name (None = every verb)."""

    def __init__(self, verb: Optional[str] = None):
        self.verb = verb

    def matches(self, verb: str, key: tuple) -> bool:
        return self.verb is None or self.verb == verb

    def apply(self, comms, verb: str, key: tuple, n_match: int) -> bool:
        """Called before a matching execution (``n_match`` is 1-based
        count of matching calls so far).  Raise to inject a failure;
        return True for a non-raising effect (a delay) so the injector
        records it."""
        raise NotImplementedError


class FailNth(Fault):
    """Raise :class:`InjectedError` on the nth matching call (1-based);
    with ``persistent=True``, on every call from the nth onward."""

    def __init__(self, n: int = 1, verb: Optional[str] = None,
                 persistent: bool = False):
        super().__init__(verb)
        self.n = int(n)
        self.persistent = persistent

    def apply(self, comms, verb, key, n_match):
        if n_match == self.n or (self.persistent and n_match >= self.n):
            raise InjectedError(
                "injected transient failure: verb=%s call=%d" % (verb, n_match))
        return False


class Delay(Fault):
    """Sleep ``seconds`` before a matching verb executes.  ``rank``
    restricts to calls whose static parameters (root, permutation
    endpoints) involve that rank; ``times`` bounds how many calls are
    delayed (None = all)."""

    def __init__(self, seconds: float, verb: Optional[str] = None,
                 rank: Optional[int] = None, times: Optional[int] = None,
                 sleep=time.sleep):
        super().__init__(verb)
        self.seconds = float(seconds)
        self.rank = rank
        self.times = times
        self._sleep = sleep

    def matches(self, verb, key):
        if not super().matches(verb, key):
            return False
        return self.rank is None or self.rank in _ranks_in_key(key)

    def apply(self, comms, verb, key, n_match):
        if self.times is None or n_match <= self.times:
            # count before sleeping: a delayed attempt may be abandoned
            # by the watchdog, and the injection must be visible on the
            # counter while the delay is still in flight
            tracing.counter_inc("comms.fault_injected")
            self._sleep(self.seconds)
            # the watchdog abandoned this attempt while it slept: bail
            # BEFORE the verb dispatches its program — a late
            # collective racing the retry's (or the next test's)
            # collective deadlocks the CPU backend's shared rendezvous.
            # The check-or-commit runs under the watchdog's handshake
            # lock (RetryPolicy._attempt) so a delay straddling the
            # deadline cannot read a stale flag and dispatch anyway.
            # The error lands in the abandoned runner's discarded
            # result box, never a caller.
            cur = threading.current_thread()
            lock = getattr(cur, "raft_tpu_abandon_lock", None)
            with lock if lock is not None else contextlib.nullcontext():
                if getattr(cur, "raft_tpu_abandoned", False):
                    raise CommTimeoutError(
                        "delayed attempt abandoned by the watchdog; "
                        "suppressing its late dispatch")
                cur.raft_tpu_dispatch_committed = True
            return True
        return False


class Abort(Fault):
    """From the nth matching call on: latch the communicator aborted and
    raise :class:`CommAbortedError` — the peer-observed ``ncclCommAbort``.
    Persistent by construction (the latch outlives the injector).
    ``rank`` scopes it to the verbs that rank takes part in (module
    doc): the lost-rank fault."""

    # verbs whose key names their participants; every other verb is a
    # collective of the whole communicator
    _NAMED = ("probe", "p2p")

    def __init__(self, n: int = 1, verb: Optional[str] = None, rank: Optional[int] = None):
        super().__init__(verb)
        self.n = int(n)
        self.rank = rank

    def matches(self, verb, key):
        if not super().matches(verb, key):
            return False
        return (self.rank is None or key[0] not in self._NAMED
                or self.rank in _ranks_in_key(key))

    def apply(self, comms, verb, key, n_match):
        if n_match >= self.n:
            comms.abort()
            raise CommAbortedError(
                "injected abort: verb=%s call=%d%s"
                % (verb, n_match, "" if self.rank is None else " rank=%d" % self.rank))


class RandomFail(Fault):
    """Fail each matching call with probability ``p``, drawn from a
    private seeded stream — deterministic per seed, independent of any
    other randomness in the process."""

    def __init__(self, p: float, seed: int, verb: Optional[str] = None):
        super().__init__(verb)
        self.p = float(p)
        self._rng = random.Random(seed)

    def apply(self, comms, verb, key, n_match):
        if self._rng.random() < self.p:
            raise InjectedError(
                "injected random failure: verb=%s call=%d" % (verb, n_match))
        return False


class Injection(NamedTuple):
    """One injected (or delayed) event, recorded for assertions."""

    verb: str
    call: int
    fault: Fault


class FaultInjector:
    """Instance-level wrapper around one communicator's ``_execute``.

    Counts calls per fault (a fault's ``n`` is relative to *its* matching
    stream, not the global call count), applies the first matching fault,
    and records every injection in :attr:`injected`.  ``calls`` counts
    every execution attempt that reached the harness — retries included —
    so tests can assert exactly how many times the transport was hit.
    """

    def __init__(self, comms, faults_: List[Fault]):
        self._comms = comms
        self._faults = list(faults_)
        self._match_counts = [0] * len(self._faults)
        self._orig_execute = None
        self.calls: List[Tuple[str, tuple]] = []
        self.injected: List[Injection] = []

    def _fire(self, target, verb: str, key: tuple) -> None:
        """Record the call and apply the first matching fault (raising
        to inject a failure).  ``target`` is whatever object the seam
        wraps — the communicator here, the serve worker at the serving
        seam (:mod:`raft_tpu_torch.serve.resilience` reuses this loop)."""
        self.calls.append((verb, key))
        for i, fault in enumerate(self._faults):
            if not fault.matches(verb, key):
                continue
            self._match_counts[i] += 1
            n = self._match_counts[i]
            try:
                applied = fault.apply(target, verb, key, n)
            except Exception:
                self.injected.append(Injection(verb, n, fault))
                tracing.counter_inc("comms.fault_injected")
                raise
            if applied:
                # counter already incremented by the fault itself
                # (pre-sleep); only the log entry lands here
                self.injected.append(Injection(verb, n, fault))
            break  # first matching fault owns this call

    def activate(self) -> None:
        assert self._orig_execute is None, "injector already active"
        self._orig_execute = self._comms._execute
        orig = self._orig_execute

        def patched(key, fn, *args, **kwargs):
            self._fire(self._comms, key[0], key)
            return orig(key, fn, *args, **kwargs)

        self._comms._execute = patched

    def deactivate(self) -> None:
        if self._orig_execute is not None:
            self._comms._execute = self._orig_execute
            self._orig_execute = None


@contextlib.contextmanager
def inject(comms, *faults_: Fault) -> Iterator[FaultInjector]:
    """Scoped fault injection on ``comms``: patch its execute seam for
    the duration of the block, restore it after (even on error — but an
    :class:`Abort`'s latch, like the real thing, persists)."""
    injector = FaultInjector(comms, list(faults_))
    injector.activate()
    try:
        yield injector
    finally:
        injector.deactivate()
