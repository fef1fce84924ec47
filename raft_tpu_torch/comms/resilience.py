"""Retry/backoff/timeout policy around a fallible call.

A copy of ``RetryPolicy`` from ``raft_tpu/comms/resilience.py`` with its
imports re-pointed at this package: a deterministic exponential-backoff
schedule, an optional per-attempt watchdog deadline, and an exception
taxonomy that distinguishes transient failures (retry), invariant
violations (propagate — retrying a shape error cannot help), and aborts
(latch).  In the port it wraps every eager verb of a
:class:`~raft_tpu_torch.comms.host_comms.HostComms`
(``retry_policy=``) and the serving worker's device call
(``Service(retry_policy=...)``), and the multi-process bootstrap
(``Comms(bootstrap_retry_policy=...)``, :mod:`raft_tpu_torch.comms.dist`),
as in the JAX package.

Every retry/timeout is reported through
:func:`raft_tpu_torch.core.tracing.event` (span + monotonic counter)
under the JAX package's names, ``comms.retry`` / ``comms.timeout``.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, List, Optional

from raft_tpu_torch.core import tracing
from raft_tpu_torch.core.error import (
    CALLER_BUG_ERRORS,
    CommAbortedError,
    CommTimeoutError,
)

# Exceptions a retry can never fix: deterministic caller bugs (the shared
# CALLER_BUG_ERRORS taxonomy — RAFT_EXPECTS violations plus the
# Python-level errors raised for bad shapes/indices/dtypes) and latched
# aborts (the ncclCommAbort contract: the communicator is permanently
# dead).  Device and runtime failures (RuntimeErrors) stay retryable.
NON_RETRYABLE = CALLER_BUG_ERRORS + (CommAbortedError,)


class RetryPolicy:
    """Deterministic exponential backoff with optional watchdog timeout.

    Parameters
    ----------
    max_retries:
        Retries *after* the first attempt (``max_retries=3`` means up to
        4 attempts total).
    base_delay / multiplier / max_delay:
        Backoff schedule: attempt i (0-based retry index) sleeps
        ``min(base_delay * multiplier**i, max_delay)`` seconds.  The
        schedule is a pure function of the policy — no jitter — so fault
        tests replay identically.
    timeout:
        Optional per-attempt deadline in seconds.  Enforced by a watchdog:
        the attempt runs on a worker thread and the calling thread waits
        up to ``timeout``; on expiry a :class:`CommTimeoutError` is
        raised.  The worker thread cannot be cancelled (same limitation as
        ``ncclCommAbort``, which leaks the in-flight kernel) — it is a
        daemon thread and its eventual result is discarded.  Beware the
        consequence under ``retry_timeouts=True``: the abandoned attempt
        is still *executing* while the retry re-runs the same verb, so
        the two overlap on the same communicator.  Harmless for the
        bootstrap connect and for CPU-simulated tests; on real hardware,
        overlapping collectives on one mesh can deadlock or reorder, so
        production verb policies should prefer ``retry_timeouts=False``
        (timeout == fabric gone == abort, the NCCL stance).
    retry_timeouts:
        Whether a watchdog expiry counts as transient (default True —
        bootstrap connects genuinely succeed on retry; set False for the
        NCCL-style "timeout means the fabric is gone" stance — see the
        overlap caveat under ``timeout``).
    sleep:
        Injection point for the backoff sleep (tests pass a recorder).
    """

    def __init__(self,
                 max_retries: int = 3,
                 base_delay: float = 0.05,
                 multiplier: float = 2.0,
                 max_delay: float = 2.0,
                 timeout: Optional[float] = None,
                 retry_timeouts: bool = True,
                 sleep: Callable[[float], None] = time.sleep):
        self.max_retries = int(max_retries)
        self.base_delay = float(base_delay)
        self.multiplier = float(multiplier)
        self.max_delay = float(max_delay)
        self.timeout = timeout
        self.retry_timeouts = retry_timeouts
        self._sleep = sleep

    def schedule(self) -> List[float]:
        """The full deterministic backoff schedule (one delay per retry)."""
        return [min(self.base_delay * self.multiplier ** i, self.max_delay)
                for i in range(self.max_retries)]

    # ------------------------------------------------------------------ #
    def _attempt(self, fn, args, kwargs):
        """One attempt, bounded by the watchdog deadline if configured."""
        if self.timeout is None:
            return fn(*args, **kwargs)
        box = {}
        done = threading.Event()

        def runner():
            try:
                box["result"] = fn(*args, **kwargs)
            except BaseException as e:  # noqa: BLE001 — relayed below
                box["error"] = e
            finally:
                done.set()

        t = threading.Thread(target=runner, daemon=True,
                             name="raft-tpu-comms-watchdog-worker")
        # handshake with the fault seam (faults.Delay.apply): the
        # runner commits to dispatching and the watchdog abandons under
        # the SAME lock, so a stall whose duration straddles the
        # deadline resolves to exactly one of {bailed, committed} — no
        # check-then-act window where the runner reads a stale flag and
        # dispatches its program late anyway
        t.raft_tpu_abandon_lock = threading.Lock()
        t.start()
        if not done.wait(self.timeout):
            with t.raft_tpu_abandon_lock:
                committed = getattr(t, "raft_tpu_dispatch_committed",
                                    False)
                if not committed:
                    t.raft_tpu_abandoned = True
            if committed:
                # the runner won the boundary race: its program is
                # already dispatching, and overlapping the retry with
                # it is the rendezvous deadlock this machinery exists
                # to suppress — grant one extra deadline for the
                # in-flight dispatch to drain.  If it drains, USE the
                # outcome: discarding a completed collective and
                # re-running it is pure duplicate device work, and on
                # real hardware a rank re-running a collective the
                # other ranks completed once desyncs the mesh.  An
                # attempt that outlives the grace too is abandoned
                # mid-program, the documented residual risk.
                if done.wait(self.timeout):
                    if "error" in box:
                        raise box["error"]
                    return box["result"]
            raise CommTimeoutError(
                "verb exceeded its %.3fs watchdog deadline" % self.timeout)
        if "error" in box:
            raise box["error"]
        return box["result"]

    def call(self, fn, *args, verb: str = "call", **kwargs):
        """Run ``fn`` under this policy: watchdog per attempt, backoff
        between attempts.  Non-retryable exceptions propagate
        immediately; on exhaustion the *last* failure propagates
        (callers wrap/latch as appropriate for their layer)."""
        delays = self.schedule()
        attempts = self.max_retries + 1
        last: Optional[BaseException] = None
        for attempt in range(attempts):
            try:
                return self._attempt(fn, args, kwargs)
            except NON_RETRYABLE:
                raise
            except CommTimeoutError as e:
                tracing.counter_inc("comms.timeout")
                if not self.retry_timeouts:
                    raise
                last = e
            except Exception as e:  # transient: retry
                last = e
            if attempt == attempts - 1:
                break
            with tracing.event("comms.retry",
                               "%s attempt=%d/%d delay=%.3fs: %s",
                               verb, attempt + 1, attempts,
                               delays[attempt], last):
                self._sleep(delays[attempt])
        assert last is not None
        raise last
