"""Error types and assertion helpers.

A copy of ``raft_tpu/core/error.py`` with the same exception names, kept
here because the port imports nothing of the JAX package.  Analog of the
reference's exception machinery (cpp/include/raft/error.hpp):
``raft::exception`` collects a stack trace at construction
(error.hpp:28-92) and the ``RAFT_EXPECTS`` / ``RAFT_FAIL`` macros
(error.hpp:132,148) raise it with a formatted message.
"""

from __future__ import annotations

import traceback


class RaftError(RuntimeError):
    """Exception with a captured construction-site stack trace.

    Mirrors ``raft::exception`` (reference error.hpp:28): the message is
    augmented with the stack collected where the error was *created*, which
    matters when the raise happens later (e.g. out of an async callback).
    """

    def __init__(self, message: str, collect_stack: bool = True):
        self.raw_message = message
        if collect_stack:
            stack = "".join(traceback.format_stack()[:-1])
            message = f"{message}\nObtained stack trace:\n{stack}"
        super().__init__(message)


class LogicError(RaftError):
    """Invariant violation (analog of raft::logic_error, error.hpp:94)."""


class AllocationError(RaftError):
    """A buffer allocation failed (the analog of the reference's
    ``rmm::bad_alloc`` surfacing through ``RAFT_TRY``).  Carries the
    context an OOM post-mortem needs: how much was asked for and how
    much this library already holds live.

    Attributes
    ----------
    requested_bytes:
        Size of the allocation that failed.
    live_bytes:
        library-accounted live buffer bytes at failure time.
    """

    def __init__(self, message: str, requested_bytes: int, live_bytes: int):
        self.requested_bytes = int(requested_bytes)
        self.live_bytes = int(live_bytes)
        super().__init__(
            "%s (requested %d bytes; %d library buffer bytes live)"
            % (message, self.requested_bytes, self.live_bytes))


class ServiceOverloadError(RaftError):
    """Admission control rejected a request: the serving queue (or the
    shedding tenant's share of it) is at its configured depth cap
    (the serving layer — the analog of a load-balancer shedding
    rather than queueing unboundedly; see docs/SERVING.md).  Callers
    should back off ``retry_after_s`` and resubmit, or raise capacity
    (``serve_queue_cap``).

    Matches the :class:`ServiceUnavailableError` taxonomy — both carry
    ``retry_after_s`` so callers back off uniformly whether the service
    is *full* (this error) or *broken/healing* (that one).

    Attributes
    ----------
    queue_depth:
        Requests queued at rejection time (the shedding tenant's depth
        when a per-tenant cap shed).
    queue_cap:
        The cap that shed (the tenant's share when tenancy is active).
    tenant:
        Name of the tenant whose quota shed the request, or None for a
        shed with no tenant dimension (e.g. a full ANN delta segment).
    retry_after_s:
        Hint: estimated seconds until the queue drains enough to admit
        again (0.0 when unknown).
    """

    def __init__(self, message: str, queue_depth: int, queue_cap: int,
                 tenant: "str | None" = None,
                 retry_after_s: float = 0.0):
        self.queue_depth = int(queue_depth)
        self.queue_cap = int(queue_cap)
        self.tenant = None if tenant is None else str(tenant)
        self.retry_after_s = float(retry_after_s)
        super().__init__(
            "%s (queue depth %d at cap %d%s retry_after_s=%.3f)"
            % (message, self.queue_depth, self.queue_cap,
               "" if self.tenant is None else " tenant=%s" % self.tenant,
               self.retry_after_s))


class ServiceUnavailableError(RaftError):
    """The service cannot accept requests *at all* right now — its
    circuit breaker is open (too many consecutive/windowed batch
    failures), its worker thread has died, or a recovery is in progress
    (the serving layer's resilience module).  Distinct from
    :class:`ServiceOverloadError`: overload means "healthy but full —
    back off briefly"; unavailable means "broken or healing — shed now
    and retry after ``retry_after_s``" (queueing into a broken worker
    would only convert the outage into client timeouts).

    Attributes
    ----------
    service:
        Name of the service that shed the request.
    reason:
        Short machine-readable cause (``"breaker_open"``,
        ``"worker_dead"``, ``"recovering"``).
    retry_after_s:
        Hint: seconds until the service may admit again (0.0 when
        unknown — e.g. a dead worker awaiting an explicit
        ``restart()``/recovery).
    """

    def __init__(self, message: str, service: str, reason: str,
                 retry_after_s: float = 0.0):
        self.service = str(service)
        self.reason = str(reason)
        self.retry_after_s = float(retry_after_s)
        super().__init__(
            "%s (service=%s reason=%s retry_after_s=%.3f)"
            % (message, self.service, self.reason, self.retry_after_s))


class DataCorruptionError(RaftError):
    """Persisted serving state failed an integrity check
    (the persistence layer): a snapshot manifest, array payload, or
    interior write-ahead-log record whose stored checksum does not
    match its bytes (docs/PERSISTENCE.md).  Never retried and never
    tolerated silently — a corrupt region must fail loudly rather than
    serve wrong distances.  (A *torn trailing* WAL record — an append
    cut short by the crash itself — is the one tolerated case and does
    not raise; see the WAL replay contract.)

    Attributes
    ----------
    path:
        File holding the corrupt region.
    offset:
        Byte offset of the failing region within ``path`` (None when
        the whole file is the unit, e.g. a manifest).
    expected_crc / actual_crc:
        The stored checksum vs the checksum of the bytes actually read
        (None when the failure precedes checksumming, e.g. a bad
        record magic or unparseable manifest).
    """

    def __init__(self, message: str, path: str,
                 offset: "int | None" = None,
                 expected_crc: "int | None" = None,
                 actual_crc: "int | None" = None):
        self.path = str(path)
        self.offset = None if offset is None else int(offset)
        self.expected_crc = (None if expected_crc is None
                             else int(expected_crc))
        self.actual_crc = None if actual_crc is None else int(actual_crc)
        where = self.path if self.offset is None else (
            "%s @ byte %d" % (self.path, self.offset))
        crcs = ("" if self.expected_crc is None
                else " expected_crc=0x%08x actual_crc=0x%08x"
                % (self.expected_crc,
                   0 if self.actual_crc is None else self.actual_crc))
        super().__init__("%s (%s%s)" % (message, where, crcs))


class CommError(RaftError):
    """Communicator failure (analog of the reference's NCCL/UCX error
    surfacing: ``RAFT_NCCL_TRY`` / the ERROR arm of ``status_t``,
    comms.hpp:41).  Transient instances are retryable by
    the comms retry policy; a communicator that
    exhausts its retries latches aborted."""


class CommAbortedError(CommError):
    """The communicator is latched aborted (the ``ncclCommAbort``
    contract, std_comms.hpp:443-475: once any participant observes a
    failure the communicator is permanently unusable).  Every subsequent
    verb fails fast with this error; recovery requires rebuilding the
    communicator (``Comms.recover``)."""


class CommTimeoutError(CommError):
    """A communicator verb (or the multi-host bootstrap) exceeded its
    watchdog deadline (the analog of the reference's UCX progress-loop
    timeout abort, std_comms.hpp:234-298)."""


# Deterministic caller bugs: invariant violations (RAFT_EXPECTS) plus the
# Python-level errors raised for bad shapes/indices/dtypes.
CALLER_BUG_ERRORS = (LogicError, TypeError, ValueError, IndexError, KeyError)


def expects(cond: bool, fmt: str, *args) -> None:
    """Raise :class:`LogicError` unless ``cond`` holds.

    Analog of ``RAFT_EXPECTS(cond, fmt, ...)`` (reference error.hpp:132).
    ``fmt`` is %-formatted with ``args`` to match the macro's printf style.
    """
    if not cond:
        raise LogicError(fmt % args if args else fmt)


def fail(fmt: str, *args) -> None:
    """Unconditionally raise :class:`LogicError`.

    Analog of ``RAFT_FAIL(fmt, ...)`` (reference error.hpp:148).
    """
    raise LogicError(fmt % args if args else fmt)
