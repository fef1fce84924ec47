"""Fleet wire protocol: JSON over HTTP, typed errors end-to-end.

Port of ``raft_tpu/fleet/protocol.py`` (host-side only), with the
port's :mod:`raft_tpu_torch.core.error` classes.  Design rules:

- **JSON only.**  Every frame is a JSON object, so a
  garbled frame is a *detected* :class:`CommError`, never silent
  deserialization of attacker/corruption-controlled bytes.  Vectors
  travel as nested float lists — float32 → JSON → float32 round-trips
  exactly (every float32 is representable as a double), which is what
  lets the crash-rejoin tests assert byte-identical results across
  the wire.
- **Typed errors round-trip.**  A worker-side
  :class:`ServiceOverloadError` (with its ``retry_after_s`` hint)
  arrives at the router as the same class with the same hint — the
  backpressure contract of the serving layer is preserved end-to-end
  rather than flattened into a status code.
- **Transport faults are typed.**  Connection refused / reset / short
  reads map to :class:`CommError`; a socket timeout maps to
  :class:`CommTimeoutError`.  Both are retryable at the router (same
  taxonomy the comms retry policy uses in-process).

Placement is rendezvous (highest-random-weight) hashing: stable under
membership churn — a worker leaving moves only its own keys, and a
rejoining worker (same worker id, new generation) gets exactly its
old keys back, which is what lets a crash-restored WAL line up with
the traffic the router sends after rejoin.
"""

from __future__ import annotations

import hashlib
import json
import urllib.error
import urllib.request
from typing import Dict, List, Optional, Sequence, Tuple

from raft_tpu_torch.core.error import (CommError, CommTimeoutError, LogicError,
                                 RaftError, ServiceOverloadError,
                                 ServiceUnavailableError)

__all__ = [
    "encode_error", "decode_error", "error_response", "http_transport",
    "post_json", "get_json", "get_text", "rendezvous", "rendezvous_rank",
    "merge_topk", "trace_frame", "parse_trace", "TRACE_HEADER",
]

# status codes the router treats as "the body is a typed raft error"
ERROR_STATUSES = (409, 429, 500, 503, 504)

# HTTP header mirroring the in-body trace context (body is the
# authoritative carrier — the header exists so generic proxies/tcpdump
# sessions can follow a fleet request without parsing JSON bodies)
TRACE_HEADER = "X-Raft-Fleet-Trace"


# ---------------------------------------------------------------------- #
# propagated trace context
# ---------------------------------------------------------------------- #
def trace_frame(fleet_id: str, parent: str,
                sent_at: float) -> dict:
    """The propagated fleet trace context: the fleet-wide request id,
    the span that dispatched this hop (``parent``), and the sender's
    monotonic clock at send time (``sent_at`` — the receiver reports
    its own clocks; alignment happens router-side from the heartbeat
    clock-offset estimate, :mod:`raft_tpu_torch.fleet.tracing`)."""
    return {"id": str(fleet_id), "parent": str(parent),
            "sent_at": round(float(sent_at), 6)}


def parse_trace(obj) -> Optional[dict]:
    """Validate a wire-carried trace context.  Accepts the structured
    frame (dict with ``id``) or a legacy opaque id string; anything
    else — including a garbled frame — degrades to None (tracing is
    best-effort; a bad context must never fail the request)."""
    if isinstance(obj, str) and obj:
        return {"id": obj}
    if isinstance(obj, dict) and obj.get("id") is not None:
        out = {"id": str(obj["id"])}
        if obj.get("parent") is not None:
            out["parent"] = str(obj["parent"])
        try:
            if obj.get("sent_at") is not None:
                out["sent_at"] = float(obj["sent_at"])
        except (TypeError, ValueError):
            pass
        return out
    return None


# ---------------------------------------------------------------------- #
# typed-error round-tripping
# ---------------------------------------------------------------------- #
def encode_error(exc: BaseException) -> dict:
    """Wire form of an exception: enough fields to reconstruct the
    typed class (with its backoff hints) on the other side."""
    d = {"error": type(exc).__name__, "message": str(exc)}
    for attr in ("retry_after_s", "queue_depth", "queue_cap", "tenant",
                 "service", "reason"):
        v = getattr(exc, attr, None)
        if v is not None:
            d[attr] = v
    return d


def decode_error(payload: dict, *,
                 default_service: str = "fleet") -> RaftError:
    """Inverse of :func:`encode_error`: rebuild the typed exception.
    Unknown kinds degrade to bare :class:`RaftError` (still typed at
    the taxonomy root, never a silent string)."""
    kind = str(payload.get("error", "RaftError"))
    msg = str(payload.get("message", "remote error"))
    retry = float(payload.get("retry_after_s", 0.0) or 0.0)
    if kind == "ServiceOverloadError":
        return ServiceOverloadError(
            msg, int(payload.get("queue_depth", 0) or 0),
            int(payload.get("queue_cap", 0) or 0),
            tenant=payload.get("tenant"), retry_after_s=retry)
    if kind == "ServiceUnavailableError":
        return ServiceUnavailableError(
            msg, str(payload.get("service") or default_service),
            str(payload.get("reason", "unknown")), retry_after_s=retry)
    if kind == "CommTimeoutError":
        return CommTimeoutError(msg)
    if kind in ("CommError", "CommAbortedError"):
        return CommError(msg)
    if kind in ("LogicError", "TypeError", "ValueError", "IndexError",
                "KeyError"):
        # deterministic caller bugs: never retried on either side
        return LogicError(msg)
    return RaftError(msg)


def error_status(exc: BaseException) -> int:
    """HTTP status a worker replies with for a typed error (the router
    keys retry behavior off the decoded class, not the code — the code
    is for generic scrapers/curl)."""
    if isinstance(exc, ServiceOverloadError):
        return 429
    if isinstance(exc, ServiceUnavailableError):
        return 503
    if isinstance(exc, CommTimeoutError):
        return 504
    if isinstance(exc, LogicError) or isinstance(
            exc, (TypeError, ValueError, IndexError, KeyError)):
        return 409
    return 500


def error_response(exc: BaseException) -> Tuple[int, dict]:
    return error_status(exc), encode_error(exc)


# ---------------------------------------------------------------------- #
# transport
# ---------------------------------------------------------------------- #
def http_transport(method: str, url: str, body: Optional[bytes],
                   timeout: float,
                   headers: Optional[dict] = None) -> Tuple[int, bytes]:
    """One HTTP exchange → ``(status, body_bytes)``.  Transport-layer
    failures raise typed comm errors (module doc); HTTP error statuses
    are RETURNED (the caller decodes the typed body), not raised.
    This is the seam the chaos harness wraps to inject dropped and
    garbled frames.  ``headers`` adds extra request headers (the trace
    context mirror, :data:`TRACE_HEADER`)."""
    req = urllib.request.Request(url, data=body, method=method)
    if body is not None:
        req.add_header("Content-Type", "application/json")
    for k, v in (headers or {}).items():
        req.add_header(k, v)
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return int(resp.status), resp.read()
    except urllib.error.HTTPError as e:
        try:
            data = e.read()
        except Exception:
            data = b""
        return int(e.code), data
    except TimeoutError as e:
        raise CommTimeoutError("fleet transport timeout: %s %s (%s)"
                               % (method, url, e)) from e
    except (urllib.error.URLError, ConnectionError, OSError) as e:
        reason = getattr(e, "reason", e)
        if isinstance(reason, TimeoutError) or "timed out" in str(e):
            raise CommTimeoutError("fleet transport timeout: %s %s (%s)"
                                   % (method, url, e)) from e
        raise CommError("fleet transport failure: %s %s (%s)"
                        % (method, url, e)) from e


def _decode_body(status: int, data: bytes, url: str) -> dict:
    try:
        payload = json.loads(data.decode("utf-8"))
    except (UnicodeDecodeError, ValueError) as e:
        # a garbled frame is a typed, retryable comm fault — never a
        # silent parse of corrupted bytes
        raise CommError("fleet frame garbled from %s (status %d): %s"
                        % (url, status, e)) from e
    if not isinstance(payload, dict):
        raise CommError("fleet frame from %s is not an object" % url)
    if status >= 400:
        raise decode_error(payload)
    return payload


def post_json(url: str, payload: dict, *, timeout: float,
              transport=http_transport,
              trace: Optional[dict] = None) -> dict:
    """POST a JSON frame.  ``trace`` mirrors the in-body trace context
    into :data:`TRACE_HEADER`; transports that predate the header
    parameter (injected test doubles) are still accepted — the body
    remains the authoritative carrier."""
    body = json.dumps(payload).encode("utf-8")
    if trace is not None:
        headers = {TRACE_HEADER: json.dumps(trace, sort_keys=True)}
        try:
            status, data = transport("POST", url, body, timeout,
                                     headers)
        except TypeError:
            status, data = transport("POST", url, body, timeout)
    else:
        status, data = transport("POST", url, body, timeout)
    return _decode_body(status, data, url)


def get_json(url: str, *, timeout: float,
             transport=http_transport) -> dict:
    status, data = transport("GET", url, None, timeout)
    return _decode_body(status, data, url)


def get_text(url: str, *, timeout: float,
             transport=http_transport) -> str:
    status, data = transport("GET", url, None, timeout)
    if status >= 400:
        raise CommError("fleet GET %s failed with status %d"
                        % (url, status))
    return data.decode("utf-8", errors="replace")


# ---------------------------------------------------------------------- #
# placement
# ---------------------------------------------------------------------- #
def _hrw_weight(key: str, node: str) -> int:
    h = hashlib.blake2b(("%s|%s" % (key, node)).encode("utf-8"),
                        digest_size=8)
    return int.from_bytes(h.digest(), "big")


def rendezvous_rank(key: str, nodes: Sequence[str]) -> List[str]:
    """All ``nodes`` ordered by highest-random-weight for ``key`` —
    index 0 is the owner, index 1 the first hedge/failover target.
    Deterministic across processes (blake2b, no PYTHONHASHSEED
    dependence)."""
    return sorted(nodes, key=lambda n: _hrw_weight(key, n),
                  reverse=True)


def rendezvous(key: str, nodes: Sequence[str]) -> str:
    if not nodes:
        raise ServiceUnavailableError(
            "fleet has no live workers for placement", "fleet",
            "no_workers")
    return rendezvous_rank(key, nodes)[0]


# ---------------------------------------------------------------------- #
# router-side top-k merge
# ---------------------------------------------------------------------- #
def merge_topk(parts: Sequence[Tuple[Sequence[Sequence[float]],
                                     Sequence[Sequence[int]]]],
               k: int) -> Tuple[List[List[float]], List[List[int]]]:
    """Merge per-shard top-k results into fleet top-k: for each query,
    pool every shard's candidates, drop ``-1`` pad slots, sort by
    ``(distance, id)`` (the id tiebreak makes the merge deterministic
    under equal distances), keep ``k``, pad short results back to
    ``k`` with ``(inf, -1)``.  Shard-local ids must already be
    translated to global ids by the worker (the worker owns the
    translation table; the router stays data-blind)."""
    if not parts:
        raise LogicError("merge_topk: no shard results to merge")
    n_queries = len(parts[0][0])
    for dists, ids in parts:
        if len(dists) != n_queries or len(ids) != n_queries:
            raise LogicError(
                "merge_topk: ragged shard results (%d vs %d queries)"
                % (len(dists), n_queries))
    out_d: List[List[float]] = []
    out_i: List[List[int]] = []
    inf = float("inf")
    for q in range(n_queries):
        pool = []
        for dists, ids in parts:
            for d, i in zip(dists[q], ids[q]):
                if int(i) >= 0:
                    pool.append((float(d), int(i)))
        pool.sort()
        pool = pool[:k]
        pad = k - len(pool)
        out_d.append([d for d, _ in pool] + [inf] * pad)
        out_i.append([i for _, i in pool] + [-1] * pad)
    return out_d, out_i
