"""One owner for the runtime knobs that this package reads.

Port of ``raft_tpu/config.py``, cut to the knobs that the ported modules
read, under the same knob names and the same ``RAFT_TPU_*`` environment
variables.  Resolution order (first hit wins):

1. an explicit function argument at the call site (never reaches here);
2. an active :func:`override` context, innermost first;
3. a value set by :func:`configure`;
4. the knob's environment variable;
5. the built-in default.

Every knob here is read at construction time (a service, a recorder),
so a change affects the next construction.  The JAX
package's tuning-table layer and the impl-choice and block-shape knobs
that it serves (``core/tuning.py``) are not ported yet (queue 1 item 7b
of ``ROADMAP.md``): :func:`describe` attributes each knob to one of the
four rungs above, never to a tuning table.  Free-form numeric
and list knobs read through the typed helpers (:func:`get_int`,
:func:`get_float`, :func:`get_int_list`, :func:`get_float_list`), so
that a malformed value fails as a :class:`LogicError` naming the knob
and its environment variable.

Knobs
-----
serve_bucket_rungs / serve_max_wait_ms / serve_queue_cap
    The serving layer's shape ladder (``"pow2"`` or a comma list), its
    micro-batch window and its admission cap
    (:mod:`raft_tpu_torch.serve.service`).
serve_breaker_threshold / serve_breaker_window /
serve_breaker_window_failures / serve_breaker_cooldown_ms
    The default circuit breaker of every service (both trip conditions
    0 = no breaker).
serve_tenant_weights
    ``"name:weight,..."`` weighted-fair tenants (empty = one queue).
serve_ann_nprobe / serve_ann_nprobe_ladder / serve_ann_delta_cap /
serve_ann_compact_rows / serve_ann_degrade_frac
    :class:`~raft_tpu_torch.serve.ANNService`: the served probe count
    (0 = the index's own), the ladder of probe counts that warmup and
    calibrate walk, the delta segment's capacity, the auto-compaction
    threshold (0 = manual only) and the queue fraction past which
    batches are served one ladder step lower (0 = never).
serve_ann_device_budget_bytes
    The device bytes an out-of-core ``ANNService`` (``ooc=True``) may hold
    for slot vectors: its frequency-promoted hot set and the
    double-buffered tile pool.  ``0`` (the default) sets no budget, and an
    ``ooc=True`` service must then pass ``device_budget_bytes=``.
persist_fsync / persist_snapshot_interval_s / persist_scrub_chunks
    Durable ANN serving (:mod:`raft_tpu_torch.persist`): the write-ahead
    log's fsync policy (``always`` before every acknowledge, ``batch`` at
    the next maintenance tick, ``off``), the least seconds between
    interval snapshots of a dirty state, and the snapshot chunks
    re-checksummed a maintenance tick (0 = no scrub).
serve_slo_target_ms / serve_slo_objective / serve_slo_windows_s
    The per-service SLO tracker (:mod:`raft_tpu_torch.core.flight`).
flight_events
    The flight recorder's ring size in events.
mnmg_merge
    The cross-shard top-k merge of the sharded searches
    (:func:`raft_tpu_torch.spatial.mnmg_knn.mnmg_knn`,
    ``mnmg_ivf_flat_search`` and the sharded services): ``allgather`` |
    ``ring`` | ``hierarchical``.
serve_hedge_ms / serve_hedge_factor / serve_hedge_min_ms
    Hedged dispatch of a replicated ``KNNService(replicas=...)``: a fixed
    threshold in milliseconds (``0`` = adaptive: ``serve_hedge_factor`` x
    the fastest in-rotation replica's p99 at the batch's rung, floored at
    ``serve_hedge_min_ms``).
ops_healthz_ttl_s
    TTL of the ops plane's cached full ``health_check()`` verdict
    (``/healthz?full=1``, :class:`raft_tpu_torch.serve.opsplane.OpsPlane`):
    scrapes within the window share one battery run.
ops_sentinel_interval_s / ops_sentinel_latency_factor /
ops_sentinel_min_samples / ops_sentinel_queue_frac / ops_sentinel_burn /
ops_sentinel_wal_records / ops_sentinel_stall_frac /
ops_sentinel_rejoin_ms_per_record / ops_sentinel_rejoin_hold_s
    The anomaly sentinel (:mod:`raft_tpu_torch.serve.sentinel`): the least
    seconds between evaluations, the ``exec_latency`` breach multiplier
    over the rolling baseline, the batches (and per-tenant SLO outcomes)
    before a baseline rule judges, the ``queue_depth`` fraction of the
    admission cap, the ``slo_burn`` threshold, the ``wal_depth`` record
    threshold, the ``tile_stall`` fraction of H2D time, the
    ``rejoin_lag`` milliseconds per replayed WAL record, and how long
    after a rejoin that rule judges it.
fleet_lease_interval_s / fleet_lease_misses
    The fleet's heartbeat period and the missed beats before the router
    evicts a worker (:mod:`raft_tpu_torch.fleet.router`).
fleet_retry_max / fleet_retry_backoff_s
    The router's dispatch retry budget and its initial backoff (doubling;
    a worker's ``retry_after_s`` hint overrides it upward).
fleet_hedge_ms
    Replicated mode: a primary silent this long gets a hedged
    re-dispatch to the next worker in rendezvous order (``0`` = none).
fleet_timeout_s / fleet_inflight_cap
    The default deadline of a router request, and the router's global
    admission cap (typed ``ServiceOverloadError`` at or above it).
"""

from __future__ import annotations

import os
import threading
from contextlib import contextmanager
from typing import Dict, Iterator, Optional, Tuple

__all__ = ["configure", "override", "get", "describe", "knob_default", "get_int",
           "get_float", "get_int_list", "get_float_list"]

# knob -> (env alias, default)
_KNOBS: Dict[str, Tuple[str, Optional[str]]] = {
    "serve_bucket_rungs": ("RAFT_TPU_SERVE_BUCKET_RUNGS", "pow2"),
    "serve_max_wait_ms": ("RAFT_TPU_SERVE_MAX_WAIT_MS", "2"),
    "serve_queue_cap": ("RAFT_TPU_SERVE_QUEUE_CAP", "1024"),
    "serve_breaker_threshold": ("RAFT_TPU_SERVE_BREAKER_THRESHOLD", "5"),
    "serve_breaker_window": ("RAFT_TPU_SERVE_BREAKER_WINDOW", "16"),
    "serve_breaker_window_failures": (
        "RAFT_TPU_SERVE_BREAKER_WINDOW_FAILURES", "8"),
    "serve_breaker_cooldown_ms": ("RAFT_TPU_SERVE_BREAKER_COOLDOWN_MS", "250"),
    "serve_tenant_weights": ("RAFT_TPU_SERVE_TENANT_WEIGHTS", ""),
    "serve_ann_nprobe": ("RAFT_TPU_SERVE_ANN_NPROBE", "0"),
    "serve_ann_nprobe_ladder": ("RAFT_TPU_SERVE_ANN_NPROBE_LADDER", "4,8,16,32,64"),
    "serve_ann_delta_cap": ("RAFT_TPU_SERVE_ANN_DELTA_CAP", "4096"),
    "serve_ann_compact_rows": ("RAFT_TPU_SERVE_ANN_COMPACT_ROWS", "2048"),
    "serve_ann_degrade_frac": ("RAFT_TPU_SERVE_ANN_DEGRADE_FRAC", "0.75"),
    "serve_ann_device_budget_bytes": ("RAFT_TPU_SERVE_ANN_DEVICE_BUDGET_BYTES", "0"),
    "flight_events": ("RAFT_TPU_FLIGHT_EVENTS", "4096"),
    "mnmg_merge": ("RAFT_TPU_MNMG_MERGE", "allgather"),
    "serve_hedge_ms": ("RAFT_TPU_SERVE_HEDGE_MS", "0"),
    "serve_hedge_factor": ("RAFT_TPU_SERVE_HEDGE_FACTOR", "1.5"),
    "serve_hedge_min_ms": ("RAFT_TPU_SERVE_HEDGE_MIN_MS", "10"),
    "persist_fsync": ("RAFT_TPU_PERSIST_FSYNC", "always"),
    "persist_snapshot_interval_s": ("RAFT_TPU_PERSIST_SNAPSHOT_INTERVAL_S", "30"),
    "persist_scrub_chunks": ("RAFT_TPU_PERSIST_SCRUB_CHUNKS", "4"),
    "serve_slo_target_ms": ("RAFT_TPU_SERVE_SLO_TARGET_MS", "100"),
    "serve_slo_objective": ("RAFT_TPU_SERVE_SLO_OBJECTIVE", "0.99"),
    "serve_slo_windows_s": ("RAFT_TPU_SERVE_SLO_WINDOWS_S", "60,300"),
    "ops_healthz_ttl_s": ("RAFT_TPU_OPS_HEALTHZ_TTL_S", "15"),
    "ops_sentinel_interval_s": ("RAFT_TPU_OPS_SENTINEL_INTERVAL_S", "1"),
    "ops_sentinel_latency_factor": ("RAFT_TPU_OPS_SENTINEL_LATENCY_FACTOR", "3"),
    "ops_sentinel_min_samples": ("RAFT_TPU_OPS_SENTINEL_MIN_SAMPLES", "20"),
    "ops_sentinel_queue_frac": ("RAFT_TPU_OPS_SENTINEL_QUEUE_FRAC", "0.8"),
    "ops_sentinel_burn": ("RAFT_TPU_OPS_SENTINEL_BURN", "2"),
    "ops_sentinel_wal_records": ("RAFT_TPU_OPS_SENTINEL_WAL_RECORDS", "100000"),
    "ops_sentinel_stall_frac": ("RAFT_TPU_OPS_SENTINEL_STALL_FRAC", "0.5"),
    "ops_sentinel_rejoin_ms_per_record": ("RAFT_TPU_OPS_SENTINEL_REJOIN_MS_PER_RECORD", "50"),
    "ops_sentinel_rejoin_hold_s": ("RAFT_TPU_OPS_SENTINEL_REJOIN_HOLD_S", "10"),
    "fleet_lease_interval_s": ("RAFT_TPU_FLEET_LEASE_INTERVAL_S", "0.5"),
    "fleet_lease_misses": ("RAFT_TPU_FLEET_LEASE_MISSES", "3"),
    "fleet_retry_max": ("RAFT_TPU_FLEET_RETRY_MAX", "3"),
    "fleet_retry_backoff_s": ("RAFT_TPU_FLEET_RETRY_BACKOFF_S", "0.05"),
    "fleet_hedge_ms": ("RAFT_TPU_FLEET_HEDGE_MS", "100"),
    "fleet_timeout_s": ("RAFT_TPU_FLEET_TIMEOUT_S", "10"),
    "fleet_inflight_cap": ("RAFT_TPU_FLEET_INFLIGHT_CAP", "256"),
}

# sentinel for "no layer claimed this knob" during resolution — distinct
# from None, which an override frame may hold to mean "revert to
# env/default inside this scope"
_UNSET = object()

_values: Dict[str, Optional[str]] = {}
_tls = threading.local()


def _frames():
    return getattr(_tls, "frames", ())


def _check(name: str) -> None:
    if name not in _KNOBS:
        raise ValueError(
            f"raft_tpu_torch.config: unknown knob {name!r} "
            f"(have: {', '.join(sorted(_KNOBS))})")


def _attribute(name: str) -> Tuple[Optional[str], str]:
    """``(value, rung)`` of a knob, walking the module-doc order: the
    innermost override frame, then :func:`configure`, the environment and
    the default.  A literal None in a frame is the scoped revert to
    env/default (it skips :func:`configure` too).  The one copy of the
    walk: :func:`get` and :func:`describe` share it."""
    env, default = _KNOBS[name]
    val = _UNSET
    for frame in reversed(_frames()):
        if name in frame:
            val = frame[name]
            break
    if val is _UNSET and name in _values:
        return _values[name], "configure"
    if val is not _UNSET and val is not None:
        return val, "override"
    ev = os.environ.get(env)
    if ev is not None:
        return ev, "env"
    return default, "default"


def get(name: str) -> Optional[str]:
    """Resolve a knob (module-doc order); the raw string."""
    _check(name)
    return _attribute(name)[0]


def describe(layers: bool = False) -> Dict:
    """The effective value of every knob; ``layers=True`` also names the
    rung that answered: ``{knob: {"value": ..., "layer": "override" |
    "configure" | "env" | "default"}}`` (no ``"table"`` rung until the
    tuning table is ported, module doc)."""
    if not layers:
        return {name: _attribute(name)[0] for name in _KNOBS}
    return {name: dict(zip(("value", "layer"), _attribute(name))) for name in _KNOBS}


def knob_default(name: str) -> Optional[str]:
    """The built-in default of ``name`` (the bottom resolution rung)."""
    _check(name)
    return _KNOBS[name][1]


def _parse_error(name: str, raw, kind: str):
    from raft_tpu_torch.core.error import LogicError

    env = _KNOBS[name][0]
    return LogicError(
        f"raft_tpu_torch.config: {name}={raw!r} is not a valid {kind} "
        f"(knob {name}, env var {env})")


def get_int(name: str) -> int:
    """:func:`get` + int parse; malformed → :class:`LogicError`."""
    raw = get(name)
    try:
        return int(raw)
    except (TypeError, ValueError):
        raise _parse_error(name, raw, "integer") from None


def get_float(name: str) -> float:
    """:func:`get` + float parse; malformed → :class:`LogicError`."""
    raw = get(name)
    try:
        return float(raw)
    except (TypeError, ValueError):
        raise _parse_error(name, raw, "number") from None


def _split_list(raw) -> Tuple[str, ...]:
    return tuple(tok.strip() for tok in str(raw).split(",") if tok.strip())


def get_int_list(name: str) -> Tuple[int, ...]:
    """:func:`get` + comma-separated int-list parse; malformed →
    :class:`LogicError` naming the knob and env var."""
    raw = get(name)
    try:
        return tuple(int(tok) for tok in _split_list(raw))
    except (TypeError, ValueError):
        raise _parse_error(name, raw, "comma-separated integer list") from None


def get_float_list(name: str) -> Tuple[float, ...]:
    """:func:`get` + comma-separated float-list parse; malformed →
    :class:`LogicError` naming the knob and env var."""
    raw = get(name)
    try:
        return tuple(float(tok) for tok in _split_list(raw))
    except (TypeError, ValueError):
        raise _parse_error(name, raw, "comma-separated number list") from None


def configure(**knobs: Optional[str]) -> None:
    """Set knob values process-wide (None = revert to env/default)."""
    for name, value in knobs.items():
        _check(name)
        if value is None:
            _values.pop(name, None)
        else:
            _values[name] = value


@contextmanager
def override(**knobs: Optional[str]) -> Iterator[None]:
    """Scoped knob values (thread-local; nestable, innermost wins).

    ``override(knob=None)`` reverts the knob to its env/default inside
    the scope — the scoped spelling of ``configure(knob=None)``."""
    for name in knobs:
        _check(name)
    frames = list(_frames())
    frames.append(dict(knobs))
    _tls.frames = tuple(frames)
    try:
        yield
    finally:
        _tls.frames = tuple(frames[:-1])

