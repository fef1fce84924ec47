"""One owner for the runtime knobs that this package reads.

Port of ``raft_tpu/config.py``, cut to the knobs that the ported modules
read, under the same knob names and the same ``RAFT_TPU_*`` environment
variables.  Resolution order (first hit wins):

1. an explicit function argument at the call site (never reaches here);
2. an active :func:`override` context, innermost first;
3. a value set by :func:`configure`;
4. the knob's environment variable;
5. a loaded **tuning table** (shape-class lookups through :func:`tuned`
   only: the winners of the ``tools/torch_autotune.py`` sweep, loaded by
   :func:`load_tuning_table`, :func:`install_tuning_table` or the
   ``RAFT_TPU_TUNING_TABLE`` environment variable: ``auto`` finds the
   checked-in table under ``raft_tpu_torch/tuning/`` whose fingerprint
   is this backend's, a path loads that file, ``0`` or empty loads
   none);
6. the built-in default.

The impl knobs (those with a ``choices`` tuple below) are owned by the
candidate registry (:mod:`raft_tpu_torch.core.tuning`): consumers
resolve them through ``tuning.resolve(knob, ...)``, which calls
:func:`tuned` here, and validation and legality live there.  The port
compiles nothing per shape, so an impl knob is read at each call: a
change takes effect at the next call (the JAX package's trace-time
caveat does not apply).  The other knobs are read at construction time
(a service, a recorder), so a change affects the next construction.
Free-form numeric and list knobs read through the typed helpers
(:func:`get_int`, :func:`get_float`, :func:`get_int_list`,
:func:`get_float_list`), so that a malformed value fails as a
:class:`LogicError` naming the knob and its environment variable.

The table is opt-in: with none loaded, resolution is the five-rung
ladder without it.  A table whose fingerprint is not this backend's
warns once and installs nothing; a corrupt one raises
:class:`LogicError`; a table winner that is illegal for the real cell is
counted ``discarded`` on ``raft_tpu_tuning_table_lookups_total{outcome,
knob}`` (beside ``hit`` and ``miss``) and resolution takes the default.
:func:`suspend_tuning` bypasses the table in its thread only.

Knobs
-----
select_impl
    Per-row top-k of :func:`raft_tpu_torch.spatial.select_k` and every
    selection of the kNN and ANN paths: ``kernel`` (K2) | ``sort`` (a
    stable ``torch.sort``) | ``approx95`` (the TPU's approximate top-k at
    recall target 0.95: an opt-in trade of exactness, never swept); unset
    = K2 where legal, else the sort.
fused_knn_impl
    :func:`raft_tpu_torch.spatial.fused_l2_knn`: ``kernel`` (K1) |
    ``scan`` (the tile scan); unset = K1 on CUDA where legal.
knn_block_n
    K6's index-tile rows (:func:`raft_tpu_torch.ops.knn_tile.fused_knn_twophase`),
    the JAX ladder ``256`` .. ``4096``.
ivf_scan_impl
    The IVF-Flat probe scan (:func:`raft_tpu_torch.spatial.ann.ivf_flat_search`):
    ``kernel`` (K3) | ``kernel_bf16`` | ``scan``; unset = K3 on CUDA
    where legal.
spmv_impl
    CSR SpMV (:func:`raft_tpu_torch.sparse.linalg.csr_spmv`):
    ``segment`` | ``cumsum`` | ``sortscan``.
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

import json
import os
import threading
import warnings
from contextlib import contextmanager
from typing import Dict, Iterator, Optional, Tuple

__all__ = ["configure", "override", "get", "describe", "tuned", "knob_default", "get_int",
           "get_float", "get_int_list", "get_float_list", "load_tuning_table",
           "install_tuning_table", "clear_tuning_table", "suspend_tuning",
           "tuning_table_info", "discover_tuning_table"]

# knob -> (env alias, default, the values configure/override accept);
# choices None = free-form (the consumer validates)
_KNOBS: Dict[str, Tuple[str, Optional[str], Optional[Tuple[str, ...]]]] = {
    "select_impl": ("RAFT_TPU_SELECT_IMPL", None, ("kernel", "sort", "approx95")),
    "fused_knn_impl": ("RAFT_TPU_FUSED_KNN_IMPL", None, ("kernel", "scan")),
    "knn_block_n": ("RAFT_TPU_KNN_BLOCK_N", "1024", ("256", "512", "1024", "2048", "4096")),
    "ivf_scan_impl": ("RAFT_TPU_IVF_SCAN_IMPL", None, ("kernel", "kernel_bf16", "scan")),
    "spmv_impl": ("RAFT_TPU_SPMV_IMPL", "segment", ("segment", "cumsum", "sortscan")),
    "mnmg_merge": ("RAFT_TPU_MNMG_MERGE", "allgather", ("allgather", "ring", "hierarchical")),
    "serve_bucket_rungs": ("RAFT_TPU_SERVE_BUCKET_RUNGS", "pow2", None),
    "serve_max_wait_ms": ("RAFT_TPU_SERVE_MAX_WAIT_MS", "2", None),
    "serve_queue_cap": ("RAFT_TPU_SERVE_QUEUE_CAP", "1024", None),
    "serve_breaker_threshold": ("RAFT_TPU_SERVE_BREAKER_THRESHOLD", "5", None),
    "serve_breaker_window": ("RAFT_TPU_SERVE_BREAKER_WINDOW", "16", None),
    "serve_breaker_window_failures": (
        "RAFT_TPU_SERVE_BREAKER_WINDOW_FAILURES", "8", None),
    "serve_breaker_cooldown_ms": ("RAFT_TPU_SERVE_BREAKER_COOLDOWN_MS", "250", None),
    "serve_tenant_weights": ("RAFT_TPU_SERVE_TENANT_WEIGHTS", "", None),
    "serve_ann_nprobe": ("RAFT_TPU_SERVE_ANN_NPROBE", "0", None),
    "serve_ann_nprobe_ladder": ("RAFT_TPU_SERVE_ANN_NPROBE_LADDER", "4,8,16,32,64", None),
    "serve_ann_delta_cap": ("RAFT_TPU_SERVE_ANN_DELTA_CAP", "4096", None),
    "serve_ann_compact_rows": ("RAFT_TPU_SERVE_ANN_COMPACT_ROWS", "2048", None),
    "serve_ann_degrade_frac": ("RAFT_TPU_SERVE_ANN_DEGRADE_FRAC", "0.75", None),
    "serve_ann_device_budget_bytes": ("RAFT_TPU_SERVE_ANN_DEVICE_BUDGET_BYTES", "0", None),
    "flight_events": ("RAFT_TPU_FLIGHT_EVENTS", "4096", None),
    "serve_hedge_ms": ("RAFT_TPU_SERVE_HEDGE_MS", "0", None),
    "serve_hedge_factor": ("RAFT_TPU_SERVE_HEDGE_FACTOR", "1.5", None),
    "serve_hedge_min_ms": ("RAFT_TPU_SERVE_HEDGE_MIN_MS", "10", None),
    "persist_fsync": ("RAFT_TPU_PERSIST_FSYNC", "always", None),
    "persist_snapshot_interval_s": ("RAFT_TPU_PERSIST_SNAPSHOT_INTERVAL_S", "30", None),
    "persist_scrub_chunks": ("RAFT_TPU_PERSIST_SCRUB_CHUNKS", "4", None),
    "serve_slo_target_ms": ("RAFT_TPU_SERVE_SLO_TARGET_MS", "100", None),
    "serve_slo_objective": ("RAFT_TPU_SERVE_SLO_OBJECTIVE", "0.99", None),
    "serve_slo_windows_s": ("RAFT_TPU_SERVE_SLO_WINDOWS_S", "60,300", None),
    "ops_healthz_ttl_s": ("RAFT_TPU_OPS_HEALTHZ_TTL_S", "15", None),
    "ops_sentinel_interval_s": ("RAFT_TPU_OPS_SENTINEL_INTERVAL_S", "1", None),
    "ops_sentinel_latency_factor": ("RAFT_TPU_OPS_SENTINEL_LATENCY_FACTOR", "3", None),
    "ops_sentinel_min_samples": ("RAFT_TPU_OPS_SENTINEL_MIN_SAMPLES", "20", None),
    "ops_sentinel_queue_frac": ("RAFT_TPU_OPS_SENTINEL_QUEUE_FRAC", "0.8", None),
    "ops_sentinel_burn": ("RAFT_TPU_OPS_SENTINEL_BURN", "2", None),
    "ops_sentinel_wal_records": ("RAFT_TPU_OPS_SENTINEL_WAL_RECORDS", "100000", None),
    "ops_sentinel_stall_frac": ("RAFT_TPU_OPS_SENTINEL_STALL_FRAC", "0.5", None),
    "ops_sentinel_rejoin_ms_per_record": ("RAFT_TPU_OPS_SENTINEL_REJOIN_MS_PER_RECORD", "50", None),
    "ops_sentinel_rejoin_hold_s": ("RAFT_TPU_OPS_SENTINEL_REJOIN_HOLD_S", "10", None),
    "fleet_lease_interval_s": ("RAFT_TPU_FLEET_LEASE_INTERVAL_S", "0.5", None),
    "fleet_lease_misses": ("RAFT_TPU_FLEET_LEASE_MISSES", "3", None),
    "fleet_retry_max": ("RAFT_TPU_FLEET_RETRY_MAX", "3", None),
    "fleet_retry_backoff_s": ("RAFT_TPU_FLEET_RETRY_BACKOFF_S", "0.05", None),
    "fleet_hedge_ms": ("RAFT_TPU_FLEET_HEDGE_MS", "100", None),
    "fleet_timeout_s": ("RAFT_TPU_FLEET_TIMEOUT_S", "10", None),
    "fleet_inflight_cap": ("RAFT_TPU_FLEET_INFLIGHT_CAP", "256", None),
}

# sentinel for "no layer claimed this knob" during resolution — distinct
# from None, which an override frame may hold to mean "revert to
# env/table/default inside this scope"
_UNSET = object()

_values: Dict[str, Optional[str]] = {}
_tls = threading.local()
_lock = threading.Lock()


def _frames():
    return getattr(_tls, "frames", ())


def _check(name: str, value: Optional[str] = None) -> None:
    if name not in _KNOBS:
        raise ValueError(
            f"raft_tpu_torch.config: unknown knob {name!r} "
            f"(have: {', '.join(sorted(_KNOBS))})")
    choices = _KNOBS[name][2]
    if value is not None and choices is not None and value not in choices:
        raise ValueError(f"raft_tpu_torch.config: {name}={value!r} not in {choices}")


def _walk(name: str) -> Tuple[object, Optional[str]]:
    """One knob through the rungs above the table (module doc): the
    innermost override frame, then :func:`configure`, then the
    environment.  ``(_UNSET, None)`` when none claimed it.  A literal
    None in a frame is the scoped revert to env/table/default (it skips
    :func:`configure` too).  The one copy of the walk: :func:`get`,
    :func:`tuned` and :func:`describe` share it."""
    env = _KNOBS[name][0]
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
    return _UNSET, None


def get(name: str) -> Optional[str]:
    """Resolve a knob (module-doc order, without the table: :func:`tuned`
    is the shape-aware entry); the raw string, or None for an unset knob
    with no default."""
    _check(name)
    val, _ = _walk(name)
    return _KNOBS[name][1] if val is _UNSET else val


def knob_default(name: str) -> Optional[str]:
    """The built-in default of ``name`` (the bottom resolution rung)."""
    _check(name)
    return _KNOBS[name][1]


def tuned(name: str, op: Optional[str] = None, dtype: Optional[str] = None,
          dims: Optional[Dict[str, int]] = None) -> Tuple[Optional[str], str]:
    """The whole ladder, the table included: ``(value, rung)`` with rung
    ``"override" | "configure" | "env" | "table" | "default"``.  The
    registry (:mod:`raft_tpu_torch.core.tuning`) is the caller and needs
    the rung to treat a table answer as advisory."""
    _check(name)
    val, layer = _walk(name)
    if val is _UNSET:
        # a scoped revert (override(knob=None)) lands here too: it
        # restores the table's answer, not the built-in default
        tv = _table_answer(name, op, dtype, dims)
        if tv is not None:
            return tv, "table"
        return _KNOBS[name][1], "default"
    return val, layer


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


# --------------------------------------------------------------------- #
# the tuning-table rung (module doc)
# --------------------------------------------------------------------- #
TUNING_TABLE_VERSION = 1
TUNING_TABLE_ENV = "RAFT_TPU_TUNING_TABLE"

_table: Optional[Dict] = None          # validated and indexed
_table_env_checked = False
_table_warned: set = set()             # one stale warning per source


def _tables_dir() -> str:
    return os.path.join(os.path.dirname(os.path.abspath(__file__)), "tuning")


def _fingerprint_matches(fp: Dict) -> bool:
    from raft_tpu_torch.core.tuning import backend_fingerprint

    live = backend_fingerprint()
    return all(fp.get(k) == live[k] for k in ("platform", "device_kind", "device_count"))


def _index_table(doc: Dict, source: str) -> Dict:
    """Validate a parsed table and index it; a corrupt table raises (one
    read in half would pin choices nobody swept)."""
    from raft_tpu_torch.core.error import LogicError

    def bad(why):
        return LogicError("raft_tpu_torch.config: corrupt tuning table %s — %s" % (source, why))

    if not isinstance(doc, dict):
        raise bad("top level is not an object")
    if doc.get("version") != TUNING_TABLE_VERSION:
        raise bad("version=%r (this build reads version %d)"
                  % (doc.get("version"), TUNING_TABLE_VERSION))
    fp = doc.get("fingerprint")
    if not isinstance(fp, dict) or not all(
            k in fp for k in ("platform", "device_kind", "device_count")):
        raise bad("fingerprint missing platform/device_kind/device_count")
    entries = doc.get("entries")
    if not isinstance(entries, list):
        raise bad("entries is not a list")
    index: Dict[Tuple, Dict] = {}
    for i, e in enumerate(entries):
        if not isinstance(e, dict) or not all(
                k in e for k in ("op", "knob", "shape_class", "dtype", "winner")):
            raise bad("entry %d missing op/knob/shape_class/dtype/winner" % i)
        index[(e["op"], e["knob"], e["shape_class"], e["dtype"])] = e
    return {"doc": doc, "index": index, "source": source, "fingerprint": fp}


def install_tuning_table(doc: Dict, *, source: str = "<memory>",
                         check_fingerprint: bool = True) -> bool:
    """Make a parsed table THE active table.  Returns False, with one
    warning a source and nothing installed, when its fingerprint is not
    this backend's and ``check_fingerprint`` holds."""
    global _table
    t = _index_table(doc, source)
    if check_fingerprint and not _fingerprint_matches(t["fingerprint"]):
        from raft_tpu_torch.core.tuning import backend_fingerprint

        with _lock:
            first = source not in _table_warned
            _table_warned.add(source)
        if first:
            warnings.warn(
                "raft_tpu_torch.config: tuning table %s has stale fingerprint %r (this "
                "backend: %r) — table IGNORED; sweep this card with tools/torch_autotune.py"
                % (source, t["fingerprint"], backend_fingerprint()), stacklevel=2)
        return False
    _table = t
    return True


def load_tuning_table(path: str, *, check_fingerprint: bool = True) -> bool:
    """Load a table file written by ``tools/torch_autotune.py``.  An
    unreadable or corrupt file raises :class:`LogicError`; a stale
    fingerprint warns once and returns False."""
    from raft_tpu_torch.core.error import LogicError

    try:
        with open(path, encoding="utf-8") as f:
            doc = json.load(f)
    except (OSError, ValueError) as e:
        raise LogicError("raft_tpu_torch.config: corrupt/unreadable tuning table %s — %s"
                         % (path, e)) from None
    return install_tuning_table(doc, source=str(path), check_fingerprint=check_fingerprint)


def clear_tuning_table() -> None:
    """Remove the active table (resolution reverts to env/default)."""
    global _table
    _table = None


def discover_tuning_table() -> Optional[str]:
    """Path of the checked-in table under ``raft_tpu_torch/tuning/`` whose
    fingerprint is this backend's, or None (no warning: no table for this
    venue simply means no table)."""
    d = _tables_dir()
    if not os.path.isdir(d):
        return None
    for fname in sorted(os.listdir(d)):
        if not fname.endswith(".json"):
            continue
        path = os.path.join(d, fname)
        try:
            with open(path, encoding="utf-8") as f:
                fp = json.load(f).get("fingerprint", {})
        except (OSError, ValueError, AttributeError):
            continue
        if isinstance(fp, dict) and _fingerprint_matches(fp):
            return path
    return None


def _auto_load_table() -> None:
    """Honour ``RAFT_TPU_TUNING_TABLE`` once, at the first consult:
    ``"0"`` or empty loads nothing, ``"auto"`` discovers by fingerprint,
    anything else is a path."""
    global _table_env_checked
    if _table_env_checked:
        return
    _table_env_checked = True
    spec = os.environ.get(TUNING_TABLE_ENV)
    if not spec or spec == "0":
        return
    if spec == "auto":
        path = discover_tuning_table()
        if path is not None:
            load_tuning_table(path)
        return
    load_tuning_table(spec)


def _suspend_depth() -> int:
    return getattr(_tls, "table_suspended", 0)


@contextmanager
def suspend_tuning() -> Iterator[None]:
    """Resolution inside the block behaves as if no table were loaded (the
    untuned arm of an A/B, the sweep's timing).  Thread-local, like the
    override frames: a serve worker thread never sees a caller's
    suspension."""
    _tls.table_suspended = _suspend_depth() + 1
    try:
        yield
    finally:
        _tls.table_suspended = _suspend_depth() - 1


def _active_table() -> Optional[Dict]:
    if _suspend_depth():
        return None
    if _table is None:
        _auto_load_table()
    return _table


def _count_table(outcome: str, knob: str) -> None:
    from raft_tpu_torch.core import metrics

    metrics.default_registry().counter(
        "raft_tpu_tuning_table_lookups_total", help="tuning-table lookups by outcome",
        labels=("outcome", "knob")).labels(outcome=outcome, knob=knob).inc()


def _table_answer(name: str, op: Optional[str], dtype: Optional[str],
                  dims: Optional[Dict[str, int]]) -> Optional[str]:
    t = _active_table()
    if t is None:
        return None
    from raft_tpu_torch.core.tuning import shape_class

    cls = shape_class(dims or {})
    dt = dtype or "*"
    o = op or "*"
    index = t["index"]
    for key in ((o, name, cls, dt), (o, name, cls, "*"), (o, name, "*", dt), (o, name, "*", "*")):
        e = index.get(key)
        if e is not None:
            _count_table("hit", name)
            return e["winner"]
    _count_table("miss", name)
    return None


def _table_entries_for(name: str):
    t = _active_table()
    if t is None:
        return ()
    return tuple(e for e in t["index"].values() if e["knob"] == name)


def tuning_table_info() -> Optional[Dict]:
    """Summary of the active table, None when untuned: its source, its
    fingerprint, its cell count and the cells of each knob.  The ops
    plane's ``/statusz`` and ``/debug/snapshot`` report it."""
    t = _active_table()
    if t is None:
        return None
    per_knob: Dict[str, int] = {}
    for e in t["index"].values():
        per_knob[e["knob"]] = per_knob.get(e["knob"], 0) + 1
    return {"source": t["source"], "fingerprint": dict(t["fingerprint"]),
            "cells": len(t["index"]), "knobs": per_knob}


# --------------------------------------------------------------------- #
# setting and reporting
# --------------------------------------------------------------------- #
def configure(**knobs: Optional[str]) -> None:
    """Set knob values process-wide (None = revert to env/table/default)."""
    for name, value in knobs.items():
        _check(name, value)
        if value is None:
            _values.pop(name, None)
        else:
            _values[name] = value


@contextmanager
def override(**knobs: Optional[str]) -> Iterator[None]:
    """Scoped knob values (thread-local; nestable, innermost wins).

    ``override(knob=None)`` reverts the knob to its env/table/default
    inside the scope — the scoped spelling of ``configure(knob=None)``."""
    for name, value in knobs.items():
        _check(name, value)
    frames = list(_frames())
    frames.append(dict(knobs))
    _tls.frames = tuple(frames)
    try:
        yield
    finally:
        _tls.frames = tuple(frames[:-1])


def _attribute(name: str) -> Tuple[Optional[str], str]:
    """``(value, rung)`` of a knob with no shape: the table rung answers
    when the active table holds a cell of the knob and no rung above
    claims it, with the cells' one winner, or ``"per-shape"`` where they
    disagree."""
    val, layer = _walk(name)
    if val is not _UNSET:
        return val, layer
    cells = _table_entries_for(name)
    if cells:
        winners = {e["winner"] for e in cells}
        return (winners.pop() if len(winners) == 1 else "per-shape"), "table"
    return _KNOBS[name][1], "default"


def describe(layers: bool = False) -> Dict:
    """The effective value of every knob, the table rung included;
    ``layers=True`` also names the rung that answered: ``{knob:
    {"value": ..., "layer": "override" | "configure" | "env" | "table" |
    "default"}}``."""
    if not layers:
        return {name: _attribute(name)[0] for name in _KNOBS}
    return {name: dict(zip(("value", "layer"), _attribute(name))) for name in _KNOBS}
