"""Service facades: warmup / submit / drain / close over hot primitives.

Port of ``raft_tpu/serve/service.py``.  A service pins the
heavy, shape-stable half of a query workload at construction (the kNN
index, the pairwise reference matrix, k, the metric) and serves the
light, shape-varying half (query rows) through the micro-batching
engine:

- :class:`KNNService`  — ``submit((n_i, d) queries) -> (dists, ids)``
  over :func:`raft_tpu_torch.spatial.brute_force_knn`, or, with
  ``mesh``/``axis``, over the sharded search
  :func:`raft_tpu_torch.spatial.mnmg_knn.mnmg_knn` (the index
  row-sharded over a rank mesh once at construction), or, with
  ``replicas``, over R replicas of it on disjoint sub-meshes with hedged
  dispatch (:mod:`raft_tpu_torch.serve.replicas`);
- :class:`PairwiseService` — ``submit((n_i, d) x) -> (n_i, n_y)`` over
  :func:`raft_tpu_torch.distance.pairwise_distance`.

Each takes ``device=`` (default ``"cuda"``; it raises when CUDA is
missing, and ``device="cpu"`` runs the plain PyTorch versions of the
kernels).  Both call their device function only at bucket shapes, and
:meth:`Service.warmup` runs every rung once on zeros before traffic
arrives: that builds and loads the kernel libraries and warms the
caching allocator.  PyTorch compiles nothing per shape, so the JAX
package's "zero compiles after warmup" becomes "zero kernel builds or
loads after warmup", counted by :mod:`raft_tpu_torch.ops._build`
(``stats()["kernel_libraries_after_warmup"]``).

What is not ported, and why:

- ``profiled_jit`` and the donating twins: PyTorch runs eagerly and has
  no buffer donation, so ``donate=`` is not an argument here.

(``ANNService``, with its resident, sharded and out-of-core arms, is in
``serve/ann_service.py``.)

Recovery seams: :meth:`Service.pause`/:meth:`Service.resume` and
:meth:`Service.post_recover`, which the
:class:`~raft_tpu_torch.serve.resilience.RecoveryManager` runs after a
communicator rebuild: a sharded service re-partitions onto the rebuilt
session mesh (:meth:`KNNService.repartition`), a replicated one re-cuts
its replica groups (:meth:`KNNService.rebuild_replicas`).

Results: a kNN request's result depends only on its own query row, and
the kernels' arithmetic is per row, so a served kNN result equals the
unbatched ``brute_force_knn`` of the same rows on the card, and a
sharded or replicated one the unbatched ``mnmg_knn`` of its rows (its
merges order ties by global id, row by row).  A pairwise
metric on the card's matmul (the expanded ones) may round differently
at another row count, since cuBLAS may pick another kernel; it is
bitwise equal to the call on the same padded batch, sliced, as the JAX
package promises for pairwise.  The unexpanded metrics (K5) are per
pair and equal the unbatched call.

Optional per-service query-vector cache: an LRU
:class:`~raft_tpu_torch.cache.VecCache` keyed by caller ids
(``query_cache_size > 0``) lets repeat queries be submitted *by key*
(:meth:`Service.submit_keys`) without re-shipping the vector; hit/miss
counters land in the registry.
"""

from __future__ import annotations

import itertools
import threading
import time
from typing import Callable, List, NamedTuple, Optional, Sequence, Tuple

import torch

from raft_tpu_torch import config
from raft_tpu_torch.cache import VecCache
from raft_tpu_torch.comms.mesh import refuse_spanning
from raft_tpu_torch.core import flight
from raft_tpu_torch.core.device import as_tensor, resolve_device
from raft_tpu_torch.core.error import (
    LogicError,
    ServiceOverloadError,
    ServiceUnavailableError,
    expects,
)
from raft_tpu_torch.distance.distance_type import DistanceType
from raft_tpu_torch.distance.pairwise import pairwise_distance
from raft_tpu_torch.ops import _build
from raft_tpu_torch.serve.batcher import MicroBatcher, ServeFuture
from raft_tpu_torch.serve.bucketing import BucketPolicy, resolve_rungs
from raft_tpu_torch.serve.resilience import BreakerState, CircuitBreaker
from raft_tpu_torch.serve.scheduler import ServeWorker, _counter, _gauge, _tenant_counter
from raft_tpu_torch.spatial.knn import brute_force_knn
from raft_tpu_torch.spatial.mnmg_knn import mnmg_knn, resolve_merge, shard_knn_index

__all__ = ["Service", "KNNService", "PairwiseService"]

_service_seq = itertools.count()

_knob_float = config.get_float
_knob_int = config.get_int


def _parse_tenant_weights(spec) -> Optional[dict]:
    """Resolve a tenant-weight spec — ``{name: weight}`` dict, or the
    ``serve_tenant_weights`` knob's ``"name:weight,name:weight"``
    string — into a dict (None/empty = tenancy off)."""
    if spec is None:
        return None
    if isinstance(spec, dict):
        return {str(k): float(v) for k, v in spec.items()} or None
    out = {}
    for tok in str(spec).split(","):
        tok = tok.strip()
        if not tok:
            continue
        name, sep, w = tok.partition(":")
        try:
            out[name.strip()] = float(w) if sep else 1.0
        except ValueError:
            raise ValueError(
                "serve_tenant_weights: %r is not name:weight" % tok
            ) from None
    return out or None


def _parse_windows(spec) -> tuple:
    """Resolve an SLO-window seconds list (an explicit sequence, or
    the ``serve_slo_windows_s`` knob already parsed by
    :func:`config.get_float_list`) into an ascending float tuple."""
    try:
        out = tuple(sorted(float(tok) for tok in
                           (spec.split(",") if isinstance(spec, str)
                            else spec) if str(tok).strip()))
    except (TypeError, ValueError):
        raise ValueError(
            "serve_slo_windows_s: %r is not a comma-separated number "
            "list" % (spec,)) from None
    expects(len(out) > 0 and all(w > 0 for w in out),
            "serve_slo_windows_s: %r resolves to no positive windows",
            spec)
    return out


def _breaker_from_knobs(name: str, clock) -> Optional[CircuitBreaker]:
    """One breaker per the ``serve_breaker_*`` knobs, or None when both
    trip conditions are knobbed off (a breaker that can never open is
    just overhead)."""
    threshold = _knob_int("serve_breaker_threshold")
    window_failures = _knob_int("serve_breaker_window_failures")
    if threshold == 0 and window_failures == 0:
        return None
    return CircuitBreaker(
        name,
        failure_threshold=threshold,
        window=_knob_int("serve_breaker_window"),
        window_failures=window_failures,
        cooldown_s=_knob_float("serve_breaker_cooldown_ms") / 1e3,
        clock=clock)


class Service:
    """Micro-batching façade over one device function.

    Parameters
    ----------
    execute:
        ``execute(padded_queries) -> tensor or tuple of tensors`` with
        the batch rows leading (subclasses bind the pinned operands).
    dim / dtype:
        Query row shape contract; enforced at ``submit``.
    device:
        Where the queries go and the device function runs (default
        ``"cuda"``; raises when CUDA is missing).
    max_batch_rows:
        Top bucket rung = device-call row cap = per-request row cap.
    bucket_rungs / max_wait_ms / queue_cap:
        Shape ladder, micro-batch window, admission cap; each defaults
        to its ``serve_*`` knob in :mod:`raft_tpu_torch.config`.
    retry_policy:
        Optional per-batch :class:`~raft_tpu_torch.comms.resilience.RetryPolicy`
        (watchdog deadline + retries around the device call).
    breaker:
        The service circuit breaker
        (:class:`~raft_tpu_torch.serve.resilience.CircuitBreaker`).
        Default (None): construct one from the ``serve_breaker_*``
        knobs.  Pass a configured instance to tune it, or ``False`` to
        opt out (every batch failure is relayed to its riders).
    tenant_weights:
        Multi-tenant traffic shaping: a ``{tenant: weight}`` dict or the
        knob's ``"name:weight,..."`` string.  Each coalesce window is a
        weighted-fair share of the batch across tenants with queued
        work, and each tenant's admission cap is its weight's share of
        ``queue_cap``.  Default: the ``serve_tenant_weights`` knob
        (empty = single-queue serving).
    query_cache_size:
        > 0 enables the :class:`VecCache` query-vector cache
        (:meth:`cache_put` / :meth:`submit_keys`).
    maintenance / maintenance_interval_s:
        Optional background-work callback run on the worker thread
        between batches (see :class:`ServeWorker`).
    start:
        Spawn the worker thread now (False = threadless: tests drive
        :attr:`worker` ``.run_once()`` under an injected ``clock``).
    """

    # sharded-serving contract: non-None on services dispatching into a
    # sharded search.  The session's health_check validates them against
    # its (possibly rebuilt) mesh; post_recover re-partitions through them.
    axis: Optional[str] = None
    mesh = None

    def __init__(self, name: str, execute: Callable, dim: int,
                 dtype=torch.float32, *,
                 device="cuda",
                 max_batch_rows: int = 1024,
                 bucket_rungs=None,
                 max_wait_ms: Optional[float] = None,
                 queue_cap: Optional[int] = None,
                 retry_policy=None,
                 breaker=None,
                 tenant_weights=None,
                 query_cache_size: int = 0,
                 maintenance: Optional[Callable[[], None]] = None,
                 maintenance_interval_s: float = 0.05,
                 start: bool = True,
                 clock: Callable[[], float] = time.monotonic):
        expects(dim >= 1, "Service: dim=%d", dim)
        self.name = name
        self.dim = int(dim)
        self.dtype = dtype
        self.device = resolve_device(device)
        self._execute = execute
        self._clock = clock
        if bucket_rungs is None:
            bucket_rungs = config.get("serve_bucket_rungs")
        if max_wait_ms is None:
            max_wait_ms = _knob_float("serve_max_wait_ms")
        if queue_cap is None:
            queue_cap = _knob_int("serve_queue_cap")
        if tenant_weights is None:
            tenant_weights = config.get("serve_tenant_weights")
        tenant_weights = _parse_tenant_weights(tenant_weights)
        self.tenant_weights = tenant_weights
        self.policy = BucketPolicy(
            resolve_rungs(bucket_rungs, int(max_batch_rows)))
        self.batcher = MicroBatcher(
            max_batch_rows=self.policy.max_rows,
            max_wait_s=float(max_wait_ms) / 1e3,
            queue_cap=int(queue_cap), clock=clock, name=name,
            tenant_weights=tenant_weights)
        if breaker is None:
            breaker = _breaker_from_knobs(name, clock)
        elif breaker is False:
            breaker = None
        self.breaker = breaker
        # per-tenant SLO tracker: latency target + deadline-hit-rate with
        # multi-window burn rates, fed by the worker per terminal
        # request and surfaced through stats()
        self.slo = flight.slo_for(
            name,
            target_s=_knob_float("serve_slo_target_ms") / 1e3,
            objective=_knob_float("serve_slo_objective"),
            windows_s=_parse_windows(
                config.get_float_list("serve_slo_windows_s")),
            clock=clock)
        # fresh exemplars to match the fresh SLO tracker (cleared in
        # place — the worker caches the same reservoir object)
        flight.exemplars_for(name).clear()
        self.worker = ServeWorker(name, self.batcher, self.policy,
                                  execute, retry_policy=retry_policy,
                                  maintenance=maintenance,
                                  maintenance_interval_s=(
                                      maintenance_interval_s),
                                  breaker=breaker,
                                  slo=self.slo,
                                  device=self.device,
                                  clock=clock)
        self._warmed: Tuple[int, ...] = ()
        self._warm_kernels: Optional[dict] = None
        self._closed = False
        self._cache_lock = threading.Lock()
        self._cache: Optional[VecCache] = None
        self._cache_state = None
        if query_cache_size > 0:
            self._cache = VecCache(self.dim, int(query_cache_size),
                                   dtype=self.dtype, device=self.device)
            self._cache_state = self._cache.init()
        if start:
            self.worker.start()

    # ------------------------------------------------------------------ #
    # lifecycle
    # ------------------------------------------------------------------ #
    def warmup(self) -> "Service":
        """Run the device function once at every bucket rung on zeros
        and wait for it: every kernel library is built and loaded and
        the caching allocator holds blocks of every rung's shapes.  The
        kernel-library count taken here is what ``stats()`` compares
        against: steady-state traffic builds and loads nothing.  It runs
        on the worker's stream, whose pool of the caching allocator
        serves the batches."""
        with torch.cuda.stream(self.worker.stream):
            for rung in self.policy.rungs:
                self._execute(torch.zeros((rung, self.dim), dtype=self.dtype,
                                          device=self.device))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._warmed = self.policy.rungs
        self._warm_kernels = _build.stats()
        return self

    @property
    def warmed_rungs(self) -> Tuple[int, ...]:
        return self._warmed

    def kernel_libraries_after_warmup(self) -> Optional[dict]:
        """``{"builds": n, "loads": n}`` since :meth:`warmup` (None
        before it): both 0 in steady state."""
        if self._warm_kernels is None:
            return None
        now = _build.stats()
        return {k: now[k] - self._warm_kernels[k] for k in now}

    def is_open(self) -> bool:
        return not self._closed

    def drain(self, timeout: Optional[float] = None) -> bool:
        """Stop admission, serve out the queue; True when empty."""
        return self.worker.drain(timeout=timeout)

    def pause(self) -> None:
        """Suspend the service: new submits shed with
        :class:`~raft_tpu_torch.core.error.ServiceUnavailableError`
        (``reason="recovering"``), batch formation stops, queued
        requests wait.  Reversible (:meth:`resume`) — unlike drain."""
        self.batcher.pause()

    def resume(self) -> None:
        """Re-admit after :meth:`pause`: batch formation restarts (the
        queued backlog first) and the breaker is reset closed."""
        self.batcher.resume()
        if self.breaker is not None:
            self.breaker.reset()

    def post_recover(self) -> None:
        """Hook run by :class:`~raft_tpu_torch.serve.resilience.RecoveryManager`
        after a communicator rebuild, before ``warmup()``.  The base
        services pin only immutable operands: nothing to redo; an
        ``ANNService`` re-publishes its snapshot, and the sharded services
        re-partition onto the rebuilt mesh."""

    # -- the sharded-recovery plumbing shared by KNNService and ANNService
    def _recovery_mesh(self):
        """The mesh ``repartition()`` re-cuts onto when none is given: the
        owning session's rebuilt mesh when it still has our axis
        (``Comms.serve`` binds ``_session``), else the current one."""
        session = getattr(self, "_session", None)
        comms = getattr(session, "comms", None)
        if comms is not None and self.axis in comms.mesh.axis_names:
            return comms.mesh
        return self.mesh

    def _drop_stale_group_size(self, mesh) -> None:
        """A pinned hierarchical ``group_size`` that does not divide the
        survivor mesh's axis size must not brick recovery: drop the pin
        and let ``resolve_group_size`` re-derive it per mesh."""
        g = getattr(self, "_group_size", None)
        if g and int(mesh.shape[self.axis]) % int(g):
            self._group_size = None

    def _record_repartition(self, mesh) -> None:
        _counter("raft_tpu_serve_repartitions_total",
                 "sharded-index re-partitions (shard-loss recovery)", self.name).inc()
        _shard_gauge(self.name, int(mesh.shape[self.axis]))
        flight.record("repartition", service=self.name, devices=int(mesh.shape[self.axis]))

    def close(self, drain: bool = True,
              timeout: Optional[float] = None) -> None:
        """Drain (by default) and stop the worker.  Idempotent."""
        if self._closed:
            return
        self._closed = True
        self.worker.close(drain=drain, timeout=timeout)

    def __enter__(self) -> "Service":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # ------------------------------------------------------------------ #
    # submission
    # ------------------------------------------------------------------ #
    def _check_payload(self, queries) -> torch.Tensor:
        q = as_tensor(queries, self.device)
        if q.ndim == 1:
            q = q[None, :]
        expects(q.ndim == 2 and q.shape[1] == self.dim,
                "%s.submit: expected (rows, %d) queries, got %r",
                self.name, self.dim, tuple(q.shape))
        return q.to(self.dtype)

    def submit(self, queries, timeout: Optional[float] = None, *,
               tenant: Optional[str] = None,
               tier: int = 0) -> ServeFuture:
        """Enqueue a query block (a numpy array or a tensor, moved to the
        service's device); returns a future resolving to this service's
        result slice for exactly those rows.

        ``timeout`` is the request's end-to-end deadline in seconds: if
        it expires while the request is still queued, the future fails
        with :class:`~raft_tpu_torch.core.error.CommTimeoutError` instead
        of occupying a batch (deadline-aware shedding).

        ``tenant`` tags the request for weighted-fair traffic shaping
        (None = the default tenant) and ``tier`` is the priority
        override applied before earliest-deadline-first ordering within
        the tenant's share (lower = more urgent).

        Unavailability sheds FAST with
        :class:`~raft_tpu_torch.core.error.ServiceUnavailableError` before
        anything is queued: a dead worker thread, an open circuit
        breaker (``retry_after_s`` carries the cooldown), or a pause.
        """
        expects(not self._closed, "%s.submit: service is closed",
                self.name)
        # payload validation FIRST: a malformed request is the caller's
        # bug and must not consume a half-open probe slot
        q = self._check_payload(queries)
        self._check_available()
        stream = self._join_worker_stream(q)
        deadline_t = None if timeout is None else self._clock() + timeout
        try:
            fut = self.batcher.submit(q, int(q.shape[0]), deadline_t,
                                      tenant=tenant, tier=tier,
                                      stream=stream)
        except ServiceOverloadError as e:
            _counter("raft_tpu_serve_rejected_total",
                     "requests shed by admission control",
                     self.name).inc()
            if e.tenant is not None:
                _tenant_counter("raft_tpu_serve_tenant_rejected_total",
                                "requests shed by admission control, "
                                "per tenant", self.name, e.tenant).inc()
            # sheds precede admission, so no trace exists — a system
            # event keeps them visible in the ordered stream anyway
            flight.record("shed", service=self.name, tenant=e.tenant,
                          reason="overload")
            raise
        _counter("raft_tpu_serve_submitted_total",
                 "admitted requests", self.name).inc()
        _gauge("raft_tpu_serve_queue_depth", "requests queued",
               self.name).set(self.batcher.depth())
        return fut

    def _join_worker_stream(self, q: torch.Tensor):
        """Order the worker's stream after the caller's current stream,
        on which ``q`` may still be being written, and mark ``q`` as used
        on the worker's stream.  Returns the caller's stream when it is
        another one (None on the CPU or on the worker's own stream)."""
        worker = self.worker.stream
        if worker is None:
            return None
        caller = torch.cuda.current_stream(self.device)
        if caller == worker:
            return None
        worker.wait_stream(caller)
        q.record_stream(worker)
        return caller

    def _shed_unavailable(self, message: str, reason: str,
                          retry_after_s: float = 0.0) -> None:
        _counter("raft_tpu_serve_unavailable_total",
                 "requests shed because the service is broken or "
                 "healing (breaker open / dead worker / recovering)",
                 self.name).inc()
        flight.record("shed", service=self.name, reason=reason)
        raise ServiceUnavailableError(message, self.name, reason,
                                      retry_after_s)

    def _check_available(self) -> None:
        """The fail-fast half of admission: a request must never be
        queued into a service that cannot possibly serve it."""
        w = self.worker
        if w.dead():
            self._shed_unavailable(
                "%s.submit: worker thread has died — restart() before "
                "resubmitting" % self.name,
                "worker_dead")
        if self.batcher.paused():
            self._shed_unavailable(
                "%s.submit: recovery in progress" % self.name,
                "recovering")
        if self.breaker is not None and not self.breaker.allow():
            half_open = self.breaker.state is BreakerState.HALF_OPEN
            self._shed_unavailable(
                "%s.submit: circuit breaker is %s — back off and "
                "retry" % (self.name,
                           "half-open (probe budget spent)"
                           if half_open else "open"),
                "breaker_half_open" if half_open else "breaker_open",
                self.breaker.retry_after())

    def submit_many(self, blocks: Sequence,
                    timeout: Optional[float] = None, *,
                    tenant: Optional[str] = None,
                    tier: int = 0) -> List[ServeFuture]:
        """Submit several query blocks; one future each, same deadline
        (and the same tenant/tier tags)."""
        return [self.submit(b, timeout=timeout, tenant=tenant,
                            tier=tier) for b in blocks]

    # ------------------------------------------------------------------ #
    # query-vector cache
    # ------------------------------------------------------------------ #
    def _require_cache(self) -> VecCache:
        expects(self._cache is not None,
                "%s: no query cache (construct with query_cache_size>0)",
                self.name)
        return self._cache

    def _keys(self, keys) -> torch.Tensor:
        return as_tensor(keys, self.device, torch.int32).reshape(-1)

    def cache_put(self, keys, vectors) -> None:
        """Store query vectors under caller ids for later
        :meth:`submit_keys` (functional :class:`VecCache` state swapped
        under a lock — concurrent submitters stay consistent)."""
        cache = self._require_cache()
        k = self._keys(keys)
        v = self._check_payload(vectors)
        expects(k.shape[0] == v.shape[0],
                "%s.cache_put: %d keys for %d vectors", self.name,
                k.shape[0], v.shape[0])
        expects(k.shape[0] == 0 or bool((k >= 0).all()),
                "%s.cache_put: negative keys (the cache reserves -1 "
                "for empty ways)", self.name)
        with self._cache_lock:
            self._cache_state = cache.store_vecs(self._cache_state, k, v)

    def cache_lookup(self, keys) -> Tuple[torch.Tensor, torch.Tensor]:
        """Fetch cached vectors for ``keys``; returns ``(vectors,
        found)`` and feeds the hit/miss counters."""
        cache = self._require_cache()
        k = self._keys(keys)
        with self._cache_lock:
            vecs, found, self._cache_state = cache.get_vecs(
                self._cache_state, k)
        hits = int(found.sum())
        if hits:
            _counter("raft_tpu_serve_query_cache_hits_total",
                     "query-vector cache hits", self.name).inc(hits)
        if hits < k.shape[0]:
            _counter("raft_tpu_serve_query_cache_misses_total",
                     "query-vector cache misses", self.name).inc(
                         k.shape[0] - hits)
        return vecs, found

    def submit_keys(self, keys, timeout: Optional[float] = None
                    ) -> ServeFuture:
        """Submit queries *by cached id* — the repeat-query fast path.
        Every key must be cached; missing keys raise
        :class:`LogicError` naming them."""
        k = self._keys(keys)
        vecs, found = self.cache_lookup(k)
        if not bool(found.all()):
            missing = k[~found]
            raise LogicError(
                "%s.submit_keys: keys not in the query cache: %r%s"
                % (self.name, missing[:16].tolist(),
                   "..." if missing.shape[0] > 16 else ""))
        return self.submit(vecs, timeout=timeout)

    # ------------------------------------------------------------------ #
    def stats(self) -> dict:
        """Small live-state dict."""
        out = {
            "open": self.is_open(),
            "worker_started": self.worker.started(),
            "worker_alive": self.worker.is_alive(),
            "queue_depth": self.batcher.depth(),
            "rows_queued": self.batcher.rows_queued(),
            "rungs": list(self.policy.rungs),
            "warmed": bool(self._warmed),
            "kernel_libraries_after_warmup": self.kernel_libraries_after_warmup(),
            "paused": self.batcher.paused(),
            # a silently failing maintenance callback must be visible
            # here, not only as a bare counter
            "last_maintenance_error": self.worker.last_maintenance_error,
            "slo": self.slo.snapshot(),
            "exemplars": flight.exemplars_for(self.name).snapshot(),
        }
        if self.breaker is not None:
            out["breaker"] = self.breaker.describe()
        if self.tenant_weights:
            depths = self.batcher.tenant_depths()   # one lock pass
            out["tenants"] = {
                name: {"weight": w,
                       "depth": depths.get(name, 0),
                       "cap": self.batcher.tenant_cap(name)}
                for name, w in self.batcher.tenants().items()}
        rs = getattr(self, "_replica_set", None)
        if rs is not None:
            out["replicas"] = rs.describe()
        if self.axis is not None:
            out.update({"sharded": True, "axis": self.axis,
                        "shard_devices": int(self.mesh.shape[self.axis]),
                        "shard_ranks": list(self.mesh.rank_ids()),
                        "merge": getattr(self, "merge", None)})
        return out


def _shard_gauge(service: str, ranks: int) -> None:
    _gauge("raft_tpu_serve_shard_devices",
           "rank slots the service's sharded index spans (0/absent = one device)",
           service).set(ranks)


def _resolve_shard_spec(cls_name: str, mesh, axis, merge, device):
    """Shared sharded-constructor resolution (KNNService and ANNService):
    default the mesh (the default mesh of ``device``), default the axis
    to the mesh's first, validate, resolve the merge knob once."""
    from raft_tpu_torch.comms.mesh import as_mesh, default_mesh

    mesh = default_mesh(device=device) if mesh is None else as_mesh(mesh)
    refuse_spanning(mesh, cls_name)
    if axis is None:
        axis = mesh.axis_names[0]
    expects(axis in mesh.axis_names, "%s: axis %r not in mesh axes %r", cls_name, axis,
            tuple(mesh.axis_names))
    return mesh, axis, resolve_merge(merge, devices=int(mesh.shape[axis]))


def _service_device(device, mesh):
    """A sharded or replicated service's device: the one asked for, else
    the first rank's of its mesh, else ``"cuda"``."""
    refuse_spanning(mesh, "a sharded or replicated service")
    if device is not None:
        return resolve_device(device)
    if mesh is not None:
        return mesh.ranks.flat[0].device
    return resolve_device("cuda")


class _ShardState(NamedTuple):
    """One immutable sharded-dispatch snapshot: the shards and the mesh
    they were cut for travel together, so a concurrent
    :meth:`KNNService.repartition` never pairs new shards with the old
    mesh mid-dispatch."""

    index: object       # ShardedRows
    n_rows: int
    mesh: object
    axis: str


class KNNService(Service):
    """Micro-batched :func:`brute_force_knn` over one pinned index, or,
    with ``mesh``/``axis``, :func:`~raft_tpu_torch.spatial.mnmg_knn.mnmg_knn`
    over the index row-sharded on a rank mesh once, or, with
    ``replicas``, R such replicas with hedged dispatch.

    ``submit((n_i, d))`` futures resolve to ``(distances, indices)`` of
    shape ``(n_i, k)``, equal bit for bit to the unbatched call of the
    same rows (module doc).

    Sharded parameters
    ------------------
    mesh / axis:
        Shard the index rows over ``axis`` of ``mesh`` (a
        :class:`~raft_tpu_torch.comms.mesh.Mesh`; ``axis`` alone takes the
        default mesh of ``device``; a session's ``serve`` passes its own).
    merge:
        ``allgather`` | ``ring`` | ``hierarchical``; None resolves the
        ``mnmg_merge`` knob.
    group_size:
        Hierarchical group size; None resolves per mesh.

    On a lost shard, :meth:`repartition` (run by ``post_recover`` in the
    :class:`~raft_tpu_torch.serve.resilience.RecoveryManager` sequence)
    re-shards the full index over the surviving ranks, and ``warmup()``
    runs every rung on them.

    Replica parameters
    ------------------
    replicas:
        Build this many replicas of the index over **disjoint**
        sub-meshes of ``mesh`` (:func:`~raft_tpu_torch.serve.replicas.split_mesh`;
        each sharded over its group), dispatched through a
        :class:`~raft_tpu_torch.serve.replicas.ReplicaSet`: rotation with
        per-replica breakers and hedged re-dispatch of straggling
        batches, first result wins, the loser cancelled.
        ``mesh``/``axis``/``merge`` describe the parent span.
    hedge_ms:
        Fixed hedge threshold in ms; None resolves ``serve_hedge_ms``
        (0 = adaptive: ``serve_hedge_factor`` x the per-rung p99,
        floored at ``serve_hedge_min_ms``).
    device:
        Where the index lives and the unsharded search runs (default: the
        first rank's device of ``mesh`` when one is given, else
        ``"cuda"``).
    """

    def __init__(self, index, k: int,
                 metric: DistanceType = DistanceType.L2Expanded,
                 tile_n: int = 8192, precision: str = "highest",
                 mesh=None, axis: Optional[str] = None,
                 merge: Optional[str] = None,
                 group_size: Optional[int] = None,
                 replicas: Optional[int] = None,
                 hedge_ms: Optional[float] = None,
                 name: Optional[str] = None, device=None, **opts):
        dev = _service_device(device, mesh)
        index = as_tensor(index, dev)
        expects(index.ndim == 2, "KNNService: (n, d) index required")
        expects(1 <= k <= index.shape[0],
                "KNNService: k=%d out of range for n_index=%d",
                k, index.shape[0])
        self.index = index
        self.k = int(k)
        self.metric = metric
        self._tile_n = int(tile_n)
        self._precision = precision
        self._group_size = group_size
        self._spmd: Optional[_ShardState] = None
        self._replica_set = None
        self._n_replicas = 0
        self.merge = None
        # the name first: replica breakers and metric labels need it
        name = name or "knn%d" % next(_service_seq)
        self.name = name
        if replicas is not None:
            expects(int(replicas) >= 2, "KNNService: replicas=%d (need >= 2; one replica "
                    "is just a [sharded] service)", int(replicas))
            mesh, axis, self.merge = _resolve_shard_spec("KNNService", mesh, axis, merge, dev)
            if hedge_ms is None:
                hedge_ms = _knob_float("serve_hedge_ms")
            self._hedge_s = None if float(hedge_ms) <= 0.0 else float(hedge_ms) / 1e3
            self._hedge_factor = _knob_float("serve_hedge_factor")
            self._hedge_min_s = _knob_float("serve_hedge_min_ms") / 1e3
            self._n_replicas = int(replicas)
            self._replica_axis = axis
            self._replica_parent = mesh
            self._replica_set = self._build_replica_set(
                mesh, axis, self._n_replicas, opts.get("clock", time.monotonic))
        elif mesh is not None or axis is not None:
            mesh, axis, self.merge = _resolve_shard_spec("KNNService", mesh, axis, merge, dev)
            self._shard_to(mesh, axis)

        def execute(padded):
            rs = self._replica_set      # one snapshot per batch
            if rs is not None:
                return rs.run(padded)
            spmd = self._spmd           # one snapshot per batch
            if spmd is not None:
                return mnmg_knn(spmd.index, padded, self.k, metric=self.metric,
                                mesh=spmd.mesh, axis=spmd.axis, n_rows=spmd.n_rows,
                                tile_n=self._tile_n, precision=self._precision,
                                merge=self.merge, group_size=self._group_size)
            return brute_force_knn(self.index, padded, self.k,
                                   metric=self.metric, tile_n=self._tile_n,
                                   precision=self._precision, device=dev)

        super().__init__(name, execute, dim=index.shape[1], dtype=index.dtype, device=dev,
                         **opts)
        if self.axis is not None:
            _shard_gauge(self.name, int(self.mesh.shape[self.axis]))

    # -- sharded serving ------------------------------------------------ #
    @property
    def mesh(self):
        return self._spmd.mesh if self._spmd is not None else None

    @property
    def axis(self) -> Optional[str]:
        return self._spmd.axis if self._spmd is not None else None

    def _shard_to(self, mesh, axis: str) -> None:
        """(Re-)shard the pinned index over ``axis``: one reference
        assignment of an immutable :class:`_ShardState`, so a batch reads
        the old or the new snapshot whole."""
        sharded, n_rows = shard_knn_index(self.index, mesh, axis)
        self._spmd = _ShardState(sharded, n_rows, mesh, axis)
        if "worker" in self.__dict__:
            _shard_gauge(self.name, int(mesh.shape[axis]))

    def repartition(self, mesh=None) -> bool:
        """Re-shard the index rows over ``mesh`` (default: the owning
        session's current mesh): the lost shard's rows redistribute over
        the surviving ranks, exactly (the full index is the source).
        Call ``warmup()`` after.  True when the mesh changed."""
        expects(self.axis is not None, "%s.repartition: service is not sharded", self.name)
        mesh = self._recovery_mesh() if mesh is None else mesh
        refuse_spanning(mesh, "%s.repartition" % self.name)
        expects(self.axis in mesh.axis_names,
                "%s.repartition: replacement mesh lacks axis %r", self.name, self.axis)
        if mesh is self.mesh:
            return False
        self._drop_stale_group_size(mesh)
        self._shard_to(mesh, self.axis)
        self._record_repartition(mesh)
        return True

    # -- replica groups and hedged dispatch ------------------------------ #
    def _replica_group_size(self, mesh) -> Optional[int]:
        """The pinned group size, dropped where it does not divide a
        replica sub-mesh's axis."""
        g = self._group_size
        if g and int(mesh.shape[self._replica_axis]) % int(g):
            return None
        return g

    def _build_replica_set(self, parent_mesh, axis: str, n: int, clock):
        """Cut ``parent_mesh`` into ``n`` disjoint sub-meshes, shard a full
        copy of the index over each, and wrap them in a
        :class:`~raft_tpu_torch.serve.replicas.ReplicaSet` with fresh
        per-replica breakers."""
        from raft_tpu_torch.serve.replicas import ReplicaSet, split_mesh

        members = []
        for m in split_mesh(parent_mesh, axis, n):
            sharded, n_rows = shard_knn_index(self.index, m, axis)
            state = _ShardState(sharded, n_rows, m, axis)

            def exec_replica(padded, st=state):
                return mnmg_knn(st.index, padded, self.k, metric=self.metric, mesh=st.mesh,
                                axis=st.axis, n_rows=st.n_rows, tile_n=self._tile_n,
                                precision=self._precision, merge=self.merge,
                                group_size=self._replica_group_size(st.mesh))

            members.append((m, exec_replica))
        breakers = [_breaker_from_knobs("%s/r%d" % (self.name, i), clock)
                    for i in range(len(members))]
        return ReplicaSet(self.name, members, hedge_s=self._hedge_s,
                          hedge_factor=self._hedge_factor, hedge_min_s=self._hedge_min_s,
                          breakers=breakers, clock=clock)

    def replica_rank_ids(self) -> Optional[set]:
        """Rank ids the replica set spans (None when not replicated); the
        session's ``health_check`` validates them against its mesh."""
        rs = self._replica_set
        return rs.rank_ids() if rs is not None else None

    def rebuild_replicas(self, mesh=None) -> bool:
        """Re-cut the replica groups over ``mesh`` (default: the owning
        session's current mesh), the replica-loss lever.  A mesh too small
        for two replicas degrades to plain sharded serving over the whole
        mesh (a later rebuild on a grown mesh restores the replicas).
        Fresh per-replica breakers.  Call ``warmup()`` after.  True when
        the mesh changed."""
        expects(self._n_replicas > 0, "%s.rebuild_replicas: service was not built with "
                "replicas", self.name)
        if mesh is None:
            session = getattr(self, "_session", None)
            comms = getattr(session, "comms", None)
            if comms is not None and self._replica_axis in comms.mesh.axis_names:
                mesh = comms.mesh
            else:
                mesh = self._replica_parent
        refuse_spanning(mesh, "%s.rebuild_replicas" % self.name)
        changed = mesh is not self._replica_parent
        n = min(self._n_replicas, int(mesh.size))
        self._replica_parent = mesh
        if n >= 2:
            self._spmd = None
            self._replica_set = self._build_replica_set(mesh, self._replica_axis, n,
                                                        self._clock)
        else:
            self._replica_set = None
            self._shard_to(mesh, self._replica_axis)
        if changed:
            _counter("raft_tpu_serve_repartitions_total",
                     "sharded-index re-partitions (shard-loss recovery)", self.name).inc()
            _shard_gauge(self.name, int(mesh.size))
            flight.record("repartition", service=self.name, devices=int(mesh.size),
                          replicas=(len(self._replica_set.replicas)
                                    if self._replica_set is not None else 0))
        return changed

    def warmup(self) -> "Service":
        rs = self._replica_set
        if rs is None:
            return super().warmup()
        # hedged dispatch may route any rung to any replica: warm them all
        with torch.cuda.stream(self.worker.stream):
            for rung in self.policy.rungs:
                rs.warm(torch.zeros((rung, self.dim), dtype=self.dtype, device=self.device))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._warmed = self.policy.rungs
        self._warm_kernels = _build.stats()
        return self

    def post_recover(self) -> None:
        """Re-partition onto the rebuilt session mesh (RecoveryManager
        step 4), keyed off the constructor's replica intent: a service
        degraded to unreplicated by a small survivor mesh regains its
        replicas when a later recovery regrows the mesh."""
        if self._n_replicas:
            self.rebuild_replicas()
        elif self.axis is not None:
            self.repartition()


class PairwiseService(Service):
    """Micro-batched :func:`pairwise_distance` against one pinned
    reference matrix; futures resolve to the ``(n_i, n_y)`` block."""

    def __init__(self, y,
                 metric: DistanceType = DistanceType.L2Expanded,
                 name: Optional[str] = None, device="cuda", **opts):
        dev = resolve_device(device)
        y = as_tensor(y, dev)
        expects(y.ndim == 2, "PairwiseService: (n, d) reference required")
        self.y = y
        self.metric = metric

        def execute(padded):
            return pairwise_distance(padded, self.y, self.metric, device=dev)

        super().__init__(
            name or "pairwise%d" % next(_service_seq), execute,
            dim=y.shape[1], dtype=y.dtype, device=dev, **opts)
