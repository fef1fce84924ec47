"""Serving layer: dynamic micro-batching query engine.

Port of ``raft_tpu/serve`` for the brute-force, pairwise and IVF paths,
on one device or sharded over a rank mesh.
Concurrent callers submit small query blocks; a per-service worker
coalesces them into one padded device call per shape bucket, so

- the shapes the kernels and the caching allocator see are bounded,
  and pre-warmed, by the bucket ladder
  (:mod:`~raft_tpu_torch.serve.bucketing`),
- device efficiency comes from batch fill rather than per-call
  dispatch (:mod:`~raft_tpu_torch.serve.batcher`, which also holds the
  weighted-fair tenants and EDF ordering),
- overload is shed at admission and deadlines expire in-queue, and
  batch N+1 launches while batch N still runs on the card
  (:mod:`~raft_tpu_torch.serve.scheduler`),
- facades own warmup / drain / close lifecycle and the optional
  query-vector cache (:mod:`~raft_tpu_torch.serve.service`), and
  :class:`ANNService` serves an IVF-Flat index with streaming ingestion,
  compaction and recall-targeted probe counts
  (:mod:`~raft_tpu_torch.serve.ann_service`),
- the serving failure contract — serve-seam fault injection, the
  per-service circuit breaker and the :class:`RecoveryManager` —
  lives in :mod:`~raft_tpu_torch.serve.resilience`, and replica groups
  with hedged dispatch (``KNNService(replicas=...)``) in
  :mod:`~raft_tpu_torch.serve.replicas`.

Every layer records into the flight recorder
(:mod:`raft_tpu_torch.core.flight`): each admitted request carries a
trace_id and ``ServeFuture.trace()`` returns its complete timeline.

The embedded ops plane (:class:`OpsPlane`, a pull endpoint for
scrapers: ``/metrics``, ``/healthz``, ``/statusz``, ``/debug/*``) lives in
:mod:`~raft_tpu_torch.serve.opsplane`, and the anomaly sentinel that
watches the services' vitals (:class:`AnomalySentinel`) in
:mod:`~raft_tpu_torch.serve.sentinel`.
"""

from raft_tpu_torch.serve.ann_service import ANNService  # noqa: F401
from raft_tpu_torch.serve.batcher import MicroBatcher, ServeFuture  # noqa: F401
from raft_tpu_torch.serve.bucketing import (  # noqa: F401
    BucketPolicy,
    coalesce,
    pad_rows,
    resolve_rungs,
    split_rows,
)
from raft_tpu_torch.serve.opsplane import OpsPlane  # noqa: F401
from raft_tpu_torch.serve.replicas import (  # noqa: F401
    ReplicaFaultInjector,
    ReplicaSet,
    inject_replica,
    split_mesh,
)
from raft_tpu_torch.serve.resilience import (  # noqa: F401
    BreakerState,
    CircuitBreaker,
    RecoveryManager,
    ServeFaultInjector,
    inject_worker,
)
from raft_tpu_torch.serve.scheduler import ServeWorker  # noqa: F401
from raft_tpu_torch.serve.sentinel import AnomalySentinel  # noqa: F401
from raft_tpu_torch.serve.service import (  # noqa: F401
    KNNService,
    PairwiseService,
    Service,
)

__all__ = [
    "BucketPolicy", "resolve_rungs", "pad_rows", "coalesce", "split_rows",
    "MicroBatcher", "ServeFuture", "ServeWorker",
    "Service", "KNNService", "PairwiseService", "ANNService",
    "BreakerState", "CircuitBreaker", "ServeFaultInjector", "inject_worker",
    "RecoveryManager", "ReplicaSet", "split_mesh", "inject_replica", "ReplicaFaultInjector",
    "OpsPlane", "AnomalySentinel",
]
