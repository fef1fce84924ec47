"""Process-level serving fleet: a router and worker processes.

Port of ``raft_tpu/fleet``: the fault-domain layer that keeps tenants
served when a process dies.  Each worker process serves a shard (or a
replica) of an IVF-Flat index through
:class:`~raft_tpu_torch.serve.ANNService` on its device (``"cuda"``
unless its spec says ``"cpu"``), keeps its state in a write-ahead log
and snapshots, and heals from a ``kill -9``.  The pieces:

- :mod:`raft_tpu_torch.fleet.protocol` — the JSON-over-HTTP wire format,
  typed-error round-tripping, rendezvous placement, top-k merge.
- :mod:`raft_tpu_torch.fleet.router` — the front-end router (host-side
  only): placement, admission, retry and hedging, shard fan-out and
  merge, heartbeat leases with typed eviction, and the aggregated
  ``/fleet/metrics`` and ``/fleet/healthz`` scrape surface.
- :mod:`raft_tpu_torch.fleet.worker` — the worker process: builds (or
  crash-restores) its service, binds its data plane and ops plane on
  ephemeral ports, registers with the router, and heartbeats.
- :mod:`raft_tpu_torch.fleet.supervisor` — spawns, kills, restarts and
  drains worker processes; builds the kernels once before spawning.
- :mod:`raft_tpu_torch.fleet.chaos` — the seeded process-fault harness
  (SIGKILL, hang, slow join, dropped or garbled frames, fsync stall).
- :mod:`raft_tpu_torch.fleet.tracing` — the cross-process trace join.
"""

from raft_tpu_torch.fleet.router import Router
from raft_tpu_torch.fleet.supervisor import Fleet, WorkerSpec

__all__ = ["Router", "Fleet", "WorkerSpec"]
