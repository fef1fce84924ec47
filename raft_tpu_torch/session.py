"""Cluster session orchestration: the Dask ``Comms`` lifecycle over a rank mesh.

Port of ``raft_tpu/session.py`` (reference python/raft/dask/common/comms.py:
the ``Comms`` session object, :37, runs ``_func_init_all`` on every
worker, :414-460, to set up the communicator and
``inject_comms_on_handle``, keeps a per-worker state dict,
``get_raft_comm_state`` :266, and tears everything down in ``destroy``;
``local_handle(sessionId)``, :247, fetches a worker's handle).

Inside a process the port is single-controller like the JAX package:
"workers" are the rank slots of a :class:`~raft_tpu_torch.comms.mesh.Mesh`,
driven by one process; several slots may share a card, so a world of 4
runs on one H100.  Across processes (``coordinator_address``,
``num_processes``, ``process_id``: one process a card over
``torch.distributed``, :mod:`raft_tpu_torch.comms.dist`) every process
runs the same session: the bootstrap brings up the process group under
``bootstrap_retry_policy``, the processes exchange their local slots,
and the session spans them (every process's local slots in process
order, ids their flat positions), as ``jax.distributed`` spans hosts in
the JAX package.  ``mesh=`` then names this process's slots (the JAX
``mesh=`` is global; torch cannot name another process's device).  The
payload backend is NCCL where every slot is on its own process's card,
gloo otherwise (one card shared by two processes, or the CPU); it shows
in :meth:`Comms.worker_info` and :meth:`Comms.health_check`.  Ownership
is the JAX package's: a group the user brought up is adopted and never
torn down; one the session brought up is torn down by :meth:`destroy`,
or at once when ``init()`` fails after the bootstrap.

Resilience: the session is the recovery authority.  :meth:`Comms.health_check`
runs the :mod:`~raft_tpu_torch.comms.selftest` battery plus a per-rank
liveness probe (:meth:`HostComms.probe_rank`: a scalar round trip on
the rank's device through the communicator's execute seam), and
:meth:`Comms.recover` rebuilds a fresh communicator on the surviving
ranks and re-injects it on every registered handle.  Ranks are named by
their ids or :class:`~raft_tpu_torch.comms.mesh.Rank` objects, never by
their device, since slots share devices.  On a card, where a rank's
slot shares the device with the others, a rank is lost through the fault
seam: ``faults.inject(session.comms, faults.Abort(rank=r))`` aborts the
communicator on the rank's next verb and makes its probe fail while the
others answer, which is what ``health_check`` reports and ``recover``
(with no explicit survivors) acts on.

Observability: :meth:`Comms.serve_ops` starts the embedded ops plane
(:class:`~raft_tpu_torch.serve.opsplane.OpsPlane`) over the session's
services, and :meth:`destroy` closes it before it drains them;
:func:`metrics_snapshot` carries the kernel cost inventory
(:mod:`raft_tpu_torch.core.inventory`).
"""

from __future__ import annotations

import json
import uuid
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from raft_tpu_torch.comms import HostComms, default_mesh, dist, selftest
from raft_tpu_torch.comms.mesh import Mesh, Rank, as_mesh
from raft_tpu_torch.comms.resilience import RetryPolicy
from raft_tpu_torch.core import flight as _flight
from raft_tpu_torch.core import inventory as _inventory
from raft_tpu_torch.core import metrics as _metrics
from raft_tpu_torch.core import profiler as _profiler
from raft_tpu_torch.core import tracing
from raft_tpu_torch.core.error import CommError, expects, fail
from raft_tpu_torch.core.handle import Handle

# module-level session registry (the reference keeps worker-local state
# dicts keyed by sessionId, comms.py:266)
_sessions: Dict[str, "Comms"] = {}


def _distributed_is_initialized() -> bool:
    """Whether this process already has a ``torch.distributed`` group."""
    return dist.is_initialized()


def inject_comms_on_handle(handle: Handle, comms: HostComms) -> None:
    """Attach an initialised communicator to a handle (reference
    comms_utils.pyx inject_comms_on_handle -> helper.hpp:39)."""
    handle.set_comms(comms)
    handle.mesh = comms.mesh


class Comms:
    """Communicator session over a rank mesh (reference Comms,
    python/raft/dask/common/comms.py:37).

    Parameters
    ----------
    comms_p2p:
        Whether tagged p2p will be used (the reference's UCX flag; here
        informational: p2p rides the same communicator).
    mesh:
        Rank mesh to span; default: one rank a visible card
        (:func:`~raft_tpu_torch.comms.mesh.default_mesh`), or one CPU rank
        with ``device="cpu"``.  In a multi-process session, this
        process's slots (1-D), which the session joins into the mesh that
        spans every process.
    coordinator_address / num_processes / process_id:
        The multi-process bootstrap (:func:`raft_tpu_torch.comms.dist.initialize`):
        ``host:port`` of the store process 0 serves, the process count and
        this process's index.  Leave None for one process.
    retry_policy:
        Optional :class:`~raft_tpu_torch.comms.resilience.RetryPolicy` for
        every eager verb of the session's communicator (and its
        ``comm_split`` children), the default of the services it serves,
        and, unless ``bootstrap_retry_policy`` overrides it, of the
        bootstrap.  None: fail on the first error.
    bootstrap_retry_policy:
        Optional separate policy for the bootstrap, whose failures are
        transient (a peer not up yet) where a verb's timeout should be
        fatal; each attempt's waits end inside its ``timeout``.
    device:
        The kind of the default mesh (``"cuda"`` unless ``"cpu"``).
    """

    def __init__(self, comms_p2p: bool = False, mesh: Optional[Mesh] = None,
                 coordinator_address: Optional[str] = None,
                 num_processes: Optional[int] = None,
                 process_id: Optional[int] = None,
                 retry_policy: Optional[RetryPolicy] = None,
                 bootstrap_retry_policy: Optional[RetryPolicy] = None,
                 verbose: bool = False, device="cuda"):
        self.comms_p2p = comms_p2p
        self.sessionId = uuid.uuid4().hex
        self._mesh = as_mesh(mesh) if mesh is not None else None
        self._device = device
        self._coordinator = coordinator_address
        self._num_processes = num_processes
        self._process_id = process_id
        self.retry_policy = retry_policy
        self.bootstrap_retry_policy = (bootstrap_retry_policy
                                       if bootstrap_retry_policy is not None else retry_policy)
        self._owns_distributed = False
        self._group: Optional[dist.ProcessGroup] = None
        self.verbose = verbose
        self.initialized = False
        self.comms: Optional[HostComms] = None
        self.handle: Optional[Handle] = None
        self._handles: List[Handle] = []
        self._services: Dict[str, object] = {}
        self._ops_plane = None

    # -- lifecycle (reference init/destroy, comms.py:171,228) ---------- #
    def _bootstrap_distributed(self) -> None:
        """Join the process group (the NCCL-uid-exchange analog), retried
        under the bootstrap policy: a peer that is not up yet is the most
        transient failure a cluster has, and each attempt's waits end
        inside the policy's timeout, so a black-holed connect cannot hang
        bring-up."""
        if _distributed_is_initialized():
            # a group the user brought up: use it, never own it (destroy()
            # must not tear down what this session did not create)
            return
        expects(self._num_processes is not None and self._process_id is not None,
                "Comms: coordinator_address= needs num_processes= and process_id=")
        policy = self.bootstrap_retry_policy
        attempt_s = (0.8 * policy.timeout if policy is not None and policy.timeout
                     else dist.GROUP_TIMEOUT_S)

        def connect():
            # idempotency guard for the retry path: an attempt abandoned
            # by the watchdog may still land the group after its deadline;
            # a retry that finds it up takes that as success (the group
            # was down before the first attempt, so it is ours to own)
            if _distributed_is_initialized():
                return
            dist.initialize(self._coordinator, self._num_processes, self._process_id,
                            timeout_s=attempt_s)

        if policy is None:
            connect()
        else:
            try:
                policy.call(connect, verb="bootstrap")
            except Exception as e:
                raise CommError(
                    "multi-host bootstrap to %s failed after %d attempts: %s"
                    % (self._coordinator, policy.max_retries + 1, e)) from e
        self._owns_distributed = True

    def _span(self, local: Mesh) -> Mesh:
        """The mesh over every process's slots, ``local`` this process's."""
        if self._num_processes is not None and self._process_id is not None:
            world, rank = int(self._num_processes), int(self._process_id)
        else:
            world, rank = torch.distributed.get_world_size(), torch.distributed.get_rank()
        self._group = dist.ProcessGroup.create([r.device for r in local.rank_list()], rank,
                                               world)
        return self._group.span(local)

    def init(self) -> "Comms":
        if self.initialized:
            return self
        if self._coordinator is not None:
            self._bootstrap_distributed()
        try:
            # self._mesh stays this process's part: a re-init spans it again
            self._mesh = self._mesh if self._mesh is not None else default_mesh(
                device=self._device)
            mesh = self._mesh if self._coordinator is None else self._span(self._mesh)
            self.comms = HostComms(mesh, retry_policy=self.retry_policy)
            self.handle = Handle(device=mesh.home(), mesh=mesh)
            self.register_handle(self.handle)
        except Exception:
            # failure after a successful bootstrap: release the owned
            # group now (a context manager's __exit__ never runs when
            # __enter__ raises, and a leaked group would be adopted,
            # unowned, by the next session of this process)
            self.destroy()
            raise
        _sessions[self.sessionId] = self
        self.initialized = True
        if self.verbose:
            print("Initialized comms session %s over %d ranks" % (self.sessionId, mesh.size))
        return self

    def register_handle(self, handle: Handle) -> Handle:
        """Inject the session communicator on ``handle`` and track it so
        :meth:`recover` re-injects after a rebuild."""
        expects(self.comms is not None, "register_handle: session has no communicator")
        inject_comms_on_handle(handle, self.comms)
        if handle not in self._handles:
            self._handles.append(handle)
        return handle

    def destroy(self) -> None:
        """Tear down and deregister (reference destroy, comms.py:228).

        The ops plane goes first (scrapers stop reading service state
        before the services it reports on are drained), then services
        registered through :meth:`serve` are drained and closed (bounded):
        an in-flight batch must finish before the communicator it may use
        goes away.  Idempotent, and the registry
        entry is removed in a ``finally``, so a teardown failure never
        leaves a dead session shadowing a later one."""
        if not self.initialized:
            # a bootstrap that succeeded before a later init() failure
            # still owns the group: release it here
            try:
                self._teardown()
            finally:
                _sessions.pop(self.sessionId, None)
            return
        try:
            plane, self._ops_plane = self._ops_plane, None
            if plane is not None:
                try:
                    plane.close()
                except Exception:
                    pass
            for svc in list(self._services.values()):
                try:
                    svc.close(drain=True, timeout=10.0)
                except Exception:
                    pass
            self._teardown()
        finally:
            self.comms = None
            self.handle = None
            self._handles = []
            self._services = {}
            self.initialized = False
            _sessions.pop(self.sessionId, None)
            # the shared zeros cache (serve pad tails, p2p blanks) has no
            # owner of its own: session teardown releases it
            from raft_tpu_torch.mr.buffer import default_zeros_pool

            default_zeros_pool().release()

    def _teardown(self) -> None:
        """Leave the process group when this session brought it up."""
        self._group = None
        if self._owns_distributed:
            self._owns_distributed = False
            try:
                dist.shutdown()
            except Exception:
                pass

    @property
    def backend(self) -> Optional[str]:
        """The payload backend across processes (``"nccl"`` or
        ``"gloo"``, :func:`raft_tpu_torch.comms.dist.choose_backend`);
        None for a session of one process."""
        return self._group.backend if self._group is not None else None

    # -- health / recovery --------------------------------------------- #
    def health_check(self) -> Dict:
        """Run the self-test battery plus the per-rank liveness probes.

        Returns ``{"ok": bool, "tests": {name: bool}, "ranks": {rank_id:
        bool}, "backend": ...}`` (the JAX package keys its probes
        ``"devices"`` by device id; here a rank is not a device).  Ranks of
        other processes report live, as the JAX package's do: a dead
        process is the group's to detect.  On an aborted communicator every
        collective verdict is False while the probes still report which
        ranks could carry a rebuilt communicator: the input :meth:`recover`
        needs.  With services registered (:meth:`serve`) it also carries
        ``"services"``: each service's ``stats()`` with ``mesh_ok`` for a
        sharded or replicated one (its ranks still in the session mesh);
        an open service whose worker died, whose breaker is open or whose
        mesh is stale fails ``ok``."""
        expects(self.initialized, "health_check: session not initialized")
        with tracing.event("comms.health_check", "session=%s", self.sessionId):
            tests = selftest.run_all(self.comms)
            ranks = {r.id: self.comms.probe_rank(pos) for pos, r in enumerate(self.comms.ranks)}
        ok = all(tests.values()) and all(ranks.values())
        out = {"ok": ok, "tests": tests, "ranks": ranks, "backend": self.backend}
        blackboxes = _flight.default_recorder().blackbox_summaries()
        if blackboxes:
            out["flight_blackboxes"] = blackboxes
        if self._services:
            mesh_ranks = set(self.comms.mesh.rank_ids())
            services = {}
            for name, svc in self._services.items():
                s = svc.stats()
                replica_ids = None
                if callable(getattr(svc, "replica_rank_ids", None)):
                    replica_ids = svc.replica_rank_ids()
                if replica_ids is not None:
                    s["mesh_ok"] = replica_ids <= mesh_ranks
                elif getattr(svc, "axis", None) is not None:
                    s["mesh_ok"] = (svc.axis in self.comms.mesh.axis_names
                                    and set(svc.mesh.rank_ids()) <= mesh_ranks)
                services[name] = s
            out["services"] = services

            def _service_ok(s):
                if not s["open"]:
                    return True
                if s["worker_started"] and not s["worker_alive"]:
                    return False
                if s.get("mesh_ok") is False:
                    return False
                if s.get("persist", {}).get("corruption_detected"):
                    return False
                br = s.get("breaker")
                return not (br and br.get("state") == "open")

            out["ok"] = ok and all(_service_ok(s) for s in services.values())
        return out

    def recover(self, devices: Optional[Sequence] = None, mesh: Optional[Mesh] = None
                ) -> HostComms:
        """Rebuild a fresh communicator on the surviving ranks and
        re-inject it on every registered handle.

        ``devices`` names the survivors: rank ids (the keys of
        :meth:`health_check`'s ``"ranks"``), :class:`Rank` objects of the
        session mesh, or a ``torch.device`` that exactly one rank holds;
        None probes every rank and keeps those that answer.  The
        automatic rebuild is a 1-D mesh over the comms axis, so a session
        on a mesh of several axes must pass the replacement ``mesh``.  The
        old communicator (typically latched aborted) is discarded; the new
        one spans only survivors, so consumers resume at reduced width."""
        expects(self.initialized, "recover: session not initialized")
        expects(devices is None or mesh is None,
                "recover: pass either devices or mesh, not both: an explicit mesh "
                "already names its ranks")
        axis = self.comms.axis
        old = self.comms.mesh
        if mesh is None:
            expects(len(old.axis_names) == 1,
                    "recover: automatic rebuild only supports 1-D meshes; session mesh has "
                    "axes %s: pass the replacement mesh explicitly", tuple(old.axis_names))
            if devices is None:
                devices = [r for pos, r in enumerate(self.comms.ranks)
                           if self.comms.probe_rank(pos)]
            survivors = [self._resolve_rank(old, d) for d in devices]
            expects(len(survivors) >= 1, "recover: no surviving ranks")
            mesh = old.submesh(survivors, (axis,))
        else:
            mesh = as_mesh(mesh)
            expects(axis in mesh.axis_names, "recover: replacement mesh lacks comms axis %s",
                    axis)
        with tracing.event("comms.recover", "session=%s survivors=%d", self.sessionId,
                           mesh.size):
            # carry the communicator's configuration across the rebuild
            self.comms = HostComms(mesh, axis, retry_policy=self.retry_policy,
                                   p2p_staging=self.comms.p2p_staging)
            if mesh.group is None:
                self._mesh = mesh
            for h in self._handles:
                inject_comms_on_handle(h, self.comms)
        if self.verbose:
            print("Recovered comms session %s on %d surviving ranks"
                  % (self.sessionId, mesh.size))
        return self.comms

    @staticmethod
    def _resolve_rank(mesh: Mesh, d) -> Rank:
        by_id = {r.id: r for r in mesh.ranks.ravel()}
        if isinstance(d, Rank):
            expects(by_id.get(d.id) is d, "recover: rank %r not in the session mesh", d)
            return d
        if isinstance(d, torch.device):
            holders = [r for r in mesh.ranks.ravel() if r.is_local and r.device == d]
            expects(len(holders) == 1, "recover: device %s holds %d ranks of the session "
                    "mesh; name ranks by id", d, len(holders))
            return holders[0]
        key = d if isinstance(d, int) and not isinstance(d, bool) else getattr(d, "id", None)
        expects(key in by_id and (isinstance(d, int) or isinstance(d, Rank)),
                "recover: rank %r not in the session mesh", d)
        return by_id[key]

    def self_heal(self, **recover_kwargs) -> Dict:
        """Health-check, and if anything is wrong (aborted communicator,
        dead rank, dead worker thread, tripped breaker) run the serving
        recovery sequence (:class:`raft_tpu_torch.serve.resilience.RecoveryManager`).
        Returns ``{"report", "recovered", "recovery"}``.  Call it from a
        supervising thread, never from a serve worker."""
        expects(self.initialized, "self_heal: session not initialized")
        from raft_tpu_torch.serve.resilience import RecoveryManager

        return RecoveryManager(self).check_and_recover(**recover_kwargs)

    # -- serving ------------------------------------------------------- #
    def serve(self, kind: str = "knn", *, name: Optional[str] = None, **kwargs):
        """Construct and register a micro-batching service on this
        session: ``"knn"`` (:class:`~raft_tpu_torch.serve.KNNService`),
        ``"pairwise"`` (:class:`~raft_tpu_torch.serve.PairwiseService`) or
        ``"ann"`` (:class:`~raft_tpu_torch.serve.ANNService`), with their
        keyword arguments.  ``retry_policy`` defaults to the session's; a
        sharded (``axis=``) or replicated (``replicas=``) service spans
        the session mesh unless given one, and ``device`` defaults to the
        session's first rank's.  Registration buys the lifecycle:
        :meth:`health_check` reports the service, :meth:`destroy` drains
        it, and a recovery re-partitions it onto the rebuilt mesh
        (``post_recover``).  The service is started; call ``warmup()``
        before traffic."""
        expects(self.initialized, "serve: session not initialized")
        from raft_tpu_torch.serve import ANNService, KNNService, PairwiseService

        kinds = {"knn": KNNService, "pairwise": PairwiseService, "ann": ANNService}
        expects(kind in kinds, "serve: unknown service kind %r (have: %s)", kind,
                ", ".join(sorted(kinds)))
        expects(name is None or name not in self._services,
                "serve: a service named %r is already registered", name)
        kwargs.setdefault("retry_policy", self.retry_policy)
        kwargs.setdefault("device", self.comms.home)
        if ((kwargs.get("axis") is not None or kwargs.get("replicas") is not None)
                and kwargs.get("mesh") is None):
            kwargs["mesh"] = self.comms.mesh
        svc = kinds[kind](name=name, **kwargs)
        svc._session = self
        if svc.name in self._services:
            svc.close(drain=False)
            fail("serve: a service named %r is already registered", svc.name)
        self._services[svc.name] = svc
        return svc

    @property
    def services(self) -> Dict[str, object]:
        """Registered services by name (read-only view)."""
        return dict(self._services)

    def serve_ops(self, port: int = 0, **kwargs):
        """Start the embedded ops plane over this session: an HTTP
        endpoint on a daemon thread serving ``/metrics``, ``/healthz``
        (``?full=1`` runs :meth:`health_check` behind a TTL cache),
        ``/statusz``, ``/debug/traces``, ``/debug/config``,
        ``/debug/inventory``, ``/debug/snapshot`` and ``POST
        /debug/blackbox`` (:mod:`raft_tpu_torch.serve.opsplane`).

        ``port=0`` binds an ephemeral port (read ``plane.port``);
        ``kwargs`` go to :class:`~raft_tpu_torch.serve.opsplane.OpsPlane`
        (``host=``, ``sentinel=``, ``healthz_ttl_s=``, ...).  One live
        plane a session; :meth:`destroy` closes it before draining the
        services."""
        expects(self.initialized, "serve_ops: session not initialized")
        # a manually closed plane must not brick the session: only a
        # live plane blocks a second one
        expects(self._ops_plane is None or self._ops_plane.closed,
                "serve_ops: this session already has a live ops plane (close it first)")
        from raft_tpu_torch.serve.opsplane import OpsPlane

        self._ops_plane = OpsPlane(session=self, port=port, **kwargs)
        return self._ops_plane

    @property
    def ops_plane(self):
        """The session's live ops plane, or None."""
        return self._ops_plane

    # -- observability ------------------------------------------------- #
    def metrics_snapshot(self) -> Dict:
        """The process's observability artifact (:func:`metrics_snapshot`)."""
        return metrics_snapshot()

    def dump_metrics(self, path: str) -> Dict:
        """Write :meth:`metrics_snapshot` as JSON to ``path``; returns it."""
        snap = self.metrics_snapshot()
        with open(path, "w", encoding="utf-8") as f:
            json.dump(snap, f, indent=2, sort_keys=True, default=str)
            f.write("\n")
        return snap

    def worker_info(self, workers=None) -> Dict:
        """Rank map per "worker" (reference Comms.worker_info, comms.py:154):
        keyed by rank id, each with its communicator rank (its coordinate
        along the comms axis), its coordinates on every mesh axis, the
        index of the process that owns it, its device (a rank of another
        process: its owner's description, ``"cuda:0@process 1"``),
        platform and device kind (a remote rank's from the bootstrap's
        exchange), and the session's payload backend.  ``workers``
        restricts to those rank ids."""
        expects(self.initialized, "worker_info: session not initialized")
        mesh = self.comms.mesh
        axis_idx = mesh.axis_names.index(self.comms.axis)
        info = {}
        for coords in np.ndindex(*mesh.ranks.shape):
            r = mesh.ranks[coords]
            if workers is not None and r.id not in workers:
                continue
            slot = (dist.describe_slot(r.device) if r.is_local
                    else mesh.group.slot_of(r.id))
            info[r.id] = {"rank": int(coords[axis_idx]),
                          "mesh_coords": dict(zip(mesh.axis_names, map(int, coords))),
                          "process_index": r.process,
                          "device": str(r.device) if r.is_local else r.desc,
                          "platform": slot["type"],
                          "device_kind": slot["name"],
                          "backend": self.backend}
        return info

    def __enter__(self) -> "Comms":
        return self.init()

    def __exit__(self, *exc) -> None:
        self.destroy()


# the observability surface names the session object "Session"; ``Comms``
# keeps the reference's name: the same class
Session = Comms


def metrics_snapshot() -> Dict:
    """Process-global observability snapshot: the flight recorder's state
    (taken first: it publishes the SLO gauges), the metrics registry, the
    profiler's span tree and report, the resilience event counters, and
    the kernel cost inventory (summary plus ``detail``).  The JAX
    package's compile-cache section has no counterpart: there is no
    compile cache to report (the kernels' build counts are
    :func:`raft_tpu_torch.ops._build.stats`)."""
    fl = _flight.flight_snapshot()
    inv = _inventory.summary()
    inv["detail"] = _inventory.snapshot()
    return {
        "metrics": _metrics.default_registry().snapshot(),
        "profiler_tree": _profiler.default_profiler().tree(),
        "profiler_report": _profiler.default_profiler().report(),
        "event_counters": tracing.counters(),
        "flight": fl,
        "inventory": inv,
    }


def get_raft_comm_state(session_id: str) -> Dict:
    """Session state dict (reference get_raft_comm_state, comms.py:266)."""
    s = _sessions.get(session_id)
    if s is None:
        return {}
    return {"sessionId": s.sessionId, "comms": s.comms, "handle": s.handle,
            "nworkers": s.comms.get_size()}


def local_handle(session_id: str) -> Handle:
    """Fetch the session's injected handle (reference local_handle,
    comms.py:247)."""
    s = _sessions.get(session_id)
    expects(s is not None and s.initialized, "local_handle: no initialized session %s",
            session_id)
    return s.handle
