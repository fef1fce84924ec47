"""The process group: one process a card over ``torch.distributed``.

Port only (the JAX package's counterpart is ``jax.distributed``: its
coordination service plays the NCCL-uid bootstrap role, and one
``HostComms`` spans every process, ``raft_tpu/comms/host_comms.py:1-12``).
The port keeps that design.  Inside a process the single-controller rank
mesh (:mod:`raft_tpu_torch.comms.mesh`) drives the process's slots, several
on one card if need be; across processes this module adds a
``torch.distributed`` group, and every process builds the same spanning
mesh: every process's local slots concatenated in process order, ids
their flat positions.  Every process makes the same calls with the same
rank-major inputs, acts only on the rows of its own ranks, and ends with
the whole rank-major result, as the JAX ``process_allgather`` gives.

**Bootstrap** (:func:`initialize`, the seam the session's retry policy
wraps and the tests replace).  The coordinator address names a
``TCPStore`` that process 0 serves; every process writes its join key
and waits, bounded, for all of them, then ``init_process_group`` runs
once on the store.  A retried ``init_process_group(init_method="tcp://")``
cannot meet a peer that joins late: each failed attempt advances the
process's group counter, and processes on different attempts wait on
different keys.  So an attempt here retries the store connection and the
join wait, both idempotent (the store is kept across attempts), and the
group is made only when every process is known to be there.  Each wait
ends by itself inside the attempt's budget, before a watchdog would
abandon it.  One attempt runs at a time in a process: an attempt the
watchdog abandoned inside ``init_process_group`` (a slow peer) runs on
to its end, and the next attempt waits for it, within its own budget,
and takes a group it brought up as its own success; two
``init_process_group`` calls never overlap.  Process 0 binds the
coordinator's port; a bind that fails ("address in use") is an attempt
that failed, and the policy retries it.

**The backend rule** (:func:`choose_backend`), decided once from the
topology the processes exchange when the session spans its local mesh
(every process's slots, each card named by its UUID), never by trying
one backend and catching its failure: NCCL when every slot of every
process is on CUDA and no card is held by two processes; gloo otherwise
(on the CPU, and when processes share a card, which NCCL refuses as a
duplicate GPU).  A gloo group is always the control plane (the topology
exchange, barriers); an NCCL group is added for payloads when the rule
allows.  Gloo carries CUDA payloads through the host: the copies are
explicit, and their bytes count under
``raft_tpu_comms_host_staged_bytes{verb=}``.  The NCCL route needs a
machine with two or more cards, one for each process.

**Exactness.**  Every verb that crosses processes is one exchange of each
process's local rows (:meth:`ProcessGroup.exchange`: an ``all_gather`` of
one byte buffer a process, the rows in rank-id order), after which every
process runs the single-controller arithmetic in rank order on its own
device.  So a result is bitwise the one a world of the same slots gives
in one process.  A reduction gathers the rows and folds them locally in
rank order; it never calls an NCCL or gloo ``all_reduce``, whose order
of summation is the library's.  A wire-efficient reduce (and a ring on
the wire) is performance work (``ROADMAP.md``).

**Teardown** (:func:`shutdown`): a bounded barrier, so no process
closes its sockets while a peer still reads, then
``destroy_process_group``.  A process that dies mid-verb is the group's
to detect: its peers' verbs end at the group's timeout
(:data:`GROUP_TIMEOUT_S`), and the communicator latches aborted.
"""

from __future__ import annotations

import datetime
import math
import threading
import time
from typing import Dict, List, Optional, Sequence

import torch

from raft_tpu_torch.core import metrics as _metrics
from raft_tpu_torch.core.error import expects, fail

__all__ = ["GROUP_TIMEOUT_S", "ProcessGroup", "Remote", "choose_backend", "describe_slot",
           "initialize", "is_initialized", "process_index", "shutdown"]

GROUP_TIMEOUT_S = 60.0       # every verb and barrier of the group ends within this
_JOIN_KEY = "raft_tpu/joined/%d"
_ALIGN = 8                   # each row's bytes start 8-aligned in an exchange buffer

# the bootstrap's store, kept across the attempts of one bootstrap (the
# process group it serves is itself process-global in torch.distributed)
_bootstrap: Dict[str, object] = {"store": None, "key": None}
_attempt_lock = threading.Lock()     # one bootstrap attempt at a time (module doc)


def is_initialized() -> bool:
    """Whether this process has a default ``torch.distributed`` group."""
    return torch.distributed.is_available() and torch.distributed.is_initialized()


def process_index() -> int:
    """This process's index in its group (0 without one)."""
    return torch.distributed.get_rank() if is_initialized() else 0


def _seconds(s: float) -> datetime.timedelta:
    return datetime.timedelta(seconds=float(s))


def initialize(coordinator_address: str, num_processes: int, process_id: int,
               timeout_s: float = GROUP_TIMEOUT_S) -> None:
    """One bootstrap attempt (module doc): connect to (process 0: serve)
    the store at ``coordinator_address`` (``host:port``), write this
    process's join key, wait for every process's, then bring up the
    default gloo group on the store.  The connection and the wait end
    within ``timeout_s``; the group's verbs within :data:`GROUP_TIMEOUT_S`."""
    host, sep, port = str(coordinator_address).rpartition(":")
    expects(sep == ":" and host and port.isdigit(),
            "initialize: coordinator_address %r is not host:port", coordinator_address)
    num_processes, process_id = int(num_processes), int(process_id)
    expects(num_processes >= 1 and 0 <= process_id < num_processes,
            "initialize: process_id %d out of range for %d processes", process_id,
            num_processes)
    deadline = time.monotonic() + float(timeout_s)
    if not _attempt_lock.acquire(timeout=float(timeout_s)):
        raise RuntimeError("initialize: an earlier bootstrap attempt is still running")
    try:
        if is_initialized():
            return          # an earlier, abandoned attempt brought the group up
        key = (host, int(port), num_processes, process_id)
        store = _bootstrap["store"] if _bootstrap["key"] == key else None
        if store is None:
            left = max(deadline - time.monotonic(), 0.001)
            store = torch.distributed.TCPStore(host, int(port), num_processes,
                                               process_id == 0, timeout=_seconds(left),
                                               wait_for_workers=False)
            _bootstrap.update(store=store, key=key)
        store.set(_JOIN_KEY % process_id, "1")
        left = max(deadline - time.monotonic(), 0.001)
        store.wait([_JOIN_KEY % p for p in range(num_processes)], _seconds(left))
        torch.distributed.init_process_group(
            "gloo", store=torch.distributed.PrefixStore("raft_tpu", store), rank=process_id,
            world_size=num_processes, timeout=_seconds(GROUP_TIMEOUT_S))
    finally:
        _attempt_lock.release()


def shutdown() -> None:
    """Leave the group this process brought up: a bounded barrier, then
    ``destroy_process_group``; the bootstrap's store is dropped."""
    try:
        if is_initialized():
            if torch.distributed.get_world_size() > 1:
                try:
                    torch.distributed.monitored_barrier(timeout=_seconds(GROUP_TIMEOUT_S))
                except RuntimeError:
                    pass        # a peer already gone: leave all the same
            torch.distributed.destroy_process_group()
    finally:
        _bootstrap.update(store=None, key=None)


# --------------------------------------------------------------------- #
# topology and the backend rule
# --------------------------------------------------------------------- #
def describe_slot(device: torch.device) -> dict:
    """What other processes learn of one local slot: its device's type,
    index, card UUID and name (``"cpu"`` for the CPU)."""
    if device.type != "cuda":
        return {"type": device.type, "index": device.index, "uuid": None, "name": "cpu"}
    p = torch.cuda.get_device_properties(device)
    return {"type": "cuda", "index": device.index, "uuid": str(p.uuid), "name": p.name}


def choose_backend(topology: Sequence[Sequence[dict]]) -> str:
    """The payload backend for a topology (one list of
    :func:`describe_slot` entries a process): ``"nccl"`` when every slot
    is on CUDA and no card is held by two processes, else ``"gloo"``."""
    owner: Dict[str, int] = {}
    slots = 0
    for p, proc in enumerate(topology):
        for s in proc:
            slots += 1
            if s["type"] != "cuda" or owner.setdefault(s["uuid"], p) != p:
                return "gloo"
    return "nccl" if slots else "gloo"


class Remote:
    """A stand-in for a tensor another process holds: its shape and dtype,
    which every process can compute (SPMD), so an exchange needs no
    metadata round."""

    __slots__ = ("shape", "dtype")

    def __init__(self, shape, dtype: torch.dtype):
        self.shape = tuple(int(s) for s in shape)
        self.dtype = dtype

    def __repr__(self) -> str:
        return "Remote(%s, %s)" % (self.shape, self.dtype)


def _dtype(name: str) -> torch.dtype:
    return getattr(torch, name.rsplit(".", 1)[-1])


def _nbytes(shape, dtype) -> int:
    return math.prod(shape) * torch.empty((), dtype=dtype).element_size()


def _padded(n: int) -> int:
    return -(-n // _ALIGN) * _ALIGN


class ProcessGroup:
    """The processes a spanning mesh covers (module doc): this process's
    index (``rank``) and the count, every process's slots
    (``topology``), the payload backend, the device this process keeps
    what it receives on (``home``), and the exchange.  Made by
    :meth:`create` after the bootstrap."""

    def __init__(self, rank: int, world_size: int, topology: List[List[dict]], backend: str,
                 home: torch.device, control=None, payload=None):
        self.rank = int(rank)
        self.world_size = int(world_size)
        self.topology = topology
        self.backend = backend
        self.home = home
        self._control = control
        self._payload = payload
        self.stats = {"exchanges": 0, "seconds": 0.0, "bytes_sent": 0, "bytes_received": 0,
                      "host_staged_bytes": 0}

    @classmethod
    def create(cls, local_devices: Sequence[torch.device], rank: int,
               world_size: int) -> "ProcessGroup":
        """Exchange every process's slots over the control group (gloo),
        choose the backend by the rule, and add an NCCL group when it says
        so.  A world of one process exchanges nothing."""
        local = [describe_slot(d) for d in local_devices]
        expects(len(local) >= 1, "ProcessGroup: a process needs at least one slot")
        home = local_devices[0]
        if int(world_size) == 1:
            return cls(0, 1, [local], choose_backend([local]), home)
        dist = torch.distributed
        control = None if dist.get_backend() == "gloo" else dist.new_group(backend="gloo")
        topology: List[Optional[List[dict]]] = [None] * int(world_size)
        dist.all_gather_object(topology, local, group=control)
        backend = choose_backend(topology)
        payload = control
        if backend == "nccl":
            torch.cuda.set_device(home)
            payload = None if dist.get_backend() == "nccl" else dist.new_group(backend="nccl")
            # NCCL's communicator forms on its first collective: every
            # process takes part in this one
            dist.barrier(group=payload, device_ids=[home.index])
        return cls(rank, world_size, topology, backend, home, control, payload)

    # -- the spanning mesh -------------------------------------------- #
    def span(self, local_mesh):
        """The mesh over every process's slots (module doc) of which
        ``local_mesh`` (1-D) is this process's part; a world of one
        process gives ``local_mesh`` back."""
        from raft_tpu_torch.comms.mesh import Mesh, Rank

        expects(len(local_mesh.axis_names) == 1,
                "a multi-process session spans a 1-D local mesh; got axes %r",
                tuple(local_mesh.axis_names))
        if self.world_size == 1:
            return local_mesh
        local = local_mesh.rank_list()
        expects(len(local) == len(self.topology[self.rank]),
                "span: the local mesh has %d slots, the bootstrap exchanged %d", len(local),
                len(self.topology[self.rank]))
        ranks = []
        for p, proc in enumerate(self.topology):
            for j, slot in enumerate(proc):
                desc = "%s%s@process %d" % (slot["type"], "" if slot["index"] is None
                                            else ":%d" % slot["index"], p)
                dev = local[j].device if p == self.rank else None
                ranks.append(Rank(len(ranks), dev, process=p, desc=desc))
        return Mesh(ranks, local_mesh.axis_names, group=self)

    def slot_of(self, rank_id: int) -> dict:
        """The exchanged description of the slot with spanning id
        ``rank_id`` (ids are flat positions over the processes' slots)."""
        for proc in self.topology:
            if rank_id < len(proc):
                return proc[rank_id]
            rank_id -= len(proc)
        fail("slot_of: no slot with id %d in this group", rank_id)

    # -- the exchange ------------------------------------------------- #
    def _staging(self) -> torch.device:
        return self.home if self.backend == "nccl" else torch.device("cpu")

    def _count_staged(self, verb: str, n: int) -> None:
        if n:
            self.stats["host_staged_bytes"] += n
            _metrics.default_registry().counter(
                "raft_tpu_comms_host_staged_bytes", labels=("verb",),
                help="payload bytes bounced through the host").labels(verb=verb).inc(n)

    def exchange(self, items: Sequence, owners: Sequence[int], verb: str = "exchange") -> list:
        """Every process's items, on every process.

        ``items[j]`` is a tensor where this process owns it
        (``owners[j] == rank``), and elsewhere a :class:`Remote` (or None
        when its shape is not known here: one metadata round then
        resolves every None).  One ``all_gather`` of one byte buffer a
        process, its items in index order; returns the items with every
        remote one received onto :attr:`home` (local ones as given)."""
        expects(len(items) == len(owners), "exchange: %d items for %d owners", len(items),
                len(owners))
        t0 = time.perf_counter()
        me, dist = self.rank, torch.distributed
        specs: List[Optional[tuple]] = []
        for it, o in zip(items, owners):
            if o == me:
                expects(isinstance(it, torch.Tensor), "exchange: a local item must be a tensor")
                specs.append((tuple(it.shape), it.dtype))
            else:
                specs.append((it.shape, it.dtype) if isinstance(it, Remote) else None)
        if any(s is None for s in specs):
            mine = [(j, specs[j][0], str(specs[j][1])) for j, o in enumerate(owners) if o == me]
            got: List[Optional[list]] = [None] * self.world_size
            dist.all_gather_object(got, mine, group=self._control)
            for lst in got:
                for j, shape, name in lst:
                    specs[j] = (tuple(shape), _dtype(name))
        sizes = [_nbytes(*s) for s in specs]
        width = max(sum(_padded(sizes[j]) for j, o in enumerate(owners) if o == p)
                    for p in range(self.world_size))
        out = list(items)
        staging = self._staging()
        through_host = staging.type == "cpu" and self.home.type == "cuda"
        mine = [j for j, o in enumerate(owners) if o == me]
        if through_host and any(sizes[j] for j in mine):
            torch.cuda.synchronize(self.home)
            t0 = time.perf_counter()            # the local work is done: time the exchange
        if width:
            buf = torch.zeros(width, dtype=torch.uint8, device=staging)
            off = 0
            for j in mine:
                if sizes[j]:
                    buf[off:off + sizes[j]].copy_(
                        items[j].contiguous().reshape(-1).view(torch.uint8))
                off += _padded(sizes[j])
            bufs = [torch.empty(width, dtype=torch.uint8, device=staging)
                    for _ in range(self.world_size)]
            dist.all_gather(bufs, buf, group=self._payload)
        for p in range(self.world_size):
            if p == me:
                continue
            off = 0
            for j, o in enumerate(owners):
                if o != p:
                    continue
                shape, dtype = specs[j]
                if sizes[j]:
                    out[j] = bufs[p][off:off + sizes[j]].view(dtype).reshape(shape).to(self.home)
                else:
                    out[j] = torch.empty(shape, dtype=dtype, device=self.home)
                off += _padded(sizes[j])
        if through_host:        # down to the host and back up, both counted
            self._count_staged(verb, sum(sizes))
        st = self.stats
        st["exchanges"] += 1
        st["seconds"] += time.perf_counter() - t0
        st["bytes_sent"] += sum(sizes[j] for j, o in enumerate(owners) if o == me)
        st["bytes_received"] += sum(sizes[j] for j, o in enumerate(owners) if o != me)
        return out

    def send_recv(self, moves: Sequence[tuple], owners: Sequence[int],
                  verb: str = "p2p") -> Dict[int, torch.Tensor]:
        """Point-to-point moves across processes: ``moves[n] = (src rank,
        dst rank, payload)``, the payload a tensor where the source is
        local and a :class:`Remote` (or a tensor of the same spec)
        elsewhere.  Every process passes the same moves in the same order;
        a move between two processes is one ``isend``/``irecv`` pair of
        ``batch_isend_irecv``, tagged by its position.  Returns
        ``{n: received tensor}`` (on :attr:`home`) for the moves this
        process receives from another."""
        me, dist = self.rank, torch.distributed
        staging = self._staging()
        ops, got, moved = [], {}, 0
        for n, (src, dst, payload) in enumerate(moves):
            so, do = owners[src], owners[dst]
            if me not in (so, do) or so == do:
                continue
            moved += _nbytes(payload.shape, payload.dtype)
            if so == me:
                t = payload.contiguous().to(staging)
                ops.append(dist.P2POp(dist.isend, t, do, group=self._payload, tag=n))
            else:
                got[n] = torch.empty(payload.shape, dtype=payload.dtype, device=staging)
                ops.append(dist.P2POp(dist.irecv, got[n], so, group=self._payload, tag=n))
        if ops:
            for work in dist.batch_isend_irecv(ops):
                work.wait()
        if staging.type == "cpu" and self.home.type == "cuda":
            self._count_staged(verb, moved)
        return {n: buf.to(self.home) for n, buf in got.items()}

    def barrier(self) -> None:
        """Every process of the group reaches this point (bounded by the
        group's timeout)."""
        torch.distributed.barrier(group=self._control)
