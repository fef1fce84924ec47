"""Host-level communicator: eager collectives, tagged p2p, comm_split.

Port of ``raft_tpu/comms/host_comms.py`` (reference ``std_comms``,
cpp/include/raft/comms/std_comms.hpp, and the injection helpers,
comms/helper.hpp:39-95).  The reference is multi-controller: one process
per GPU, each holding a per-rank ``comms_t``.  The JAX package is
single-controller: one process drives every device, and the host-level
communicator represents the *whole* communicator, its verbs taking
rank-major data (a leading axis of extent ``size``, row r being rank r's
buffer).  The port keeps that: a :class:`HostComms` spans the rank slots
of one axis of a :class:`~raft_tpu_torch.comms.mesh.Mesh` (slots may
share a card), splits a rank-major input into per-rank tensors on the
ranks' devices, runs the verb of
:class:`~raft_tpu_torch.comms.mesh_comms.MeshComms` over them, and
stacks the per-rank results into a rank-major tensor on the first rank's
device.  On a mesh of several axes the verbs run along ``axis`` through
coordinate 0 of the others (the other lines would compute the same).

**Across processes** (a mesh that spans processes, built by a
multi-process session: :mod:`raft_tpu_torch.comms.dist`).  One
:class:`HostComms` spans every process, as under ``jax.distributed``.
Every process makes the same calls with the same rank-major inputs; a
process places only its own ranks' rows (a remote rank's row is never
read), and inside the :meth:`_execute` seam one exchange of each
process's local rows (``ProcessGroup.exchange``) hands every process
every row, received onto its home device (:meth:`Mesh.home`).  Then the
:class:`MeshComms` arithmetic runs in rank order, so every process ends
with the whole rank-major result, bitwise the one a world of the same
slots gives in one process (a reduction is a gather and a local fold in
rank order, never a library ``all_reduce``).  ``gather``/``gatherv``
keep root-only validity.  Tagged p2p: a pair with both ends in this
process takes the direct route below; a pair that crosses processes is
one ``isend``/``irecv`` of ``batch_isend_irecv``, in the matched order
every process computes alike; then every process receives every
result (one exchange, as ``process_allgather`` gives in the JAX
package).  ``comm_split`` children exchange through the parent's group,
and every process calls their verbs, one that holds no member too.  A
remote rank's probe reports live (a dead process is the group's to
detect: a verb that outlasts the group's timeout latches the abort).
On one process nothing of this runs: the code paths are the
single-controller ones.

**Policy layer** (:meth:`HostComms._run`): a verb on a latched-aborted
communicator fails fast with :class:`CommAbortedError` (the
``ncclCommAbort`` contract, std_comms.hpp:443-475); an optional
:class:`~raft_tpu_torch.comms.resilience.RetryPolicy` retries transient
failures with deterministic backoff and a watchdog deadline; an
unrecoverable failure latches the abort; malformed calls
(``LogicError`` and the Python errors of bad shapes and indices) are
neither retried nor latched.  The execution itself is
:meth:`HostComms._execute`, the seam :mod:`raft_tpu_torch.comms.faults`
patches, so injected faults take the path a device failure takes.

**Tagged p2p** (UCX's role, std_comms.hpp:204-298): ``isend``/``irecv``
record descriptors with dynamic ranks and tags; ``waitall`` matches them
(tags never cross; an unmatched request raises, the analog of the
reference's progress-loop timeout abort; success or failure, the
requests it waited on are consumed) and moves the payloads by one of
three routes (``p2p_staging``):

- ``"device"`` (default): one device-to-device copy per matched pair
  onto the receiving rank's device, zero bytes through the host.  While
  a fault injector holds the ``_execute`` seam, it takes the
  ``"ppermute"`` route instead, so every fault stays observable.
- ``"ppermute"``: pairs grouped by (shape, dtype), layered into
  permutations (unique source and destination), each layer one
  ``device_sendrecv`` verb over per-rank buffers assembled on the
  devices from shared zero blanks.  Zero host bytes.
- ``"host"``: the rank-major buffer assembled in numpy, the measurable
  baseline; its bytes are counted.

``raft_tpu_comms_host_staged_bytes{verb="p2p"}`` records what each
route bounced through the host (``waitall`` always materialises it, so
the device routes' zero is a measurement).

**Metrics**: ``raft_tpu_comms_verb_seconds{verb=}`` (end to end, retries
and watchdog waits included), ``raft_tpu_comms_bytes_total{verb=}``
(payload bytes of successful verbs; for p2p the send rows, not the
staging buffer) and the staged-bytes counter above.  The JAX package's
program-cache and compile-time series have no counterpart: torch
compiles nothing per verb.

``sync_stream`` is the reference's status-returning health check: it
waits for the devices of the given tensors and maps a failure to
``Status.ERROR`` (latching the abort) and an aborted communicator to
``Status.ABORT``.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from raft_tpu_torch.comms.dist import Remote
from raft_tpu_torch.comms.mesh import AXIS, Mesh, as_mesh, default_mesh
from raft_tpu_torch.comms.mesh_comms import MeshComms
from raft_tpu_torch.comms.types import Op, Status
from raft_tpu_torch.core import metrics as _metrics
from raft_tpu_torch.core import tracing
from raft_tpu_torch.core.error import (
    CALLER_BUG_ERRORS,
    CommAbortedError,
    CommError,
    CommTimeoutError,
    expects,
)
from raft_tpu_torch.mr.buffer import zeros_cached

__all__ = ["HostComms", "default_mesh", "axis_host_group_size"]

_STAGINGS = ("device", "ppermute", "host")


def axis_host_group_size(mesh: Mesh, axis: str) -> Optional[int]:
    """Ranks per process along ``axis`` when processes are contiguous
    runs: the natural group of the hierarchical top-k merge (its inner
    allgather stays within a process, its ring crosses them).  The run
    length of equal :attr:`Rank.process` values along one line of the
    axis (other axes at coordinate 0) when every run has that length and
    no process comes back; None on one process (the caller falls back to
    a divisor heuristic) or on interleaved or uneven placement, as
    ``raft_tpu/comms/host_comms.py:axis_host_group_size``."""
    mesh = as_mesh(mesh)
    expects(axis in mesh.axis_names, "axis_host_group_size: axis %s not in mesh", axis)
    procs = [r.process for r in mesh.line(axis, (0,) * len(mesh.axis_names))]
    if len(set(procs)) <= 1:
        return None
    run = 1
    while run < len(procs) and procs[run] == procs[0]:
        run += 1
    if len(procs) % run != 0:
        return None
    for base in range(0, len(procs), run):
        chunk = procs[base:base + run]
        if len(set(chunk)) != 1:
            return None
        if base and chunk[0] == procs[base - 1]:
            return None
    return run


class _Request:
    """Pending p2p operation (reference request_t, comms.hpp:46)."""

    __slots__ = ("kind", "rank", "peer", "tag", "data", "result")

    def __init__(self, kind: str, rank: int, peer: int, tag: int, data=None):
        self.kind = kind      # "send" | "recv"
        self.rank = rank      # owning rank
        self.peer = peer      # destination (send) / source (recv)
        self.tag = tag
        self.data = data      # send payload
        self.result = None    # filled for recv by waitall


class HostComms:
    """Whole-communicator handle over one axis of a rank mesh.

    Data convention: collective inputs are **rank-major** (a tensor or
    numpy array of shape ``(size, ...)``, row r being rank r's buffer, or
    a list of ``size`` per-rank tensors) and outputs are rank-major
    tensors on the first rank's device.  ``reduce`` is replicated (every
    row valid); ``gather``/``gatherv`` have true root-only semantics
    (non-root rows are zeros).
    """

    def __init__(self, mesh: Optional[Mesh] = None, axis: str = AXIS,
                 retry_policy=None, p2p_staging: str = "device"):
        self.mesh = as_mesh(mesh) if mesh is not None else default_mesh()
        self.axis = axis
        expects(axis in self.mesh.axis_names, "axis %s not in mesh", axis)
        expects(p2p_staging in _STAGINGS,
                "p2p_staging must be 'device', 'ppermute' or 'host', got %r", p2p_staging)
        self.p2p_staging = p2p_staging
        self.ranks = self.mesh.line(axis, (0,) * len(self.mesh.axis_names))
        self.group = self.mesh.group
        local = [r for r in self.ranks if r.is_local]
        # where results land, and what this process receives is kept
        self.home = local[0].device if local else self.group.home
        # where this process holds each rank's row: the rank's device, or
        # the home device for a rank of another process
        self.devices = [r.device if r.is_local else self.home for r in self.ranks]
        self._owners = [r.process for r in self.ranks]
        self._mc = MeshComms(axis, len(self.ranks), self.devices)
        self._requests: List[_Request] = []
        self._aborted = False
        self._series_cache: Dict[tuple, tuple] = {}
        # optional RetryPolicy around every eager verb; None = fail on
        # the first error, the reference's behaviour
        self.retry_policy = retry_policy

    # ------------------------------------------------------------------ #
    # topology
    # ------------------------------------------------------------------ #
    def get_size(self) -> int:
        return self._mc.get_size()

    @property
    def mesh_comms(self) -> MeshComms:
        """The per-rank communicator (verbs over lists of per-rank tensors)."""
        return self._mc

    # ------------------------------------------------------------------ #
    # eager collective execution
    # ------------------------------------------------------------------ #
    def _run(self, key: tuple, fn, *args, payload_bytes: Optional[int] = None):
        """Policy layer for one eager verb (module doc): fail fast once
        aborted, the retry policy around :meth:`_execute`, the abort
        latched on an unrecoverable failure; caller bugs propagate
        unchanged and poison nothing."""
        verb = key[0]
        self._ensure_alive(verb)
        timer = self._series("timer", "raft_tpu_comms_verb_seconds", verb,
                             "eager verb latency (incl. retries)")
        if payload_bytes is None:
            payload_bytes = sum(_nbytes(a) for a in args)
        try:
            with timer.time():
                if self.retry_policy is None:
                    out = self._execute(key, fn, *args)
                else:
                    out = self.retry_policy.call(self._execute, key, fn, *args, verb=verb)
            self._series("counter", "raft_tpu_comms_bytes_total", verb,
                         "payload bytes moved by eager verbs").inc(payload_bytes)
            return out
        except CALLER_BUG_ERRORS:
            raise
        except (CommAbortedError, CommTimeoutError):
            self.abort()
            raise
        except Exception as e:
            self.abort()
            raise CommError(
                "%s failed unrecoverably%s; communicator aborted: %s"
                % (verb, "" if self.retry_policy is None
                   else " after %d attempts" % (self.retry_policy.max_retries + 1), e)) from e

    def _series(self, kind: str, name: str, verb: str, help: str):
        """Resolve (and memoise per registry generation) one labelled
        series for this communicator's hot verb path."""
        reg = _metrics.default_registry()
        gen = reg.generation
        cached = self._series_cache.get((name, verb))
        if cached is not None and cached[0] == gen:
            return cached[1]
        series = getattr(reg, kind)(name, help=help, labels=("verb",)).labels(verb=verb)
        self._series_cache[(name, verb)] = (gen, series)
        return series

    def _execute(self, key: tuple, fn, *args):
        """Run ``fn`` (a :class:`MeshComms` verb over per-rank lists) and
        stack its per-rank result rank-major on the home device (the first
        rank's in one process).  Across processes the per-rank lists are
        first completed by the exchange (module doc).  The seam the fault
        injector patches."""
        if self.group is not None:
            args = tuple(self.group.exchange(a, self._owners, key[0]) if isinstance(a, list)
                         else a for a in args)
        return self._stack(fn(*args))

    def _stack(self, outs: List[torch.Tensor]) -> torch.Tensor:
        dev = self.home
        return torch.stack([o if o.device == dev else o.to(dev) for o in outs])

    def _ensure_alive(self, verb: str) -> None:
        """Fail fast once aborted: every verb on a latched communicator
        raises :class:`CommAbortedError` without touching a device."""
        if self._aborted:
            raise CommAbortedError(
                "%s on aborted communicator (size=%d); rebuild via Comms.recover()"
                % (verb, self.get_size()), collect_stack=False)

    def _check(self, x) -> list:
        """A rank-major input as per-rank tensors on the ranks' devices;
        across processes a remote rank's row is not read: its entry is a
        :class:`~raft_tpu_torch.comms.dist.Remote` of the row's shape
        (None where a list gave none), which the exchange fills."""
        size = self.get_size()
        if isinstance(x, (list, tuple)):
            expects(len(x) == size, "rank-major input required: %d buffers for size=%d",
                    len(x), size)
            rows = [None if t is None else torch.as_tensor(t) for t in x]
        else:
            x = torch.as_tensor(x)
            expects(x.ndim >= 1 and x.shape[0] == size,
                    "rank-major input required: leading axis must be size=%d", size)
            rows = list(x.unbind(0))
        out = []
        for r, rank, d in zip(rows, self.ranks, self.devices):
            if not rank.is_local:
                out.append(None if r is None else Remote(r.shape, r.dtype))
            else:
                expects(r is not None, "rank-major input: no buffer for local rank %d", rank.id)
                out.append(r if r.device == d else r.to(d))
        return out

    def allreduce(self, x, op: Op = Op.SUM):
        xs = self._check(x)
        return self._run(("allreduce", op), lambda b: self._mc.allreduce(b, op), xs)

    def bcast(self, x, root: int = 0):
        xs = self._check(x)
        return self._run(("bcast", root), lambda b: self._mc.bcast(b, root), xs)

    def reduce(self, x, root: int = 0, op: Op = Op.SUM):
        xs = self._check(x)
        return self._run(("reduce", op), lambda b: self._mc.reduce(b, root, op), xs)

    def allgather(self, x):
        """Rank-major (size, n, ...) -> (size, size*n, ...): every row
        holds the concatenation of all rows."""
        xs = self._check(x)
        return self._run(("allgather",), self._mc.allgather, xs)

    def allgatherv(self, x, recvcounts: Sequence[int]):
        xs = self._check(x)
        return self._run(("allgatherv", tuple(recvcounts)),
                         lambda b: self._mc.allgatherv(b, recvcounts), xs)

    def gather(self, x, root: int = 0):
        """Rank-major (size, n, ...) -> (size, size*n, ...): row ``root``
        holds the concatenation of all rows, every other row is zeros
        (reference gather, std_comms.hpp:377)."""
        xs = self._check(x)
        return self._run(("gather", root), lambda b: self._mc.gather(b, root), xs)

    def gatherv(self, x, recvcounts: Sequence[int], root: int = 0):
        """Variable-sized :meth:`gather`; root-only validity as there."""
        xs = self._check(x)
        return self._run(("gatherv", tuple(recvcounts), root),
                         lambda b: self._mc.gatherv(b, recvcounts, root), xs)

    def reducescatter(self, x, op: Op = Op.SUM):
        """Rank-major (size, size*n, ...) -> (size, n, ...)."""
        xs = self._check(x)
        return self._run(("reducescatter", op), lambda b: self._mc.reducescatter(b, op), xs)

    def barrier(self) -> None:
        self._run(("barrier",), self._barrier, payload_bytes=0)

    def _barrier(self) -> List[torch.Tensor]:
        out = self._mc.barrier()
        if self.group is not None:
            self.group.barrier()
        return out

    # ------------------------------------------------------------------ #
    # tagged p2p (reference comms.hpp:254-292 isend/irecv/waitall)
    # ------------------------------------------------------------------ #
    def isend(self, buf, rank: int, dest: int, tag: int = 0) -> _Request:
        """Queue a tagged send of ``buf`` from ``rank`` to ``dest``."""
        self._ensure_alive("isend")
        req = _Request("send", rank, dest, tag, torch.as_tensor(buf))
        self._requests.append(req)
        return req

    def irecv(self, rank: int, source: int, tag: int = 0) -> _Request:
        """Queue a tagged receive on ``rank`` from ``source``."""
        self._ensure_alive("irecv")
        req = _Request("recv", rank, source, tag)
        self._requests.append(req)
        return req

    def waitall(self, requests: Optional[Sequence[_Request]] = None,
                staging: Optional[str] = None) -> None:
        """Match queued sends and receives and move the payloads by the
        ``staging`` route (default: :attr:`p2p_staging`; module doc).
        Each receive's result lies on its rank's device.  Unmatched
        requests raise; success or failure, the requests waited on are
        consumed, so a stale request cannot poison a later ``waitall``."""
        self._ensure_alive("waitall")
        if staging is None:
            staging = self.p2p_staging
        expects(staging in _STAGINGS,
                "waitall: staging must be 'device', 'ppermute' or 'host', got %r", staging)
        staged_c = self._series(
            "counter", "raft_tpu_comms_host_staged_bytes", "p2p",
            "payload bytes bounced through the host on the p2p path (0 on the "
            "device-resident routes)")
        reqs = list(requests) if requests is not None else list(self._requests)
        try:
            sends = [r for r in reqs if r.kind == "send"]
            recvs = [r for r in reqs if r.kind == "recv"]
            pairs: List[Tuple[_Request, _Request]] = []
            taken: set = set()
            for s in sends:
                match = next((r for r in recvs
                              if r.tag == s.tag and r.peer == s.rank and s.peer == r.rank
                              and r.result is None and id(r) not in taken), None)
                expects(match is not None, "waitall: unmatched send rank=%d->%d tag=%d",
                        s.rank, s.peer, s.tag)
                taken.add(id(match))
                pairs.append((s, match))
            leftover = [r for r in recvs if id(r) not in taken and r.result is None]
            expects(not leftover, "waitall: %d unmatched irecv(s)", len(leftover))
            size = self.get_size()
            for s, r in pairs:
                expects(0 <= s.rank < size and 0 <= r.rank < size,
                        "waitall: rank out of range in %d->%d", s.rank, r.rank)

            if staging == "device" and not self._execute_is_patched():
                staged_c.inc(0)
                self._direct_p2p(pairs)
                return

            groups: Dict[tuple, List[Tuple[_Request, _Request]]] = {}
            for s, r in pairs:
                groups.setdefault((tuple(s.data.shape), s.data.dtype), []).append((s, r))
            for (shape, dtype), gpairs in groups.items():
                # greedy layering: each layer is a permutation
                layers: List[List[Tuple[_Request, _Request]]] = []
                for s, r in gpairs:
                    for layer in layers:
                        if all(s.rank != ls.rank and s.peer != ls.peer for ls, _ in layer):
                            layer.append((s, r))
                            break
                    else:
                        layers.append([(s, r)])
                for layer in layers:
                    perm = [(s.rank, s.peer) for s, _ in layer]
                    if staging == "host":
                        buf = np.zeros((size,) + shape, torch.empty(0, dtype=dtype).numpy().dtype)
                        for s, _ in layer:
                            buf[s.rank] = s.data.cpu().numpy()
                        staged_c.inc(int(buf.nbytes))
                        rows = self._check(torch.from_numpy(buf))
                    else:
                        staged_c.inc(0)
                        by_rank = {s.rank: s.data for s, _ in layer}
                        rows = []
                        for rk, dev in enumerate(self.devices):
                            row = by_rank.get(rk)
                            if not self.ranks[rk].is_local:
                                rows.append(Remote(shape, dtype))
                            else:
                                rows.append(zeros_cached(shape, dtype, dev) if row is None
                                            else row.to(dev))
                    out = self._run(("p2p", tuple(perm)),
                                    lambda b, perm=perm: self._mc.device_sendrecv(b, perm),
                                    rows, payload_bytes=sum(_nbytes(s.data) for s, _ in layer))
                    for s, r in layer:
                        r.result = out[r.rank].to(self.devices[r.rank])
        finally:
            done = {id(r) for r in reqs}
            self._requests = [r for r in self._requests if id(r) not in done]

    def _execute_is_patched(self) -> bool:
        """True while a fault injector (or any monkeypatch) holds the
        ``_execute`` seam: the direct route never reaches it, so it would
        walk around an attached fault harness."""
        inst = self.__dict__.get("_execute")
        return inst is not None and getattr(inst, "__func__", None) is not HostComms._execute

    def _direct_p2p(self, pairs) -> None:
        """The zero-copy route: each matched pair is one device copy of
        the send buffer onto the receiving rank's device (a copy also
        where both ranks share the device, as a transfer is)."""
        timer = self._series("timer", "raft_tpu_comms_verb_seconds", "p2p",
                             "eager verb latency (incl. retries)")
        payload = sum(_nbytes(s.data) for s, _ in pairs)
        try:
            with timer.time():
                for s, r in pairs:
                    if not (self.ranks[s.rank].is_local and self.ranks[r.rank].is_local):
                        continue
                    dev = self.devices[r.rank]
                    if self.retry_policy is None:
                        r.result = s.data.to(dev, copy=True)
                    else:
                        r.result = self.retry_policy.call(
                            lambda t, d: t.to(d, copy=True), s.data, dev, verb="p2p")
                if self.group is not None:
                    self._cross_process_p2p(pairs)
        except CALLER_BUG_ERRORS:
            raise
        except (CommAbortedError, CommTimeoutError):
            self.abort()
            raise
        except Exception as e:
            self.abort()
            raise CommError("p2p direct transfer failed unrecoverably%s; communicator "
                            "aborted: %s" % ("" if self.retry_policy is None else
                                             " after %d attempts"
                                             % (self.retry_policy.max_retries + 1), e)) from e
        self._series("counter", "raft_tpu_comms_bytes_total", "p2p",
                     "payload bytes moved by eager verbs").inc(payload)

    def _cross_process_p2p(self, pairs) -> None:
        """The pairs that cross processes, one ``isend``/``irecv`` each in
        the matched order; then every process receives every result (module
        doc).  Not retried: a retried exchange on one process alone would
        desynchronise the group."""
        local = [r.is_local for r in self.ranks]
        moves = [(s.rank, r.rank, s.data if local[s.rank] else Remote(s.data.shape, s.data.dtype))
                 for s, r in pairs]
        for n, t in self.group.send_recv(moves, self._owners).items():
            r = pairs[n][1]
            r.result = t.to(self.devices[r.rank])
        items = [r.result if local[r.rank] else Remote(s.data.shape, s.data.dtype)
                 for s, r in pairs]
        full = self.group.exchange(items, [self._owners[r.rank] for _, r in pairs], "p2p")
        for (_, r), t in zip(pairs, full):
            if not local[r.rank]:
                r.result = t

    # device_send/recv: the reference's stream-ordered p2p verbs
    # (comms.hpp:508,522) share the tagged machinery with a reserved tag
    _DEVICE_TAG = -1

    def device_send(self, buf, rank: int, dest: int) -> _Request:
        return self.isend(buf, rank, dest, tag=self._DEVICE_TAG)

    def device_recv(self, rank: int, source: int) -> _Request:
        return self.irecv(rank, source, tag=self._DEVICE_TAG)

    def device_sendrecv(self, x, perm: Sequence[Tuple[int, int]]):
        """Eager static-permutation exchange (reference comms.hpp:522)."""
        xs = self._check(x)
        return self._run(("sendrecv", tuple(tuple(p) for p in perm)),
                         lambda b: self._mc.device_sendrecv(b, perm), xs)

    def device_multicast_sendrecv(self, x, sends: Sequence[Tuple[int, int]]):
        xs = self._check(x)
        return self._run(("multicast", tuple(tuple(p) for p in sends)),
                         lambda b: self._mc.device_multicast_sendrecv(b, sends), xs)

    # ------------------------------------------------------------------ #
    # liveness (the per-rank probe of a session's health_check)
    # ------------------------------------------------------------------ #
    def probe_rank(self, rank: int) -> bool:
        """Whether rank ``rank`` answers: a scalar round trip on its
        device, run through the ``_execute`` seam (so a fault injected on
        the rank shows here) but not through the abort latch (an aborted
        communicator's ranks may still be fit to carry a rebuilt one).  A
        rank of another process reports live, untouched: a dead process is
        the group's to detect."""
        if not self.ranks[rank].is_local:
            return True
        dev = self.devices[rank]

        def ping():
            return [torch.ones((), dtype=torch.int32, device=dev) + 1]

        try:
            return int(self._execute(("probe", int(rank)), ping)[0]) == 2
        except Exception:
            return False

    # ------------------------------------------------------------------ #
    # comm_split (reference comms.hpp:96 / std_comms.hpp:115-177)
    # ------------------------------------------------------------------ #
    def comm_split(self, colors: Sequence[int], keys: Optional[Sequence[int]] = None
                   ) -> Dict[int, "HostComms"]:
        """Partition the communicator by colour; within a colour, ranks
        are ordered by key (ties by rank).  Returns {colour:
        sub-communicator} over sub-meshes of the same rank slots.
        Children inherit the retry policy and staging; splitting an
        aborted communicator fails fast."""
        self._ensure_alive("comm_split")
        size = self.get_size()
        expects(len(colors) == size, "comm_split: need one color per rank")
        keys = list(keys) if keys is not None else list(range(size))
        expects(len(keys) == size, "comm_split: need one key per rank")
        out: Dict[int, HostComms] = {}
        for color in sorted(set(colors)):
            members = sorted((r for r in range(size) if colors[r] == color),
                             key=lambda r: (keys[r], r))
            sub = self.mesh.submesh([self.ranks[r] for r in members], (self.axis,))
            out[color] = HostComms(sub, self.axis, retry_policy=self.retry_policy,
                                   p2p_staging=self.p2p_staging)
        return out

    # ------------------------------------------------------------------ #
    # failure surfacing (reference sync_stream, std_comms.hpp:443-475)
    # ------------------------------------------------------------------ #
    @property
    def aborted(self) -> bool:
        """Whether the communicator has latched aborted (permanent)."""
        return self._aborted

    def abort(self) -> None:
        """Latch the communicator unusable (reference ncclCommAbort).
        Idempotent; counted once."""
        if not self._aborted:
            self._aborted = True
            tracing.counter_inc("comms.abort")

    def sync_stream(self, *tensors) -> Status:
        """Wait for the devices of ``tensors`` (every rank's device when
        none is given); map failures to a status instead of raising."""
        if self._aborted:
            return Status.ABORT
        devs = {t.device for t in tensors if isinstance(t, torch.Tensor)} or set(self.devices)
        try:
            for dev in devs:
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
            return Status.SUCCESS
        except Exception:
            self.abort()
            return Status.ERROR


def _nbytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, (list, tuple)):
        return sum(_nbytes(t) for t in x)
    return int(getattr(x, "nbytes", 0))
