"""The per-rank communicator: each collective verb over a list of per-rank tensors.

Port of ``raft_tpu/comms/mesh_comms.py`` (reference ``comms_t`` /
``comms_iface``, cpp/include/raft/comms/comms.hpp:91-609, and its NCCL
implementation ``std_comms``, comms/std_comms.hpp:300-441).  In the JAX
package the verbs are XLA collectives traced inside ``shard_map``, one
SPMD program for all ranks.  The port is single-controller in the same
way, without a tracer: a verb takes the list of every rank's buffer
(entry r on rank r's device, in rank order along the axis) and returns
the list of every rank's result, each on its rank's device.  The
collectives are torch ops and device-to-device copies
(``Tensor.to``); ranks that share a device share the work of a verb
(a reduction or a concatenation is computed once per device, in rank
order), and nothing is staged through the host.
:class:`~raft_tpu_torch.comms.host_comms.HostComms` runs every eager verb
through these, so the eager API and the per-rank API cannot diverge.

Verb map (reference -> here), with the reference's documented
semantics:

- allreduce (PROD included) -> a fold in rank order: sums in row order,
  never atomics, so every call repeats bit for bit;
- bcast(root) -> root's buffer on every rank;
- reduce(root) -> allreduce: the result is replicated (a superset of
  "defined on root only", as in the reference);
- allgather / allgatherv -> concatenation in rank order (``dim`` and
  ``groups`` as ``lax.all_gather``'s ``axis`` and ``axis_index_groups``);
- gather(v)(root) -> the concatenation on root, zeros on every other
  rank (true root-only validity);
- reducescatter -> allreduce, then rank r keeps block r;
- device_sendrecv(perm) -> a copy per (src, dst) pair, zeros where a
  rank receives nothing;
- device_multicast_sendrecv(sends) -> the sum, in the payload's own
  dtype, of every block a rank receives;
- barrier -> every device of the axis synchronised (a CUDA sync; nothing
  on the CPU), and the rank count on every rank.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import torch

from raft_tpu_torch.comms.types import Op
from raft_tpu_torch.core.error import expects, fail

_FOLD = {Op.SUM: torch.add, Op.PROD: torch.mul, Op.MIN: torch.minimum, Op.MAX: torch.maximum}


def _to(t: torch.Tensor, dev: torch.device) -> torch.Tensor:
    return t if t.device == dev else t.to(dev)


class MeshComms:
    """Collective verbs over the ranks of one mesh axis.

    Parameters
    ----------
    axis:
        Mesh axis name the collectives run over.
    axis_size:
        Number of ranks along ``axis``; every verb takes and returns
        lists of this length.
    devices:
        The ranks' devices in rank order, used by :meth:`barrier` (the
        other verbs place each result on its rank's input device).
    """

    def __init__(self, axis: str, axis_size: int,
                 devices: Optional[Sequence[torch.device]] = None):
        self.axis = axis
        self._size = int(axis_size)
        self.devices = list(devices) if devices is not None else None

    # ------------------------------------------------------------------ #
    # topology (reference comms.hpp:206-216)
    # ------------------------------------------------------------------ #
    def get_size(self) -> int:
        return self._size

    def get_rank(self) -> List[int]:
        """Each entry's rank: entry r of every per-rank list is rank r
        (the JAX verb returns the traced index of the executing shard)."""
        return list(range(self._size))

    def _check(self, xs, verb: str) -> List[torch.Tensor]:
        xs = list(xs)
        expects(len(xs) == self._size, "%s: need one buffer per rank (%d), got %d", verb,
                self._size, len(xs))
        return xs

    @staticmethod
    def _per_device(xs: List[torch.Tensor], make: Callable[[torch.device], torch.Tensor],
                    ranks: Optional[Sequence[int]] = None) -> List[torch.Tensor]:
        """``make(device)`` for each rank's device, computed once per device."""
        cache = {}
        out = []
        for r in (range(len(xs)) if ranks is None else ranks):
            dev = xs[r].device
            if dev not in cache:
                cache[dev] = make(dev)
            out.append(cache[dev])
        return out

    # ------------------------------------------------------------------ #
    # collectives (reference comms.hpp:294-437 -> std_comms.hpp:300-441)
    # ------------------------------------------------------------------ #
    def allreduce(self, xs, op: Op = Op.SUM) -> List[torch.Tensor]:
        """Element-wise cross-rank reduction, folded in rank order."""
        xs = self._check(xs, "allreduce")
        fold = _FOLD.get(Op(op)) if isinstance(op, (int, Op)) else None
        if fold is None:
            fail("allreduce: unknown reduction op %s", op)

        def make(dev):
            acc = _to(xs[0], dev)
            for x in xs[1:]:
                acc = fold(acc, _to(x, dev))
            return acc

        return self._per_device(xs, make)

    def bcast(self, xs, root: int = 0) -> List[torch.Tensor]:
        """Every rank receives root's buffer (reference bcast,
        comms.hpp:314/331)."""
        xs = self._check(xs, "bcast")
        expects(0 <= root < self._size, "bcast: root %d out of range", root)
        return [_to(xs[root], x.device) for x in xs]

    def reduce(self, xs, root: int = 0, op: Op = Op.SUM) -> List[torch.Tensor]:
        """Reduction "to root", replicated on every rank (module doc)."""
        del root
        return self.allreduce(xs, op)

    def allgather(self, xs, dim: int = 0,
                  groups: Optional[Sequence[Sequence[int]]] = None) -> List[torch.Tensor]:
        """Every rank's buffer concatenated in rank order along ``dim``
        (reference allgather, std_comms.hpp:344: recvbuf rank-major).
        ``groups`` partitions the ranks: each rank gathers its group's
        buffers only (``lax.all_gather``'s ``axis_index_groups``)."""
        xs = self._check(xs, "allgather")
        if groups is None:
            groups = [list(range(self._size))]
        out: List[Optional[torch.Tensor]] = [None] * self._size
        for grp in groups:
            grp = list(grp)
            got = self._per_device(
                xs, lambda dev, g=grp: torch.cat([_to(xs[r], dev) for r in g], dim=dim), grp)
            for r, t in zip(grp, got):
                out[r] = t
        expects(all(t is not None for t in out), "allgather: groups %r miss a rank", groups)
        return out

    def allgatherv(self, xs, recvcounts: Sequence[int]) -> List[torch.Tensor]:
        """Variable-sized allgather (reference allgatherv,
        std_comms.hpp:355-375): rank r's first ``recvcounts[r]`` rows,
        concatenated in rank order."""
        xs = self._check(xs, "allgatherv")
        expects(len(recvcounts) == self._size, "allgatherv: need one recvcount per rank")
        return self._per_device(xs, lambda dev: torch.cat(
            [_to(x[:int(c)], dev) for x, c in zip(xs, recvcounts)], dim=0))

    def gather(self, xs, root: int = 0) -> List[torch.Tensor]:
        """The concatenation on ``root``, zeros on every other rank
        (reference gather, std_comms.hpp:377: recvbuf valid on root)."""
        return self._root_only(self.allgather(xs), root)

    def gatherv(self, xs, recvcounts: Sequence[int], root: int = 0) -> List[torch.Tensor]:
        """Variable-sized :meth:`gather` (reference gatherv, std_comms.hpp:403)."""
        return self._root_only(self.allgatherv(xs, recvcounts), root)

    def _root_only(self, outs: List[torch.Tensor], root: int) -> List[torch.Tensor]:
        expects(0 <= root < self._size, "gather: root %d out of range", root)
        return [t if r == root else torch.zeros_like(t) for r, t in enumerate(outs)]

    def reducescatter(self, xs, op: Op = Op.SUM) -> List[torch.Tensor]:
        """Reduce, then rank r keeps block r of axis 0 (reference
        reducescatter, std_comms.hpp:427)."""
        full = self.allreduce(xs, op)
        n = full[0].shape[0]
        expects(n % self._size == 0,
                "reducescatter: axis-0 extent %d not divisible by %d ranks", n, self._size)
        block = n // self._size
        return [t[r * block:(r + 1) * block] for r, t in enumerate(full)]

    # ------------------------------------------------------------------ #
    # device p2p (reference comms.hpp:508-607)
    # ------------------------------------------------------------------ #
    def device_sendrecv(self, xs, perm: Sequence[Tuple[int, int]]) -> List[torch.Tensor]:
        """Exchange buffers along a (src, dst) permutation (reference
        device_sendrecv, comms.hpp:522); a rank named as no destination
        receives zeros."""
        xs = self._check(xs, "device_sendrecv")
        perm = [(int(s), int(d)) for s, d in perm]
        dsts = [d for _, d in perm]
        expects(len(set(dsts)) == len(dsts) and len({s for s, _ in perm}) == len(perm),
                "device_sendrecv: %r is not a permutation", perm)
        out = [None] * self._size
        for s, d in perm:
            out[d] = _to(xs[s], xs[d].device)
        return [t if t is not None else torch.zeros_like(x) for t, x in zip(out, xs)]

    def device_multicast_sendrecv(self, xs, sends: Sequence[Tuple[int, int]]
                                  ) -> List[torch.Tensor]:
        """One-to-many / many-to-one exchange (reference
        device_multicast_sendrecv, comms.hpp:560): each rank receives the
        sum of the buffers sent to it, in the payload's own dtype (ids
        above 2^24 stay exact)."""
        xs = self._check(xs, "device_multicast_sendrecv")
        out = [torch.zeros_like(x) for x in xs]
        for s, d in sends:
            out[d] = out[d] + _to(xs[s], xs[d].device)
        return out

    def barrier(self) -> List[torch.Tensor]:
        """Wait for every device of the axis, then each rank holds the
        rank count (reference barrier, comms.hpp:244)."""
        expects(self.devices is not None, "barrier: MeshComms built without devices")
        done = set()
        for dev in self.devices:
            if dev.type == "cuda" and dev not in done:
                torch.cuda.synchronize(dev)
                done.add(dev)
        return [torch.full((), self._size, dtype=torch.int32, device=d) for d in self.devices]
