"""A mesh of rank slots: where ``jax.sharding.Mesh`` stands in the JAX package.

The JAX package is single-controller: one process drives every device
of its own, and its tests run every multi-device path on 8 virtual CPU
devices of one process.  The port keeps that design inside a process.  A :class:`Mesh` holds named
axes over an array of **rank slots** (:class:`Rank`), each bound to a
:class:`torch.device`, and several slots may share one device, as the
virtual JAX mesh shares the host's cores.  So a world of 4 runs on one
card (``Mesh([torch.device("cuda:0")] * 4, ("x",))``), a world of 8 on
the CPU in one process (``Mesh([torch.device("cpu")] * 8, ("x",))``), and
where the machine shows several cards, ranks given distinct devices
land on distinct cards with no change of code.

A rank is not its device: two slots on one card are two ranks.  Each
slot carries an id of its own (its flat position in the mesh it was
first built in), and sub-meshes (:meth:`Mesh.submesh`, the session's
``recover``, ``comm_split``, replica groups) keep the slots, ids
included.  Everything that names a rank (the liveness verdicts of a
session's ``health_check``, ``recover(devices=...)``, a replica's span,
``worker_info``) names it by that id or by the :class:`Rank` object.

**A mesh that spans processes.**  A multi-process session (one process a
card over ``torch.distributed``, :mod:`raft_tpu_torch.comms.dist`)
builds one mesh on every process: the concatenation of every process's
local slots in process order, ids their flat positions, carrying the
process group (:attr:`Mesh.group`).  Each :class:`Rank` knows the
process that owns it (``process``) and whether that is this process
(``is_local``).  A remote rank carries its owner's device description
(``"cuda:0@process 1"``) and no device: reading :attr:`Rank.device` of
a remote rank raises :class:`~raft_tpu_torch.core.error.LogicError`, so
no code can copy data to "its" device by mistake.  Sub-meshes keep the
group.  :meth:`Mesh.home` is where this process holds what it receives
from other processes: its first local slot's device.
"""

from __future__ import annotations

from typing import Dict, Iterable, Optional, Sequence, Tuple

import numpy as np
import torch

from raft_tpu_torch.core.device import resolve_device
from raft_tpu_torch.core.error import RaftError, expects, fail

AXIS = "ranks"


class Rank:
    """One rank slot: an id, the process that owns it, and, where this
    process owns it, the device it runs on (module doc)."""

    __slots__ = ("id", "_device", "process", "desc")

    def __init__(self, rank_id: int, device: Optional[torch.device], process: int = 0,
                 desc: Optional[str] = None):
        self.id = int(rank_id)
        self._device = device
        self.process = int(process)
        self.desc = desc if desc is not None else str(device)

    @property
    def is_local(self) -> bool:
        """Whether this process owns the slot (and so may touch its device)."""
        return self._device is not None

    @property
    def device(self) -> torch.device:
        """The slot's device; a rank of another process has none here."""
        if self._device is None:
            fail("Rank %d lives on %s: another process's device cannot be touched here",
                 self.id, self.desc)
        return self._device

    def __repr__(self) -> str:
        return "Rank(%d, %s)" % (self.id, self.desc)


def _as_device(d) -> torch.device:
    dev = resolve_device(d)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class Mesh:
    """Named axes over an array of rank slots (module doc).

    Parameters
    ----------
    devices:
        An array (nested lists or a numpy object array) of
        :class:`torch.device` objects or device strings, one per rank slot
        (ids are the flat positions), or of :class:`Rank` objects (kept
        as they are, ids included).
    axis_names:
        One name per array dimension.
    group:
        The :class:`~raft_tpu_torch.comms.dist.ProcessGroup` of a mesh
        that spans processes (None: every slot is this process's).
    """

    def __init__(self, devices, axis_names: Sequence[str], group=None):
        src = np.asarray(devices, dtype=object)
        arr = np.empty(src.shape, dtype=object)
        for pos, idx in enumerate(np.ndindex(arr.shape)):
            item = src[idx]
            arr[idx] = item if isinstance(item, Rank) else Rank(pos, _as_device(item))
        axis_names = tuple(axis_names)
        expects(arr.ndim == len(axis_names) and arr.size > 0,
                "Mesh: %d axis names for a %d-D array of %d rank slots", len(axis_names),
                arr.ndim, arr.size)
        expects(len(set(axis_names)) == len(axis_names), "Mesh: repeated axis names %r",
                axis_names)
        ids = [r.id for r in arr.ravel()]
        expects(len(set(ids)) == len(ids), "Mesh: repeated rank ids %r", ids)
        self.ranks = arr
        self.axis_names: Tuple[str, ...] = axis_names
        self.group = group
        expects(group is not None or all(r.is_local for r in arr.ravel()),
                "Mesh: remote rank slots need the process group that spans them")

    # -- geometry ------------------------------------------------------- #
    @property
    def shape(self) -> Dict[str, int]:
        """Axis name -> size (``mesh.shape[axis]``, as in JAX)."""
        return dict(zip(self.axis_names, self.ranks.shape))

    @property
    def size(self) -> int:
        return int(self.ranks.size)

    @property
    def devices(self) -> np.ndarray:
        """The device of every rank slot, in the mesh's shape (raises on a
        mesh with remote slots: their devices are not this process's)."""
        out = np.empty(self.ranks.shape, dtype=object)
        for idx in np.ndindex(self.ranks.shape):
            out[idx] = self.ranks[idx].device
        return out

    @property
    def spans_processes(self) -> bool:
        return self.group is not None

    def local_ranks(self) -> list:
        """This process's slots, in flat order."""
        return [r for r in self.ranks.ravel() if r.is_local]

    def home(self) -> torch.device:
        """Where this process keeps results and what it receives from other
        processes: its first local slot's device (the process group's
        first slot where this mesh holds none of this process's)."""
        local = self.local_ranks()
        if local:
            return local[0].device
        return self.group.home

    def rank_list(self) -> list:
        """The rank slots in flat (row-major) order."""
        return list(self.ranks.ravel())

    def rank_ids(self) -> Tuple[int, ...]:
        return tuple(r.id for r in self.ranks.ravel())

    def submesh(self, ranks: Iterable, axis_names: Optional[Sequence[str]] = None) -> "Mesh":
        """A 1-D mesh over some of this mesh's slots (Rank objects or rank
        ids), in the given order; the slots keep their ids."""
        by_id = {r.id: r for r in self.ranks.ravel()}
        picked = []
        for r in ranks:
            key = r.id if isinstance(r, Rank) else r
            expects(isinstance(key, (int, np.integer)) and int(key) in by_id
                    and (not isinstance(r, Rank) or by_id[int(key)] is r),
                    "Mesh.submesh: %r is not a rank of this mesh", r)
            picked.append(by_id[int(key)])
        names = tuple(axis_names) if axis_names is not None else (self.axis_names[0],)
        return Mesh(np.asarray(picked, dtype=object), names, group=self.group)

    def line(self, axis: str, coord: Tuple[int, ...]) -> list:
        """The slots along ``axis`` through the mesh coordinate ``coord``
        (its entry on ``axis`` ignored)."""
        ax = self.axis_names.index(axis)
        idx = list(coord)
        out = []
        for i in range(self.ranks.shape[ax]):
            idx[ax] = i
            out.append(self.ranks[tuple(idx)])
        return out

    def __repr__(self) -> str:
        return "Mesh(%s, ranks=%s)" % (self.shape, [repr(r) for r in self.ranks.ravel()])


def default_mesh(n_devices: Optional[int] = None, device="cuda") -> Mesh:
    """A 1-D mesh over the first ``n_devices`` visible devices (the
    bootstrap analog of reference helper.hpp:39 build_comms_nccl_only):
    one rank slot a card on CUDA (raises when asked for more cards than
    exist), ``n_devices`` slots (default 1) on the CPU.  A world of N
    rank slots on one card is built explicitly:
    ``Mesh([torch.device("cuda:0")] * N, ("ranks",))``."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        count = torch.cuda.device_count()
        n = count if n_devices is None else int(n_devices)
        expects(1 <= n <= count, "requested %d devices, only %d available", n, count)
        return Mesh([torch.device("cuda", i) for i in range(n)], (AXIS,))
    n = 1 if n_devices is None else int(n_devices)
    expects(n >= 1, "default_mesh: n_devices=%d", n)
    return Mesh([dev] * n, (AXIS,))


def refuse_spanning(mesh, what: str) -> None:
    """Raise :class:`RaftError` when ``mesh`` spans processes: ``what``
    does not run across a process boundary yet (``ROADMAP.md``'s
    performance work holds it as "serving across processes")."""
    if mesh is not None and getattr(mesh, "group", None) is not None:
        raise RaftError("%s over a mesh that spans processes is not ported yet; ROADMAP.md "
                        "holds it under performance work as 'serving across processes'"
                        % what, collect_stack=False)


def as_mesh(mesh) -> Mesh:
    """``mesh`` itself when it is a :class:`Mesh`; anything else raises."""
    expects(isinstance(mesh, Mesh), "expected a raft_tpu_torch.comms.Mesh, got %r",
            type(mesh).__name__)
    return mesh
