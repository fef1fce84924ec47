"""A mesh of rank slots: where ``jax.sharding.Mesh`` stands in the JAX package.

The JAX package is single-controller: one process drives every device,
and its tests run every multi-device path on 8 virtual CPU devices of
one process.  The port keeps that design.  A :class:`Mesh` holds named
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
"""

from __future__ import annotations

from typing import Dict, Iterable, Optional, Sequence, Tuple

import numpy as np
import torch

from raft_tpu_torch.core.device import resolve_device
from raft_tpu_torch.core.error import expects

AXIS = "ranks"


class Rank:
    """One rank slot: an id and the device it runs on."""

    __slots__ = ("id", "device")

    def __init__(self, rank_id: int, device: torch.device):
        self.id = int(rank_id)
        self.device = device

    def __repr__(self) -> str:
        return "Rank(%d, %s)" % (self.id, self.device)


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
    """

    def __init__(self, devices, axis_names: Sequence[str]):
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
        """The device of every rank slot, in the mesh's shape."""
        out = np.empty(self.ranks.shape, dtype=object)
        for idx in np.ndindex(self.ranks.shape):
            out[idx] = self.ranks[idx].device
        return out

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
        return Mesh(np.asarray(picked, dtype=object), names)

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


def as_mesh(mesh) -> Mesh:
    """``mesh`` itself when it is a :class:`Mesh`; anything else raises."""
    expects(isinstance(mesh, Mesh), "expected a raft_tpu_torch.comms.Mesh, got %r",
            type(mesh).__name__)
    return mesh
