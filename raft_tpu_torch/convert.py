"""State carried between the JAX package and the port.

This system has no weights; its state is the index: the partitions, their
id translations and the metric, and for IVF-Flat the centroids and the
slotted store.  :func:`from_reference` turns the JAX package's arrays (as
numpy, after ``np.asarray``) into the port's tensors on a device, keeping
dtype and layout (ids stay int32); :func:`to_numpy` goes the other way.
Both walk lists, tuples (named tuples keep their type), dicts, and pass
numbers (a metric, a translation) and ``None`` as they are.
:func:`ivf_flat_index_from_reference` and :func:`ivf_flat_index_to_numpy`
carry an IVF-Flat index.
"""

from __future__ import annotations

import numbers

import numpy as np
import torch

from raft_tpu_torch.core.device import resolve_device
from raft_tpu_torch.distance.distance_type import DistanceType
from raft_tpu_torch.spatial.ann import IVFFlatIndex


def _walk(tree, leaf):
    if tree is None or isinstance(tree, numbers.Number):
        return tree
    if isinstance(tree, dict):
        return {key: _walk(v, leaf) for key, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*[_walk(v, leaf) for v in tree])
    if isinstance(tree, (list, tuple)):
        return type(tree)(_walk(v, leaf) for v in tree)
    return leaf(tree)


def from_reference(arrays, device="cuda"):
    """numpy arrays (or nested lists/tuples/dicts of them) as tensors on
    ``device``."""
    dev = resolve_device(device)
    return _walk(arrays, lambda a: torch.from_numpy(np.array(a, copy=True, order="C")).to(dev))


def to_numpy(tensors):
    """Tensors (or nested lists/tuples/dicts of them) as numpy arrays."""
    return _walk(tensors, lambda t: t.detach().cpu().numpy() if isinstance(t, torch.Tensor)
                 else np.asarray(t))


def ivf_flat_index_from_reference(index, device="cuda") -> IVFFlatIndex:
    """The port's :class:`IVFFlatIndex` from the JAX package's (any object
    with its fields), every array on ``device`` with its dtype.  A missing
    ``slot_norms`` is computed from the vectors, as the JAX search does."""
    fields = {name: getattr(index, name) for name in IVFFlatIndex._fields}
    fields["metric"] = DistanceType(int(fields["metric"]))
    fields["nprobe"] = int(fields["nprobe"])
    out = IVFFlatIndex(**from_reference(fields, device))
    if out.slot_norms is None:
        out = out._replace(slot_norms=(out.slot_vecs * out.slot_vecs).sum(dim=-1))
    return out


def ivf_flat_index_to_numpy(index: IVFFlatIndex) -> IVFFlatIndex:
    """The index with every array as numpy (metric and nprobe unchanged)."""
    return to_numpy(index)
