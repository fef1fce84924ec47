"""State carried between the JAX package and the port.

This system has no weights; its state is the index: the partitions, their
id translations and the metric, and for IVF-Flat the centroids and the
slotted store.  :func:`from_reference` turns the JAX package's arrays (as
numpy, after ``np.asarray``) into the port's tensors on a device, keeping
dtype and layout (ids stay int32); :func:`to_numpy` goes the other way.
Both walk lists, tuples (named tuples keep their type), dicts, and pass
numbers (a metric, a translation) and ``None`` as they are.
:func:`ivf_flat_index_from_reference`, :func:`ivf_pq_index_from_reference`
and :func:`ivf_sq_index_from_reference` carry an IVF index (their
``*_to_numpy`` inverses carry it back), and
:func:`ball_cover_index_from_reference` a ball cover.
:func:`ooc_ivf_flat_from_reference` carries an out-of-core IVF-Flat index
(its metadata to the device, its ``slot_centroid`` and host ``store`` as
numpy), and :func:`ooc_ivf_flat_to_numpy` carries it back.

Sparse containers travel too.  An object with the fields of the JAX
package's ``COO`` (``rows``, ``cols``, ``vals``, ``shape``, ``nnz``) or
``CSR`` (``indptr``, ``indices``, ``data``, ``shape``) becomes the port's
:class:`~raft_tpu_torch.sparse.formats.COO` or
:class:`~raft_tpu_torch.sparse.formats.CSR` with the same arrays, shape
and nnz (ids int32, padding and capacity kept); :func:`to_numpy` turns
the port's containers into :class:`COOArrays` and :class:`CSRArrays`,
which carry back the same way.  An MST edge list with the JAX
``GraphCOO``'s fields (``src``, ``dst``, ``weights``, ``n_edges``) becomes
the port's :class:`~raft_tpu_torch.sparse.mst.GraphCOO`.
"""

from __future__ import annotations

import numbers
from typing import NamedTuple, Tuple

import numpy as np
import torch

from raft_tpu_torch.core.device import resolve_device
from raft_tpu_torch.distance.distance_type import DistanceType
from raft_tpu_torch.sparse.formats import COO, CSR
from raft_tpu_torch.sparse.mst import GraphCOO
from raft_tpu_torch.spatial.ann import IVFFlatIndex, IVFPQIndex, IVFSQIndex
from raft_tpu_torch.spatial.ball_cover import BallCoverIndex
from raft_tpu_torch.spatial.ooc import OocIVFFlat


class COOArrays(NamedTuple):
    """A COO's arrays on the host (:func:`to_numpy`)."""
    rows: np.ndarray
    cols: np.ndarray
    vals: np.ndarray
    shape: Tuple[int, int]
    nnz: int


class CSRArrays(NamedTuple):
    """A CSR's arrays on the host (:func:`to_numpy`)."""
    indptr: np.ndarray
    indices: np.ndarray
    data: np.ndarray
    shape: Tuple[int, int]


def _is_sparse(tree) -> bool:
    return all(hasattr(tree, f) for f in ("rows", "cols", "vals", "shape", "nnz")) or all(
        hasattr(tree, f) for f in ("indptr", "indices", "data", "shape"))


def _host(a) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _sparse_from_reference(a, dev: torch.device):
    def own(x):
        return np.array(_host(x), copy=True)
    if hasattr(a, "indptr"):
        return CSR(own(a.indptr), own(a.indices), own(a.data), a.shape, device=dev)
    return COO(own(a.rows), own(a.cols), own(a.vals), a.shape, int(_host(a.nnz)), device=dev)


def _sparse_to_numpy(t):
    if isinstance(t, CSR):
        return CSRArrays(_host(t.indptr), _host(t.indices), _host(t.data), t.shape)
    return COOArrays(_host(t.rows), _host(t.cols), _host(t.vals), t.shape, int(_host(t.nnz)))


def _walk(tree, leaf):
    if tree is None or isinstance(tree, numbers.Number):
        return tree
    if _is_sparse(tree):          # before the tuples: COOArrays is one
        return leaf(tree)
    if isinstance(tree, dict):
        return {key: _walk(v, leaf) for key, v in tree.items()}
    if isinstance(tree, tuple) and getattr(tree, "_fields", None) == GraphCOO._fields:
        return GraphCOO(*[_walk(v, leaf) for v in tree])
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*[_walk(v, leaf) for v in tree])
    if isinstance(tree, (list, tuple)):
        return type(tree)(_walk(v, leaf) for v in tree)
    return leaf(tree)


def from_reference(arrays, device="cuda"):
    """numpy arrays (or nested lists/tuples/dicts of them) as tensors on
    ``device``."""
    dev = resolve_device(device)
    return _walk(arrays, lambda a: _sparse_from_reference(a, dev) if _is_sparse(a)
                 else torch.from_numpy(np.array(a, copy=True, order="C")).to(dev))


def to_numpy(tensors):
    """Tensors (or nested lists/tuples/dicts of them) as numpy arrays."""
    return _walk(tensors, lambda t: _sparse_to_numpy(t) if _is_sparse(t) else _host(t))


def _index_from_reference(cls, index, device, **scalars):
    """``cls`` from an object with its fields: every array on ``device``
    with its dtype, the metric a :class:`DistanceType` and ``scalars``
    (field name: type) converted."""
    fields = {name: getattr(index, name) for name in cls._fields}
    fields["metric"] = DistanceType(int(fields["metric"]))
    for name, kind in scalars.items():
        fields[name] = kind(fields[name])
    return cls(**from_reference(fields, device))


def ivf_flat_index_from_reference(index, device="cuda") -> IVFFlatIndex:
    """The port's :class:`IVFFlatIndex` from the JAX package's (any object
    with its fields), every array on ``device`` with its dtype.  A missing
    ``slot_norms`` is computed from the vectors, as the JAX search does."""
    out = _index_from_reference(IVFFlatIndex, index, device, nprobe=int)
    if out.slot_norms is None:
        out = out._replace(slot_norms=(out.slot_vecs * out.slot_vecs).sum(dim=-1))
    return out


def ivf_flat_index_to_numpy(index: IVFFlatIndex) -> IVFFlatIndex:
    """The index with every array as numpy (metric and nprobe unchanged)."""
    return to_numpy(index)


def ivf_pq_index_from_reference(index, device="cuda") -> IVFPQIndex:
    """The port's :class:`IVFPQIndex` from the JAX package's: int32 codes,
    the codebooks with their padded ``inf`` rows, ``vectors`` where it has
    them."""
    return _index_from_reference(IVFPQIndex, index, device, nprobe=int, refine_ratio=int)


def ivf_pq_index_to_numpy(index: IVFPQIndex) -> IVFPQIndex:
    """The index with every array as numpy."""
    return to_numpy(index)


def ivf_sq_index_from_reference(index, device="cuda") -> IVFSQIndex:
    """The port's :class:`IVFSQIndex` from the JAX package's: the uint8
    store, float32 ``scale`` and ``offset``."""
    return _index_from_reference(IVFSQIndex, index, device, nprobe=int, encode_residual=bool)


def ivf_sq_index_to_numpy(index: IVFSQIndex) -> IVFSQIndex:
    """The index with every array as numpy."""
    return to_numpy(index)


def ball_cover_index_from_reference(index, device="cuda") -> BallCoverIndex:
    """The port's :class:`BallCoverIndex` from the JAX package's: the
    data, landmarks, int32 groups and float32 radii."""
    return _index_from_reference(BallCoverIndex, index, device)


def ooc_ivf_flat_from_reference(index, device="cuda") -> OocIVFFlat:
    """The port's :class:`OocIVFFlat` from the JAX package's: the
    metadata on ``device`` with its dtypes, ``slot_centroid`` (int32) and
    the slot ``store`` as writable host numpy arrays."""
    fields = {name: getattr(index, name) for name in OocIVFFlat._fields}
    host = {"slot_centroid": np.array(fields.pop("slot_centroid"), np.int32),
            "store": np.array(fields.pop("store"), copy=True, order="C")}
    fields["metric"] = DistanceType(int(fields["metric"]))
    fields["nprobe"] = int(fields["nprobe"])
    return OocIVFFlat(**from_reference(fields, device), **host)


def ooc_ivf_flat_to_numpy(index: OocIVFFlat) -> OocIVFFlat:
    """The index with every array as numpy (metric and nprobe unchanged)."""
    return to_numpy(index)
