"""Sparse containers: padded, fixed-capacity COO and CSR.

Port of ``raft_tpu/sparse/formats.py`` (reference ``raft::sparse::COO``,
sparse/detail/coo.cuh:46, and the CSR convention of sparse/csr.hpp).
The JAX package keeps its containers at a fixed capacity because XLA
needs static shapes; the port keeps the same contract, so that a
container carried from the JAX package (``raft_tpu_torch.convert``)
compares entry by entry:

- the arrays have length ``capacity``; only the first ``nnz`` entries
  (after compaction) are real;
- padding entries carry ``row == n_rows`` (the sentinel), which sorts
  after every real row, so sorted containers keep their padding at the
  tail and ``searchsorted``-built indptrs are right as they are;
- ids are int32;
- ``COO.nnz`` is a Python int or a 0-d int32 tensor on the container's
  device (what an nnz-changing op returns: reading it would make the
  host wait for the card); ``CSR.nnz`` is ``indptr[-1]``.

They are plain classes holding tensors, not pytrees.  The constructors
and ``from_dense`` take ``device=`` (default ``"cuda"``; raises when
CUDA is missing) and move their arrays there; everything else runs on
the container's device.  ``to_device`` moves a container, which is how
:func:`raft_tpu_torch.core.handle.takes_handle` moves one given to a
primitive.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from raft_tpu_torch.core.device import as_tensor, resolve_device
from raft_tpu_torch.core.error import expects


def _scatter_dense(shape, rows, cols, vals, mask) -> torch.Tensor:
    """Dense (shape) of the masked entries; duplicates summed (on the
    card in no fixed order)."""
    out = torch.zeros(shape, dtype=vals.dtype, device=vals.device)
    r = torch.where(mask, rows, 0).long()
    c = torch.where(mask, cols, 0).long()
    return out.index_put_((r, c), torch.where(mask, vals, 0), accumulate=True)


class COO:
    """Coordinate-format sparse matrix (padded, fixed capacity).

    ``rows``, ``cols``: int32 (capacity,); ``vals``: (capacity,);
    ``shape``: (n_rows, n_cols); ``nnz``: the valid entries (default the
    capacity).
    """

    def __init__(self, rows, cols, vals, shape: Tuple[int, int], nnz=None, device="cuda"):
        dev = resolve_device(device)
        self.rows = as_tensor(rows, dev, torch.int32)
        self.cols = as_tensor(cols, dev, torch.int32)
        self.vals = as_tensor(vals, dev)
        self.shape = (int(shape[0]), int(shape[1]))
        self.nnz = self.capacity if nnz is None else (
            nnz.to(dev) if isinstance(nnz, torch.Tensor) else int(nnz))

    @property
    def capacity(self) -> int:
        return int(self.rows.shape[0])

    @property
    def n_rows(self) -> int:
        return self.shape[0]

    @property
    def n_cols(self) -> int:
        return self.shape[1]

    @property
    def sentinel(self) -> int:
        """Row id marking padding entries (sorts after all valid rows)."""
        return self.shape[0]

    @property
    def device(self) -> torch.device:
        return self.rows.device

    def tensors(self):
        """The container's tensors (for stream bookkeeping)."""
        nnz = (self.nnz,) if isinstance(self.nnz, torch.Tensor) else ()
        return (self.rows, self.cols, self.vals) + nnz

    def to_device(self, device) -> "COO":
        """The container on ``device`` (itself where it already is)."""
        dev = resolve_device(device)
        if dev == self.device or (dev.index is None and dev.type == self.device.type):
            return self
        return COO(self.rows, self.cols, self.vals, self.shape, self.nnz, device=dev)

    def valid_mask(self) -> torch.Tensor:
        """Boolean mask of real (non-padding) entries."""
        return self.rows < self.shape[0]

    @classmethod
    def from_dense(cls, dense, capacity: int | None = None, device="cuda") -> "COO":
        """Construction from a dense matrix (on the host, then moved to
        ``device``)."""
        d = np.asarray(dense.cpu() if isinstance(dense, torch.Tensor) else dense)
        r, c = np.nonzero(d)
        nnz = len(r)
        cap = capacity if capacity is not None else max(nnz, 1)
        expects(cap >= nnz, "from_dense: capacity %d below the %d nonzeros", cap, nnz)
        rows = np.full(cap, d.shape[0], dtype=np.int32)
        cols = np.zeros(cap, dtype=np.int32)
        vals = np.zeros(cap, dtype=d.dtype)
        rows[:nnz], cols[:nnz], vals[:nnz] = r, c, d[r, c]
        return cls(rows, cols, vals, d.shape, nnz, device=device)

    def to_dense(self) -> torch.Tensor:
        """Densify; duplicate coordinates are summed."""
        return _scatter_dense(self.shape, self.rows, self.cols, self.vals, self.valid_mask())

    def compact(self) -> "COO":
        """Trim padding to the true nnz (reads nnz on the host)."""
        n = int(self.nnz)
        order = torch.sort((~self.valid_mask()).to(torch.uint8), stable=True).indices[:n]
        return COO(self.rows[order], self.cols[order], self.vals[order], self.shape, n,
                   device=self.device)

    def __repr__(self):
        return "COO(shape=%s, capacity=%d, nnz=%s)" % (self.shape, self.capacity, self.nnz)


class CSR:
    """Compressed-sparse-row matrix (padded, fixed capacity).

    ``indptr`` (n_rows + 1,) indexes into ``indices`` / ``data``;
    entries at positions >= ``indptr[-1]`` are padding.
    """

    def __init__(self, indptr, indices, data, shape: Tuple[int, int], device="cuda"):
        dev = resolve_device(device)
        self.indptr = as_tensor(indptr, dev, torch.int32)
        self.indices = as_tensor(indices, dev, torch.int32)
        self.data = as_tensor(data, dev)
        self.shape = (int(shape[0]), int(shape[1]))

    @property
    def capacity(self) -> int:
        return int(self.indices.shape[0])

    @property
    def nnz(self) -> torch.Tensor:
        return self.indptr[-1]

    @property
    def n_rows(self) -> int:
        return self.shape[0]

    @property
    def n_cols(self) -> int:
        return self.shape[1]

    @property
    def device(self) -> torch.device:
        return self.indptr.device

    def tensors(self):
        """The container's tensors (for stream bookkeeping)."""
        return (self.indptr, self.indices, self.data)

    def to_device(self, device) -> "CSR":
        """The container on ``device`` (itself where it already is)."""
        dev = resolve_device(device)
        if dev == self.device or (dev.index is None and dev.type == self.device.type):
            return self
        return CSR(self.indptr, self.indices, self.data, self.shape, device=dev)

    def row_ids(self) -> torch.Tensor:
        """Per-entry row id, int32 (padding entries get n_rows): the
        segment ids that stand for the reference's per-row kernel
        launches (sparse/op/row_op.hpp:37)."""
        pos = torch.arange(self.capacity, dtype=torch.int32, device=self.device)
        r = torch.searchsorted(self.indptr, pos, right=True, out_int32=True) - 1
        return torch.where(pos < self.indptr[-1], r, self.shape[0])

    @classmethod
    def from_dense(cls, dense, capacity: int | None = None, device="cuda") -> "CSR":
        """Construction from a dense matrix (on the host, then moved to
        ``device``)."""
        d = np.asarray(dense.cpu() if isinstance(dense, torch.Tensor) else dense)
        r, c = np.nonzero(d)
        nnz = len(r)
        cap = capacity if capacity is not None else max(nnz, 1)
        expects(cap >= nnz, "from_dense: capacity %d below the %d nonzeros", cap, nnz)
        indptr = np.zeros(d.shape[0] + 1, dtype=np.int32)
        np.add.at(indptr[1:], r, 1)
        indptr = np.cumsum(indptr).astype(np.int32)
        indices = np.zeros(cap, dtype=np.int32)
        data = np.zeros(cap, dtype=d.dtype)
        indices[:nnz], data[:nnz] = c, d[r, c]
        return cls(indptr, indices, data, d.shape, device=device)

    def to_dense(self) -> torch.Tensor:
        """Densify; duplicate coordinates are summed."""
        rows = self.row_ids()
        return _scatter_dense(self.shape, rows, self.indices, self.data, rows < self.shape[0])

    def __repr__(self):
        return "CSR(shape=%s, capacity=%d)" % (self.shape, self.capacity)
