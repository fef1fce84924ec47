"""Implicit matrix operators for spectral methods.

Port of ``raft_tpu/spectral/matrix_wrappers.py`` (reference
spectral/matrix_wrappers.hpp: ``sparse_matrix_t`` with ``mv()`` :126,180,
``laplacian_matrix_t``, D - A as an implicit operator, :300,
``modularity_matrix_t``, A - d d^T / 2E, :372).

Plain classes with ``mv(x)``, on the device of their CSR.  The product
is :func:`raft_tpu_torch.sparse.linalg.spmv` over the matrix prepared
once at construction; the Laplacian and modularity corrections are
vector updates.

``densify``: the JAX package densifies on a TPU when the dense matrix
fits 2^22 elements, because an element gather is serial there; elsewhere
it keeps the sparse product.  The port runs on a GPU, so ``None`` keeps
the sparse product, as the JAX rule does off a TPU.  ``True`` stores the
dense matrix and multiplies it with :func:`raft_tpu_torch.core.precision.matmul`
(IEEE float32).  ``spmv_impl`` pins the SpMV route (``None``:
``"segment"``); a name that is not a route raises at construction.
"""

from __future__ import annotations

import torch

from raft_tpu_torch.core import precision
from raft_tpu_torch.core.device import as_tensor
from raft_tpu_torch.sparse.formats import CSR
from raft_tpu_torch.sparse.linalg import check_spmv_impl, spmv, spmv_plan


class SparseMatrix:
    """CSR operator with ``mv`` (reference sparse_matrix_t, :126)."""

    def __init__(self, csr: CSR, densify: bool | None = None, spmv_impl: str | None = None):
        # a misspelled route fails here, not deep inside a solve
        if spmv_impl is not None:
            check_spmv_impl(spmv_impl, "SparseMatrix")
        self.csr = csr
        self.spmv_impl = spmv_impl
        self.dense = csr.to_dense() if densify else None
        self._plan = None if densify else spmv_plan(csr)

    @property
    def n_rows(self) -> int:
        return self.csr.n_rows

    @property
    def device(self) -> torch.device:
        return self.csr.device

    def _ax(self, x: torch.Tensor) -> torch.Tensor:
        if not isinstance(x, torch.Tensor):
            x = as_tensor(x, self.device)
        if self.dense is not None:
            return precision.matmul(self.dense, x)
        return spmv(self._plan, x, self.spmv_impl or "segment")

    def mv(self, x: torch.Tensor) -> torch.Tensor:
        return self._ax(x)


class LaplacianMatrix(SparseMatrix):
    """Implicit graph Laplacian L = D - A (reference laplacian_matrix_t,
    :300); ``diagonal`` is the weighted degree vector."""

    def __init__(self, csr: CSR, diagonal: torch.Tensor | None = None,
                 densify: bool | None = None, spmv_impl: str | None = None):
        super().__init__(csr, densify=densify, spmv_impl=spmv_impl)
        if diagonal is None:
            if self.dense is not None:
                diagonal = self.dense.sum(dim=1)
            else:
                diagonal = self._ax(torch.ones(csr.n_cols, dtype=csr.data.dtype,
                                               device=csr.device))
        self.diagonal = as_tensor(diagonal, self.device)

    def mv(self, x: torch.Tensor) -> torch.Tensor:
        return self.diagonal * x - self._ax(x)


class ModularityMatrix(LaplacianMatrix):
    """Implicit modularity matrix B = A - d d^T / (2E) (reference
    modularity_matrix_t, :372); ``edge_sum`` = |d|_1 = 2E (:382)."""

    def __init__(self, csr: CSR, diagonal: torch.Tensor | None = None,
                 densify: bool | None = None, spmv_impl: str | None = None):
        super().__init__(csr, diagonal, densify=densify, spmv_impl=spmv_impl)
        self.edge_sum = self.diagonal.abs().sum()

    def mv(self, x: torch.Tensor) -> torch.Tensor:
        d = self.diagonal
        return self._ax(x) - d * (torch.dot(d, x) / self.edge_sum)
