"""Singular value decomposition.

Port of ``raft_tpu/linalg/svd.py`` (reference
cpp/include/raft/linalg/svd.cuh: ``svdQR`` :55, ``svdEig`` :136,
``svdJacobi`` :213, ``svdReconstruction`` :296,
``evaluateSVDByL2Norm`` :329).  As in the JAX package, which runs XLA's
solver outside any Pallas kernel, ``svd_qr`` is the library's SVD
(:func:`torch.linalg.svd`, cuSOLVER on the card) and ``svd_jacobi``
keeps its (tol, sweeps) signature and runs the same solver;
``svd_eig`` keeps the real AᵀA algorithm: one (n, n) eigensolve and one
product for U, its products in IEEE float32
(:mod:`raft_tpu_torch.core.precision`).
"""

from __future__ import annotations

from typing import Tuple

import torch

from raft_tpu_torch.core import precision
from raft_tpu_torch.core.error import expects
from raft_tpu_torch.core.handle import takes_handle


def _svd_qr(a, gen_u=True, gen_v=True):
    u, s, vt = torch.linalg.svd(a, full_matrices=False)
    return (u if gen_u else None), s, (vt.T if gen_v else None)


def _svd_reconstruction(u, s, v):
    return precision.matmul(u * s[None, :], v.T)


@takes_handle
def svd_qr(a: torch.Tensor, gen_u: bool = True,
           gen_v: bool = True) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Thin SVD ``a = u @ diag(s) @ v.T`` (reference svd.cuh:55
    ``svdQR``): ``(u, s, v)``, the right singular vectors in the columns
    of ``v``, singular values descending."""
    return _svd_qr(a, gen_u, gen_v)


@takes_handle
def svd_eig(a: torch.Tensor,
            gen_left_vec: bool = True) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """SVD through the eigendecomposition of AᵀA (reference
    svd.cuh:136), for (m, n) with m >= n; singular values descend."""
    m, n = a.shape
    expects(m >= n, "svd_eig: requires m >= n (got %d x %d)", m, n)
    w, v = torch.linalg.eigh(precision.matmul(a.T, a))
    # ascending eigenvalues -> descending singular values
    w, v = w.flip(0), v.flip(1)
    s = torch.sqrt(torch.clamp(w, min=0.0))
    u = None
    if gen_left_vec:
        u = precision.matmul(a, v) / torch.where(s > 0, s, 1.0)[None, :]
    return u, s, v


@takes_handle
def svd_jacobi(a: torch.Tensor, gen_u: bool = True, gen_v: bool = True, tol: float = 1e-7,
               sweeps: int = 15) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Jacobi-SVD signature (reference svd.cuh:213 ``svdJacobi``); the
    solver is ``svd_qr``'s."""
    del tol, sweeps
    return _svd_qr(a, gen_u, gen_v)


@takes_handle
def svd_reconstruction(u: torch.Tensor, s: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``u @ diag(s) @ v.T`` (reference svd.cuh:296)."""
    return _svd_reconstruction(u, s, v)


@takes_handle
def evaluate_svd_by_l2_norm(a: torch.Tensor, u: torch.Tensor, s: torch.Tensor,
                            v: torch.Tensor, tol: float) -> bool:
    """Whether the relative Frobenius error of the reconstruction is
    below ``tol`` (reference svd.cuh:329)."""
    recon = _svd_reconstruction(u, s, v)
    err = torch.linalg.norm(a - recon) / torch.clamp(torch.linalg.norm(a), min=1e-30)
    return bool(err < tol)
