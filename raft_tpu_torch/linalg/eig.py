"""Symmetric eigendecomposition.

Port of ``raft_tpu/linalg/eig.py`` (reference
cpp/include/raft/linalg/eig.cuh: ``eigDC`` :90, cuSOLVER syevd;
``eigSelDC`` :169; ``eigJacobi`` :276).  The JAX package computes these
with XLA's solver, outside any Pallas kernel, so the port's counterpart
is the library's: :func:`torch.linalg.eigh` (cuSOLVER on the card).
``eig_jacobi`` keeps its (tol, sweeps) signature and runs the same
solver, as in the JAX package.

Every variant returns eigenvalues ascending with matching eigenvectors
in columns, the reference's cuSOLVER convention.
"""

from __future__ import annotations

from typing import Tuple

import torch

from raft_tpu_torch.core.error import expects
from raft_tpu_torch.core.handle import takes_handle


def _check_square(a: torch.Tensor, name: str) -> None:
    expects(a.ndim == 2 and a.shape[0] == a.shape[1], "%s: matrix must be square", name)


def _eig_dc(a: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    _check_square(a, "eig_dc")
    w, v = torch.linalg.eigh(a)
    return v, w


@takes_handle
def eig_dc(a: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full symmetric eigendecomposition (reference eig.cuh:90 ``eigDC``):
    ``(eig_vectors, eig_vals)``, eigenvalues ascending, ``eig_vectors[:, i]``
    the i-th eigenvector."""
    return _eig_dc(a)


@takes_handle
def eig_sel_dc(a: torch.Tensor, n_eig_vals: int,
               largest: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """``n_eig_vals`` extreme eigenpairs (reference eig.cuh:169
    ``eigSelDC``): the smallest, ascending, or with ``largest`` the
    largest, in the solver's ascending order."""
    _check_square(a, "eig_sel_dc")
    expects(0 < n_eig_vals <= a.shape[0], "eig_sel_dc: n_eig_vals must be in (0, %d], got %d",
            a.shape[0], n_eig_vals)
    w, v = torch.linalg.eigh(a)
    if largest:
        return v[:, -n_eig_vals:], w[-n_eig_vals:]
    return v[:, :n_eig_vals], w[:n_eig_vals]


@takes_handle
def eig_jacobi(a: torch.Tensor, tol: float = 1e-7,
               sweeps: int = 15) -> Tuple[torch.Tensor, torch.Tensor]:
    """Jacobi-method signature (reference eig.cuh:276 ``eigJacobi``);
    ``tol`` and ``sweeps`` are accepted, and the solver is ``eig_dc``'s."""
    del tol, sweeps
    return _eig_dc(a)
