"""Eigen solver facade over the thick-restart Lanczos driver.

Port of ``raft_tpu/spectral/eigen_solvers.py`` (reference
spectral/eigen_solvers.hpp: ``eigen_solver_config_t`` :27,
``lanczos_solver_t`` :42), delegating to
:mod:`raft_tpu_torch.linalg.lanczos` with the operator's ``mv``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch

from raft_tpu_torch.linalg.lanczos import (compute_largest_eigenvectors,
                                           compute_smallest_eigenvectors)


@dataclass
class EigenSolverConfig:
    """(reference eigen_solver_config_t, eigen_solvers.hpp:27)"""

    n_eig_vecs: int
    max_iter: int = 4000
    restart_iter: int = 0
    tol: float = 1e-9
    reorthogonalize: bool = True  # the thick-restart driver always does
    seed: int = 1234567


def _operator(op):
    """(matrix or ``mv``, device): an operator's ``mv`` on its device, a
    tensor on its own, a bare callable on the default device."""
    if hasattr(op, "mv"):
        return op.mv, op.device
    if isinstance(op, torch.Tensor):
        return op, op.device
    return op, None


class LanczosSolver:
    """(reference lanczos_solver_t, eigen_solvers.hpp:42)"""

    def __init__(self, config: EigenSolverConfig):
        self.config = config

    def _solve(self, fn, op, n: int):
        c = self.config
        a, device = _operator(op)
        return fn(a, n, c.n_eig_vecs, maxiter=c.max_iter, restart_iter=c.restart_iter,
                  tol=c.tol, seed=c.seed, device=device)

    def solve_smallest_eigenvectors(self, op, n: int) -> Tuple[torch.Tensor, torch.Tensor, int]:
        """(eigenvalues ascending, eigenvectors as columns, iterations)."""
        return self._solve(compute_smallest_eigenvectors, op, n)

    def solve_largest_eigenvectors(self, op, n: int) -> Tuple[torch.Tensor, torch.Tensor, int]:
        """(eigenvalues descending, eigenvectors as columns, iterations)."""
        return self._solve(compute_largest_eigenvectors, op, n)
