"""Spectral embedding of a sparse graph.

Port of ``raft_tpu/sparse/spectral.py`` (reference
sparse/linalg/spectral.hpp:25 ``fit_embedding`` ->
detail/spectral.cuh:33-80): COO -> CSR -> Laplacian -> the
(n_components + 1) smallest eigenvectors by Lanczos -> whitening -> the
trivial constant eigenvector dropped.
"""

from __future__ import annotations

import torch

from raft_tpu_torch.core.handle import takes_handle
from raft_tpu_torch.sparse.convert import coo_to_csr
from raft_tpu_torch.sparse.formats import COO


@takes_handle
def fit_embedding(coo: COO, n_components: int, seed: int = 1234567, maxiter: int = 4000,
                  tol: float = 0.01) -> torch.Tensor:
    """(n, n_components) spectral embedding of a symmetric COO graph.

    The solver's configuration is the reference's cuGraph-derived default
    (detail/spectral.cuh:68-74: maxiter 4000, tol 0.01, restart_iter 15 +
    the eigenvectors wanted).
    """
    # deferred: raft_tpu_torch.spectral imports raft_tpu_torch.sparse when
    # the package is imported, so importing it here at module scope would
    # be circular
    from raft_tpu_torch.spectral.eigen_solvers import EigenSolverConfig, LanczosSolver
    from raft_tpu_torch.spectral.matrix_wrappers import LaplacianMatrix
    from raft_tpu_torch.spectral.spectral_util import transform_eigen_matrix

    neigvs = n_components + 1
    L = LaplacianMatrix(coo_to_csr(coo))
    solver = LanczosSolver(EigenSolverConfig(n_eig_vecs=neigvs, max_iter=maxiter,
                                             restart_iter=15 + neigvs, tol=tol, seed=seed))
    _, vecs, _ = solver.solve_smallest_eigenvectors(L, coo.n_rows)
    return transform_eigen_matrix(vecs, device=vecs.device)[:, 1:]
