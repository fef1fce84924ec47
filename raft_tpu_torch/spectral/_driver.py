"""Shared eigenvector-embedding -> clustering driver.

Port of ``raft_tpu/spectral/_driver.py``.  Both spectral entry points
(partition.hpp:65, modularity_maximization.hpp:83) are one pipeline but
for the operator and the end of the spectrum: solve eigenvectors,
whiten, k-means.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from raft_tpu_torch.spectral.cluster_solvers import ClusterSolverConfig, KmeansSolver
from raft_tpu_torch.spectral.eigen_solvers import EigenSolverConfig, LanczosSolver
from raft_tpu_torch.spectral.spectral_util import transform_eigen_matrix


def solve_embed_cluster(op, n: int, which: str, eigen_solver: Optional[LanczosSolver],
                        cluster_solver: Optional[KmeansSolver], n_clusters: int,
                        n_eig_vecs: Optional[int]
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, int, int]:
    """(labels, eig_vals, eig_vecs, iters_eig, iters_cluster)."""
    if n_eig_vecs is None:
        n_eig_vecs = (eigen_solver.config.n_eig_vecs if eigen_solver is not None
                      else n_clusters)
    if eigen_solver is None:
        eigen_solver = LanczosSolver(EigenSolverConfig(n_eig_vecs=n_eig_vecs))
    if cluster_solver is None:
        cluster_solver = KmeansSolver(ClusterSolverConfig(n_clusters=n_clusters))
    solve = (eigen_solver.solve_smallest_eigenvectors if which == "smallest"
             else eigen_solver.solve_largest_eigenvectors)
    vals, vecs, it_eig = solve(op, n)
    labels, _, it_clu = cluster_solver.solve(transform_eigen_matrix(vecs, device=vecs.device))
    return labels, vals, vecs, it_eig, it_clu
