"""Modularity-based community detection.

Port of ``raft_tpu/spectral/modularity_maximization.py`` (reference
spectral/modularity_maximization.hpp: the largest eigenvectors of the
modularity matrix B = A - d d^T / 2E, :83, whitened, then k-means;
``analyzeModularity`` :143, Q = sum_c x_c^T B x_c / |d|_1).  Both
functions take ``handle=`` or ``device=``
(:func:`raft_tpu_torch.core.handle.takes_handle`, default ``"cuda"``).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from raft_tpu_torch.core.handle import takes_handle
from raft_tpu_torch.sparse.formats import CSR
from raft_tpu_torch.spectral._driver import solve_embed_cluster
from raft_tpu_torch.spectral.cluster_solvers import KmeansSolver
from raft_tpu_torch.spectral.eigen_solvers import LanczosSolver
from raft_tpu_torch.spectral.matrix_wrappers import ModularityMatrix
from raft_tpu_torch.spectral.spectral_util import construct_indicator


class ModularityResult(NamedTuple):
    clusters: torch.Tensor
    eig_vals: torch.Tensor
    eig_vecs: torch.Tensor
    iters_eig: int
    iters_cluster: int


@takes_handle
def modularity_maximization(csr: CSR, eigen_solver: Optional[LanczosSolver] = None,
                            cluster_solver: Optional[KmeansSolver] = None,
                            n_clusters: int = 2,
                            n_eig_vecs: Optional[int] = None) -> ModularityResult:
    """(reference modularity_maximization, modularity_maximization.hpp:83)"""
    return ModularityResult(*solve_embed_cluster(
        ModularityMatrix(csr), csr.n_rows, "largest", eigen_solver, cluster_solver,
        n_clusters, n_eig_vecs))


@takes_handle
def analyze_modularity(csr: CSR, n_clusters: int, clusters: torch.Tensor) -> torch.Tensor:
    """Modularity Q of a clustering (reference analyzeModularity,
    modularity_maximization.hpp:143)."""
    B = ModularityMatrix(csr)
    q = torch.zeros((), dtype=torch.float32, device=csr.device)
    for c in range(n_clusters):
        _, quad, ok = construct_indicator(c, clusters, B, device=csr.device)
        q = q + torch.where(ok, quad, 0.0)
    return q / B.edge_sum
