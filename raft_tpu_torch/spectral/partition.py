"""Spectral graph partitioning.

Port of ``raft_tpu/spectral/partition.py`` (reference
spectral/partition.hpp:65-113: Laplacian -> smallest eigenvectors ->
whiten -> k-means; ``analyzePartition`` :133, the edge cut and the
ratio-cut cost).  Both functions take ``handle=`` or ``device=``
(:func:`raft_tpu_torch.core.handle.takes_handle`, default ``"cuda"``):
the CSR is moved there and, with a handle, the call runs on its main
stream.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from raft_tpu_torch.core.handle import takes_handle
from raft_tpu_torch.sparse.formats import CSR
from raft_tpu_torch.spectral._driver import solve_embed_cluster
from raft_tpu_torch.spectral.cluster_solvers import KmeansSolver
from raft_tpu_torch.spectral.eigen_solvers import LanczosSolver
from raft_tpu_torch.spectral.matrix_wrappers import LaplacianMatrix
from raft_tpu_torch.spectral.spectral_util import construct_indicator


class PartitionResult(NamedTuple):
    clusters: torch.Tensor   # (n,) int32 labels
    eig_vals: torch.Tensor   # (n_eig_vecs,)
    eig_vecs: torch.Tensor   # (n, n_eig_vecs)
    iters_eig: int
    iters_cluster: int


@takes_handle
def partition(csr: CSR, eigen_solver: Optional[LanczosSolver] = None,
              cluster_solver: Optional[KmeansSolver] = None, n_clusters: int = 2,
              n_eig_vecs: Optional[int] = None) -> PartitionResult:
    """Spectral partition of an undirected (symmetric) graph (reference
    spectral::partition, partition.hpp:65).  Solvers not given take the
    reference's default configurations."""
    return PartitionResult(*solve_embed_cluster(
        LaplacianMatrix(csr), csr.n_rows, "smallest", eigen_solver, cluster_solver,
        n_clusters, n_eig_vecs))


@takes_handle
def analyze_partition(csr: CSR, n_clusters: int, clusters: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(edge_cut, cost) (reference analyzePartition, partition.hpp:133):
    each cluster's Laplacian quadratic form of its indicator is its cut;
    the cost is the ratio cut, the sum of cut_c / size_c."""
    L = LaplacianMatrix(csr)
    edge_cut = torch.zeros((), dtype=torch.float32, device=csr.device)
    cost = torch.zeros((), dtype=torch.float32, device=csr.device)
    for c in range(n_clusters):
        size, quad, ok = construct_indicator(c, clusters, L, device=csr.device)
        cost = cost + torch.where(ok, quad / torch.clamp(size, min=1.0), 0.0)
        edge_cut = edge_cut + torch.where(ok, quad, 0.0) / 2.0
    return edge_cut, cost
