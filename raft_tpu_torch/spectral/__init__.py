"""Spectral graph analysis: implicit operators, eigen and cluster
solvers, graph partitioning, modularity maximization, and k-means.

Port of ``raft_tpu/spectral`` (reference cpp/include/raft/spectral/).
"""

from raft_tpu_torch.spectral.cluster_solvers import ClusterSolverConfig, KmeansSolver
from raft_tpu_torch.spectral.eigen_solvers import EigenSolverConfig, LanczosSolver
from raft_tpu_torch.spectral.kmeans import KmeansResult, kmeans
from raft_tpu_torch.spectral.matrix_wrappers import (LaplacianMatrix, ModularityMatrix,
                                                     SparseMatrix)
from raft_tpu_torch.spectral.modularity_maximization import (analyze_modularity,
                                                             modularity_maximization)
from raft_tpu_torch.spectral.partition import analyze_partition, partition

__all__ = ["ClusterSolverConfig", "EigenSolverConfig", "KmeansResult", "KmeansSolver",
           "LanczosSolver", "LaplacianMatrix", "ModularityMatrix", "SparseMatrix",
           "analyze_modularity", "analyze_partition", "kmeans", "modularity_maximization",
           "partition"]
