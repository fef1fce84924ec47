"""Cluster solver facade (reference spectral/cluster_solvers.hpp).

Port of ``raft_tpu/spectral/cluster_solvers.py``:
``cluster_solver_config_t`` (:28) and ``kmeans_solver_t`` (:38), the
clustering stage of spectral partitioning and modularity maximization,
delegating to :func:`raft_tpu_torch.spectral.kmeans.kmeans`.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch

from raft_tpu_torch.spectral.kmeans import kmeans


@dataclass
class ClusterSolverConfig:
    """(reference cluster_solver_config_t, cluster_solvers.hpp:28)"""

    n_clusters: int
    max_iter: int = 300
    tol: float = 1e-4
    seed: int = 123456
    # spectral embeddings are small (n x n_eig_vecs) but rich in Lloyd
    # local optima: restarts cost little there, and the lowest residual
    # wins
    n_init: int = 8


class KmeansSolver:
    """(reference kmeans_solver_t, cluster_solvers.hpp:38)"""

    def __init__(self, config: ClusterSolverConfig):
        self.config = config

    def solve(self, obs) -> Tuple[torch.Tensor, torch.Tensor, int]:
        """Cluster the rows of ``obs`` on its device (a numpy array goes
        to ``"cuda"``): (labels, residual, iterations)."""
        c = self.config
        device = obs.device if isinstance(obs, torch.Tensor) else "cuda"
        res = kmeans(obs, c.n_clusters, tol=c.tol, max_iter=c.max_iter, seed=c.seed,
                     n_init=c.n_init, device=device)
        return res.labels, res.residual, res.iters
