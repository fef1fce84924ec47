"""raft_tpu_torch: the PyTorch/CUDA port of raft_tpu for NVIDIA Hopper.

The JAX package ``raft_tpu`` is the reference; this package imports
nothing of it, nor JAX.  Today it covers exact brute-force kNN and
pairwise distances (``brute_force_knn``, ``knn_merge_parts``,
``fused_l2_knn``, ``select_k``, ``pairwise_distance``,
``haversine_knn``), the fused L2 1-nearest-neighbour (``fused_l2_nn``,
``fused_l2_nn_min_reduce``), k-means (``kmeans``) and the IVF-Flat
approximate index (``ivf_flat_build``, ``ivf_flat_search``,
``ivf_flat_extend``, ``ivf_flat_reconstruct``, ``approx_knn_build_index``,
``approx_knn_search``), the serving layer in front of brute-force
kNN, pairwise distances and IVF-Flat (``KNNService``, ``PairwiseService``,
``ANNService``; more in :mod:`raft_tpu_torch.serve`), and the dense
library (:mod:`raft_tpu_torch.linalg`, :mod:`raft_tpu_torch.matrix`,
:mod:`raft_tpu_torch.stats`, :mod:`raft_tpu_torch.random`,
:mod:`raft_tpu_torch.label`, :mod:`raft_tpu_torch.lap`, with ``Handle`` in
:mod:`raft_tpu_torch.core.handle`), the sparse core
(:mod:`raft_tpu_torch.sparse`: COO and CSR, conversions, element ops,
linear algebra, ``fit_embedding``; pairwise distances and the kNN over
CSR, the kNN graph, the MST and ``single_linkage``) and spectral
partitioning on CSR (:mod:`raft_tpu_torch.spectral`: ``partition``,
``modularity_maximization``).  Each entry point takes ``device=``
(default ``"cuda"``) and raises when CUDA is asked for and missing;
``device="cpu"`` runs the plain PyTorch versions of the kernels.  The
kernels (``ops/``) are CUDA C++ for ``sm_90a``, built with ``nvcc`` at
first use.
"""

from raft_tpu_torch import config  # noqa: F401
from raft_tpu_torch.core.error import (CommError, CommTimeoutError, LogicError, RaftError,
                                       ServiceOverloadError, ServiceUnavailableError)
from raft_tpu_torch.distance import (DistanceType, fused_l2_nn, fused_l2_nn_min_reduce,
                                     pairwise_distance)
from raft_tpu_torch.spatial import (IVFFlatIndex, IVFFlatParams, approx_knn_build_index,
                                    approx_knn_search, brute_force_knn, fused_l2_knn,
                                    haversine_knn, ivf_flat_build, ivf_flat_extend,
                                    ivf_flat_reconstruct, ivf_flat_search, knn_merge_parts,
                                    select_k)
from raft_tpu_torch.serve import ANNService, KNNService, PairwiseService
from raft_tpu_torch.spectral import KmeansResult, kmeans

__version__ = "0.1.0"

__all__ = [
    "ANNService",
    "CommError",
    "CommTimeoutError",
    "DistanceType",
    "IVFFlatIndex",
    "IVFFlatParams",
    "KNNService",
    "KmeansResult",
    "LogicError",
    "PairwiseService",
    "RaftError",
    "ServiceOverloadError",
    "ServiceUnavailableError",
    "approx_knn_build_index",
    "approx_knn_search",
    "brute_force_knn",
    "fused_l2_knn",
    "fused_l2_nn",
    "fused_l2_nn_min_reduce",
    "haversine_knn",
    "ivf_flat_build",
    "ivf_flat_extend",
    "ivf_flat_reconstruct",
    "ivf_flat_search",
    "kmeans",
    "knn_merge_parts",
    "pairwise_distance",
    "select_k",
]
