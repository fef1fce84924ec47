"""raft_tpu_torch: the PyTorch/CUDA port of raft_tpu for NVIDIA Hopper.

The JAX package ``raft_tpu`` is the reference; this package imports
nothing of it, nor JAX.  Today it covers exact brute-force kNN and
pairwise distances: ``brute_force_knn``, ``knn_merge_parts``,
``fused_l2_knn``, ``select_k``, ``pairwise_distance`` and
``haversine_knn``.  Each takes ``device=`` (default ``"cuda"``) and raises
when CUDA is asked for and missing; ``device="cpu"`` runs the plain
PyTorch versions of the kernels.  The kernels (``ops/``) are CUDA C++ for
``sm_90a``, built with ``nvcc`` at first use.
"""

from raft_tpu_torch.core.error import LogicError, RaftError
from raft_tpu_torch.distance import DistanceType, pairwise_distance
from raft_tpu_torch.spatial import (brute_force_knn, fused_l2_knn, haversine_knn,
                                    knn_merge_parts, select_k)

__version__ = "0.1.0"

__all__ = [
    "DistanceType",
    "LogicError",
    "RaftError",
    "brute_force_knn",
    "fused_l2_knn",
    "haversine_knn",
    "knn_merge_parts",
    "pairwise_distance",
    "select_k",
]
