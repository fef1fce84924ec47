"""Nearest-neighbour search: exact (brute force) and approximate
(IVF-Flat), and k-selection."""

from raft_tpu_torch.spatial.ann import (IVFFlatIndex, IVFFlatParams, approx_knn_build_index,
                                        approx_knn_search, ivf_flat_build, ivf_flat_extend,
                                        ivf_flat_reconstruct, ivf_flat_search)
from raft_tpu_torch.spatial.fused_l2_knn import fused_l2_knn
from raft_tpu_torch.spatial.haversine import haversine_knn
from raft_tpu_torch.spatial.knn import brute_force_knn, knn_merge_parts
from raft_tpu_torch.spatial.select_k import select_k

__all__ = ["IVFFlatIndex", "IVFFlatParams", "approx_knn_build_index", "approx_knn_search",
           "brute_force_knn", "fused_l2_knn", "haversine_knn", "ivf_flat_build",
           "ivf_flat_extend", "ivf_flat_reconstruct", "ivf_flat_search", "knn_merge_parts",
           "select_k"]
