"""Exact nearest-neighbour search and k-selection."""

from raft_tpu_torch.spatial.fused_l2_knn import fused_l2_knn
from raft_tpu_torch.spatial.haversine import haversine_knn
from raft_tpu_torch.spatial.knn import brute_force_knn, knn_merge_parts
from raft_tpu_torch.spatial.select_k import select_k

__all__ = ["brute_force_knn", "fused_l2_knn", "haversine_knn",
           "knn_merge_parts", "select_k"]
