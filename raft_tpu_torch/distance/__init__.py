"""Pairwise distances and the fused L2 1-nearest-neighbour."""

from raft_tpu_torch.distance.distance_type import DistanceType
from raft_tpu_torch.distance.fused_l2_nn import (IDX_SENTINEL, fused_l2_nn,
                                                 fused_l2_nn_min_reduce)
from raft_tpu_torch.distance.pairwise import distance, get_workspace_size, pairwise_distance

__all__ = ["DistanceType", "IDX_SENTINEL", "distance", "fused_l2_nn", "fused_l2_nn_min_reduce",
           "get_workspace_size", "pairwise_distance"]
