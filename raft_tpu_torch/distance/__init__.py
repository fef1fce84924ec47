"""Pairwise distances."""

from raft_tpu_torch.distance.distance_type import DistanceType
from raft_tpu_torch.distance.pairwise import pairwise_distance

__all__ = ["DistanceType", "pairwise_distance"]
