"""Clustering: k-means with k-means++ initialisation."""

from raft_tpu_torch.spectral.kmeans import KmeansResult, kmeans

__all__ = ["KmeansResult", "kmeans"]
