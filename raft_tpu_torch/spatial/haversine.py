"""Haversine (great-circle) distance and kNN.

Port of ``raft_tpu/spatial/haversine.py`` (reference
haversine_distance.cuh).  The 2-D feature dimension makes this
element-wise work; the kNN runs on the tile scan
(:mod:`raft_tpu_torch.spatial.tiled_knn`), whose selections run on K2.
"""

from __future__ import annotations

from typing import Tuple

import torch

from raft_tpu_torch.core.device import as_tensor, resolve_device
from raft_tpu_torch.core.error import expects
from raft_tpu_torch.spatial.tiled_knn import tiled_knn


def haversine_distances(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """All-pairs haversine distance between (m, 2) and (n, 2) radian
    lat/lon rows (reference compute_haversine, haversine_distance.cuh:38)."""
    expects(x.ndim == 2 and x.shape[1] == 2 and y.ndim == 2 and y.shape[1] == 2,
            "haversine distance requires 2 dimensions (latitude / longitude).")
    sin_lat = torch.sin(0.5 * (x[:, None, 0] - y[None, :, 0]))
    sin_lon = torch.sin(0.5 * (x[:, None, 1] - y[None, :, 1]))
    rdist = sin_lat ** 2 + torch.cos(x[:, None, 0]) * torch.cos(y[None, :, 0]) * sin_lon ** 2
    return 2.0 * torch.arcsin(torch.sqrt(torch.clamp(rdist, 0.0, 1.0)))


def haversine_knn(
    index,
    queries,
    k: int,
    tile_n: int = 8192,
    device="cuda",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """k nearest index rows per query under haversine distance
    (reference haversine_knn, haversine_distance.cuh:120).

    Returns (distances, indices) of shape (n_queries, k), int32 ids.
    """
    dev = resolve_device(device)
    index = as_tensor(index, dev)
    queries = as_tensor(queries, dev)
    expects(queries.ndim == 2 and queries.shape[1] == 2,
            "haversine distance requires 2 dimensions (latitude / longitude).")
    return tiled_knn(index, queries, k, haversine_distances, tile_n=tile_n)
