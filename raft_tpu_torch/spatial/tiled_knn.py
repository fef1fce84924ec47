"""Tile-scan kNN.

Port of ``raft_tpu/spatial/tiled_knn.py``: stream index tiles, compute a
distance tile, keep each tile's k best, and merge them with the running
top-k.  The JAX ``lax.scan`` becomes a Python loop; both selections go
through :func:`raft_tpu_torch.spatial.select_k.select_k`, so on the card
they run on K2.  The running top-k holds smaller ids than the tile and
sits first in the merge, so ties resolve to the smaller id.

This is the CPU route of ``fused_l2_knn``, the route of k > 128 and of
the rerank mode's first stage (the JAX package pins that to its tile
scan too), and of the haversine kNN.  With ``select_impl="approx95"``
each tile's select is approximate; the merges of 2k columns fold nothing
(``spatial/select_k.py:approx_bins`` gives r = 0 there), so they stay
exact, as the JAX scan's merge sort is.  The JAX ``tile_merge`` knob and
query donation have no counterpart.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch

from raft_tpu_torch.core.error import expects
from raft_tpu_torch.spatial.select_k import select_k


def tiled_knn(
    index: torch.Tensor,
    queries: torch.Tensor,
    k: int,
    tile_dist: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
    tile_n: int = 8192,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """k best (smallest-distance) index rows per query.

    ``tile_dist(queries, index_tile) -> (n_queries, tile_rows)`` computes
    one distance tile.  Returns (n_queries, k) float32 ascending and int32
    ids.
    """
    n = index.shape[0]
    expects(0 < k <= n, "tiled_knn: k=%d out of range for n_index=%d", k, n)
    tile_n = max(k, min(tile_n, n))
    dev = queries.device
    best_d = best_i = None
    for j0 in range(0, n, tile_n):
        d = tile_dist(queries, index[j0:j0 + tile_n]).to(torch.float32)
        t_d, t_i = select_k(d, min(k, d.shape[1]), device=dev)
        t_i = t_i + j0
        if best_d is not None:
            t_d, t_i = select_k(torch.cat([best_d, t_d], dim=1), k,
                                values=torch.cat([best_i, t_i], dim=1), device=dev)
        best_d, best_i = t_d, t_i
    return best_d, best_i
