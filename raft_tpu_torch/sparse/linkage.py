"""Graph connection fix-up: each component's nearest other component.

Port of ``raft_tpu/sparse/linkage.py`` (reference ``connect_components``,
sparse/selection/detail/connect_components.cuh:89,215,230): every point
finds its nearest neighbour of another colour, then each component keeps
its single best cross edge, emitted in both directions as a COO that
stitches a disconnected graph together.

The scan is the JAX one: :func:`raft_tpu_torch.distance.fused_l2_nn.fused_l2_nn_min_reduce`
with the colour test as a per-tile mask (``tile_mask_fn``), plain torch
as it is plain XLA in JAX (its float32 products pinned IEEE).  K4 takes
no mask, so it is not on this path.  One (rows, tile_n) temporary of the
whole row set would be 16 GB at a million rows, so the rows of ``X`` go
through in chunks whose (rows, tile_n) float32 temporary stays within
:data:`ROW_BUDGET_BYTES`; a row's result depends on that row alone.
Ties: ``torch.min`` takes the first index among equal minima (the JAX
rule toward the smaller index), and a component's best edge is the
smallest point index among its equal minima.
"""

from __future__ import annotations

from typing import Tuple

import torch

from raft_tpu_torch.core.handle import takes_handle
from raft_tpu_torch.distance.fused_l2_nn import fused_l2_nn_min_reduce
from raft_tpu_torch.sparse.formats import COO

# bytes of one (rows, tile_n) float32 temporary of the masked scan; the
# scan holds a few of them at once
ROW_BUDGET_BYTES = 512 * 2**20
_INT32_MAX = 2**31 - 1


@takes_handle
def cross_color_nn(X: torch.Tensor, colors: torch.Tensor, sqrt: bool = True,
                   tile_n: int = 4096) -> Tuple[torch.Tensor, torch.Tensor]:
    """For each point, its nearest neighbour of another colour: ((m,)
    distances, (m,) int32 ids); a point with none keeps (inf,
    IDX_SENTINEL).  The fusedL2NN + FixConnectivitiesRedOp composition
    (connect_components.cuh:230)."""
    c = colors.to(torch.int32)
    m = X.shape[0]
    tile = min(tile_n, m)
    rows = max(1, ROW_BUDGET_BYTES // (4 * tile))
    dists, ids = [], []
    for r0 in range(0, m, rows):
        cr = c[r0:r0 + rows, None]

        def color_mask(j0, tn, cr=cr):
            # the last tile is narrower: its mask is as wide as its columns
            return cr != c[None, j0:j0 + tn]

        d, j = fused_l2_nn_min_reduce(X[r0:r0 + rows], X, sqrt=sqrt, tile_n=tile,
                                      tile_mask_fn=color_mask, device=X.device)
        dists.append(d)
        ids.append(j)
    return torch.cat(dists), torch.cat(ids)


@takes_handle
def connect_components(X: torch.Tensor, colors: torch.Tensor, sqrt: bool = True) -> COO:
    """Symmetric edges joining each component to its nearest other
    component (reference connect_components, connect_components.cuh:215):
    a COO (m, m) of capacity 2m, padding rows the sentinel."""
    m = X.shape[0]
    d, j = cross_color_nn(X, colors, sqrt=sqrt, device=X.device)
    c = colors.long()
    # each component's best (distance, point index): two segment minima
    mind = torch.full((m,), float("inf"), dtype=d.dtype, device=d.device).scatter_reduce(
        0, c, d, "amin")
    is_min = (d == mind[c]) & torch.isfinite(d)
    pidx = torch.arange(m, dtype=torch.int64, device=d.device)
    minp = torch.full((m,), _INT32_MAX, dtype=torch.int64, device=d.device).scatter_reduce(
        0, c, torch.where(is_min, pidx, _INT32_MAX), "amin")
    chosen = minp < _INT32_MAX             # per colour id
    src = torch.where(chosen, minp, 0)
    dst = j[src].long()
    wv = torch.where(chosen, d[src], 0)
    rows = torch.cat([torch.where(chosen, src, m), torch.where(chosen, dst, m)])
    cols = torch.cat([torch.where(chosen, dst, 0), torch.where(chosen, src, 0)])
    return COO(rows, cols, torch.cat([wv, wv]), (m, m), nnz=2 * chosen.sum(dtype=torch.int32),
               device=X.device)
