"""Minimum spanning tree or forest: Borůvka by segment minima.

Port of ``raft_tpu/sparse/mst.py`` (reference ``MST_solver``,
sparse/mst/mst_solver.cuh:42, and its ``solve()`` loop,
sparse/mst/detail/mst_solver_inl.cuh:111-219).  As in the JAX package,
each round picks every component's lightest outgoing edge by three
segment minima, over the weight, then the canonical edge id
``min(u, v) * V + max(u, v)``, then the entry index, so the (weight,
edge id) key is unique, the MST is unique, and the port's edge set
equals the JAX one on the same graph.  The minima are
``scatter_reduce(..., "amin")``: a minimum is exact in any order, so the
card's atomics change nothing.  Edge ids are int64.  Two components
that pick the same edge keep the smaller colour as root; colours merge
by bounded pointer jumping.

The JAX ``while_loop`` is a Python loop here, with one host read a round
(whether any edge still crosses components), capped at
``2 * ceil(log2 V) + 4`` rounds unless ``max_iterations`` says
otherwise.  The chosen entries are marked in a bitmap over the entry
list, then deduplicated by edge id and packed to the front.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from raft_tpu_torch.core.device import as_tensor
from raft_tpu_torch.core.handle import takes_handle
from raft_tpu_torch.sparse.formats import CSR

_INT32_MAX = 2**31 - 1
_INT64_MAX = 2**63 - 1


class GraphCOO(NamedTuple):
    """MST edge list (reference Graph_COO, mst_solver.cuh:27): capacity
    ``max(V - 1, 1)``; the first ``n_edges`` entries are the edges, the
    rest carry ``src == dst == -1`` and weight 0.  ``n_edges`` is a 0-d
    int32 tensor on the device."""

    src: torch.Tensor
    dst: torch.Tensor
    weights: torch.Tensor
    n_edges: torch.Tensor


def _pointer_jump(parent: torch.Tensor) -> torch.Tensor:
    """Parent pointers compressed to roots, in ``ceil(log2 V) + 2``
    doublings: enough for any forest; a pointer still off a root after
    them (a cycle, which only an asymmetric input makes) is cut to
    itself, so the solve stops on a forest instead of spinning."""
    V = parent.shape[0]
    p = parent
    for _ in range(max(int(V - 1).bit_length(), 1) + 2):
        p = p[p]
    return torch.where(p[p] == p, p, torch.arange(V, dtype=p.dtype, device=p.device))


def solve(csr: CSR, colors0: torch.Tensor, cap: int) -> Tuple[GraphCOO, torch.Tensor, int]:
    """Borůvka from the components ``colors0`` (int64, (V,)): the
    compacted edge list, the final colours (int32) and the rounds run."""
    V, E, dev = csr.n_rows, csr.capacity, csr.device
    rows = csr.row_ids()
    valid = rows < V
    safe_rows = torch.where(valid, rows, 0).long()
    safe_cols = torch.where(valid, csr.indices, 0).long()
    w = csr.data
    eid = torch.where(valid, torch.minimum(safe_rows, safe_cols) * V
                      + torch.maximum(safe_rows, safe_cols), _INT64_MAX)
    vidx = torch.arange(V, dtype=torch.int64, device=dev)
    eidx = torch.arange(E, dtype=torch.int64, device=dev)
    in_mst = torch.zeros(E + 1, dtype=torch.bool, device=dev)     # the last: a spare slot
    inf = torch.full((V,), float("inf"), dtype=w.dtype, device=dev)
    eid_max = torch.full((V,), _INT64_MAX, dtype=torch.int64, device=dev)
    color = colors0
    rounds = 0
    while rounds < cap:
        csrc = color[safe_rows]
        cross = valid & (csrc != color[safe_cols])
        if not bool(cross.any()):            # the round's one host read
            break
        rounds += 1
        # pass 1: each component's least weight over its outgoing edges
        minw = inf.scatter_reduce(0, csrc, torch.where(cross, w, float("inf")), "amin")
        is_min = cross & (w == minw[csrc])
        # pass 2: ties broken by canonical edge id (weight uniqueness)
        mine = eid_max.scatter_reduce(0, csrc, torch.where(is_min, eid, _INT64_MAX), "amin")
        is_min &= eid == mine[csrc]
        # pass 3: duplicate entries broken by entry index
        mini = eid_max.scatter_reduce(0, csrc, torch.where(is_min, eidx, _INT64_MAX), "amin")
        chosen = mini < _INT64_MAX          # per colour: it has an outgoing edge
        sel = torch.where(chosen, mini, 0)
        in_mst[torch.where(chosen, mini, E)] = True
        # merge: each choosing colour points at its target's colour; of a
        # 2-cycle the smaller colour stays root
        parent = torch.where(chosen, color[safe_cols[sel]], vidx)
        parent = torch.where(parent[parent] == vidx, torch.minimum(vidx, parent), parent)
        color = _pointer_jump(parent)[color]
    # extract: of the marked entries keep the first of each edge id, packed
    key = torch.where(in_mst[:E] & valid, eid, _INT64_MAX)
    k_sorted, order = torch.sort(key, stable=True)
    first = torch.cat([torch.ones(1, dtype=torch.bool, device=dev),
                       k_sorted[1:] != k_sorted[:-1]])
    keep = first & (k_sorted < _INT64_MAX)
    pack = torch.sort((~keep).to(torch.uint8), stable=True).indices
    n_cap = max(V - 1, 1)
    take = order[pack][:n_cap]
    kept = keep[pack][:n_cap]
    src = torch.where(kept, safe_rows[take], -1).to(torch.int32)
    dst = torch.where(kept, safe_cols[take], -1).to(torch.int32)
    weights = torch.where(kept, w[take], 0)
    return GraphCOO(src, dst, weights, kept.sum(dtype=torch.int32)), color.to(torch.int32), rounds


def round_cap(V: int, max_iterations: int = 0) -> int:
    """The rounds ``mst`` allows: ``max_iterations``, or 2 ceil(log2 V) + 4
    (more than any symmetric input needs)."""
    return max_iterations if max_iterations else 2 * max(int(V - 1).bit_length(), 1) + 4


@takes_handle
def mst(csr: CSR, colors: Optional[torch.Tensor] = None,
        max_iterations: int = 0) -> Tuple[GraphCOO, torch.Tensor]:
    """Borůvka MST or forest of a symmetric weighted CSR adjacency (both
    directions stored, weights the values).

    ``colors``: initial component labels (the restart path, reference
    detail/mst.cuh:95-104), default ``arange(V)``.  ``max_iterations``:
    the cap on rounds (:func:`round_cap`).  Returns the edge list
    (:class:`GraphCOO`, one entry a tree edge) and the final int32
    colours (the input graph's components, with the starting ones).
    """
    V = csr.n_rows
    if colors is None:
        colors0 = torch.arange(V, dtype=torch.int64, device=csr.device)
    else:
        colors0 = as_tensor(colors, csr.device, torch.int64)
    g, color, _ = solve(csr, colors0, round_cap(V, max_iterations))
    return g, color


def mst_weight(g: GraphCOO) -> torch.Tensor:
    """The total weight of the edge list (0-d, on its device)."""
    return torch.where(g.src >= 0, g.weights, 0).sum()
