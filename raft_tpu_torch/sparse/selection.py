"""Sparse brute-force kNN and the kNN graph.

Port of ``raft_tpu/sparse/selection.py`` (reference
sparse/selection/knn.hpp:52 ``brute_force_knn`` over CSR, engine
selection/detail/knn.cuh:117,162; sparse/selection/knn_graph.hpp:46).
The dataflow is the JAX one: query and index row tiles, the block
distances of a densified query tile against a densified index tile
(:func:`raft_tpu_torch.sparse.distance.block_pairwise`), a per-block
``select_k`` and a running ``knn_merge_parts`` over [running, block]; on
the card both selections are K2 (k <= 128).  The JAX package densifies
every index tile up front; the port densifies one index tile per step,
which holds two dense tiles at a time and gives the same result.  Both
functions take ``handle=`` or ``device=``
(:func:`raft_tpu_torch.core.handle.takes_handle`, default ``"cuda"``).
"""

from __future__ import annotations

from typing import Tuple

import torch

from raft_tpu_torch.core.error import expects
from raft_tpu_torch.core.handle import takes_handle
from raft_tpu_torch.distance.distance_type import DistanceType
from raft_tpu_torch.sparse.distance import block_pairwise, densify, unique_entries
from raft_tpu_torch.sparse.formats import COO, CSR
from raft_tpu_torch.sparse.linalg import symmetrize_knn
from raft_tpu_torch.spatial.knn import brute_force_knn as dense_knn
from raft_tpu_torch.spatial.knn import knn_merge_parts
from raft_tpu_torch.spatial.select_k import select_k

D = DistanceType


@takes_handle
def brute_force_knn(idx: CSR, query: CSR, k: int, metric: DistanceType = D.L2Expanded,
                    metric_arg: float = 2.0, batch_size_index: int = 2048,
                    batch_size_query: int = 2048) -> Tuple[torch.Tensor, torch.Tensor]:
    """k nearest index rows for every query row, both CSR.

    Returns (distances, indices) of shape (n_query, k), best-first, int32
    ids (reference sparse/selection/knn.hpp:52).  Where an index tile
    holds fewer than k rows its block result is padded with the worst
    distance and id -1, and those pads never become ids.
    """
    m, nq = idx.n_rows, query.n_rows
    expects(0 < k <= m, "sparse brute_force_knn: k=%d out of range for n_index=%d", k, m)
    expects(idx.n_cols == query.n_cols,
            "sparse brute_force_knn: dimensionality mismatch (%d vs %d)", idx.n_cols,
            query.n_cols)
    dev = idx.device
    select_min = metric != D.InnerProduct
    worst = float("inf") if select_min else float("-inf")
    bi, bq = min(batch_size_index, m), min(batch_size_query, nq)
    ie, qe = unique_entries(idx), unique_entries(query)
    out_d = torch.empty((nq, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((nq, k), dtype=torch.int32, device=dev)
    for q0 in range(0, nq, bq):
        xq = densify(qe, q0, min(bq, nq - q0), 0, query.n_cols)
        run_d = torch.full((xq.shape[0], k), worst, dtype=torch.float32, device=dev)
        run_i = torch.full((xq.shape[0], k), -1, dtype=torch.int32, device=dev)
        for i0 in range(0, m, bi):
            xi = densify(ie, i0, min(bi, m - i0), 0, idx.n_cols)
            blk = block_pairwise(xq, xi, metric, metric_arg).to(torch.float32)
            kk = min(k, xi.shape[0])
            bd, bl = select_k(blk, kk, select_min=select_min, device=dev)
            if kk < k:        # pad the block result up to k candidates
                bd = torch.nn.functional.pad(bd, (0, k - kk), value=worst)
                bl = torch.nn.functional.pad(bl, (0, k - kk), value=-1)
            # translate the real entries only: pads stay -1
            bg = torch.where(bl >= 0, bl + i0, -1).to(torch.int32)
            run_d, run_i = knn_merge_parts(torch.stack([run_d, bd]), torch.stack([run_i, bg]),
                                           k, select_min=select_min, device=dev)
        out_d[q0:q0 + xq.shape[0]] = run_d
        out_i[q0:q0 + xq.shape[0]] = run_i
    return out_d, out_i


@takes_handle
def knn_graph(X: torch.Tensor, k: int, metric: DistanceType = D.L2SqrtExpanded) -> COO:
    """Symmetrised kNN graph of the dense rows X (m, d): a COO (m, m)
    (reference sparse/selection/knn_graph.hpp:46).  The kNN (the port's
    ``spatial.knn.brute_force_knn``: K1 for the L2 family with k <= 128)
    counts each row as its own neighbour, a zero-weight loop edge; the
    graph keeps the larger weight of the two directions."""
    dists, inds = dense_knn([X], X, k=k, metric=metric, device=X.device)
    return symmetrize_knn(inds, dists, X.shape[0], device=X.device)
