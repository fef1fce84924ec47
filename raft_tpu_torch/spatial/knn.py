"""Brute-force k-nearest-neighbours over partitioned inputs.

Port of ``raft_tpu/spatial/knn.py`` (reference ``brute_force_knn``,
knn.hpp:127 and detail/knn_brute_force_faiss.cuh:220): search each index
partition, merge the partitions' results (``knn_merge_parts``), then
apply the sqrt fix-up for the L2Sqrt metrics.  Per partition:

- the L2 family runs ``fused_l2_knn`` (K1 on the card), or with
  ``rerank_ratio > 1`` a bfloat16 tile scan for ``k * rerank_ratio``
  candidates followed by an exact float32 re-rank;
- haversine runs its tile scan;
- cosine and correlation pre-process the rows, take inner products and
  select the smallest ``1 - sim``;
- inner product selects the largest;
- every other metric runs ``pairwise_distance`` (K5 for the unexpanded
  ones) and ``select_k`` (K2).

Ids are int32.  Partitions are searched one after another on the current
stream; the JAX ``handle=``, ``donate_queries=`` and ``@profiled`` wait
for the serving slice.
"""

from __future__ import annotations

import numbers
from typing import List, Optional, Sequence, Tuple, Union

import torch

from raft_tpu_torch.core.device import as_tensor, resolve_device
from raft_tpu_torch.core.error import expects
from raft_tpu_torch.distance.distance_type import DistanceType
from raft_tpu_torch.distance.pairwise import matmul, pairwise_distance
from raft_tpu_torch.spatial.fused_l2_knn import fused_l2_knn
from raft_tpu_torch.spatial.haversine import haversine_knn
from raft_tpu_torch.spatial.processing import create_processor
from raft_tpu_torch.spatial.select_k import select_k

D = DistanceType

_L2_FAMILY = (D.L2Expanded, D.L2SqrtExpanded, D.L2Unexpanded, D.L2SqrtUnexpanded)
_IP_FAMILY = (D.InnerProduct,)
_SIM_FAMILY = (D.CosineExpanded, D.CorrelationExpanded)


def knn_merge_parts(
    part_distances,
    part_indices,
    k: int,
    translations: Optional[Sequence[int]] = None,
    select_min: bool = True,
    device="cuda",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Merge per-partition kNN results into a global top-k.

    ``part_distances`` and ``part_indices`` are (n_parts, n_queries, k);
    ``translations`` are per-partition id offsets added to the ids.
    Returns (n_queries, k) distances and ids, best-first.
    """
    dev = resolve_device(device)
    part_distances = as_tensor(part_distances, dev)
    part_indices = as_tensor(part_indices, dev)
    expects(part_distances.ndim == 3 and part_indices.shape == part_distances.shape,
            "knn_merge_parts: (n_parts, n_queries, k) inputs required")
    n_parts, nq, kk = part_distances.shape
    expects(k <= n_parts * kk, "knn_merge_parts: k=%d > total candidates", k)
    idx = part_indices
    if translations is not None:
        expects(len(translations) == n_parts,
                "knn_merge_parts: %d translations for %d partitions",
                len(translations), n_parts)
        if isinstance(translations, torch.Tensor) and translations.device == dev:
            idx = idx + translations.to(idx.dtype)[:, None, None]
        else:
            # host offsets: one scalar add a partition, since copying them to
            # the card would make the host wait for every kernel queued before
            idx = torch.stack([part + int(t) for part, t in zip(idx.unbind(0), translations)])
    cand_d = part_distances.permute(1, 0, 2).reshape(nq, n_parts * kk)
    cand_i = idx.permute(1, 0, 2).reshape(nq, n_parts * kk)
    return select_k(cand_d, k, select_min=select_min, values=cand_i, device=dev)


def _exact_rerank_l2(part, queries, cand_ids, k):
    """Exact float32 re-rank of first-stage candidates (squared L2)."""
    vecs = part[torch.clamp(cand_ids, 0, part.shape[0] - 1).long()]   # (nq, k2, d)
    diff = vecs.to(torch.float32) - queries.to(torch.float32)[:, None]
    dist = (diff * diff).sum(dim=-1)
    return select_k(dist, k, select_min=True, values=cand_ids, device=queries.device)


def _search_one_partition(part, queries, k, metric, metric_arg, tile_n,
                          precision, rerank_ratio):
    """One partition's (distances, int32 ids): squared for the L2 family,
    final form for every other metric."""
    dev = queries.device
    if metric in _L2_FAMILY:
        if rerank_ratio > 1:
            k2 = min(k * rerank_ratio, part.shape[0])
            _, i1 = fused_l2_knn(part, queries, k2, tile_n=tile_n,
                                 precision="default", impl="scan", device=dev)
            return _exact_rerank_l2(part, queries, i1, k)
        return fused_l2_knn(part, queries, k, tile_n=tile_n, precision=precision,
                            device=dev)
    if metric == D.Haversine:
        expects(queries.shape[1] == 2,
                "Haversine distance requires 2 dimensions (latitude / longitude).")
        return haversine_knn(part, queries, k, tile_n=tile_n, device=dev)
    if metric in _SIM_FAMILY:
        proc = create_processor(metric)
        sim = matmul(proc.preprocess(queries), proc.preprocess(part).T, precision)
        return select_k(proc.postprocess(sim), k, select_min=True, device=dev)
    if metric in _IP_FAMILY:
        return select_k(matmul(queries, part.T, precision), k, select_min=False,
                        device=dev)
    dist = pairwise_distance(queries, part, metric, metric_arg=metric_arg,
                             precision=precision, device=dev)
    return select_k(dist, k, select_min=True, device=dev)


def brute_force_knn(
    inputs: Union[object, List[object]],
    queries,
    k: int,
    metric: DistanceType = D.L2Expanded,
    metric_arg: float = 2.0,
    translations: Optional[Sequence[int]] = None,
    tile_n: int = 8192,
    precision: str = "highest",
    rerank_ratio: int = 1,
    device="cuda",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact kNN of ``queries`` against one or more index partitions.

    Parameters
    ----------
    inputs:
        One (n, d) index or a list of (n_i, d) partitions (numpy arrays
        or tensors), moved to ``device``.
    queries:
        (n_queries, d) rows.
    k:
        Neighbours per query.
    metric, metric_arg:
        Distance metric (``metric_arg`` is the Minkowski p).
    translations:
        Per-partition global id offsets; default: cumulative partition
        starts.
    tile_n:
        Index rows per step of the tile scans.
    precision:
        ``"highest"`` (float32 products) or ``"default"`` (bfloat16
        operands, float32 sums: K1's bfloat16 instance for the L2
        family on the card) for the matmul-backed metrics.
    rerank_ratio:
        L2 family only.  Above 1, a bfloat16 tile scan keeps
        ``k * rerank_ratio`` candidates per partition and an exact
        float32 re-rank reduces them to k (whatever ``precision`` says).

    Returns
    -------
    (distances, indices): (n_queries, k); global int32 ids; distances in
    final form (square-rooted for the L2Sqrt metrics).
    """
    dev = resolve_device(device)
    parts = [inputs] if not isinstance(inputs, (list, tuple)) else list(inputs)
    expects(len(parts) > 0, "brute_force_knn: no input partitions")
    queries = as_tensor(queries, dev)
    parts = [as_tensor(p, dev) for p in parts]
    for p in parts:
        expects(p.ndim == 2 and p.shape[1] == queries.shape[1],
                "brute_force_knn: partition/query dimensionality mismatch")
    if translations is None:
        translations = []
        total = 0
        for p in parts:
            translations.append(total)
            total += p.shape[0]
    expects(isinstance(rerank_ratio, numbers.Integral)
            and not isinstance(rerank_ratio, bool) and rerank_ratio >= 1,
            "brute_force_knn: rerank_ratio must be an integer >= 1, got %r",
            rerank_ratio)
    rerank_ratio = int(rerank_ratio)
    expects(rerank_ratio == 1 or metric in _L2_FAMILY,
            "brute_force_knn: rerank_ratio applies to the L2 family only")
    results = [_search_one_partition(p, queries, k, metric, metric_arg, tile_n,
                                     precision, rerank_ratio) for p in parts]
    if len(parts) == 1:
        dist, idx = results[0]
        if int(translations[0]) != 0:
            idx = idx + int(translations[0])
    else:
        dist, idx = knn_merge_parts(torch.stack([d for d, _ in results]),
                                    torch.stack([i for _, i in results]), k,
                                    translations, select_min=metric not in _IP_FAMILY,
                                    device=dev)
    # sqrt after the merge; the map is monotone, so the order holds
    if metric in (D.L2SqrtExpanded, D.L2SqrtUnexpanded):
        dist = torch.sqrt(torch.clamp(dist, min=0.0))
    return dist, idx
