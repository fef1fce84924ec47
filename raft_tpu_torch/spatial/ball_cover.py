"""Random ball cover: exact kNN for low-dimensional data by landmark pruning.

Port of ``raft_tpu/spatial/ball_cover.py`` (reference
spatial/knn/ball_cover.hpp:32,77,142, ``rbc_build_index``,
``rbc_all_knn_query``, ``rbc_knn_query``, and detail/ball_cover.cuh).

**Build.** ``n_landmarks`` rows (default sqrt(m)) drawn by
``numpy.random.default_rng(seed).choice(m, L, replace=False)``, the rows
the JAX package draws; every point is 1-NN assigned to a landmark in the
metric's root form (Haversine, or the square root of the expanded L2),
in row chunks under :data:`BUDGET_BYTES`; the groups are packed on the
host by the native runtime (``rt_pack_groups`` through
:mod:`raft_tpu_torch.core.native`: members by descending owner distance,
-1 padded, and each group's radius); the numpy route runs only on a
machine without ``g++``.

**Query.** Each query orders the landmarks by distance once (a full
``select_k`` over L, a stable sort past 128).  The reverse suffix minimum
of ``d(q, landmark) - radius`` over that order (a flip, ``torch.cummin``,
a flip) bounds what any later group can offer.  A loop then scans one
ranked group per step for every query of the batch: the group's members
gathered, their distances, ``select_k`` of the step (K2 on the card) and
``knn_merge_parts`` with the running top-k (K2 again).  It stops when no
query's k-th distance exceeds the suffix bound at the next rank, as the
JAX ``while_loop`` condition does, which costs one host read a step.

**Chunks.** Unlike the JAX function, the queries go through in chunks
whose transient bytes (the ordering, the gathered groups) stay under
:data:`BUDGET_BYTES`; the build's assignment is chunked by the same
budget.  A query's k nearest are exact whatever its chunk; only ties may
resolve otherwise, as a chunk may run more steps than the query needs.
``stats={}`` fills a dict with the chunk size, the chunk count and each
chunk's loop steps.

Metrics: the L2 family and Haversine (2-D radian lat/lon), as the
reference.  L2Expanded and L2Unexpanded report squared distances.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from raft_tpu_torch.core import native, precision
from raft_tpu_torch.core.device import as_tensor, resolve_device
from raft_tpu_torch.core.error import expects
from raft_tpu_torch.distance.distance_type import DistanceType
from raft_tpu_torch.distance.pairwise import expanded_sq_dists
from raft_tpu_torch.spatial.haversine import haversine_distances
from raft_tpu_torch.spatial.knn import knn_merge_parts
from raft_tpu_torch.spatial.select_k import select_k

D = DistanceType
_SUPPORTED = (D.L2Expanded, D.L2SqrtExpanded, D.L2Unexpanded, D.L2SqrtUnexpanded, D.Haversine)

# transient bytes of one query chunk (and of one row chunk of the build's
# assignment); tests set it small to cut the queries into chunks
BUDGET_BYTES = 1 << 30


class BallCoverIndex(NamedTuple):
    """(reference BallCoverIndex, ball_cover_common.h:38)"""

    X: torch.Tensor          # (m, d) the data
    landmarks: torch.Tensor  # (L, d) the sampled landmark rows
    groups: torch.Tensor     # (L, gmax) int32 member row ids, -1 padded
    radius: torch.Tensor     # (L,) float32 largest member distance a landmark
    metric: DistanceType


def _dists(x: torch.Tensor, y: torch.Tensor, metric) -> torch.Tensor:
    """(m, n) distances in the root form, where the triangle inequality
    holds."""
    if metric == D.Haversine:
        return haversine_distances(x, y)
    return torch.sqrt(expanded_sq_dists(x, y))


def _rows_per_chunk(bytes_per_row: int) -> int:
    return max(1, BUDGET_BYTES // max(bytes_per_row, 1))


def query_bytes(gmax: int, dim: int, L: int) -> int:
    """A query's transient bytes in :func:`rbc_knn_query`: per member of
    the gathered group its int64 row, vector, norm, group id and about
    eight float32 elementwise temporaries of the distance; per landmark
    the ordering (distance, int64 id, slack, bound)."""
    return gmax * (8 + 4 * (dim + 10)) + 24 * L


def _pack_groups_numpy(owner: np.ndarray, dist: np.ndarray, L: int, gmax: int):
    """The numpy route of ``native.pack_groups``."""
    groups = np.full((L, gmax), -1, np.int32)
    fill = np.zeros(L, np.int64)
    for i in np.argsort(dist)[::-1]:       # members by descending distance
        groups[owner[i], fill[owner[i]]] = i
        fill[owner[i]] += 1
    radius = np.zeros(L, np.float32)
    np.maximum.at(radius, owner, dist)
    return groups, radius


def rbc_build_index(X, metric: DistanceType = D.L2SqrtExpanded, n_landmarks: Optional[int] = None,
                    seed: int = 0, device="cuda") -> BallCoverIndex:
    """Build the ball cover (reference rbc_build_index, ball_cover.hpp:32;
    ``n_landmarks`` defaults to sqrt(m), ball_cover_common.h:55).  ``X`` (a
    numpy array or tensor) is moved to ``device``."""
    dev = resolve_device(device)
    X = as_tensor(X, dev)
    expects(X.ndim == 2, "rbc_build_index: 2-D data required")
    m, dim = X.shape
    expects(metric in _SUPPORTED, "rbc_build_index: unsupported metric %d", int(metric))
    if metric == D.Haversine:
        expects(dim == 2, "haversine ball cover requires 2-d lat/lon")
    L = n_landmarks or max(int(np.sqrt(m)), 1)
    expects(1 <= L <= m, "rbc_build_index: n_landmarks=%d out of range for %d rows", L, m)
    lm_ids = np.random.default_rng(seed).choice(m, size=L, replace=False)
    landmarks = X[torch.from_numpy(lm_ids).to(dev)]

    owner, dist_own = [], []
    # the distances and about eight elementwise temporaries a landmark
    chunk = _rows_per_chunk(40 * L)
    for s in range(0, m, chunk):
        d, o = torch.min(_dists(X[s:s + chunk], landmarks, metric), dim=1)
        dist_own.append(d)
        owner.append(o)
    owner = torch.cat(owner).cpu().numpy()
    dist_own = torch.cat(dist_own).cpu().numpy()
    gmax = max(int(np.bincount(owner, minlength=L).max()), 1)
    nat = native.pack_groups(owner, dist_own, L, gmax)
    if nat is not None:
        groups, radius = nat[0].astype(np.int32), nat[1].astype(np.float32)
    else:
        groups, radius = _pack_groups_numpy(owner, dist_own, L, gmax)
    return BallCoverIndex(X, landmarks, torch.from_numpy(groups).to(dev),
                          torch.from_numpy(radius).to(dev), metric)


def _group_dists(q, qn, vecs, vn, metric):
    """(nq, gmax) root-form distances of each query to its gathered group
    ``vecs`` (nq, gmax, d), ``vn`` their squared norms."""
    if metric == D.Haversine:
        sin_lat = torch.sin(0.5 * (q[:, None, 0] - vecs[..., 0]))
        sin_lon = torch.sin(0.5 * (q[:, None, 1] - vecs[..., 1]))
        rdist = sin_lat ** 2 + torch.cos(q[:, None, 0]) * torch.cos(vecs[..., 0]) * sin_lon ** 2
        return 2.0 * torch.arcsin(torch.sqrt(torch.clamp(rdist, 0.0, 1.0)))
    dot = precision.bmm(vecs, q[:, :, None])[:, :, 0]
    return torch.sqrt(torch.clamp(qn[:, None] + vn - 2.0 * dot, min=0.0))


def _query_chunk(X, xn, landmarks, groups, radius, q, k, metric):
    """Exact kNN of one chunk of queries (module doc): (distances in the
    root form, int32 ids, loop steps)."""
    nq, dev = q.shape[0], q.device
    L, gmax = groups.shape
    rank_d, rank_l = select_k(_dists(q, landmarks, metric), L, select_min=True, device=dev)
    rank_l = rank_l.long()
    # the reverse suffix minimum over the ranked landmarks of d - radius:
    # past rank r no group can hold a point closer than suffix_min[:, r]
    slack = torch.flip(rank_d - radius[rank_l], dims=[1])
    suffix_min = torch.flip(torch.cummin(slack, dim=1).values, dims=[1])
    qn = (q * q).sum(dim=1)
    best_d = torch.full((nq, k), float("inf"), dtype=torch.float32, device=dev)
    best_i = torch.full((nq, k), -1, dtype=torch.int32, device=dev)
    kk = min(k, gmax)
    steps = 0
    while steps < L and bool((suffix_min[:, steps] <= best_d[:, -1]).any()):
        gids = groups[rank_l[:, steps]]                      # (nq, gmax)
        rows = torch.clamp(gids, min=0).long()
        dd = torch.where(gids >= 0, _group_dists(q, qn, X[rows], xn[rows], metric),
                         float("inf"))
        bd, bi = select_k(dd, kk, select_min=True, values=gids, device=dev)
        if kk < k:
            bd = torch.nn.functional.pad(bd, (0, k - kk), value=float("inf"))
            bi = torch.nn.functional.pad(bi, (0, k - kk), value=-1)
        best_d, best_i = knn_merge_parts(torch.stack([best_d, bd]), torch.stack([best_i, bi]), k,
                                         device=dev)
        steps += 1
    return best_d, best_i, steps


def rbc_knn_query(index: BallCoverIndex, k: int, queries, *, device="cuda",
                  stats: Optional[dict] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact kNN of ``queries`` against the indexed set (reference
    rbc_knn_query, ball_cover.hpp:142): (nq, k) distances and int32 ids,
    best-first.  ``stats`` (a dict) receives ``chunk_rows``, ``chunks``
    and ``steps`` (each chunk's loop steps)."""
    dev = resolve_device(device)
    metric = DistanceType(int(index.metric))
    X = as_tensor(index.X, dev)
    landmarks = as_tensor(index.landmarks, dev)
    groups = as_tensor(index.groups, dev)
    radius = as_tensor(index.radius, dev)
    q = as_tensor(queries, dev).to(X.dtype)
    expects(q.ndim == 2 and q.shape[1] == X.shape[1],
            "rbc_knn_query: expected (n_queries, %d) queries, got %r", X.shape[1],
            tuple(q.shape))
    expects(1 <= k <= X.shape[0], "rbc_knn_query: k=%d out of range for %d rows", k,
            X.shape[0])
    L, gmax = groups.shape
    xn = (X * X).sum(dim=1)
    chunk = _rows_per_chunk(query_bytes(gmax, X.shape[1], L))
    out_d, out_i, steps = [], [], []
    for s in range(0, q.shape[0], chunk):
        d, i, n = _query_chunk(X, xn, landmarks, groups, radius, q[s:s + chunk], k, metric)
        out_d.append(d)
        out_i.append(i)
        steps.append(n)
    if stats is not None:
        stats.update(chunk_rows=chunk, chunks=len(steps), steps=steps)
    dist = torch.cat(out_d) if out_d else torch.empty((0, k), dtype=torch.float32, device=dev)
    ids = torch.cat(out_i) if out_i else torch.empty((0, k), dtype=torch.int32, device=dev)
    if metric in (D.L2Expanded, D.L2Unexpanded):
        dist = dist * dist
    return dist, ids


def rbc_all_knn_query(index: BallCoverIndex, k: int, *, device="cuda",
                      stats: Optional[dict] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """All-points kNN, each point's self included (reference
    rbc_all_knn_query, ball_cover.hpp:77)."""
    return rbc_knn_query(index, k, index.X, device=device, stats=stats)
