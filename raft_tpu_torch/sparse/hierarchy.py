"""Single-linkage hierarchical agglomerative clustering.

Port of ``raft_tpu/sparse/hierarchy.py`` (reference ``single_linkage``,
sparse/hierarchy/single_linkage.hpp:48, pipeline
hierarchy/detail/single_linkage.hpp:64-120):

1. :func:`get_distance_graph`: the kNN graph (k = log2(m) + c; K1 and
   the symmetrisation on the card) or the full pairwise graph;
2. :func:`build_sorted_mst`: Borůvka (:mod:`~raft_tpu_torch.sparse.mst`),
   then, while the graph is a forest, :func:`~raft_tpu_torch.sparse.linkage.connect_components`
   and Borůvka again from the colours;
3. :func:`build_dendrogram_host`: union-find over the weight-sorted edges
   on the host (scipy's convention: merge i makes cluster m + i,
   children[i] = (find(src), find(dst)));
4. :func:`extract_flattened_clusters`: the cut into n_clusters labels.

Stage 3 runs the host runtime (``core/native.py``, built with g++), with
the JAX package's numpy loop where there is no g++; stage 4 is a
vectorised numpy cut (:func:`extract_flattened_clusters` says why).  As in the JAX
package the host reads each MST's colours (``np.unique``) to count the
components.  :func:`single_linkage` takes ``handle=`` or ``device=``
(:func:`raft_tpu_torch.core.handle.takes_handle`, default ``"cuda"``) and
returns numpy arrays, as the JAX function does.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from raft_tpu_torch.core import native
from raft_tpu_torch.core.error import expects
from raft_tpu_torch.core.handle import takes_handle
from raft_tpu_torch.core.utils import StageTimer
from raft_tpu_torch.distance.distance_type import DistanceType
from raft_tpu_torch.distance.pairwise import pairwise_distance
from raft_tpu_torch.sparse.convert import coo_to_csr
from raft_tpu_torch.sparse.formats import CSR
from raft_tpu_torch.sparse.linalg import symmetrize_knn
from raft_tpu_torch.sparse.linkage import connect_components
from raft_tpu_torch.sparse.mst import round_cap, solve
from raft_tpu_torch.spatial.knn import brute_force_knn as dense_knn

D = DistanceType

_SQRT_L2 = (D.L2SqrtExpanded, D.L2SqrtUnexpanded)
_SQUARED_L2 = (D.L2Expanded, D.L2Unexpanded)


class LinkageResult(NamedTuple):
    """Reference ``linkage_output`` (hierarchy/common.h:22-36)."""

    labels: np.ndarray        # (m,) flattened cluster assignments
    children: np.ndarray      # (m-1, 2) scipy-convention merge tree
    deltas: np.ndarray        # (m-1,) merge distances
    sizes: np.ndarray         # (m-1,) merged cluster sizes
    n_clusters: int
    n_leaves: int


class _UnionFind:
    """Host union-find with scipy-style next-id assignment (reference
    UnionFind, detail/agglomerative.cuh:38-80)."""

    def __init__(self, n: int):
        self.parent = np.full(2 * n - 1, -1, dtype=np.int64)
        self.size = np.ones(2 * n - 1, dtype=np.int64)
        self.size[n:] = 0
        self.next_id = n

    def find(self, x: int) -> int:
        root = x
        while self.parent[root] != -1:
            root = self.parent[root]
        while self.parent[x] != -1:  # path compression
            self.parent[x], x = root, self.parent[x]
        return root

    def union(self, a: int, b: int) -> None:
        nid = self.next_id
        self.parent[a] = nid
        self.parent[b] = nid
        self.size[nid] = self.size[a] + self.size[b]
        self.next_id += 1


def build_dendrogram_numpy(src, dst, weights, m: int, assume_sorted: bool = False
                           ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The numpy route of :func:`build_dendrogram_host` (the JAX
    package's loop)."""
    src, dst, weights = (np.asarray(a)[: m - 1] for a in (src, dst, weights))
    if not assume_sorted:
        order = np.argsort(weights, kind="stable")
        src, dst, weights = src[order], dst[order], weights[order]
    children = np.zeros((m - 1, 2), dtype=np.int64)
    sizes = np.zeros(m - 1, dtype=np.int64)
    uf = _UnionFind(m)
    for i in range(m - 1):
        aa, bb = uf.find(int(src[i])), uf.find(int(dst[i]))
        children[i, 0], children[i, 1] = aa, bb
        sizes[i] = uf.size[aa] + uf.size[bb]
        uf.union(aa, bb)
    return children, weights.astype(np.float64), sizes


def build_dendrogram_host(src, dst, weights, m: int, assume_sorted: bool = False
                          ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Union-find dendrogram of m - 1 MST edges (reference
    build_dendrogram_host, detail/agglomerative.cuh:101): (children (m - 1,
    2), merge distances, merged sizes).  The host runtime's
    ``rt_build_dendrogram`` (which sorts by weight itself), or the numpy
    loop where there is no g++; ``assume_sorted`` skips the numpy route's
    sort."""
    src, dst, weights = (np.asarray(a)[: m - 1] for a in (src, dst, weights))
    nat = native.build_dendrogram(src, dst, weights, m)
    if nat is not None:
        return nat
    return build_dendrogram_numpy(src, dst, weights, m, assume_sorted)


def extract_flattened_clusters(children: np.ndarray, n_clusters: int,
                               n_leaves: int) -> np.ndarray:
    """Cut the dendrogram into n_clusters monotonic labels (reference
    extract_flattened_clusters, detail/agglomerative.cuh:237): the
    forest of the first m - n_clusters merges, each node's root by
    pointer jumping (ceil(log2 depth) vectorised passes), the leaves'
    roots relabelled in sorted order, as the host runtime's
    ``rt_extract_clusters`` and the JAX package's numpy loop label them.
    Those two walk every leaf up to its root, O(m x depth), and a
    single-linkage tree chains, so its depth grows with m: the host
    runtime's cut takes minutes at a million rows."""
    m = n_leaves
    if n_clusters == 1:
        return np.zeros(m, dtype=np.int64)
    expects(1 <= n_clusters <= m, "extract_flattened_clusters: n_clusters=%d out of [1, %d]",
            n_clusters, m)
    merged = np.asarray(children, dtype=np.int64)[: m - n_clusters]
    root = np.arange(2 * m - 1, dtype=np.int64)
    root[merged.reshape(-1)] = np.repeat(np.arange(m, 2 * m - n_clusters, dtype=np.int64), 2)
    while True:
        up = root[root]
        if np.array_equal(up, root):
            break
        root = up
    _, labels = np.unique(root[:m], return_inverse=True)
    return labels.astype(np.int64)


def _mst_host(csr: CSR, colors: torch.Tensor, stages: StageTimer):
    g, colors, rounds = solve(csr, colors.long(), round_cap(csr.n_rows))
    n_components = len(np.unique(colors.cpu().numpy()))
    stages.done("mst", boruvka_rounds=rounds)
    return g, colors, n_components


def _build_sorted_mst(X: torch.Tensor, graph: CSR, max_iter: int, metric: DistanceType,
                      stages: StageTimer) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    m = X.shape[0]
    g, colors, n_components = _mst_host(
        graph, torch.arange(m, dtype=torch.int64, device=X.device), stages)
    edges = [g]
    if n_components > 1:
        expects(metric in _SQRT_L2 or metric in _SQUARED_L2,
                "build_sorted_mst: graph is disconnected and metric %d is not in the L2 "
                "family; cannot stitch components (the reference's fusedL2NN fix-up is "
                "L2-only)", int(metric))
    iters = 1
    while n_components > 1 and iters < max_iter:
        fix = coo_to_csr(connect_components(X, colors, sqrt=metric in _SQRT_L2,
                                            device=X.device))
        stages.done("connect", connect_components=n_components)
        g, colors, n_components = _mst_host(fix, colors, stages)
        edges.append(g)
        iters += 1
    expects(n_components == 1, "MST or MSF still disconnected after %d iterations", max_iter)
    src = np.concatenate([e.src.cpu().numpy() for e in edges])
    dst = np.concatenate([e.dst.cpu().numpy() for e in edges])
    w = np.concatenate([e.weights.cpu().numpy() for e in edges])
    keep = src >= 0
    src, dst, w = src[keep], dst[keep], w[keep]
    expects(len(src) == m - 1, "MST has %d edges, expected %d", len(src), m - 1)
    order = np.argsort(w, kind="stable")
    return src[order], dst[order], w[order]


@takes_handle
def build_sorted_mst(X: torch.Tensor, graph: CSR, max_iter: int = 10,
                     metric: DistanceType = D.L2SqrtExpanded
                     ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """MST over the connectivity graph; while it is a forest, stitch the
    components with connect_components and solve again from the colours
    (reference build_sorted_mst, detail/mst.cuh:133-160).  ``metric``
    gives the units of the graph's weights, so that the stitch edges
    (Euclidean, from X) match; only the L2 family can be stitched.
    Returns host (src, dst, weights), m - 1 edges sorted by weight."""
    return _build_sorted_mst(X, graph, max_iter, metric, StageTimer(None, X.device))


def _distance_graph(X: torch.Tensor, c: int, metric: DistanceType, linkage: str,
                    stages: StageTimer) -> CSR:
    m = X.shape[0]
    if linkage == "knn":
        k = min(m, int(math.log2(max(m, 2))) + c)
        dists, inds = dense_knn([X], X, k=k, metric=metric, device=X.device)
        stages.done("knn_graph")
        graph = coo_to_csr(symmetrize_knn(inds, dists, m, device=X.device))
        stages.done("symmetrize_csr")
        return graph
    if linkage == "pairwise":
        dmat = pairwise_distance(X, X, metric, device=X.device)
        dmat.fill_diagonal_(0.0)
        graph = CSR.from_dense(dmat, device=X.device)
        stages.done("pairwise_graph")
        return graph
    raise ValueError(f"unknown linkage '{linkage}'")


@takes_handle
def get_distance_graph(X: torch.Tensor, c: int, metric: DistanceType,
                       linkage: str = "knn") -> CSR:
    """The connectivity graph: the symmetrised kNN graph (k = log2(m) + c,
    reference detail/connectivities.cuh; :func:`~raft_tpu_torch.sparse.selection.knn_graph`)
    or the full pairwise one, as a CSR."""
    return _distance_graph(X, c, metric, linkage, StageTimer(None, X.device))


@takes_handle
def single_linkage(X: torch.Tensor, n_clusters: int, metric: DistanceType = D.L2SqrtExpanded,
                   linkage: str = "knn", c: int = 15,
                   stages: Optional[dict] = None) -> LinkageResult:
    """Single-linkage clustering of the dense rows X (m, d) (reference
    single_linkage, sparse/hierarchy/single_linkage.hpp:48).

    ``stages``: a dict to fill with each stage's host-clock milliseconds,
    the device synchronised at each stage's end: ``knn_graph_ms`` and
    ``symmetrize_csr_ms`` (``pairwise_graph_ms`` for
    ``linkage="pairwise"``), ``mst_ms`` with ``boruvka_rounds`` (one entry
    a solve), ``connect_ms`` with ``connect_components`` (the components
    each fix-up joined), ``dendrogram_ms`` and ``cut_ms``.  None (the
    default) times nothing and adds no synchronisation.
    """
    m = X.shape[0]
    expects(n_clusters <= m,
            "n_clusters must be less than or equal to the number of data points")
    timer = StageTimer(stages, X.device)
    graph = _distance_graph(X, c, metric, linkage, timer)
    src, dst, w = _build_sorted_mst(X, graph, 10, metric, timer)
    del graph
    children, deltas, sizes = build_dendrogram_host(src, dst, w, m, assume_sorted=True)
    timer.done("dendrogram")
    labels = extract_flattened_clusters(children, n_clusters, m)
    timer.done("cut")
    return LinkageResult(labels, children, deltas, sizes, n_clusters=n_clusters, n_leaves=m)
