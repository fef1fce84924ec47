"""Port parity of the MST, the components fix-up and single linkage
(raft_tpu_torch.sparse.{mst, linkage, hierarchy}) against the JAX
package and scipy, on the CPU.

Each graph is built once, in the JAX package, and carried into the port
by ``convert.from_reference``, so both MSTs solve the identical graph:
the (weight, edge id) key makes the tree unique, and the edge lists and
colours are compared exactly.  The MST weight is held to scipy's
``minimum_spanning_tree`` at rtol 1e-5 (a float32 sum).  Distances of
the fix-up scan agree with JAX within 1e-5 (float32 products in another
order); ``single_linkage`` gives the same partition as JAX and scipy,
and its merge heights agree with scipy's at rtol 1e-3, atol 1e-4 (the
JAX test's tolerance: float32 device distances against float64).
Every port call passes ``device="cpu"``.
"""

import numpy as np
import pytest
import scipy.cluster.hierarchy as sch
import scipy.sparse as sp
import scipy.sparse.csgraph as csg
import torch

from raft_tpu.sparse import convert as jconvert
from raft_tpu.sparse.formats import CSR as JCSR
from raft_tpu.sparse.hierarchy import extract_flattened_clusters as jax_extract
from raft_tpu.sparse.hierarchy import single_linkage as jax_single_linkage
from raft_tpu.sparse.linkage import connect_components as jax_connect
from raft_tpu.sparse.linkage import cross_color_nn as jax_cross_color_nn
from raft_tpu.sparse.mst import mst as jax_mst
from raft_tpu.sparse.selection import knn_graph as jax_knn_graph
from raft_tpu_torch import convert as pconvert
from raft_tpu_torch.core import native
from raft_tpu_torch.sparse import hierarchy, linkage
from raft_tpu_torch.sparse.mst import GraphCOO, mst, mst_weight

CPU = dict(device="cpu")


def random_sym_graph(rng, n, density=0.3):
    d = rng.random((n, n)) * (rng.random((n, n)) < density)
    d = np.triu(d, 1)
    return (d + d.T).astype(np.float32)


def assert_same_mst(got, ref):
    """The port's (GraphCOO, colours) equal the JAX ones entry by entry."""
    g, colors = got
    jg, jcolors = ref
    assert isinstance(g, GraphCOO) and g.src.dtype == torch.int32
    assert int(g.n_edges) == int(jg.n_edges)
    np.testing.assert_array_equal(g.src.numpy(), np.asarray(jg.src))
    np.testing.assert_array_equal(g.dst.numpy(), np.asarray(jg.dst))
    np.testing.assert_array_equal(g.weights.numpy(), np.asarray(jg.weights))
    np.testing.assert_array_equal(colors.numpy(), np.asarray(jcolors))
    assert colors.dtype == torch.int32


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("n", [10, 40])
def test_mst_equals_jax_and_weighs_as_scipy(seed, n):
    adj = random_sym_graph(np.random.default_rng(seed), n, density=0.5)
    j = JCSR.from_dense(adj)
    got = mst(pconvert.from_reference(j, **CPU), **CPU)
    assert_same_mst(got, jax_mst(j))
    ncomp, _ = csg.connected_components(sp.csr_matrix(adj), directed=False)
    assert int(got[0].n_edges) == n - ncomp
    ref_weight = csg.minimum_spanning_tree(sp.csr_matrix(adj)).sum()
    np.testing.assert_allclose(float(mst_weight(got[0])), float(ref_weight), rtol=1e-5)


def test_mst_of_a_jax_knn_graph_and_its_carried_edge_list():
    # a kNN graph with ties in weight (duplicated rows) and duplicate
    # undirected entries: the JAX graph, carried, solved by both
    X = np.random.default_rng(4).random((60, 3)).astype(np.float32)
    X[30:40] = X[:10]
    j = jconvert.coo_to_csr(jax_knn_graph(X, k=6))
    ref = jax_mst(j)
    assert_same_mst(mst(pconvert.from_reference(j, **CPU), **CPU), ref)
    # the JAX edge list carries across as the port's GraphCOO
    carried = pconvert.from_reference(ref[0], **CPU)
    assert isinstance(carried, GraphCOO) and carried.src.dtype == torch.int32
    np.testing.assert_array_equal(carried.src.numpy(), np.asarray(ref[0].src))
    assert int(carried.n_edges) == int(ref[0].n_edges)
    back = pconvert.to_numpy(carried)
    assert isinstance(back, GraphCOO) and isinstance(back.weights, np.ndarray)


def test_mst_restart_with_colors():
    adj = np.zeros((4, 4), np.float32)
    adj[0, 1] = adj[1, 0] = 1.0
    adj[2, 3] = adj[3, 2] = 1.0
    j = JCSR.from_dense(adj)
    g, colors = mst(pconvert.from_reference(j, **CPU), **CPU)
    jg, jcolors = jax_mst(j)
    assert_same_mst((g, colors), (jg, jcolors))
    assert int(g.n_edges) == 2 and len(np.unique(colors.numpy())) == 2
    bridge = np.zeros((4, 4), np.float32)
    bridge[1, 2] = bridge[2, 1] = 5.0
    jb = JCSR.from_dense(bridge)
    got = mst(pconvert.from_reference(jb, **CPU), colors=colors, **CPU)
    assert_same_mst(got, jax_mst(jb, colors=jcolors))
    assert int(got[0].n_edges) == 1 and len(np.unique(got[1].numpy())) == 1


def test_mst_round_cap_stops_early():
    # a path whose edges alternate light and heavy: one round joins the
    # pairs only, and a forest of n / 2 trees comes back
    n = 16
    adj = np.zeros((n, n), np.float32)
    for i in range(n - 1):
        adj[i, i + 1] = adj[i + 1, i] = 1.0 + 2.0 * (i % 2)
    j = JCSR.from_dense(adj)
    got = mst(pconvert.from_reference(j, **CPU), max_iterations=1, **CPU)
    assert_same_mst(got, jax_mst(j, max_iterations=1))
    assert len(np.unique(got[1].numpy())) == n // 2


@pytest.mark.parametrize("budget_rows", [None, 3])
def test_cross_color_nn_and_connect_components_match_jax(budget_rows, monkeypatch):
    X = np.concatenate([np.random.default_rng(3).random((10, 2)),
                        np.random.default_rng(4).random((10, 2)) + 5,
                        np.random.default_rng(5).random((7, 2)) - 4]).astype(np.float32)
    colors = np.array([0] * 10 + [10] * 10 + [20] * 7, np.int32)
    if budget_rows:
        # 3 rows a chunk of 8-column tiles: ten chunks
        monkeypatch.setattr(linkage, "ROW_BUDGET_BYTES", 4 * 8 * budget_rows)
    d, j = linkage.cross_color_nn(X, colors, tile_n=8, **CPU)
    jd, jj = jax_cross_color_nn(X, colors, tile_n=8)
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(j.numpy(), np.asarray(jj))
    fix = pconvert.to_numpy(linkage.connect_components(X, colors, **CPU))
    ref = jax_connect(X, colors)
    assert fix.nnz == int(ref.nnz) == 6 and fix.shape == (27, 27)
    np.testing.assert_array_equal(fix.rows, np.asarray(ref.rows))
    np.testing.assert_array_equal(fix.cols, np.asarray(ref.cols))
    np.testing.assert_allclose(fix.vals, np.asarray(ref.vals), rtol=1e-5, atol=1e-5)


def test_cross_color_nn_known_answer():
    X = np.array([[0.0, 0], [1, 0], [10, 0], [11, 0]], np.float32)
    d, j = linkage.cross_color_nn(X, np.array([0, 0, 1, 1], np.int32), **CPU)
    np.testing.assert_allclose(d.numpy(), [10, 9, 9, 10], rtol=1e-5)
    np.testing.assert_array_equal(j.numpy(), [2, 2, 1, 1])


@pytest.mark.parametrize("linkage_kind", ["knn", "pairwise"])
def test_single_linkage_matches_jax_and_scipy(linkage_kind):
    rng = np.random.default_rng(11)
    X = np.concatenate([rng.normal(0, 0.3, (20, 3)), rng.normal(4, 0.3, (25, 3)),
                        rng.normal((8, 0, 0), 0.3, (15, 3))]).astype(np.float32)
    res = hierarchy.single_linkage(X, n_clusters=3, linkage=linkage_kind, **CPU)
    ref = jax_single_linkage(X, n_clusters=3, linkage=linkage_kind)
    Z = sch.linkage(X, method="single")
    scipy_labels = sch.fcluster(Z, t=3, criterion="maxclust")
    assert isinstance(res.labels, np.ndarray) and len(np.unique(res.labels)) == 3
    np.testing.assert_array_equal(res.labels, np.asarray(ref.labels))
    for lab in np.unique(res.labels):
        members = scipy_labels[res.labels == lab]
        assert (members == members[0]).all()
    np.testing.assert_array_equal(res.children, np.asarray(ref.children))
    np.testing.assert_array_equal(res.sizes, np.asarray(ref.sizes))
    np.testing.assert_allclose(res.deltas, Z[:, 2], rtol=1e-3, atol=1e-4)
    assert (res.n_clusters, res.n_leaves) == (3, 60)


def test_single_linkage_stitches_a_disconnected_knn_graph():
    # three blobs 6 apart and c = 1 (k = 6): the kNN graph is a forest,
    # and the fix-up joins it; the stage record counts the solves and the
    # fix-ups
    rng = np.random.default_rng(2)
    X = np.concatenate([rng.normal(c, 0.3, (s, 2)) for c, s in ((-6, 15), (0, 12), (6, 9))]
                       ).astype(np.float32)
    stages = {}
    res = hierarchy.single_linkage(X, 3, c=1, stages=stages, **CPU)
    ref = jax_single_linkage(X, 3, c=1)
    np.testing.assert_array_equal(res.labels, np.asarray(ref.labels))
    Z = sch.linkage(X, method="single")
    np.testing.assert_allclose(res.deltas, Z[:, 2], rtol=1e-3, atol=1e-4)
    assert stages["connect_components"][0] > 1
    assert len(stages["boruvka_rounds"]) == len(stages["connect_components"]) + 1
    for key in ("knn_graph_ms", "symmetrize_csr_ms", "mst_ms", "connect_ms",
                "dendrogram_ms", "cut_ms"):
        assert stages[key] >= 0.0


def test_single_linkage_n_clusters_one():
    X = np.random.default_rng(5).random((12, 2)).astype(np.float32)
    res = hierarchy.single_linkage(X, n_clusters=1, **CPU)
    assert (res.labels == 0).all()


def test_single_linkage_children_and_sizes_shapes():
    X = np.random.default_rng(6).random((16, 2)).astype(np.float32)
    res = hierarchy.single_linkage(X, n_clusters=2, **CPU)
    assert res.children.shape == (15, 2) and res.deltas.shape == (15,)
    assert res.sizes[-1] == 16
    assert len(np.unique(res.labels)) == 2


def test_numpy_dendrogram_and_cut_equal_the_native_ones():
    # the numpy dendrogram (the route without g++) against the host
    # runtime's; the port's cut (pointer jumping) against the host
    # runtime's and the JAX package's
    if not native.native_available():
        pytest.skip("no g++: the host runtime is not built")
    rng = np.random.default_rng(8)
    X = rng.random((50, 3)).astype(np.float32)
    src, dst, w = hierarchy.build_sorted_mst(X, hierarchy.get_distance_graph(
        X, 15, hierarchy.D.L2SqrtExpanded, **CPU), **CPU)
    nat = native.build_dendrogram(src, dst, w, 50)
    num = hierarchy.build_dendrogram_numpy(src, dst, w, 50, assume_sorted=True)
    for a, b in zip(nat, num):
        np.testing.assert_array_equal(a, b)
    for n_clusters in (1, 2, 5, 49, 50):
        got = hierarchy.extract_flattened_clusters(nat[0], n_clusters, 50)
        assert got.dtype == np.int64
        np.testing.assert_array_equal(got, jax_extract(nat[0], n_clusters, 50))
        if n_clusters > 1:
            np.testing.assert_array_equal(got, native.extract_clusters(nat[0], n_clusters, 50))


def test_cut_of_a_chained_tree():
    # a chain (each merge adds one leaf to one cluster), the shape that
    # makes the leaf-by-leaf walk quadratic: the cut is the JAX one
    m = 3000
    children = np.stack([np.r_[0, m + np.arange(m - 2)], np.arange(1, m)], axis=1)
    for n_clusters in (2, 3, 100):
        np.testing.assert_array_equal(
            hierarchy.extract_flattened_clusters(children, n_clusters, m),
            jax_extract(children, n_clusters, m))
