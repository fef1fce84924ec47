"""Port parity of spectral partitioning on CSR (raft_tpu_torch.spectral:
the operators, the eigen and cluster solvers, partition, modularity
maximization, whitening; raft_tpu_torch.sparse.spectral.fit_embedding)
against the JAX package, on the CPU.

Graphs are built by the JAX package (``bench.two_community_graph`` at
300 vertices; the planted blocks of tests/test_spectral.py; the ring of
``bench._bench_spectral`` at 300 vertices) and carried into the port by
``convert.from_reference``.  The two packages start Lanczos and k-means
from other random draws (torch cannot reproduce Threefry), so:

- operator products agree within float32 rounding (RTOL 1e-5, ATOL 1e-5);
- eigenvalues agree with float64 ``numpy.linalg.eigh`` within the
  solver's stopping rule (``tol`` times the largest |Ritz value|, taken
  as lambda_max), and eigenvectors by subspace: the largest principal
  angle against eigh's is within the Davis-Kahan bound sqrt(k) * tol *
  lambda_max / gap;
- partitions agree by their adjusted Rand index against the planted
  communities (above 0.95 for both packages) and by quality metrics;
- ``analyze_partition`` and ``analyze_modularity`` of the same labels
  agree with the JAX package's within 1e-5 relative.

Every port call passes ``device="cpu"``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bench import two_community_graph
from helpers.torch_parity import adjusted_rand_index, max_principal_angle
from raft_tpu import spectral as jspec
from raft_tpu.sparse.formats import COO as JCOO
from raft_tpu.sparse.formats import CSR as JCSR
from raft_tpu.sparse.spectral import fit_embedding as jfit_embedding
from raft_tpu.spectral.spectral_util import construct_indicator as jconstruct_indicator
from raft_tpu.spectral.spectral_util import transform_eigen_matrix as jtransform
from raft_tpu_torch import convert
from raft_tpu_torch import spectral as pspec
from raft_tpu_torch.sparse.spectral import fit_embedding
from raft_tpu_torch.spectral.spectral_util import construct_indicator, transform_eigen_matrix

CPU = dict(device="cpu")
RTOL, ATOL = 1e-5, 1e-5
N_HALF, N_CROSS = 150, 4


@pytest.fixture(scope="module")
def communities():
    """(JAX CSR, port CSR, planted labels) of the two-community graph."""
    j = two_community_graph(N_HALF, N_CROSS, np.random.default_rng(0))
    truth = (np.arange(2 * N_HALF) >= N_HALF).astype(np.int32)
    return j, convert.from_reference(j, **CPU), truth


def _planted_blocks(n_per=15, p_in=0.7, p_out=0.05, seed=17):
    """The planted two-block graph of tests/test_spectral.py."""
    rng = np.random.default_rng(seed)
    n = 2 * n_per
    adj = np.zeros((n, n), np.float32)
    for i in range(n):
        for j in range(i + 1, n):
            if rng.random() < (p_in if (i < n_per) == (j < n_per) else p_out):
                adj[i, j] = adj[j, i] = 1.0
    return adj


def _dense(j):
    return np.asarray(j.to_dense(), np.float64)


def _solver(pkg, k, tol=1e-5, restart_iter=40):
    return pkg.LanczosSolver(pkg.EigenSolverConfig(n_eig_vecs=k, max_iter=6000,
                                                   restart_iter=restart_iter, tol=tol, seed=42))


# ---------------------------------------------------------------------- #
# operators
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("densify", [None, True])
@pytest.mark.parametrize("kind", ["SparseMatrix", "LaplacianMatrix", "ModularityMatrix"])
def test_operator_mv_matches_jax(kind, densify, communities):
    j, p, _ = communities
    x = np.random.default_rng(1).standard_normal(2 * N_HALF).astype(np.float32)
    ref = getattr(jspec, kind)(j, densify=False)
    got = getattr(pspec, kind)(p, densify=densify)
    assert (got.dense is not None) == bool(densify)
    np.testing.assert_allclose(got.mv(torch.from_numpy(x)).numpy(), np.asarray(ref.mv(x)),
                               rtol=RTOL, atol=ATOL)
    if kind != "SparseMatrix":
        np.testing.assert_allclose(got.diagonal.numpy(), np.asarray(ref.diagonal), rtol=RTOL)
    if kind == "ModularityMatrix":
        np.testing.assert_allclose(float(got.edge_sum), float(ref.edge_sum), rtol=RTOL)


def test_operator_routes_agree(communities):
    _, p, _ = communities
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(2 * N_HALF).astype(np.float32))
    seg = pspec.LaplacianMatrix(p).mv(x)
    assert torch.equal(pspec.LaplacianMatrix(p, spmv_impl="sortscan").mv(x), seg)
    torch.testing.assert_close(pspec.LaplacianMatrix(p, spmv_impl="cumsum").mv(x), seg,
                               rtol=RTOL, atol=ATOL)


# ---------------------------------------------------------------------- #
# eigen solver
# ---------------------------------------------------------------------- #
def test_laplacian_smallest_eigenpairs(communities):
    j, p, _ = communities
    tol, k = 1e-5, 2
    w, V = np.linalg.eigh(np.diag(_dense(j).sum(1)) - _dense(j))
    vals, vecs, iters = _solver(pspec, k, tol).solve_smallest_eigenvectors(
        pspec.LaplacianMatrix(p), 2 * N_HALF)
    jvals, _, _ = _solver(jspec, k, tol).solve_smallest_eigenvectors(jspec.LaplacianMatrix(j),
                                                                     2 * N_HALF)
    assert vecs.shape == (2 * N_HALF, k) and iters > 0
    slack = tol * w[-1]
    np.testing.assert_allclose(vals.numpy(), w[:k], atol=slack)
    np.testing.assert_allclose(vals.numpy(), np.asarray(jvals), atol=2 * slack)
    bound = np.sqrt(k) * slack / (w[k] - w[k - 1])
    assert max_principal_angle(vecs.numpy(), V[:, :k]) <= bound


def test_modularity_largest_eigenpair(communities):
    j, p, _ = communities
    d = _dense(j)
    deg = d.sum(1)
    w, V = np.linalg.eigh(d - np.outer(deg, deg) / deg.sum())
    tol = 1e-5
    vals, vecs, _ = _solver(pspec, 1, tol).solve_largest_eigenvectors(
        pspec.ModularityMatrix(p), 2 * N_HALF)
    np.testing.assert_allclose(vals.numpy(), w[-1:], atol=tol * w[-1])
    assert max_principal_angle(vecs.numpy(), V[:, -1:]) <= tol * w[-1] / (w[-1] - w[-2])


# ---------------------------------------------------------------------- #
# partition and modularity maximization
# ---------------------------------------------------------------------- #
def test_partition_matches_jax(communities):
    j, p, truth = communities
    got = pspec.partition(p, eigen_solver=_solver(pspec, 2, 1e-3), n_clusters=2, **CPU)
    ref = jspec.partition(j, eigen_solver=_solver(jspec, 2, 1e-3), n_clusters=2)
    labels = got.clusters.numpy()
    assert got.clusters.dtype == torch.int32 and got.eig_vecs.shape == (2 * N_HALF, 2)
    assert adjusted_rand_index(labels, truth) > 0.95
    assert adjusted_rand_index(np.asarray(ref.clusters), truth) > 0.95
    cut, cost = pspec.analyze_partition(p, 2, got.clusters, **CPU)
    jcut, jcost = jspec.analyze_partition(j, 2, jnp.asarray(labels))
    np.testing.assert_allclose(float(cut), float(jcut), rtol=1e-5)
    np.testing.assert_allclose(float(cost), float(jcost), rtol=1e-5)
    assert float(cut) <= 3 * N_CROSS
    # and the JAX package's labels, analysed by both
    cut, cost = pspec.analyze_partition(p, 2, np.array(ref.clusters), **CPU)
    jcut, jcost = jspec.analyze_partition(j, 2, ref.clusters)
    np.testing.assert_allclose([float(cut), float(cost)], [float(jcut), float(jcost)], rtol=1e-5)


@pytest.mark.parametrize("graph", ["planted", "communities"])
def test_modularity_maximization_matches_jax(graph, communities):
    if graph == "planted":
        adj = _planted_blocks()
        j = JCSR.from_dense(adj)
        truth = (np.arange(30) >= 15).astype(np.int32)
    else:
        j, _, truth = communities
    p = convert.from_reference(j, **CPU)
    got = pspec.modularity_maximization(p, n_clusters=2, **CPU)
    ref = jspec.modularity_maximization(j, n_clusters=2)
    labels = got.clusters.numpy()
    assert adjusted_rand_index(labels, truth) > 0.95
    assert adjusted_rand_index(np.asarray(ref.clusters), truth) > 0.95
    q = float(pspec.analyze_modularity(p, 2, got.clusters, **CPU))
    np.testing.assert_allclose(q, float(jspec.analyze_modularity(j, 2, jnp.asarray(labels))),
                               rtol=1e-5)
    d = _dense(j)
    deg = d.sum(1)
    B = d - np.outer(deg, deg) / deg.sum()
    q_ref = sum((labels == c) @ B @ (labels == c) for c in range(2)) / deg.sum()
    np.testing.assert_allclose(q, q_ref, rtol=1e-5)
    assert q > 0.2


# ---------------------------------------------------------------------- #
# fit_embedding
# ---------------------------------------------------------------------- #
def _ring_graph(n, seed=0):
    """The graph of bench._bench_spectral at ``n`` vertices (COO arrays)."""
    rng = np.random.default_rng(seed)
    src = np.arange(n)
    dst = (src + 1) % n
    extra = rng.integers(0, n, size=(2 * n, 2))
    extra = extra[extra[:, 0] != extra[:, 1]]
    rows = np.concatenate([src, dst, extra[:, 0], extra[:, 1]]).astype(np.int32)
    cols = np.concatenate([dst, src, extra[:, 1], extra[:, 0]]).astype(np.int32)
    return rows, cols, np.ones(rows.shape[0], np.float32)


def test_fit_embedding_spans_the_smallest_eigenvectors():
    # the embedding and the constant vector span eigenvectors 1..5 of the
    # Laplacian (a subspace check: the whitening mixes in the constant,
    # and eigenvalues 4 and 5 lie 0.006 apart); the reference's tol of
    # 0.01 leaves this graph's span unresolved, so the check runs at 1e-4
    n, k, tol = 300, 4, 1e-4
    rows, cols, vals = _ring_graph(n)
    j = JCOO(rows, cols, vals, (n, n))
    emb = fit_embedding(convert.from_reference(j, **CPU), k, tol=tol, **CPU)
    jemb = np.asarray(jfit_embedding(j, k, tol=tol))
    assert emb.shape == (n, k) and emb.dtype == torch.float32
    A = np.zeros((n, n))
    np.add.at(A, (rows, cols), 1.0)
    w, V = np.linalg.eigh(np.diag(A.sum(1)) - A)
    bound = np.sqrt(k + 1) * tol * w[-1] / (w[k + 1] - w[k])
    ones = np.ones((n, 1))
    assert max_principal_angle(np.hstack([ones, emb.numpy()]), V[:, :k + 1]) <= bound
    assert max_principal_angle(np.hstack([ones, jemb]), V[:, :k + 1]) <= bound


# ---------------------------------------------------------------------- #
# whitening, indicators, the cluster solver
# ---------------------------------------------------------------------- #
def test_whitening_zeroes_constant_column():
    # the case of tests/test_spectral.py:223
    n = 64
    const = np.full((n,), 1.0 / np.sqrt(n), np.float32)
    const += np.random.default_rng(0).normal(0, 1e-6, n).astype(np.float32)
    sig = np.concatenate([np.full(n // 2, -1.0), np.full(n // 2, 1.0)]).astype(np.float32)
    vecs = np.stack([const, sig], 1)
    emb = transform_eigen_matrix(vecs, **CPU).numpy()
    assert np.abs(emb[:, 0]).max() < 1e-2
    np.testing.assert_allclose(np.abs(emb[:, 1]), 1.0, rtol=1e-5)
    np.testing.assert_allclose(emb, np.asarray(jtransform(jnp.asarray(vecs))), rtol=RTOL,
                               atol=ATOL)


def test_whitening_matches_jax():
    x = np.random.default_rng(3).standard_normal((50, 4)).astype(np.float32)
    np.testing.assert_allclose(transform_eigen_matrix(x, **CPU).numpy(),
                               np.asarray(jtransform(jnp.asarray(x))), rtol=RTOL, atol=ATOL)


def test_construct_indicator_matches_jax(communities):
    j, p, truth = communities
    L, jL = pspec.LaplacianMatrix(p), jspec.LaplacianMatrix(j)
    for c in (0, 1, 2):                   # cluster 2 is empty
        size, quad, ok = construct_indicator(c, truth, L, **CPU)
        jsize, jquad, jok = jconstruct_indicator(c, jnp.asarray(truth), jL)
        assert float(size) == float(jsize) and bool(ok) == bool(jok)
        np.testing.assert_allclose(float(quad), float(jquad), rtol=1e-5)


def test_kmeans_solver_facade():
    X = np.random.default_rng(4).random((40, 3)).astype(np.float32)
    labels, residual, iters = pspec.KmeansSolver(pspec.ClusterSolverConfig(n_clusters=4)).solve(
        torch.from_numpy(X))
    assert labels.shape == (40,) and labels.dtype == torch.int32
    assert len(torch.unique(labels)) == 4 and float(residual) >= 0 and iters >= 1
    assert pspec.ClusterSolverConfig(n_clusters=2).n_init == 8
