"""Port parity of the sparse distance and selection engines
(raft_tpu_torch.sparse.distance, raft_tpu_torch.sparse.selection) and
of K5's accumulate-only mode, against the JAX package, on the CPU.

The inputs are made with numpy from a seed, built as JAX CSRs, and
carried into the port by ``convert.from_reference``; every port call
passes ``device="cpu"``, where K5 and K2 run their plain versions and
the JAX package runs the Pallas ``pairwise_tile`` in interpret mode.
Both compute in float32 (the reference gets float32 arrays, whatever
x64 says), in another order: distances agree within RTOL = ATOL = 1e-5
on values of order 1 (2e-4 for the column-tiled expanded L2 forms,
whose cross terms cancel), and ids as sets up to ties.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from raft_tpu.distance import pairwise as jpairwise
from raft_tpu.ops.pairwise_tile import pairwise_tile as jax_pairwise_tile
from raft_tpu.sparse import convert as jconvert
from raft_tpu.sparse.distance import pairwise_distance as jax_sparse_pairwise
from raft_tpu.sparse.formats import COO as JCOO
from raft_tpu.sparse.formats import CSR as JCSR
from raft_tpu.sparse.selection import brute_force_knn as jax_sparse_knn
from raft_tpu.sparse.selection import knn_graph as jax_knn_graph
from raft_tpu_torch import convert as pconvert
from raft_tpu_torch.distance.distance_type import DistanceType as D
from raft_tpu_torch.ops.pairwise_tile import METRICS, apply_epilog, pairwise_tile_plain
from raft_tpu_torch.sparse import COO, CSR
from raft_tpu_torch.sparse import distance as sdist
from raft_tpu_torch.sparse import selection as ssel
from helpers.torch_parity import assert_knn_close

CPU = dict(device="cpu")
RTOL = ATOL = 1e-5
P = 3.0                   # the Minkowski exponent

# every metric the sparse engines take (tests/test_sparse_distance.py's
# METRICS and its extra column-tiled metrics, and L2Unexpanded)
SPARSE_METRICS = [D.L2Expanded, D.L2SqrtExpanded, D.InnerProduct, D.L1, D.Linf,
                  D.CosineExpanded, D.JaccardExpanded, D.DiceExpanded, D.Canberra,
                  D.LpUnexpanded, D.CorrelationExpanded, D.KLDivergence, D.HellingerExpanded,
                  D.BrayCurtis, D.HammingUnexpanded, D.JensenShannon, D.L2SqrtUnexpanded,
                  D.RusselRaoExpanded, D.L2Unexpanded]
# metrics on probability vectors (they take logs or square roots of the values)
_PROB = (D.KLDivergence, D.JensenShannon, D.HellingerExpanded)


def _dense_pair(metric, seed=7, m=23, n=19, k=17, density=0.4):
    rng = np.random.default_rng(seed)
    a = (rng.random((m, k)) * (rng.random((m, k)) < density)).astype(np.float32)
    b = (rng.random((n, k)) * (rng.random((n, k)) < density)).astype(np.float32)
    if metric in _PROB:
        a = (a / np.maximum(a.sum(1, keepdims=True), 1e-6)).astype(np.float32)
        b = (b / np.maximum(b.sum(1, keepdims=True), 1e-6)).astype(np.float32)
    return a, b


def _both(dense, capacity=256):
    """A JAX CSR of ``dense`` and the port's, carried across."""
    j = JCSR.from_dense(dense, capacity=capacity)
    return j, pconvert.from_reference(j, **CPU)


@pytest.mark.parametrize("batch_size_k", [None, 5], ids=["full_width", "column_tiled"])
@pytest.mark.parametrize("metric", SPARSE_METRICS, ids=lambda m: m.name)
def test_pairwise_matches_jax(metric, batch_size_k):
    a, b = _dense_pair(metric)
    ja, pa = _both(a)
    jb, pb = _both(b)
    kw = dict(metric_arg=P, batch_size_a=8, batch_size_b=8, batch_size_k=batch_size_k)
    ref = np.asarray(jax_sparse_pairwise(ja, jb, metric, **kw))
    got = sdist.pairwise_distance(pa, pb, metric, **kw, **CPU)
    assert got.dtype == torch.float32 and got.shape == (23, 19)
    # the column-tiled expanded L2 finalises |a|^2 + |b|^2 - 2 a.b, which
    # cancels to values near 0 from sums of order 1
    tol = 2e-4 if (batch_size_k and metric in (D.L2Expanded, D.L2SqrtExpanded)) else RTOL
    np.testing.assert_allclose(got.numpy(), ref, rtol=tol, atol=tol, equal_nan=True)


def test_column_tiled_engine_engages_for_tall_b(monkeypatch):
    # a tall, narrow b whose full-width densification (40,960 padded rows
    # x 2,048 columns, 335 MB) passes the 256 MiB budget: the engine goes
    # column-tiled with one column tile, as the JAX heuristic does
    n_cols, m, n = 2048, 8, 40_000
    rng = np.random.default_rng(5)
    a = sp.random(m, n_cols, density=0.05, format="csr", dtype=np.float32, random_state=rng)
    rows = np.repeat(np.arange(n), 4)
    cols = rng.integers(0, n_cols, n * 4)
    b = sp.coo_matrix((rng.random(n * 4).astype(np.float32), (rows, cols)), shape=(n, n_cols))
    b.sum_duplicates()
    b = b.tocsr()

    def both(s, shape):
        j = JCSR(s.indptr.astype(np.int32), s.indices.astype(np.int32),
                 s.data.astype(np.float32), shape=shape)
        return j, pconvert.from_reference(j, **CPU)

    (ja, pa), (jb, pb) = both(a, (m, n_cols)), both(b, (n, n_cols))
    assert sdist.column_tile(m, n, n_cols, 1024, 1024, None) == n_cols
    engines = []
    real = sdist._coltiled_pairwise
    monkeypatch.setattr(sdist, "_coltiled_pairwise",
                        lambda *args: engines.append(args[-1]) or real(*args))
    got = sdist.pairwise_distance(pa, pb, D.L2Expanded, **CPU).numpy()
    assert engines == [n_cols]
    ref = np.asarray(jax_sparse_pairwise(ja, jb, D.L2Expanded))
    np.testing.assert_allclose(got, ref, rtol=2e-4, atol=2e-4)
    # and a b that fits stays full width
    assert sdist.column_tile(m, 1000, n_cols, 1024, 1024, None) is None


def test_duplicate_entries_densify_the_same_every_time():
    # a CSR holding repeated (row, col) entries, in no column order: the
    # block holds their sum, the same bits on each call
    rng = np.random.default_rng(3)
    n, k, nnz = 30, 12, 200
    rows = np.sort(rng.integers(0, n, nnz))
    cols = rng.integers(0, k, nnz)
    vals = rng.standard_normal(nnz).astype(np.float32)
    indptr = np.searchsorted(rows, np.arange(n + 1)).astype(np.int32)
    csr = CSR(indptr, cols, vals, (n, k), **CPU)
    assert nnz > len(set(zip(rows.tolist(), cols.tolist())))       # duplicates held
    first = sdist.densify_rows(csr, 0, n, **CPU)
    second = sdist.densify_rows(csr, 0, n, **CPU)
    assert torch.equal(first.view(torch.int32), second.view(torch.int32))
    want = np.zeros((n, k), np.float64)
    np.add.at(want, (rows, cols), vals)
    np.testing.assert_allclose(first.numpy(), want, rtol=1e-6, atol=1e-6)
    # a block off the origin, and rows past the end stay zero
    blk = sdist.densify_block(csr, 25, 8, 4, 5, **CPU)
    np.testing.assert_allclose(blk[:5].numpy(), want[25:30, 4:9], rtol=1e-6, atol=1e-6)
    assert not blk[5:].any()
    # a block wider than its columns (the column-tiled engine's rounding
    # to a multiple of 4): the columns past bk are zero, not the next ones
    wide = sdist.densify(sdist.unique_entries(csr), 0, n, 4, 5, width=8)
    np.testing.assert_allclose(wide[:, :5].numpy(), want[:, 4:9], rtol=1e-6, atol=1e-6)
    assert not wide[:, 5:].any()


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m.name)
def test_k5_raw_mode_then_epilog_is_the_epilog_form(metric):
    # the accumulate-only mode, passed through the finaliser, is the
    # epilog form (the same reduce); over two column halves, added (or
    # maxed) and finalised once, it is the whole-depth result
    x, y = _dense_pair(D.JensenShannon if metric == D.JensenShannon else D.L1, seed=2)
    x, y = torch.from_numpy(x), torch.from_numpy(y)
    d = x.shape[1]
    raw = pairwise_tile_plain(x, y, metric, P, epilog=False)
    whole = pairwise_tile_plain(x, y, metric, P)
    assert torch.equal(apply_epilog(metric, raw, P, d), whole)
    lo = pairwise_tile_plain(x[:, :9], y[:, :9], metric, P, epilog=False)
    hi = pairwise_tile_plain(x[:, 9:], y[:, 9:], metric, P, epilog=False)
    acc = torch.maximum(lo, hi) if metric == D.Linf else lo + hi
    torch.testing.assert_close(apply_epilog(metric, acc, P, d), whole, rtol=RTOL, atol=ATOL)


_JAX_COMBINE = {D.L1: (jpairwise._c_l1, "add"), D.L2Unexpanded: (jpairwise._c_l2, "add"),
                D.L2SqrtUnexpanded: (jpairwise._c_l2, "add"), D.Linf: (jpairwise._c_l1, "max"),
                D.Canberra: (jpairwise._c_canberra, "add"),
                D.LpUnexpanded: (jpairwise._c_minkowski(P), "add"),
                D.HammingUnexpanded: (jpairwise._c_hamming, "add"),
                D.JensenShannon: (jpairwise._c_jensen_shannon, "add")}


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m.name)
def test_k5_raw_mode_matches_the_jax_kernel_without_epilog(metric):
    x, y = _dense_pair(D.JensenShannon if metric == D.JensenShannon else D.L1, seed=4)
    combine, kind = _JAX_COMBINE[metric]
    ref = np.asarray(jax_pairwise_tile(x, y, combine, reduce_kind=kind, epilog=None, init=0.0))
    got = pairwise_tile_plain(torch.from_numpy(x), torch.from_numpy(y), metric, P, epilog=False)
    np.testing.assert_allclose(got.numpy(), ref, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("metric", [D.L2Expanded, D.L1, D.InnerProduct, D.CosineExpanded],
                         ids=lambda m: m.name)
def test_sparse_knn_matches_jax(metric):
    a, b = _dense_pair(metric, seed=9, m=37, n=21)
    ja, pa = _both(a)
    jb, pb = _both(b)
    # index tiles of 8: the last holds 5 rows, fewer than k
    kw = dict(k=6, batch_size_index=8, batch_size_query=8)
    d_ref, i_ref = jax_sparse_knn(ja, jb, metric=metric, **kw)
    d_got, i_got = ssel.brute_force_knn(pa, pb, metric=metric, **kw, **CPU)
    assert_knn_close(d_ref, i_ref, d_got, i_got, rtol=RTOL, atol=ATOL)


def test_sparse_knn_pads_stay_minus_one():
    # a single index tile of 3 rows for k = 3: no pad reaches the result;
    # tiles of 2 pad each block to k with (inf, -1) and the merge drops them
    a, b = _dense_pair(D.L1, seed=1, m=3, n=4)
    _, pa = _both(a)
    _, pb = _both(b)
    d1, i1 = ssel.brute_force_knn(pa, pb, 3, D.L1, **CPU)
    d2, i2 = ssel.brute_force_knn(pa, pb, 3, D.L1, batch_size_index=2, **CPU)
    assert (i1 >= 0).all() and torch.equal(torch.sort(i1).values, torch.sort(i2).values)
    torch.testing.assert_close(d1, d2, rtol=0, atol=0)


def test_knn_graph_matches_jax_and_carries_across():
    X = np.random.default_rng(0).random((40, 4)).astype(np.float32)
    ref = jax_knn_graph(X, k=5)
    carried = pconvert.from_reference(ref, **CPU)
    assert isinstance(carried, COO) and carried.capacity == ref.rows.shape[0]
    assert int(carried.nnz) == int(ref.nnz)
    got = pconvert.to_numpy(ssel.knn_graph(X, 5, **CPU))
    assert got.shape == (40, 40) and got.nnz == int(ref.nnz)
    np.testing.assert_array_equal(got.rows, np.asarray(ref.rows))
    np.testing.assert_array_equal(got.cols, np.asarray(ref.cols))
    # the weights are sqrt of expanded-form squared L2: compared squared, as
    # a self-distance rounds to some 1e-7 and its root to some 1e-4
    np.testing.assert_allclose(got.vals ** 2, np.asarray(ref.vals) ** 2, rtol=RTOL, atol=ATOL)
    # the carried graph converts as the JAX one does
    jcsr = jconvert.coo_to_csr(ref)
    pcsr = pconvert.to_numpy(pconvert.from_reference(jcsr, **CPU))
    np.testing.assert_array_equal(pcsr.indptr, np.asarray(jcsr.indptr))


def test_sparse_pairwise_takes_a_jax_coo_built_graph():
    # a COO with duplicates, converted to CSR by the JAX package: both
    # engines sum them as the JAX densification does
    rng = np.random.default_rng(12)
    rows = rng.integers(0, 10, 60).astype(np.int32)
    cols = rng.integers(0, 9, 60).astype(np.int32)
    vals = rng.random(60).astype(np.float32)
    j = jconvert.coo_to_csr(JCOO(rows, cols, vals, (10, 9)))
    p = pconvert.from_reference(j, **CPU)
    for bk in (None, 4):
        ref = np.asarray(jax_sparse_pairwise(j, j, D.L1, batch_size_k=bk))
        got = sdist.pairwise_distance(p, p, D.L1, batch_size_k=bk, **CPU)
        np.testing.assert_allclose(got.numpy(), ref, rtol=RTOL, atol=ATOL)
