"""Port parity of the sparse core (raft_tpu_torch.sparse: formats,
convert, op, linalg) against the JAX package's raft_tpu.sparse, on the
CPU.

One graph is built in the JAX package, padded (sentinel rows, nnz below
capacity, duplicate coordinates), and carried into the port by
``convert.from_reference``; every function runs on both and the outputs
are compared entry by entry (padding included).  Ids, counts, masks and
orders are exact.  Values that are sums agree within float32 rounding of
a few terms (RTOL 1e-6, ATOL 1e-6 on values of order 1); maxima, minima
and moved values are exact.  Every port call passes ``device="cpu"``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu.sparse import convert as jconvert
from raft_tpu.sparse import linalg as jlinalg
from raft_tpu.sparse import op as jop
from raft_tpu.sparse.formats import COO as JCOO
from raft_tpu.sparse.formats import CSR as JCSR
from raft_tpu_torch import RaftError
from raft_tpu_torch import convert as pconvert
from raft_tpu_torch.sparse import COO, CSR
from raft_tpu_torch.sparse import convert as sconvert
from raft_tpu_torch.sparse import linalg as plinalg
from raft_tpu_torch.sparse import op as pop
from raft_tpu_torch.spectral import SparseMatrix

RTOL, ATOL = 1e-6, 1e-6
CPU = dict(device="cpu")
N, N_EDGES, CAP = 40, 150, 200


def _graph(seed=0, n=N, n_edges=N_EDGES, cap=CAP, levels=None):
    """A JAX COO of ``n_edges`` random directed edges (some repeated)
    padded to ``cap`` with sentinel rows; values uniform, or drawn from
    ``levels`` distinct values."""
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, n, n_edges)
    cols = rng.integers(0, n, n_edges)
    rows[-10:], cols[-10:] = rows[:10], cols[:10]        # ten exact duplicates
    if levels:
        vals = rng.integers(0, levels, n_edges).astype(np.float32)
    else:
        vals = rng.random(n_edges).astype(np.float32) + 0.1
    r = np.full(cap, n, np.int32)
    c = np.zeros(cap, np.int32)
    v = np.zeros(cap, np.float32)
    r[:n_edges], c[:n_edges], v[:n_edges] = rows, cols, vals
    return JCOO(r, c, v, (n, n), n_edges)


def _csr(seed=0, **kw):
    """A JAX CSR (deduplicated, padded) of :func:`_graph`."""
    return jconvert.coo_to_csr(jop.max_duplicates(_graph(seed, **kw)), assume_sorted=True)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def assert_coo_equal(got, ref, exact_vals=True):
    g = pconvert.to_numpy(got)
    assert g.shape == tuple(ref.shape)
    assert int(g.nnz) == int(ref.nnz)
    np.testing.assert_array_equal(g.rows, np.asarray(ref.rows))
    np.testing.assert_array_equal(g.cols, np.asarray(ref.cols))
    assert g.rows.dtype == np.int32 and g.cols.dtype == np.int32
    if exact_vals:
        np.testing.assert_array_equal(g.vals, np.asarray(ref.vals))
    else:
        np.testing.assert_allclose(g.vals, np.asarray(ref.vals), rtol=RTOL, atol=ATOL)


def assert_csr_equal(got, ref, exact_vals=True):
    g = pconvert.to_numpy(got)
    assert g.shape == tuple(ref.shape)
    np.testing.assert_array_equal(g.indptr, np.asarray(ref.indptr))
    nnz = int(np.asarray(ref.indptr)[-1])
    np.testing.assert_array_equal(g.indices[:nnz], np.asarray(ref.indices)[:nnz])
    assert g.indptr.dtype == np.int32 and g.indices.dtype == np.int32
    assert g.indices.shape == np.asarray(ref.indices).shape
    if exact_vals:
        np.testing.assert_array_equal(g.data[:nnz], np.asarray(ref.data)[:nnz])
    else:
        np.testing.assert_allclose(g.data[:nnz], np.asarray(ref.data)[:nnz], rtol=RTOL,
                                   atol=ATOL)


# ---------------------------------------------------------------------- #
# formats and the carry across
# ---------------------------------------------------------------------- #
def test_coo_carried_across_keeps_its_contract():
    j = _graph()
    p = pconvert.from_reference(j, **CPU)
    assert isinstance(p, COO) and p.device.type == "cpu"
    assert p.capacity == CAP and p.nnz == N_EDGES and p.sentinel == N and p.shape == (N, N)
    assert p.rows.dtype == torch.int32 and p.cols.dtype == torch.int32
    np.testing.assert_array_equal(_np(p.valid_mask()), np.asarray(j.valid_mask()))
    assert_coo_equal(p, j)
    np.testing.assert_allclose(_np(p.to_dense()), np.asarray(j.to_dense()), rtol=RTOL, atol=ATOL)
    assert_coo_equal(p.compact(), j.compact())
    # and back: the host arrays carry into the port again unchanged
    assert_coo_equal(pconvert.from_reference(pconvert.to_numpy(p), **CPU), j)


def test_csr_carried_across_keeps_its_contract():
    j = _csr()
    p = pconvert.from_reference(j, **CPU)
    assert isinstance(p, CSR) and p.capacity == j.capacity
    assert int(p.nnz) == int(j.nnz) < p.capacity          # padding at the tail
    assert_csr_equal(p, j)
    np.testing.assert_array_equal(_np(p.row_ids()), np.asarray(j.row_ids()))
    np.testing.assert_array_equal(_np(p.to_dense()), np.asarray(j.to_dense()))


@pytest.mark.parametrize("capacity", [None, 90])
def test_from_dense(capacity):
    d = (np.random.default_rng(3).random((9, 7)) < 0.3) * np.arange(63.0).reshape(9, 7)
    d = d.astype(np.float32)
    assert_coo_equal(COO.from_dense(d, capacity, **CPU), JCOO.from_dense(d, capacity))
    assert_csr_equal(CSR.from_dense(d, capacity, **CPU), JCSR.from_dense(d, capacity))
    assert_csr_equal(sconvert.dense_to_csr(d, capacity, **CPU), jconvert.dense_to_csr(d, capacity))
    with pytest.raises(RaftError, match="capacity"):
        COO.from_dense(d, 3, **CPU)


# ---------------------------------------------------------------------- #
# convert
# ---------------------------------------------------------------------- #
def test_conversions():
    j = _graph()
    p = pconvert.from_reference(j, **CPU)
    jcsr = jconvert.coo_to_csr(j)
    pcsr = sconvert.coo_to_csr(p)
    assert_csr_equal(pcsr, jcsr)
    srt = jop.coo_sort(j)
    np.testing.assert_array_equal(
        _np(sconvert.sorted_rows_to_indptr(torch.from_numpy(np.array(srt.rows)), N)),
        np.asarray(jconvert.sorted_rows_to_indptr(srt.rows, N)))
    assert_coo_equal(sconvert.csr_to_coo(pcsr), jconvert.csr_to_coo(jcsr))
    np.testing.assert_allclose(_np(sconvert.csr_to_dense(pcsr)),
                               np.asarray(jconvert.csr_to_dense(jcsr)), rtol=RTOL, atol=ATOL)


# ---------------------------------------------------------------------- #
# op
# ---------------------------------------------------------------------- #
def test_sorts():
    j = _graph()
    p = pconvert.from_reference(j, **CPU)
    assert_coo_equal(pop.coo_sort(p, **CPU), jop.coo_sort(j))
    assert_coo_equal(pop.coo_sort_by_weight(p, **CPU), jop.coo_sort_by_weight(j))


def test_duplicates_mask():
    s = jop.coo_sort(_graph())
    got = pop.compute_duplicates_mask(np.array(s.rows), np.array(s.cols), N, **CPU)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(_np(got),
                                  np.asarray(jop.compute_duplicates_mask(s.rows, s.cols, N)))


def test_max_and_sum_duplicates():
    j = _graph()
    p = pconvert.from_reference(j, **CPU)
    got = pop.max_duplicates(p, **CPU)
    assert isinstance(got.nnz, torch.Tensor)              # no host read
    assert_coo_equal(got, jop.max_duplicates(j))
    assert int(got.nnz) < N_EDGES                           # the duplicates went
    assert_coo_equal(pop.sum_duplicates(p, **CPU), jop.sum_duplicates(j), exact_vals=False)


def test_remove_scalar_and_zeros():
    j = _graph(levels=4)
    p = pconvert.from_reference(j, **CPU)
    assert_coo_equal(pop.coo_remove_scalar(p, 2.0, **CPU), jop.coo_remove_scalar(j, 2.0))
    got = pop.coo_remove_zeros(p, **CPU)
    assert_coo_equal(got, jop.coo_remove_zeros(j))
    assert int(got.nnz) < N_EDGES


def test_csr_row_op_and_slice():
    j = _csr()
    p = pconvert.from_reference(j, **CPU)
    got = pop.csr_row_op(p, lambda r, v: r.to(torch.float32) * 10 + v, **CPU)
    np.testing.assert_array_equal(_np(got),
                                  np.asarray(jop.csr_row_op(j, lambda r, v: r * 10.0 + v)))
    for start, stop in [(0, N), (5, 17), (39, 40), (12, 12)]:
        assert_csr_equal(pop.csr_row_slice(p, start, stop, **CPU),
                         jop.csr_row_slice(j, start, stop))


# ---------------------------------------------------------------------- #
# linalg
# ---------------------------------------------------------------------- #
def test_degrees():
    j = _graph(levels=3)
    p = pconvert.from_reference(j, **CPU)
    for got, ref in [(plinalg.coo_degree(p, **CPU), jlinalg.coo_degree(j)),
                     (plinalg.coo_degree_scalar(p, 1.0, **CPU), jlinalg.coo_degree_scalar(j, 1.0))]:
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(_np(got), np.asarray(ref))
    jc = _csr()
    np.testing.assert_array_equal(_np(plinalg.csr_degree(pconvert.from_reference(jc, **CPU),
                                                         **CPU)),
                                  np.asarray(jlinalg.csr_degree(jc)))


def test_row_norms_and_normalization():
    # rows 3 and 7 empty, and a row whose max is 0
    d = np.random.default_rng(5).standard_normal((12, 9)).astype(np.float32)
    d[np.abs(d) < 0.6] = 0
    d[[3, 7]] = 0
    d[9] = -np.abs(d[9])
    j = JCSR.from_dense(d, capacity=120)
    p = CSR.from_dense(d, capacity=120, **CPU)
    for norm in ("l1", "l2", "linf"):
        np.testing.assert_allclose(_np(plinalg.csr_row_norm(p, norm, **CPU)),
                                   np.asarray(jlinalg.csr_row_norm(j, norm)), rtol=RTOL,
                                   atol=ATOL)
    assert_csr_equal(plinalg.csr_row_normalize_l1(p, **CPU), jlinalg.csr_row_normalize_l1(j),
                     exact_vals=False)
    assert_csr_equal(plinalg.csr_row_normalize_max(p, **CPU), jlinalg.csr_row_normalize_max(j),
                     exact_vals=False)


def test_add_and_transpose():
    ja, jb = _csr(1), _csr(2)
    pa, pb = pconvert.from_reference(ja, **CPU), pconvert.from_reference(jb, **CPU)
    got = plinalg.csr_add(pa, pb, **CPU)
    assert got.capacity == ja.capacity + jb.capacity
    assert_csr_equal(got, jlinalg.csr_add(ja, jb), exact_vals=False)
    assert_csr_equal(plinalg.csr_transpose(pa, **CPU), jlinalg.csr_transpose(ja))
    # a rectangular matrix
    d = np.random.default_rng(8).random((6, 11)).astype(np.float32)
    d[d < 0.6] = 0
    assert_csr_equal(plinalg.csr_transpose(CSR.from_dense(d, 50, **CPU), **CPU),
                     jlinalg.csr_transpose(JCSR.from_dense(d, 50)))


@pytest.mark.parametrize("reduce", ["sum", "max"])
def test_symmetrize(reduce):
    j = _graph()
    p = pconvert.from_reference(j, **CPU)
    if reduce == "sum":
        got, ref = plinalg.coo_symmetrize(p, **CPU), jlinalg.coo_symmetrize(j)
    else:
        got = plinalg.coo_symmetrize(p, torch.maximum, **CPU)
        ref = jlinalg.coo_symmetrize(j, jnp.maximum)
    assert got.capacity == 2 * CAP
    assert_coo_equal(got, ref, exact_vals=reduce == "max")
    dense = _np(got.to_dense())
    np.testing.assert_array_equal(dense, dense.T)


def test_symmetrize_knn():
    rng = np.random.default_rng(4)
    idx = np.stack([rng.permutation(30)[:5] for _ in range(30)]).astype(np.int32)
    dist = rng.random((30, 5)).astype(np.float32)
    assert_coo_equal(plinalg.symmetrize_knn(idx, dist, 30, **CPU),
                     jlinalg.symmetrize_knn(jnp.asarray(idx), jnp.asarray(dist), 30))


@pytest.mark.parametrize("impl", list(plinalg.SPMV_IMPLS))
def test_spmv_routes(impl):
    # held to the JAX package's route of the same name, and to a float64
    # product of the dense matrix
    j = _csr(6)
    p = pconvert.from_reference(j, **CPU)
    x = np.random.default_rng(7).standard_normal(N).astype(np.float32)
    got = plinalg.csr_spmv(p, x, impl, **CPU)
    assert got.shape == (N,) and got.dtype == torch.float32
    np.testing.assert_allclose(_np(got), np.asarray(jlinalg.csr_spmv(j, jnp.asarray(x), impl)),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(_np(got), np.asarray(j.to_dense(), np.float64) @ x, rtol=1e-5,
                               atol=1e-5)
    if impl == "sortscan":
        assert torch.equal(got, plinalg.csr_spmv(p, x, "segment", **CPU))


def test_spmm():
    j = _csr(6)
    p = pconvert.from_reference(j, **CPU)
    x = np.random.default_rng(9).standard_normal((N, 3)).astype(np.float32)
    got = plinalg.csr_spmm(p, x, **CPU)
    np.testing.assert_allclose(_np(got), np.asarray(jlinalg.csr_spmm(j, jnp.asarray(x))),
                               rtol=1e-5, atol=1e-5)
    for c in range(3):          # column by column, the SpMV's sums exactly
        assert torch.equal(got[:, c], plinalg.csr_spmv(p, x[:, c], **CPU))


def test_weak_cc():
    # four components: two cliques, a path, and an isolated vertex
    n = 25
    d = np.zeros((n, n), np.float32)
    d[:6, :6] = 1
    d[10:15, 10:15] = 1
    for i in range(16, 23):
        d[i, i + 1] = 1                       # directed: weak connectivity
    d[7, 24] = d[24, 6] = 1
    np.fill_diagonal(d, 0)
    j = JCSR.from_dense(d, capacity=120)
    p = CSR.from_dense(d, capacity=120, **CPU)
    got = plinalg.weak_cc(p, **CPU)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(_np(got), np.asarray(jlinalg.weak_cc(j)))
    # {0-5} {6, 7, 24} {8} {9} {10-14} {15} {16-23}
    assert len(np.unique(_np(got))) == 7
    np.testing.assert_array_equal(_np(plinalg.weak_cc(p, 1, **CPU)),
                                  np.asarray(jlinalg.weak_cc(j, 1)))


@pytest.mark.parametrize("bad", ["segmnet", "Segment", ""])
def test_misspelled_spmv_impl_raises(bad):
    p = pconvert.from_reference(_csr(), **CPU)
    with pytest.raises(RaftError, match="spmv_impl"):
        SparseMatrix(p, spmv_impl=bad)
    with pytest.raises(RaftError, match="spmv_impl"):
        plinalg.csr_spmv(p, np.ones(N, np.float32), bad, **CPU)
