"""Port parity of the dense linear algebra (raft_tpu_torch.linalg) against
the JAX package's raft_tpu.linalg, on the CPU.

Inputs are float32 numpy arrays made from a seed, given to both packages
(the reference as explicit float32: ``tests/conftest.py`` turns on x64).
Element-wise results agree within float32 rounding (RTOL 1e-5, ATOL 1e-5
on values of order 10).  Eigen-, singular- and QR decompositions are held
by values, by reconstruction and by |cos| between matching vectors, never
by sign; Lanczos by its Ritz values and residuals.  Operations passed in
are torch functions on the port's side and jax.numpy ones on the
reference's.
"""

import importlib
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu import linalg as jl
from raft_tpu.linalg import elementwise as jel
from raft_tpu.linalg import svd as jsvd
from raft_tpu_torch import LogicError
from raft_tpu_torch import linalg as pl
from raft_tpu_torch.linalg import elementwise as pel
from raft_tpu_torch.linalg import svd as psvd

# the package exports a function named ``reduce`` over its module's name
preduce = importlib.import_module("raft_tpu_torch.linalg.reduce")

RTOL, ATOL = 1e-5, 1e-5
CPU = dict(device="cpu")


def _f32(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _j(x):
    return jnp.asarray(x, jnp.float32)


def close(got, ref, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=rtol, atol=atol)


# ---------------------------------------------------------------------- #
# gemm / gemv
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("trans_a,trans_b", [(False, False), (True, False), (False, True),
                                             (True, True)])
@pytest.mark.parametrize("alpha,beta", [(1.0, 0.0), (0.5, 2.0)])
def test_gemm_matches_jax(trans_a, trans_b, alpha, beta):
    a, b, c = _f32(7, 5), _f32(5, 6, seed=1), _f32(7, 6, seed=2)
    a = a.T.copy() if trans_a else a
    b = b.T.copy() if trans_b else b
    kw = dict(trans_a=trans_a, trans_b=trans_b, alpha=alpha, beta=beta)
    got = pl.gemm(a, b, c=c if beta else None, **kw, **CPU)
    ref = jl.gemm(_j(a), _j(b), c=_j(c) if beta else None, **kw)
    assert got.dtype == torch.float32 and got.shape == (7, 6)
    close(got, ref)


def test_gemm_precision_default_and_bf16():
    a, b = _f32(16, 300), _f32(300, 9, seed=1)
    ref64 = a.astype(np.float64) @ b.astype(np.float64)
    close(pl.gemm(a, b, precision="default", **CPU), jl.gemm(_j(a), _j(b), precision="default"),
          rtol=1e-3, atol=1e-2)
    close(pl.gemm(a, b, **CPU), ref64, rtol=1e-5, atol=1e-4)
    ab, bb = torch.from_numpy(a).bfloat16(), torch.from_numpy(b).bfloat16()
    got = pl.gemm(ab, bb, preferred_element_type=torch.float32, **CPU)
    ref = jl.gemm(jnp.asarray(ab.float().numpy(), jnp.bfloat16),
                  jnp.asarray(bb.float().numpy(), jnp.bfloat16),
                  preferred_element_type=jnp.float32)
    assert got.dtype == torch.float32 and ref.dtype == jnp.float32
    # the products of bfloat16 values are exact in float32
    close(got, ref, rtol=1e-5, atol=1e-4)
    assert pl.gemm(ab, bb, **CPU).dtype == torch.bfloat16
    with pytest.raises(LogicError, match="precision"):
        pl.gemm(a, b, precision="fastest", **CPU)


def test_gemm_shape_and_beta_checks():
    with pytest.raises(LogicError, match="inner dimensions"):
        pl.gemm(_f32(3, 4), _f32(5, 2), **CPU)
    with pytest.raises(LogicError, match="requires c"):
        pl.gemm(_f32(3, 4), _f32(4, 2), beta=1.0, **CPU)
    with pytest.raises(LogicError, match="dimension mismatch"):
        pl.gemv(_f32(3, 4), _f32(5), **CPU)


@pytest.mark.parametrize("trans_a", [False, True])
def test_gemv_matches_jax(trans_a):
    a, x, y = _f32(6, 6), _f32(6, seed=1), _f32(6, seed=2)
    got = pl.gemv(a, x, trans_a=trans_a, alpha=2.0, beta=-1.0, y=y, **CPU)
    close(got, jl.gemv(_j(a), _j(x), trans_a=trans_a, alpha=2.0, beta=-1.0, y=_j(y)))


# ---------------------------------------------------------------------- #
# norms and reductions
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("norm_type", [pl.L1Norm, pl.L2Norm, pl.LinfNorm])
@pytest.mark.parametrize("do_sqrt", [False, True])
def test_row_and_col_norm_match_jax(norm_type, do_sqrt):
    x = np.abs(_f32(9, 13)) if do_sqrt else _f32(9, 13)
    for pf, jf in ((pl.row_norm, jl.row_norm), (pl.col_norm, jl.col_norm)):
        close(pf(x, norm_type, do_sqrt, **CPU), jf(_j(x), jl.NormType(int(norm_type)), do_sqrt))
    close(pl.row_norm(x, norm_type, fin_op=lambda v: v * 3.0, **CPU),
          jl.row_norm(_j(x), jl.NormType(int(norm_type)), fin_op=lambda v: v * 3.0))


def test_mean_squared_error_matches_jax():
    a, b = _f32(5, 4), _f32(5, 4, seed=1)
    close(pl.mean_squared_error(a, b, 0.5, **CPU), jl.mean_squared_error(_j(a), _j(b), 0.5))


REDUCE_OPS = {"sum": (None, None), "max": (torch.maximum, jnp.maximum),
              "min": (torch.minimum, jnp.minimum),
              "add_lambda": (lambda a, b: a + b, lambda a, b: a + b)}


@pytest.mark.parametrize("op", list(REDUCE_OPS))
@pytest.mark.parametrize("n", [1, 2, 7, 64, 129])
def test_coalesced_and_strided_reduction_match_the_jax_fold(op, n):
    # a generic reduce_op runs as the pairwise tree; the JAX fold takes one
    # column at a time: equal up to the rounding of a reordered sum
    x = _f32(6, n)
    pop, jop = REDUCE_OPS[op]
    init = {"max": -1e30, "min": 1e30}.get(op, 0.5)
    main = (lambda v, i: v * v + i), (lambda v, i: v * v + i)
    got = pl.coalesced_reduction(x, main_op=main[0], reduce_op=pop, init=init,
                                 final_op=lambda v: v / 2, **CPU)
    ref = jl.coalesced_reduction(_j(x), main_op=main[1], reduce_op=jop, init=init,
                                 final_op=lambda v: v / 2)
    close(got, ref, rtol=2e-5, atol=1e-4)
    acc = _f32(6, seed=3)
    got = pl.strided_reduction(x.T.copy(), reduce_op=pop, init=init, inplace_accumulate=acc,
                               **CPU)
    ref = jl.strided_reduction(_j(x.T.copy()), reduce_op=jop, init=init,
                               inplace_accumulate=_j(acc))
    close(got, ref, rtol=2e-5, atol=1e-4)


@pytest.mark.parametrize("n", [1, 2, 3, 4096, 4097])
def test_tree_reduce_takes_log2_steps(n):
    calls = []

    def op(a, b):
        calls.append(a.shape)
        return torch.maximum(a, b)

    x = torch.from_numpy(_f32(3, n))
    got = preduce._tree_reduce(x, 1, op, -float("inf"))
    assert torch.equal(got, x.amax(dim=1))
    assert len(calls) == math.ceil(math.log2(n)) + 1      # the steps, then init


def test_reduce_dispatch_and_map_then_reduce_match_jax():
    x = _f32(5, 8)
    for along_rows in (True, False):
        close(pl.reduce(x, along_rows=along_rows, main_op=lambda v, i: v * 2, **CPU),
              jl.reduce(_j(x), along_rows=along_rows, main_op=lambda v, i: v * 2))
    a, b = _f32(4, 3), _f32(4, 3, seed=1)
    close(pl.map_then_reduce(lambda u, v: u * v, torch.maximum, -1e30, a, b, **CPU),
          jl.map_then_reduce(lambda u, v: u * v, jnp.maximum, -1e30, _j(a), _j(b)))
    close(pl.map_then_reduce(lambda u, v: u - v, None, 0.0, a, b, **CPU),
          jl.map_then_reduce(lambda u, v: u - v, None, 0.0, _j(a), _j(b)))
    close(pl.map_then_sum_reduce(lambda u: u * u, a, **CPU),
          jl.map_then_sum_reduce(lambda u: u * u, _j(a)))


def test_transpose_is_a_contiguous_copy():
    x = _f32(5, 7)
    got = pl.transpose(x, **CPU)
    assert got.is_contiguous() and got.shape == (7, 5)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jl.transpose(_j(x))))


# ---------------------------------------------------------------------- #
# elementwise, matrix_vector_op, init
# ---------------------------------------------------------------------- #
BINARY = ["eltwise_add", "eltwise_sub", "eltwise_multiply", "eltwise_divide",
          "eltwise_divide_check_zero", "add", "subtract"]
SCALAR = ["add_scalar", "subtract_scalar", "multiply_scalar", "divide_scalar"]


@pytest.mark.parametrize("name", BINARY + SCALAR)
def test_elementwise_matches_jax(name):
    x, y = _f32(4, 5), _f32(4, 5, seed=1)
    y[0, :2] = 0.0
    if name in SCALAR:
        got, ref = getattr(pel, name)(x, 1.5, **CPU), getattr(jel, name)(_j(x), 1.5)
    else:
        got, ref = getattr(pel, name)(x, y, **CPU), getattr(jel, name)(_j(x), _j(y))
    close(got, ref)


def test_ops_with_operations_match_jax():
    x, y, z = _f32(3, 4), _f32(3, 4, seed=1), _f32(3, 4, seed=2)
    close(pl.unary_op(x, torch.exp, **CPU), jl.unary_op(_j(x), jnp.exp))
    close(pl.binary_op(x, y, torch.maximum, **CPU), jl.binary_op(_j(x), _j(y), jnp.maximum))
    close(pl.map_op(lambda a, b, c: a * b + c, x, y, z, **CPU),
          jl.map_op(lambda a, b, c: a * b + c, _j(x), _j(y), _j(z)))
    got = pel.write_only_unary_op((3, 4), torch.float32, lambda i: i * 2, **CPU)
    ref = jel.write_only_unary_op((3, 4), jnp.float32, lambda i: i * 2)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(pl.range_init(3, 9, **CPU).numpy(),
                                  np.asarray(jl.range_init(3, 9)))
    assert pl.range_init(0, 3, torch.int64, **CPU).dtype == torch.int64


@pytest.mark.parametrize("along_rows", [True, False])
def test_matrix_vector_op_matches_jax(along_rows):
    m = _f32(4, 6)
    v = _f32(6 if along_rows else 4, seed=1)
    v2 = _f32(6 if along_rows else 4, seed=2)
    close(pl.matrix_vector_op(m, v, torch.mul, along_rows, **CPU),
          jl.matrix_vector_op(_j(m), _j(v), jnp.multiply, along_rows))
    close(pl.matrix_vector_op(m, v, lambda a, b, c: a * b - c, along_rows, vec2=v2, **CPU),
          jl.matrix_vector_op(_j(m), _j(v), lambda a, b, c: a * b - c, along_rows,
                              vec2=_j(v2)))
    with pytest.raises(LogicError, match="vector length"):
        pl.matrix_vector_op(m, _f32(5), torch.mul, along_rows, **CPU)


# ---------------------------------------------------------------------- #
# eig, svd, qr, cholesky
# ---------------------------------------------------------------------- #
def _sym(n, seed=0):
    a = _f32(n, n, seed=seed)
    return (a + a.T) / 2


def _abs_cos(u, v):
    """|cos| of the angle between matching columns."""
    u, v = np.asarray(u, np.float64), np.asarray(v, np.float64)
    return np.abs((u * v).sum(0)) / (np.linalg.norm(u, axis=0) * np.linalg.norm(v, axis=0))


@pytest.mark.parametrize("fn", ["eig_dc", "eig_jacobi"])
def test_eig_matches_jax(fn):
    a = _sym(12)
    (v, w), (jv, jw) = getattr(pl, fn)(a, **CPU), getattr(jl, fn)(_j(a))
    close(w, jw, atol=1e-5)
    assert (_abs_cos(v, jv) > 1 - 1e-4).all()
    close(v.numpy() @ np.diag(w.numpy()) @ v.numpy().T, a, atol=1e-5)


@pytest.mark.parametrize("largest", [False, True])
def test_eig_sel_dc_matches_jax(largest):
    a = _sym(10, seed=3)
    (v, w), (jv, jw) = pl.eig_sel_dc(a, 3, largest, **CPU), jl.eig_sel_dc(_j(a), 3, largest)
    close(w, jw, atol=1e-5)
    assert (_abs_cos(v, jv) > 1 - 1e-4).all()
    with pytest.raises(LogicError):
        pl.eig_sel_dc(a, 11, **CPU)
    with pytest.raises(LogicError, match="square"):
        pl.eig_dc(_f32(3, 4), **CPU)


@pytest.mark.parametrize("fn", ["svd_qr", "svd_eig", "svd_jacobi"])
def test_svd_matches_jax(fn):
    a = _f32(20, 6)
    (u, s, v), (ju, js, jv) = getattr(pl, fn)(a, **CPU), getattr(jl, fn)(_j(a))
    close(s, js, atol=1e-4)
    assert (_abs_cos(v, jv) > 1 - 1e-3).all() and (_abs_cos(u, ju) > 1 - 1e-3).all()
    close(pl.svd_reconstruction(u, s, v, **CPU), a, atol=1e-4)
    close(pl.svd_reconstruction(u, s, v, **CPU), jl.svd_reconstruction(ju, js, jv), atol=1e-4)
    assert psvd.evaluate_svd_by_l2_norm(a, u, s, v, 1e-5, **CPU)
    assert jsvd.evaluate_svd_by_l2_norm(_j(a), ju, js, jv, 1e-5)
    assert not psvd.evaluate_svd_by_l2_norm(a, u, s * 2, v, 1e-5, **CPU)


def test_svd_options():
    a = _f32(8, 5)
    u, s, v = pl.svd_qr(a, gen_u=False, gen_v=False, **CPU)
    assert u is None and v is None and s.shape == (5,)
    assert pl.svd_eig(a, gen_left_vec=False, **CPU)[0] is None
    with pytest.raises(LogicError, match="m >= n"):
        pl.svd_eig(a.T.copy(), **CPU)


def test_qr_matches_jax():
    a = _f32(9, 4)
    q, r = pl.qr_get_qr(a, **CPU)
    jq, jr = jl.qr_get_qr(_j(a))
    close(np.abs(np.asarray(r)), np.abs(np.asarray(jr)), atol=1e-5)
    assert (_abs_cos(q, jq) > 1 - 1e-5).all()
    close(q.numpy() @ r.numpy(), a, atol=1e-5)
    q1 = pl.qr_get_q(a, **CPU)
    assert (_abs_cos(q1, jl.qr_get_q(_j(a))) > 1 - 1e-5).all()
    close(q1.numpy().T @ q1.numpy(), np.eye(4), atol=1e-5)


@pytest.mark.parametrize("lower", [True, False])
@pytest.mark.parametrize("n", [1, 2, 5])
def test_cholesky_rank1_update_matches_jax(lower, n):
    b = _f32(5, 5)
    spd = (b @ b.T + 5 * np.eye(5)).astype(np.float32)
    full = np.linalg.cholesky(spd.astype(np.float64)).astype(np.float32)
    if not lower:
        full = full.T.copy()
    # the leading block holds the factor, the new row/column holds A
    work = full.copy()
    if lower:
        work[n - 1, :n] = spd[n - 1, :n]
    else:
        work[:n, n - 1] = spd[:n, n - 1]
    got = pl.cholesky_rank1_update(work, n, lower, **CPU)
    ref = jl.cholesky_rank1_update(_j(work), n, lower)
    close(got, ref, atol=1e-5)
    close(got[:n, :n], full[:n, :n], atol=1e-4)
    with pytest.raises(LogicError, match="positive definite"):
        pl.cholesky_rank1_update(-np.eye(3, dtype=np.float32), 1, lower, eps=1e-6, **CPU)


# ---------------------------------------------------------------------- #
# Lanczos
# ---------------------------------------------------------------------- #
def _path_laplacian_spd(n):
    """A symmetric matrix with well-separated extreme eigenvalues."""
    d = np.linspace(1.0, 50.0, n)
    q, _ = np.linalg.qr(np.random.default_rng(5).standard_normal((n, n)))
    return (q @ np.diag(d) @ q.T).astype(np.float32), d


@pytest.mark.parametrize("which", ["smallest", "largest"])
@pytest.mark.parametrize("operator", ["dense", "callable"])
def test_lanczos_matches_jax_by_ritz_values_and_residuals(which, operator):
    n, k = 120, 4
    a, d = _path_laplacian_spd(n)
    pf = pl.compute_smallest_eigenvectors if which == "smallest" else \
        pl.compute_largest_eigenvectors
    jf = jl.compute_smallest_eigenvectors if which == "smallest" else \
        jl.compute_largest_eigenvectors
    at = torch.from_numpy(a)
    op = at if operator == "dense" else (lambda x: at @ x)
    vals, vecs, iters = pf(op, n, k, tol=1e-6, **CPU)
    jvals, jvecs, _ = jf(_j(a), n, k, tol=1e-6)
    want = np.sort(d)[:k] if which == "smallest" else np.sort(d)[::-1][:k]
    close(vals, want, rtol=1e-4, atol=1e-4)
    close(vals, jvals, rtol=1e-4, atol=1e-4)
    resid = np.linalg.norm(a @ vecs.numpy() - vecs.numpy() * vals.numpy()[None, :], axis=0)
    assert resid.max() <= 1e-3 * np.abs(d).max()
    assert (_abs_cos(vecs, jvecs) > 1 - 1e-3).all()
    assert iters >= 1 and vecs.shape == (n, k)


def test_lanczos_small_n_and_argument_checks():
    a, d = _path_laplacian_spd(10)
    vals, _, iters = pl.compute_smallest_eigenvectors(a, 10, 3, **CPU)
    close(vals, np.sort(d)[:3], rtol=1e-4, atol=1e-4)
    assert iters == 10                     # one expansion spans the space
    with pytest.raises(LogicError, match="0 < k < n"):
        pl.compute_smallest_eigenvectors(a, 10, 10, **CPU)
    with pytest.raises(LogicError, match="matrix"):
        pl.compute_smallest_eigenvectors(a, 12, 2, **CPU)


def test_lanczos_is_reproducible_from_its_seed():
    a, _ = _path_laplacian_spd(80)
    r1 = pl.compute_smallest_eigenvectors(a, 80, 2, seed=7, maxiter=200, **CPU)
    r2 = pl.compute_smallest_eigenvectors(a, 80, 2, seed=7, maxiter=200, **CPU)
    assert torch.equal(r1[0], r2[0]) and torch.equal(r1[1], r2[1]) and r1[2] == r2[2]
