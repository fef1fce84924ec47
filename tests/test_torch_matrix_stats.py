"""Port parity of the matrix helpers (raft_tpu_torch.matrix) and the column
statistics (raft_tpu_torch.stats) against the JAX package's, on the CPU.

Inputs are float32 numpy arrays made from a seed, given to the reference as
explicit float32 (``tests/conftest.py`` turns on x64).  Gathers, slices,
reversals and fills are held exactly; arithmetic within float32 rounding
(RTOL 1e-5, ATOL 1e-6 on values of order 1).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu import matrix as jm
from raft_tpu import stats as js
from raft_tpu_torch import LogicError
from raft_tpu_torch import matrix as pm
from raft_tpu_torch import stats as ps

RTOL, ATOL = 1e-5, 1e-6
CPU = dict(device="cpu")


def _f32(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _j(x):
    return jnp.asarray(x, jnp.float32)


def close(got, ref, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=rtol, atol=atol)


def exact(got, ref):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(ref))


# ---------------------------------------------------------------------- #
# matrix.py
# ---------------------------------------------------------------------- #
def test_copy_rows_matches_jax():
    x, idx = _f32(8, 3), np.array([5, 0, 5, 7], np.int32)
    exact(pm.copy_rows(x, idx, **CPU), jm.copy_rows(_j(x), jnp.asarray(idx)))


@pytest.mark.parametrize("name", ["col_reverse", "row_reverse", "copy_upper_triangular",
                                  "get_l2_norm"])
@pytest.mark.parametrize("shape", [(5, 5), (4, 6), (6, 4)])
def test_unary_matrix_helpers_match_jax(name, shape):
    x = _f32(*shape)
    close(getattr(pm, name)(x, **CPU), getattr(jm, name)(_j(x)))


def test_diagonal_inverse_matches_jax():
    # a zero on the diagonal inverts to 0; the off-diagonal entries stay
    x = _f32(5, 5)
    x[1, 1] = 0.0
    close(pm.get_diagonal_inverse_matrix(x, **CPU), jm.get_diagonal_inverse_matrix(_j(x)))


def test_slicing_matches_jax():
    x = _f32(6, 7)
    exact(pm.trunc_zero_origin(x, 3, 4, **CPU), jm.trunc_zero_origin(_j(x), 3, 4))
    exact(pm.slice_matrix(x, 1, 2, 5, 7, **CPU), jm.slice_matrix(_j(x), 1, 2, 5, 7))
    with pytest.raises(LogicError, match="exceeds source"):
        pm.trunc_zero_origin(x, 7, 2, **CPU)
    with pytest.raises(LogicError, match="invalid bounds"):
        pm.slice_matrix(x, 3, 0, 3, 2, **CPU)


def test_diagonal_and_print_match_jax():
    v = _f32(4)
    exact(pm.initialize_diagonal_matrix(v, **CPU), jm.initialize_diagonal_matrix(_j(v)))
    x = np.array([[1.5, -2.0], [0.25, 3.0]], np.float32)
    assert pm.print_host(x, **CPU) == jm.print_host(np.asarray(x)) == "1.5,-2.0;0.25,3.0"
    assert pm.print_host(x, "|", " ", **CPU) == jm.print_host(np.asarray(x), "|", " ")


# ---------------------------------------------------------------------- #
# math.py
# ---------------------------------------------------------------------- #
MATH_UNARY = {
    "power": {}, "power_scaled": {"scalar": 2.5},
    "seq_root": {"scalar": 2.0, "set_neg_zero": True},
    "set_small_values_zero": {"thres": 0.3},
    "reciprocal": {"scalar": 2.0}, "reciprocal_setzero": {"setzero": True, "thres": 0.3},
    "set_value": {"scalar": 4.0}, "ratio": {}, "argmax": {}, "sign_flip": {},
}


@pytest.mark.parametrize("case", list(MATH_UNARY))
def test_math_helpers_match_jax(case):
    x = _f32(6, 5)
    x[2, 3] = 0.0
    name = case.split("_scaled")[0].split("_setzero")[0]
    kw = MATH_UNARY[case]
    got, ref = getattr(pm, name)(x, **kw, **CPU), getattr(jm, name)(_j(x), **kw)
    if name == "argmax":
        exact(got, ref)
    else:
        close(got, ref)


BROADCAST = ["matrix_vector_binary_mult", "matrix_vector_binary_mult_skip_zero",
             "matrix_vector_binary_div", "matrix_vector_binary_div_skip_zero",
             "matrix_vector_binary_add", "matrix_vector_binary_sub"]


@pytest.mark.parametrize("name", BROADCAST)
@pytest.mark.parametrize("along_rows", [True, False])
def test_broadcast_ops_match_jax(name, along_rows):
    x = _f32(4, 6)
    v = _f32(6 if along_rows else 4, seed=1)
    v[1] = 0.0
    close(getattr(pm, name)(x, v, along_rows, **CPU), getattr(jm, name)(_j(x), _j(v), along_rows))
    if name.endswith("div_skip_zero"):
        close(getattr(pm, name)(x, v, along_rows, return_zero=True, **CPU),
              getattr(jm, name)(_j(x), _j(v), along_rows, return_zero=True))


# ---------------------------------------------------------------------- #
# stats
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("sample", [True, False])
def test_column_statistics_match_jax(sample):
    x = _f32(40, 7) * 3 + 1
    close(ps.mean(x, sample, **CPU), js.mean(_j(x), sample))
    close(ps.sum_cols(x, **CPU), js.sum_cols(_j(x)), atol=1e-5)
    close(ps.vars_(x, sample=sample, **CPU), js.vars_(_j(x), sample=sample), atol=1e-5)
    close(ps.stddev(x, sample=sample, **CPU), js.stddev(_j(x), sample=sample))
    mu = _f32(7, seed=1)
    close(ps.vars_(x, mu, sample, **CPU), js.vars_(_j(x), _j(mu), sample), atol=1e-4)
    close(ps.stddev(x, mu, sample, **CPU), js.stddev(_j(x), _j(mu), sample))


@pytest.mark.parametrize("along_rows", [True, False])
def test_mean_center_and_add_match_jax(along_rows):
    x = _f32(5, 5)
    mu = _f32(5, seed=2)
    got = ps.mean_center(x, mu, along_rows, **CPU)
    exact(got, js.mean_center(_j(x), _j(mu), along_rows))
    close(ps.mean_add(got, mu, along_rows, **CPU), x)


def test_statistics_reject_a_missing_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(Exception, match="CUDA"):
        ps.mean(_f32(3, 2))
    with pytest.raises(Exception, match="CUDA"):
        pm.power(_f32(3, 2))
