"""The precision decision of the fused kNN body (``csrc/knn_tile.cuh``:
K1, K3, K4, K6), emulated on the CPU: distances from 3xTF32 dot products
stay within the tolerance that ``chip_smoke.py`` holds the kernels to
(``l2_atol``: the float32 rounding of |q|^2 + |x|^2 at the largest
norms) of the float32 plain version, on normal data and on offset data
where the expanded form cancels most, for the top-k and for K4's 1-NN;
and one TF32 pass misses the same check, so the check tells the two
apart.  K3's bfloat16 instance issues big x big alone: a bfloat16 value
is a TF32 value (its small half is 0), and products of two are exact in
float32.  The tensor cores add each wgmma's products into the float32
accumulator truncated toward zero: with the three products of a k8 step
in one accumulator, large same-sign dot products drift past the
tolerance (uniform data at depth 300, as the card showed); with the small
products in an accumulator of their own, as every instance sums them,
they stay within it."""

import numpy as np
import pytest
import torch

from helpers.tf32 import (bf16_round, dots_tf32, dots_tf32x3, knn_from_dots, nn_from_dots,
                          split_tf32, tf32_round)
from helpers.torch_parity import assert_knn_close
from raft_tpu_torch.ops.knn_tile import knn_tile_plain
from raft_tpu_torch.ops.nn_tile import nn_tile_plain

# (name, n, nq, d, k, offset)
CASES = [("normal", 3000, 40, 128, 10, 0.0), ("normal-d64", 2000, 17, 64, 100, 0.0),
         ("offset", 4000, 33, 16, 100, 100.0), ("offset-d32", 3000, 25, 32, 32, 100.0)]


def _data(n, nq, d, offset, seed=0):
    rng = np.random.default_rng(seed)
    return ((rng.standard_normal((n, d)) + offset).astype(np.float32),
            (rng.standard_normal((nq, d)) + offset).astype(np.float32))


def _l2_atol(q, x):
    return 2e-6 * (float((q * q).sum(1).max()) + float((x * x).sum(1).max()))


def _plain(x, q, k):
    d, i = knn_tile_plain(torch.from_numpy(x), torch.from_numpy(q), k)
    return d.numpy(), i.numpy()


@pytest.mark.parametrize("case", CASES, ids=lambda c: c[0])
def test_tf32x3_meets_the_float32_tolerance(case):
    _, n, nq, d, k, offset = case
    x, q = _data(n, nq, d, offset)
    got_d, got_i = knn_from_dots(q, x, dots_tf32x3(q, x), k)
    assert_knn_close(*_plain(x, q, k), got_d, got_i, 0.0, _l2_atol(q, x))


@pytest.mark.parametrize("case", CASES, ids=lambda c: c[0])
def test_one_tf32_pass_misses_it(case):
    _, n, nq, d, k, offset = case
    x, q = _data(n, nq, d, offset)
    got_d, got_i = knn_from_dots(q, x, dots_tf32(q, x), k)
    with pytest.raises(AssertionError):
        assert_knn_close(*_plain(x, q, k), got_d, got_i, 0.0, _l2_atol(q, x))


def test_tf32_rounding():
    x = np.array([1.0, 1.0 + 2.0 ** -11, 1.0 + 2.0 ** -10, 1.0 + 3 * 2.0 ** -12,
                  -(1.0 + 2.0 ** -11), 3.0e-39], np.float32)
    r = tf32_round(x)
    # 10 mantissa bits kept; a tie (2^-11) rounds away from zero
    np.testing.assert_array_equal(r[:5], np.array([1.0, 1.0 + 2.0 ** -10, 1.0 + 2.0 ** -10,
                                                   1.0 + 2.0 ** -10, -(1.0 + 2.0 ** -10)],
                                                  np.float32))
    assert (r.view(np.uint32) & 0x1FFF == 0).all()
    big, small = split_tf32(np.array([np.pi], np.float32))
    assert abs(float(big[0]) + float(small[0]) - np.pi) < 2.0 ** -21 * np.pi


# K4 at the shape of a k-means assignment, cut down: (name, m, n, d, offset)
NN_CASES = [("normal", 2000, 256, 128, 0.0), ("offset", 1500, 300, 16, 100.0)]


def _nn_check(x, y, got_v, got_i):
    ref_v, ref_i = (t.numpy() for t in nn_tile_plain(torch.from_numpy(x), torch.from_numpy(y)))
    atol = _l2_atol(x, y)
    np.testing.assert_allclose(got_v, ref_v, rtol=0, atol=atol)
    bad = got_i != ref_i                    # another index only at a tie
    alt = ((x[bad] - y[got_i[bad]]) ** 2).sum(1)
    assert (np.abs(alt - ref_v[bad]) <= atol).all()


@pytest.mark.parametrize("case", NN_CASES, ids=lambda c: c[0])
def test_tf32x3_argmin_meets_the_float32_tolerance(case):
    _, m, n, d, offset = case
    y, x = _data(n, m, d, offset, seed=3)
    _nn_check(x, y, *nn_from_dots(x, y, dots_tf32x3(x, y)))


@pytest.mark.parametrize("case", NN_CASES, ids=lambda c: c[0])
def test_one_tf32_pass_argmin_misses_it(case):
    _, m, n, d, offset = case
    y, x = _data(n, m, d, offset, seed=3)
    with pytest.raises(AssertionError):
        _nn_check(x, y, *nn_from_dots(x, y, dots_tf32(x, y)))


def test_bf16_values_are_tf32_values_with_exact_products():
    rng = np.random.default_rng(7)
    a = bf16_round(rng.standard_normal(4096).astype(np.float32) * 10)
    b = bf16_round(rng.standard_normal(4096).astype(np.float32) * 10)
    # the rounding is torch's
    np.testing.assert_array_equal(a, torch.from_numpy(a).to(torch.bfloat16).float().numpy())
    big, small = split_tf32(a)
    np.testing.assert_array_equal(big, a)
    assert (small == 0).all()
    # 8 + 8 significant bits: the float32 product is the exact one
    np.testing.assert_array_equal((a * b).astype(np.float64),
                                  a.astype(np.float64) * b.astype(np.float64))
    # so one big x big pass of bfloat16 operands is the float32 product of
    # the rounded values, as the JAX accum_bf16 path takes it
    q, x = a.reshape(64, 64), b.reshape(64, 64)
    np.testing.assert_array_equal(dots_tf32(q, x), q @ x.T)
    # which a float32 value in general is not: TF32 keeps three more bits
    v = rng.standard_normal(64).astype(np.float32)
    assert (bf16_round(v) != tf32_round(v)).any()


# same-sign data, where every truncation drifts the same way: (name, kind,
# rows of the index or y, queries or x, d, k; k 1 is K4's argmin)
SAME_SIGN_CASES = [("uniform-d300", "uniform", 3000, 40, 300, 10),
                   ("uniform-d128", "uniform", 3000, 40, 128, 100),
                   ("mixture-d128-argmin", "mixture", 256, 2000, 128, 1)]


def _same_sign(kind, n, nq, d, seed=0):
    rng = np.random.default_rng(seed)
    if kind == "uniform":
        return rng.random((n, d)).astype(np.float32), rng.random((nq, d)).astype(np.float32)
    # the IVF build's Gaussian mixture: rows of x near the centroids y
    centers = rng.standard_normal((n, d)) * 4.0
    x = centers[rng.integers(0, n, nq)] + rng.standard_normal((nq, d)) * 0.35
    y = centers + rng.standard_normal((n, d)) * 0.05
    return y.astype(np.float32), x.astype(np.float32)


def _check_dots(x, q, k, dots):
    if k == 1:
        _nn_check(q, x, *nn_from_dots(q, x, dots))
    else:
        assert_knn_close(*_plain(x, q, k), *knn_from_dots(q, x, dots, k), 0.0, _l2_atol(q, x))


@pytest.mark.parametrize("case", SAME_SIGN_CASES, ids=lambda c: c[0])
def test_truncating_sums_in_split_accumulators_meet_the_tolerance(case):
    _, kind, n, nq, d, k = case
    x, q = _same_sign(kind, n, nq, d)
    _check_dots(x, q, k, dots_tf32x3(q, x, acc="split"))


def test_truncating_sums_in_one_accumulator_miss_it():
    x, q = _same_sign("uniform", 3000, 40, 300)
    _check_dots(x, q, 10, dots_tf32x3(q, x, acc="split"))
    with pytest.raises(AssertionError):
        _check_dots(x, q, 10, dots_tf32x3(q, x, acc="one"))
