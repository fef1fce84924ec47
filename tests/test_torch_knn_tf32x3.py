"""The precision decision of K1 and K6 (``csrc/knn_tile.cuh``), emulated
on the CPU: distances from 3xTF32 dot products stay within the tolerance
that ``chip_smoke.py`` holds the kernels to (``l2_atol``: the float32
rounding of |q|^2 + |x|^2 at the largest norms) of the float32 plain
version, on normal data and on offset data where the expanded form
cancels most; and one TF32 pass misses the same check on both, so the
check tells the two apart."""

import numpy as np
import pytest
import torch

from helpers.tf32 import dots_tf32, dots_tf32x3, knn_from_dots, split_tf32, tf32_round
from helpers.torch_parity import assert_knn_close
from raft_tpu_torch.ops.knn_tile import knn_tile_plain

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
