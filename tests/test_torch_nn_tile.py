"""Port parity: K4's plain version (``nn_tile_plain``) vs the JAX package's
``fused_l2_nn(impl="xla")`` scan, and one small case against the Pallas
``fused_nn_tile`` in interpret mode (the cases of
``tests/test_distance.py::TestFusedNnTile``)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu.distance.fused_l2_nn import fused_l2_nn as jax_fused_l2_nn
from raft_tpu.ops.nn_tile import fused_nn_tile as jax_fused_nn_tile
from raft_tpu_torch import LogicError
from raft_tpu_torch.ops import nn_tile
from raft_tpu_torch.ops.nn_tile import IDX_SENTINEL, fused_nn_tile, nn_tile_plain

# expanded-form squared L2 in another summation order: a few ulps of the
# norms (|x|^2 + |y|^2 <= ~500 here); ids exact (random data, no ties)
RTOL, ATOL = 1e-5, 1e-4

# (m, n, d): aligned, ragged, wide d, many y tiles
CASES = [(64, 512, 32), (57, 1000, 17), (32, 300, 200), (40, 5000, 8)]


def _data(m, n, d, seed=1234):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((m, d)).astype(np.float32),
            rng.standard_normal((n, d)).astype(np.float32))


def _check(x, y, got_v, got_i):
    ref_v, ref_i = jax_fused_l2_nn(jnp.asarray(x, jnp.float32), jnp.asarray(y, jnp.float32),
                                   impl="xla")
    np.testing.assert_allclose(got_v.numpy(), np.asarray(ref_v), rtol=RTOL, atol=ATOL)
    assert got_i.dtype == torch.int32
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(ref_i))


@pytest.mark.parametrize("case", CASES, ids=lambda c: "m%d-n%d-d%d" % c)
def test_plain_matches_jax_scan(case):
    x, y = _data(*case)
    _check(x, y, *nn_tile_plain(torch.from_numpy(x), torch.from_numpy(y)))


def test_plain_spans_several_tiles(monkeypatch):
    monkeypatch.setattr(nn_tile, "_PLAIN_TILE", 64)
    x, y = _data(33, 700, 12, seed=5)
    _check(x, y, *nn_tile_plain(torch.from_numpy(x), torch.from_numpy(y)))


def test_plain_matches_interpreted_pallas_kernel():
    # the one interpret-mode run of the Pallas kernel
    x, y = _data(57, 1000, 17, seed=3)
    ref_v, ref_i = jax_fused_nn_tile(jnp.asarray(x, jnp.float32), jnp.asarray(y, jnp.float32),
                                     block_n=256, interpret=True)
    got_v, got_i = fused_nn_tile(torch.from_numpy(x), torch.from_numpy(y))
    np.testing.assert_allclose(got_v.numpy(), np.asarray(ref_v), rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(ref_i))


def test_tie_breaks_to_smaller_index(monkeypatch):
    # duplicate rows of y, also across tiles of the plain version
    monkeypatch.setattr(nn_tile, "_PLAIN_TILE", 2)
    y = torch.tensor([[1.0, 0.0], [3.0, 0.0], [1.0, 0.0], [5.0, 1.0]])
    v, i = fused_nn_tile(y[:1], y)
    assert float(v[0]) == 0.0 and int(i[0]) == 0
    v, i = fused_nn_tile(torch.tensor([[2.0, 0.0]]), y)
    assert float(v[0]) == 1.0 and int(i[0]) == 0


def test_no_finite_distance_keeps_the_sentinel():
    x = torch.tensor([[float("nan"), 0.0]])
    v, i = fused_nn_tile(x, torch.zeros((3, 2)))
    assert torch.isinf(v).all() and int(i[0]) == IDX_SENTINEL == 2**31 - 1


def test_wrapper_limits():
    x, y = (torch.from_numpy(a) for a in _data(5, 7, 3))
    with pytest.raises(LogicError, match="empty index"):
        fused_nn_tile(x, y[:0])
    with pytest.raises(LogicError, match="float32"):
        fused_nn_tile(x.double(), y.double())
    with pytest.raises(LogicError, match="shape"):
        fused_nn_tile(x, y[:, :2])
