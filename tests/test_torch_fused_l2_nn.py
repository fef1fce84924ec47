"""Port parity: ``distance/fused_l2_nn.py`` (the scan and its dispatch) vs
the JAX package's, with masks, per-tile masks, a custom reduce op, sqrt
and the sentinel of fully masked rows."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu.distance.fused_l2_nn import IDX_SENTINEL as JAX_SENTINEL
from raft_tpu.distance.fused_l2_nn import fused_l2_nn as jax_nn
from raft_tpu.distance.fused_l2_nn import fused_l2_nn_min_reduce as jax_min_reduce
from raft_tpu_torch import LogicError, fused_l2_nn, fused_l2_nn_min_reduce
from raft_tpu_torch.distance import IDX_SENTINEL

RTOL, ATOL = 1e-5, 1e-4


def _data(m, n, d, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((m, d)).astype(np.float32),
            rng.standard_normal((n, d)).astype(np.float32))


def _j(a):
    return jnp.asarray(a, jnp.float32) if a.dtype == np.float32 else jnp.asarray(a)


def _assert_same(ref, got):
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]), rtol=RTOL, atol=ATOL)
    assert got[1].dtype == torch.int32
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))


def test_sentinel_matches_the_reference():
    assert IDX_SENTINEL == int(JAX_SENTINEL)


@pytest.mark.parametrize("sqrt", [False, True])
@pytest.mark.parametrize("impl", ["scan", "kernel", None])
def test_matches_jax(sqrt, impl):
    x, y = _data(45, 1300, 10, seed=0)
    ref = jax_nn(_j(x), _j(y), sqrt=sqrt, tile_n=256, impl="xla")
    _assert_same(ref, fused_l2_nn(x, y, sqrt=sqrt, tile_n=256, impl=impl, device="cpu"))


def test_mask_and_fully_masked_rows():
    x, y = _data(30, 200, 6, seed=1)
    mask = np.random.default_rng(2).random((30, 200)) < 0.3
    mask[4] = False                                  # no admissible pair
    ref = jax_nn(_j(x), _j(y), mask=jnp.asarray(mask), tile_n=64, impl="xla")
    got = fused_l2_nn(x, y, mask=mask, tile_n=64, device="cpu")
    _assert_same(ref, got)
    assert np.isinf(got[0][4].item()) and int(got[1][4]) == IDX_SENTINEL


def test_tile_mask_fn():
    x, y = _data(20, 300, 5, seed=3)
    colors_x = np.arange(20) % 3
    colors_y = np.arange(300) % 3

    def jax_fn(j0, tile_n):
        cols = j0 + jnp.arange(tile_n)
        return jnp.asarray(colors_x)[:, None] != jnp.asarray(colors_y)[cols % 300][None, :]

    def port_fn(j0, tile_n):
        cols = j0 + torch.arange(tile_n)
        cx, cy = torch.from_numpy(colors_x), torch.from_numpy(colors_y)
        return cx[:, None] != cy[cols % 300][None, :]

    ref = jax_min_reduce(_j(x), _j(y), tile_n=128, tile_mask_fn=jax_fn)
    _assert_same(ref, fused_l2_nn_min_reduce(x, y, tile_n=128, tile_mask_fn=port_fn,
                                             device="cpu"))


def test_custom_reduce_op_and_init():
    # keep the largest index among the per-tile minima below a cut
    x, y = _data(15, 400, 4, seed=4)

    def jax_op(best, cand):
        take = (cand[0] < 3.0) & (cand[1] > best[1])
        return jnp.where(take, cand[0], best[0]), jnp.where(take, cand[1], best[1])

    def port_op(best, cand):
        take = (cand[0] < 3.0) & (cand[1] > best[1])
        return torch.where(take, cand[0], best[0]), torch.where(take, cand[1], best[1])

    init = (np.full(15, 100.0, np.float32), np.full(15, -1, np.int32))
    ref = jax_min_reduce(_j(x), _j(y), reduce_op=jax_op, tile_n=50,
                         init_val=(jnp.asarray(init[0]), jnp.asarray(init[1])))
    got = fused_l2_nn_min_reduce(x, y, reduce_op=port_op, tile_n=50,
                                 init_val=tuple(torch.from_numpy(a) for a in init),
                                 device="cpu")
    _assert_same(ref, got)


def test_float64_and_integer_inputs_take_the_scan():
    x, y = _data(12, 90, 3, seed=5)
    ref = jax_nn(jnp.asarray(x, jnp.float64), jnp.asarray(y, jnp.float64), impl="xla")
    got = fused_l2_nn(x.astype(np.float64), y.astype(np.float64), device="cpu")
    assert got[0].dtype == torch.float64
    _assert_same(ref, got)
    xi, yi = (np.round(a * 3).astype(np.int32) for a in (x, y))
    got = fused_l2_nn(xi, yi, device="cpu")
    assert got[0].dtype == torch.float32
    _assert_same(jax_nn(jnp.asarray(xi), jnp.asarray(yi), impl="xla"), got)


def test_explicit_kernel_outside_its_limits_raises():
    x, y = _data(5, 9, 3, seed=6)
    with pytest.raises(LogicError, match="plain float32"):
        fused_l2_nn(x, y, mask=np.ones((5, 9), bool), impl="kernel", device="cpu")
    with pytest.raises(LogicError, match="plain float32"):
        fused_l2_nn(x.astype(np.float64), y, impl="kernel", device="cpu")
    with pytest.raises(LogicError, match="impl"):
        fused_l2_nn(x, y, impl="pallas", device="cpu")
