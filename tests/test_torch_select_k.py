"""Port parity: raft_tpu_torch select_k / K2 vs the JAX package's
``select_k(impl="topk")``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu.spatial.select_k import chunked_top_k as jax_chunked_top_k
from raft_tpu.spatial.select_k import select_k as jax_select_k
from raft_tpu_torch.ops.select_tile import select_tile, select_tile_plain
from raft_tpu_torch.spatial.select_k import chunked_top_k, select_k, top_k_rows

# (rows, width, k): k = 1, k = 100, k at the kernel's cap, and widths that
# are not a multiple of any tile
CASES = [(7, 50, 1), (9, 333, 100), (5, 129, 128), (12, 1000, 37)]


def _keys(m, w, seed=0):
    # distinct keys: selection is then exactly determined, ids included
    rng = np.random.default_rng(seed)
    return rng.permutation(m * w).reshape(m, w).astype(np.float32) / (m * w)


@pytest.mark.parametrize("select_min", [True, False], ids=["min", "max"])
@pytest.mark.parametrize("case", CASES, ids=lambda c: "%dx%d-k%d" % c)
def test_select_k_matches_jax(case, select_min):
    m, w, k = case
    keys = _keys(m, w)
    ref_v, ref_i = jax_select_k(jnp.asarray(keys, jnp.float32), k,
                                select_min=select_min, impl="topk")
    got_v, got_i = select_k(keys, k, select_min=select_min, device="cpu")
    assert got_i.dtype == torch.int32
    # selection moves values without arithmetic: exact
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(ref_v))
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(ref_i))


@pytest.mark.parametrize("select_min", [True, False], ids=["min", "max"])
def test_select_k_payload_matches_jax(select_min):
    m, w, k = 6, 211, 100
    keys = _keys(m, w, seed=1)
    payload = np.random.default_rng(2).integers(0, 10**6, (m, w)).astype(np.int32)
    ref_v, ref_p = jax_select_k(jnp.asarray(keys, jnp.float32), k, select_min=select_min,
                                values=jnp.asarray(payload), impl="topk")
    got_v, got_p = select_k(keys, k, select_min=select_min, values=payload, device="cpu")
    assert got_p.dtype == torch.int32
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(ref_v))
    np.testing.assert_array_equal(got_p.numpy(), np.asarray(ref_p))


@pytest.mark.parametrize("case", CASES, ids=lambda c: "%dx%d-k%d" % c)
def test_select_tile_plain_matches_jax_topk(case):
    m, w, k = case
    keys = _keys(m, w, seed=3)
    ref_v, ref_i = jax_select_k(jnp.asarray(keys, jnp.float32), k, impl="topk")
    got_v, got_i = select_tile_plain(torch.from_numpy(keys), k)
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(ref_v))
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(ref_i))


def test_deficit_rows():
    # rows with fewer than k finite keys: +inf fills the rest, every id
    # stays in range and no id repeats
    m, w, k = 4, 150, 100
    keys = _keys(m, w, seed=4)
    keys[0, 10:] = np.inf
    keys[1, :] = np.inf
    ref_v, ref_i = jax_select_k(jnp.asarray(keys, jnp.float32), k, impl="topk")
    got_v, got_i = select_tile(torch.from_numpy(keys), k)
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(ref_v))
    finite = np.isfinite(np.asarray(ref_v))
    np.testing.assert_array_equal(got_i.numpy()[finite], np.asarray(ref_i)[finite])
    gi = got_i.numpy()
    assert gi.min() >= 0 and gi.max() <= w - 1
    for row in gi:
        assert len(np.unique(row)) == k


def test_ties_resolve_to_smaller_column():
    keys = np.array([[3.0, 1.0, 2.0, 1.0, 1.0, 0.5]], np.float32)
    v, i = select_k(keys, 3, device="cpu")
    assert i.tolist() == [[5, 1, 3]]
    v, i = select_k(-keys, 3, select_min=False, device="cpu")
    assert i.tolist() == [[5, 1, 3]]


def test_integer_keys_and_wide_k_take_the_sort():
    rng = np.random.default_rng(5)
    keys = rng.permutation(4 * 300).reshape(4, 300).astype(np.int64)
    ref_v, ref_i = jax_select_k(jnp.asarray(keys), 200, select_min=False, impl="topk")
    got_v, got_i = select_k(keys, 200, select_min=False, device="cpu")
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(ref_v))
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(ref_i))


@pytest.mark.parametrize("w", [700, 1000])
def test_chunked_top_k_matches_jax(w):
    keys = _keys(5, w, seed=6)
    ref_v, ref_i = jax_chunked_top_k(jnp.asarray(keys, jnp.float32), 40, chunk=128)
    got_v, got_i = chunked_top_k(torch.from_numpy(keys), 40, chunk=128)
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(ref_v))
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(ref_i))


def test_top_k_rows_is_largest():
    keys = _keys(3, 90, seed=7)
    v, i = top_k_rows(torch.from_numpy(keys), 5)
    want = np.sort(keys, axis=1)[:, ::-1][:, :5]
    np.testing.assert_array_equal(v.numpy(), want)
    assert i.dtype == torch.int32
