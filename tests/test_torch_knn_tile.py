"""Port parity: K1's plain version (``knn_tile_plain``) vs the JAX
package's ``fused_knn_xla``, the production twin of the Pallas kernel
whose distances equal the kernel's bitwise; and one small case against
the Pallas kernel itself in interpret mode."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers.torch_parity import assert_knn_close
from raft_tpu.ops.knn_tile import fused_knn_tile as jax_fused_knn_tile
from raft_tpu.ops.knn_tile import fused_knn_xla
from raft_tpu_torch import LogicError
from raft_tpu_torch.ops import knn_tile
from raft_tpu_torch.ops.knn_tile import fused_knn_tile, knn_tile_plain, split_rows

# Expanded-form squared L2 (qn + xn - 2 q.x) differs between two float32
# products by a few ulps of the norms (|q|^2 + |x|^2 <= ~150 here), so
# distances agree to 1e-4 absolute; ids agree as sets up to ties.
RTOL, ATOL = 1e-5, 1e-4

# (n, nq, d, k): k = 1, k = 100 (not a power of two), k at the cap of
# 128, and n, nq, d off every tile multiple
CASES = [(300, 17, 32, 1), (517, 33, 24, 100), (400, 9, 64, 128), (1000, 5, 3, 10)]


def _data(n, nq, d, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, d)).astype(np.float32),
            rng.standard_normal((nq, d)).astype(np.float32))


@pytest.mark.parametrize("case", CASES, ids=lambda c: "n%d-q%d-d%d-k%d" % c)
def test_plain_matches_fused_knn_xla(case):
    n, nq, d, k = case
    x, q = _data(n, nq, d)
    ref_d, ref_i = fused_knn_xla(jnp.asarray(x, jnp.float32), jnp.asarray(q, jnp.float32), k)
    got_d, got_i = knn_tile_plain(torch.from_numpy(x), torch.from_numpy(q), k)
    assert_knn_close(ref_d, ref_i, got_d.numpy(), got_i.numpy(), RTOL, ATOL)


def test_plain_spans_several_tiles(monkeypatch):
    # force the running top-k across many tiles of the plain version
    monkeypatch.setattr(knn_tile, "_PLAIN_TILE", 64)
    x, q = _data(700, 11, 16, seed=1)
    ref_d, ref_i = fused_knn_xla(jnp.asarray(x, jnp.float32), jnp.asarray(q, jnp.float32), 100)
    got_d, got_i = knn_tile_plain(torch.from_numpy(x), torch.from_numpy(q), 100)
    assert_knn_close(ref_d, ref_i, got_d.numpy(), got_i.numpy(), RTOL, ATOL)


def test_plain_ties_resolve_to_smaller_id():
    x, q = _data(64, 4, 8, seed=2)
    x = np.concatenate([x, x])        # every row twice: ids j and j + 64 tie
    _, got_i = knn_tile_plain(torch.from_numpy(x), torch.from_numpy(q), 6)
    gi = got_i.numpy()
    # each distance appears twice in a row, the smaller id first
    assert (gi[:, 0::2] < 64).all() and (gi[:, 1::2] == gi[:, 0::2] + 64).all()


def test_plain_matches_interpreted_pallas_kernel():
    # the one interpret-mode run of the Pallas kernel (about 15 s of CPU)
    x, q = _data(300, 8, 16, seed=3)
    ref_d, ref_i = jax_fused_knn_tile(jnp.asarray(x, jnp.float32),
                                      jnp.asarray(q, jnp.float32), 5, interpret=True)
    got_d, got_i = fused_knn_tile(torch.from_numpy(x), torch.from_numpy(q), 5)
    assert_knn_close(ref_d, ref_i, got_d.numpy(), got_i.numpy(), RTOL, ATOL)


def test_wrapper_limits():
    x, q = _data(50, 3, 4)
    xt, qt = torch.from_numpy(x), torch.from_numpy(q)
    with pytest.raises(LogicError):
        fused_knn_tile(xt, qt, 129)
    with pytest.raises(LogicError):
        fused_knn_tile(xt, qt, 51)
    with pytest.raises(LogicError):
        fused_knn_tile(xt.double(), qt.double(), 5)


@pytest.mark.parametrize("nq,n", [(1024, 1_000_000), (5, 1000), (64, 128), (10_000, 10**6)])
def test_split_rows_cover_the_index(nq, n):
    rows = split_rows(nq, n, n_sms=132)
    assert rows % knn_tile.BLOCK_N == 0
    splits = -(-n // rows)
    assert (splits - 1) * rows < n <= splits * rows
    q_tiles = -(-nq // knn_tile.BLOCK_Q)
    # the split fills the card unless the index runs out of tiles first
    assert q_tiles * splits >= min(knn_tile.BLOCKS_PER_SM * 132,
                                   q_tiles * -(-n // knn_tile.BLOCK_N)) * 0.5
