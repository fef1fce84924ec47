"""Port parity of K6, the two-phase fused kNN: the port's
``fused_knn_twophase`` on CPU tensors (its plain version) against the JAX
package's ``fused_knn_twophase`` run in interpret mode, and the contract
around it (the k limit, ties, the intermediate's width, the merge and
the precision it takes)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers.tf32 import bf16_round
from helpers.torch_parity import assert_knn_close
from raft_tpu.ops.knn_tile import fused_knn_twophase as jax_twophase
from raft_tpu.ops.knn_tile import tile_geometry
from raft_tpu_torch import LogicError
from raft_tpu_torch.spatial.select_k import select_k
from raft_tpu_torch.ops.knn_tile import (BLOCK_N, BLOCK_N_LADDER, TWOPHASE_PAD, fused_knn_twophase,
                                         index_blocks, knn_tile_plain, knn_twophase_plain,
                                         twophase_geometry, twophase_tiles)

# the tolerance of the JAX package's own test of this kernel
# (tests/test_spatial.py test_fused_knn_twophase_exact): expanded-form
# squared L2 from two float32 products differs by a few ulps of the norms
RTOL, ATOL = 1e-4, 1e-4


def _data(n, nq, d, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, d)).astype(np.float32),
            rng.standard_normal((nq, d)).astype(np.float32))


# (n, nq, d, k, block_n): one sub-tile index, several tiles at the
# north-star k, and an explicit block_n
@pytest.mark.parametrize("case", [(300, 17, 13, 5, None), (3000, 33, 128, 100, None),
                                  (2500, 24, 64, 10, 1024)],
                         ids=lambda c: "n%d-q%d-d%d-k%d-bn%s" % c)
def test_matches_jax_interpret(case):
    n, nq, d, k, block_n = case
    x, q = _data(n, nq, d)
    ref_d, ref_i = jax_twophase(jnp.asarray(x), jnp.asarray(q), k, block_n=block_n,
                                interpret=True)
    kw = {} if block_n is None else {"block_n": block_n}
    got_d, got_i = fused_knn_twophase(torch.from_numpy(x), torch.from_numpy(q), k, **kw)
    assert_knn_close(np.asarray(ref_d), np.asarray(ref_i), got_d.numpy(), got_i.numpy(),
                     RTOL, ATOL)


@pytest.mark.parametrize("block_n", BLOCK_N_LADDER)
def test_intermediate_has_the_jax_width(block_n):
    n, nq, d = 5000, 3, 8
    x, q = _data(n, nq, d, seed=1)
    _, bn_ref, _, _, _, np_ref = tile_geometry(nq, n, d, 256, block_n, unit=128)
    bn, n_tiles = twophase_geometry(n, block_n)
    assert (bn, n_tiles) == (bn_ref, np_ref // bn_ref)
    part_d, part_i = twophase_tiles(torch.from_numpy(x), torch.from_numpy(q), bn)
    assert part_d.shape == part_i.shape == (nq, n_tiles * TWOPHASE_PAD)
    # every tile's 128 are its own ids, ascending by distance
    tiles_i = part_i.view(nq, n_tiles, TWOPHASE_PAD)
    live = tiles_i >= 0
    tile_of = torch.where(live, tiles_i // bn, torch.arange(n_tiles)[None, :, None])
    assert torch.equal(tile_of, torch.arange(n_tiles)[None, :, None].expand_as(tile_of))
    tiles_d = part_d.view(nq, n_tiles, TWOPHASE_PAD)
    assert (tiles_d[..., 1:] >= tiles_d[..., :-1]).all()


def test_short_tile_pads_with_minus_one():
    # a tile with fewer than 128 rows fills its other slots with (+inf, -1)
    x, q = _data(100, 4, 8, seed=2)
    part_d, part_i = twophase_tiles(torch.from_numpy(x), torch.from_numpy(q), 256)
    assert part_d.shape == (4, 128)
    assert (part_i[:, 100:] == -1).all() and torch.isinf(part_d[:, 100:]).all()
    assert torch.equal(torch.sort(part_i[:, :100], dim=1).values,
                       torch.arange(100, dtype=torch.int32).expand(4, 100))


def test_matches_k1_plain():
    x, q = _data(2000, 9, 16, seed=3)
    xt, qt = torch.from_numpy(x), torch.from_numpy(q)
    got_d, got_i = fused_knn_twophase(xt, qt, 64, block_n=256)
    ref_d, ref_i = knn_tile_plain(xt, qt, 64)
    assert_knn_close(ref_d.numpy(), ref_i.numpy(), got_d.numpy(), got_i.numpy(), RTOL, ATOL)
    plain_d, plain_i = knn_twophase_plain(xt, qt, 64, block_n=256)
    assert torch.equal(got_d, plain_d) and torch.equal(got_i, plain_i)


def test_ties_resolve_to_smaller_id():
    x, q = _data(700, 4, 8, seed=4)
    x = np.concatenate([x, x])        # every row twice: ids j and j + 700 tie
    _, got_i = fused_knn_twophase(torch.from_numpy(x), torch.from_numpy(q), 10, block_n=256)
    gi = got_i.numpy()
    assert (gi[:, 0::2] < 700).all() and (gi[:, 1::2] == gi[:, 0::2] + 700).all()


@pytest.mark.parametrize("bad", [
    {"k": 129}, {"k": 0}, {"block_n": 768}, {"precision": "high"},
    {"merge_select_impl": "chunked"}, {"merge_select_impl": "pallas"},
    {"merge_select_impl": "bogus"}])
def test_rejects(bad):
    x, q = _data(300, 3, 8, seed=5)
    args = {"k": 5, **bad}
    with pytest.raises(LogicError):
        fused_knn_twophase(torch.from_numpy(x), torch.from_numpy(q), **args)


@pytest.mark.parametrize("ported", [{"precision": "default"}, {"merge_select_impl": "approx95"}],
                         ids=["precision-default", "merge-approx95"])
def test_accepts_what_was_refused(ported):
    # precision="default" (the bfloat16 single pass) runs: the same as the
    # JAX function on inputs that are bfloat16 values, where the single
    # pass is exact.  The approximate merge runs the approximate select
    # over phase 1's candidates: each tile's sorted run of 128 lands its
    # j-th best in bin j (mod 256 here), so runs collide and recall is
    # the data's; it is held to that select, and each distance to the
    # JAX distance of its id
    x, q = _data(700, 6, 16, seed=6)
    x, q = bf16_round(x), bf16_round(q)
    xt, qt = torch.from_numpy(x), torch.from_numpy(q)
    got_d, got_i = fused_knn_twophase(xt, qt, 5, block_n=256, **ported)
    if "precision" in ported:
        ref_d, ref_i = jax_twophase(jnp.asarray(x), jnp.asarray(q), 5, block_n=256,
                                    interpret=True)
        assert_knn_close(np.asarray(ref_d), np.asarray(ref_i), got_d.numpy(), got_i.numpy(),
                         RTOL, ATOL)
        return
    part_d, part_i = twophase_tiles(xt, qt, 256)
    want_d, want_i = select_k(part_d, 5, values=part_i, impl="approx95", device="cpu")
    assert torch.equal(got_d, want_d) and torch.equal(got_i, want_i)
    exact = ((q[:, None, :].astype(np.float64) - x[got_i.numpy()]) ** 2).sum(-1)
    np.testing.assert_allclose(got_d.numpy(), exact, rtol=RTOL, atol=ATOL)


def test_unported_merge_is_named():
    x, q = _data(300, 3, 8, seed=5)
    with pytest.raises(LogicError, match="approx.*not ported"):
        fused_knn_twophase(torch.from_numpy(x), torch.from_numpy(q), 5,
                           merge_select_impl="approx")


@pytest.mark.parametrize("block_n", BLOCK_N_LADDER)
def test_block_ranges_cover_the_jax_tiles(block_n):
    # K6's grid along the index (index_blocks over the JAX tiles, as
    # twophase_tiles hands it to csrc/knn_twophase.cu): each block owns a
    # run of whole JAX tiles, the runs cover every tile of
    # twophase_geometry once, and at these few query tiles the grid is
    # one wave of blocks on 132 SMs; query tiles of 64, 32 and 16 (depths
    # 128, 300, 2000)
    for n, nq, n_q in [(1_000_000, 1024, 64), (5000, 5, 64), (300, 64, 32), (70_001, 3, 16)]:
        bn, n_tiles = twophase_geometry(n, block_n)
        q_tiles = -(-nq // n_q)
        per, blocks = index_blocks(q_tiles, n_tiles, 132, TWOPHASE_PAD, bn // BLOCK_N)
        runs = [range(b * per, min((b + 1) * per, n_tiles)) for b in range(blocks)]
        assert all(len(r) > 0 for r in runs)
        assert [t for r in runs for t in r] == list(range(n_tiles))
        assert q_tiles * blocks <= max(132, q_tiles)
        # a block's rows are whole tiles: its range starts on a tile edge
        assert all(r.start * bn < n for r in runs)


@pytest.mark.parametrize("block_n", BLOCK_N_LADDER)
def test_runs_fill_whole_waves_at_ten_thousand_queries(block_n):
    # 157 query tiles at 10,000 queries: the runs of tiles make whole waves
    # on 132 SMs, where one run a query tile filled 59.5% of two
    bn, n_tiles = twophase_geometry(1_000_000, block_n)
    per, blocks = index_blocks(157, n_tiles, 132, TWOPHASE_PAD, bn // BLOCK_N)
    assert blocks == -(-n_tiles // per) and (blocks - 1) * per < n_tiles <= blocks * per
    waves = -(-157 * blocks // 132)
    assert 157 * blocks / (waves * 132) >= 0.9
