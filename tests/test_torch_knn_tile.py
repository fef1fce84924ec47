"""Port parity: K1's plain version (``knn_tile_plain``) vs the JAX
package's ``fused_knn_xla``, the production twin of the Pallas kernel
whose distances equal the kernel's bitwise; and one small case against
the Pallas kernel itself in interpret mode."""

import re
from pathlib import Path

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


def _misaligned(n, d, seed):
    # a contiguous view 4 bytes past an aligned start: the kernels' TMA
    # copies need 16-byte aligned rows
    flat = torch.from_numpy(np.random.default_rng(seed).standard_normal(n * d + 1)
                            .astype(np.float32))
    return flat[1:].view(n, d)


# (name, index, queries): depths off the multiple of 8, a misaligned
# tensor, a strided view, and the main path's depth, which is not copied
def _tensors(n, nq, d):
    x, q = _data(n, nq, d)
    return torch.from_numpy(x), torch.from_numpy(q)


OPERANDS = {
    "d3": lambda: _tensors(300, 9, 3),
    "d13": lambda: _tensors(200, 5, 13),
    "misaligned": lambda: (_misaligned(257, 16, 1), _misaligned(7, 16, 2)),
    "strided": lambda: tuple(t[:, ::2] for t in _tensors(100, 4, 256)),
    "d128": lambda: _tensors(100, 4, 128),
}


@pytest.mark.parametrize("name", sorted(OPERANDS))
def test_prepare_operands(name):
    x, q = OPERANDS[name]()
    xp, qp, qn, xn = knn_tile.prepare_operands(x, q)
    d = x.shape[1]
    dp = -(-d // knn_tile.DEPTH_UNIT) * knn_tile.DEPTH_UNIT
    for orig, got in ((x, xp), (q, qp)):
        assert got.shape == (orig.shape[0], dp) and got.is_contiguous()
        assert got.data_ptr() % 16 == 0
        assert torch.equal(got[:, :d], orig) and not got[:, d:].any()
    # the norms of the unpadded rows, bitwise
    assert torch.equal(qn, (q.contiguous() * q.contiguous()).sum(dim=1))
    assert torch.equal(xn, (x.contiguous() * x.contiguous()).sum(dim=1))
    if name == "d128":                       # the main path copies nothing
        assert xp.data_ptr() == x.data_ptr() and qp.data_ptr() == q.data_ptr()


@pytest.mark.parametrize("name", sorted(OPERANDS))
def test_prepared_operands_leave_the_plain_result(name):
    x, q = OPERANDS[name]()
    xp, qp, _, _ = knn_tile.prepare_operands(x, q)
    # against the rows as the wrapper holds them, contiguous
    ref_d, ref_i = knn_tile_plain(x.contiguous(), q.contiguous(), 5)
    got_d, got_i = knn_tile_plain(xp, qp, 5)
    if xp.shape[1] == x.shape[1]:
        # an alignment copy holds the same rows: bitwise the same result
        assert torch.equal(got_d, ref_d) and torch.equal(got_i, ref_i)
    else:
        # zero columns change no product, but the CPU matmul blocks a
        # longer depth differently, so the sums may round apart
        assert_knn_close(ref_d.numpy(), ref_i.numpy(), got_d.numpy(), got_i.numpy(), RTOL, ATOL)


def test_grid_constants_match_the_kernel_source():
    # the wrapper sizes K1's splits, and the kernels their grids, from the
    # same tile rows and blocks per SM (csrc/knn_tile.cuh,
    # csrc/knn_twophase.cu); the query tile comes from the kernel itself
    csrc = Path(knn_tile.__file__).parent / "csrc"

    def const(name, src):
        return int(re.search(r"constexpr int %s = (\d+);" % name,
                             (csrc / src).read_text()).group(1))

    assert const("kBN", "knn_tile.cuh") == knn_tile.BLOCK_N
    assert const("kBlocksPerSm", "knn_twophase.cu") == knn_tile.BLOCKS_PER_SM


@pytest.mark.parametrize("nq,n,n_q", [(1024, 1_000_000, 32), (7, 5000, 16)])
def test_split_rows_at_other_depths(nq, n, n_q):
    # the query tiles of 32 (depths 136 to 512, and past 1216 in slabs)
    # and 16 (depths 520 to 1216)
    rows = split_rows(nq, n, 132, n_q)
    splits = -(-n // rows)
    assert rows % knn_tile.BLOCK_N == 0 and (splits - 1) * rows < n <= splits * rows
    assert -(-nq // n_q) * splits <= max(132, -(-nq // n_q))   # one wave


def test_kernel_route_takes_any_depth():
    # the kernels stream the queries' depth in slabs: no depth limit on
    # the kernel route, which at 4096 gives the scan's result
    from raft_tpu_torch.spatial.fused_l2_knn import fused_l2_knn
    x, q = _data(40, 3, 4096, seed=4)
    got_d, got_i = fused_l2_knn(x, q, 3, impl="kernel", device="cpu")
    ref_d, ref_i = fused_l2_knn(x, q, 3, impl="scan", device="cpu")
    assert_knn_close(ref_d.numpy(), ref_i.numpy(), got_d.numpy(), got_i.numpy(), RTOL, 1e-3)
