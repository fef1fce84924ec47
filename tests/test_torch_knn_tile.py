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


def _rule(nq, n, n_q=knn_tile.BLOCK_Q, sms=132, k=100):
    """The split rule's contract at one shape; returns (splits, the share
    of the waves' block slots the grid fills)."""
    rows = split_rows(nq, n, sms, n_q, k)
    splits = -(-n // rows)
    # whole BLOCK_N tiles, covering the index, no split left empty
    assert rows % knn_tile.BLOCK_N == 0 and (splits - 1) * rows < n <= splits * rows
    q_tiles, units = -(-nq // n_q), -(-n // knn_tile.BLOCK_N)
    slots = knn_tile.BLOCKS_PER_SM * sms
    assert splits <= max(knn_tile.MAX_SPLITS, slots // q_tiles)
    # no worse, as predicted, than one split
    merge = nq * k * knn_tile.MERGE_COLUMN_S
    predicted = knn_tile.grid_time(q_tiles, units, splits, slots, k, merge_s=merge)
    assert predicted[1:] == (-(-units // splits), splits)
    assert predicted[0] <= knn_tile.grid_time(q_tiles, units, 1, slots, k, merge_s=merge)[0]
    blocks = q_tiles * splits
    return splits, blocks / (-(-blocks // slots) * slots)


def _spare(nq, n, n_q, sms, k=100):
    # the index has tiles to spare: at the most splits the rule tries,
    # each split still holds four times a block's fixed cost in tiles
    cap = max(knn_tile.MAX_SPLITS, knn_tile.BLOCKS_PER_SM * sms // -(-nq // n_q))
    return -(-n // knn_tile.BLOCK_N) >= 4 * cap * knn_tile.block_seconds(k) / knn_tile.TILE_S


@pytest.mark.parametrize("nq,n", [(1024, 1_000_000), (5, 1000), (64, 128), (10_000, 10**6)])
def test_split_rows_cover_the_index(nq, n):
    splits, fill = _rule(nq, n)
    if nq == 1024:
        assert splits == 8                      # 16 query tiles x 8: one wave
    elif nq == 10_000:
        assert splits > 1 and fill >= 0.95      # whole waves, where one split filled 59.5%
    else:                                       # one query tile over every tile there is
        assert splits == -(-n // knn_tile.BLOCK_N)


@pytest.mark.parametrize("k", [100, 10])
@pytest.mark.parametrize("sms", [132, 114])
@pytest.mark.parametrize("n_q", [64, 32, 16])
@pytest.mark.parametrize("n", [128, 5000, 250_000, 1_000_000])
@pytest.mark.parametrize("nq", [1, 5, 64, 1024, 5000, 8448, 10_000, 20_000])
def test_split_rule(nq, n, n_q, sms, k):
    _, fill = _rule(nq, n, n_q, sms, k)
    if _spare(nq, n, n_q, sms, k):
        assert fill >= 0.9


@pytest.mark.parametrize("k,want", [(10, 5), (100, 4)])
def test_split_count_follows_k(k, want):
    # a 250,000-row shard of the sharded search at 10,000 queries: a
    # block's fixed cost grows with k, so k 10 takes 5 splits (9.63 ms on
    # the card against 10.02 at 4) and k 100 takes 4 (12.05 against 12.12)
    splits, _ = _rule(10_000, 250_000, k=k)
    assert splits == want


@pytest.mark.parametrize("sms", [132, 114])
@pytest.mark.parametrize("nq", [1, 8, 64])
def test_one_query_tile_spreads_the_index_over_the_card(nq, sms):
    # the services' batches: one block on every SM
    splits, fill = _rule(nq, 1_000_000, sms=sms)
    assert splits == sms and fill == 1.0


def test_counters_count_a_launch_blocks_and_wave_slots(monkeypatch):
    # K1 at 10,000 x 1M on 132 SMs, the launch mocked: the counters advance
    # by the grid's blocks and the slots of the waves they take
    import contextlib
    import types

    from raft_tpu_torch.core import inventory, tracing
    from raft_tpu_torch.ops import _build
    launched = []
    monkeypatch.setattr(_build, "entry", lambda *a, **kw: lambda *args: launched.append(args) or 0)
    monkeypatch.setattr(inventory, "_entries", {})
    monkeypatch.setattr(knn_tile, "block_q", lambda d: 64)
    monkeypatch.setattr(knn_tile, "_sms", lambda dev: 132)
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda: types.SimpleNamespace(cuda_stream=0))
    x = torch.zeros(1, 128).expand(1_000_000, 128)     # shapes only: no launch reads them
    q = torch.zeros(1, 128).expand(10_000, 128)
    rows = split_rows(10_000, 1_000_000, 132, 64, 100)
    before = [tracing.get_counter(c) for c in knn_tile.WAVE_COUNTERS]
    part_d, _ = knn_tile.split_partials(x, q, q[:, 0], x[:, 0], 100, rows)
    after = [tracing.get_counter(c) for c in knn_tile.WAVE_COUNTERS]
    splits = -(-1_000_000 // rows)
    assert part_d.shape == (10_000, splits * 100) and launched[0][8] == rows
    blocks = 157 * splits
    assert [a - b for a, b in zip(after, before)] == [blocks, -(-blocks // 132) * 132]
    knn_tile.count_waves(knn_tile.TWOPHASE_WAVE_COUNTERS, 200, 132)
    assert [tracing.get_counter(c) for c in knn_tile.WAVE_COUNTERS] == after


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
    # the wrapper sizes K1's splits and K6's runs of tiles, from the tile
    # rows and the blocks an SM of the kernel (csrc/knn_tile.cuh); K6's
    # launcher takes its runs from the wrapper and keeps no rule of its
    # own; the query tile comes from the kernel itself
    csrc = Path(knn_tile.__file__).parent / "csrc"

    def const(name, src):
        return int(re.search(r"constexpr int %s = (\d+);" % name,
                             (csrc / src).read_text()).group(1))

    assert const("kBN", "knn_tile.cuh") == knn_tile.BLOCK_N
    bounds = re.search(r"__launch_bounds__\(kThreads, (\d+)\)\s*knn_tile_kernel",
                       (csrc / "knn_tile.cuh").read_text())
    assert int(bounds.group(1)) == knn_tile.BLOCKS_PER_SM
    twophase = (csrc / "knn_twophase.cu").read_text()
    assert "int per_block," in twophase
    assert not re.search(r"^[^/]*\bindex_blocks\(", twophase, re.M)


@pytest.mark.parametrize("nq,n,n_q", [(1024, 1_000_000, 32), (7, 5000, 16)])
def test_split_rows_at_other_depths(nq, n, n_q):
    # the query tiles of 32 (depths 136 to 512, and past 1216 in slabs)
    # and 16 (depths 520 to 1216)
    splits, fill = _rule(nq, n, n_q)
    if nq == 1024:
        assert splits == 4 and fill >= 0.95     # 32 query tiles x 4: one wave
    else:
        assert splits == -(-n // knn_tile.BLOCK_N)


def test_kernel_route_takes_any_depth():
    # the kernels stream the queries' depth in slabs: no depth limit on
    # the kernel route, which at 4096 gives the scan's result
    from raft_tpu_torch.spatial.fused_l2_knn import fused_l2_knn
    x, q = _data(40, 3, 4096, seed=4)
    got_d, got_i = fused_l2_knn(x, q, 3, impl="kernel", device="cpu")
    ref_d, ref_i = fused_l2_knn(x, q, 3, impl="scan", device="cpu")
    assert_knn_close(ref_d.numpy(), ref_i.numpy(), got_d.numpy(), got_i.numpy(), RTOL, 1e-3)
