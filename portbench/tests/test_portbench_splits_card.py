"""On the card: K1's answers under the index splits that its grid rule
picks are bit for bit those of one split, and K6's under its runs of
tiles those of one run a query tile and of the one-wave rule it had
before, at the brute-force cells' shape (10,000 queries against 1M x 128,
float32 "highest").  Run on a machine with a card:
``python -m pytest portbench/tests/test_portbench_splits_card.py -m card``."""

import pytest
import torch

N, NQ, D = 1_000_000, 10_000, 128


@pytest.fixture(scope="module")
def data():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card on this machine")
    g = torch.Generator(device="cuda").manual_seed(21)
    x = torch.randn((N, D), device="cuda", generator=g)
    q = torch.randn((NQ, D), device="cuda", generator=g)
    return x, q


@pytest.mark.card
@pytest.mark.parametrize("k", [100, 10])
def test_k1_splits_answer_as_one_split(card, data, k):
    from raft_tpu_torch.core import tracing
    from raft_tpu_torch.ops import knn_tile
    x, q = data
    xp, qp, qn, xn = knn_tile.prepare_operands(x, q)
    sms = torch.cuda.get_device_properties(card).multi_processor_count
    rows = knn_tile.split_rows(NQ, N, sms, knn_tile.block_q(D), k)
    assert N // rows > 1, "the rule gave one split: nothing to compare"
    blocks0, slots0 = (tracing.get_counter(c) for c in knn_tile.WAVE_COUNTERS)
    got_d, got_i = knn_tile.fused_knn_tile(x, q, k)
    blocks, slots = (tracing.get_counter(c) - c0
                     for c, c0 in zip(knn_tile.WAVE_COUNTERS, (blocks0, slots0)))
    one = -(-N // knn_tile.BLOCK_N) * knn_tile.BLOCK_N
    want_d, want_i = knn_tile.split_partials(xp, qp, qn, xn, k, one)
    torch.cuda.synchronize()
    assert want_d.shape == (NQ, k)
    assert torch.equal(got_d, want_d) and torch.equal(got_i, want_i)
    assert blocks == -(-NQ // knn_tile.block_q(D)) * -(-N // rows)
    assert slots == -(-blocks // sms) * sms and blocks / slots >= 0.95


def _twophase(x, q, bn, per):
    # K6's C entry at `per` tiles a block
    from raft_tpu_torch.ops import _build, knn_tile
    xp, qp, qn, xn = knn_tile.prepare_operands(x, q)
    width = -(-N // bn) * knn_tile.TWOPHASE_PAD
    out_d = torch.empty((NQ, width), dtype=torch.float32, device=x.device)
    out_i = torch.empty((NQ, width), dtype=torch.int32, device=x.device)
    code = knn_tile._twophase_entry()(
        qp.data_ptr(), xp.data_ptr(), qn.data_ptr(), xn.data_ptr(), NQ, N, D, bn, per, 0,
        out_d.data_ptr(), out_i.data_ptr(), torch.cuda.current_stream().cuda_stream)
    _build.check(code, "knn_twophase_launch")
    return out_d, out_i


@pytest.mark.card
def test_k6_runs_answer_as_one_run(card, data):
    from raft_tpu_torch.core import tuning
    from raft_tpu_torch.ops import knn_tile
    x, q = data
    block_n = int(tuning.resolve("knn_block_n", None, site="fused_knn_twophase",
                                 dtype=x.dtype, n=N, k=100, d=D))
    bn, n_tiles = knn_tile.twophase_geometry(N, block_n)
    got_d, got_i = knn_tile.twophase_tiles(x, q, bn)
    sms = torch.cuda.get_device_properties(card).multi_processor_count
    q_tiles = -(-NQ // knn_tile.block_q(D))
    per_now, _ = knn_tile.index_blocks(q_tiles, n_tiles, sms, knn_tile.TWOPHASE_PAD,
                                      bn // knn_tile.BLOCK_N)
    assert per_now < n_tiles, "the rule gave one run: nothing to compare"
    # one run a query tile, and the runs of the one-wave rule
    old = -(-n_tiles // min(n_tiles, max(1, knn_tile.BLOCKS_PER_SM * sms // q_tiles)))
    for per in sorted({n_tiles, old}):
        want_d, want_i = _twophase(x, q, bn, per)
        torch.cuda.synchronize()
        assert torch.equal(got_d, want_d) and torch.equal(got_i, want_i), per
