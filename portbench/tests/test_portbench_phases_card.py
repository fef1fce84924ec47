"""On the card: the phase-timed instances of the fused tile kernel answer
bit for bit as the default instances, and their counters reduce to shares
in [0, 100].  Run on a machine with a card:
``python -m pytest portbench/tests/test_portbench_phases_card.py -m card``."""

import pytest
import torch


def _data(card, seed, n=20000, nq=300, d=128):
    g = torch.Generator(device=card).manual_seed(seed)
    x = torch.randn((n, d), device=card, generator=g)
    q = torch.randn((nq, d), device=card, generator=g)
    return x, q


def _ivf(card, seed, k, accum_bf16):
    from raft_tpu_torch.ops.ivf_tile import fused_ivf_scan
    g = torch.Generator(device=card).manual_seed(seed)
    S, cap, d, nq, steps = 64, 300, 128, 200, 12
    sv = torch.randn((S, cap, d), device=card, generator=g)
    sn = (sv * sv).sum(-1)
    si = torch.arange(S * cap, dtype=torch.int32, device=card).view(S, cap)
    si[:, cap - 20:] = -1                          # vacant rows
    q = torch.randn((nq, d), device=card, generator=g)
    slots = torch.argsort(torch.rand((nq, S), device=card, generator=g), dim=1)[:, :steps]
    slots = slots.to(torch.int32)
    slots[0, 4:] = -1                              # a short scan list
    return lambda: fused_ivf_scan(q, sv, sn, si, slots, k, accum_bf16=accum_bf16)


def _calls(card):
    from raft_tpu_torch.ops.knn_tile import fused_knn_tile, twophase_tiles
    from raft_tpu_torch.ops.nn_tile import fused_nn_tile
    x, q = _data(card, 11)
    return {
        "K1-k100": ("K1", lambda: fused_knn_tile(x, q, 100)),
        "K1-k10-default": ("K1", lambda: fused_knn_tile(x, q, 10, precision="default")),
        "K1-deep": ("K1", lambda: fused_knn_tile(*_data(card, 12, 3000, 40, 1504), 50)),
        "K3-k100": ("K3", _ivf(card, 13, 100, False)),
        "K3-k10-bf16": ("K3", _ivf(card, 14, 10, True)),
        "K4": ("K4", lambda: fused_nn_tile(q, x[:1024])),
        "K6": ("K6", lambda: twophase_tiles(x, q, 2048)),
    }


CASES = ["K1-k100", "K1-k10-default", "K1-deep", "K3-k100", "K3-k10-bf16", "K4", "K6"]


@pytest.mark.card
@pytest.mark.parametrize("case", CASES)
def test_timed_instance_answers_bitwise(card, case):
    from raft_tpu_torch.core import tracing
    kernel, call = _calls(card)[case]
    want = call()
    with tracing.kernel_phases() as table:
        got = call()
    for a, b in zip(want, got):
        assert torch.equal(a, b), case
    assert {e["kernel"] for e in table.values()} == {kernel}
    for name, e in table.items():
        assert e["calls"] >= 1 and e["blocks"] >= 1 and e["seconds"] > 0.0, name
        for role, shares in e["shares"].items():
            assert e["cycles"][role]["total"] > 0, (name, role)
            assert e["cycles"][role]["issue"] >= 0, (name, role)
            assert all(0.0 <= v <= 100.0 for v in shares.values()), (name, role, shares)
            assert sum(shares.values()) == pytest.approx(100.0)
