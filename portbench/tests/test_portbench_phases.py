"""The six phase-share readers (``metrics/k1.mma_*_pct.py``,
``metrics/k3.mma_*_pct.py``, ``phases.py``) against a fake context: a
synthetic trace and a fake phase table in place of the card's."""

import contextlib
import types

import pytest
import torch

from portbench import harness, phases
from portbench import trace as T

K1 = "void raft_tpu_torch::knn_tile_kernel<64, 4, 0, false>(CUtensorMap, int)"
K3 = "void raft_tpu_torch::knn_tile_kernel<16, 4, 2, false>(CUtensorMap, int)"
READERS = [("%s.mma_%s_pct" % (k, p), mode, p) for k, mode in (("k1", 0), ("k3", 2))
           for p in ("wait_load", "wait_tensor", "wait_select")]


def _entry(kernel, calls, seconds, mma):
    total = sum(mma.values())
    return {"kernel": kernel, "calls": calls, "blocks": 132 * calls, "seconds": seconds,
            "cycles": {"mma": dict(mma, total=total),
                       "select": {"total": 100, "wait_tile": 60, "gate": 10, "merge": 20,
                                  "write": 5, "issue": 5},
                       "producer": {"total": 10, "wait_slot": 9, "issue": 1}}}


MMA = {"wait_load": 100, "wait_tensor": 500, "fill": 0, "wait_select": 50, "epilogue": 50,
       "issue": 300}


def _table():
    return {"knn_tile_kernel<64, 4, 0, false>": _entry("K1", 2, 0.13, MMA),
            "knn_tile_kernel<16, 4, 2, false>": _entry("K3", 4, 0.042, dict(MMA, fill=100))}


def _ctx(kernel_names, calls=(3, 2), measured=True):
    events = [{"ph": "X", "cat": "user_annotation", "name": T.WINDOW, "ts": 0, "dur": 10000}]
    events += [{"ph": "X", "cat": "kernel", "name": name, "ts": 100 + 600 * j, "dur": 60}
               for j, name in enumerate(kernel_names)]
    ctx = types.SimpleNamespace(trace=T.Trace(events), launches={},
                                work={"pool": [torch.zeros(4, 8)] * 2, "calls": list(calls)},
                                k=10, system=None)
    if measured:
        ctx.kernel_phases = {"table": _table(), "first_round_s": 14.5, "second_round_s": 0.5,
                             "calls": 2, "sms": 132}
    return ctx


@pytest.mark.parametrize("name,mode,phase", READERS, ids=[r[0] for r in READERS])
def test_reader_reads_the_multipliers_share(name, mode, phase):
    kernel = K1 if mode == 0 else K3
    got = harness._reader(name)(_ctx([kernel] * 5))
    mma = dict(MMA, fill=100) if mode == 2 else MMA
    total = sum(mma.values())
    assert got["value"] == pytest.approx(100.0 * mma[phase] / total)
    assert 0.0 <= got["value"] <= 100.0
    assert sum(got["shares"]["mma"].values()) == pytest.approx(100.0)
    assert got["shares"]["select"]["wait_tile"] == pytest.approx(60.0)
    # the window ran 5 kernels of 60 us over 5 calls; the timed calls 2
    timed = 0.13 if mode == 0 else 0.042
    assert got["cost_ratio"] == pytest.approx((timed / 2) / 60e-6)
    assert got["timed_build_s"] == pytest.approx(14.0)
    assert got["shares_of"].startswith("the timed instance")   # cost far above 3%


def test_cheap_timing_reads_as_the_kernels_shares():
    ctx = _ctx([K1] * 5)
    ctx.kernel_phases["table"]["knn_tile_kernel<64, 4, 0, false>"]["seconds"] = 2 * 61e-6
    got = harness._reader("k1.mma_wait_select_pct")(ctx)
    assert got["cost_ratio"] == pytest.approx(61 / 60)
    assert got["shares_of"].startswith("the kernel")


@pytest.mark.parametrize("name,mode,phase", READERS, ids=[r[0] for r in READERS])
def test_reader_reads_nothing_where_its_kernel_did_not_run(name, mode, phase):
    other = K3 if mode == 0 else K1
    ctx = _ctx([other, "void something_else()"], measured=False)
    assert harness._reader(name)(ctx) is None
    assert not hasattr(ctx, "kernel_phases"), "nothing timed where nothing is read"


def test_reader_reads_nothing_from_a_program_without_counters(monkeypatch):
    from raft_tpu_torch.core import tracing
    monkeypatch.delattr(tracing, "kernel_phases")
    ctx = _ctx([K1], measured=False)
    assert harness._reader("k1.mma_wait_load_pct")(ctx) is None


def test_reader_fails_where_its_kernel_ran_uncounted():
    ctx = _ctx([K1])
    ctx.kernel_phases["table"] = {k: v for k, v in _table().items() if v["kernel"] != "K1"}
    with pytest.raises(RuntimeError, match="K1 ran in the window"):
        harness._reader("k1.mma_wait_tensor_pct")(ctx)


def test_instances_of_one_kernel_are_summed():
    a = _entry("K1", 1, 0.06, MMA)
    b = _entry("K1", 1, 0.06, dict(MMA, wait_load=300))
    cycles, shares = phases.combine([a, b])
    assert cycles["mma"]["wait_load"] == 400
    assert shares["mma"]["wait_load"] == pytest.approx(100.0 * 400 / (2 * 1000 + 200))


def test_measurement_counts_the_second_round_only(monkeypatch):
    from raft_tpu_torch.core import tracing
    rounds = []

    @contextlib.contextmanager
    def fake_phases():
        table = {}
        rounds.append(table)
        yield table
        table["round"] = len(rounds)

    monkeypatch.setattr(tracing, "kernel_phases", fake_phases)
    monkeypatch.setattr(phases, "_sms", lambda t: 132)
    called = []
    ctx = _ctx([K1], measured=False)
    ctx.system = types.SimpleNamespace(call=lambda q, k: called.append((len(rounds), k)))
    got = phases.measured(ctx)
    assert called == [(1, 10), (1, 10), (2, 10), (2, 10)]
    assert got["table"] == {"round": 2} and got["calls"] == 2
    assert phases.measured(ctx) is got, "one measurement a run"
