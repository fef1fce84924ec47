"""On the card: the ``sift1m_ivfpq.batch10k`` cell in a short traced window
is correct and reads every metric of its own, each control of its
reference is not correct, the cell's readers find nothing to read in
``sift1m_ivfflat.batch10k``, and a 10,000-query search stays within
``PQ_BUDGET_BYTES`` above the index, with the same answers at half the
budget.  Run on a machine with a card:
``python -m pytest portbench/tests/test_portbench_ivfpq_card.py -m card``."""

import importlib

import pytest

from portbench import harness
from portbench.frozen import datagen

CELL = "sift1m_ivfpq.batch10k"
READERS = ("pq.tables_pct", "pq.scan_pct", "pq.refine_pct", "select.sort_pct",
           "pq_scan_roofline")
SEED = 3000000019


def _controls():
    ref = harness.cell_spec(CELL)["config"]["reference"]
    return importlib.import_module("portbench.reference." + ref).Reference.CONTROLS


@pytest.mark.card
def test_cell_traced_is_correct_and_reads_its_metrics(card):
    res = harness.run_cell(harness.cell_spec(CELL), SEED, 2.0, True, "cuda")
    assert res["correct"], res["compared"]
    assert set(READERS) | {"device.idle_pct.batch"} <= set(res["metrics"]), res["metrics"]
    assert 0.0 < res["metrics"]["pq_scan_roofline"]["value"] <= 100.0


@pytest.mark.card
@pytest.mark.parametrize("control", _controls())
def test_control_is_not_correct(card, control):
    res = harness.run_cell(harness.cell_spec(CELL), SEED + 1, 1.0, False, "cuda",
                           control=control)
    assert not res["correct"], res["compared"]


@pytest.mark.card
def test_readers_find_nothing_in_ivfflat(card):
    spec = harness.cell_spec("sift1m_ivfflat.batch10k")
    spec["per_layer"] = [{"name": name, "unit": "%"} for name in READERS]
    res = harness.run_cell(spec, SEED, 1.0, True, "cuda")
    assert res["metrics"] == {}, res["metrics"]


@pytest.mark.card
def test_search_within_its_budget(card, monkeypatch):
    import torch

    from raft_tpu_torch.spatial import ann
    ctx = harness.setup(harness.cell_spec(CELL), SEED, "cuda")
    q = datagen.make_queries(10000, ctx.centers, ctx.config["data"], SEED)
    index, k = ctx.system.index, ctx.k
    ann.ivf_pq_search(index, q, k, device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    whole = ann.ivf_pq_search(index, q, k, device="cuda")
    torch.cuda.synchronize()
    assert torch.cuda.max_memory_allocated() - base <= ann.PQ_BUDGET_BYTES
    monkeypatch.setattr(ann, "PQ_BUDGET_BYTES", ann.PQ_BUDGET_BYTES // 2)
    half = ann.ivf_pq_search(index, q, k, device="cuda")
    assert torch.equal(whole[0], half[0]) and torch.equal(whole[1], half[1])
