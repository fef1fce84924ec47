"""Whole runs of each cell at a tiny size on the CPU (the harness's look
for a card skipped): a sound run is correct, and each control, or a fault
planted in the timed path where the answer is produced or in the index's
build, is not."""

import importlib

import pytest
import torch

from portbench import harness
from portbench.tests import tiny

CELLS = [w["name"] for w in harness.load_json(harness.ROOT / "BENCHMARK.json")["workloads"]]
IVF_CELLS = [c for c in CELLS if c.startswith("sift1m_ivfflat")]
SEED = 2 ** 31 + 77


def _controls(cell):
    ref = tiny.spec(cell)["config"]["reference"]
    return importlib.import_module("portbench.reference." + ref).Reference.CONTROLS


def _run(cell, **kw):
    torch.set_num_threads(2)
    return harness.run_cell(tiny.spec(cell), SEED, 0.5, False, "cpu", **kw)


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    res = _run(cell)
    assert res["correct"], res["compared"]
    assert list(res)[-1] == "compared"


@pytest.mark.parametrize("cell,control", [(c, k) for c in CELLS for k in _controls(c)])
def test_control_is_not_correct(cell, control):
    res = _run(cell, control=control)
    assert not res["correct"], res["compared"]


def _plant(monkeypatch, cell, fault):
    """Break the function that produces the cell's answers."""
    if cell.startswith("sift1m_ivfflat"):
        import raft_tpu_torch.spatial.ann as mod
        name = "_ivf_flat_search_impl"
    else:
        import raft_tpu_torch.spatial.knn as mod
        name = "_search_one_partition"
    real = getattr(mod, name)

    def broken(*args, **kwargs):
        d, i = real(*args, **kwargs)
        d, i = d.clone(), i.clone()
        if fault == "altered_answer":
            i[:, 0] = torch.where(i[:, 0] > 0, i[:, 0] - 1, i[:, 0] + 1)
        else:                                   # half of the batch left out
            half = d.shape[0] // 2
            d[half:] = float("inf")
            i[half:] = -1
        return d, i

    monkeypatch.setattr(mod, name, broken)


@pytest.mark.parametrize("fault", ["altered_answer", "half_the_batch"])
@pytest.mark.parametrize("cell", CELLS)
def test_planted_fault_is_not_correct(cell, fault, monkeypatch):
    _plant(monkeypatch, cell, fault)
    res = _run(cell)
    assert not res["correct"], res["compared"]


@pytest.mark.parametrize("fault", ["kmeans_one_step", "kmeans_half_sample"])
@pytest.mark.parametrize("cell", IVF_CELLS)
def test_planted_build_fault_is_not_correct(cell, fault, monkeypatch):
    """k-means that skips its iterations, or trains on half its rows."""
    import raft_tpu_torch.spatial.ann as ann
    real = ann.kmeans

    def broken(X, k, **kwargs):
        if fault == "kmeans_one_step":
            return real(X, k, **dict(kwargs, max_iter=1))
        res = real(X[: X.shape[0] // 2], k, **kwargs)
        return res._replace(labels=ann._assign_labels(X, res.centroids))

    monkeypatch.setattr(ann, "kmeans", broken)
    res = _run(cell)
    assert not res["correct"], res["compared"]
