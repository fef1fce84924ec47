"""The IVF-PQ search of the benchmark's ``gist1m_ivfpq`` cell, at a small
size on the CPU with the cell's 10 dimensions a subspace (4,000 x 40, M
4): the port's ``ivf_pq_build`` and ``ivf_pq_search`` graded by the cell's
plain reference (``portbench/reference/ivf_pq.py``) within the cell's
limits, on the step route and on the wide route's glue (its legality rule
forced; a CPU tensor hands the scan to the plain version), and the
probe's float64 distances above their depth."""

import json
from pathlib import Path

import pytest
import torch

from portbench.reference import ivf_pq as ref_pq
from raft_tpu_torch.core import tracing
from raft_tpu_torch.distance.distance_type import DistanceType
from raft_tpu_torch.ops import pq_scan
from raft_tpu_torch.spatial import ann

ROOT = Path(__file__).resolve().parents[1]
CELL = json.loads((ROOT / "portbench/workloads/gist1m_ivfpq.batch1k.json").read_text())
CONFIG = dict(json.loads((ROOT / "portbench/configs/gist1m_ivfpq.json").read_text()),
              rows=4000, dim=40, nlist=16, nprobe=4, pq_dim=4, train_rows=None)
NQ = 120


@pytest.fixture(scope="module")
def data():
    g = torch.Generator().manual_seed(26)
    centres = torch.randn(8, CONFIG["dim"], generator=g) * 2.0
    x = centres[torch.randint(8, (CONFIG["rows"],), generator=g)]
    x = x + 0.5 * torch.randn(x.shape, generator=g)
    q = centres[torch.randint(8, (NQ,), generator=g)] + 0.5 * torch.randn(NQ, CONFIG["dim"],
                                                                        generator=g)
    return x, q


@pytest.fixture(scope="module")
def index(data):
    params = ann.IVFPQParams(nlist=CONFIG["nlist"], nprobe=CONFIG["nprobe"], M=CONFIG["pq_dim"],
                             n_bits=CONFIG["pq_bits"], refine_ratio=CONFIG["refine_ratio"])
    out = ann.ivf_pq_build(data[0], params, DistanceType[CONFIG["metric"]], seed=5,
                           device="cpu")
    assert tuple(out.codebooks.shape) == (4, 256, 10)
    return out


def _state(index):
    return {"centroids": index.centroids, "codebooks": index.codebooks,
            "slot_codes": index.slot_codes, "slot_ids": index.slot_ids,
            "slot_centroid": index.slot_centroid, "list_sizes": index.list_sizes,
            "vectors": index.vectors}


def _numbers(x, q, index, k, answer):
    ref = ref_pq.Reference(CONFIG, x, _state(index), seed=3)
    return dict(ref.index_numbers(), **ref.grade(q, *answer, ref.expect(q, k)), missing=0)


def _over(nums):
    return {key: nums[key] for key, limit in CELL["limits"].items() if nums[key] > limit}


@pytest.mark.parametrize("k", [10, 80], ids=["k10 (K2 route)", "k80 (sort route)"])
def test_port_within_the_cells_limits(data, index, k):
    x, q = data
    nums = _numbers(x, q, index, k, ann.ivf_pq_search(index, q, k, device="cpu"))
    assert not _over(nums), nums
    assert nums["graded"] == NQ * k and nums["hits"] >= 0.4 * nums["graded"]


@pytest.mark.parametrize("k", [10, 80])
def test_wide_route_within_the_cells_limits(data, index, k, monkeypatch):
    """The search on the wide route's glue (K7 refused, the wide rule
    forced): one chunk, counted as a wide one, its answers the step
    route's bit for bit and within the cell's limits."""
    x, q = data
    step = ann.ivf_pq_search(index, q, k, device="cpu")
    monkeypatch.setattr(pq_scan, "takes", lambda *args: False)
    monkeypatch.setattr(pq_scan, "takes_wide", lambda *args: True)
    names = (ann.PQ_COUNTERS[0], ann.PQ_WIDE_CHUNKS, ann.PQ_TABLE_READS[1])
    before = [tracing.get_counter(c) for c in names]
    got = ann.ivf_pq_search(index, q, k, device="cpu")
    assert [tracing.get_counter(c) - b for c, b in zip(names, before)] == [1, 1, NQ]
    assert torch.equal(got[0], step[0]) and torch.equal(got[1], step[1])
    assert not _over(_numbers(x, q, index, k, got))


def test_reference_controls_fail_a_limit(data, index):
    x, q = data
    for control in ref_pq.Reference.CONTROLS:
        ref = ref_pq.Reference(CONFIG, x, _state(index), seed=3, control=control)
        nums = dict(ref.index_numbers(), **ref.grade(q, *ref.control(q, 20), ref.expect(q, 20)),
                    missing=0)
        assert _over(nums), control


@pytest.mark.parametrize("d", [40, 128, 256, 960])
def test_probe_in_float64(d):
    """The probe's distances are the float64 expanded form's rounded to
    float32 at every depth, on rows far from the origin (where the
    float32 form's rounding is largest)."""
    g = torch.Generator().manual_seed(d)
    q = 3.0 + torch.randn(50, d, generator=g)
    c = 3.0 + torch.randn(70, d, generator=g)
    got = ann._pq_probe_dists(q, c)
    assert got.dtype == torch.float32
    exact = ((q.double()[:, None, :] - c.double()[None]) ** 2).sum(-1)
    want = ann.expanded_sq_dists(q.double(), c.double()).float()
    assert torch.equal(got, want)
    assert float(((got.double() - exact).abs() / exact).max()) < 2e-7


def test_search_probes_in_float64(data, index, monkeypatch):
    """The search's probe takes the float64 distances, at the cell's
    depth of 40 as at gist-960's."""
    _, q = data
    seen = []
    dists = ann.expanded_sq_dists
    monkeypatch.setattr(ann, "expanded_sq_dists",
                        lambda a, b, *rest: seen.append(a.dtype) or dists(a, b, *rest))
    ann.ivf_pq_search(index, q, 10, device="cpu")
    assert seen == [torch.float64]
