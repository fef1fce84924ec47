"""The IVF-PQ search of the benchmark's ``sift1m_ivfpq`` cell, at a small
size on the CPU: the port's ``ivf_pq_build`` and ``ivf_pq_search``
graded by the cell's plain reference (``portbench/reference/ivf_pq.py``)
within the cell's limits, the chunked search bit for bit the same
whatever its chunks, its trace ranges and counters, and faults planted
in the search caught by the grade."""

import json
from pathlib import Path

import pytest
import torch

from portbench.reference import ivf_pq as ref_pq
from raft_tpu_torch.core import tracing
from raft_tpu_torch.distance.distance_type import DistanceType
from raft_tpu_torch.spatial import ann
from raft_tpu_torch.spatial.select_k import SORT_RANGE, select_k

ROOT = Path(__file__).resolve().parents[1]
CELL = json.loads((ROOT / "portbench/workloads/sift1m_ivfpq.batch10k.json").read_text())
CONFIG = dict(json.loads((ROOT / "portbench/configs/sift1m_ivfpq.json").read_text()),
              rows=4096, dim=32, nlist=16, nprobe=4, pq_dim=16, train_rows=None)
NQ = 200


@pytest.fixture(scope="module")
def data():
    g = torch.Generator().manual_seed(11)
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
    return ann.ivf_pq_build(data[0], params, DistanceType[CONFIG["metric"]], seed=5,
                            device="cpu")


def _state(index):
    return {"centroids": index.centroids, "codebooks": index.codebooks,
            "slot_codes": index.slot_codes, "slot_ids": index.slot_ids,
            "slot_centroid": index.slot_centroid, "list_sizes": index.list_sizes,
            "vectors": index.vectors}


def _numbers(x, q, index, k):
    """Every number the cell compares, for the program's answer to ``q``
    at ``k``."""
    ref = ref_pq.Reference(CONFIG, x, _state(index), seed=3)
    d, i = ann.ivf_pq_search(index, q, k, device="cpu")
    return dict(ref.index_numbers(), **ref.grade(q, d, i, ref.expect(q, k)), missing=0)


def _over(nums):
    return {key: nums[key] for key, limit in CELL["limits"].items() if nums[key] > limit}


@pytest.mark.parametrize("k", [10, 80], ids=["k10 (K2 route)", "k80 (sort route)"])
def test_port_within_the_cells_limits(data, index, k):
    x, q = data
    nums = _numbers(x, q, index, k)
    assert not _over(nums), nums
    assert nums["graded"] == NQ * k and nums["hits"] >= 0.9 * nums["graded"]


def _budget_for(chunks, nq, k):
    """A budget that cuts ``nq`` queries at ``k`` into ``chunks`` chunks."""
    per = ann.pq_query_bytes(CONFIG["nprobe"], CONFIG["pq_dim"], 2 ** CONFIG["pq_bits"], 256,
                             k * CONFIG["refine_ratio"], CONFIG["dim"], True)
    return nq * (4 * CONFIG["nprobe"] + 8 * k) + per * -(-nq // chunks)


@pytest.mark.parametrize("k", [10, 80])
def test_answers_are_the_same_whatever_the_chunks(data, index, k, monkeypatch):
    assert index.slot_ids.shape[1] == 256
    q = data[1]
    got = {}
    for chunks in (1, 3, 7):
        monkeypatch.setattr(ann, "PQ_BUDGET_BYTES", _budget_for(chunks, NQ, k))
        before = [tracing.get_counter(c) for c in ann.PQ_COUNTERS]
        got[chunks] = ann.ivf_pq_search(index, q, k, device="cpu")
        counted = [tracing.get_counter(c) - b for c, b in zip(ann.PQ_COUNTERS, before)]
        assert counted[0] == chunks
        # every query's tables are built once, whatever the chunks
        assert counted[2] == NQ * CONFIG["nprobe"] * CONFIG["pq_dim"] * 256 * 4
        assert counted[1] >= 1
    for chunks in (3, 7):
        assert torch.equal(got[chunks][0], got[1][0]) and torch.equal(got[chunks][1], got[1][1])


def test_chunk_rows_keep_the_budget():
    per = ann.pq_query_bytes(50, 64, 256, 984, 200, 128, True)
    # the tables and their temporaries set the peak at the cell's shape
    assert per == 4 * (4 * 50 * 64 * 256) + 12 * 50 * 128
    rows = ann._pq_chunk_rows(10000, 100, 50, per)
    chunks = -(-10000 // rows)
    assert rows * per + 10000 * (4 * 50 + 8 * 100) <= ann.PQ_BUDGET_BYTES
    assert (chunks - 1) * rows < 10000 <= chunks * rows
    assert ann._pq_chunk_rows(5, 100, 50, 1 << 40) == 1


def test_search_opens_its_ranges(data, index):
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        ann.ivf_pq_search(index, data[1][:20], 80, device="cpu")
    names = {e.name for e in prof.events()}
    for name in ("ivf_pq_search.probe", "ivf_pq_search.tables", "ivf_pq_search.scan",
                 "ivf_pq_search.refine", SORT_RANGE):
        assert name in names, name


def test_sort_range_marks_only_the_sort(data):
    keys = torch.rand(30, 400)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        select_k(keys, 150, device="cpu")
    assert SORT_RANGE in {e.name for e in prof.events()}
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        select_k(keys, 100, device="cpu")
    assert SORT_RANGE not in {e.name for e in prof.events()}


def _wrong_code(index):
    codes = index.slot_codes.clone()
    codes[..., 0] = (codes[..., 0] + 1) % 256
    return index._replace(slot_codes=codes)


@pytest.mark.parametrize("fault", ["wrong_code", "wrong_probe_rank", "no_rerank"])
def test_planted_faults_are_caught(data, index, fault, monkeypatch):
    x, q = data
    if fault == "wrong_code":
        index = _wrong_code(index)
    elif fault == "wrong_probe_rank":
        real = ann._scan_steps

        def shifted(qc, slots, prank, n_live, step_dist, *args):
            return real(qc, slots, (prank + 1) % CONFIG["nprobe"], n_live, step_dist, *args)

        monkeypatch.setattr(ann, "_scan_steps", shifted)
    else:
        def skipped(vectors, qc, cand_ids, k, sqrt, select_impl=None):
            ids = cand_ids[:, :k]                      # the ADC top-k, in ADC order
            diff = vectors[ids.clamp(min=0).long()] - qc[:, None, :]
            d = (diff * diff).sum(dim=-1)
            return (d.sqrt() if sqrt else d), ids

        monkeypatch.setattr(ann, "_refine_impl", skipped)
    over = _over(_numbers(x, q, index, 20))
    assert over, fault


def test_reference_controls_fail_a_limit(data, index):
    x, q = data
    for control in ref_pq.Reference.CONTROLS:
        ref = ref_pq.Reference(CONFIG, x, _state(index), seed=3, control=control)
        nums = dict(ref.index_numbers(), **ref.grade(q, *ref.control(q, 20), ref.expect(q, 20)),
                    missing=0)
        assert _over(nums), control
