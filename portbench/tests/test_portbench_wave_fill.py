"""The reader of ``k1.wave_fill_pct`` on synthetic traces and counters."""

import sys
import types

import pytest

from portbench import harness
from portbench import trace as T

K1 = "void raft_tpu_torch::knn_tile_kernel<64, 4, 0, false>(CUtensorMap, int)"


def _ctx(kernel):
    events = [{"ph": "X", "cat": "user_annotation", "name": T.WINDOW, "ts": 0, "dur": 1000,
               "tid": 1}]
    if kernel:
        events.append({"ph": "X", "cat": "kernel", "name": kernel, "ts": 10, "dur": 50,
                       "tid": 7})
    return types.SimpleNamespace(trace=T.Trace(events))


@pytest.fixture
def counters():
    from raft_tpu_torch.core import tracing
    tracing.reset_counters()
    yield tracing
    tracing.reset_counters()


def test_blocks_over_wave_slots(counters):
    from raft_tpu_torch.ops.knn_tile import WAVE_COUNTERS
    counters.counter_inc(WAVE_COUNTERS[0], 2 * 785)
    counters.counter_inc(WAVE_COUNTERS[1], 2 * 6 * 132)
    got = harness._reader("k1.wave_fill_pct")(_ctx(K1))
    assert got["value"] == pytest.approx(100.0 * 785 / 792)
    assert (got["blocks"], got["wave_slots"]) == (1570, 1584)


def test_nothing_to_read_without_k1(counters):
    assert harness._reader("k1.wave_fill_pct")(_ctx("void other()")) is None


def test_raises_where_k1_ran_uncounted(counters):
    with pytest.raises(RuntimeError, match="wave counters read 0 blocks"):
        harness._reader("k1.wave_fill_pct")(_ctx(K1))


def test_a_program_without_the_counters_reads_nothing(monkeypatch, counters):
    # the parent program: a knn_tile module with no WAVE_COUNTERS
    monkeypatch.setitem(sys.modules, "raft_tpu_torch.ops.knn_tile",
                        types.ModuleType("raft_tpu_torch.ops.knn_tile"))
    assert harness._reader("k1.wave_fill_pct")(_ctx(K1)) is None
