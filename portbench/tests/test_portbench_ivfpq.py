"""The IVF-PQ cell's frozen ADC counts against a hand count, and its readers
on synthetic traces: each reads the device time launched inside its own
range, and nothing where its range ran nothing."""

import importlib.util
import types

import pytest
import torch

from portbench import harness
from portbench import trace as T
from portbench.frozen import pq_cost

READERS = {"pq.tables_pct": "ivf_pq_search.tables", "pq.scan_pct": "ivf_pq_search.scan",
           "pq.refine_pct": "ivf_pq_search.refine", "select.sort_pct": "select_k.sort"}


def _read(metric, ctx):
    path = harness.HERE / "metrics" / (metric + ".py")
    spec = importlib.util.spec_from_file_location("pb_metric_" + metric.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(ctx)


def test_adc_cost_by_hand():
    # 2 queries of depth 4 in 2 subspaces of 3 codewords, 2 probes: 2 x 2 x
    # 3 table entries of 2 x 4 operations; 10 rows scanned, one add a code;
    # 6 distinct rows of two 8-bit codes and an id, the queries, 2 x 5
    # candidates written
    ops, nbytes = pq_cost.adc_cost(2, 4, 3, 2, 8, 2, 5, 10, 6)
    assert ops == 2 * 2 * 3 * 8 + 2 * 10
    assert nbytes == 6 * (2 + 4) + 4 * 2 * 4 + 8 * 2 * 5


def _ev(cat, name, ts, dur, corr=None, tid=1):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def _trace(span):
    # window 0-1000 us; two kernels of 100 us, the first launched in ``span``
    return T.Trace([
        _ev("user_annotation", T.WINDOW, 0, 1000),
        _ev("user_annotation", span, 10, 30),
        _ev("cuda_runtime", "cudaLaunchKernel", 20, 5, corr=1),
        _ev("cuda_runtime", "cudaLaunchKernel", 60, 5, corr=2),
        _ev("kernel", "void a()", 100, 100, corr=1, tid=7),
        _ev("kernel", "void b()", 300, 100, corr=2, tid=7),
    ])


@pytest.mark.parametrize("metric", list(READERS))
def test_reader_reads_its_range(metric):
    got = _read(metric, types.SimpleNamespace(trace=_trace(READERS[metric])))
    value = got["value"] if isinstance(got, dict) else got
    assert value == pytest.approx(50.0)
    for other in set(READERS.values()) - {READERS[metric]}:
        assert _read(metric, types.SimpleNamespace(trace=_trace(other))) is None
    assert _read(metric, types.SimpleNamespace(trace=None)) is None


def test_roofline_reads_tables_and_scan():
    index = types.SimpleNamespace(centroids=torch.eye(4)[:3], list_sizes=torch.tensor([5, 3, 2]),
                                  codebooks=torch.zeros(2, 3, 2))
    q = torch.eye(4)[:2]
    ctx = types.SimpleNamespace(trace=_trace("ivf_pq_search.scan"), k=2,
                                system=types.SimpleNamespace(index=index),
                                config={"nprobe": 2, "pq_bits": 8, "refine_ratio": 2},
                                work={"pool": [q], "calls": [3]})
    got = _read("pq_scan_roofline", ctx)
    # three calls' work (bound by its bytes at this size) over the 100 us
    # launched under the scan; nothing where neither range ran
    assert got["bound"] == "bytes" and 0.0 < got["value"] < 100.0
    assert _read("pq_scan_roofline", _with(ctx, trace=_trace("ivf_flat_search.probe"))) is None


def _with(ctx, **kw):
    return types.SimpleNamespace(**dict(vars(ctx), **kw))
