"""Port parity: the span profiler (``raft_tpu_torch/core/profiler.py``)
against the JAX package's (``raft_tpu/core/profiler.py``).

The span cases of the JAX ``tests/test_metrics_profiler.py::
TestProfilerReport`` that do not use ``profiled_jit``: the same span
sequence run on both profilers gives the same tree (names, nesting,
counts), the report indents children, a span with a layer feeds the
``raft_tpu_<layer>_<name>_seconds`` timer, threads do not graft, an
exception still records, disabled metrics record nothing.  Then the
handle: ``takes_handle`` opens its ``<layer>.<name>`` span on the
handle's scoped profiler (the process default without one), beside the
torch profiler range it opens, and ``profiled`` follows a ``handle=``."""

import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu import Handle as JaxHandle
from raft_tpu.core import metrics as jmetrics
from raft_tpu.core import profiler as jprofiler
from raft_tpu.linalg import gemm as jgemm
from raft_tpu_torch.core import Handle, default_profiler, default_registry, metrics, profiled
from raft_tpu_torch.core import profiler as pprofiler
from raft_tpu_torch.linalg import gemm, row_norm


def _both():
    return (jprofiler.Profiler(registry=jmetrics.MetricsRegistry()),
            pprofiler.Profiler(registry=metrics.MetricsRegistry()))


def _shape(tree):
    """The tree without its times: names, nesting and counts."""
    return {name: (node["count"], _shape(node.get("children", {})))
            for name, node in tree.items()}


def _nest(prof):
    with prof.span("outer"):
        with prof.span("inner"):
            pass
        with prof.span("inner"):
            with prof.span("leaf"):
                pass
    with prof.span("outer"):
        pass


def test_nesting_and_counts_match_jax():
    jprof, pprof = _both()
    _nest(jprof)
    _nest(pprof)
    tree = pprof.tree()
    assert _shape(tree) == _shape(jprof.tree())
    assert tree["outer"]["count"] == 2
    assert tree["outer"]["children"]["inner"]["count"] == 2
    assert tree["outer"]["total_s"] >= tree["outer"]["children"]["inner"]["total_s"] >= 0.0
    report = pprof.report()
    out_line = [ln for ln in report.splitlines() if "outer" in ln][0]
    in_line = [ln for ln in report.splitlines() if "inner" in ln][0]
    # children render indented under their parent, as in the JAX report
    assert len(in_line) - len(in_line.lstrip()) > len(out_line) - len(out_line.lstrip())
    assert "n=2" in in_line
    jlines = jprof.report().splitlines()
    assert [ln.split("total=")[0] for ln in report.splitlines()[1:]] == [
        ln.split("total=")[0] for ln in jlines[1:]]


@pytest.mark.parametrize("name,layer,metric", [
    ("linalg.fake_op", "linalg", "raft_tpu_linalg_fake_op_seconds"),
    ("ooc.prefetch", "ooc", "raft_tpu_ooc_prefetch_seconds"),
    ("scan.step", "serve", "raft_tpu_serve_scan_step_seconds"),
])
def test_span_feeds_layer_timer_like_jax(name, layer, metric):
    jreg, preg = jmetrics.MetricsRegistry(), metrics.MetricsRegistry()
    for prof in (jprofiler.Profiler(registry=jreg), pprofiler.Profiler(registry=preg)):
        with prof.span(name, layer=layer):
            pass
        with prof.span(name, layer=layer):
            pass
    jsnap, psnap = jreg.snapshot(), preg.snapshot()
    assert set(psnap) == set(jsnap) == {metric}
    assert psnap[metric]["series"][0]["count"] == jsnap[metric]["series"][0]["count"] == 2


def test_threads_do_not_graft():
    for prof in _both():
        done = threading.Event()

        def worker():
            with prof.span("from_thread"):
                pass
            done.set()

        with prof.span("main_scope"):
            t = threading.Thread(target=worker)
            t.start()
            t.join(10)
        assert done.is_set() and not t.is_alive()
        tree = prof.tree()
        # the thread's span is a root, not a child of main_scope
        assert "from_thread" in tree
        assert "from_thread" not in tree["main_scope"].get("children", {})


def test_exception_still_recorded():
    for prof in _both():
        with pytest.raises(RuntimeError):
            with prof.span("exploding"):
                raise RuntimeError("boom")
        assert prof.tree()["exploding"]["count"] == 1


def test_disabled_spans_record_nothing():
    jprof, pprof = _both()
    metrics.set_enabled(False)
    jmetrics.set_enabled(False)
    try:
        for prof in (jprof, pprof):
            with prof.span("invisible", layer="core"):
                pass
    finally:
        metrics.set_enabled(True)
        jmetrics.set_enabled(True)
    assert "invisible" not in pprof.tree() and "invisible" not in jprof.tree()
    assert pprof.registry.snapshot() == {}


def test_reset_and_empty_report():
    pprof = _both()[1]
    with pprof.span("x"):
        pass
    pprof.reset()
    assert pprof.tree() == {}
    assert "(no spans recorded)" in pprof.report()


def test_takes_handle_span_on_the_scoped_profiler():
    a = np.eye(8, dtype=np.float32)
    jscoped = jprofiler.Profiler(registry=jmetrics.MetricsRegistry())
    pscoped = pprofiler.Profiler(registry=metrics.MetricsRegistry())
    jgemm(jnp.asarray(a), jnp.asarray(a), handle=JaxHandle(profiler=jscoped))
    h = Handle("cpu", profiler=pscoped)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as tp:
        got = gemm(a, a, handle=h)
    np.testing.assert_array_equal(got.numpy(), a)
    assert _shape(pscoped.tree()) == _shape(jscoped.tree()) == {"linalg.gemm": (1, {})}
    # the span feeds the scoped profiler's registry, and its range is on
    # the torch profiler's trace
    assert pscoped.registry.snapshot()["raft_tpu_linalg_gemm_seconds"]["series"][0]["count"] == 1
    assert "linalg.gemm" in {e.key for e in tp.key_averages()}


def test_takes_handle_defaults_to_the_process_profiler():
    assert Handle("cpu").profiler is default_profiler()
    before = default_profiler().tree().get("linalg.row_norm", {}).get("count", 0)
    fam = default_registry().get("raft_tpu_linalg_row_norm_seconds")
    timer_before = fam.labels().count if fam is not None else 0
    row_norm(np.ones((3, 4), np.float32), device="cpu")
    assert default_profiler().tree()["linalg.row_norm"]["count"] == before + 1
    assert default_registry().get("raft_tpu_linalg_row_norm_seconds").labels().count == (
        timer_before + 1)


def test_profiled_follows_the_handle_and_the_open_span():
    @profiled("spatial", name="fake_search")
    def fake_search(x, handle=None):
        return x * 2

    scoped = pprofiler.Profiler(registry=metrics.MetricsRegistry())
    assert fake_search(3, handle=Handle("cpu", profiler=scoped)) == 6
    assert _shape(scoped.tree()) == {"spatial.fake_search": (1, {})}
    # no handle: the innermost open profiler of this thread takes it
    other = pprofiler.Profiler(registry=metrics.MetricsRegistry())
    with other.span("caller"):
        fake_search(1)
    assert _shape(other.tree()) == {"caller": (1, {"spatial.fake_search": (1, {})})}
    assert "raft_tpu_spatial_fake_search_seconds" in other.registry.snapshot()
