"""Port parity of the observability modules the serving layer stands on:
metrics, flight recorder, tracing ranges and counters, and the
kernel-library count."""

import numpy as np
import pytest
import torch

from raft_tpu.core import flight as jax_flight
from raft_tpu.core.metrics import MetricsRegistry as JaxRegistry
from raft_tpu_torch.core import flight, tracing
from raft_tpu_torch.core.metrics import MetricsRegistry, parse_prometheus
from raft_tpu_torch.ops import _build
from raft_tpu_torch.serve import KNNService


def _drive(reg):
    c = reg.counter("raft_tpu_serve_requests_total", help="served", labels=("service",))
    c.labels(service="a").inc(3)
    c.labels(service="b").inc()
    g = reg.gauge("raft_tpu_serve_queue_depth", help="queued", labels=("service",))
    g.labels(service="a").set(7)
    g.labels(service="a").set(2)
    t = reg.timer("raft_tpu_serve_exec_seconds", help="exec")
    for s in (0.001, 0.004, 0.002, 0.010):
        t.observe(s)
    return reg


def test_metrics_exposition_equals_the_jax_registry():
    ours, theirs = _drive(MetricsRegistry()), _drive(JaxRegistry())
    assert ours.to_prometheus() == theirs.to_prometheus()
    assert ours.snapshot() == theirs.snapshot()
    parsed = parse_prometheus(ours.to_prometheus())
    assert parsed["raft_tpu_serve_requests_total"][(("service", "a"),)] == 3.0
    assert ours.get("raft_tpu_serve_queue_depth").labels(service="a").high_water == 7


@pytest.mark.parametrize("observations", [
    [("t0", 0.01, True), ("t0", 0.5, True), ("t1", 0.02, False)],
    [("t0", 0.2, True)] * 5 + [("t0", 0.01, True)] * 20])
def test_slo_tracker_equals_the_jax_tracker(observations):
    def run(mod):
        clock = iter(np.arange(0.0, 100.0, 0.5))
        slo = mod.SLOTracker("svc", target_s=0.1, objective=0.9, windows_s=(5.0, 60.0),
                             clock=lambda: next(clock))
        for tenant, latency, ok in observations:
            slo.observe(tenant, latency, deadline_ok=ok)
        return slo.snapshot(publish=False)

    assert run(flight) == run(jax_flight)


def test_flight_ring_is_bounded_and_traces_complete():
    rec = flight.FlightRecorder(capacity=8)
    tr = rec.new_trace("svc", "t")
    for i in range(20):
        rec.record("admitted" if i == 0 else "note", service="svc", trace=tr, i=i)
    rec.record("resolved", service="svc", trace=tr)
    assert len(rec.events()) == 8
    assert tr.kinds()[0] == "admitted" and tr.terminal() == "resolved"


def test_tracing_ranges_reach_the_torch_profiler():
    tracing.reset_counters()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with tracing.annotate("serve.batch %d", 3):
            torch.ones(4).sum()
        tracing.range_push("imperative")
        tracing.range_pop()
        with tracing.event("comms.retry", "attempt=%d", 1):
            pass
    names = {e.name for e in prof.events()}
    assert {"serve.batch 3", "imperative", "comms.retry attempt=1"} <= names
    assert tracing.get_counter("comms.retry") == 1
    tracing.range_pop()                   # an empty stack pops nothing
    tracing.set_enabled(False)
    try:
        with tracing.annotate("off"):
            pass
    finally:
        tracing.set_enabled(True)


def test_service_counts_kernel_libraries_after_warmup(monkeypatch):
    x = np.random.default_rng(0).standard_normal((50, 4)).astype(np.float32)
    svc = KNNService(x, 3, device="cpu", start=False, name="torch-warm")
    assert svc.kernel_libraries_after_warmup() is None
    monkeypatch.setattr(_build, "_stats", {"builds": 2, "loads": 5})
    svc.warmup()
    assert svc.warmed_rungs == svc.policy.rungs
    assert svc.stats()["kernel_libraries_after_warmup"] == {"builds": 0, "loads": 0}
    _build._stats["loads"] += 1           # a library loaded in steady state
    assert svc.kernel_libraries_after_warmup() == {"builds": 0, "loads": 1}
    svc.close()
