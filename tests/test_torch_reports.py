"""The port's report tools against the JAX ones: the same flight dump and
fleet join payload through ``tools/torch_trace_report.py`` and
``tools/trace_report.py`` render equal, string for string and JSON for
JSON; the same port snapshot through both ``render_report``s renders
every section that reads no live process equal (the tuning line reads
each package's own config; the inventory section is the port's own).

The dump comes from the port's ``KNNService`` on the CPU (requests, a
transient fault, a recovery), the fleet payload from
``raft_tpu_torch/fleet/tracing.py:join`` on fake clocks.
"""

import json

import numpy as np
import pytest

from raft_tpu_torch.comms import faults
from raft_tpu_torch.core import flight
from raft_tpu_torch.fleet import tracing
from raft_tpu_torch.serve import KNNService
from raft_tpu_torch.serve.resilience import RecoveryManager, inject_worker
from raft_tpu_torch.session import metrics_snapshot
from tools import metrics_report as jmr
from tools import torch_metrics_report as mr
from tools import torch_trace_report as tr
from tools import trace_report as jtr


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """The port's flight dump and metrics snapshot after a served run on
    the CPU: batched requests, one failed batch, a recovery."""
    flight.default_recorder().clear()
    rng = np.random.default_rng(0)
    x = rng.standard_normal((500, 8)).astype(np.float32)
    svc = KNNService(x, k=3, max_batch_rows=16, max_wait_ms=1.0, device="cpu",
                     name="reports-knn")
    try:
        svc.warmup()
        for f in svc.submit_many([x[i:i + 3] for i in range(0, 30, 3)]):
            f.result(timeout=30)
        with inject_worker(svc.worker, faults.FailNth(1)):
            fut = svc.submit(x[:2])
            fut.wait(timeout=30)
        RecoveryManager(services=[svc]).recover()
        for f in svc.submit_many([x[i:i + 2] for i in range(0, 8, 2)], tenant="t1"):
            f.result(timeout=30)
    finally:
        svc.close()
    path = tmp_path_factory.mktemp("flight") / "dump.json"
    flight.default_recorder().dump_to(str(path))
    dump = json.loads(path.read_text())
    return dump, json.loads(json.dumps(metrics_snapshot()))


def _router_events(rid, t0=100.0, worker="w0", server_s=0.008):
    return [
        {"ts": t0, "kind": "fleet_admitted", "service": "fleet", "rid": rid},
        {"ts": t0 + 0.001, "kind": "fleet_rpc_send", "service": "fleet", "rid": rid,
         "worker": worker, "attempt": 0},
        {"ts": t0 + 0.012, "kind": "fleet_rpc_recv", "service": "fleet", "rid": rid,
         "worker": worker, "attempt": 0, "elapsed_s": 0.011, "server_s": server_s,
         "network_s": 0.011 - server_s},
        {"ts": t0 + 0.013, "kind": "fleet_resolved", "service": "fleet", "rid": rid},
    ]


def _worker_payload(rid, wid, clock_t0, server_s=0.008):
    events = [
        {"ts": clock_t0, "kind": "admitted", "service": "ann", "trace_id": 1},
        {"ts": clock_t0 + server_s * 0.5, "kind": "batch_formed", "service": "ann",
         "traces": [1]},
        {"ts": clock_t0 + server_s, "kind": "resolved", "service": "ann", "trace_id": 1},
    ]
    return {"fleet": rid, "worker_id": wid, "generation": 1, "now": clock_t0 + 1.0,
            "traces": [{"trace_id": 1, "service": "ann", "tenant": None, "events": events}]}


def _joined(rid, workers):
    """A joined payload as the router serves it: the join and its
    invariant problems."""
    joined = tracing.join(rid, _router_events(rid), workers)
    joined["problems"] = tracing.validate(joined)
    return joined


JOINS = {
    "aligned": lambda: _joined("r1", {"w0": {"offset_s": 50.0, "rtt_s": 0.002,
                                             "payload": _worker_payload("r1", "w0", 50.003)}}),
    "partial": lambda: _joined("r4", {"w0": {"offset_s": 0.0, "rtt_s": 0.0, "payload": None}}),
    "misaligned": lambda: _joined("r2", {"w0": {"offset_s": 50.08, "rtt_s": 0.002,
                                                "payload": _worker_payload("r2", "w0", 50.003)}}),
}


def test_dump_renders_as_the_jax_tool(served):
    dump, _ = served
    events = tr.load_events(dump)
    assert events == jtr.load_events(dump)
    ids = tr.trace_ids(events)
    assert ids and ids == jtr.trace_ids(events)
    assert tr.summarize(events) == jtr.summarize(events)
    assert "failed" in tr.summarize(events) and "recovery_begin" in tr.summarize(events)
    assert tr.to_chrome_trace(events) == jtr.to_chrome_trace(events)
    for tid in ids:
        timeline = [e for e in events if tid in tr.event_trace_ids(e)]
        assert tr.render_waterfall(timeline) == jtr.render_waterfall(timeline)
    assert tr.load_events(events) == events       # a bare list
    with pytest.raises(SystemExit):
        tr.load_events({"nothing": 1})


@pytest.mark.parametrize("case", sorted(JOINS))
def test_fleet_join_renders_as_the_jax_tool(case):
    joined = json.loads(json.dumps(JOINS[case]()))
    assert tr.is_fleet_join(joined) and jtr.is_fleet_join(joined)
    text = tr.render_fleet_waterfall(joined)
    assert text == jtr.render_fleet_waterfall(joined)
    assert tr.fleet_to_chrome_trace(joined) == jtr.fleet_to_chrome_trace(joined)
    if case == "aligned":
        assert not joined["problems"] and "!!" not in text
        assert "hop tiling" in text
    if case == "misaligned":
        assert joined["problems"] and "!!" in text


def _run_main(mod, argv, capsys):
    rc = mod.main(argv)
    return rc, capsys.readouterr().out


def test_trace_mains_print_the_same(served, tmp_path, capsys):
    dump, _ = served
    path = tmp_path / "dump.json"
    path.write_text(json.dumps(dump))
    joined = tmp_path / "joined.json"
    joined.write_text(json.dumps(JOINS["aligned"]()))
    tid = tr.trace_ids(dump["events"])[0]
    for argv in ([str(path)], [str(path), "--trace-id", str(tid)], [str(joined)],
                 [str(path), "--trace-id", "999999"]):
        ours = _run_main(tr, argv, capsys)
        theirs = _run_main(jtr, argv, capsys)
        assert ours == theirs, argv
    for src in (path, joined):
        outs = []
        for mod, name in ((tr, "ours.json"), (jtr, "theirs.json")):
            out = tmp_path / name
            assert mod.main([str(src), "--chrome", str(out)]) == 0
            outs.append(json.loads(out.read_text()))
        capsys.readouterr()
        assert outs[0] == outs[1] and outs[0]["traceEvents"]


def _sections(text):
    """``{header: body}`` of a rendered report (the lines before the first
    header under ``""``)."""
    out, head = {}, ""
    for line in text.splitlines():
        if line.startswith("== ") or line.startswith("profiler report"):
            head = line
            out.setdefault(head, [])
            continue
        out.setdefault(head, []).append(line)
    return out


def _comparable(sections):
    return {h: b for h, b in sections.items()
            if not h.startswith(("== tuning", "== program inventory", "== kernel inventory"))}


FLEET_SECTION = {"mode": "sharded", "shard_count": 2,
                 "rollup": {"workers_total": 2, "workers_dead": 0, "uptime_s": 12.5,
                            "requests_total": 40, "qps_lifetime": 3.2, "p50_e2e_ms": 4.0,
                            "p99_e2e_ms": 9.5, "slo_burn_max": 0.0},
                 "workers": {"w0": {"state": "active", "generation": 1, "wal_seq": 7,
                                    "queue_depth": 0, "requests_total": 20,
                                    "exec_p50_ms": 1.5, "exec_p95_ms": 2.5, "slo_burn": 0.0}},
                 "stats": {"last_rejoin": {"worker_id": "w0", "generation": 1,
                                           "replayed_records": 3, "restore_s": 0.2}}}


def test_snapshot_renders_as_the_jax_tool(served):
    _, snap = served
    snap = dict(snap, fleet=FLEET_SECTION)
    ours, theirs = _sections(mr.render_report(snap)), _sections(jmr.render_report(snap))
    assert _comparable(ours) == _comparable(theirs)
    for head in ("== fleet", "== timers", "== counters", "== serving", "== SLO burn"):
        assert any(h.startswith(head) for h in ours), head
    serving = next(b for h, b in ours.items() if h.startswith("== serving"))
    assert any("reports-knn" in line and "breaker=closed" in line for line in serving)
    assert not any("compile cache" in h for h in ours)


def test_inventory_section_reads_the_ports_inventory():
    snap = {"metrics": {}, "inventory": {
        "programs": 3, "total_hbm_bytes": 5.0e6,
        "per_fn": {"knn_tile": {"programs": 2, "max_flops": 2.6e11, "total_flops": 3.0e11,
                                "total_bytes_accessed": 5.2e8, "total_hbm_bytes": 4.0e6,
                                "launches": 17, "device_mean_s": None},
                   "select_tile": {"programs": 1, "max_flops": 0.0, "total_flops": 0.0,
                                   "total_bytes_accessed": 4.1e5, "total_hbm_bytes": 1.0e6,
                                   "launches": 5, "device_mean_s": 0.002}}}}
    text = mr.render_report(snap)
    lines = _sections(text)["== kernel inventory (launches, operations and bytes from "
                            "ops/cost.py) =="]
    assert lines[0] == "  shapes=3  footprint (args+outs+scratch) = 5.0 MB"
    assert "launches=17" in lines[1] and "flops=3e+11" in lines[1] and "bytes=5.2e+08" in lines[1]
    assert lines[2].startswith("  select_tile") and "launches=5" in lines[2]
    assert "device mean=2.000ms" in lines[2]


def test_metrics_main_on_a_snapshot_file(served, tmp_path, capsys):
    _, snap = served
    path = tmp_path / "snap.json"
    path.write_text(json.dumps(snap))
    rc, ours = _run_main(mr, [str(path)], capsys)
    rc2, theirs = _run_main(jmr, [str(path)], capsys)
    assert rc == rc2 == 0
    assert _comparable(_sections(ours)) == _comparable(_sections(theirs))
    rc, ours = _run_main(mr, [str(path), "--format", "json"], capsys)
    assert rc == 0 and json.loads(ours) == snap
    assert mr.main([str(path), "--format", "prom"]) == 2
    with pytest.raises(SystemExit):
        mr.main([])


def test_metrics_demo_on_the_cpu(tmp_path, capsys):
    out = tmp_path / "demo.json"
    rc, text = _run_main(mr, ["--demo", "--device", "cpu", "--out", str(out)], capsys)
    assert rc == 0
    snap = json.loads(out.read_text())
    assert {"metrics", "flight", "inventory", "profiler_tree"} <= set(snap)
    assert "compile_cache" not in snap
    assert "raft_tpu_comms_verb_seconds" in text and "== serving" in text


def test_metrics_demo_without_a_card_exits_2(monkeypatch, capsys):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert mr.main(["--demo"]) == 2
    assert "--device cpu" in capsys.readouterr().err
