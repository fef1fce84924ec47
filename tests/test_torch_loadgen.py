"""The port's load generator (``tools/torch_loadgen.py``) against the JAX
tool (``tools/loadgen.py``): every flag of the JAX tool, the same seeded
data, and each scenario at a tiny size on the CPU (2,000 x 16, k 5,
windows of 1-1.5 s) holding its invariants.  Where the JAX scenario
passes in the JAX package's own tests (chaos, tenants, crash-restart,
ops scrape), the port's report has the JAX report's keys at the same
arguments.

The invariants are read from counters and events (futures resolved,
typed errors, hedge wins, acked ids found), never from a latency: the
ops scrape's "QPS within noise" rule is the card's check, not this
file's, and the hedged replica is held back far longer than the hedge
threshold.  Every wait is bounded and every scenario stops its threads.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from raft_tpu.serve.resilience import RecoveryManager as JaxRecoveryManager
from raft_tpu_torch.core import flight
from raft_tpu_torch.serve.resilience import RecoveryManager
from tools import loadgen as jlg
from tools import torch_loadgen as lg

ROOT = Path(__file__).resolve().parents[1]
SEED = 3
ROWS, DIM, K = 2000, 16, 5
SVC = dict(max_batch_rows=64, max_wait_ms=1.0)
# the fleet's worker processes: two rungs (32 rows: the verification
# searches' 32-row requests), so two warmups on the CPU
# stay short side by side
FLEET_OPTS = {"delta_cap": 512, "max_batch_rows": 32, "bucket_rungs": [8, 32]}


@pytest.fixture(autouse=True)
def _slo_off_the_cpu(monkeypatch):
    # CPU latencies burn the 100 ms SLO; nothing here reads it
    monkeypatch.setenv("RAFT_TPU_SERVE_SLO_TARGET_MS", "100000")


def _keys(report):
    """A report's key structure (nested dicts by their own keys)."""
    return {k: (_keys(v) if isinstance(v, dict) else None) for k, v in report.items()}


def _flags(path):
    return set(re.findall(r"add_argument\(\s*\"(--[a-z0-9-]+)\"", path.read_text()))


def test_every_jax_flag_is_accepted():
    jax_flags = _flags(ROOT / "tools" / "loadgen.py")
    ours = _flags(ROOT / "tools" / "torch_loadgen.py")
    assert len(jax_flags) == 46
    assert jax_flags <= ours, sorted(jax_flags - ours)
    args = lg._parser().parse_args(["--device", "cpu"])
    for flag in jax_flags:
        assert hasattr(args, flag[2:].replace("-", "_")), flag


@pytest.mark.parametrize("seed,clusters", [(0, 0), (3, 8)])
def test_data_is_the_jax_tools(seed, clusters):
    ours = lg.synth_data(500, 16, seed=seed, clusters=clusters)
    theirs = jlg.synth_data(500, 16, seed=seed, clusters=clusters)
    assert ours.dtype == theirs.dtype == np.float32
    assert np.array_equal(ours, theirs)
    pool = lg.make_query_pool(ours, 4, seed=seed + 1)
    jpool = jlg.make_query_pool(theirs, 4, seed=seed + 1)
    assert len(pool) == len(jpool) == 32
    for a, b in zip(pool, jpool):
        assert a.dtype == np.float32 and np.array_equal(a, np.asarray(b))
    # a tensor reference draws the same rows
    tpool = lg.make_query_pool(torch.from_numpy(ours), 4, seed=seed + 1)
    assert all(np.array_equal(a, b) for a, b in zip(pool, tpool))


def test_without_a_card_the_tool_exits_2(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert lg.main(["--chaos", "--duration", "0.1"]) == 2
    assert "--device cpu" in capsys.readouterr().err


@pytest.mark.parametrize("argv", [
    ["--kill-shard", "--chaos"], ["--hedge-chaos"], ["--ooc"], ["--merge", "ring"],
    ["--ops-port", "0", "--chaos"], ["--trace", "--chaos"], ["--hedge-ms", "5"],
    ["--service", "ann", "--device-budget-mb", "4"]])
def test_the_jax_tools_flag_rules(argv):
    with pytest.raises(SystemExit):
        lg.main(["--device", "cpu"] + argv)


def _jax_service(**opts):
    svc = jlg.build_service("knn", ROWS, DIM, K, seed=SEED, **SVC, **opts)
    svc.warmup()
    return svc


def _service(kind="knn", **opts):
    svc = lg.build_service(kind, ROWS, DIM, K, device="cpu", seed=SEED, **SVC, **opts)
    svc.warmup()
    return svc


def _assert_exactly_once(rep):
    assert rep["exactly_once"] and rep["typed_only"], rep
    assert rep["lost"] == 0 and rep["untyped_errors"] == 0
    assert rep["ok"] + rep["typed_errors"] == rep["submitted"] == rep["resolved"]


def test_chaos_keys_and_invariants():
    args = dict(duration=1.2, concurrency=3, rows=2, seed=SEED, transient_p=0.05,
                outage_at=0.3, outage_s=0.4)
    jsvc = _jax_service()
    try:
        jrep = jlg.run_chaos(jsvc, manager=JaxRecoveryManager(services=[jsvc]), **args)
    finally:
        jsvc.close()
    svc = _service()
    timings = {}
    try:
        rep = lg.run_chaos(svc, manager=RecoveryManager(services=[svc]), timings=timings,
                           **args)
        assert svc.breaker.state.name == "CLOSED"
    finally:
        svc.close()
    assert _keys(rep) == _keys(jrep)
    assert rep["chaos_ok"], rep
    _assert_exactly_once(rep)
    # the persistent outage tripped the breaker and the manager recovered
    assert rep["breaker_trips"] >= 1 and rep["recoveries"] == 1
    assert rep["breaker_state"] == "closed"
    assert timings["recovery_s"] >= 0.0 and timings["rows"] == 2 * len(timings["latencies_s"])


def test_kill_shard_heals_exactly():
    svc = lg.build_service("knn", 800, DIM, K, device="cpu", seed=SEED, mesh_devices=4,
                           max_batch_rows=32)
    svc.warmup()
    try:
        assert svc.stats()["shard_devices"] == 4
        rep = lg.run_chaos(svc, duration=1.2, concurrency=2, rows=4, seed=11, transient_p=0.02,
                           outage_s=0.4, manager=RecoveryManager(services=[svc]),
                           kill_shard=True)
    finally:
        svc.close()
    assert rep["chaos_ok"], rep
    _assert_exactly_once(rep)
    assert rep["kill_shard"] is True and rep["shard_devices"] == 3
    assert rep["post_recovery_exact"] is True


def test_hedge_chaos_hedges_win():
    # the straggler holds each of its batches 1.5 s against a 30 ms hedge:
    # the other replica answers first however loaded the host is
    svc = _service(replicas=2, hedge_ms=30.0)
    try:
        rep = lg.run_hedge_chaos(svc, duration=1.2, concurrency=3, rows=4, seed=SEED,
                                 delay_s=1.5)
    finally:
        svc.close()
    assert rep["chaos_ok"], rep
    _assert_exactly_once(rep)
    assert rep["hedges_fired"] >= rep["hedge_wins"] > 0
    assert rep["post_warmup_compiles"] == 0 and rep["host_staged_bytes"] == 0
    assert set(rep) == {"seed", "duration_s", "delay_s", "submitted", "sheds", "ok",
                        "typed_errors", "untyped_errors", "lost", "resolved", "exactly_once",
                        "typed_only", "hedges_fired", "hedge_wins", "hedge_cancelled",
                        "post_warmup_compiles", "host_staged_bytes", "chaos_ok"}


def test_mixed_tenants_keys_and_typed_sheds():
    opts = dict(queue_cap=32, tenant_weights={"interactive": 4, "bulk": 1})
    args = dict(duration=1.0, interactive_concurrency=2, bulk_qps=150.0, interactive_rows=2,
                bulk_rows=16, seed=SEED)
    jsvc = _jax_service(**opts)
    try:
        jrep = jlg.run_mixed_tenants(jsvc, **args)
    finally:
        jsvc.close()
    svc = _service(**opts)
    try:
        rep = lg.run_mixed_tenants(svc, **args)
    finally:
        svc.close()
    assert _keys(rep) == _keys(jrep)
    assert set(rep["tenants"]) == {"interactive", "bulk"}
    assert rep["untyped_sheds"] == 0
    assert rep["tenants"]["interactive"]["requests_ok"] > 0
    # the closed interactive loop cannot exceed its share of the cap
    assert rep["tenants"]["interactive"]["rejected"] == 0
    assert rep["post_warmup_compiles"] == 0


def test_crash_restart_keys_and_invariants(tmp_path):
    args = dict(index_rows=ROWS, dim=DIM, k=K, seed=SEED, duration=1.2, concurrency=2, rows=4,
                nlist=16, clusters=8)
    jrep = jlg.run_crash_restart(str(tmp_path / "jax"), **args)
    timings = {}
    rep = lg.run_crash_restart(str(tmp_path / "port"), device="cpu", timings=timings, **args)
    assert _keys(rep) == _keys(jrep)
    assert rep["crash_ok"], rep
    _assert_exactly_once(rep)
    assert rep["no_insert_loss"] and rep["acked_inserts"] > 0
    assert rep["bit_identical"] and rep["wal_replayed_records"] > 0
    assert rep["post_restore_compiles"] == 0
    assert timings["warmup_s"] > 0.0 and timings["window_s"] > 0.0


def test_ops_scrape_keys_and_scrapes():
    args = dict(port=0, duration=2.0, concurrency=3, rows=4, seed=SEED)
    jsvc = _jax_service()
    try:
        jrep = jlg.run_ops_scrape(jsvc, **args)
    finally:
        jsvc.close()
    svc = _service()
    timings = {}
    try:
        rep = lg.run_ops_scrape(svc, timings=timings, **args)
    finally:
        svc.close()
    assert _keys(rep) == _keys(jrep)
    # the QPS ratio is a card number: not held here
    assert rep["scrapes"] > 0 and rep["scrape_failures"] == 0
    assert rep["post_warmup_compiles"] == 0 and rep["ops_port"] > 0
    assert rep["baseline_qps"] > 0 and rep["scraped_qps"] > 0
    assert timings["scraped"]["requests_ok"] == rep["requests_ok"]


def test_ooc_chaos_and_slow_traces(tmp_path):
    svc = lg.build_service("ann", 3000, DIM, K, device="cpu", seed=SEED, clusters=16, nlist=32,
                           ooc=True, **SVC)
    svc.warmup()
    try:
        pool = lg.make_query_pool(svc.loadgen_ref, 4, seed=SEED + 1)
        rep = lg.run_load(svc, duration=0.6, concurrency=2, recall=True, query_pool=pool,
                          trace_k=2)
        chaos = lg.run_chaos(svc, duration=1.0, concurrency=2, rows=4, seed=SEED,
                             outage_s=0.3, manager=RecoveryManager(services=[svc]))
    finally:
        svc.close()
    assert chaos["chaos_ok"], chaos
    _assert_exactly_once(chaos)
    assert rep["tile_hits"] + rep["tile_misses"] > 0 and rep["recall_k"] == K
    assert rep["post_warmup_compiles"] == 0
    assert len(rep["slow_traces"]) == 2
    for entry in rep["slow_traces"]:
        kinds = [ev["kind"] for ev in entry["timeline"]]
        assert kinds[0] == "admitted" and kinds[-1] == "resolved"
    path = tmp_path / "dump.json"
    lg._dump_flight(str(path))
    assert path.stat().st_size > 0


def test_cli_chaos_run(capsys, tmp_path):
    dump = tmp_path / "chaos.json"
    rc = lg.main(["--device", "cpu", "--chaos", "--index-rows", "1000", "--dim", "8", "--k",
                  "3", "--duration", "0.8", "--concurrency", "2", "--max-batch-rows", "32",
                  "--max-wait-ms", "1", "--outage-s", "0.3", "--trace-dump", str(dump),
                  "--seed", str(SEED)])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "chaos_ok             True" in out
    assert dump.exists()


def test_fleet_scenario_kill_and_rejoin(tmp_path):
    # seed 1's schedule kills a worker and restarts it (the headline fault
    # of the drill), with frame faults and an fsync stall; the process has
    # routed another fleet's requests before (its counters and its
    # request ids in the flight ring), which the accounting must not count
    from raft_tpu_torch.fleet.router import _counter

    _counter("raft_tpu_fleet_requests_total", "fleet requests by terminal outcome",
             outcome="resolved").inc(40)
    _counter("raft_tpu_fleet_rejoins_total", "workers re-registered after eviction/restart"
             ).inc(3)
    for rid in ("flt-00000001", "flt-00000002"):
        flight.record("fleet_resolved", service="fleet", rid=rid)
    rep = lg.run_fleet(str(tmp_path), n_workers=2, index_rows=ROWS, dim=DIM, k=K, seed=1,
                       duration=3.0, concurrency=3, rows=4, nlist=16, clusters=8,
                       device="cpu", service_opts=FLEET_OPTS, trace_k=1)
    assert "kill" in rep["chaos_applied"] and "restart" in rep["chaos_applied"], rep
    assert rep["fleet_ok"], rep
    assert rep["exactly_once"] and rep["dup_terminals"] == 0
    assert rep["typed_only"] and rep["no_insert_loss"] and rep["acked_inserts"] > 0
    assert rep["healed"] and rep["rejoins"] >= 1 and not rep["chaos_failed"]
    assert len(rep["slow_fleet_traces"]) <= 1
    for wid in ("w0", "w1"):
        assert (tmp_path / wid).is_dir()
