"""Port parity and a live CPU run of the process fleet (raft_tpu_torch.fleet).

The host-side modules are held to the JAX package's on the same inputs:
the wire protocol's typed-error round trip and status taxonomy (by class
name and payload), rendezvous placement under roster growth, the
router's top-k merge, the chaos harness's seeded schedules and frame
faults, the metric relabelling of the aggregated scrape, and the trace
join and the worker's clock-offset estimate on fake clocks.

Then a live fleet of two sharded worker processes (600 x 8, ``device=
"cpu"`` in their specs) on ephemeral ports: formation, fan-out and
merge (the router's answer equal to the merge of each worker's own
``/search``), inserts acked and found, the typed admission shed, the
aggregated scrape and health, and a deterministic kill and rejoin: the
``SIGKILL`` lands after every insert of a batch was acknowledged, with
no insert racing it; no acknowledged row is lost and the answers to a
fixed query set are bitwise equal before and after.  A worker whose
spec asks for CUDA on a machine without it exits non-zero, and
``wait_ready`` raises at once naming the exit code.  Every wait has a
deadline.
"""

import json
import os
import random
import signal
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from raft_tpu.core import error as jerror
from raft_tpu.fleet import chaos as jchaos
from raft_tpu.fleet import protocol as jprotocol
from raft_tpu.fleet import tracing as jtracing
from raft_tpu.fleet.router import _relabel_metrics as j_relabel
from raft_tpu.fleet.worker import FleetWorker as JaxFleetWorker
from raft_tpu.fleet.worker import _synth as j_synth
from raft_tpu_torch.core import error as perror
from raft_tpu_torch.core import flight
from raft_tpu_torch.core.error import RaftError, ServiceOverloadError
from raft_tpu_torch.fleet import Fleet, chaos, protocol, tracing
from raft_tpu_torch.fleet.router import _relabel_metrics
from raft_tpu_torch.fleet.worker import FleetWorker, _synth

pytestmark = pytest.mark.fleet

ROWS, DIM, K, NLIST, SEED = 600, 8, 5, 8, 7
# a small warmup: two rungs, one probe count
SERVICE_OPTS = {"delta_cap": 256, "max_batch_rows": 16, "bucket_rungs": [8, 16],
                "nprobe_ladder": [8]}


@pytest.fixture(autouse=True)
def _flight_isolation():
    yield
    flight.reset()


def _http_json(url, body=None, timeout=10.0):
    data = None if body is None else json.dumps(body).encode("utf-8")
    req = urllib.request.Request(url, data=data, method="GET" if body is None else "POST",
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return resp.status, json.loads(resp.read().decode("utf-8"))


# --------------------------------------------------------------------- #
# the wire protocol against the JAX package's
# --------------------------------------------------------------------- #
def _errors(err):
    """The same exceptions built from one package's error classes."""
    return [
        err.ServiceOverloadError("full", 9, 10, tenant="t0", retry_after_s=0.25),
        err.ServiceUnavailableError("x", "svc", "recovering", retry_after_s=1.0),
        err.CommTimeoutError("late"),
        err.CommError("reset"),
        err.LogicError("bad k"),
        err.DataCorruptionError("crc", "/x/chunk0"),
        ValueError("caller bug"),
        RuntimeError("surprise"),
    ]


def _no_stack(payload):
    """A payload with the message cut before the raising stack, which
    names each package's own frames."""
    out = dict(payload)
    out["message"] = out["message"].split("\nObtained stack trace")[0]
    return out


@pytest.mark.parametrize("case", range(8))
def test_error_round_trip_matches_jax(case):
    theirs, ours = _errors(jerror)[case], _errors(perror)[case]
    (jstatus, jpayload), (status, payload) = (jprotocol.error_response(theirs),
                                              protocol.error_response(ours))
    assert status == jstatus
    assert _no_stack(payload) == _no_stack(jpayload)
    jback, back = jprotocol.decode_error(jpayload), protocol.decode_error(payload)
    assert type(back).__name__ == type(jback).__name__
    assert isinstance(back, perror.RaftError)
    # a JAX worker's payload decodes to the port's class of that name
    assert type(protocol.decode_error(jpayload)) is type(back)
    for attr in ("retry_after_s", "queue_depth", "queue_cap", "tenant", "service", "reason"):
        assert getattr(back, attr, None) == getattr(jback, attr, None), attr


def test_garbled_body_raises_typed_comm_error():
    def garbled(method, url, body, timeout):
        return 200, b"\xff\xfenot json"

    with pytest.raises(perror.CommError):
        protocol.get_json("http://x/info", timeout=1.0, transport=garbled)


def test_rendezvous_matches_jax_under_roster_growth():
    nodes = ["w0", "w1", "w2"]
    keys = [str(i) for i in range(500)]
    for roster in (nodes, nodes + ["w3"], ["w1", "w3"]):
        assert [protocol.rendezvous(k, roster) for k in keys] == \
            [jprotocol.rendezvous(k, roster) for k in keys]
        assert [protocol.rendezvous_rank(k, roster) for k in keys[:50]] == \
            [jprotocol.rendezvous_rank(k, roster) for k in keys[:50]]
    before = {k: protocol.rendezvous(k, nodes) for k in keys}
    moved = [k for k in keys if protocol.rendezvous(k, nodes + ["w3"]) != before[k]]
    assert moved and all(protocol.rendezvous(k, nodes + ["w3"]) == "w3" for k in moved)
    with pytest.raises(perror.ServiceUnavailableError):
        protocol.rendezvous("k", [])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_merge_topk_matches_jax(seed):
    rng = np.random.default_rng(seed)
    parts = []
    for s in range(3):
        d = np.sort(rng.integers(0, 6, (4, K)).astype(np.float32) / 4, axis=1)
        i = rng.integers(0, 1000, (4, K)) + 1000 * s
        d[s % 4, -2:], i[s % 4, -2:] = np.inf, -1
        parts.append((d.tolist(), i.tolist()))
    for k in (1, 3, K):
        assert protocol.merge_topk(parts, k) == jprotocol.merge_topk(parts, k)


def test_trace_frames_match_jax():
    for obj in ("flt-1", {"id": "flt-2", "parent": "router", "sent_at": 3.25}, {"x": 1}, 7,
                None):
        assert protocol.parse_trace(obj) == jprotocol.parse_trace(obj)
    frame = protocol.trace_frame("a", "b", 1.0000004)
    assert frame == jprotocol.trace_frame("a", "b", 1.0000004)


# --------------------------------------------------------------------- #
# chaos and relabelling against the JAX package's
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("seed", [3, 11, 12])
def test_chaos_schedule_matches_jax(seed):
    for n_workers in (2, 3):
        ours = chaos.ChaosSchedule.from_seed(seed, duration_s=10.0, n_workers=n_workers)
        theirs = jchaos.ChaosSchedule.from_seed(seed, duration_s=10.0, n_workers=n_workers)
        assert ours.events == theirs.events and ours.events


def _frame_run(mod):
    sent = []

    def base(method, url, body, timeout):
        sent.append(url)
        return 200, b'{"ok": true}'

    ff = mod.FrameFaults(5, base=base)
    out = []
    ff.arm(drop_p=0.4, garble_p=0.4, duration_s=600.0)
    for i in range(40):
        url = "http://w/%s" % ("insert" if i % 3 == 0 else "search")
        try:
            out.append(ff("POST", url, b"{}", 1.0)[1])
        except Exception as e:  # noqa: BLE001 — the typed drop is the outcome
            out.append(type(e).__name__)
    return out, sent, dict(ff.injected)


def test_frame_faults_match_jax():
    ours, theirs = _frame_run(chaos), _frame_run(jchaos)
    assert ours == theirs
    assert ours[2]["drop"] > 0 and ours[2]["garble"] > 0


def test_relabel_metrics_matches_jax():
    text = ("# HELP m demo\n# TYPE m counter\n"
            "m{service=\"a\"} 1\nm_plain 2\n\xff garbled {\n"
            "q{le=\"0.5\",x=\"a\\\"b\"} 3.5\n")
    seen, jseen = set(), set()
    for worker in ("w0", "w1", 'we"ird\\'):
        assert _relabel_metrics(text, worker, seen) == j_relabel(text, worker, jseen)
    assert seen == jseen


def test_synth_matches_jax():
    for clusters in (0, 4):
        assert np.array_equal(_synth(300, 8, 5, clusters), j_synth(300, 8, 5, clusters))


# --------------------------------------------------------------------- #
# the trace join and the clock-offset estimate, on fake clocks
# --------------------------------------------------------------------- #
def _router_events(rid, t0=100.0, worker="w0", server_s=0.008, terminal="fleet_resolved"):
    return [
        {"ts": t0, "kind": "fleet_admitted", "service": "fleet", "rid": rid},
        {"ts": t0 + 0.001, "kind": "fleet_rpc_send", "service": "fleet", "rid": rid,
         "worker": worker, "attempt": 0},
        {"ts": t0 + 0.012, "kind": "fleet_rpc_recv", "service": "fleet", "rid": rid,
         "worker": worker, "attempt": 0, "elapsed_s": 0.011, "server_s": server_s,
         "network_s": 0.011 - server_s},
        {"ts": t0 + 0.013, "kind": terminal, "service": "fleet", "rid": rid},
    ]


def _worker_payload(rid, wid, clock_t0, server_s=0.008, extra_terminal=False):
    events = [
        {"ts": clock_t0, "kind": "admitted", "service": "ann", "trace_id": 1},
        {"ts": clock_t0 + server_s * 0.5, "kind": "batch_formed", "service": "ann",
         "traces": [1]},
        {"ts": clock_t0 + server_s, "kind": "resolved", "service": "ann", "trace_id": 1},
    ]
    if extra_terminal:
        events.append({"ts": clock_t0 + 0.02, "kind": "resolved", "service": "ann",
                       "trace_id": 1})
    return {"fleet": rid, "worker_id": wid, "generation": 1, "now": clock_t0 + 1.0,
            "traces": [{"trace_id": 1, "service": "ann", "tenant": None, "events": events}]}


JOIN_CASES = {
    "aligned": (lambda: _router_events("r1"),
                lambda: {"w0": {"offset_s": 50.0, "rtt_s": 0.002,
                                "payload": _worker_payload("r1", "w0", 50.003)}}),
    "misaligned": (lambda: _router_events("r2"),
                   lambda: {"w0": {"offset_s": 50.08, "rtt_s": 0.002,
                                   "payload": _worker_payload("r2", "w0", 50.003)}}),
    "double_terminal": (lambda: _router_events("r3") + [
        {"ts": 100.014, "kind": "fleet_resolved", "service": "fleet", "rid": "r3"}],
        lambda: {"w0": {"offset_s": 0.0, "rtt_s": 0.002,
                        "payload": _worker_payload("r3", "w0", 100.003, extra_terminal=True)}}),
    "partial": (lambda: _router_events("r4"),
                lambda: {"w0": {"offset_s": 0.0, "rtt_s": 0.0, "payload": None}}),
}


@pytest.mark.parametrize("case", sorted(JOIN_CASES))
def test_trace_join_matches_jax(case):
    events, workers = JOIN_CASES[case]
    rid = events()[0]["rid"]
    ours = tracing.join(rid, events(), workers())
    theirs = jtracing.join(rid, events(), workers())
    assert ours == theirs
    assert tracing.validate(ours) == jtracing.validate(theirs)
    if case in ("aligned", "partial"):
        assert tracing.validate(ours) == []
        if case == "aligned":
            assert tracing.hop_segments(ours) == jtracing.hop_segments(theirs)
    else:
        assert tracing.validate(ours)


def test_local_payload_matches_jax():
    """A worker's half of the join, from each package's default recorder:
    the same payload but for the event times (each process's clock)."""
    from raft_tpu.core import flight as jflight

    payloads = []
    for fl, mod in ((flight, tracing), (jflight, jtracing)):
        rec = fl.default_recorder()
        with fl.trace_context({"id": "flt-x", "parent": "router"}):
            tr = rec.new_trace("ann", "t0")
        rec.record("admitted", service="ann", trace=tr)
        rec.record("resolved", service="ann", trace=tr)
        p = mod.local_payload("flt-x", worker_id="w0", generation=2, clock=lambda: 9.0)
        for t in p["traces"]:
            t.pop("trace_id")
            for ev in t["events"]:
                for key in ("ts", "trace_id"):
                    ev.pop(key, None)
            t.pop("duration_s", None)
        payloads.append(p)
        fl.reset()
    assert payloads[0] == payloads[1]
    assert payloads[0]["traces"] and payloads[0]["now"] == 9.0


def test_clock_offset_estimate_matches_jax():
    spec = {"worker_id": "w0", "router_url": "http://127.0.0.1:1"}
    ours, theirs = FleetWorker(spec), JaxFleetWorker(spec)
    rng = random.Random(4)
    t = 1000.0
    for _ in range(30):
        rtt = rng.choice([0.001, 0.002, 0.02, 0.0015])
        router_now = t + 40.0 + rtt / 2 + rng.uniform(-1e-4, 1e-4)
        for w in (ours, theirs):
            w._note_clock(router_now, t, t + rtt)
        assert (ours._clock_offset, ours._clock_rtt) == (theirs._clock_offset,
                                                         theirs._clock_rtt)
        t += 0.5
    assert abs(ours._clock_offset - 40.0) < 0.002
    for bad in (None, "x"):
        ours._note_clock(bad, 0.0, 1.0)
    assert abs(ours._clock_offset - 40.0) < 0.002


# --------------------------------------------------------------------- #
# a live CPU fleet
# --------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def fleet(tmp_path_factory):
    """Two sharded worker processes at 600 x 8, on the CPU."""
    root = tmp_path_factory.mktemp("torch_fleet")
    f = Fleet(2, root=str(root), index_rows=ROWS, dim=DIM, k=K, seed=SEED, clusters=4,
              nlist=NLIST, nprobe=NLIST, service_opts=SERVICE_OPTS, device="cpu")
    try:
        f.wait_ready(timeout=60.0)
        yield f
    finally:
        f.close()
        for m in f._members.values():
            assert m.proc is None or m.proc.poll() is not None, "a worker outlived close()"


def _worker_merge(fleet, vectors):
    """The merge of each worker's own /search answer to ``vectors``."""
    parts = []
    for wid, pub in sorted(fleet.router.registry().items()):
        status, out = _http_json("http://127.0.0.1:%d/search" % pub["data_port"],
                                 {"vectors": vectors})
        assert status == 200 and out["worker_id"] == wid
        parts.append((out["distances"], out["ids"]))
    return protocol.merge_topk(parts, K)


def _assert_self_distance(out, vecs):
    """Each row finds itself at distance 0 up to the expanded form's
    float32 rounding, ``|q|^2 + |x|^2 - 2 q.x``: 1e-5 of ``|x|^2``."""
    norms = (vecs.astype(np.float64) ** 2).sum(axis=1)
    for drow, n in zip(out["distances"], norms):
        assert 0.0 <= drow[0] <= 1e-5 * max(1.0, n)


def test_fleet_forms_on_ephemeral_ports(fleet):
    reg = fleet.router.registry()
    assert sorted(reg) == ["w0", "w1"]
    ports = set()
    for wid, pub in reg.items():
        assert pub["state"] == "active" and pub["data_port"] > 0 and pub["ops_port"] > 0
        ports.update((pub["data_port"], pub["ops_port"]))
        status, info = _http_json("http://127.0.0.1:%d/info" % pub["data_port"])
        assert status == 200 and info["worker_id"] == wid and info["pid"] != os.getpid()
        status, cfg = _http_json("http://127.0.0.1:%d/debug/config" % pub["ops_port"])
        assert status == 200 and "fleet_lease_interval_s" in cfg["knobs"]
        # the device profile is the card's: a CPU worker refuses it, typed
        with pytest.raises(urllib.error.HTTPError) as ei:
            _http_json("http://127.0.0.1:%d/debug/profile" % pub["data_port"], {"seconds": 0.1})
        assert ei.value.code == 409
        assert json.loads(ei.value.read().decode("utf-8"))["error"] == "ValueError"
    assert len(ports) == 4


def test_search_fans_out_and_merges_as_the_workers_answer(fleet):
    data = _synth(ROWS, DIM, SEED, 4)
    picks = [3, 117, 240, 511]
    vectors = [data[i].tolist() for i in picks]
    out = fleet.router.search(vectors)
    assert not out["degraded"] and sorted(out["shards_answered"]) == [0, 1]
    for want, row, drow in zip(picks, out["ids"], out["distances"]):
        assert row[0] == want and drow[0] == 0.0 and drow == sorted(drow)
    dists, ids = _worker_merge(fleet, vectors)
    assert out["distances"] == dists and out["ids"] == ids


def test_inserts_acked_and_found(fleet):
    rng = np.random.default_rng(41)
    ids = list(range(50_000, 50_008))
    vecs = rng.standard_normal((8, DIM)).astype(np.float32)
    rep = fleet.router.insert(ids, [v.tolist() for v in vecs])
    assert rep["ok"] and sorted(rep["acked_ids"]) == ids and not rep["errors"]
    out = fleet.router.search([v.tolist() for v in vecs])
    assert [row[0] for row in out["ids"]] == ids
    _assert_self_distance(out, vecs)
    rep = fleet.router.insert([1], [[0.0] * DIM])     # below the base range
    assert not rep["ok"] and any(e.get("error") == "LogicError" for e in rep["errors"])


def test_admission_shed_is_typed(fleet):
    r = fleet.router
    with r._lock:
        saved, r._inflight = r._inflight, r._inflight_cap
    try:
        with pytest.raises(ServiceOverloadError) as ei:
            r.search([[0.0] * DIM])
        assert ei.value.retry_after_s > 0.0
    finally:
        with r._lock:
            r._inflight = saved


def test_aggregated_scrape_and_health(fleet):
    text = fleet.router.fleet_metrics_text()
    for worker in ('worker="router"', 'worker="w0"', 'worker="w1"'):
        assert worker in text
    assert text.count("# TYPE raft_tpu_serve_requests_total") == 1
    ok, payload = fleet.router.fleet_health()
    assert ok and payload["ok"] and set(payload["workers"]) == {"w0", "w1"}
    status, body = _http_json(fleet.router.url + "/fleet/healthz")
    assert status == 200 and body["ok"]
    status, body = _http_json(fleet.router.url + "/debug/snapshot")
    assert status == 200 and body["fleet"]["mode"] == "sharded"
    assert set(body["fleet"]["workers"]) == {"w0", "w1"}
    fleet.router.sentinel.tick(force=True)
    assert "worker_dead/fleet" in fleet.router.sentinel.status()["watches"]


def _wait(cond, timeout, what):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return
        time.sleep(0.05)
    raise TimeoutError(what)


def test_kill_and_rejoin_loses_no_acked_row(fleet):
    router = fleet.router
    rng = np.random.default_rng(17)
    fixed = [v.tolist() for v in _synth(ROWS, DIM, SEED, 4)[:24:3]]
    ids = list(range(60_000, 60_032))
    vecs = rng.standard_normal((32, DIM)).astype(np.float32)
    for at in range(0, 32, 8):
        rep = router.insert(ids[at:at + 8], [v.tolist() for v in vecs[at:at + 8]])
        assert rep["ok"] and sorted(rep["acked_ids"]) == ids[at:at + 8]
    before = router.search(fixed)
    gen_before = router.registry()["w1"]["generation"]
    # every insert above was acknowledged; nothing races the kill
    fleet.kill("w1", signal.SIGKILL)
    _wait(lambda: router.fleet_health()[1]["degraded"], 20.0, "fleet never read degraded")
    fleet.restart("w1")
    _wait(lambda: router.registry()["w1"]["state"] == "active"
          and router.registry()["w1"]["generation"] > gen_before, 45.0, "w1 never rejoined")
    _wait(lambda: not router.fleet_health()[1]["degraded"], 20.0, "fleet never healed")
    restore = router.registry()["w1"]
    assert restore["state"] == "active"
    status, info = _http_json("http://127.0.0.1:%d/info" % restore["data_port"])
    assert info["restore"]["restored"] is True
    for at in (0, 16):            # a request fits one batch: 16 rows
        out = router.search([v.tolist() for v in vecs[at:at + 16]])
        assert [row[0] for row in out["ids"]] == ids[at:at + 16]
        _assert_self_distance(out, vecs[at:at + 16])
    after = router.search(fixed)
    assert after["ids"] == before["ids"] and after["distances"] == before["distances"]


def test_worker_without_cuda_fails_fast(tmp_path):
    """A spec asking for CUDA on a machine without it: the worker exits
    non-zero, and wait_ready raises at once naming the exit code."""
    f = Fleet(1, root=str(tmp_path), index_rows=64, dim=4, k=2, device="cpu", start=False)
    try:
        f._members["w0"].spec.payload["device"] = "cuda"
        f.spawn("w0")
        t0 = time.monotonic()
        with pytest.raises(RaftError, match="w0 exited with code 3") as ei:
            f.wait_ready(timeout=60.0)
        assert time.monotonic() - t0 < 45.0
        assert "torch.cuda.is_available() is False" in str(ei.value)
    finally:
        f.close()
    assert not f.proc_alive("w0")


def test_fleet_asked_for_cuda_raises_before_spawning(tmp_path, monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RaftError, match="CUDA"):
        Fleet(1, root=str(tmp_path), index_rows=64, dim=4, k=2)
    assert not any(p.name.endswith(".log") for p in tmp_path.iterdir())
