"""Port parity of the ops plane and the anomaly sentinel
(raft_tpu_torch.serve.{opsplane,sentinel}) against the JAX package's.

Sentinel parity: the JAX ``AnomalySentinel`` and the port's are fed the
same service-shaped fakes, the same metric observations (each into its
own package's registry) and the same fake-clock steps, one rule at a
time (the rules of ``tests/test_opsplane.py``'s ``TestSentinelRules``,
plus the per-rung latency and the fleet rules).  Every ``status()``,
``active()`` and anomaly flight event must be identical.  The latency
rule is held on a fake clock; the reference's injected-delay test is
not copied (it is load-sensitive in the reference).

Plane parity: a JAX ``OpsPlane`` over a JAX ``ANNService`` and a port
``OpsPlane`` over the port's, both on one index built by the JAX package
(``convert.ivf_flat_index_from_reference``), services threadless on fake
clocks, planes unbound (``start=False``) and read through their handlers.
Then the port's plane over HTTP: lifecycle, bind failure, the 404
listing, the TTL-cached full health, ``Comms.serve_ops`` and
``destroy``, and the WAL's ``FSYNC_HOOK``.
"""

import itertools
import json
import types
import urllib.error
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu import config as jconfig
from raft_tpu.core import flight as jflight
from raft_tpu.core.metrics import default_registry as jregistry
from raft_tpu.core.metrics import parse_prometheus
from raft_tpu.serve import ANNService as JaxANNService
from raft_tpu.serve import OpsPlane as JaxOpsPlane
from raft_tpu.serve import sentinel as jsentinel
from raft_tpu.spatial import ann as jann
from raft_tpu_torch import config
from raft_tpu_torch.comms import Mesh
from raft_tpu_torch.convert import ivf_flat_index_from_reference
from raft_tpu_torch.core import flight
from raft_tpu_torch.core.metrics import default_registry
from raft_tpu_torch.persist import wal
from raft_tpu_torch.serve import ANNService, AnomalySentinel, KNNService, OpsPlane
from raft_tpu_torch.serve import sentinel
from raft_tpu_torch.session import Comms

pytestmark = pytest.mark.ops

_uniq = itertools.count()
JAX = types.SimpleNamespace(config=jconfig, flight=jflight, registry=jregistry,
                            sentinel=jsentinel)
PORT = types.SimpleNamespace(config=config, flight=flight, registry=default_registry,
                             sentinel=sentinel)


def _name(prefix="tops"):
    return "%s%d" % (prefix, next(_uniq))


@pytest.fixture(autouse=True)
def _flight_isolation():
    """Breaches dump black boxes into each package's bounded deque: clear
    both after every test."""
    yield
    flight.reset()
    jflight.reset()


class FakeClock:
    def __init__(self, t=0.0):
        self.t = float(t)

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


class _Dummy:
    """Service-shaped nothing: the sentinel copes with objects exposing
    none of the optional surfaces."""


def _get(url, timeout=10.0):
    """(status, parsed-json-or-text) tolerating non-2xx statuses."""
    try:
        with urllib.request.urlopen(url, timeout=timeout) as resp:
            body, code = resp.read().decode("utf-8"), resp.status
    except urllib.error.HTTPError as e:
        body, code = e.read().decode("utf-8"), e.code
    try:
        return code, json.loads(body)
    except ValueError:
        return code, body


# --------------------------------------------------------------------- #
# sentinel parity: one scenario a rule, run on both packages
# --------------------------------------------------------------------- #
class _Run:
    """One package's side of a scenario: its sentinel, clock and tape."""

    def __init__(self, pkg, name, services, knobs, interval_s=0.0, clock_t=0.0):
        self.pkg, self.name, self.clock = pkg, name, FakeClock(clock_t)
        self.services = services
        with pkg.config.override(**{k: str(v) for k, v in knobs.items()}):
            self.sent = pkg.sentinel.AnomalySentinel(lambda: self.services,
                                                     interval_s=interval_s, clock=self.clock)
        self.tape = []

    def timer(self, metric, **labels):
        return self.pkg.registry().timer(metric, labels=tuple(labels)).labels(**labels)

    def tick(self, force=True):
        ran = self.sent.tick(force=force)
        events = [(e.kind, e.attrs.get("rule")) for e in self.pkg.flight.default_recorder()
                  .events(service=self.name) if e.kind.startswith("anomaly")]
        self.tape.append((ran, self.sent.status(), self.sent.active(), self.sent.degraded(),
                          events))
        return ran


def _exec_latency(run):
    t = run.timer("raft_tpu_serve_exec_seconds", service=run.name)
    run.tick()
    for _ in range(2):
        for _ in range(5):
            t.observe(0.002)
        run.clock.advance(1.0)
        run.tick()
    for _ in range(2):            # a 10x window trips, the next keeps it frozen
        t.observe(0.02)
        run.clock.advance(1.0)
        run.tick()
    for _ in range(5):
        t.observe(0.002)
    run.clock.advance(1.0)
    run.tick()


def _exec_latency_rungs(run):
    rungs = {r: run.timer("raft_tpu_serve_exec_rung_seconds", service=run.name, rung=str(r))
             for r in (8, 32)}
    run.tick()
    for _ in range(3):
        for t in rungs.values():
            for _ in range(4):
                t.observe(0.003)
        run.clock.advance(1.0)
        run.tick()
    rungs[32].observe(0.05)       # one bucket regresses
    rungs[8].observe(0.003)
    run.clock.advance(1.0)
    run.tick()


def _quiet_window(run):
    t = run.timer("raft_tpu_serve_exec_seconds", service=run.name)
    run.tick()
    for _ in range(3):
        t.observe(0.005)
    run.clock.advance(1.0)
    run.tick()
    run.clock.advance(1.0)
    run.tick()


def _queue_depth(run):
    svc = run.services[run.name]
    svc.batcher = types.SimpleNamespace(queue_cap=100, _depth=0)
    svc.batcher.depth = lambda: svc.batcher._depth
    for depth in (0, 80, 81, 3):
        svc.batcher._depth = depth
        run.tick()


def _persist(run):
    svc = run.services[run.name]
    st = {"wal_records": 0, "snapshot_age_s": 1.0, "snapshot_interval_s": 30.0,
          "snapshot_stale": False, "corruption_detected": False}
    svc._persist = types.SimpleNamespace(stats=lambda: dict(st))
    run.tick()
    st.update(wal_records=51, corruption_detected=True, snapshot_stale=True)
    run.tick()
    st.update(wal_records=2, corruption_detected=False, snapshot_stale=False)
    run.tick()


def _slo_burn(run):
    tracker = run.pkg.flight.slo_for(run.name, target_s=0.01, objective=0.9,
                                     windows_s=(60.0,), clock=run.clock)
    run.services[run.name].slo = tracker
    for _ in range(10):
        tracker.observe("default", 0.001)
    run.tick()
    for _ in range(10):
        tracker.observe("default", 0.5)
    run.tick()


def _tile_stall(run):
    h2d = run.timer("raft_tpu_h2d_seconds", pool=run.name)
    stall = run.timer("raft_tpu_h2d_stall_seconds", pool=run.name)
    h2d.observe(1.0)
    stall.observe(0.9)
    run.tick()                    # first sighting: cursor only
    h2d.observe(1.0)
    stall.observe(0.9)
    run.tick()
    h2d.observe(1.0)
    stall.observe(0.1)
    run.tick()


def _fleet(run):
    st = {"workers_dead": 0, "last_rejoin": None}
    run.services[run.name].fleet_stats = lambda: dict(st)
    run.tick()
    st["workers_dead"] = 1
    run.tick()
    st.update(workers_dead=0, last_rejoin={"replayed_records": 10, "restore_s": 2.0,
                                           "age_s": 1.0})
    run.tick()                    # 200 ms a record > 50: rejoin_lag trips
    st["last_rejoin"] = {"replayed_records": 10, "restore_s": 2.0, "age_s": 30.0}
    run.tick()                    # aged past the hold: clears


def _fleet_network(run):
    run.services[run.name].fleet_stats = lambda: {"workers_dead": 0}
    t = run.timer("raft_tpu_fleet_network_seconds", worker=run.name + "w0")
    run.tick()
    for _ in range(3):
        for _ in range(4):
            t.observe(0.001)
        run.clock.advance(1.0)
        run.tick()
    t.observe(0.01)
    run.clock.advance(1.0)
    run.tick()


def _rate_limit(run):
    run.sent._interval = 10.0
    run.tick(force=False)
    run.tick(force=False)         # inside the interval: no evaluation
    run.clock.advance(11.0)
    run.tick(force=False)
    run.pkg.sentinel.register(run.sent)
    try:
        run.pkg.sentinel.poke()   # rate-limited: a no-op
        run.tick(force=False)
        run.clock.advance(11.0)
        run.pkg.sentinel.poke()
        run.tape.append(run.sent.status()["ticks"])
    finally:
        run.pkg.sentinel.unregister(run.sent)


SCENARIOS = {
    "exec_latency": (_exec_latency, dict(ops_sentinel_min_samples=5,
                                         ops_sentinel_latency_factor=3)),
    "exec_latency_rungs": (_exec_latency_rungs, dict(ops_sentinel_min_samples=4)),
    "quiet_window": (_quiet_window, dict(ops_sentinel_min_samples=2)),
    "queue_depth": (_queue_depth, dict(ops_sentinel_queue_frac=0.5)),
    "persist": (_persist, dict(ops_sentinel_wal_records=50)),
    "slo_burn": (_slo_burn, dict(ops_sentinel_min_samples=5, ops_sentinel_burn=2)),
    "tile_stall": (_tile_stall, dict(ops_sentinel_stall_frac=0.5)),
    "fleet": (_fleet, dict(ops_sentinel_rejoin_ms_per_record=50,
                           ops_sentinel_rejoin_hold_s=10)),
    "fleet_network": (_fleet_network, dict(ops_sentinel_min_samples=4)),
    "rate_limit": (_rate_limit, {}),
}


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_sentinel_transitions_match_jax(scenario):
    fn, knobs = SCENARIOS[scenario]
    name = _name("sent")
    runs = []
    for pkg in (JAX, PORT):
        run = _Run(pkg, name, {name: _Dummy()}, knobs, clock_t=100.0)
        fn(run)
        runs.append(run)
    assert runs[1].tape == runs[0].tape
    # every scenario but the quiet and rate-limited ones breaches something
    if scenario not in ("quiet_window", "rate_limit"):
        assert any(step[3] for step in runs[1].tape), "no breach in %s" % scenario


def test_sentinel_counts_a_broken_services_fn():
    counts = []
    for pkg in (JAX, PORT):
        def boom():
            raise RuntimeError("broken registry")

        sent = pkg.sentinel.AnomalySentinel(boom, interval_s=0.0, clock=FakeClock())
        before = pkg.registry().family_total("raft_tpu_ops_sentinel_errors_total")
        assert sent.tick(force=True) is True
        counts.append(pkg.registry().family_total("raft_tpu_ops_sentinel_errors_total")
                      - before)
    assert counts == [1, 1]


def test_breach_records_counter_gauge_and_blackbox():
    name = _name("sent")
    run = _Run(PORT, name, {name: _Dummy()}, dict(ops_sentinel_queue_frac=0.5))
    run.services[name].batcher = types.SimpleNamespace(queue_cap=10, depth=lambda: 9)
    before = default_registry().family_total("raft_tpu_anomaly_total")
    boxes = len(flight.default_recorder().blackboxes())
    run.tick()
    run.tick()
    assert default_registry().family_total("raft_tpu_anomaly_total") == before + 1
    assert len(flight.default_recorder().blackboxes()) == boxes + 1
    gauge = {tuple(sorted(lbls.items())): s.value for lbls, s in
             default_registry().get("raft_tpu_anomaly_active").series()}
    assert gauge[(("rule", "queue_depth"), ("service", name))] == 1


def test_serve_worker_pokes_the_sentinel():
    """ServeWorker.run_maintenance ticks every registered sentinel."""
    rng = np.random.default_rng(3)
    svc = KNNService(torch.from_numpy(rng.standard_normal((64, 8)).astype(np.float32)), k=3,
                     start=False, device="cpu", name=_name("poke"))
    sent = AnomalySentinel(lambda: {svc.name: svc}, interval_s=0.0, clock=FakeClock())
    sentinel.register(sent)
    try:
        svc.worker.run_maintenance()
        svc.worker.run_maintenance()
        assert sent.status()["ticks"] == 2
    finally:
        sentinel.unregister(sent)
        svc.close()
    svc2 = KNNService(torch.zeros((8, 8)), k=1, start=False, device="cpu", name=_name("poke"))
    svc2.worker.run_maintenance()     # nothing registered: a no-op
    assert sent.status()["ticks"] == 2
    svc2.close()


# --------------------------------------------------------------------- #
# plane parity over one index
# --------------------------------------------------------------------- #
DIM, K = 16, 5
SVC_KW = dict(max_batch_rows=16, bucket_rungs=(8, 16), max_wait_ms=1.0, nprobe_ladder=(4,),
              delta_cap=32, compact_rows=0)


@pytest.fixture(scope="module")
def data():
    return np.random.default_rng(11).standard_normal((500, DIM)).astype(np.float32)


@pytest.fixture(scope="module")
def jindex(data):
    return jann.ivf_flat_build(jnp.asarray(data, jnp.float32),
                               jann.IVFFlatParams(nlist=8, nprobe=4), seed=1)


@pytest.fixture
def planes(data, jindex):
    """A JAX plane over a JAX service and a port plane over the port's,
    one name, each service stepped once on its fake clock."""
    name = _name("svc")
    jclock, clock = FakeClock(), FakeClock()
    jsvc = JaxANNService(jindex, k=K, start=False, clock=jclock, name=name, **SVC_KW)
    psvc = ANNService(ivf_flat_index_from_reference(jindex, device="cpu"), K, start=False,
                      clock=clock, device="cpu", name=name, **SVC_KW)
    for svc, c in ((jsvc, jclock), (psvc, clock)):
        fut = svc.submit(data[:3])
        c.advance(1.0)
        assert svc.worker.run_once()
        fut.result(timeout=0)
    jp = JaxOpsPlane(services={name: jsvc}, start=False, clock=jclock)
    pp = OpsPlane(services={name: psvc}, start=False, clock=clock)
    yield name, jp, pp
    for obj in (jp, pp, jsvc, psvc):
        obj.close()


def _body(ep):
    code, body, _ = ep
    return code, json.loads(body)


def test_statusz_keys_match_jax(planes):
    name, jp, pp = planes
    (jcode, jbody), (code, body) = _body(jp._ep_statusz({})), _body(pp._ep_statusz({}))
    assert code == jcode == 200
    assert set(body) == set(jbody)
    assert set(body["sentinel"]) == set(jbody["sentinel"])
    assert set(body["inventory"]) == set(jbody["inventory"])
    assert set(body["flight"]) == set(jbody["flight"])
    assert body["tuning_table"] is None
    assert name in body["services"] and name in jbody["services"]


def test_metrics_serving_families_match_jax(planes):
    name, jp, pp = planes

    def families(plane):
        code, text, ctype = plane._ep_metrics({})
        assert code == 200 and ctype.startswith("text/plain")
        return {k for k, series in parse_prometheus(text).items()
                if k.startswith("raft_tpu_serve_")
                and any(dict(lbls).get("service") == name for lbls in series)}

    ours, theirs = families(pp), families(jp)
    assert ours
    # the JAX per-executable device timer keys on profiled_jit names, which
    # the port does not have (serve/scheduler.py's module doc)
    device_timer = {k for k in theirs if k.startswith("raft_tpu_serve_device_seconds")}
    assert ours == theirs - device_timer


def test_healthz_verdicts_match_jax(planes):
    name, jp, pp = planes
    (jcode, jbody), (code, body) = _body(jp._ep_healthz({})), _body(pp._ep_healthz({}))
    assert (code, body) == (jcode, jbody)
    assert body["ok"] is True and body["services"][name]["breaker"] == "closed"
    for plane in (jp, pp):        # an open breaker fails both the same way
        plane._services()[name].breaker.trip()
    (jcode, jbody), (code, body) = _body(jp._ep_healthz({})), _body(pp._ep_healthz({}))
    assert (code, body) == (jcode, jbody)
    assert code == 503 and body["services"][name]["breaker"] == "open"


def test_debug_config_ops_and_fleet_knobs_match_jax(planes, monkeypatch):
    _, jp, pp = planes
    monkeypatch.setenv("RAFT_TPU_FLEET_RETRY_MAX", "7")
    with jconfig.override(ops_sentinel_burn="4"), config.override(ops_sentinel_burn="4"):
        (_, jbody), (_, body) = _body(jp._ep_config({})), _body(pp._ep_config({}))
    names = {k for k in jbody["knobs"] if k.startswith(("ops_", "fleet_"))}
    assert len(names) == 17
    assert {k: body["knobs"][k] for k in names} == {k: jbody["knobs"][k] for k in names}
    assert body["knobs"]["ops_sentinel_burn"] == {"value": "4", "layer": "override"}
    assert body["knobs"]["fleet_retry_max"] == {"value": "7", "layer": "env"}
    assert body["knobs"]["fleet_hedge_ms"] == {"value": "100", "layer": "default"}
    assert body["tuning_table"] is None
    assert {k: config.knob_default(k) for k in names} == \
        {k: jconfig.knob_default(k) for k in names}


def test_statusz_and_config_report_an_installed_table(planes):
    """With a table installed, ``/statusz`` and ``/debug/config`` carry
    ``config.tuning_table_info()`` as the JAX plane does; cleared, None."""
    from raft_tpu_torch.core import tuning

    _, _, pp = planes
    table = {"version": 1, "fingerprint": tuning.backend_fingerprint(), "entries": [
        {"op": "select_k", "knob": "select_impl", "shape_class": "*", "dtype": "*",
         "winner": "sort"},
        {"op": "csr_spmv", "knob": "spmv_impl", "shape_class": "*", "dtype": "*",
         "winner": "segment"}]}
    assert config.install_tuning_table(table, source="<statusz test>")
    try:
        want = config.tuning_table_info()
        assert want == {"source": "<statusz test>", "fingerprint": tuning.backend_fingerprint(),
                        "cells": 2, "knobs": {"select_impl": 1, "spmv_impl": 1}}
        (_, status), (_, conf) = _body(pp._ep_statusz({})), _body(pp._ep_config({}))
        assert status["tuning_table"] == want and conf["tuning_table"] == want
        assert conf["knobs"]["select_impl"] == {"value": "sort", "layer": "table"}
    finally:
        config.clear_tuning_table()
    assert _body(pp._ep_statusz({}))[1]["tuning_table"] is None


def test_config_describe_rungs():
    assert config.describe()["fleet_timeout_s"] == "10"
    config.configure(fleet_timeout_s="3")
    try:
        assert config.describe(layers=True)["fleet_timeout_s"] == {"value": "3",
                                                                   "layer": "configure"}
        with config.override(fleet_timeout_s=None):
            assert config.describe(layers=True)["fleet_timeout_s"]["layer"] == "default"
    finally:
        config.configure(fleet_timeout_s=None)


def test_inventory_and_snapshot_endpoints(planes):
    _, _, pp = planes
    code, body = _body(pp._ep_inventory({}))
    assert code == 200 and set(body) == {"summary", "detail"}
    code, snap = _body(pp._ep_snapshot({}))
    assert code == 200
    assert set(snap) == {"metrics", "kernel_builds", "flight", "inventory"}
    assert set(snap["kernel_builds"]) == {"builds", "loads"}
    code, status = _body(pp._ep_statusz({}))
    for st in status["inventory"]["per_fn"].values():
        assert st["device_mean_s"] is None and st["achieved_gflops_device"] is None


# --------------------------------------------------------------------- #
# the port's plane over HTTP
# --------------------------------------------------------------------- #
@pytest.fixture
def knn_service():
    rng = np.random.default_rng(5)
    svc = KNNService(torch.from_numpy(rng.standard_normal((200, 8)).astype(np.float32)), k=3,
                     max_batch_rows=16, max_wait_ms=1.0, device="cpu", name=_name("knn"))
    svc.warmup()
    yield svc
    svc.close()


def test_lifecycle(knn_service):
    with OpsPlane(services={knn_service.name: knn_service}, port=0) as p:
        url = p.url
        assert p.port > 0 and not p.closed
        code, body = _get(url + "/healthz")
        assert code == 200 and body["services"][knn_service.name]["worker_alive"] is True
        assert _get(url + "/metrics")[0] == 200
        assert _get(url + "/statusz")[0] == 200
    assert p.closed
    p.close()
    with pytest.raises(Exception):
        urllib.request.urlopen(url + "/healthz", timeout=2)


def test_bind_failure_leaks_no_sentinel(knn_service):
    with OpsPlane(services={knn_service.name: knn_service}, port=0) as p:
        with sentinel._reg_lock:
            before = list(sentinel._registered)
        with pytest.raises(OSError):
            OpsPlane(services={knn_service.name: knn_service}, host="127.0.0.1", port=p.port)
        with sentinel._reg_lock:
            assert list(sentinel._registered) == before


def test_unknown_endpoint_404_lists_routes(knn_service):
    with OpsPlane(services={knn_service.name: knn_service}, port=0) as p:
        code, body = _get(p.url + "/nope")
        assert code == 404 and "/metrics" in body["endpoints"]
        code, body = _get(p.url + "/debug/blackbox")
        assert code == 405
        req = urllib.request.Request(p.url + "/debug/blackbox?reason=t", method="POST")
        with urllib.request.urlopen(req, timeout=10) as resp:
            assert json.loads(resp.read().decode("utf-8"))["reason"] == "ops_t"
    endpoints = {lbls["endpoint"] for lbls, _ in
                 default_registry().get("raft_tpu_ops_requests_total").series()}
    assert "unknown" in endpoints and "/nope" not in endpoints


class _FakeSession:
    def __init__(self):
        self.calls = 0
        self.services = {}

    def health_check(self):
        self.calls += 1
        return {"ok": True, "tests": {}, "ranks": {}}


def test_full_health_is_ttl_cached():
    fake = _FakeSession()
    with OpsPlane(session=fake, port=0, healthz_ttl_s=60.0, sentinel=False) as p:
        code, body = _get(p.url + "/healthz?full=1")
        assert code == 200 and body["full"]["ok"] is True
        _get(p.url + "/healthz?full=1")
        _get(p.url + "/healthz")
        assert fake.calls == 1


def test_session_serve_ops_and_destroy():
    mesh = Mesh([torch.device("cpu")] * 2, ("ranks",))
    s = Comms(mesh=mesh).init()
    try:
        svc = s.serve(kind="knn", index=torch.zeros((16, 4)), k=2, max_batch_rows=8)
        svc.warmup()
        plane = s.serve_ops(port=0)
        assert s.ops_plane is plane
        code, body = _get(plane.url + "/statusz")
        assert code == 200 and svc.name in body["services"]
        code, body = _get(plane.url + "/healthz?full=1")
        assert code == 200 and body["full"]["ok"] is True
        assert len(body["full"]["ranks"]) == 2
        with pytest.raises(Exception):
            s.serve_ops(port=0)
        plane.close()
        plane2 = s.serve_ops(port=0)
        url = plane2.url
        assert _get(url + "/healthz")[0] == 200
    finally:
        s.destroy()
    assert s.ops_plane is None
    with pytest.raises(Exception):
        urllib.request.urlopen(url + "/healthz", timeout=2)


def test_fsync_hook_called_per_fsync(tmp_path, monkeypatch):
    calls = []
    monkeypatch.setattr(wal, "FSYNC_HOOK", lambda: calls.append(1))
    log = wal.WriteAheadLog(str(tmp_path / "wal.log"), dim=4, dtype=np.float32, fsync="always")
    before = len(calls)
    for i in range(3):
        log.append(np.arange(i * 2, i * 2 + 2, dtype=np.int64),
                   np.ones((2, 4), np.float32))
    assert len(calls) - before == 3
    log.close()
    monkeypatch.setattr(wal, "FSYNC_HOOK", None)
