"""Replica groups and hedged dispatch in the port
(``raft_tpu_torch.serve.replicas``, ``KNNService(replicas=, hedge_ms=)``)
on meshes of CPU rank slots: the cut of the mesh (against the JAX
``split_mesh``), rotation, per-replica breakers and failover, a hedge
that fires and wins under a delay released by an event (not a wall
clock), loser cancellation, warmup of every replica, and the rebuild of
the groups after a recovery.  Served rows are held bit for bit to the
sharded call on the padded batch (CPU rounding may depend on the row
count).  The workers run threadless."""

import threading

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

from raft_tpu.serve.replicas import split_mesh as jsplit_mesh
from raft_tpu_torch.comms import Mesh, faults
from raft_tpu_torch.core.error import LogicError
from raft_tpu_torch.core.metrics import default_registry
from raft_tpu_torch.serve import (KNNService, RecoveryManager, ReplicaFaultInjector, ReplicaSet,
                                  inject_replica, pad_rows, split_mesh)
from raft_tpu_torch.session import Comms
from raft_tpu_torch.spatial.mnmg_knn import mnmg_knn

CPU = torch.device("cpu")
RUNGS = (8, 32)


def _mesh(n=4):
    return Mesh([CPU] * n, ("ranks",))


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(21)
    return (rng.standard_normal((300, 12)).astype(np.float32),
            rng.standard_normal((6, 12)).astype(np.float32))


def _svc(data, **kw):
    kw.setdefault("mesh", _mesh())
    kw.setdefault("replicas", 2)
    return KNNService(data[0], 5, axis="ranks", merge="ring", max_batch_rows=RUNGS[-1],
                      bucket_rungs=list(RUNGS), max_wait_ms=0.0, start=False, **kw)


def _step(svc, q):
    fut = svc.submit(q)
    assert svc.worker.run_once()
    return fut.result(timeout=5)


def _counter(name, service):
    fam = default_registry().get(name)
    return 0.0 if fam is None else sum(s.value for lbl, s in fam.series()
                                       if lbl.get("service") == service)


def _want(svc, q, r=0):
    """The sharded call of replica r on the padded batch, sliced."""
    m = svc._replica_set.replicas[r].mesh
    d, i = mnmg_knn(svc.index, pad_rows(torch.from_numpy(q), 8), 5, mesh=m, axis="ranks",
                    merge="ring")
    return d[:len(q)], i[:len(q)]


@pytest.mark.parametrize("n,replicas", [(4, 2), (8, 2), (8, 3), (5, 2), (3, 3)])
def test_split_mesh_cuts_like_jax(n, replicas):
    groups = split_mesh(_mesh(n), "ranks", replicas)
    jgroups = jsplit_mesh(JMesh(np.array(jax.devices()[:n]), ("ranks",)), "ranks", replicas)
    assert [g.rank_ids() for g in groups] == [tuple(int(d.id) for d in j.devices.ravel())
                                              for j in jgroups]


def test_split_mesh_refusals():
    with pytest.raises(LogicError, match="1-D"):
        split_mesh(Mesh(np.array([CPU] * 4, dtype=object).reshape(2, 2), ("ranks", "x")),
                   "ranks", 2)
    with pytest.raises(LogicError, match="need >= 2"):
        split_mesh(_mesh(), "ranks", 1)
    with pytest.raises(LogicError, match="cannot host"):
        split_mesh(_mesh(2), "ranks", 3)


def test_replicas_rotate_and_answer_alike(data):
    svc = _svc(data)
    _, q = data
    outs = [_step(svc, q) for _ in range(4)]
    want = _want(svc, q)
    for d, i in outs:
        assert torch.equal(d, want[0]) and torch.equal(i, want[1])
    assert torch.equal(_want(svc, q, 1)[1], want[1])
    lat = svc._replica_set.tracker.per_replica()
    assert sorted(lat) == [0, 1] and all(v[8]["samples"] == 2 for v in lat.values())
    assert svc.replica_rank_ids() == {0, 1, 2, 3}
    desc = svc.stats()["replicas"]
    assert [r["ranks"] for r in desc["replicas"]] == [[0, 1], [2, 3]]
    assert desc["hedge_ms"] is None and svc.mesh is None
    svc.close()


def test_warmup_warms_every_replica(data):
    svc = _svc(data)
    calls = {0: 0, 1: 0}
    for rep in svc._replica_set.replicas:
        orig = rep.execute

        def counting(padded, orig=orig, idx=rep.idx):
            calls[idx] += 1
            return orig(padded)

        rep.execute = counting
    svc.warmup()
    assert calls == {0: len(RUNGS), 1: len(RUNGS)}
    assert svc.kernel_libraries_after_warmup() == {"builds": 0, "loads": 0}
    svc.close()


def test_failing_replica_fails_over_then_drops_out(data):
    svc = _svc(data, name="torch-rep-failover")
    _, q = data
    want = _want(svc, q)
    with inject_replica(svc, 0, faults.FailNth(1, persistent=True)) as log:
        outs = [_step(svc, q) for _ in range(12)]
    for d, i in outs:
        assert torch.equal(d, want[0]) and torch.equal(i, want[1])
    failovers = _counter("raft_tpu_serve_replica_failovers_total", svc.name)
    assert failovers >= 1 and len(log.injected) == failovers
    assert svc._replica_set.replicas[0].breaker.state.name == "OPEN"
    assert svc.stats()["replicas"]["replicas"][0]["state"] == "open"
    svc.close()


def test_hedge_fires_and_wins_under_an_event_released_delay(data):
    svc = _svc(data, hedge_ms=250.0, name="torch-rep-hedge")
    _, q = data
    want = _want(svc, q)
    gate = threading.Event()
    dispatched = []
    rep1 = svc._replica_set.replicas[1]
    orig = rep1.execute

    def counting(padded):
        dispatched.append(1)
        return orig(padded)

    rep1.execute = counting
    try:
        with inject_replica(svc, 1, faults.Delay(0.0, sleep=lambda s: gate.wait(10))):
            first = _step(svc, q)          # replica 0 is the primary
            names = ("hedges", "hedge_wins", "hedge_cancelled")
            before = {n: _counter("raft_tpu_serve_%s_total" % n, svc.name) for n in names}
            second = _step(svc, q)         # replica 1 stalls: the hedge to replica 0 wins
            fired = {n: _counter("raft_tpu_serve_%s_total" % n, svc.name) - before[n]
                     for n in names}
    finally:
        gate.set()                         # the abandoned loser wakes and bails
    for d, i in (first, second):
        assert torch.equal(d, want[0]) and torch.equal(i, want[1])
    assert fired == {"hedges": 1, "hedge_wins": 1, "hedge_cancelled": 1}
    for _ in range(100):                   # the loser's thread: bounded wait
        if _counter("raft_tpu_serve_replica_errors_total", svc.name) >= 1:
            break
        threading.Event().wait(0.01)
    assert dispatched == []                # it never reached the replica's execute
    svc.close()


def test_adaptive_threshold_needs_samples(data):
    svc = _svc(data, hedge_ms=0.0)
    rs = svc._replica_set
    assert rs.hedge_s is None and rs.hedge_after(8) is None
    for _ in range(5):
        rs.tracker.observe(8, 0.002, replica=0)
    assert rs.hedge_after(8) == pytest.approx(max(1.5 * 0.002, 0.010))
    svc.close()


def test_replica_arguments_refused(data):
    with pytest.raises(LogicError, match="need >= 2"):
        _svc(data, replicas=1)
    plain = KNNService(data[0], 3, device="cpu", start=False)
    with pytest.raises(LogicError, match="not replicated"):
        ReplicaFaultInjector(plain, 0, [])
    with pytest.raises(LogicError, match="not built with replicas"):
        plain.rebuild_replicas()
    plain.close()
    svc = _svc(data)
    with pytest.raises(LogicError, match="out of range"):
        with inject_replica(svc, 2, faults.FailNth(1)):
            pass
    with pytest.raises(LogicError, match="need >= 2"):
        ReplicaSet("x", [(None, None)], hedge_s=None, hedge_factor=1.5, hedge_min_s=0.01)
    svc.close()


def test_rebuild_replicas_degrades_and_regrows(data):
    svc = _svc(data)
    _, q = data
    want = _want(svc, q)
    assert svc.rebuild_replicas(mesh=_mesh(1)) is True
    assert svc._replica_set is None and svc.stats()["shard_devices"] == 1
    assert torch.equal(_step(svc, q)[1], want[1])
    assert svc.rebuild_replicas(mesh=_mesh(6)) is True
    assert len(svc._replica_set.replicas) == 2 and svc.replica_rank_ids() == set(range(6))
    svc.warmup()
    assert torch.equal(_step(svc, q)[1], want[1])
    svc.close()


def test_session_recovery_recuts_the_replica_groups(data):
    _, q = data
    with Comms(mesh=_mesh(4)) as s:
        svc = s.serve("knn", index=data[0], k=5, replicas=2, axis="ranks", merge="ring",
                      max_batch_rows=RUNGS[-1], bucket_rungs=list(RUNGS), max_wait_ms=0.0,
                      start=False)
        want = _want(svc, q)
        assert s.health_check()["services"][svc.name]["mesh_ok"]
        s.comms.abort()
        s.recover(devices=[0, 2, 3])
        assert s.health_check()["services"][svc.name]["mesh_ok"] is False
        RecoveryManager(s).recover(recover_comms=False)
        assert [r.mesh.rank_ids() for r in svc._replica_set.replicas] == [(0, 2), (3,)]
        assert s.health_check()["ok"]
        out = _step(svc, q)
        assert torch.equal(out[0], want[0]) and torch.equal(out[1], want[1])
