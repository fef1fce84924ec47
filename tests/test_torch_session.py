"""The port's session (raft_tpu_torch.session) on meshes of CPU rank slots:
the lifecycle, the registry, ``worker_info``, ``health_check`` with a
lost rank, ``recover`` on a shrunk mesh (the self-tests pass there), the
ops plane, and the serving recovery sequence (:class:`RecoveryManager`),
beside the JAX package's session on its 8 virtual devices where the two
answer the same question."""

import json

import numpy as np
import pytest
import torch

from raft_tpu.comms import Op as JOp
from raft_tpu.session import Comms as JComms
from raft_tpu_torch.comms import HostComms, Mesh, Op, faults, selftest
from raft_tpu_torch.core import tracing
from raft_tpu_torch.core.error import CommAbortedError, LogicError
from raft_tpu_torch.core.handle import Handle
from raft_tpu_torch.serve import KNNService, RecoveryManager
from raft_tpu_torch.session import (Comms, Session, _sessions, get_raft_comm_state,
                                    local_handle, metrics_snapshot)

CPU = torch.device("cpu")


def _mesh(n=8, axes=("ranks",), shape=None):
    arr = np.array([CPU] * n, dtype=object)
    return Mesh(arr.reshape(shape) if shape else arr, axes)


def test_lifecycle_and_registry():
    c = Comms(mesh=_mesh()).init()
    assert c.initialized and Session is Comms
    st = get_raft_comm_state(c.sessionId)
    assert st["nworkers"] == 8 and st["comms"] is c.comms
    h = local_handle(c.sessionId)
    assert h.comms_initialized() and h.mesh is c.comms.mesh and h.device == CPU
    c.destroy()
    assert get_raft_comm_state(c.sessionId) == {} and c.sessionId not in _sessions
    c.destroy()                                   # idempotent
    with pytest.raises(LogicError):
        local_handle("nope")


def test_context_manager_runs_a_collective_like_jax():
    x = np.arange(8, dtype=np.float32).reshape(8, 1)
    with JComms() as jc:
        want = np.asarray(jc.comms.allreduce(x, JOp.SUM))
    with Comms(mesh=_mesh()) as c:
        out = local_handle(c.sessionId).get_comms().allreduce(x, Op.SUM)
        np.testing.assert_array_equal(out.numpy(), want)
    assert not c.initialized


def test_default_mesh_of_the_cpu():
    with Comms(device="cpu") as c:
        assert c.comms.get_size() == 1 and c.handle.device == CPU


def test_worker_info_keys_ranks_by_id():
    with Comms(mesh=_mesh()) as c:
        info = c.worker_info()
        assert sorted(info) == list(range(8))
        assert sorted(v["rank"] for v in info.values()) == list(range(8))
        assert list(c.worker_info(workers=[3])) == [3]
        assert all(v["device"] == "cpu" and v["platform"] == "cpu" and v["process_index"] == 0
                   for v in info.values())


def test_worker_info_2d_mesh_ranks_in_comms_space():
    with Comms(mesh=_mesh(8, ("ranks", "aux"), (2, 4))) as c:
        info = c.worker_info()
        assert sorted(v["rank"] for v in info.values()) == [0] * 4 + [1] * 4
        assert all(v["mesh_coords"]["ranks"] == v["rank"] for v in info.values())
        assert c.comms.get_size() == 2


def test_health_check_flags_a_lost_rank_and_recover_drops_it():
    with Comms(mesh=_mesh()) as s:
        ok = s.health_check()
        assert ok["ok"] and all(ok["tests"].values()) and all(ok["ranks"].values())
        old = s.comms
        extra = s.register_handle(Handle(device="cpu"))
        with faults.inject(s.comms, faults.Abort(rank=5)):
            health = s.health_check()
            assert not health["ok"] and not any(health["tests"].values())
            assert health["ranks"] == {r: r != 5 for r in range(8)}
            with pytest.raises(CommAbortedError):
                s.comms.allreduce(np.ones((8, 1), np.float32))
            before = tracing.get_counter("comms.recover")
            fresh = s.recover()                       # probes: rank 5 is left out
        assert tracing.get_counter("comms.recover") == before + 1
        assert fresh is not old and fresh.mesh.rank_ids() == (0, 1, 2, 3, 4, 6, 7)
        assert s.handle.get_comms() is fresh and extra.get_comms() is fresh
        assert all(selftest.run_all(fresh).values())
        assert s.health_check()["ok"]


def test_recover_on_a_shrunk_mesh_passes_selftests():
    with Comms(mesh=_mesh(), retry_policy=None) as s:
        s.comms.abort()
        fresh = s.recover(devices=[0, 1, 2, 3])
        assert fresh.get_size() == 4 and not fresh.aborted
        results = selftest.run_all(fresh)
        assert results and all(results.values())
        ranks = list(fresh.mesh.ranks.ravel())
        again = s.recover(devices=ranks[:2])          # Rank objects of the session mesh
        assert again.mesh.rank_ids() == (0, 1)


def test_recover_rejects_foreign_ranks():
    class FakeDevice:
        id = 999

    class Impostor:
        id = 0

    with Comms(mesh=_mesh(4)) as s:
        for bad in (FakeDevice(), Impostor(), 7, _mesh(4).ranks[0], CPU):
            with pytest.raises(LogicError):
                s.recover(devices=[bad])


def test_recover_multiaxis_mesh_requires_explicit_mesh():
    m = _mesh(8, ("ranks", "aux"), (4, 2))
    with Comms(mesh=m) as s:
        s.comms.abort()
        with pytest.raises(LogicError, match="pass the replacement mesh"):
            s.recover()
        sub = Mesh(m.ranks[:2], ("ranks", "aux"))
        with pytest.raises(LogicError, match="not both"):
            s.recover(devices=[0], mesh=sub)
        fresh = s.recover(mesh=sub)
        assert fresh.get_size() == 2 and s.handle.mesh.axis_names == ("ranks", "aux")
        assert (fresh.allreduce(np.ones((2, 1), np.float32)).numpy() == 2).all()


def test_health_check_leaves_user_p2p_queue_alone():
    with Comms(mesh=_mesh()) as s:
        send = s.comms.isend(torch.ones(2), rank=0, dest=1, tag=42)
        recv = s.comms.irecv(rank=1, source=0, tag=42)
        assert s.health_check()["ok"]
        assert send in s.comms._requests and recv in s.comms._requests
        s.comms.waitall()
        assert (recv.result == 1.0).all()


def test_ops_plane_names_item_7():
    """Item 7 ported the ops plane: ``serve_ops`` starts one over the
    session, and ``destroy`` closes it."""
    with Comms(mesh=_mesh(2)) as s:
        assert s.ops_plane is None
        plane = s.serve_ops(port=0)
        assert s.ops_plane is plane and not plane.closed and plane.port > 0
    assert plane.closed and s.ops_plane is None


def test_metrics_snapshot_and_dump(tmp_path):
    with Comms(mesh=_mesh(2)) as s:
        s.comms.allreduce(np.ones((2, 1), np.float32))
        snap = s.metrics_snapshot()
        assert set(snap) == {"metrics", "profiler_tree", "profiler_report", "event_counters",
                             "flight", "inventory"}
        assert {"programs", "total_hbm_bytes", "per_fn", "detail"} <= set(snap["inventory"])
        assert "raft_tpu_comms_verb_seconds" in snap["metrics"]
        written = s.dump_metrics(str(tmp_path / "m.json"))
        assert json.loads((tmp_path / "m.json").read_text())["event_counters"] \
            == json.loads(json.dumps(written["event_counters"]))
    assert set(metrics_snapshot()) == set(snap)


def test_destroy_closes_services_and_clears_the_registry():
    s = Comms(mesh=_mesh(2)).init()
    svc = s.serve("pairwise", y=np.ones((4, 3), np.float32), start=False)
    assert s.services == {svc.name: svc} and svc._session is s
    with pytest.raises(LogicError, match="already registered"):
        s.serve("pairwise", y=np.ones((4, 3), np.float32), name=svc.name, start=False)
    with pytest.raises(LogicError, match="unknown service kind"):
        s.serve("nope")
    sid = s.sessionId
    s.destroy()
    assert not svc.is_open() and sid not in _sessions and s.services == {}


# --------------------------------------------------------------------- #
# the serving recovery sequence
# --------------------------------------------------------------------- #
class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _step(svc, q):
    fut = svc.submit(q)
    svc.worker.run_once()
    return fut.result(timeout=5)


def test_recovery_manager_repartitions_a_served_index():
    rng = np.random.default_rng(0)
    index = rng.standard_normal((300, 12)).astype(np.float32)
    q = rng.standard_normal((5, 12)).astype(np.float32)
    with Comms(mesh=_mesh(4)) as s:
        svc = s.serve("knn", index=index, k=6, axis="ranks", merge="ring", start=False,
                      max_batch_rows=8, max_wait_ms=0.0, clock=FakeClock())
        svc.warmup()
        before = _step(svc, q)
        with faults.inject(s.comms, faults.Abort(rank=1)):
            assert not s.health_check()["ok"]
            report = RecoveryManager(s).recover()
        assert report["comms_recovered"] and report["services"] == [svc.name]
        assert svc.mesh.rank_ids() == (0, 2, 3) and svc.stats()["shard_devices"] == 3
        after = _step(svc, q)
        assert torch.equal(after[1], before[1])
        assert s.health_check()["ok"]


def test_self_heal_takes_the_cheap_path_on_a_healthy_mesh():
    with Comms(mesh=_mesh(2)) as s:
        out = s.self_heal()
        assert out == {"report": out["report"], "recovered": False, "recovery": None}


def test_health_check_flags_a_stale_sharded_service():
    rng = np.random.default_rng(1)
    index = rng.standard_normal((64, 4)).astype(np.float32)
    with Comms(mesh=_mesh(4)) as s:
        svc = s.serve("knn", index=index, k=3, axis="ranks", start=False)
        s.comms.abort()
        s.recover(devices=[0, 1])
        health = s.health_check()
        assert health["services"][svc.name]["mesh_ok"] is False and not health["ok"]
        assert svc.repartition() and svc.mesh.rank_ids() == (0, 1)
        assert s.health_check()["ok"]


def test_recovery_manager_needs_a_session_or_services():
    with pytest.raises(LogicError):
        RecoveryManager()
    svc = KNNService(np.ones((4, 2), np.float32), 1, device="cpu", start=False)
    rep = RecoveryManager(services=[svc]).recover()
    assert rep["services"] == [svc.name] and not rep["comms_recovered"]
    svc.close()


def test_session_mesh_is_a_rank_mesh():
    with pytest.raises(LogicError, match="raft_tpu_torch.comms.Mesh"):
        Comms(mesh=[CPU, CPU])
    with Comms(mesh=_mesh(2)) as s:
        assert isinstance(s.comms, HostComms)
