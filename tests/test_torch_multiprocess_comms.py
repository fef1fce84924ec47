"""The port's multi-process session: two real processes over gloo.

The JAX package proves its multi-process bootstrap with two OS processes
(``tests/test_multiprocess_comms.py``, ``tests/helpers/mp_comms_worker.py``).
Here two processes of the port's worker entry point
(``python -m raft_tpu_torch.comms.mp_selftest``, ``device="cpu"``) each
bring two CPU rank slots into one session over ``torch.distributed``
(a world of 4 spanning 2 processes) and run every comms self-test, the
registry and placement checks, and ``mnmg_knn`` (the JAX worker's sizes:
n=103, d=16, nq=8, k=10, seed 7) and the slot-sharded IVF-Flat search (an
index built by the JAX package, carried across with ``convert`` and
written once with the port's snapshot) with the allgather, ring and
hierarchical merges.  Each answer is held bitwise to the same search over
a world of 4 in one process, equal on both processes, and within
tolerance of the JAX package's searches on 4 of its virtual CPU devices
in this test's process.  A second spawn starts the second process after
the first is waiting, so the first's bootstrap retries and then succeeds.
Every wait is bounded (``communicate(timeout=120)``, the group's 60 s
timeout) and every child is killed in a ``finally``.

Around the spawns: the bootstrap's retry, timeout, release and adoption
(ports of ``tests/test_comms_resilience.py``'s four bootstrap tests,
with the port's seam ``comms.dist.initialize`` replaced), a session aimed
at a coordinator nobody serves, ``axis_host_group_size`` against the JAX
function on placements of processes, the backend rule, a remote rank's
device refused, and services refusing a mesh that spans processes."""

import json
import socket
import subprocess
import sys
import time
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

from raft_tpu.comms.host_comms import axis_host_group_size as jaxis_host_group_size
from raft_tpu.spatial.ann import IVFFlatParams as JIVFFlatParams
from raft_tpu.spatial.ann import ivf_flat_build as jivf_flat_build
from raft_tpu.spatial.mnmg_knn import mnmg_ivf_flat_search as jmnmg_ivf
from raft_tpu.spatial.mnmg_knn import mnmg_knn as jmnmg_knn
from raft_tpu.spatial.mnmg_knn import shard_ivf_flat_index as jshard_ivf
from raft_tpu_torch import convert
from raft_tpu_torch.comms import HostComms, Mesh, RetryPolicy, dist, mp_selftest
from raft_tpu_torch.comms.host_comms import axis_host_group_size
from raft_tpu_torch.comms.mesh import Rank
from raft_tpu_torch.core.error import CommError, CommTimeoutError, LogicError, RaftError
from raft_tpu_torch.core.handle import Handle
from raft_tpu_torch.persist.snapshot import write_snapshot
from raft_tpu_torch.serve import ANNService, KNNService
from raft_tpu_torch.session import Comms, _sessions
from raft_tpu_torch.spatial.mnmg_knn import (mnmg_ivf_flat_search, mnmg_knn,
                                             shard_ivf_flat_index)

ROOT = Path(__file__).resolve().parent.parent
CPU = torch.device("cpu")
MERGES = ["allgather", "ring", "hierarchical"]
N, DIM, NQ, K = 103, 16, 8, 10          # the JAX worker's sizes, seed 7
SEED = 7
IVF_K, IVF_NPROBE = 10, 6
SPAWN_TIMEOUT_S = 120


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _worker(pid, port, out, *extra, timeout=20.0, retries=3):
    return subprocess.Popen(
        [sys.executable, "-m", "raft_tpu_torch.comms.mp_selftest", "--process-id", str(pid),
         "--num-processes", "2", "--coordinator", "127.0.0.1:%d" % port, "--slots", "2",
         "--device", "cpu", "--out", str(out), "--reps", "1",
         "--bootstrap-timeout", str(timeout), "--bootstrap-retries", str(retries), *extra],
        cwd=str(ROOT), stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def _finish(procs, outs):
    """Wait for every child (bounded), kill them all on the way out, and
    return each one's report."""
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=SPAWN_TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=10)
    reports = []
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0 and out.exists(), "process %d rc %s:\n%s" % (
            i, p.returncode, logs[i][-3000:] + (out.read_text()[-3000:] if out.exists() else ""))
        reports.append(json.loads(out.read_text()))
    return reports


def _data():
    rng = np.random.default_rng(SEED)
    return (rng.standard_normal((N, DIM), dtype=np.float32),
            rng.standard_normal((NQ, DIM), dtype=np.float32))


@pytest.fixture(scope="module")
def jmesh4():
    return JMesh(np.asarray(jax.devices()[:4]), ("ranks",))


@pytest.fixture(scope="module")
def ivf(tmp_path_factory):
    """A small IVF-Flat index built by the JAX package, carried across and
    written with the port's snapshot for the children to restore."""
    rng = np.random.default_rng(3)
    X = rng.standard_normal((600, DIM)).astype(np.float32)
    q = rng.standard_normal((NQ, DIM)).astype(np.float32)
    jindex = jivf_flat_build(jnp.asarray(X), JIVFFlatParams(nlist=12, nprobe=IVF_NPROBE))
    pindex = convert.ivf_flat_index_from_reference(jindex, device="cpu")
    root = tmp_path_factory.mktemp("ivf")
    write_snapshot(str(root), pindex, seq=1, wal_seq=0)
    np.save(root / "queries.npy", q)
    return types.SimpleNamespace(root=root, jindex=jindex, pindex=pindex, q=q)


@pytest.fixture(scope="module")
def spawned(tmp_path_factory, ivf):
    """The two processes of one session, run once for the module."""
    root = tmp_path_factory.mktemp("mp")
    port = _free_port()
    outs = [root / ("p%d.json" % i) for i in range(2)]
    extra = ("--knn", "%d,%d,%d,%d" % (N, DIM, NQ, K), "--seed", str(SEED), "--ivf",
             str(ivf.root), "--nprobe", str(IVF_NPROBE), "--k", str(IVF_K))
    procs = []
    try:
        for i in range(2):
            procs.append(_worker(i, port, outs[i], *extra))
    finally:
        reports = _finish(procs, outs)
    return reports


# --------------------------------------------------------------------- #
# two processes, one session
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("pid", [0, 1])
def test_every_selftest_passes_in_each_process(spawned, pid):
    rep = spawned[pid]
    assert rep["ok"], rep["failures"]
    assert len(rep["selftests"]) == 14 and all(v is True for v in rep["selftests"].values()), (
        rep["selftests"])
    assert rep["commsplit_by_process"]
    assert rep["health"]["ok"] and rep["health"]["backend"] == "gloo"
    assert rep["health"]["ranks"] == {str(r): True for r in range(4)}


@pytest.mark.parametrize("pid", [0, 1])
def test_registry_placement_and_backend(spawned, pid):
    rep = spawned[pid]
    assert rep["process_indices"] == [0, 0, 1, 1]
    assert rep["axis_host_group_size"] == 2
    assert rep["backend"] == "gloo" and rep["worker_backends"] == ["gloo"]
    assert rep["handle_process_index"] == pid
    assert rep["remote_device_refused"]
    assert rep["exchange"]["exchanges"] > 0 and rep["exchange"]["host_staged_bytes"] == 0
    assert rep["build"] == {"builds": 0, "loads": 0}      # the CPU runs no kernel


@pytest.mark.parametrize("merge", MERGES)
def test_mnmg_knn_across_processes(spawned, jmesh4, merge):
    runs = [rep["knn"]["runs"][merge] for rep in spawned]
    # bitwise: each process against its one-process world of 4, and the two alike
    assert all(r["equal_one_process_world"] for r in runs)
    assert runs[0]["digest"] == runs[1]["digest"] == runs[0]["local_digest"]
    # the same search over a world of 4 in this process
    index, queries = _data()
    d, i = mnmg_knn(index, queries, K, mesh=Mesh([CPU] * 4, ("ranks",)), axis="ranks",
                    merge=merge, group_size=2 if merge == "hierarchical" else None)
    got_d, got_i = np.asarray(runs[0]["d"], np.float32), np.asarray(runs[0]["i"], np.int32)
    np.testing.assert_allclose(got_d, d.numpy(), rtol=1e-6, atol=1e-6)
    # the JAX package's on 4 of its virtual devices
    jd, ji = jmnmg_knn(jnp.asarray(index), jnp.asarray(queries), K, mesh=jmesh4,
                       axis="ranks", merge=merge)
    jd, ji = np.asarray(jd), np.asarray(ji)
    np.testing.assert_allclose(got_d, jd, rtol=1e-4, atol=1e-4)
    mism = got_i != ji
    assert np.allclose(got_d[mism], jd[mism], rtol=1e-4, atol=1e-4), merge
    assert spawned[0]["knn"]["group_size"] == 2


@pytest.mark.parametrize("merge", MERGES)
def test_sharded_ivf_flat_across_processes(spawned, ivf, jmesh4, merge):
    runs = [rep["ivf"]["runs"][merge] for rep in spawned]
    assert all(r["equal_one_process_world"] for r in runs)
    assert runs[0]["digest"] == runs[1]["digest"] == runs[0]["local_digest"]
    assert spawned[0]["ivf"]["index_digest"] == spawned[1]["ivf"]["index_digest"] == (
        mp_selftest._digest(ivf.pindex.centroids, ivf.pindex.slot_vecs, ivf.pindex.slot_ids,
                            ivf.pindex.cent_slots))
    got_d, got_i = np.asarray(runs[0]["d"], np.float32), np.asarray(runs[0]["i"], np.int32)
    sharded = shard_ivf_flat_index(ivf.pindex, Mesh([CPU] * 4, ("ranks",)), "ranks")
    d, _ = mnmg_ivf_flat_search(sharded, ivf.q, IVF_K, nprobe=IVF_NPROBE, merge=merge,
                                group_size=2 if merge == "hierarchical" else None)
    np.testing.assert_allclose(got_d, d.numpy(), rtol=1e-6, atol=1e-6)
    jsharded = jshard_ivf(ivf.jindex, jmesh4, "ranks")
    jd, ji = jmnmg_ivf(jsharded, jnp.asarray(ivf.q), IVF_K, nprobe=IVF_NPROBE, merge=merge)
    jd, ji = np.asarray(jd), np.asarray(ji)
    np.testing.assert_allclose(got_d, jd, rtol=1e-4, atol=1e-4)
    mism = got_i != ji
    assert np.allclose(got_d[mism], jd[mism], rtol=1e-4, atol=1e-4), merge


@pytest.mark.parametrize("pid", [0, 1])
def test_kernel_checks_in_each_process(spawned, pid):
    rep = spawned[pid]
    assert rep["knn"]["k1_check"]["ok"] and rep["ivf"]["k3_check"]["ok"]
    for part in ("knn", "ivf"):
        for run in rep[part]["runs"].values():
            assert run["bytes_exchanged_per_search"] > 0 and run["ms"] > 0


def test_a_late_peer_makes_the_bootstrap_retry(tmp_path):
    """Process 0 serves the store and waits; process 1 starts only once
    the store answers and one of process 0's attempts has run out, so
    process 0's bootstrap retries, then succeeds."""
    port = _free_port()
    outs = [tmp_path / "p0.json", tmp_path / "p1.json"]
    procs = []
    try:
        procs.append(_worker(0, port, outs[0], timeout=1.0, retries=20))
        # a client of process 0's store: it connects once the store is up
        probe = torch.distributed.TCPStore("127.0.0.1", port, 2, False,
                                           timeout=dist._seconds(SPAWN_TIMEOUT_S),
                                           wait_for_workers=False)
        del probe
        time.sleep(1.5)         # past process 0's first attempt (0.8 s)
        procs.append(_worker(1, port, outs[1], timeout=1.0, retries=20))
    finally:
        reports = _finish(procs, outs)
    assert reports[0]["bootstrap_retries"] >= 1, reports[0]
    for rep in reports:
        assert rep["ok"] and all(v is True for v in rep["selftests"].values()), rep


# --------------------------------------------------------------------- #
# the bootstrap: retry, timeout, release, adoption (no process spawned)
# --------------------------------------------------------------------- #
def fast_policy(**kw):
    """A policy whose backoff is recorded, not slept."""
    slept = []
    kw.setdefault("max_retries", 3)
    kw.setdefault("base_delay", 0.01)
    return RetryPolicy(sleep=slept.append, **kw), slept


def _mesh(n=2):
    return Mesh([CPU] * n, ("ranks",))


def test_bootstrap_retry_honors_timeout(monkeypatch):
    attempts = []
    monkeypatch.setattr(dist, "initialize", lambda *a, **kw: (attempts.append(1), time.sleep(3)))
    policy, slept = fast_policy(max_retries=2, timeout=0.1)
    s = Comms(mesh=_mesh(), coordinator_address="127.0.0.1:1", num_processes=1, process_id=0,
              retry_policy=policy)
    t0 = time.monotonic()
    with pytest.raises(CommError) as ei:
        s.init()
    elapsed = time.monotonic() - t0
    assert isinstance(ei.value.__cause__, CommTimeoutError)
    assert "after 3 attempts" in str(ei.value)
    assert len(attempts) == 3 and len(slept) == 2
    assert elapsed < 2.0            # bounded by the watchdog, not the 3 s hang
    assert not s.initialized and s.sessionId not in _sessions


def test_bootstrap_transient_failures_then_success(monkeypatch):
    attempts, shutdowns = [], []

    def flaky(*a, **kw):
        attempts.append(kw.get("timeout_s"))
        if len(attempts) < 3:
            raise RuntimeError("coordinator not up yet")

    monkeypatch.setattr(dist, "initialize", flaky)
    monkeypatch.setattr(dist, "shutdown", lambda *a: shutdowns.append(1))
    boot_policy, slept = fast_policy(max_retries=3, timeout=5.0)
    verb_policy = RetryPolicy(max_retries=1, retry_timeouts=False)
    s = Comms(mesh=_mesh(), coordinator_address="127.0.0.1:1", num_processes=1,
              process_id=0, retry_policy=verb_policy, bootstrap_retry_policy=boot_policy)
    s.init()
    try:
        assert s.initialized and len(attempts) == 3
        assert slept == boot_policy.schedule()[:2]
        assert attempts == [4.0] * 3            # each attempt's waits end inside its timeout
        # bootstrap and verbs run under their own policies
        assert s.comms.retry_policy is verb_policy
        assert s.backend == "gloo" and s.comms.get_size() == 2
        assert s.handle.get_device_properties()["process_index"] == 0
    finally:
        s.destroy()
    assert shutdowns == [1]


def test_init_failure_after_bootstrap_releases_the_group(monkeypatch):
    """If init() fails after a successful bootstrap, the owned group is
    torn down: a context manager's __exit__ never runs when __enter__
    raises."""
    import raft_tpu_torch.session as sessmod

    shutdowns = []
    monkeypatch.setattr(dist, "initialize", lambda *a, **kw: None)
    monkeypatch.setattr(dist, "shutdown", lambda *a: shutdowns.append(1))
    monkeypatch.setattr(sessmod, "default_mesh", lambda **kw: (_ for _ in ()).throw(
        RuntimeError("mesh construction exploded")))
    s = Comms(coordinator_address="127.0.0.1:1", num_processes=1, process_id=0, device="cpu")
    with pytest.raises(RuntimeError, match="mesh construction"):
        s.init()
    assert shutdowns == [1]
    assert not s.initialized and not s._owns_distributed
    assert s.sessionId not in _sessions


def test_bootstrap_adopts_a_preexisting_group(monkeypatch):
    """A group the user brought up is used but never owned: no second
    initialize, and destroy() leaves it standing."""
    import raft_tpu_torch.session as sessmod

    monkeypatch.setattr(sessmod, "_distributed_is_initialized", lambda: True)
    inits, shutdowns = [], []
    monkeypatch.setattr(dist, "initialize", lambda *a, **kw: inits.append(1))
    monkeypatch.setattr(dist, "shutdown", lambda *a: shutdowns.append(1))
    s = Comms(mesh=_mesh(), coordinator_address="127.0.0.1:1", num_processes=1,
              process_id=0).init()
    assert inits == [] and not s._owns_distributed
    s.destroy()
    assert shutdowns == []


def test_a_coordinator_nobody_serves_fails_in_bounded_time():
    """A real store connection to a port no process serves: three
    attempts of 0.4 s, then ``CommError``."""
    policy = RetryPolicy(max_retries=2, base_delay=0.01, timeout=0.5)
    s = Comms(mesh=_mesh(), coordinator_address="127.0.0.1:%d" % _free_port(),
              num_processes=2, process_id=1, bootstrap_retry_policy=policy)
    t0 = time.monotonic()
    with pytest.raises(CommError, match="after 3 attempts"):
        s.init()
    assert time.monotonic() - t0 < 10.0
    assert not dist.is_initialized() and s.sessionId not in _sessions


def test_the_worker_refuses_cuda_without_a_card(tmp_path, monkeypatch):
    """Asked for CUDA where there is none, the worker exits 3 at once."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert mp_selftest.main(["--process-id", "0", "--num-processes", "2", "--coordinator",
                             "127.0.0.1:1", "--device", "cuda",
                             "--out", str(tmp_path / "x.json")]) == 3
    assert not (tmp_path / "x.json").exists()


# --------------------------------------------------------------------- #
# placement, the backend rule, remote ranks (no process spawned)
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("procs", [[0, 0, 1, 1], [0, 0, 0, 1, 1, 1], [0, 1, 0, 1],
                                   [0, 0, 0, 1], [0, 0, 0, 0], [0, 0, 1, 1, 0, 0],
                                   [0, 1, 2, 3], [3, 3, 1, 1]])
def test_axis_host_group_size_matches_jax(procs):
    mesh = Mesh([Rank(i, CPU, process=p) for i, p in enumerate(procs)], ("ranks",))
    fake = types.SimpleNamespace(
        axis_names=("ranks",),
        devices=np.asarray([types.SimpleNamespace(process_index=p) for p in procs],
                           dtype=object))
    assert axis_host_group_size(mesh, "ranks") == jaxis_host_group_size(fake, "ranks")


def _cuda(uuid, index=0):
    return {"type": "cuda", "index": index, "uuid": uuid, "name": "NVIDIA H100 80GB HBM3"}


@pytest.mark.parametrize("topology,want", [
    ([[dist.describe_slot(CPU)] * 2] * 2, "gloo"),                     # the CPU
    ([[_cuda("a")], [_cuda("b")]], "nccl"),                            # a card each
    ([[_cuda("a"), _cuda("a")], [_cuda("b")]], "nccl"),                # two slots, one card
    ([[_cuda("a")], [_cuda("a")]], "gloo"),                            # one card shared
    ([[_cuda("a")], [dist.describe_slot(CPU)]], "gloo"),               # a CPU slot
    ([[_cuda("a", 0), _cuda("b", 1)], [_cuda("c", 0), _cuda("b", 1)]], "gloo"),
])
def test_the_backend_rule(topology, want):
    assert dist.choose_backend(topology) == want


def _spanning(world=2, slots=2):
    """This process's side of a mesh that spans ``world`` processes, with
    a stand-in group (nothing is exchanged)."""
    group = dist.ProcessGroup(0, world, [[dist.describe_slot(CPU)] * slots] * world, "gloo",
                              CPU)
    return group.span(Mesh([CPU] * slots, ("ranks",)))


def test_a_remote_rank_has_no_device_here():
    mesh = _spanning()
    assert [r.process for r in mesh.rank_list()] == [0, 0, 1, 1]
    assert [r.is_local for r in mesh.rank_list()] == [True, True, False, False]
    remote = mesh.rank_list()[2]
    assert remote.desc == "cpu@process 1" and "cpu@process 1" in repr(remote)
    with pytest.raises(LogicError, match="another process"):
        remote.device
    with pytest.raises(LogicError):
        mesh.devices
    assert mesh.home() == CPU and mesh.submesh([2, 3]).home() == CPU
    comms = HostComms(mesh)
    assert comms.probe_rank(3) and comms.devices == [CPU] * 4     # remote rows land home
    rows = comms._check(torch.arange(4.0)[:, None])
    assert [type(r).__name__ for r in rows] == ["Tensor", "Tensor", "Remote", "Remote"]
    assert axis_host_group_size(mesh, "ranks") == 2


def test_a_spanning_mesh_needs_its_group():
    with pytest.raises(LogicError, match="process group"):
        Mesh([Rank(0, CPU), Rank(1, None, process=1, desc="cpu@process 1")], ("ranks",))


@pytest.mark.parametrize("kind", ["knn", "ann", "replicas"])
def test_services_refuse_a_mesh_that_spans_processes(ivf, kind):
    mesh = _spanning()
    index = np.zeros((16, DIM), np.float32)
    with pytest.raises(RaftError, match="serving across processes"):
        if kind == "knn":
            KNNService(index, 4, mesh=mesh, axis="ranks", start=False, device="cpu")
        elif kind == "ann":
            ANNService(ivf.pindex, 4, mesh=mesh, axis="ranks", start=False, device="cpu")
        else:
            KNNService(index, 4, mesh=mesh, axis="ranks", replicas=2, start=False,
                       device="cpu")


def test_a_handle_names_its_process():
    assert Handle(device="cpu").get_device_properties()["process_index"] == 0
