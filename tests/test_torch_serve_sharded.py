"""Sharded serving in the port (``KNNService``/``ANNService`` with
``mesh``/``axis``) on meshes of CPU rank slots, beside the JAX package's
sharded services on its 8 virtual devices.

Served rows are held bit for bit to the port's own sharded call
(``mnmg_knn`` / ``mnmg_ivf_flat_search``) on the batch the worker formed,
padded to its rung and sliced (a CPU matmul may round a row differently
at another row count; ``chip_smoke.py`` holds each response to the call
of its own rows on the card), and to the JAX service by tolerance.  The
workers run threadless (``start=False``, ``worker.run_once()``)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu.serve import ANNService as JANNService
from raft_tpu.serve import KNNService as JKNNService
from raft_tpu.spatial.ann import IVFFlatParams as JIVFFlatParams
from raft_tpu.spatial.ann import ivf_flat_build as jivf_flat_build
from raft_tpu_torch import brute_force_knn, convert
from raft_tpu_torch.comms import Mesh
from raft_tpu_torch.core.error import LogicError, RaftError
from raft_tpu_torch.core.metrics import default_registry
from raft_tpu_torch.serve import ANNService, KNNService, RecoveryManager, pad_rows
from raft_tpu_torch.session import Comms
from raft_tpu_torch.spatial.ann import IVFSQParams, ivf_sq_build
from raft_tpu_torch.spatial.mnmg_knn import mnmg_ivf_flat_search, mnmg_knn

CPU = torch.device("cpu")
RUNGS = (8, 32)


def _mesh(n=8):
    return Mesh([CPU] * n, ("ranks",))


def _kw(**extra):
    return dict(max_batch_rows=RUNGS[-1], bucket_rungs=list(RUNGS), max_wait_ms=0.0,
                start=False, **extra)


def _serve(svc, blocks):
    futs = [svc.submit(b) for b in blocks]
    while svc.worker.run_once():
        pass
    return [f.result(timeout=5) for f in futs]


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(42)
    return (rng.standard_normal((1200, 24)).astype(np.float32),
            rng.standard_normal((12, 24)).astype(np.float32))


@pytest.fixture(scope="module")
def ivf(data):
    jindex = jivf_flat_build(jnp.asarray(data[0]), JIVFFlatParams(nlist=24, nprobe=6))
    return jindex, convert.ivf_flat_index_from_reference(jindex, device="cpu")


def _close(got, want):
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=1e-4, atol=1e-4)


# --------------------------------------------------------------------- #
# KNNService(mesh=, axis=)
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("merge", ["allgather", "ring", "hierarchical"])
def test_sharded_knn_bitwise_to_its_own_call_and_close_to_jax(data, merge):
    ref, queries = data
    svc = KNNService(ref, 7, mesh=_mesh(), axis="ranks", merge=merge, **_kw())
    (d, i), = _serve(svc, [queries])
    spmd = svc._spmd
    pd, pi = mnmg_knn(spmd.index, pad_rows(torch.from_numpy(queries), 32), 7, mesh=spmd.mesh,
                      axis="ranks", n_rows=spmd.n_rows, merge=merge)
    assert torch.equal(d, pd[:12]) and torch.equal(i, pi[:12])
    jsvc = JKNNService(jnp.asarray(ref), k=7, axis="ranks", merge=merge,
                       max_batch_rows=RUNGS[-1], bucket_rungs=RUNGS)
    try:
        _close((d, i), jsvc.submit(jnp.asarray(queries)).result(timeout=60))
    finally:
        jsvc.close()
    st = svc.stats()
    assert st["sharded"] and st["axis"] == "ranks" and st["merge"] == merge
    assert st["shard_devices"] == 8 and st["shard_ranks"] == list(range(8))
    svc.close()


def test_sharded_knn_warmup_builds_every_rung_and_nothing_after(data):
    ref, queries = data
    svc = KNNService(ref, 5, mesh=_mesh(4), axis="ranks", **_kw())
    svc.warmup()
    assert svc.warmed_rungs == RUNGS
    _serve(svc, [queries[:3], queries[3:]])
    assert svc.kernel_libraries_after_warmup() == {"builds": 0, "loads": 0}
    svc.close()


def test_explicit_submesh_and_axis_alone(data):
    ref, queries = data
    _, bf_i = brute_force_knn(ref, queries, 5, device="cpu")
    svc = KNNService(ref, 5, mesh=_mesh(4), **_kw())
    (_, i), = _serve(svc, [queries])
    assert torch.equal(i, bf_i) and svc.stats()["shard_devices"] == 4 and svc.axis == "ranks"
    svc.close()
    svc = KNNService(ref, 5, axis="ranks", device="cpu", **_kw())   # the default CPU mesh
    assert svc.stats()["shard_devices"] == 1
    svc.close()


def test_bad_axis_and_mesh_raise(data):
    ref, _ = data
    with pytest.raises(RaftError):
        KNNService(ref, 3, mesh=_mesh(), axis="nope", start=False)
    with pytest.raises(LogicError, match="raft_tpu_torch.comms.Mesh"):
        KNNService(ref, 3, mesh=object(), axis="ranks", device="cpu", start=False)


def test_shard_devices_gauge(data):
    ref, _ = data
    svc = KNNService(ref, 3, mesh=_mesh(), axis="ranks", name="torch-gauge-knn", **_kw())
    vals = {labels.get("service"): s.value
            for labels, s in default_registry().get("raft_tpu_serve_shard_devices").series()}
    assert vals["torch-gauge-knn"] == 8
    assert svc.repartition(mesh=_mesh(3)) is True
    vals = {labels.get("service"): s.value
            for labels, s in default_registry().get("raft_tpu_serve_shard_devices").series()}
    assert vals["torch-gauge-knn"] == 3
    svc.close()


def test_repartition_drops_undivisible_group_size(data):
    ref, queries = data
    _, bf_i = brute_force_knn(ref, queries, 5, device="cpu")
    svc = KNNService(ref, 5, mesh=_mesh(4), merge="hierarchical", group_size=2, **_kw())
    (_, i), = _serve(svc, [queries])
    assert torch.equal(i, bf_i)
    assert svc.repartition(mesh=_mesh(3)) is True and svc._group_size is None
    svc.warmup()
    (_, i), = _serve(svc, [queries])
    assert torch.equal(i, bf_i) and svc.stats()["shard_devices"] == 3
    assert svc.repartition(mesh=svc.mesh) is False
    svc.close()


def test_repartition_on_unsharded_raises(data):
    svc = KNNService(data[0], 3, device="cpu", start=False)
    with pytest.raises(RaftError):
        svc.repartition()
    svc.post_recover()                    # nothing to redo on one device
    svc.close()


# --------------------------------------------------------------------- #
# ANNService(mesh=, axis=)
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("merge", ["allgather", "hierarchical"])
def test_sharded_ann_bitwise_to_its_own_call_and_close_to_jax(data, ivf, merge):
    _, queries = data
    jindex, pindex = ivf
    svc = ANNService(pindex, 6, mesh=_mesh(), axis="ranks", merge=merge, nprobe=6,
                     nprobe_ladder=(6,), **_kw())
    (d, i), = _serve(svc, [queries])
    st = svc._ann_state
    pd, pi = mnmg_ivf_flat_search(st.sharded, pad_rows(torch.from_numpy(queries), 32), 6,
                                  nprobe=6, merge=merge)
    assert torch.equal(d, pd[:12]) and torch.equal(i, pi[:12])
    jsvc = JANNService(jindex, k=6, axis="ranks", merge=merge, nprobe=6, nprobe_ladder=(6,),
                       max_batch_rows=RUNGS[-1], bucket_rungs=RUNGS)
    try:
        _close((d, i), jsvc.submit(jnp.asarray(queries)).result(timeout=60))
    finally:
        jsvc.close()
    assert svc.stats()["sharded"] and svc.stats()["shard_devices"] == 8
    svc.close()


def test_sharded_ann_warmup_covers_every_cell(data, ivf):
    _, queries = data
    svc = ANNService(ivf[1], 4, mesh=_mesh(), axis="ranks", nprobe=6, nprobe_ladder=(3, 6),
                     **_kw())
    svc.warmup()
    for cell in (3, 6):
        svc.set_nprobe(cell)
        _serve(svc, [queries])
    assert svc.kernel_libraries_after_warmup() == {"builds": 0, "loads": 0}
    svc.close()


def _with_inserts(ref, new, base_id, queries, k):
    _, want = brute_force_knn(np.concatenate([ref, new]), queries, k, device="cpu")
    return torch.where(want >= ref.shape[0], want - ref.shape[0] + base_id, want)


def test_insert_visible_and_compaction_exact(data, ivf):
    ref, queries = data
    svc = ANNService(ivf[1], 4, mesh=_mesh(), axis="ranks", nprobe=24, nprobe_ladder=(24,),
                     compact_rows=0, **_kw())
    mirror = svc._ann_state.sharded
    new = np.random.default_rng(3).standard_normal((16, 24)).astype(np.float32)
    svc.insert(np.arange(5000, 5016, dtype=np.int32), new)
    assert svc.delta_rows == 16 and svc._ann_state.sharded is mirror   # no re-shard
    want = _with_inserts(ref, new, 5000, queries, 4)
    (_, i), = _serve(svc, [queries])
    assert torch.equal(i, want)
    assert svc.compact() is True and svc.delta_rows == 0
    assert svc._ann_state.sharded is not mirror                       # re-cut on the swap
    (_, i), = _serve(svc, [queries])
    assert torch.equal(i, want)
    svc.close()


def test_ann_repartition_carries_delta(data, ivf):
    ref, queries = data
    svc = ANNService(ivf[1], 4, mesh=_mesh(), axis="ranks", nprobe=24, nprobe_ladder=(24,),
                     compact_rows=0, **_kw())
    new = np.random.default_rng(5).standard_normal((8, 24)).astype(np.float32)
    svc.insert(np.arange(7000, 7008, dtype=np.int32), new)
    assert svc.repartition(mesh=_mesh(4)) is True
    assert svc.stats()["shard_devices"] == 4 and svc.delta_rows == 8
    (_, i), = _serve(svc, [queries])
    assert torch.equal(i, _with_inserts(ref, new, 7000, queries, 4))
    svc.close()


def test_sharded_ann_refuses_pq_sq_ooc_and_refine(data, ivf):
    ref, _ = data
    sq = ivf_sq_build(ref, IVFSQParams(nlist=16, nprobe=4), device="cpu")
    with pytest.raises(RaftError, match="IVFFlatIndex"):
        ANNService(sq, 3, mesh=_mesh(), axis="ranks", start=False)
    with pytest.raises(RaftError, match="refine_ratio"):
        ANNService(ivf[1], 3, mesh=_mesh(), axis="ranks", refine_ratio=2, start=False)
    with pytest.raises(RaftError, match="ooc=True"):
        ANNService(ivf[1], 3, mesh=_mesh(), axis="ranks", ooc=True, start=False)


# --------------------------------------------------------------------- #
# shard loss -> health flag -> re-partition (session, RecoveryManager)
# --------------------------------------------------------------------- #
def test_health_flags_then_recovery_heals(data, ivf):
    ref, queries = data
    _, bf_i = brute_force_knn(ref, queries, 6, device="cpu")
    with Comms(mesh=_mesh()) as s:
        knn = s.serve("knn", index=ref, k=6, axis="ranks", merge="hierarchical", **_kw())
        ann = s.serve("ann", index=ivf[1], k=4, axis="ranks", nprobe=24, nprobe_ladder=(24,),
                      compact_rows=0, **_kw())
        new = np.random.default_rng(9).standard_normal((8, 24)).astype(np.float32)
        ann.insert(np.arange(8000, 8008, dtype=np.int32), new)
        (_, i), = _serve(knn, [queries])
        assert torch.equal(i, bf_i) and knn.stats()["shard_devices"] == 8
        s.recover(devices=[0, 1, 2, 3])
        report = s.health_check()
        assert report["services"][knn.name]["mesh_ok"] is False and report["ok"] is False
        rep = RecoveryManager(s).recover(recover_comms=False)
        assert sorted(rep["services"]) == sorted([knn.name, ann.name])
        assert knn.stats()["shard_devices"] == ann.stats()["shard_devices"] == 4
        (_, i), = _serve(knn, [queries])
        assert torch.equal(i, bf_i)
        (_, i), = _serve(ann, [queries])
        assert torch.equal(i, _with_inserts(ref, new, 8000, queries, 4))
        report = s.health_check()
        assert report["ok"] and report["services"][ann.name]["mesh_ok"]
        total = sum(v.value for lbl, v in
                    default_registry().get("raft_tpu_serve_repartitions_total").series()
                    if lbl["service"] in (knn.name, ann.name))
        assert total == 2


@pytest.mark.parametrize("ooc", [False, True])
def test_post_recover_republishes_an_unsharded_snapshot(data, ivf, ooc):
    """A single-device service keeps its state across a recovery: the
    delta re-published, an out-of-core hot set copied anew from the host
    store; answers unchanged."""
    ref, queries = data
    kw = dict(ooc=True, device_budget_bytes=1 << 20) if ooc else {}
    svc = ANNService(ivf[1], 4, nprobe=24, nprobe_ladder=(24,), compact_rows=0, device="cpu",
                     **_kw(**kw))
    new = np.random.default_rng(6).standard_normal((8, 24)).astype(np.float32)
    svc.insert(np.arange(6000, 6008, dtype=np.int32), new)
    (d0, i0), = _serve(svc, [queries])
    state = svc._ann_state
    RecoveryManager(services=[svc]).recover()
    assert svc._ann_state is not state and svc.delta_rows == 8
    if ooc:
        assert svc._ann_state.ooc_hot is not state.ooc_hot
    (d1, i1), = _serve(svc, [queries])
    assert torch.equal(d0, d1) and torch.equal(i0, i1)
    assert torch.equal(i1, _with_inserts(ref, new, 6000, queries, 4))
    svc.close()

