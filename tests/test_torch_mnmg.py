"""Port parity of the sharded searches (raft_tpu_torch.spatial.mnmg_knn)
against the JAX package's, on the CPU.

The JAX side runs on the 8 virtual CPU devices of ``tests/conftest.py``;
the port on a mesh of 8 CPU rank slots.  Same numpy inputs from a seed,
float32; held as the JAX tests hold the JAX functions to the single
device (``tests/test_mnmg.py``): ids equal, distances within 1e-4.  The
port's three topologies are also held to each other bit for bit (every
merge orders ties by global id), which the last tests check on data with
exact ties."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

from raft_tpu.comms.host_comms import default_mesh as jdefault_mesh
from raft_tpu.distance.distance_type import DistanceType as JD
from raft_tpu.spatial.ann import IVFFlatParams as JIVFFlatParams
from raft_tpu.spatial.ann import ivf_flat_build as jivf_flat_build
from raft_tpu.spatial.mnmg_knn import mnmg_ivf_flat_search as jmnmg_ivf
from raft_tpu.spatial.mnmg_knn import mnmg_knn as jmnmg_knn
from raft_tpu.spatial.mnmg_knn import shard_ivf_flat_index as jshard_ivf
from raft_tpu_torch import brute_force_knn, config, convert
from raft_tpu_torch.comms import HostComms, Mesh
from raft_tpu_torch.core.error import LogicError, RaftError
from raft_tpu_torch.core.handle import Handle
from raft_tpu_torch.distance.distance_type import DistanceType as D
from raft_tpu_torch.spatial.mnmg_knn import (MERGE_TOPOLOGIES, mnmg_ivf_flat_search, mnmg_knn,
                                             resolve_group_size, resolve_merge,
                                             shard_ivf_flat_index, shard_knn_index)

CPU = torch.device("cpu")
TOPOLOGIES = ["allgather", "ring", "hierarchical"]


def _mesh(n=8):
    return Mesh([CPU] * n, ("ranks",))


def _close(got, want):
    (dg, ig), (dw, iw) = got, want
    np.testing.assert_array_equal(ig.numpy(), np.asarray(iw))
    np.testing.assert_allclose(dg.numpy(), np.asarray(dw), rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    return (rng.standard_normal((403, 24)).astype(np.float32),   # not a multiple of 8
            rng.standard_normal((56, 24)).astype(np.float32))


@pytest.mark.parametrize("merge", TOPOLOGIES)
def test_mnmg_matches_jax(data, merge):
    index, queries = data
    want = jmnmg_knn(jnp.asarray(index), jnp.asarray(queries), 10, merge=merge)
    got = mnmg_knn(index, queries, 10, mesh=_mesh(), axis="ranks", merge=merge)
    _close(got, want)


@pytest.mark.parametrize("group_size", [1, 2, 4, 8, None])
def test_mnmg_hierarchical_group_sizes_match_jax(data, group_size):
    index, queries = data
    want = jmnmg_knn(jnp.asarray(index), jnp.asarray(queries), 10, merge="hierarchical",
                     group_size=group_size)
    got = mnmg_knn(index, queries, 10, mesh=_mesh(), axis="ranks", merge="hierarchical",
                   group_size=group_size)
    _close(got, want)


@pytest.mark.parametrize("merge", TOPOLOGIES)
@pytest.mark.parametrize("n,nq,k", [(40, 12, 9), (19, 7, 5)])
def test_mnmg_k_wider_than_a_shard_matches_jax(merge, n, nq, k):
    rng = np.random.default_rng(n)
    index = rng.standard_normal((n, 8)).astype(np.float32)
    queries = rng.standard_normal((nq, 8)).astype(np.float32)
    want = jmnmg_knn(jnp.asarray(index), jnp.asarray(queries), k, merge=merge)
    got = mnmg_knn(index, queries, k, mesh=_mesh(), axis="ranks", merge=merge)
    _close(got, want)


@pytest.mark.parametrize("merge", ["allgather", "ring"])
def test_mnmg_2d_query_mesh_matches_jax(data, merge):
    index, queries = data
    jmesh = JMesh(np.array(jax.devices()[:8]).reshape(2, 4), ("qx", "ix"))
    want = jmnmg_knn(jnp.asarray(index), jnp.asarray(queries), 10, mesh=jmesh, axis="ix",
                     query_axis="qx", merge=merge)
    mesh = Mesh(np.array([CPU] * 8, dtype=object).reshape(2, 4), ("qx", "ix"))
    got = mnmg_knn(index, queries, 10, mesh=mesh, axis="ix", query_axis="qx", merge=merge)
    _close(got, want)


@pytest.mark.parametrize("metric", [D.L2SqrtExpanded, D.InnerProduct, D.L1])
def test_mnmg_metric_dispatch_matches_jax(data, metric):
    index, queries = data
    want = jmnmg_knn(jnp.asarray(index), jnp.asarray(queries), 6, metric=JD(int(metric)))
    got = mnmg_knn(index, queries, 6, metric=metric, mesh=_mesh(), axis="ranks")
    _close(got, want)


def test_mnmg_via_injected_handle_comms(data):
    index, queries = data
    h = Handle(device="cpu")
    h.set_comms(HostComms(_mesh()))
    got = mnmg_knn(index, queries, 7, handle=h)
    _close(got, jmnmg_knn(jnp.asarray(index), jnp.asarray(queries), 7))
    h2 = Handle(device="cpu", mesh=_mesh(4))
    got = mnmg_knn(index, queries, 7, handle=h2)
    _close(got, jmnmg_knn(jnp.asarray(index), jnp.asarray(queries), 7))


def test_mnmg_presharded_index(data):
    index, queries = data
    mesh = _mesh()
    sharded, n = shard_knn_index(index, mesh, "ranks")
    assert n == 403 and [s.shape[0] for s in sharded.shards] == [51] * 7 + [46]
    # the shards are views of one copy of the index, not copies of their own
    assert len({s.untyped_storage().data_ptr() for s in sharded.shards}) == 1
    got = mnmg_knn(sharded, queries, 10, mesh=mesh, axis="ranks", n_rows=n,
                   merge="hierarchical")
    _close(got, jmnmg_knn(jnp.asarray(index), jnp.asarray(queries), 10))
    with pytest.raises(LogicError, match="another mesh"):
        mnmg_knn(sharded, queries, 10, mesh=_mesh(), axis="ranks")


def test_mnmg_errors_and_knobs(data):
    index, queries = data
    with pytest.raises(RaftError):
        mnmg_knn(index, queries, 5, mesh=_mesh(), axis="ranks", merge="hierarchical",
                 group_size=3)
    with pytest.raises(LogicError, match="mnmg_merge"):
        mnmg_knn(index, queries, 5, mesh=_mesh(), axis="ranks", merge="bogus")
    with pytest.raises(LogicError, match="out of range"):
        mnmg_knn(index, queries, 500, mesh=_mesh(), axis="ranks")
    with pytest.raises(LogicError, match="axis"):
        mnmg_knn(index, queries, 5, mesh=_mesh(), axis="nope")
    with config.override(mnmg_merge="ring"):
        assert resolve_merge(None) == "ring"
        _close(mnmg_knn(index, queries, 6, mesh=_mesh(), axis="ranks"),
               jmnmg_knn(jnp.asarray(index), jnp.asarray(queries), 6))
    assert resolve_merge(None) == "allgather" and MERGE_TOPOLOGIES == tuple(TOPOLOGIES)


@pytest.mark.parametrize("n", [1, 2, 4, 6, 8, 9])
def test_resolve_group_size_matches_jax(n):
    from raft_tpu.spatial.mnmg_knn import resolve_group_size as jresolve

    jmesh = JMesh(np.array(jax.devices()[:min(n, 8)]), ("ranks",)) if n <= 8 else None
    got = resolve_group_size(_mesh(n), "ranks")
    assert n % got == 0
    if jmesh is not None:
        assert got == jresolve(jmesh, "ranks")
    assert resolve_group_size(_mesh(8), "ranks", 4) == 4


# --------------------------------------------------------------------- #
# slot-sharded IVF-Flat: the JAX index, carried across
# --------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def ivf():
    rng = np.random.default_rng(7)
    X = rng.standard_normal((1500, 16)).astype(np.float32)
    jindex = jivf_flat_build(jnp.asarray(X), JIVFFlatParams(nlist=24, nprobe=6))
    jsharded = jshard_ivf(jindex, jdefault_mesh(), "ranks")
    pindex = convert.ivf_flat_index_from_reference(jindex, device="cpu")
    return X, jsharded, pindex, shard_ivf_flat_index(pindex, _mesh(), "ranks")


@pytest.mark.parametrize("merge", TOPOLOGIES)
def test_mnmg_ivf_matches_jax(ivf, merge):
    X, jsharded, _, sharded = ivf
    q = np.random.default_rng(11).standard_normal((9, 16)).astype(np.float32)
    want = jmnmg_ivf(jsharded, jnp.asarray(q), 5, nprobe=6, merge=merge)
    _close(mnmg_ivf_flat_search(sharded, q, 5, nprobe=6, merge=merge), want)


def test_mnmg_ivf_full_probe_matches_jax_and_brute_force(ivf):
    X, jsharded, _, sharded = ivf
    q = np.random.default_rng(12).standard_normal((6, 16)).astype(np.float32)
    got = mnmg_ivf_flat_search(sharded, q, 4, nprobe=24)
    _close(got, jmnmg_ivf(jsharded, jnp.asarray(q), 4, nprobe=24))
    _, bf_i = brute_force_knn(X, q, 4, device="cpu")
    assert torch.equal(got[1], bf_i)


def test_mnmg_ivf_delta_merge_matches_jax(ivf):
    X, jsharded, _, sharded = ivf
    rng = np.random.default_rng(13)
    q = rng.standard_normal((5, 16)).astype(np.float32)
    dv = rng.standard_normal((32, 16)).astype(np.float32)
    dv[:5] = q + np.float32(0.01)              # each query's nearest is a delta row
    dids = np.arange(9000, 9032, dtype=np.int32)
    want = jmnmg_ivf(jsharded, jnp.asarray(q), 4, nprobe=24,
                     delta=(jnp.asarray(dv), jnp.asarray(dids)))
    got = mnmg_ivf_flat_search(sharded, q, 4, nprobe=24, delta=(dv, dids))
    _close(got, want)
    assert torch.equal(got[1][:, 0], torch.arange(9000, 9005, dtype=torch.int32))


@pytest.mark.parametrize("merge", TOPOLOGIES)
def test_mnmg_ivf_narrow_candidates_pad_to_k(merge):
    """k wider than every probed candidate: (inf, -1) fillers, as the JAX
    search pads."""
    rng = np.random.default_rng(14)
    X = rng.standard_normal((120, 8)).astype(np.float32)
    jindex = jivf_flat_build(jnp.asarray(X), JIVFFlatParams(nlist=64, nprobe=1))
    jsharded = jshard_ivf(jindex, jdefault_mesh(), "ranks")
    sharded = shard_ivf_flat_index(convert.ivf_flat_index_from_reference(jindex, device="cpu"),
                                   _mesh(), "ranks")
    q = rng.standard_normal((5, 8)).astype(np.float32)
    jd, ji = jmnmg_ivf(jsharded, jnp.asarray(q), 64, nprobe=1, merge=merge)
    d, i = mnmg_ivf_flat_search(sharded, q, 64, nprobe=1, merge=merge)
    assert d.shape == (5, 64)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    live = i >= 0
    assert torch.isinf(d[~live]).all()
    np.testing.assert_allclose(d[live].numpy(), np.asarray(jd)[live.numpy()], atol=1e-4)


def test_mnmg_ivf_k_above_k3s_limit_takes_the_scan_route(ivf):
    X, jsharded, pindex, sharded = ivf
    q = np.random.default_rng(15).standard_normal((3, 16)).astype(np.float32)
    got = mnmg_ivf_flat_search(sharded, q, 200, nprobe=24)
    _close(got, jmnmg_ivf(jsharded, jnp.asarray(q), 200, nprobe=24))


def test_mnmg_ivf_select_impl_names_item_7(ivf):
    # item 7b ported select_impl: a JAX name is refused in the registry's
    # message shape, and the port's two routes give the same answer
    with pytest.raises(RaftError, match="select_impl='approx' is illegal.*legal: kernel, sort"):
        mnmg_ivf_flat_search(ivf[3], np.zeros((1, 16), np.float32), 4, select_impl="approx")
    q = np.random.default_rng(16).standard_normal((3, 16)).astype(np.float32)
    got = [mnmg_ivf_flat_search(ivf[3], q, 6, nprobe=8, select_impl=impl)
           for impl in ("kernel", "sort")]
    assert torch.equal(got[0][0], got[1][0]) and torch.equal(got[0][1], got[1][1])


# --------------------------------------------------------------------- #
# ties: ordered by global id at every level, topologies bitwise equal
# --------------------------------------------------------------------- #
def test_topologies_bitwise_equal_on_exact_ties():
    """Every row of the index four times over: exact ties everywhere.  The
    three topologies agree bit for bit, ids included, and each tie
    resolves to the smaller global id."""
    rng = np.random.default_rng(3)
    base = rng.standard_normal((40, 8)).astype(np.float32)
    index = np.concatenate([base] * 4)
    q = rng.standard_normal((13, 8)).astype(np.float32)
    outs = {m: mnmg_knn(index, q, 12, mesh=_mesh(), axis="ranks", merge=m) for m in TOPOLOGIES}
    for m in ("ring", "hierarchical"):
        assert torch.equal(outs[m][0], outs["allgather"][0])
        assert torch.equal(outs[m][1], outs["allgather"][1])
    d, i = outs["allgather"]
    # each distance comes four times, the copies' ids ascending
    assert torch.equal(i[:, 0::4] % 40, i[:, 1::4] % 40)
    assert (i[:, 1::4] > i[:, 0::4]).all()
    assert torch.equal(d[:, 0::4], d[:, 3::4])


def test_ivf_topologies_bitwise_equal_and_equal_to_the_single_device_ids(ivf):
    from raft_tpu_torch.spatial.ann import ivf_flat_search

    _, _, pindex, sharded = ivf
    q = np.random.default_rng(16).standard_normal((20, 16)).astype(np.float32)
    outs = {m: mnmg_ivf_flat_search(sharded, q, 7, nprobe=5, merge=m) for m in TOPOLOGIES}
    for m in ("ring", "hierarchical"):
        assert torch.equal(outs[m][0], outs["allgather"][0])
        assert torch.equal(outs[m][1], outs["allgather"][1])
    d, i = ivf_flat_search(pindex, q, 7, nprobe=5, device="cpu")
    assert torch.equal(outs["allgather"][1], i)
    torch.testing.assert_close(outs["allgather"][0], d, rtol=0, atol=1e-5)


# --------------------------------------------------------------------- #
# the merge computes the line's result once, and the shard scan's routes
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("merge,group_size,selections", [
    ("allgather", None, 1), ("ring", None, 7), ("hierarchical", 1, 7),
    ("hierarchical", 2, 4 + 3), ("hierarchical", 4, 2 + 1), ("hierarchical", 8, 1)])
def test_merge_selects_once_per_received_block(data, monkeypatch, merge, group_size,
                                               selections):
    """One controller computes the line's result once, for its first
    rank: a world of 8 makes one selection per block that rank receives
    (and one per group), not one per rank and hop; the result is the
    same as every other topology's, bit for bit."""
    mk = importlib.import_module("raft_tpu_torch.spatial.mnmg_knn")

    index, queries = data
    want = mnmg_knn(index, queries, 10, mesh=_mesh(), axis="ranks", merge="allgather")
    calls = []
    real = mk.select_k

    def counting(*args, **kwargs):
        calls.append(args[0].shape)
        return real(*args, **kwargs)

    monkeypatch.setattr(mk, "select_k", counting)
    got = mnmg_knn(index, queries, 10, mesh=_mesh(), axis="ranks", merge=merge,
                   group_size=group_size)
    assert len(calls) == selections
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("case", ["k_above_max_k", "float64_store"])
def test_mnmg_ivf_outside_k3s_limits_scans_by_step(ivf, monkeypatch, case):
    """Outside K3's limits a shard takes the resident search's step scan
    (never K3's plain version): held to the resident "scan" search."""
    ann = importlib.import_module("raft_tpu_torch.spatial.ann")
    mk = importlib.import_module("raft_tpu_torch.spatial.mnmg_knn")
    from raft_tpu_torch.ops.ivf_tile import MAX_K

    _, _, pindex, _ = ivf
    k = MAX_K + 8 if case == "k_above_max_k" else 6
    if case == "float64_store":
        pindex = pindex._replace(slot_vecs=pindex.slot_vecs.double(),
                                 slot_norms=pindex.slot_norms.double())
    sharded = shard_ivf_flat_index(pindex, _mesh(), "ranks")
    monkeypatch.setattr(mk, "fused_ivf_scan",
                        lambda *a, **kw: pytest.fail("K3 called outside its limits"))
    steps = []
    real = ann._probe_scan_search
    monkeypatch.setattr(ann, "_probe_scan_search",
                        lambda *a, **kw: steps.append(1) or real(*a, **kw))
    q = np.random.default_rng(17).standard_normal((4, 16)).astype(np.float32)
    got = mnmg_ivf_flat_search(sharded, q, k, nprobe=24)
    assert len(steps) == 8
    want = ann.ivf_flat_search(pindex, q, k, nprobe=24, scan_impl="scan", device="cpu")
    np.testing.assert_array_equal(got[1].numpy(), want[1].numpy())
    torch.testing.assert_close(got[0], want[0].to(got[0].dtype), rtol=0, atol=1e-5)


def test_mnmg_ivf_refuses_a_metric_outside_l2(ivf):
    _, _, pindex, sharded = ivf
    with pytest.raises(LogicError, match="L2-only"):
        shard_ivf_flat_index(pindex._replace(metric=D.InnerProduct), _mesh(), "ranks")
    with pytest.raises(LogicError, match="L2-only"):
        mnmg_ivf_flat_search(sharded._replace(metric=D.InnerProduct),
                             np.zeros((1, 16), np.float32), 4)
