"""Port parity: the out-of-core IVF-Flat tier (``raft_tpu_torch/spatial/ooc.py``
and ``ANNService(ooc=True)``) against the JAX package's, on the CPU.

The identity, extend and service cases of the JAX ``tests/test_ooc.py``.
Each search case checks two things:

- the port's out-of-core search is **bitwise** equal to the port's own
  resident ``"scan"`` search (``spatial/ann.py:ivf_flat_search``) on the
  same index: every arm (cold only, hot and cold, all hot with nothing
  streamed, synchronous against overlapped, the delta, the sqrt metric,
  ``force_rounds``);
- the port against ``raft_tpu.spatial.ooc.ooc_ivf_flat_search`` on the same
  index (built by the JAX package, carried over by ``convert.py``):
  distances within ``RTOL, ATOL = 1e-5, 1e-4`` (``tests/test_torch_ann.py``)
  and ids as sets up to ties (``assert_knn_close``).

Also: the bytes streamed by one search are the cold slots rounded up to
whole tiles (the store never moves whole), the hit and miss counters,
K3's route on the CPU (``scan_impl="kernel"``, its plain version) against
the resident kernel route, and the service (threadless, ``start=False``):
the budget split as the JAX service splits it, served rows bitwise equal
to the port's resident search of the padded batch, the budget's high
water, compaction, promotion, calibration and the refusals.  Left out:
the approximate select (queue 1 item 7), the JAX lint's device-put ban,
and the load-sensitive loadgen report (``post_recover`` of an
out-of-core service is in ``test_torch_serve_sharded.py``).
Counters are read per pool, never process-wide."""

import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers.torch_parity import assert_knn_close
from raft_tpu.distance.distance_type import DistanceType as JD
from raft_tpu.mr import TilePool as JaxTilePool
from raft_tpu.serve import ANNService as JaxANNService
from raft_tpu.spatial import ann as jann
from raft_tpu.spatial import ooc as jooc
from raft_tpu_torch import ANNService, LogicError, RaftError
from raft_tpu_torch.convert import (ivf_flat_index_from_reference, ooc_ivf_flat_from_reference,
                                    ooc_ivf_flat_to_numpy, to_numpy)
from raft_tpu_torch.core import flight
from raft_tpu_torch.core.metrics import default_registry
from raft_tpu_torch.mr import TilePool
from raft_tpu_torch.serve import pad_rows
from raft_tpu_torch.spatial import ann as pann
from raft_tpu_torch.spatial.knn import brute_force_knn
from raft_tpu_torch.spatial.ooc import (OocIVFFlat, ivf_flat_to_ooc, materialize_hot, ooc_extend,
                                        ooc_ivf_flat_search, ooc_reconstruct)

RTOL, ATOL = 1e-5, 1e-4
SEED, DIM, K = 1234, 24, 10
CPU = "cpu"


@pytest.fixture(scope="module")
def data():
    return np.random.default_rng(SEED).standard_normal((2500, DIM)).astype(np.float32)


@pytest.fixture(scope="module")
def jindex(data):
    return jann.ivf_flat_build(jnp.asarray(data), jann.IVFFlatParams(nlist=24, nprobe=6),
                               seed=SEED)


@pytest.fixture(scope="module")
def pindex(jindex):
    return ivf_flat_index_from_reference(jindex, device=CPU)


@pytest.fixture(scope="module")
def jooc_index(jindex):
    return jooc.ivf_flat_to_ooc(jindex)


@pytest.fixture
def ooc(jooc_index):
    return ooc_ivf_flat_from_reference(jooc_index, device=CPU)


@pytest.fixture
def rng():
    return np.random.default_rng(SEED + 1)


def _q(rng, n, dim=DIM):
    return rng.standard_normal((n, dim)).astype(np.float32)


def _pool(ooc, name, tiles=10, slots=4):
    return TilePool(slots, tiles * slots * (ooc.slot_bytes() + 4), name=name, device=CPU)


def _jpool(ooc, name, tiles=10, slots=4):
    return JaxTilePool(slots, tiles * slots * (ooc.slot_bytes() + 4), name=name)


def _pool_value(name, pool, attr="value"):
    fam = default_registry().get(name)
    if fam is not None:
        for labels, series in fam.series():
            if labels.get("pool") == pool:
                return float(getattr(series, attr))
    return 0.0


def _resident(pindex, q, k=K, **kw):
    return pann.ivf_flat_search(pindex, q, k, scan_impl="scan", device=CPU, **kw)


def _assert_bitwise(got, want):
    assert got[1].dtype == torch.int32
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def _assert_jax_close(got, jgot):
    assert_knn_close(np.asarray(jgot[0]), np.asarray(jgot[1]), got[0].numpy(), got[1].numpy(),
                     RTOL, ATOL)


# --------------------------------------------------------------------- #
# the index and its conversions
# --------------------------------------------------------------------- #
def test_conversion_matches_demotion(pindex, jooc_index, ooc):
    mine = ivf_flat_to_ooc(pindex)
    assert isinstance(mine, OocIVFFlat) and isinstance(mine.store, np.ndarray)
    assert mine.store.flags.writeable and not np.shares_memory(
        mine.store, pindex.slot_vecs.numpy())
    for field in OocIVFFlat._fields:
        a, b, j = getattr(mine, field), getattr(ooc, field), getattr(jooc_index, field)
        if field in ("metric", "nprobe"):
            assert int(a) == int(b) == int(j)
            continue
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        np.testing.assert_array_equal(np.asarray(a), np.asarray(j))
    assert isinstance(ooc.slot_centroid, np.ndarray) and ooc.slot_centroid.dtype == np.int32
    assert ooc.slot_bytes() == jooc_index.slot_bytes()
    assert ooc.store_bytes() == jooc_index.store_bytes()
    back = ooc_ivf_flat_to_numpy(ooc)
    assert all(isinstance(getattr(back, f), np.ndarray) for f in ("slot_ids", "store"))


# --------------------------------------------------------------------- #
# search identity
# --------------------------------------------------------------------- #
def test_cold_only(pindex, jooc_index, ooc, rng):
    q = _q(rng, 9)
    got = ooc_ivf_flat_search(ooc, q, K, pool=_pool(ooc, "id-cold"), device=CPU)
    _assert_bitwise(got, _resident(pindex, q))
    _assert_jax_close(got, jooc.ooc_ivf_flat_search(jooc_index, jnp.asarray(q), K,
                                                    pool=_jpool(ooc, "id-cold-jax")))


def test_hot_plus_cold(pindex, jooc_index, ooc, rng):
    q = _q(rng, 9)
    hot = materialize_hot(ooc, np.arange(6), pool_name="id-hot", device=CPU)
    pool = _pool(ooc, "id-hot")
    got = ooc_ivf_flat_search(ooc, q, K, pool=pool, hot=hot, device=CPU)
    _assert_bitwise(got, _resident(pindex, q))
    jhot = jooc.materialize_hot(jooc_index, np.arange(6), pool_name="id-hot-jax")
    _assert_jax_close(got, jooc.ooc_ivf_flat_search(jooc_index, jnp.asarray(q), K,
                                                    pool=_jpool(ooc, "id-hot-jax"), hot=jhot))
    assert pool.n_staged > 0 and pool.staged_bytes() == 0


def test_all_hot_streams_nothing(pindex, jooc_index, ooc, rng):
    q = _q(rng, 5)
    hot = materialize_hot(ooc, np.arange(ooc.n_slots), pool_name="id-allhot", device=CPU)
    pool = _pool(ooc, "id-allhot")
    got = ooc_ivf_flat_search(ooc, q, K, pool=pool, hot=hot, device=CPU)
    _assert_bitwise(got, _resident(pindex, q))
    assert pool.n_staged == 0
    jhot = jooc.materialize_hot(jooc_index, np.arange(ooc.n_slots), pool_name="id-allhot-jax")
    _assert_jax_close(got, jooc.ooc_ivf_flat_search(jooc_index, jnp.asarray(q), K,
                                                    pool=_jpool(ooc, "id-allhot-jax"), hot=jhot))


@pytest.mark.parametrize("tile_slots", [1, 4, 7])
def test_synchronous_arm_matches_overlapped(pindex, jooc_index, ooc, rng, tile_slots):
    q = _q(rng, 7)
    a = ooc_ivf_flat_search(ooc, q, K, pool=_pool(ooc, "id-ov", slots=tile_slots),
                            overlap=True, device=CPU)
    b = ooc_ivf_flat_search(ooc, q, K, pool=_pool(ooc, "id-sy", slots=tile_slots),
                            overlap=False, device=CPU)
    _assert_bitwise(a, b)
    _assert_bitwise(a, _resident(pindex, q))
    _assert_jax_close(b, jooc.ooc_ivf_flat_search(
        jooc_index, jnp.asarray(q), K, pool=_jpool(ooc, "id-sy-jax", slots=tile_slots),
        overlap=False))


def test_delta_merge(pindex, jooc_index, ooc, rng):
    dv = _q(rng, 8)
    di = np.array([9000, 9001, 9002, -1, -1, -1, -1, -1], np.int32)
    q = _q(rng, 6)
    got = ooc_ivf_flat_search(ooc, q, K, pool=_pool(ooc, "id-delta"), delta=(dv, di),
                              device=CPU)
    _assert_bitwise(got, _resident(pindex, q, delta=(dv, di)))
    _assert_jax_close(got, jooc.ooc_ivf_flat_search(
        jooc_index, jnp.asarray(q), K, pool=_jpool(ooc, "id-delta-jax"),
        delta=(jnp.asarray(dv), jnp.asarray(di))))


def test_sqrt_metric(rng):
    X = _q(np.random.default_rng(SEED), 1200, 16)
    jidx = jann.ivf_flat_build(jnp.asarray(X), jann.IVFFlatParams(nlist=12, nprobe=4),
                               metric=JD.L2SqrtExpanded, seed=SEED)
    pidx = ivf_flat_index_from_reference(jidx, device=CPU)
    ooc = ivf_flat_to_ooc(pidx)
    q = _q(rng, 4, 16)
    got = ooc_ivf_flat_search(ooc, q, 5, pool=_pool(ooc, "id-sqrt"), device=CPU)
    _assert_bitwise(got, _resident(pidx, q, k=5))
    jgot = jooc.ooc_ivf_flat_search(jooc.ivf_flat_to_ooc(jidx), jnp.asarray(q), 5,
                                    pool=_jpool(ooc, "id-sqrt-jax"))
    _assert_jax_close(got, jgot)


def test_force_rounds_is_a_result_noop(pindex, ooc, rng):
    hot = materialize_hot(ooc, np.arange(ooc.n_slots), pool_name="id-fr", device=CPU)
    pool = _pool(ooc, "id-fr")
    q = _q(rng, 5)
    want = ooc_ivf_flat_search(ooc, q, K, pool=pool, hot=hot, device=CPU)
    got = ooc_ivf_flat_search(ooc, q, K, pool=pool, hot=hot, force_rounds=2, device=CPU)
    _assert_bitwise(got, want)
    _assert_bitwise(got, _resident(pindex, q))
    assert pool.n_staged == 2 and pool.n_taken == 2       # the forced empty tiles


@pytest.mark.parametrize("hot_slots", [0, 5])
def test_kernel_route_matches_the_resident_kernel_route(pindex, ooc, rng, hot_slots):
    """K3's route (its plain version on the CPU) scans each part with the
    part's rows; the distances equal the resident kernel route's."""
    q = _q(rng, 11)
    hot = (materialize_hot(ooc, np.arange(hot_slots), pool_name="id-k3", device=CPU)
           if hot_slots else None)
    got = ooc_ivf_flat_search(ooc, q, K, pool=_pool(ooc, "id-k3"), hot=hot, scan_impl="kernel",
                              device=CPU)
    want = pann.ivf_flat_search(pindex, q, K, scan_impl="kernel", device=CPU)
    assert torch.equal(got[0], want[0])
    assert_knn_close(want[0].numpy(), want[1].numpy(), got[0].numpy(), got[1].numpy(), 0.0, 0.0)


def test_argument_checks(ooc):
    pool = _pool(ooc, "id-args")
    with pytest.raises(LogicError, match="nprobe"):
        ooc_ivf_flat_search(ooc, np.zeros((2, DIM), np.float32), 5, nprobe=0, pool=pool,
                            device=CPU)
    with pytest.raises(RaftError, match="select_impl='approx' is illegal.*legal: kernel, sort"):
        ooc_ivf_flat_search(ooc, np.zeros((2, DIM), np.float32), 5, pool=pool,
                            select_impl="approx", device=CPU)
    with pytest.raises(LogicError, match="scan_impl"):
        ooc_ivf_flat_search(ooc, np.zeros((2, DIM), np.float32), 5, pool=pool,
                            scan_impl="xla", device=CPU)
    with pytest.raises(LogicError, match="queries"):
        ooc_ivf_flat_search(ooc, np.zeros((2, DIM + 1), np.float32), 5, pool=pool, device=CPU)


def test_tile_hit_miss_accounting(jooc_index, ooc, rng):
    hot = materialize_hot(ooc, np.arange(ooc.n_slots // 2), pool_name="id-acct", device=CPU)
    h0 = _pool_value("raft_tpu_tile_hits_total", "id-acct")
    m0 = _pool_value("raft_tpu_tile_misses_total", "id-acct")
    seen = []
    ooc_ivf_flat_search(ooc, _q(rng, 8), K, pool=_pool(ooc, "id-acct"), hot=hot,
                        nprobe=int(ooc.centroids.shape[0]),
                        probe_hook=lambda d, c: seen.append((d, c)), device=CPU)
    hits = _pool_value("raft_tpu_tile_hits_total", "id-acct") - h0
    miss = _pool_value("raft_tpu_tile_misses_total", "id-acct") - m0
    # a full probe touches every non-empty slot once
    n_live = int((ooc.slot_ids[:, 0] >= 0).sum())
    assert hits + miss == n_live and hits > 0 and miss > 0
    assert hits == ooc.n_slots // 2
    (distinct, counts), = seen
    assert distinct.size == n_live and (counts == 8).all()


@pytest.mark.parametrize("tile_slots", [1, 3, 4])
def test_h2d_bytes_are_the_cold_slots_in_whole_tiles(ooc, rng, tile_slots):
    """One search streams ceil(cold / tile_slots) tiles, never the store."""
    name = "id-h2d-%d" % tile_slots
    pool = _pool(ooc, name, slots=tile_slots)
    hot_ids = np.arange(0, ooc.n_slots, 3)
    hot = materialize_hot(ooc, hot_ids, pool_name=name + "-hot", device=CPU)
    seen = []
    b0 = _pool_value("raft_tpu_h2d_bytes_total", name)
    ooc_ivf_flat_search(ooc, _q(rng, 6), K, pool=pool, hot=hot,
                        probe_hook=lambda d, c: seen.append(d), device=CPU)
    streamed = _pool_value("raft_tpu_h2d_bytes_total", name) - b0
    cold = np.setdiff1d(seen[0], hot_ids)
    tiles = -(-cold.size // tile_slots)
    assert tiles == pool.n_staged > 0
    assert streamed == tiles * tile_slots * (ooc.slot_bytes() + 4)
    assert streamed < ooc.store_bytes()
    hot_b = _pool_value("raft_tpu_h2d_bytes_total", name + "-hot")
    assert hot_b == hot_ids.size * (ooc.slot_bytes() + 4)


@pytest.mark.parametrize("fail_at", [1, 2])
def test_a_failure_mid_stream_discards_the_staged_tile(ooc, rng, monkeypatch, fail_at):
    """A device failure that surfaces while a tile is staged and not taken
    (here: at the query of the scans' event before the take) gives the
    tile's budget back."""
    import raft_tpu_torch.spatial.ooc as mod

    pool = _pool(ooc, "id-fail-%d" % fail_at, slots=1)
    calls = []

    def idle(dev):
        calls.append(1)
        if len(calls) == fail_at:
            raise RuntimeError("scan failed")
        return True

    monkeypatch.setattr(mod, "_compute_idle", idle)
    with pytest.raises(RuntimeError, match="scan failed"):
        ooc_ivf_flat_search(ooc, _q(rng, 4), K, pool=pool, device=CPU)
    assert pool.staged_bytes() == 0
    assert (pool.n_staged, pool.n_taken) == (fail_at, fail_at - 1)
    # the pool serves on after the failure
    monkeypatch.undo()
    got = ooc_ivf_flat_search(ooc, _q(rng, 4), K, pool=pool, device=CPU)
    assert got[0].shape == (4, K) and pool.staged_bytes() == 0


# --------------------------------------------------------------------- #
# host-side extend and reconstruct
# --------------------------------------------------------------------- #
def test_reconstruct_roundtrip(pindex, jooc_index, ooc):
    vecs_r, ids_r = pann.ivf_flat_reconstruct(pindex)
    vecs_o, ids_o = ooc_reconstruct(ooc)
    vecs_j, ids_j = jooc.ooc_reconstruct(jooc_index)
    np.testing.assert_array_equal(ids_o, ids_r)
    np.testing.assert_array_equal(vecs_o, vecs_r)
    np.testing.assert_array_equal(ids_o, ids_j)
    np.testing.assert_array_equal(vecs_o, vecs_j)


def test_extend_matches_resident_extend_and_jax(pindex, jooc_index, ooc, rng):
    new_v = _q(rng, 40)
    new_i = np.arange(50_000, 50_040)
    resident = pann.ivf_flat_extend(pindex, new_v, new_i, slot_multiple=16, device=CPU)
    ext = ooc_extend(ooc, new_v, new_i, slot_multiple=16)
    jext = jooc.ooc_extend(jooc_index, new_v, new_i, slot_multiple=16)
    np.testing.assert_array_equal(ext.slot_ids.numpy(), resident.slot_ids.numpy())
    np.testing.assert_array_equal(ext.store, resident.slot_vecs.numpy())
    np.testing.assert_array_equal(ext.slot_ids.numpy(), np.asarray(jext.slot_ids))
    np.testing.assert_array_equal(ext.store, jext.store)
    np.testing.assert_array_equal(ext.slot_centroid, jext.slot_centroid)
    np.testing.assert_array_equal(ext.cent_slots.numpy(), np.asarray(jext.cent_slots))
    np.testing.assert_allclose(ext.slot_norms.numpy(), np.asarray(jext.slot_norms),
                               rtol=RTOL, atol=ATOL)
    assert isinstance(ext.store, np.ndarray) and isinstance(ext, OocIVFFlat)
    q = _q(rng, 6)
    got = ooc_ivf_flat_search(ext, q, K, pool=_pool(ext, "ex-search"), device=CPU)
    want = _resident(resident, q)
    # the ids are equal; the norms of the rebuilt store are an einsum on
    # the host (as in the JAX package), a torch sum in the resident extend
    assert torch.equal(got[1], want[1])
    np.testing.assert_allclose(got[0].numpy(), want[0].numpy(), rtol=RTOL, atol=ATOL)


def test_extend_with_no_rows_keeps_the_content(ooc):
    ext = ooc_extend(ooc, np.zeros((0, DIM), np.float32), np.zeros(0, np.int64))
    a, b = ooc_reconstruct(ext), ooc_reconstruct(ooc)
    np.testing.assert_array_equal(np.sort(a[1]), np.sort(b[1]))
    with pytest.raises(LogicError, match="ids"):
        ooc_extend(ooc, np.zeros((2, DIM), np.float32), np.arange(3))


# --------------------------------------------------------------------- #
# ANNService(ooc=True)
# --------------------------------------------------------------------- #
def _opts(index, budget_frac, **kw):
    store_bytes = (index.slot_vecs.numel() * 4 if isinstance(index, pann.IVFFlatIndex)
                   else index.store_bytes())
    kw.setdefault("device_budget_bytes", max(1, int(store_bytes * budget_frac)))
    kw.setdefault("max_batch_rows", 32)
    kw.setdefault("bucket_rungs", (8, 32))
    kw.setdefault("max_wait_ms", 1.0)
    kw.setdefault("nprobe_ladder", (4, 8))
    kw.setdefault("delta_cap", 64)
    kw.setdefault("compact_rows", 0)
    return kw


def make_svc(index, *, budget_frac=0.3, **kw):
    return ANNService(index, k=K, ooc=True, start=False, device=CPU, **_opts(index, budget_frac,
                                                                               **kw))


def _step(svc, fut, timeout=30.0):
    t0 = time.monotonic()
    while not fut.done():
        svc.worker.run_once()
        if fut.done():
            break
        assert time.monotonic() - t0 < timeout, "future did not resolve"
        time.sleep(0.001)
    return fut.result(timeout=0)


def test_budget_split_and_first_hot_set_match_jax(jindex, pindex):
    jsvc = JaxANNService(jindex, k=K, ooc=True, start=False, **_opts(pindex, 0.3))
    svc = make_svc(pindex)
    try:
        st, jst = svc.stats()["ooc"], jsvc.stats()["ooc"]
        for key in ("budget_bytes", "store_bytes", "hot_slots", "hot_cap", "tile_slots",
                    "staged_bytes", "overlap"):
            assert st[key] == jst[key], key
        assert svc._ooc_pool.budget_bytes == jsvc._ooc_pool.budget_bytes
        np.testing.assert_array_equal(svc._ooc_hot_ids, jsvc._ooc_hot_ids)
        assert svc.stats()["kind"] == jsvc.stats()["kind"] == "OocIVFFlat"
        reg = default_registry()
        for gauge in ("raft_tpu_ooc_hot_slots", "raft_tpu_ooc_hot_bytes"):
            vals = {lbl["service"]: s.value for lbl, s in reg.get(gauge).series()}
            assert vals[svc.name] == (st["hot_slots"] if gauge.endswith("slots")
                                      else st["hot_slots"] * svc._ooc.slot_bytes())
    finally:
        svc.close()
        jsvc.close()


def test_served_rows_bitwise_to_the_resident_search(pindex, rng):
    svc = make_svc(pindex)
    svc.warmup()
    assert svc._ooc_pool.n_staged > 0             # warmup streamed tiles
    try:
        for n in (6, 1, 20):
            q = _q(rng, n)
            d, i = _step(svc, svc.submit(q))
            padded = pad_rows(torch.from_numpy(q), svc.policy.bucket_for(n))
            d0, i0 = _resident(pindex, padded, nprobe=svc.nprobe)
            assert torch.equal(d, d0[:n]) and torch.equal(i, i0[:n])
    finally:
        svc.close()


def test_served_rows_close_to_the_jax_service(jindex, pindex, rng):
    jsvc = JaxANNService(jindex, k=K, ooc=True, start=False, **_opts(pindex, 0.3))
    svc = make_svc(pindex)
    try:
        q = _q(rng, 6)
        got = _step(svc, svc.submit(q))
        jgot = _step(jsvc, jsvc.submit(jnp.asarray(q)))
        _assert_jax_close(got, jgot)
    finally:
        svc.close()
        jsvc.close()


def test_budget_never_exceeded(pindex, rng):
    svc = make_svc(pindex)
    svc.warmup()
    try:
        for _ in range(4):
            _step(svc, svc.submit(_q(rng, 8)))
        st = svc.stats()["ooc"]
        staged_hw = _pool_value("raft_tpu_tile_staged_bytes", svc.name, "high_water")
        assert 0 < staged_hw <= st["pool_budget_bytes"]
        assert st["hot_slots"] * svc._ooc.slot_bytes() + staged_hw <= st["budget_bytes"] * 1.001
        assert st["store_bytes"] > st["budget_bytes"]      # oversubscribed
    finally:
        svc.close()


def test_insert_visible_and_compaction_exact(pindex, rng):
    svc = make_svc(pindex)
    svc.warmup()
    try:
        probe = rng.standard_normal((2, DIM)).astype(np.float32) * 0.01
        svc.insert([77000, 77001], probe)
        _, i = _step(svc, svc.submit(np.zeros((1, DIM), np.float32)))
        assert 77000 in set(i.numpy().ravel().tolist())
        old_store = svc._ooc.store
        assert svc.compact() is True and svc.delta_rows == 0
        assert isinstance(svc.index, OocIVFFlat) and svc.index.store is not old_store
        _, i2 = _step(svc, svc.submit(np.zeros((1, DIM), np.float32)))
        assert 77000 in set(i2.numpy().ravel().tolist())
        # after the swap a full probe equals brute force over the store
        vecs, ids = svc.ground_truth_store()
        q = _q(rng, 4)
        _, gt_rows = brute_force_knn(vecs, q, K, device=CPU)
        gt = ids[gt_rows.numpy()]
        svc.set_nprobe(int(svc._nlist))
        _, i4 = _step(svc, svc.submit(q))
        np.testing.assert_array_equal(i4.numpy(), gt)
        assert svc.stats()["ooc"]["hot_slots"] == svc.stats()["ooc"]["hot_cap"]
    finally:
        svc.close()


def test_promotion_moves_the_hot_set(pindex):
    svc = make_svc(pindex, budget_frac=0.25, ooc_promote_batches=2)
    svc.warmup()
    try:
        ev0 = _pool_value("raft_tpu_tile_evictions_total", svc.name)
        hot_before = svc._ooc_hot_ids.copy()
        # traffic on one region of the data, so that the measured top
        # slots leave the list-size seeding
        base = pann.ivf_flat_reconstruct(pindex)[0][:4]
        q = (base + 0.01).astype(np.float32)
        for _ in range(8):
            _step(svc, svc.submit(q))
            svc.worker.run_maintenance()
        assert not np.array_equal(hot_before, svc._ooc_hot_ids)
        assert _pool_value("raft_tpu_tile_evictions_total", svc.name) > ev0
        assert any(e.kind == "hot_promote" and e.service == svc.name
                   for e in flight.default_recorder().events())
        # the promoted set serves the same answers
        d, i = _step(svc, svc.submit(q))
        padded = pad_rows(torch.from_numpy(q), svc.policy.bucket_for(len(q)))
        d0, i0 = _resident(pindex, padded, nprobe=svc.nprobe)
        assert torch.equal(d, d0[:len(q)]) and torch.equal(i, i0[:len(q)])
    finally:
        svc.close()


def test_rejects_bad_combinations(pindex, rng):
    with pytest.raises(LogicError, match="budget"):
        ANNService(pindex, k=5, ooc=True, start=False, device=CPU)
    with pytest.raises(LogicError, match="3 tiles"):
        make_svc(pindex, device_budget_bytes=1000)
    with pytest.raises(LogicError, match="refine_ratio"):
        make_svc(pindex, refine_ratio=4)
    X = _q(rng, 600, 16)
    pq = pann.ivf_pq_build(X, pann.IVFPQParams(nlist=8, M=4), seed=SEED, device=CPU)
    with pytest.raises(LogicError, match="IVF-Flat"):
        ANNService(pq, k=5, ooc=True, device_budget_bytes=1 << 20, start=False, device=CPU)
    # out-of-core knobs on a resident service: an error, not a silent no-op
    for kw in (dict(device_budget_bytes=1 << 20), dict(tile_slots=4)):
        with pytest.raises(LogicError, match="out-of-core"):
            ANNService(pindex, k=5, start=False, device=CPU, **kw)


def test_an_ooc_index_implies_ooc(ooc):
    svc = make_svc(ooc)
    try:
        assert svc.stats()["ooc"]["store_bytes"] == ooc.store_bytes()
        assert svc.stats()["kind"] == "OocIVFFlat"
    finally:
        svc.close()


def test_budget_knob(pindex, monkeypatch):
    from raft_tpu_torch import config

    budget = int(pindex.slot_vecs.numel() * 4 * 0.3)
    monkeypatch.setenv("RAFT_TPU_SERVE_ANN_DEVICE_BUDGET_BYTES", str(budget))
    assert config.get_int("serve_ann_device_budget_bytes") == budget
    svc = ANNService(pindex, k=5, ooc=True, start=False, device=CPU)
    try:
        assert svc.stats()["ooc"]["budget_bytes"] == budget
    finally:
        svc.close()
    monkeypatch.delenv("RAFT_TPU_SERVE_ANN_DEVICE_BUDGET_BYTES")
    assert config.get_int("serve_ann_device_budget_bytes") == 0


def test_synchronous_service_serves_the_same(pindex, rng):
    a, b = make_svc(pindex), make_svc(pindex, ooc_overlap=False)
    try:
        assert b.stats()["ooc"]["overlap"] is False
        q = _q(rng, 12)
        _assert_bitwise(_step(a, a.submit(q)), _step(b, b.submit(q)))
    finally:
        a.close()
        b.close()


def test_calibrate_over_the_ooc_store(pindex, rng):
    svc = make_svc(pindex, nprobe_ladder=(2, 24))
    svc.warmup()
    try:
        cal = svc.calibrate(_q(rng, 16), target_recall=1.0, measure_all=False)
        assert cal["met_target"] and cal["chosen_nprobe"] <= 24
        vecs, ids = svc.ground_truth_store()
        np.testing.assert_array_equal(np.sort(ids), np.arange(len(ids)))
    finally:
        svc.close()


def test_tile_miss_storm_is_recorded(pindex, rng):
    svc = make_svc(pindex, budget_frac=0.25, tile_slots=1, ooc_promote_batches=10_000)
    try:
        for _ in range(9):
            _step(svc, svc.submit(_q(rng, 8)))
        svc.worker.run_maintenance()
        assert any(e.kind == "tile_miss_storm" and e.service == svc.name
                   for e in flight.default_recorder().events())
    finally:
        svc.close()


def test_results_are_numpy_convertible(pindex, rng):
    svc = make_svc(pindex)
    try:
        d, i = _step(svc, svc.submit(_q(rng, 3)))
        assert to_numpy(d).shape == (3, K) and to_numpy(i).dtype == np.int32
    finally:
        svc.close()
