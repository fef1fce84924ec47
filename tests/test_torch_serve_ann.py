"""Port parity of ANNService (raft_tpu_torch.serve.ann_service) against the
JAX package's ANNService, on the CPU.

Both services serve one index: built by the JAX package and carried into
the port (``convert.ivf_flat_index_from_reference``), since k-means draws
cannot be reproduced across the two packages.  They run threadless
(``start=False``) under a fake clock, stepped by ``worker.run_once()``, as
the JAX package's own ANNService tests and ``test_torch_serve.py`` do;
one test runs a real worker thread under concurrent traffic.

Served results are held bit for bit to the port's own unbatched
``approx_knn_search`` of the batch the worker formed (same snapshot, same
nprobe), and to the JAX service with a tolerance and id sets: RTOL 1e-5,
ATOL 1e-4 on squared L2 of norms up to about 100 here (expanded-form
float32 in another order).  The reference's served-bitwise assertions,
which fail on this tree, are not copied.
"""

import threading
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers.torch_parity import assert_knn_close
from raft_tpu import config as jax_config
from raft_tpu.serve import ANNService as JaxANNService
from raft_tpu.serve.resilience import BreakerState as JaxBreakerState
from raft_tpu.spatial import ann as jann
from raft_tpu_torch import (ANNService, LogicError, RaftError, ServiceOverloadError,
                            approx_knn_search, brute_force_knn, config)
from raft_tpu_torch.convert import ivf_flat_index_from_reference
from raft_tpu_torch.core import flight
from raft_tpu_torch.core.metrics import default_registry
from raft_tpu_torch.serve import BreakerState, pad_rows

DIM, K = 24, 10
RTOL, ATOL = 1e-5, 1e-4


class FakeClock:
    def __init__(self, t=0.0):
        self.t = float(t)

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(1234)
    return rng.standard_normal((2000, DIM)).astype(np.float32)


@pytest.fixture(scope="module")
def jindex(data):
    return jann.ivf_flat_build(jnp.asarray(data, jnp.float32),
                               jann.IVFFlatParams(nlist=16, nprobe=8), seed=1234)


@pytest.fixture(scope="module")
def pindex(jindex):
    return ivf_flat_index_from_reference(jindex, device="cpu")


@pytest.fixture
def rng():
    return np.random.default_rng(7)


SVC_KW = dict(max_batch_rows=32, bucket_rungs=(8, 32), max_wait_ms=10.0, nprobe_ladder=(4, 8),
              delta_cap=64, compact_rows=0)


def make_pair(pindex, jindex, **kw):
    """A port service and a JAX service over the same index, each on a fake
    clock of its own."""
    opts = dict(SVC_KW, **kw)
    clock, jclock = FakeClock(), FakeClock()
    ours = ANNService(pindex, K, start=False, clock=clock, device="cpu", **opts)
    theirs = JaxANNService(jindex, k=K, start=False, clock=jclock, **opts)
    return (ours, clock), (theirs, jclock)


def make_port(pindex, **kw):
    clock = FakeClock()
    return ANNService(pindex, K, start=False, clock=clock, device="cpu",
                      **dict(SVC_KW, **kw)), clock


def serve(svc, clock, blocks):
    """Submit ``blocks`` as one batch window and step the worker once."""
    futs = [svc.submit(b) for b in blocks]
    clock.advance(0.5)
    assert svc.worker.run_once()
    return [f.result(timeout=0) for f in futs]


def _np(out):
    return np.asarray(out[0]), np.asarray(out[1])


def _blocks(rng, rows):
    return [rng.standard_normal((r, DIM)).astype(np.float32) for r in rows]


# ---------------------------------------------------------------------- #
# served results
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("with_delta", [False, True], ids=["no delta", "delta"])
def test_served_is_bitwise_the_port_search(pindex, rng, with_delta):
    svc, clock = make_port(pindex)
    delta = None
    if with_delta:
        svc.insert(np.arange(90000, 90020), rng.standard_normal((20, DIM)).astype(np.float32))
        st = svc._ann_state
        delta = (st.delta_vecs, st.delta_ids)
    blocks = _blocks(rng, (3, 1, 9))
    got = serve(svc, clock, blocks)
    padded = pad_rows(torch.from_numpy(np.concatenate(blocks)), 16)
    pd, pi = approx_knn_search(svc.index, padded, K, nprobe=svc.nprobe, delta=delta,
                               device="cpu")
    at = 0
    for (d, i), b in zip(got, blocks):
        assert d.shape == (len(b), K) and i.dtype == torch.int32
        assert torch.equal(d, pd[at:at + len(b)]) and torch.equal(i, pi[at:at + len(b)])
        # the request searched alone: a matmul may round a row otherwise at
        # another row count, so by tolerance and id sets
        ad, ai = approx_knn_search(svc.index, b, K, nprobe=svc.nprobe, delta=delta, device="cpu")
        assert_knn_close(ad.numpy(), ai.numpy(), d.numpy(), i.numpy(), RTOL, ATOL)
        at += len(b)
    svc.close()


@pytest.mark.parametrize("with_delta", [False, True], ids=["no delta", "delta"])
def test_served_matches_the_jax_service(pindex, jindex, rng, with_delta):
    (ours, clock), (theirs, jclock) = make_pair(pindex, jindex)
    if with_delta:
        ids = np.arange(90000, 90030)
        vecs = rng.standard_normal((30, DIM)).astype(np.float32)
        assert ours.insert(ids, vecs) == theirs.insert(ids, jnp.asarray(vecs)) == 30
    blocks = _blocks(rng, (5, 2, 11))
    got = serve(ours, clock, blocks)
    ref = serve(theirs, jclock, [jnp.asarray(b) for b in blocks])
    for (d, i), r in zip(got, ref):
        assert_knn_close(*_np(r), d.numpy(), i.numpy(), RTOL, ATOL)
    ours.close()
    theirs.close()


def test_warmup_leaves_nothing_to_build(pindex, rng):
    svc, clock = make_port(pindex)
    assert svc.kernel_libraries_after_warmup() is None
    svc.warmup()
    assert svc.warmed_rungs == (8, 32)
    serve(svc, clock, _blocks(rng, (4,)))
    svc.insert([90000], rng.standard_normal((1, DIM)).astype(np.float32))
    serve(svc, clock, _blocks(rng, (20,)))
    assert svc.kernel_libraries_after_warmup() == {"builds": 0, "loads": 0}
    assert svc.stats()["warmed"]
    svc.close()


# ---------------------------------------------------------------------- #
# streaming ingestion and compaction
# ---------------------------------------------------------------------- #
def test_insert_is_visible_to_the_next_batch(pindex, rng):
    svc, clock = make_port(pindex)
    probe = rng.standard_normal((1, DIM)).astype(np.float32)
    _, i0 = serve(svc, clock, [probe])[0]
    assert 77777 not in set(i0.numpy().ravel())
    assert svc.insert([77777], probe) == 1 and svc.delta_rows == 1
    d1, i1 = serve(svc, clock, [probe])[0]
    assert int(i1[0, 0]) == 77777 and float(d1[0, 0]) <= 1e-5
    svc.close()


def test_published_snapshot_is_private(pindex, rng):
    # a later append to the host mirror never reaches a published snapshot
    svc, _ = make_port(pindex)
    svc.insert([1], rng.standard_normal((1, DIM)).astype(np.float32))
    st = svc._ann_state
    before = st.delta_vecs.clone(), st.delta_ids.clone()
    svc.insert([2, 3], rng.standard_normal((2, DIM)).astype(np.float32))
    assert st.delta_rows == 1 and svc.delta_rows == 3
    assert torch.equal(st.delta_vecs, before[0]) and torch.equal(st.delta_ids, before[1])
    svc.close()


def test_insert_validation_and_a_full_delta_sheds(pindex, rng):
    svc, _ = make_port(pindex, delta_cap=8)
    with pytest.raises(LogicError):
        svc.insert([-1], rng.standard_normal((1, DIM)))
    with pytest.raises(LogicError):
        svc.insert([1, 2], rng.standard_normal((1, DIM)))
    with pytest.raises(LogicError):
        svc.insert(np.arange(9), rng.standard_normal((9, DIM)))
    with pytest.raises(LogicError):
        svc.insert([1], rng.standard_normal((1, DIM + 1)))
    assert svc.insert([], np.zeros((0, DIM), np.float32)) == 0
    svc.insert(np.arange(6), rng.standard_normal((6, DIM)))
    with pytest.raises(ServiceOverloadError) as exc:
        svc.insert([6, 7, 8], rng.standard_normal((3, DIM)))
    assert exc.value.retry_after_s > 0
    assert svc.delta_rows == 6              # shed, not corrupted
    svc.close()
    with pytest.raises(LogicError, match="closed"):
        svc.insert([9], rng.standard_normal((1, DIM)))


def test_results_hold_across_the_compaction_swap(pindex, rng):
    # a full probe: below it the slots legitimately miss neighbours that the
    # delta's brute force finds
    svc, clock = make_port(pindex, nprobe=16, nprobe_ladder=(16,))
    new_v = rng.standard_normal((12, DIM)).astype(np.float32)
    svc.insert(np.arange(50000, 50012), new_v)
    q = rng.standard_normal((7, DIM)).astype(np.float32)
    d_pre, i_pre = serve(svc, clock, [q])[0]
    old = svc.index
    assert svc.compact()
    assert svc.delta_rows == 0 and svc.index is not old
    d_post, i_post = serve(svc, clock, [q])[0]
    assert_knn_close(d_pre.numpy(), i_pre.numpy(), d_post.numpy(), i_post.numpy(), RTOL, ATOL)
    vecs, ids = svc.ground_truth_store()
    _, bi = brute_force_knn(vecs, q, K, device="cpu")
    want = ids[bi.numpy()]
    for r in range(q.shape[0]):
        assert set(i_post[r].tolist()) == set(want[r].tolist())
    assert svc.compact() is False
    svc.close()


def test_compaction_matches_the_jax_fold(pindex, jindex, rng):
    (ours, clock), (theirs, jclock) = make_pair(pindex, jindex)
    ids, vecs = np.arange(60000, 60040), rng.standard_normal((40, DIM)).astype(np.float32)
    ours.insert(ids, vecs)
    theirs.insert(ids, jnp.asarray(vecs))
    assert ours.compact() and theirs.compact()
    for name in ("slot_ids", "slot_centroid", "cent_slots", "list_sizes"):
        np.testing.assert_array_equal(getattr(ours.index, name).numpy(),
                                      np.asarray(getattr(theirs.index, name)))
    np.testing.assert_array_equal(ours.index.slot_vecs.numpy(),
                                  np.asarray(theirs.index.slot_vecs))
    blocks = _blocks(rng, (6,))
    got, ref = serve(ours, clock, blocks), serve(theirs, jclock, [jnp.asarray(blocks[0])])
    assert_knn_close(*_np(ref[0]), got[0][0].numpy(), got[0][1].numpy(), RTOL, ATOL)
    ours.close()
    theirs.close()


def test_maintenance_compacts_at_the_threshold_not_while_draining(pindex, rng):
    svc, clock = make_port(pindex, compact_rows=16)
    svc.insert(np.arange(100, 110), rng.standard_normal((10, DIM)))
    svc.worker.run_maintenance()
    assert svc.delta_rows == 10
    svc.insert(np.arange(110, 120), rng.standard_normal((10, DIM)))
    svc.worker.run_maintenance()
    assert svc.delta_rows == 0
    fam = default_registry().get("raft_tpu_serve_ann_compactions_total")
    assert [s.value for lbl, s in fam.series() if lbl["service"] == svc.name] == [1.0]
    ev = flight.default_recorder().events(service=svc.name, kind="compaction")
    assert ev and ev[-1].attrs["rows"] == 20
    assert svc.stats()["last_compact_s"] >= 0.0
    svc.insert(np.arange(200, 220), rng.standard_normal((20, DIM)))
    svc.batcher.begin_drain()
    svc.worker.run_maintenance()
    assert svc.delta_rows == 20
    svc.close()


def test_inserts_and_compaction_under_concurrent_traffic(pindex, rng):
    # a real worker thread; submitters and an inserter race the automatic
    # compaction: every future resolves and every inserted row is found
    svc = ANNService(pindex, K, device="cpu", max_batch_rows=32, bucket_rungs=(8, 32),
                     max_wait_ms=0.5, nprobe=16, nprobe_ladder=(16,), delta_cap=64,
                     compact_rows=24, maintenance_interval_s=0.005)
    qs = _blocks(rng, [2] * 40)
    new = rng.standard_normal((96, DIM)).astype(np.float32)
    futs, errors = [], []

    def submitter(t):
        try:
            for q in qs[t::4]:
                futs.append(svc.submit(q))
        except Exception as e:  # noqa: BLE001 — re-raised below
            errors.append(e)

    def inserter():
        try:
            for c in range(0, 96, 8):
                while True:
                    try:
                        svc.insert(np.arange(80000 + c, 80008 + c), new[c:c + 8])
                        break
                    except ServiceOverloadError:
                        threading.Event().wait(0.01)
        except Exception as e:  # noqa: BLE001 — re-raised below
            errors.append(e)

    threads = [threading.Thread(target=submitter, args=(t,)) for t in range(4)]
    threads.append(threading.Thread(target=inserter))
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    assert not any(t.is_alive() for t in threads) and not errors, errors
    for f in futs:
        assert f.result(timeout=60)[1].shape == (2, K)
    svc.compact()
    found = svc.submit(new[:32]).result(timeout=60)
    assert torch.equal(found[1][:, 0], torch.arange(80000, 80032, dtype=torch.int32))
    assert svc.drain(timeout=30)
    svc.close()
    assert not svc.worker.is_alive()


# ---------------------------------------------------------------------- #
# recall-targeted dispatch and degraded dispatch
# ---------------------------------------------------------------------- #
def test_calibrate_picks_the_cell_jax_picks():
    rng = np.random.default_rng(1234)
    centers = rng.standard_normal((16, DIM)).astype(np.float32) * 8
    X = (centers[rng.integers(0, 16, 4000)]
         + 0.1 * rng.standard_normal((4000, DIM))).astype(np.float32)
    jidx = jann.ivf_flat_build(jnp.asarray(X), jann.IVFFlatParams(nlist=16, nprobe=8), seed=1234)
    pidx = ivf_flat_index_from_reference(jidx, device="cpu")
    q = (X[:32] + 0.05 * rng.standard_normal((32, DIM))).astype(np.float32)
    ladder = (1, 2, 4, 16)
    (ours, _), (theirs, _) = make_pair(pidx, jidx, nprobe_ladder=ladder)
    # the JAX ground truth flips one tie at the rank boundary against its
    # own slot scan (recall 0.9969 at a full probe), so the targets stay
    # below that
    for kw in (dict(target_recall=0.9), dict(target_recall=0.95, measure_all=True)):
        got, ref = ours.calibrate(q, **kw), theirs.calibrate(jnp.asarray(q), **kw)
        assert got["chosen_nprobe"] == ref["chosen_nprobe"]
        assert got["met_target"] == ref["met_target"]
        assert [r["nprobe"] for r in got["table"]] == [r["nprobe"] for r in ref["table"]]
        for a, b in zip(got["table"], ref["table"]):
            assert abs(a["recall_at_k"] - b["recall_at_k"]) <= 0.02
        assert ours.nprobe == theirs.nprobe == got["chosen_nprobe"]
    fam = default_registry().get("raft_tpu_serve_ann_recall")
    cells = {int(lbl["nprobe"]) for lbl, _ in fam.series() if lbl["service"] == ours.name}
    assert cells == set(ours.nprobe_ladder) == set(ladder) | {8}   # the index default joins
    ours.close()
    theirs.close()


def test_ground_truth_store_matches_jax(pindex, jindex, rng):
    (ours, _), (theirs, _) = make_pair(pindex, jindex)
    ids, vecs = np.arange(70000, 70005), rng.standard_normal((5, DIM)).astype(np.float32)
    ours.insert(ids, vecs)
    theirs.insert(ids, jnp.asarray(vecs))
    (gv, gi), (jv, ji) = ours.ground_truth_store(), theirs.ground_truth_store()
    np.testing.assert_array_equal(gv, np.asarray(jv))
    np.testing.assert_array_equal(gi, np.asarray(ji))
    ref = rng.standard_normal((40, DIM)).astype(np.float32)
    gv, gi = ours.ground_truth_store(ref)
    assert gv.shape == (45, DIM) and list(gi[-5:]) == list(ids)
    ours.close()
    theirs.close()


def test_set_nprobe_clamps_like_jax(pindex, jindex):
    (ours, _), (theirs, _) = make_pair(pindex, jindex)
    assert ours.set_nprobe(999) == theirs.set_nprobe(999) == 16
    assert ours.set_nprobe(3) == theirs.set_nprobe(3) == 3
    for svc in (ours, theirs):
        with pytest.raises(Exception, match="nprobe"):
            svc.set_nprobe(0)
    ours.close()
    theirs.close()


@pytest.mark.parametrize("served", [1, 2, 4, 5, 8, 16])
@pytest.mark.parametrize("levels", [0, 1, 2, 3])
def test_degrade_and_restore_step_the_ladder_like_jax(pindex, jindex, served, levels):
    (ours, _), (theirs, _) = make_pair(pindex, jindex, nprobe_ladder=(2, 4, 8, 16))
    for svc in (ours, theirs):
        svc.set_nprobe(served)
        svc.degrade(levels)
    assert ours._effective_nprobe() == theirs._effective_nprobe()
    for svc in (ours, theirs):
        svc.restore()
    assert ours._effective_nprobe() == theirs._effective_nprobe() == (ours.nprobe, False)
    with pytest.raises(LogicError):
        ours.degrade(-1)
    ours.close()
    theirs.close()


@pytest.mark.parametrize("queued,frac", [(0, 0.5), (3, 0.5), (4, 0.5), (7, 0.5), (7, 0.0)])
def test_queue_pressure_brownout_like_jax(pindex, jindex, rng, queued, frac):
    (ours, clock), (theirs, jclock) = make_pair(pindex, jindex, queue_cap=8,
                                                degrade_queue_frac=frac)
    blocks = _blocks(rng, [1] * queued)
    for b in blocks:
        ours.submit(b)
        theirs.submit(jnp.asarray(b))
    assert ours._effective_nprobe() == theirs._effective_nprobe()
    assert ours._effective_nprobe() == ((4, True) if frac and queued >= 4 else (8, False))
    ours.close(drain=False)
    theirs.close(drain=False)


def test_half_open_breaker_brownout_like_jax(pindex, jindex):
    (ours, _), (theirs, _) = make_pair(pindex, jindex)
    ours.breaker = types.SimpleNamespace(state=BreakerState.HALF_OPEN)
    theirs.breaker = types.SimpleNamespace(state=JaxBreakerState.HALF_OPEN)
    assert ours._effective_nprobe() == theirs._effective_nprobe() == (4, True)
    ours.breaker = types.SimpleNamespace(state=BreakerState.CLOSED)
    assert ours._effective_nprobe() == (8, False)


def test_degraded_batches_are_counted(pindex, rng):
    svc, clock = make_port(pindex)
    svc.degrade(1)
    serve(svc, clock, _blocks(rng, (3,)))
    reg = default_registry()
    degraded = reg.get("raft_tpu_serve_degraded_batches_total")
    assert [s.value for lbl, s in degraded.series() if lbl["service"] == svc.name] == [1.0]
    active = reg.get("raft_tpu_serve_degraded_active")
    assert [s.value for lbl, s in active.series() if lbl["service"] == svc.name] == [1.0]
    svc.restore()
    assert [s.value for lbl, s in active.series() if lbl["service"] == svc.name] == [0.0]
    serve(svc, clock, _blocks(rng, (2,)))
    calls = reg.get("raft_tpu_serve_ann_calls_total")
    assert {int(lbl["nprobe"]): s.value for lbl, s in calls.series()
            if lbl["service"] == svc.name} == {4: 1.0, 8: 1.0}
    st = svc.stats()
    assert st["nprobe"] == 8 and st["nprobe_ladder"] == [4, 8] and st["kind"] == "IVFFlatIndex"
    svc.close()


# ---------------------------------------------------------------------- #
# knobs and the arguments that wait for later items
# ---------------------------------------------------------------------- #
ANN_KNOBS = {"serve_ann_nprobe": "3", "serve_ann_nprobe_ladder": "2,16,4",
             "serve_ann_delta_cap": "40", "serve_ann_compact_rows": "100",
             "serve_ann_degrade_frac": "0.25"}


def test_ann_knob_defaults_equal_the_jax_defaults():
    for name in ANN_KNOBS:
        assert config.knob_default(name) == jax_config.knob_default(name), name


@pytest.mark.parametrize("name", list(ANN_KNOBS))
def test_ann_knobs_resolve_from_env_like_jax(pindex, jindex, monkeypatch, name):
    monkeypatch.setenv("RAFT_TPU_" + name.upper(), ANN_KNOBS[name])
    assert config.get(name) == jax_config.get(name) == ANN_KNOBS[name]
    kw = {k: v for k, v in SVC_KW.items()
          if k not in ("nprobe_ladder", "delta_cap", "compact_rows")}
    ours = ANNService(pindex, K, start=False, device="cpu", **kw)
    theirs = JaxANNService(jindex, k=K, start=False, **kw)
    for attr in ("nprobe", "nprobe_ladder"):
        assert getattr(ours, attr) == getattr(theirs, attr)
    got, ref = ours.stats(), theirs.stats()
    for key in ("delta_cap", "compact_rows", "degrade_queue_frac"):
        assert got[key] == ref[key], key
    ours.close()
    theirs.close()


def test_malformed_ladder_knob_names_the_env_var(pindex, monkeypatch):
    monkeypatch.setenv("RAFT_TPU_SERVE_ANN_NPROBE_LADDER", "4,lots")
    with pytest.raises(LogicError, match="RAFT_TPU_SERVE_ANN_NPROBE_LADDER"):
        config.get_int_list("serve_ann_nprobe_ladder")
    with pytest.raises(LogicError, match="serve_ann_nprobe_ladder"):
        ANNService(pindex, K, start=False, device="cpu")
    with pytest.raises(ValueError):
        make_port(pindex, nprobe_ladder="4,x")


DEFERRED = {"ooc": True, "device_budget_bytes": 1 << 20, "tile_slots": 4,
            "ooc_overlap": True, "ooc_promote_batches": 8, "persist_mmap": True,
            "mesh": object(), "axis": "x", "merge": "ring",
            "group_size": 2, "select_impl": "approx"}
ITEM = {}


# the out-of-core arguments were deferred to queue 1 item 5, the sharded
# ones to item 6 and select_impl to item 7b, and are ported now: alone on a
# resident index each is taken as the JAX service takes it (None: accepted;
# else the LogicError's text; merge and group_size only act with a mesh or
# an axis; "approx", a JAX name, is refused in the registry's message
# shape), and none names an item
PORTED = {"ooc": "needs a device budget", "device_budget_bytes": "out-of-core knobs",
          "tile_slots": "out-of-core knobs", "ooc_overlap": None, "ooc_promote_batches": None,
          "persist_mmap": "durability knobs", "mesh": "raft_tpu_torch.comms.Mesh",
          "axis": "not in mesh axes", "merge": None, "group_size": None,
          "select_impl": "ANNService: select_impl='approx' is illegal.*legal: kernel, sort"}


@pytest.mark.parametrize("arg", list(DEFERRED))
def test_deferred_arguments_raise_naming_their_item(pindex, arg):
    if arg not in PORTED:
        with pytest.raises(RaftError, match="%s=.*queue 1 %s" % (arg, ITEM[arg])):
            ANNService(pindex, K, start=False, device="cpu", **{arg: DEFERRED[arg]})
        return
    if PORTED[arg] is None:
        ANNService(pindex, K, start=False, device="cpu", **{arg: DEFERRED[arg]}).close()
        return
    with pytest.raises(LogicError, match=PORTED[arg]) as ei:
        ANNService(pindex, K, start=False, device="cpu", **{arg: DEFERRED[arg]})
    assert all("item %s" % i not in str(ei.value) for i in ("5", "6", "7"))


def test_other_index_kinds_raise_naming_item_4(pindex):
    # IVF-PQ and IVF-SQ are served now (test_torch_serve_ann_quantized.py);
    # any other kind, a tuple of another index type included, is refused
    class OocIVFFlat(tuple):
        pass

    for other in (OocIVFFlat(), object()):
        with pytest.raises(LogicError, match="must be an IVF index"):
            ANNService(other, K, start=False, device="cpu")
    # the resident defaults of the deferred arguments pass
    svc = ANNService(pindex, K, start=False, device="cpu", ooc=False, persist_mmap=False,
                     refine_ratio=None)
    svc.close()
