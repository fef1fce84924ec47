"""Port parity of ANNService's IVF-PQ and IVF-SQ arms against the JAX
package's, on the CPU.

Both services serve one index built by the JAX package and carried into
the port (``convert.ivf_pq_index_from_reference``,
``ivf_sq_index_from_reference``).  They run threadless (``start=False``)
under a fake clock, stepped by ``worker.run_once()``, as
``test_torch_serve_ann.py`` does.  Served rows are held bit for bit to the
port's ``approx_knn_search`` of the padded batch the worker formed, and
to the JAX service within 1e-4 of the largest distance, ids as sets.  A
PQ or SQ service never compacts: ``compact()`` raises and the automatic
compaction is off, while inserts are served from the delta.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers.torch_parity import assert_knn_close
from raft_tpu.serve import ANNService as JaxANNService
from raft_tpu.spatial import ann as jann
from raft_tpu_torch import ANNService, LogicError, approx_knn_search, brute_force_knn
from raft_tpu_torch.convert import ivf_pq_index_from_reference, ivf_sq_index_from_reference
from raft_tpu_torch.serve import pad_rows

DIM, K = 24, 10
TOL = 1e-4      # of the largest distance


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
def pq_indexes(data):
    """(kind, JAX index, the port's copy) of IVF-PQ, vectors kept."""
    j = jann.ivf_pq_build(jnp.asarray(data),
                          jann.IVFPQParams(nlist=16, nprobe=8, M=6, refine_ratio=2), seed=1234)
    return "pq", j, ivf_pq_index_from_reference(j, device="cpu")


@pytest.fixture(scope="module")
def sq_indexes(data):
    j = jann.ivf_sq_build(jnp.asarray(data), jann.IVFSQParams(nlist=16, nprobe=8), seed=1234)
    return "sq", j, ivf_sq_index_from_reference(j, device="cpu")


@pytest.fixture(params=["pq", "sq"])
def indexes(request):
    return request.getfixturevalue(request.param + "_indexes")


@pytest.fixture
def rng():
    return np.random.default_rng(7)


SVC_KW = dict(max_batch_rows=32, bucket_rungs=(8, 32), max_wait_ms=10.0, nprobe_ladder=(4, 8),
              delta_cap=64, compact_rows=0)


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


def _blocks(rng, rows):
    return [rng.standard_normal((r, DIM)).astype(np.float32) for r in rows]


def _close(ref, got):
    d_ref = np.asarray(ref[0])
    assert_knn_close(d_ref, np.asarray(ref[1]), got[0].numpy(), got[1].numpy(), 0.0,
                     TOL * np.abs(d_ref[np.isfinite(d_ref)]).max())


@pytest.mark.parametrize("with_delta", [False, True], ids=["no delta", "delta"])
def test_served_is_bitwise_the_port_search(indexes, rng, with_delta):
    _, _, pindex = indexes
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
        at += len(b)
    svc.close()


@pytest.mark.parametrize("with_delta", [False, True], ids=["no delta", "delta"])
def test_served_matches_the_jax_service(indexes, rng, with_delta):
    _, jindex, pindex = indexes
    ours, clock = make_port(pindex)
    jclock = FakeClock()
    theirs = JaxANNService(jindex, k=K, start=False, clock=jclock, **SVC_KW)
    if with_delta:
        ids = np.arange(90000, 90030)
        vecs = rng.standard_normal((30, DIM)).astype(np.float32)
        assert ours.insert(ids, vecs) == theirs.insert(ids, jnp.asarray(vecs)) == 30
    blocks = _blocks(rng, (5, 2, 11))
    got = serve(ours, clock, blocks)
    ref = serve(theirs, jclock, [jnp.asarray(b) for b in blocks])
    for g, r in zip(got, ref):
        _close(r, g)
    assert ours.stats()["kind"] == theirs.stats()["kind"]
    ours.close()
    theirs.close()


def test_compact_raises_and_auto_compaction_is_off(indexes, rng):
    _, jindex, pindex = indexes
    svc, _ = make_port(pindex, compact_rows=16)
    theirs = JaxANNService(jindex, k=K, start=False, **dict(SVC_KW, compact_rows=16))
    assert svc.stats()["compact_rows"] == theirs.stats()["compact_rows"] == 0
    svc.insert(np.arange(100, 140), rng.standard_normal((40, DIM)).astype(np.float32))
    svc.worker.run_maintenance()
    assert svc.delta_rows == 40                    # no compaction
    with pytest.raises(LogicError, match="compaction requires an IVFFlatIndex"):
        svc.compact()
    svc.close()
    theirs.close()


def test_inserts_are_served_from_the_delta(indexes, rng):
    _, _, pindex = indexes
    svc, clock = make_port(pindex)
    new = rng.standard_normal((12, DIM)).astype(np.float32)
    svc.insert(np.arange(50000, 50012), new)
    out = serve(svc, clock, [new[i:i + 1] for i in range(12)])
    for r, (d, i) in enumerate(out):
        assert int(i[0, 0]) == 50000 + r and float(d[0, 0]) <= 1e-4
    svc.close()


def test_refine_ratio_reaches_the_pq_search(indexes, rng):
    kind, _, pindex = indexes
    blocks = _blocks(rng, (8,))
    outs = {}
    for ratio in (None, 1, 4):
        svc, clock = make_port(pindex, refine_ratio=ratio)
        outs[ratio] = serve(svc, clock, blocks)[0]
        ref = approx_knn_search(pindex, torch.from_numpy(blocks[0]), K, svc.nprobe, ratio,
                                device="cpu")
        assert torch.equal(outs[ratio][0], ref[0]) and torch.equal(outs[ratio][1], ref[1])
        svc.close()
    # IVF-SQ ignores the ratio; IVF-PQ's default is the build's ratio 2
    assert torch.equal(outs[1][1], outs[4][1]) == (kind == "sq")


def test_warmup_then_calibrate(indexes, data, rng):
    kind, _, pindex = indexes
    svc, clock = make_port(pindex, nprobe_ladder=(2, 4, 16))
    svc.warmup()
    q = rng.standard_normal((16, DIM)).astype(np.float32)
    if kind == "sq":
        # an SQ store holds codes: the ground truth needs the vectors
        with pytest.raises(LogicError, match="reference"):
            svc.calibrate(q, 0.5)
    out = svc.calibrate(q, 0.5, reference=data, measure_all=True)
    assert [row["nprobe"] for row in out["table"]] == [2, 4, 8, 16]   # the served 8 joins
    assert out["table"][-1]["recall_at_k"] >= out["table"][0]["recall_at_k"]
    assert svc.nprobe == out["chosen_nprobe"]
    serve(svc, clock, _blocks(rng, (5,)))
    assert svc.kernel_libraries_after_warmup() == {"builds": 0, "loads": 0}
    svc.close()


def test_pq_ground_truth_store_reads_the_kept_vectors(pq_indexes, rng):
    _, jindex, pindex = pq_indexes
    svc, _ = make_port(pindex)
    theirs = JaxANNService(jindex, k=K, start=False, **SVC_KW)
    new = rng.standard_normal((4, DIM)).astype(np.float32)
    svc.insert(np.arange(70000, 70004), new)
    theirs.insert(np.arange(70000, 70004), jnp.asarray(new))
    vecs, ids = svc.ground_truth_store()
    jvecs, jids = theirs.ground_truth_store()
    np.testing.assert_array_equal(vecs, np.asarray(jvecs))
    np.testing.assert_array_equal(ids, np.asarray(jids))
    _, bi = brute_force_knn(vecs, new, 1, device="cpu")
    assert (ids[bi.numpy()[:, 0]] == np.arange(70000, 70004)).all()
    svc.close()
    theirs.close()
