"""Port parity: the IVF-PQ and IVF-SQ half of ``spatial/ann.py`` and their
converters in ``convert.py``.

The searches are held on one index: built by the JAX package, carried
into the port (``ivf_pq_index_from_reference``,
``ivf_sq_index_from_reference``) and searched by both (the port's gather
ADC against both of the JAX package's formulations), refinement on and
off, a delta segment, and the padded codebooks of a set smaller than a
codebook.  Distances agree within 1e-4 of the largest distance (float32
sums in another order), ids as per-row sets except at ties with the k-th
distance.

The builds draw k-means streams that cannot be reproduced across the two
packages, so both packages' ``kmeans`` are replaced by one fake (the first
k rows, nearest by float64 distance): the codebooks, codes and scalar
codes must then be equal bit for bit.  A real port build clears the JAX
recall bars of ``tests/test_ann.py``.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.spatial.distance as spd
import torch

from helpers.torch_parity import assert_knn_close
from raft_tpu.spatial import ann as jann
from raft_tpu_torch import (DistanceType, IVFPQIndex, IVFPQParams, IVFSQIndex, IVFSQParams,
                            LogicError, approx_knn_build_index, approx_knn_search,
                            ivf_pq_build, ivf_pq_search, ivf_sq_build, ivf_sq_search)
from raft_tpu_torch.convert import (ivf_pq_index_from_reference, ivf_pq_index_to_numpy,
                                    ivf_sq_index_from_reference, ivf_sq_index_to_numpy)
from raft_tpu_torch.spatial import ann as pann
from raft_tpu_torch.spectral.kmeans import KmeansResult

jkm_module = importlib.import_module("raft_tpu.spectral.kmeans")

K = 10
TOL = 1e-4      # of the largest distance


@pytest.fixture(scope="module")
def gauss():
    """The JAX TestIVFPQ data: 2000 x 16 Gaussian rows, 50 queries."""
    rng = np.random.default_rng(7)
    return (rng.normal(0, 1, (2000, 16)).astype(np.float32),
            rng.normal(0, 1, (50, 16)).astype(np.float32))


@pytest.fixture(scope="module")
def uniform():
    """The JAX TestIVFSQ data: 1000 x 16 uniform rows, 50 queries."""
    rng = np.random.default_rng(42)
    return rng.random((1000, 16)).astype(np.float32), rng.random((50, 16)).astype(np.float32)


@pytest.fixture(scope="module")
def jpq(gauss):
    return jann.ivf_pq_build(jnp.asarray(gauss[0]),
                             jann.IVFPQParams(nlist=10, nprobe=4, M=8, n_bits=8, refine_ratio=4))


@pytest.fixture(scope="module")
def ppq(jpq):
    return ivf_pq_index_from_reference(jpq, device="cpu")


@pytest.fixture(scope="module", params=[True, False], ids=["residual", "no residual"])
def jsq(request, uniform):
    return jann.ivf_sq_build(jnp.asarray(uniform[0]),
                             jann.IVFSQParams(nlist=10, nprobe=4,
                                              encode_residual=request.param))


@pytest.fixture(scope="module")
def psq(jsq):
    return ivf_sq_index_from_reference(jsq, device="cpu")


def recall(got_ids, ref_ids):
    hits = sum(len(set(g) & set(r)) for g, r in zip(got_ids, ref_ids))
    return hits / ref_ids.size


def brute(X, Q, k):
    full = spd.cdist(Q, X, "sqeuclidean")
    ids = np.argsort(full, axis=1, kind="stable")[:, :k]
    return np.take_along_axis(full, ids, axis=1), ids


def _close(ref, got):
    d_ref = np.asarray(ref[0])
    scale = np.abs(d_ref[np.isfinite(d_ref)]).max()
    assert_knn_close(d_ref, np.asarray(ref[1]), got[0].numpy(), got[1].numpy(), 0.0,
                     TOL * scale)


def _jax_pq(jidx, Q, k, nprobe, refine_ratio, adc, monkeypatch, delta=None):
    monkeypatch.setenv("RAFT_TPU_PQ_ADC", adc)
    return jann.ivf_pq_search(jidx, jnp.asarray(Q), k, nprobe=nprobe, refine_ratio=refine_ratio,
                              delta=delta)


# --------------------------------------------------------------------- #
# searches of a carried index
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("given_probes", [False, True], ids=["own probes", "given probes"])
@pytest.mark.parametrize("nprobe", [2, 10])
def test_probe_compact_matches_jax(gauss, jpq, ppq, nprobe, given_probes):
    _, Q = gauss
    jprobes = None
    if given_probes:
        _, jprobes = jann.select_k(jann.expanded_sq_dists(jnp.asarray(Q), jpq.centroids), nprobe,
                                   select_min=True)
    js, jr, jn = jann._probe_compact(jnp.asarray(Q), jpq.centroids, jpq.cent_slots, nprobe,
                                     probes=jprobes)
    pprobes = None if jprobes is None else torch.from_numpy(np.array(jprobes))
    qt = torch.from_numpy(Q)
    ps, pr, pn = pann._probe_compact(qt, ppq.centroids, ppq.cent_slots, nprobe, pprobes,
                                     ranks=True)
    np.testing.assert_array_equal(ps.numpy(), np.asarray(js))
    np.testing.assert_array_equal(pr.numpy(), np.asarray(jr))
    assert int(pn) == int(jn)
    # without the ranks (the K3 route) the slots are the same
    slots, n_live = pann._probe_compact(qt, ppq.centroids, ppq.cent_slots, nprobe, pprobes)
    assert torch.equal(slots, ps) and int(n_live) == int(pn)


# the port's gather ADC against both of the JAX package's formulations
@pytest.mark.parametrize("jax_adc", ["gather", "onehot"])
@pytest.mark.parametrize("refine_ratio", [1, 4], ids=["unrefined", "refined"])
@pytest.mark.parametrize("nprobe", [2, 10])
def test_pq_search_matches_jax(gauss, jpq, ppq, jax_adc, refine_ratio, nprobe, monkeypatch):
    _, Q = gauss
    ref = _jax_pq(jpq, Q, K, nprobe, refine_ratio, jax_adc, monkeypatch)
    got = ivf_pq_search(ppq, Q, K, nprobe=nprobe, refine_ratio=refine_ratio, device="cpu")
    _close(ref, got)


@pytest.mark.parametrize("metric", [DistanceType.L2Expanded, DistanceType.L2SqrtExpanded],
                         ids=["L2", "L2Sqrt"])
@pytest.mark.parametrize("refine_ratio", [1, 4], ids=["unrefined", "refined"])
def test_pq_search_with_delta_matches_jax(gauss, jpq, ppq, metric, refine_ratio, monkeypatch):
    _, Q = gauss
    dv = np.concatenate([Q[:5] + 0.01, np.zeros((3, 16), np.float32)])
    di = np.array([9000, 9001, 9002, 9003, 9004, -1, -1, -1], np.int32)
    jidx = jpq._replace(metric=jann.DistanceType(int(metric)))
    ref = _jax_pq(jidx, Q, K, 4, refine_ratio, "gather", monkeypatch,
                  delta=(jnp.asarray(dv), jnp.asarray(di)))
    got = approx_knn_search(ppq._replace(metric=metric), Q, K, 4, refine_ratio, delta=(dv, di),
                            device="cpu")
    _close(ref, got)
    assert (got[1][:5, 0] >= 9000).all()


def test_pq_deficit_slots_match_jax(gauss, jpq, ppq, monkeypatch):
    _, Q = gauss
    k = 400                       # more than one list holds: -1 fillers
    ref = _jax_pq(jpq, Q[:8], k, 1, 1, "gather", monkeypatch)
    got = ivf_pq_search(ppq, Q[:8], k, nprobe=1, refine_ratio=1, device="cpu")
    assert (np.asarray(ref[1]) == -1).any()
    _close(ref, got)


@pytest.mark.parametrize("jax_adc", ["gather", "onehot"])
def test_pq_padded_codebooks_match_jax(jax_adc, monkeypatch):
    rng = np.random.default_rng(9)
    X = rng.normal(0, 1, (120, 16)).astype(np.float32)      # fewer rows than codewords
    Q = rng.normal(0, 1, (20, 16)).astype(np.float32)
    jidx = jann.ivf_pq_build(jnp.asarray(X), jann.IVFPQParams(nlist=4, M=8, n_bits=8))
    pidx = ivf_pq_index_from_reference(jidx, device="cpu")
    assert torch.isinf(pidx.codebooks[:, 120:]).all()
    ref = _jax_pq(jidx, Q, 5, 4, None, jax_adc, monkeypatch)
    got = ivf_pq_search(pidx, Q, 5, nprobe=4, device="cpu")
    assert torch.isfinite(got[0]).all()
    _close(ref, got)


@pytest.mark.parametrize("nprobe", [2, 10])
def test_sq_search_matches_jax(uniform, jsq, psq, nprobe):
    _, Q = uniform
    ref = jann.ivf_sq_search(jsq, jnp.asarray(Q), K, nprobe=nprobe)
    got = ivf_sq_search(psq, Q, K, nprobe=nprobe, device="cpu")
    _close(ref, got)


def test_sq_search_with_delta_matches_jax(uniform, jsq, psq):
    _, Q = uniform
    dv = np.concatenate([Q[:4] + 0.01, np.zeros((4, 16), np.float32)])
    di = np.array([7000, 7001, 7002, 7003, -1, -1, -1, -1], np.int32)
    ref = jann.ivf_sq_search(jsq, jnp.asarray(Q), K, nprobe=3,
                             delta=(jnp.asarray(dv), jnp.asarray(di)))
    got = approx_knn_search(psq, Q, K, 3, 4, delta=(dv, di), device="cpu")   # ratio ignored
    _close(ref, got)
    assert (got[1][:4, 0] >= 7000).all()


def test_search_validation(gauss, ppq, psq):
    _, Q = gauss
    for fn, idx in ((ivf_pq_search, ppq), (ivf_sq_search, psq)):
        with pytest.raises(LogicError, match="nprobe"):
            fn(idx, Q, K, nprobe=0, device="cpu")
        with pytest.raises(LogicError, match="queries"):
            fn(idx, Q[:, :8], K, device="cpu")


# --------------------------------------------------------------------- #
# builds with one fake k-means in both packages
# --------------------------------------------------------------------- #
def _first_rows_kmeans(x: np.ndarray, k: int):
    """(centroids, int32 labels): the first k rows, nearest by float64
    distance (ties to the smaller index)."""
    C = np.ascontiguousarray(x[:k], np.float32)
    d = ((x[:, None, :].astype(np.float64) - C[None].astype(np.float64)) ** 2).sum(-1)
    return C, np.argmin(d, axis=1).astype(np.int32)


@pytest.fixture
def fake_kmeans(monkeypatch):
    seen = []

    def jax_fake(X, k, seed=0, max_iter=0, **kw):
        seen.append(("jax", k, seed, max_iter))
        C, lab = _first_rows_kmeans(np.asarray(X), k)
        return jkm_module.KmeansResult(jnp.asarray(C), jnp.asarray(lab), None, None)

    def port_fake(X, k, seed=0, max_iter=0, **kw):
        seen.append(("port", k, seed, max_iter))
        C, lab = _first_rows_kmeans(X.cpu().numpy(), k)
        return KmeansResult(torch.from_numpy(C), torch.from_numpy(lab), None, 0)

    monkeypatch.setattr(jann, "kmeans", jax_fake)
    monkeypatch.setattr(pann, "kmeans", port_fake)
    return seen


def _assert_fields_equal(got, ref, names):
    for name in names:
        g, r = getattr(got, name).numpy(), np.asarray(getattr(ref, name))
        assert g.dtype == r.dtype, name
        np.testing.assert_array_equal(g, r, name)


@pytest.mark.parametrize("m,refine_ratio", [(2000, 1), (2000, 3), (120, 1)],
                         ids=["2000 rows", "refine", "padded codebooks"])
def test_pq_build_matches_jax_on_one_kmeans(gauss, fake_kmeans, m, refine_ratio):
    X = gauss[0][:m]
    params = dict(nlist=10, nprobe=4, M=4, n_bits=8, refine_ratio=refine_ratio)
    ref = jann.ivf_pq_build(jnp.asarray(X), jann.IVFPQParams(**params), seed=5)
    got = ivf_pq_build(X, IVFPQParams(**params), seed=5, device="cpu")
    # the same k-means calls: the coarse quantizer, then seeds 5 + mi
    assert [c[1:] for c in fake_kmeans if c[0] == "port"] == [
        c[1:] for c in fake_kmeans if c[0] == "jax"]
    _assert_fields_equal(got, ref, ("centroids", "codebooks", "slot_codes", "slot_ids",
                                    "slot_centroid", "cent_slots", "list_sizes"))
    assert got.refine_ratio == ref.refine_ratio and got.nprobe == ref.nprobe
    assert (got.vectors is None) == (ref.vectors is None)
    if got.vectors is not None:
        np.testing.assert_array_equal(got.vectors.numpy(), X)


@pytest.mark.parametrize("qtype", ["QT_8bit", "QT_8bit_uniform"])
@pytest.mark.parametrize("encode_residual", [True, False], ids=["residual", "no residual"])
def test_sq_build_matches_jax_on_one_kmeans(uniform, fake_kmeans, qtype, encode_residual):
    X = uniform[0]
    params = dict(nlist=10, nprobe=4, qtype=qtype, encode_residual=encode_residual)
    ref = jann.ivf_sq_build(jnp.asarray(X), jann.IVFSQParams(**params), seed=3)
    got = ivf_sq_build(X, IVFSQParams(**params), seed=3, device="cpu")
    _assert_fields_equal(got, ref, ("centroids", "slot_q", "scale", "offset", "slot_ids",
                                    "slot_centroid", "cent_slots", "list_sizes"))
    assert got.slot_q.dtype == torch.uint8 and got.encode_residual == encode_residual


def test_train_rows_reach_the_codebook_build(gauss, fake_kmeans):
    X = gauss[0]
    ref = jann.ivf_pq_build(jnp.asarray(X), jann.IVFPQParams(nlist=10, M=4), seed=2,
                            train_rows=300)
    got = ivf_pq_build(X, IVFPQParams(nlist=10, M=4), seed=2, train_rows=300, device="cpu")
    _assert_fields_equal(got, ref, ("centroids", "codebooks", "slot_codes", "slot_ids"))


# --------------------------------------------------------------------- #
# real port builds: the JAX recall bars
# --------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def port_pq(gauss):
    return ivf_pq_build(gauss[0], IVFPQParams(nlist=10, M=8, n_bits=8, refine_ratio=4),
                        device="cpu")


def test_port_pq_unrefined_recall(gauss, port_pq):
    X, Q = gauss
    _, ii = ivf_pq_search(port_pq, Q, K, nprobe=10, refine_ratio=1, device="cpu")
    assert recall(ii.numpy(), brute(X, Q, K)[1]) >= 0.8


def test_port_pq_refined_recall_and_exact_distances(gauss, port_pq):
    X, Q = gauss
    dd, ii = ivf_pq_search(port_pq, Q, K, nprobe=10, device="cpu")
    ref_d, ref_i = brute(X, Q, K)
    assert recall(ii.numpy(), ref_i) >= 0.99
    hit = ii.numpy() == ref_i
    np.testing.assert_allclose(dd.numpy()[hit], ref_d[hit], rtol=1e-3, atol=1e-3)


def test_port_pq_refine_ratio_override(gauss, port_pq):
    _, Q = gauss
    plain = port_pq._replace(vectors=None, refine_ratio=1)
    a = ivf_pq_search(port_pq, Q, K, nprobe=10, refine_ratio=1, device="cpu")
    b = ivf_pq_search(plain, Q, K, nprobe=10, device="cpu")
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_port_pq_padded_codebooks_recall():
    rng = np.random.default_rng(9)
    X = rng.normal(0, 1, (120, 16)).astype(np.float32)
    Q = rng.normal(0, 1, (20, 16)).astype(np.float32)
    idx = approx_knn_build_index(X, IVFPQParams(nlist=4, M=8, n_bits=8), device="cpu")
    dd, ii = approx_knn_search(idx, Q, 5, 4, device="cpu")
    assert torch.isfinite(dd).all()
    assert recall(ii.numpy(), brute(X, Q, 5)[1]) >= 0.8


@pytest.mark.parametrize("encode_residual", [True, False], ids=["residual", "no residual"])
def test_port_sq_recall(uniform, encode_residual):
    X, Q = uniform
    idx = approx_knn_build_index(X, IVFSQParams(nlist=10, nprobe=10,
                                                encode_residual=encode_residual),
                                 device="cpu")
    assert isinstance(idx, IVFSQIndex) and idx.slot_q.dtype == torch.uint8
    _, ii = approx_knn_search(idx, Q, K, device="cpu")      # nprobe from the build
    assert recall(ii.numpy(), brute(X, Q, K)[1]) > 0.95


def test_build_validation(gauss):
    X, _ = gauss
    with pytest.raises(LogicError, match="divisible"):
        ivf_pq_build(X, IVFPQParams(nlist=4, M=5), device="cpu")
    with pytest.raises(LogicError, match="qtype"):
        ivf_sq_build(X, IVFSQParams(nlist=4, qtype="QT_4bit"), device="cpu")
    for params in (IVFPQParams(nlist=4, M=4), IVFSQParams(nlist=4)):
        with pytest.raises(LogicError, match="unsupported metric"):
            approx_knn_build_index(X, params, metric=DistanceType.L1, device="cpu")


def test_pq_build_stages(gauss):
    stages = {}
    idx = ivf_pq_build(gauss[0][:600], IVFPQParams(nlist=4, M=4, n_bits=4), device="cpu",
                       stages=stages)
    assert isinstance(idx, IVFPQIndex) and idx.codebooks.shape == (4, 16, 4)
    assert set(stages) == {"coarse_ms", "codebooks_ms", "packing_ms"}
    assert all(v >= 0.0 for v in stages.values())


# --------------------------------------------------------------------- #
# converters
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("kind", ["pq", "sq"])
def test_quantized_index_round_trips(jpq, jsq, kind):
    jidx, cls, there, back = {
        "pq": (jpq, IVFPQIndex, ivf_pq_index_from_reference, ivf_pq_index_to_numpy),
        "sq": (jsq, IVFSQIndex, ivf_sq_index_from_reference, ivf_sq_index_to_numpy)}[kind]
    p = there(jidx, device="cpu")
    assert isinstance(p, cls) and isinstance(p.metric, DistanceType)
    out = back(p)
    for name in cls._fields:
        ref, got = getattr(jidx, name), getattr(out, name)
        if name in ("metric", "nprobe", "refine_ratio", "encode_residual"):
            assert got == ref
            continue
        assert got.dtype == np.asarray(ref).dtype, name
        np.testing.assert_array_equal(got, np.asarray(ref), name)
