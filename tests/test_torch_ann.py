"""Port parity: the IVF-Flat half of ``spatial/ann.py`` and the index
converters of ``convert.py``.

k-means draws cannot be reproduced across the two packages, so the
search is held on one index: built by the JAX package, carried into the
port (``ivf_flat_index_from_reference``), and searched by both.  The
port's scan and its kernel route (the plain version of K3 on the CPU)
are compared with the JAX ``scan_impl="xla"`` search.  The host packing
is compared array for array on the same labels, and a build made by the
port is held to brute force at a full probe."""

import importlib
from typing import NamedTuple, Optional

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers.torch_parity import assert_knn_close
from raft_tpu.distance.distance_type import DistanceType as JD
from raft_tpu.spatial import ann as jann
from raft_tpu_torch import (DistanceType, IVFFlatIndex, IVFFlatParams, LogicError,
                            approx_knn_build_index, approx_knn_search, brute_force_knn,
                            ivf_flat_build, ivf_flat_extend, ivf_flat_reconstruct,
                            ivf_flat_search)
from raft_tpu_torch.convert import (from_reference, ivf_flat_index_from_reference,
                                    ivf_flat_index_to_numpy, to_numpy)
from raft_tpu_torch.spatial import ann as pann

jkm_module = importlib.import_module("raft_tpu.spectral.kmeans")

# expanded-form float32 in another order (|q|^2 + |v|^2 up to ~300 here)
RTOL, ATOL = 1e-5, 1e-4
NLIST, D_DIM = 24, 8


def _blobs(m, seed, n_blobs=16):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((n_blobs, D_DIM)) * 4.0
    return (centers[rng.integers(0, n_blobs, m)]
            + rng.standard_normal((m, D_DIM)) * 0.35).astype(np.float32)


@pytest.fixture(scope="module")
def data():
    X = _blobs(2400, seed=0)
    Q = _blobs(40, seed=1)
    return X, Q


@pytest.fixture(scope="module")
def jindex(data):
    return jann.ivf_flat_build(jnp.asarray(data[0], jnp.float32),
                               jann.IVFFlatParams(nlist=NLIST, nprobe=3))


@pytest.fixture(scope="module")
def pindex(jindex):
    return ivf_flat_index_from_reference(jindex, device="cpu")


def _jax_search(jidx, Q, k, nprobe, metric=None, delta=None):
    if metric is not None:
        jidx = jidx._replace(metric=JD(int(metric)))
    return jann.ivf_flat_search(jidx, jnp.asarray(Q, jnp.float32), k, nprobe=nprobe,
                                scan_impl="xla", delta=delta)


# --------------------------------------------------------------------- #
# host packing
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("nlist,m,skew", [(7, 300, False), (16, 1000, True), (5, 3, False)])
def test_packing_matches_jax(nlist, m, skew):
    rng = np.random.default_rng(nlist)
    p = np.arange(nlist) + 1.0 if skew else np.ones(nlist)
    labels = rng.choice(nlist, size=m, p=p / p.sum()).astype(np.int32)
    jt, jl = jann._pack_lists(labels, nlist)
    pt, pl = pann._pack_lists(labels, nlist)
    np.testing.assert_array_equal(pt, jt)
    assert pl == jl
    for got, ref in zip(pann._build_slots(labels, nlist), jann._build_slots(labels, nlist)):
        np.testing.assert_array_equal(np.asarray(got), np.asarray(ref))
        assert np.asarray(got).dtype == np.asarray(ref).dtype
    for got, ref in zip(pann._extend_slot_layout(labels, nlist, 8, 5),
                        jann._extend_slot_layout(labels, nlist, 8, 5)):
        np.testing.assert_array_equal(got, ref)
        assert got.dtype == ref.dtype


class _PortResult(NamedTuple):
    centroids: torch.Tensor


def test_train_rows_subsample_the_same_rows(monkeypatch):
    X = _blobs(500, seed=2)
    seen = {}

    def fake(name, make):
        def run(Xs, k, **kw):
            seen[name] = np.asarray(Xs)
            return make(Xs[:k])
        return run

    monkeypatch.setattr(jann, "kmeans", fake(
        "jax", lambda C: jkm_module.KmeansResult(C, None, None, None)))
    monkeypatch.setattr(pann, "kmeans", fake("port", _PortResult))
    jann._coarse_assign(jnp.asarray(X, jnp.float32), 9, seed=5, train_rows=120)
    pann._coarse_assign(torch.from_numpy(X), 9, seed=5, train_rows=120)
    assert seen["port"].shape == (120, D_DIM)
    np.testing.assert_array_equal(seen["port"], seen["jax"])


# --------------------------------------------------------------------- #
# search on a carried index
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("scan_impl", ["scan", "kernel"])
@pytest.mark.parametrize("nprobe", [1, 3, NLIST])
@pytest.mark.parametrize("metric", [DistanceType.L2Expanded, DistanceType.L2SqrtExpanded],
                         ids=["L2", "L2Sqrt"])
def test_search_matches_jax(data, jindex, pindex, scan_impl, nprobe, metric):
    _, Q = data
    ref = _jax_search(jindex, Q, 10, nprobe, metric)
    got = ivf_flat_search(pindex._replace(metric=metric), Q, 10, nprobe=nprobe,
                          scan_impl=scan_impl, device="cpu")
    assert_knn_close(*ref, got[0].numpy(), got[1].numpy(), RTOL, ATOL)


@pytest.mark.parametrize("scan_impl", ["scan", "kernel"])
def test_search_deficit_when_k_exceeds_the_candidates(data, jindex, pindex, scan_impl):
    _, Q = data
    k = 128                      # more than one list holds
    ref = _jax_search(jindex, Q, k, 1)
    got = ivf_flat_search(pindex, Q, k, nprobe=1, scan_impl=scan_impl, device="cpu")
    assert (np.asarray(ref[1]) == -1).any()
    assert_knn_close(*ref, got[0].numpy(), got[1].numpy(), RTOL, ATOL)


@pytest.mark.parametrize("scan_impl", ["scan", "kernel"])
def test_search_with_delta_segment(data, jindex, pindex, scan_impl):
    X, Q = data
    dv = np.concatenate([Q[:5] + 0.1, np.zeros((3, D_DIM), np.float32)])
    di = np.array([9000, 9001, 9002, 9003, 9004, -1, -1, -1], np.int32)
    ref = _jax_search(jindex, Q, 10, 2, DistanceType.L2SqrtExpanded,
                      delta=(jnp.asarray(dv), jnp.asarray(di)))
    got = ivf_flat_search(pindex._replace(metric=DistanceType.L2SqrtExpanded), Q, 10,
                          nprobe=2, delta=(dv, di), scan_impl=scan_impl, device="cpu")
    assert_knn_close(*ref, got[0].numpy(), got[1].numpy(), RTOL, ATOL)
    assert (got[1][:5, 0] >= 9000).all()


def test_explicit_kernel_outside_its_limits_raises(data, pindex):
    _, Q = data
    with pytest.raises(LogicError, match="scan_impl"):
        ivf_flat_search(pindex, Q, 129, scan_impl="kernel", device="cpu")
    with pytest.raises(LogicError, match="scan_impl"):
        ivf_flat_search(pindex, Q.astype(np.float64), 5, scan_impl="kernel_bf16",
                        device="cpu")
    # a JAX name is refused in the registry's message shape, never mapped
    with pytest.raises(LogicError, match="ivf_scan_impl='pallas' is illegal.*legal: kernel, "
                                         "kernel_bf16, scan"):
        ivf_flat_search(pindex, Q, 5, scan_impl="pallas", device="cpu")


def test_nprobe_validation(data, pindex):
    _, Q = data
    with pytest.raises(LogicError, match="nprobe"):
        ivf_flat_search(pindex, Q, 5, nprobe=0, device="cpu")
    pann._NPROBE_CLAMP_WARNED.discard("ivf_flat_search")
    with pytest.warns(UserWarning, match="clamping"):
        big = ivf_flat_search(pindex, Q, 5, nprobe=NLIST + 10, device="cpu")
    full = ivf_flat_search(pindex, Q, 5, nprobe=NLIST, device="cpu")
    assert torch.equal(big[1], full[1])


# --------------------------------------------------------------------- #
# extend and reconstruct
# --------------------------------------------------------------------- #
def test_extend_and_reconstruct_match_jax(data, jindex, pindex):
    _, Q = data
    new = _blobs(150, seed=3)
    new_ids = np.arange(5000, 5150)
    jext = jann.ivf_flat_extend(jindex, jnp.asarray(new), new_ids, slot_multiple=16)
    pext = ivf_flat_extend(pindex, new, new_ids, slot_multiple=16, device="cpu")
    for name in ("centroids", "slot_vecs", "slot_ids", "slot_centroid", "cent_slots",
                 "list_sizes"):
        ref, got = np.asarray(getattr(jext, name)), getattr(pext, name).numpy()
        assert got.dtype == ref.dtype, name
        np.testing.assert_array_equal(got, ref, name)
    np.testing.assert_allclose(pext.slot_norms.numpy(), np.asarray(jext.slot_norms),
                               rtol=1e-6, atol=1e-5)
    assert pext.slot_vecs.shape[0] % 16 == 0 and pext.nprobe == jext.nprobe
    for got, ref in zip(ivf_flat_reconstruct(pext), jann.ivf_flat_reconstruct(jext)):
        np.testing.assert_array_equal(got, ref)
    ref = _jax_search(jext, Q, 10, 3)
    got = ivf_flat_search(pext, Q, 10, device="cpu")
    assert_knn_close(*ref, got[0].numpy(), got[1].numpy(), RTOL, ATOL)


# --------------------------------------------------------------------- #
# a build made by the port, dispatch
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("train_rows", [None, 600])
def test_port_build_full_probe_equals_brute_force(data, train_rows):
    X, Q = data
    idx = ivf_flat_build(X, IVFFlatParams(nlist=NLIST, nprobe=4),
                         metric=DistanceType.L2SqrtExpanded, seed=7,
                         train_rows=train_rows, device="cpu")
    assert idx.slot_ids.dtype == torch.int32 and idx.centroids.shape == (NLIST, D_DIM)
    assert int(idx.list_sizes.sum()) == len(X)
    vecs, ids = ivf_flat_reconstruct(idx)
    np.testing.assert_array_equal(vecs, X[ids])
    assert sorted(ids.tolist()) == list(range(len(X)))
    ref = brute_force_knn(X, Q, 10, DistanceType.L2SqrtExpanded, device="cpu")
    for scan_impl in ("scan", "kernel"):
        got = ivf_flat_search(idx, Q, 10, nprobe=NLIST, scan_impl=scan_impl, device="cpu")
        assert_knn_close(ref[0].numpy(), ref[1].numpy(), got[0].numpy(), got[1].numpy(),
                         RTOL, ATOL)


def test_dispatch(data):
    X, Q = data
    idx = approx_knn_build_index(X, IVFFlatParams(nlist=8, nprobe=2), seed=1, device="cpu")
    assert isinstance(idx, IVFFlatIndex)
    got = approx_knn_search(idx, Q, 4, device="cpu")
    ref = ivf_flat_search(idx, Q, 4, device="cpu")
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
    with pytest.raises(TypeError, match="params"):
        approx_knn_build_index(X, jann.IVFPQParams(nlist=8), device="cpu")
    with pytest.raises(TypeError, match="index"):
        approx_knn_search(object(), Q, 4, device="cpu")
    with pytest.raises(LogicError, match="unsupported metric"):
        ivf_flat_build(X, IVFFlatParams(nlist=8), metric=DistanceType.L1, device="cpu")


# --------------------------------------------------------------------- #
# converters
# --------------------------------------------------------------------- #
def test_ivf_index_round_trips(jindex):
    p = ivf_flat_index_from_reference(jindex, device="cpu")
    assert isinstance(p, IVFFlatIndex) and isinstance(p.metric, DistanceType)
    back = ivf_flat_index_to_numpy(p)
    for name in IVFFlatIndex._fields:
        ref, got = getattr(jindex, name), getattr(back, name)
        if name in ("metric", "nprobe"):
            assert got == int(ref) and type(got) is type(getattr(p, name))
            continue
        assert isinstance(getattr(p, name), torch.Tensor)
        assert got.dtype == np.asarray(ref).dtype, name
        np.testing.assert_array_equal(got, np.asarray(ref), name)


def test_ivf_index_without_norms_gets_them(jindex):
    p = ivf_flat_index_from_reference(jindex._replace(slot_norms=None), device="cpu")
    np.testing.assert_allclose(p.slot_norms.numpy(), np.asarray(jindex.slot_norms),
                               rtol=1e-6, atol=1e-5)


class _State(NamedTuple):
    vecs: np.ndarray
    ids: np.ndarray
    metric: int
    norms: Optional[np.ndarray] = None


def test_walkers_rebuild_named_tuples_and_pass_none():
    state = _State(np.ones((2, 3), np.float32), np.arange(2, dtype=np.int32), 1)
    t = from_reference({"a": [state], "b": (np.zeros(1),)}, device="cpu")
    got = t["a"][0]
    assert type(got) is _State and got.norms is None and got.metric == 1
    assert got.ids.dtype == torch.int32 and isinstance(t["b"], tuple)
    back = to_numpy(t)
    assert type(back["a"][0]) is _State and back["a"][0].norms is None
    np.testing.assert_array_equal(back["a"][0].vecs, state.vecs)
