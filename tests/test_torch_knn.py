"""Port parity for the slice as a whole: raft_tpu_torch brute_force_knn
and knn_merge_parts vs the JAX package, with every input carried across
by ``raft_tpu_torch.convert.from_reference``."""

import jax.numpy as jnp
import numpy as np
import pytest

from helpers.torch_parity import assert_knn_close
from raft_tpu.distance import DistanceType as JD
from raft_tpu.spatial.knn import brute_force_knn as jax_bfknn
from raft_tpu.spatial.knn import knn_merge_parts as jax_merge
from raft_tpu_torch import DistanceType, LogicError, brute_force_knn, knn_merge_parts
from raft_tpu_torch.convert import from_reference, to_numpy

D = DistanceType

# (metric, tolerance).  Distances are float32 sums over d = 24 terms taken
# in another order than XLA's: a few ulps of the operands' scale, which is
# |q|^2 + |x|^2 (about 50) for the L2 family and inner products, 1 for
# cosine / correlation / haversine, and d for L1 / Canberra.
METRICS = [(D.L2Expanded, 1e-4), (D.L2SqrtExpanded, 1e-4), (D.InnerProduct, 1e-4),
           (D.CosineExpanded, 1e-5), (D.CorrelationExpanded, 1e-5),
           (D.L1, 5e-5), (D.Canberra, 5e-5), (D.Linf, 1e-6)]


def _data(n, nq, d, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, d)).astype(np.float32),
            rng.standard_normal((nq, d)).astype(np.float32))


def _jax(parts, q, k, metric, **kw):
    jparts = [jnp.asarray(p, jnp.float32) for p in parts]
    d, i = jax_bfknn(jparts if len(jparts) > 1 else jparts[0],
                     jnp.asarray(q, jnp.float32), k, JD(int(metric)), **kw)
    return np.asarray(d), np.asarray(i)


def _port(parts, q, k, metric, **kw):
    state = from_reference({"parts": parts, "queries": q}, device="cpu")
    p = state["parts"]
    d, i = brute_force_knn(p if len(p) > 1 else p[0], state["queries"], k, metric,
                           device="cpu", **kw)
    return to_numpy(d), to_numpy(i)


@pytest.mark.parametrize("metric,tol", METRICS, ids=[m.name for m, _ in METRICS])
def test_single_partition_matches_jax(metric, tol):
    x, q = _data(400, 13, 24)
    ref = _jax([x], q, 10, metric)
    got = _port([x], q, 10, metric)
    assert_knn_close(*ref, *got, rtol=tol, atol=tol)


@pytest.mark.parametrize("metric,tol", METRICS[:4] + [(D.L1, 5e-5)],
                         ids=[m.name for m, _ in METRICS[:4]] + ["L1"])
def test_partitions_with_default_translations(metric, tol):
    x, q = _data(600, 11, 24, seed=1)
    parts = [x[:150], x[150:361], x[361:]]
    ref = _jax(parts, q, 100, metric)
    got = _port(parts, q, 100, metric)
    assert_knn_close(*ref, *got, rtol=tol, atol=tol)


def test_partitions_with_explicit_translations():
    x, q = _data(300, 7, 16, seed=2)
    parts = [x[:120], x[120:]]
    trans = [1000, 50_000]
    ref = _jax(parts, q, 20, D.L2SqrtExpanded, translations=trans)
    got = _port(parts, q, 20, D.L2SqrtExpanded, translations=trans)
    assert_knn_close(*ref, *got, rtol=1e-4, atol=1e-4)
    assert got[1].min() >= 1000


def test_haversine_matches_jax():
    rng = np.random.default_rng(3)
    def latlon(n):
        return np.stack([rng.uniform(-np.pi / 2, np.pi / 2, n),
                         rng.uniform(-np.pi, np.pi, n)], axis=1).astype(np.float32)
    x, q = latlon(350), latlon(9)
    ref = _jax([x], q, 8, D.Haversine)
    got = _port([x], q, 8, D.Haversine)
    # distances in [0, pi] from sin / cos / asin of float32: 1e-5
    assert_knn_close(*ref, *got, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("n_parts", [1, 2])
def test_rerank_matches_jax(n_parts):
    # first stage in bfloat16 for k * 2 candidates, then an exact float32
    # re-rank: the final distances are recomputed element-wise, so they
    # agree tightly once the true neighbours survive the first stage
    x, q = _data(400, 10, 16, seed=4)
    parts = [x] if n_parts == 1 else [x[:190], x[190:]]
    ref = _jax(parts, q, 10, D.L2Expanded, rerank_ratio=2)
    got = _port(parts, q, 10, D.L2Expanded, rerank_ratio=2)
    assert_knn_close(*ref, *got, rtol=1e-5, atol=1e-5)


def test_small_tiles_match_jax():
    # several tiles of the scan route, with a ragged last tile
    x, q = _data(333, 6, 8, seed=5)
    ref = _jax([x], q, 15, D.L2Expanded, tile_n=64)
    got = _port([x], q, 15, D.L2Expanded, tile_n=64)
    assert_knn_close(*ref, *got, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("select_min", [True, False], ids=["min", "max"])
def test_knn_merge_parts_matches_jax(select_min):
    rng = np.random.default_rng(6)
    n_parts, nq, k = 3, 8, 12
    dist = np.sort(rng.random((n_parts, nq, k)).astype(np.float32), axis=2)
    if not select_min:
        dist = dist[:, :, ::-1].copy()
    ids = rng.integers(0, 100, (n_parts, nq, k)).astype(np.int32)
    trans = [0, 100, 200]
    ref_d, ref_i = jax_merge(jnp.asarray(dist), jnp.asarray(ids), k, trans,
                             select_min=select_min)
    state = from_reference((dist, ids), device="cpu")
    got_d, got_i = knn_merge_parts(*state, k, trans, select_min=select_min, device="cpu")
    np.testing.assert_array_equal(to_numpy(got_d), np.asarray(ref_d))
    np.testing.assert_array_equal(to_numpy(got_i), np.asarray(ref_i))


def test_from_reference_keeps_dtype_and_layout():
    ids = np.arange(12, dtype=np.int32).reshape(3, 4)
    vecs = np.asfortranarray(np.ones((3, 4), np.float32))
    t = from_reference({"ids": ids, "vecs": vecs, "metric": int(D.L1)}, device="cpu")
    assert str(t["ids"].dtype) == "torch.int32" and t["ids"].is_contiguous()
    assert str(t["vecs"].dtype) == "torch.float32" and t["vecs"].is_contiguous()
    assert t["metric"] == 3
    np.testing.assert_array_equal(to_numpy(t)["ids"], ids)


def test_argument_checks():
    x, q = _data(50, 3, 4)
    with pytest.raises(LogicError):
        brute_force_knn(x, q, 5, D.InnerProduct, rerank_ratio=2, device="cpu")
    with pytest.raises(LogicError):
        brute_force_knn(x, q, 5, rerank_ratio=0, device="cpu")
    with pytest.raises(LogicError):
        brute_force_knn([x, x[:, :3]], q, 5, device="cpu")
    with pytest.raises(LogicError):
        brute_force_knn(x, q[:, :2], 5, D.Haversine, device="cpu")
