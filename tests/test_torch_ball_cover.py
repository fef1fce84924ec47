"""Port parity: the random ball cover (``spatial/ball_cover.py``) and its
converter.

The build draws its landmarks with numpy from the seed, as the JAX
package does, so the port's build is held to the JAX build directly: the
same landmark rows, equal groups and radii within 1e-5.  Queries are
exact: against scipy's ``cdist`` for 2-D and 3-D L2 data, and against a
float64 haversine scan for lat/lon data (the recipes of
``tests/test_ann.py``), with distances within 1e-4 (float32 expanded
forms in another order) and ids as per-row sets except at ties.  Against
the JAX query the L2 root distances are compared squared, within 1e-5:
the square root of an expanded form near 0 magnifies its rounding.  A tiny
chunk budget (``ball_cover.BUDGET_BYTES``) must give the unchunked
result, and a JAX-built index carried by ``convert`` answers as the JAX
query does.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.spatial.distance as spd
import torch

from helpers.torch_parity import assert_knn_close
from raft_tpu.distance.distance_type import DistanceType as JD
from raft_tpu.spatial import ball_cover as jbc
from raft_tpu_torch import (BallCoverIndex, DistanceType, LogicError, rbc_all_knn_query,
                            rbc_build_index, rbc_knn_query)
from raft_tpu_torch.convert import ball_cover_index_from_reference
from raft_tpu_torch.spatial import ball_cover as pbc

D = DistanceType
RTOL, ATOL = 1e-4, 1e-4


def _latlon(m, seed):
    rng = np.random.default_rng(seed)
    lat = rng.uniform(-np.pi / 2, np.pi / 2, m)
    lon = rng.uniform(-np.pi, np.pi, m)
    return np.stack([lat, lon], 1).astype(np.float32)


def _haversine64(a, b):
    a, b = a.astype(np.float64), b.astype(np.float64)
    sin_lat = np.sin(0.5 * (a[:, None, 0] - b[None, :, 0]))
    sin_lon = np.sin(0.5 * (a[:, None, 1] - b[None, :, 1]))
    r = sin_lat ** 2 + np.cos(a[:, None, 0]) * np.cos(b[None, :, 0]) * sin_lon ** 2
    return 2.0 * np.arcsin(np.sqrt(np.clip(r, 0.0, 1.0)))


def _exact(full, k):
    ids = np.argsort(full, axis=1, kind="stable")[:, :k]
    return np.take_along_axis(full, ids, axis=1), ids.astype(np.int32)


CASES = {
    "2d L2Sqrt": (lambda: np.random.default_rng(0).random((800, 2)).astype(np.float32),
                  D.L2SqrtExpanded),
    "2d L2": (lambda: np.random.default_rng(0).random((800, 2)).astype(np.float32),
              D.L2Expanded),
    "3d": (lambda: np.random.default_rng(2).random((600, 3)).astype(np.float32),
           D.L2SqrtExpanded),
    "haversine": (lambda: _latlon(500, 1), D.Haversine),
}


def _cdist(Q, X, metric):
    if metric == D.Haversine:
        return _haversine64(Q, X)
    return spd.cdist(Q.astype(np.float64), X.astype(np.float64),
                     "sqeuclidean" if metric == D.L2Expanded else "euclidean")


# --------------------------------------------------------------------- #
# build
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("case", list(CASES))
def test_build_matches_jax(case):
    X, metric = CASES[case][0](), CASES[case][1]
    ref = jbc.rbc_build_index(X, metric=JD(int(metric)), seed=3)
    got = rbc_build_index(X, metric=metric, seed=3, device="cpu")
    assert isinstance(got, BallCoverIndex) and got.metric == metric
    np.testing.assert_array_equal(got.landmarks.numpy(), np.asarray(ref.landmarks))
    assert got.groups.dtype == torch.int32 and got.radius.dtype == torch.float32
    np.testing.assert_array_equal(got.groups.numpy(), np.asarray(ref.groups))
    np.testing.assert_allclose(got.radius.numpy(), np.asarray(ref.radius), rtol=0, atol=1e-5)
    np.testing.assert_array_equal(got.X.numpy(), X)


def test_groups_hold_every_row_once_by_descending_distance():
    X = CASES["2d L2Sqrt"][0]()
    idx = rbc_build_index(X, n_landmarks=20, seed=1, device="cpu")
    g = idx.groups.numpy()
    assert g.shape[0] == 20 and sorted(g[g >= 0].tolist()) == list(range(len(X)))
    lm = idx.landmarks.numpy()
    for row in range(20):
        members = g[row][g[row] >= 0]
        d = np.sqrt(((X[members] - lm[row]) ** 2).sum(1))
        assert (np.diff(d) <= 1e-6).all()
        assert abs(d.max() - idx.radius[row].item()) <= 1e-5


def test_numpy_packing_matches_the_native_route():
    rng = np.random.default_rng(4)
    owner = rng.integers(0, 7, 300)
    dist = rng.random(300).astype(np.float32)
    gmax = int(np.bincount(owner, minlength=7).max())
    nat = pbc.native.pack_groups(owner, dist, 7, gmax)
    if nat is None:
        pytest.skip("the host runtime did not build (no g++)")
    groups, radius = pbc._pack_groups_numpy(owner, dist, 7, gmax)
    np.testing.assert_array_equal(groups, nat[0].astype(np.int32))
    np.testing.assert_array_equal(radius, nat[1].astype(np.float32))


# --------------------------------------------------------------------- #
# queries
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("case", ["2d L2Sqrt", "2d L2"])
def test_query_is_exact_2d(case):
    X, metric = CASES[case][0](), CASES[case][1]
    Q = np.random.default_rng(0).random((60, 2)).astype(np.float32)
    idx = rbc_build_index(X, metric=metric, device="cpu")
    dd, ii = rbc_knn_query(idx, 7, Q, device="cpu")
    assert_knn_close(*_exact(_cdist(Q, X, metric), 7), dd.numpy(), ii.numpy(), RTOL, ATOL)


def test_all_knn_is_exact_3d():
    X, metric = CASES["3d"][0](), CASES["3d"][1]
    idx = rbc_build_index(X, metric=metric, device="cpu")
    dd, ii = rbc_all_knn_query(idx, 4, device="cpu")
    assert_knn_close(*_exact(_cdist(X, X, metric), 4), dd.numpy(), ii.numpy(), RTOL, ATOL)


def test_all_knn_is_exact_haversine():
    X = CASES["haversine"][0]()
    idx = rbc_build_index(X, metric=D.Haversine, device="cpu")
    dd, ii = rbc_all_knn_query(idx, 5, device="cpu")
    np.testing.assert_array_equal(ii.numpy()[:, 0], np.arange(len(X)))
    np.testing.assert_allclose(dd.numpy()[:, 0], 0.0, atol=1e-5)
    ref = _exact(_haversine64(X, X), 5)
    assert_knn_close(*ref, dd.numpy(), ii.numpy(), 0.0, 1e-5)


@pytest.mark.parametrize("n_landmarks", [150, 30], ids=["sorted ranks", "K2 ranks"])
def test_many_and_few_landmarks_are_exact(n_landmarks):
    rng = np.random.default_rng(5)
    X = rng.random((3000, 2)).astype(np.float32)
    Q = rng.random((40, 2)).astype(np.float32)
    idx = rbc_build_index(X, n_landmarks=n_landmarks, device="cpu")
    dd, ii = rbc_knn_query(idx, 9, Q, device="cpu")
    ref = _exact(_cdist(Q, X, D.L2SqrtExpanded), 9)
    assert_knn_close(*ref, dd.numpy(), ii.numpy(), RTOL, ATOL)


@pytest.mark.parametrize("case", list(CASES))
def test_query_matches_jax_on_a_carried_index(case):
    X, metric = CASES[case][0](), CASES[case][1]
    Q = X[::7] + np.float32(1e-3)
    jidx = jbc.rbc_build_index(X, metric=JD(int(metric)))
    pidx = ball_cover_index_from_reference(jidx, device="cpu")
    ref_d, ref_i = jbc.rbc_knn_query(jidx, 6, jnp.asarray(Q))
    got_d, got_i = rbc_knn_query(pidx, 6, Q, device="cpu")
    ref_d, got_d = np.asarray(ref_d), got_d.numpy()
    if metric == D.L2SqrtExpanded:
        ref_d, got_d = ref_d ** 2, got_d ** 2
    assert_knn_close(ref_d, ref_i, got_d, got_i.numpy(), 0.0, 1e-5)


@pytest.mark.parametrize("case", ["2d L2Sqrt", "haversine"])
def test_small_budget_chunks_give_the_unchunked_result(case, monkeypatch):
    X, metric = CASES[case][0](), CASES[case][1]
    idx = rbc_build_index(X, metric=metric, device="cpu")
    whole, one = rbc_all_knn_query(idx, 5, device="cpu", stats={}), {}
    rbc_all_knn_query(idx, 5, device="cpu", stats=one)
    assert one["chunks"] == 1 and one["chunk_rows"] >= len(X)
    L, gmax = idx.groups.shape
    # room for 13 queries a chunk
    monkeypatch.setattr(pbc, "BUDGET_BYTES", 13 * pbc.query_bytes(gmax, X.shape[1], L))
    stats = {}
    chunked = rbc_all_knn_query(idx, 5, device="cpu", stats=stats)
    assert stats["chunk_rows"] == 13 and stats["chunks"] == -(-len(X) // 13)
    assert len(stats["steps"]) == stats["chunks"] and min(stats["steps"]) >= 1
    assert torch.equal(chunked[0], whole[0]) and torch.equal(chunked[1], whole[1])
    # the build's assignment in row chunks too
    again = rbc_build_index(X, metric=metric, device="cpu")
    assert torch.equal(again.groups, idx.groups) and torch.equal(again.radius, idx.radius)


def test_validation():
    X = CASES["3d"][0]()
    with pytest.raises(LogicError, match="unsupported metric"):
        rbc_build_index(X, metric=D.L1, device="cpu")
    with pytest.raises(LogicError, match="lat/lon"):
        rbc_build_index(X, metric=D.Haversine, device="cpu")
    idx = rbc_build_index(X, device="cpu")
    with pytest.raises(LogicError, match="queries"):
        rbc_knn_query(idx, 3, X[:, :2], device="cpu")
    with pytest.raises(LogicError, match="k="):
        rbc_knn_query(idx, len(X) + 1, X[:2], device="cpu")
