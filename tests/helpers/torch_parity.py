"""Shared checks of the port (raft_tpu_torch) against the JAX package."""

import numpy as np


def assert_knn_close(d_ref, i_ref, d_got, i_got, rtol, atol):
    """Distances agree element-wise within the tolerance; ids agree as
    per-row sets, except where the reference's k-th distance ties (within
    the tolerance) with a distance the port chose instead.  Deficit slots
    (id -1, distance +inf, where a row had fewer than k candidates) must
    sit at the same places in both."""
    d_ref, i_ref = np.asarray(d_ref), np.asarray(i_ref)
    d_got, i_got = np.asarray(d_got), np.asarray(i_got)
    assert d_got.shape == d_ref.shape and i_got.shape == i_ref.shape
    assert i_got.dtype == np.int32
    np.testing.assert_array_equal(i_got < 0, i_ref < 0, "deficit slots differ")
    assert np.isinf(d_got[i_got < 0]).all() and (i_got[i_got < 0] == -1).all()
    np.testing.assert_allclose(d_got, d_ref, rtol=rtol, atol=atol)
    for row in range(d_ref.shape[0]):
        live = i_ref[row] >= 0
        got, ref = i_got[row][live], i_ref[row][live]
        assert len(np.unique(got)) == len(got), "duplicate ids"
        if not live.any():
            continue
        kth = d_ref[row][live][-1]
        for idx in np.setdiff1d(got, ref):
            d = d_got[row][i_got[row] == idx][0]
            assert abs(d - kth) <= atol + rtol * abs(kth), (
                "row %d: id %d at distance %r is not a tie with the k-th "
                "reference distance %r" % (row, idx, d, kth))


def adjusted_rand_index(a, b) -> float:
    """The adjusted Rand index of two labellings (the contingency-table
    formula of tests/test_scale_stress.py)."""
    a, b = np.asarray(a).ravel(), np.asarray(b).ravel()
    _, ai = np.unique(a, return_inverse=True)
    _, bi = np.unique(b, return_inverse=True)
    c = np.zeros((ai.max() + 1, bi.max() + 1), np.int64)
    np.add.at(c, (ai, bi), 1)

    def comb2(x):
        return x * (x - 1) / 2.0

    sum_ij = comb2(c.astype(np.float64)).sum()
    sum_a = comb2(c.sum(axis=1).astype(np.float64)).sum()
    sum_b = comb2(c.sum(axis=0).astype(np.float64)).sum()
    expected = sum_a * sum_b / comb2(float(a.size))
    top = 0.5 * (sum_a + sum_b)
    return 1.0 if top == expected else float((sum_ij - expected) / (top - expected))


def max_principal_angle(u, v) -> float:
    """The largest principal angle (radians) between the column spans of
    ``u`` and ``v`` (float64)."""
    qu, _ = np.linalg.qr(np.asarray(u, np.float64))
    qv, _ = np.linalg.qr(np.asarray(v, np.float64))
    s = np.linalg.svd(qu.T @ qv, compute_uv=False)
    return float(np.arccos(np.clip(s.min(), -1.0, 1.0)))
