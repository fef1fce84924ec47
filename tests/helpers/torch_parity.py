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
