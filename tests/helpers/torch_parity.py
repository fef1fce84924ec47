"""Shared checks of the port (raft_tpu_torch) against the JAX package."""

import numpy as np


def assert_knn_close(d_ref, i_ref, d_got, i_got, rtol, atol):
    """Distances agree element-wise within the tolerance; ids agree as
    per-row sets, except where the reference's k-th distance ties (within
    the tolerance) with a distance the port chose instead."""
    d_ref, i_ref = np.asarray(d_ref), np.asarray(i_ref)
    d_got, i_got = np.asarray(d_got), np.asarray(i_got)
    assert d_got.shape == d_ref.shape and i_got.shape == i_ref.shape
    assert i_got.dtype == np.int32
    np.testing.assert_allclose(d_got, d_ref, rtol=rtol, atol=atol)
    for row in range(d_ref.shape[0]):
        extra = np.setdiff1d(i_got[row], i_ref[row])
        assert len(np.unique(i_got[row])) == i_got.shape[1], "duplicate ids"
        kth = d_ref[row, -1]
        for idx in extra:
            d = d_got[row][i_got[row] == idx][0]
            assert abs(d - kth) <= atol + rtol * abs(kth), (
                "row %d: id %d at distance %r is not a tie with the k-th "
                "reference distance %r" % (row, idx, d, kth))
