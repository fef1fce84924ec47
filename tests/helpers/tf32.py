"""The arithmetic of K1's and K6's tensor-core distance tile, in numpy:
TF32 rounding, the big/small split, and dot products in 3xTF32 or in one
TF32 pass (float32 sums of exact products of TF32 values)."""

import numpy as np


def tf32_round(x):
    """Round float32 to TF32 (10 mantissa bits), to nearest with ties away
    from zero, as ``cvt.rna.tf32.f32`` does: add half of the dropped unit
    to the bits, then clear the low 13."""
    bits = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def split_tf32(x):
    """``(big, small)``: big = tf32(x), small = tf32(x - big), so that
    big + small is x to about 2^-22 relative."""
    big = tf32_round(x)
    return big, tf32_round(np.asarray(x, np.float32) - big)


def dots_tf32x3(queries, index):
    """(nq, n) dot products in 3xTF32: small*big + big*small first, then
    big*big, summed in float32.  A product of two TF32 values is exact in
    float32, so each pass is a float32 matmul of the halves."""
    qb, qs = split_tf32(queries)
    xb, xs = split_tf32(index)
    return (qb @ xs.T + qs @ xb.T) + qb @ xb.T


def dots_tf32(queries, index):
    """(nq, n) dot products in one TF32 pass: big*big only."""
    return tf32_round(queries) @ tf32_round(index).T


def knn_from_dots(queries, index, dots, k):
    """The k smallest ``max(qn + xn - 2 dots, 0)`` per query in float32,
    ascending, ties to the smaller id (a stable sort): K1's output from
    the given dot products."""
    queries = np.asarray(queries, np.float32)
    index = np.asarray(index, np.float32)
    qn = (queries * queries).sum(axis=1, dtype=np.float32)[:, None]
    xn = (index * index).sum(axis=1, dtype=np.float32)[None, :]
    dist = np.maximum(qn + xn - np.float32(2.0) * dots.astype(np.float32), np.float32(0.0))
    order = np.argsort(dist, axis=1, kind="stable")[:, :k]
    return np.take_along_axis(dist, order, axis=1), order.astype(np.int32)
