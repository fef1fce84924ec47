"""The arithmetic of the tensor-core distance tile of K1, K3, K4 and K6,
in numpy: TF32 and bfloat16 rounding, the big/small split, and dot
products in 3xTF32 or in one TF32 pass (float32 sums of exact products of
TF32 values), 3xTF32 with the tensor cores' truncating sums, and the
bfloat16 single pass of precision="default" with either sum."""

import numpy as np


def tf32_round(x):
    """Round float32 to TF32 (10 mantissa bits), to nearest with ties away
    from zero, as ``cvt.rna.tf32.f32`` does: add half of the dropped unit
    to the bits, then clear the low 13."""
    bits = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def bf16_round(x):
    """Round float32 to bfloat16 (7 mantissa bits), to nearest even, as
    float32 values: K3's ``accum_bf16`` operands (``sm90.cuh:bf16_rne``,
    torch's rounding)."""
    bits = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
    odd = (bits >> np.uint32(16)) & np.uint32(1)
    return ((bits + np.uint32(0x7FFF) + odd) & np.uint32(0xFFFF0000)).view(np.float32)


def split_tf32(x):
    """``(big, small)``: big = tf32(x), small = tf32(x - big), so that
    big + small is x to about 2^-22 relative."""
    big = tf32_round(x)
    return big, tf32_round(np.asarray(x, np.float32) - big)


def _toward_zero(v):
    """float64 values to float32, rounded toward zero."""
    r = v.astype(np.float32)
    over = np.abs(r.astype(np.float64)) > np.abs(v)
    r[over] = np.nextafter(r[over], np.float32(0))
    return r


def dots_tf32x3(queries, index, acc=None):
    """(nq, n) dot products in 3xTF32: small*big + big*small first, then
    big*big.  A product of two TF32 values is exact in float32, so with
    ``acc=None`` each pass is a float32 matmul of the halves (sums rounded
    to nearest).  ``acc="one"`` and ``acc="split"`` sum as the tensor
    cores do: each wgmma adds the exact sum of its eight products (one k8
    step) into a float32 accumulator, truncated toward zero; "one" puts
    the three wgmmas of a step into one accumulator, "split" the two small
    ones into an accumulator of their own, added to the dot product's at
    the end (``csrc/knn_tile.cuh``)."""
    qb, qs = split_tf32(queries)
    xb, xs = split_tf32(index)
    if acc is None:
        return (qb @ xs.T + qs @ xb.T) + qb @ xb.T
    assert acc in ("one", "split"), acc
    qb, qs, xb, xs = (a.astype(np.float64) for a in (qb, qs, xb, xs))
    big = np.zeros((len(qb), len(xb)), np.float32)
    small = big if acc == "one" else np.zeros_like(big)
    for s in range(0, qb.shape[1], 8):
        k8 = slice(s, s + 8)
        small = _toward_zero(small + qs[:, k8] @ xb[:, k8].T)
        small = _toward_zero(small + qb[:, k8] @ xs[:, k8].T)
        if acc == "one":
            big = small = _toward_zero(small + qb[:, k8] @ xb[:, k8].T)
        else:
            big = _toward_zero(big + qb[:, k8] @ xb[:, k8].T)
    return big if acc == "one" else big + small


def dots_tf32(queries, index):
    """(nq, n) dot products in one TF32 pass: big*big only."""
    return tf32_round(queries) @ tf32_round(index).T


def dots_bf16(queries, index, acc=None):
    """(nq, n) dot products at the JAX ``precision="default"``: the
    operands rounded to bfloat16, their exact products summed in float32
    (``acc=None``: a float32 matmul of the rounded values, what the plain
    versions compute), or ``acc="one"`` as the kernels' bfloat16 instance
    sums them: each k8 step's exact sum added into one float32
    accumulator truncated toward zero (``dots_tf32x3``'s "one" with the
    small halves zero)."""
    qb, xb = bf16_round(queries), bf16_round(index)
    if acc is None:
        return qb @ xb.T
    assert acc == "one", acc
    qb, xb = qb.astype(np.float64), xb.astype(np.float64)
    out = np.zeros((len(qb), len(xb)), np.float32)
    for s in range(0, qb.shape[1], 8):
        out = _toward_zero(out + qb[:, s:s + 8] @ xb[:, s:s + 8].T)
    return out


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


def nn_from_dots(x, y, dots):
    """Per row of x, the smallest ``max(xn + yn - 2 dots, 0)`` in float32
    and its index, ties to the smaller index: K4's output from the given
    dot products."""
    x = np.asarray(x, np.float32)
    y = np.asarray(y, np.float32)
    xn = (x * x).sum(axis=1, dtype=np.float32)[:, None]
    yn = (y * y).sum(axis=1, dtype=np.float32)[None, :]
    dist = np.maximum(xn + yn - np.float32(2.0) * dots.astype(np.float32), np.float32(0.0))
    idx = np.argmin(dist, axis=1)        # the first index among equal minima
    return dist[np.arange(len(x)), idx], idx.astype(np.int32)
