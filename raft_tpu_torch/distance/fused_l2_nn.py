"""Fused L2 distance + 1-nearest-neighbour reduction.

Port of ``raft_tpu/distance/fused_l2_nn.py`` (reference
fused_l2_nn.hpp:84 and detail/fused_l2_nn.cuh:134,267): for each row of x,
the nearest row of y under L2 and its int32 index, without the (m, n)
distance matrix.  Ties between finite values resolve to the smaller index
(the reference's atomic version is first-writer-wins); a row with no
admissible pair keeps the sentinel ``(inf, IDX_SENTINEL)``.

Two implementations with one contract, named as in
``spatial/fused_l2_knn.py``:

- ``impl="kernel"``: K4 (:func:`raft_tpu_torch.ops.nn_tile.fused_nn_tile`),
  for the plain float32 min-reduce: float32 inputs (or narrower ones,
  through a float32 copy), ``precision="highest"`` (3xTF32) or
  ``"default"`` (its bfloat16 instance), no mask.  An explicit request
  outside those limits raises, as the JAX ``impl="pallas"`` does.
- ``impl="scan"``: :func:`fused_l2_nn_min_reduce`, a loop over column
  tiles of y (one expanded-form matmul and a per-row argmin each) merged
  into a running (value, index) pair, with the pluggable reduce op, the
  masks and float64.  Plain torch, as it is plain XLA in JAX.

``impl=None`` takes the kernel on CUDA wherever it is legal, and the
scan otherwise, which includes every CPU call.  ``fused_nn_impl`` is a
registry-only knob, as in the JAX package: an explicit value is checked
by :func:`raft_tpu_torch.core.tuning.check`, and no config, environment
or table rung reaches it.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from raft_tpu_torch.core import tuning
from raft_tpu_torch.core.precision import PRECISIONS
from raft_tpu_torch.core.device import as_tensor, resolve_device
from raft_tpu_torch.core.error import expects
from raft_tpu_torch.distance.pairwise import matmul
from raft_tpu_torch.ops.nn_tile import IDX_SENTINEL, fused_nn_tile

IMPLS = tuning.candidates("fused_nn_impl")

__all__ = ["IDX_SENTINEL", "fused_l2_nn", "fused_l2_nn_min_reduce"]


def _default_reduce(best, cand):
    bv, bi = best
    cv, ci = cand
    # strict improvement, or a finite tie broken toward the smaller index;
    # inf == inf is no tie, so fully masked rows keep the sentinel
    take = (cv < bv) | ((cv == bv) & torch.isfinite(cv) & (ci < bi))
    return torch.where(take, cv, bv), torch.where(take, ci, bi)


def _value_dtype(x: torch.Tensor) -> torch.dtype:
    # integer inputs promote to float: the inf sentinel and the distance
    # arithmetic are floating-point
    return torch.promote_types(x.dtype, torch.float32)


def fused_l2_nn_min_reduce(
    x,
    y,
    sqrt: bool = False,
    reduce_op: Optional[Callable] = None,
    init_val: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    tile_n: int = 4096,
    mask=None,
    tile_mask_fn: Optional[Callable] = None,
    precision: str = "highest",
    device="cuda",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Tiled L2 + 1-NN scan with a pluggable (value, index) reduce op
    (reference fused_l2_nn.hpp:29-45 MinAndDistanceReduceOp).

    ``reduce_op(best (val, idx), cand (val, idx)) -> (val, idx)`` merges
    each tile's per-row minimum into the running pair; ``init_val`` seeds
    the running pair (default ``(inf, IDX_SENTINEL)``).  ``mask`` (m, n),
    True = pair admissible; ``tile_mask_fn(j0, tile_n) -> (m, tile_n)``
    bool computes the mask of the tile starting at column j0 on the fly
    (columns past n are ignored).  ``sqrt`` reports root distances
    (monotone, so the reduction is unchanged).  Returns (m,) values and
    (m,) int32 indices.
    """
    dev = resolve_device(device)
    x = as_tensor(x, dev)
    y = as_tensor(y, dev)
    expects(x.ndim == 2 and y.ndim == 2 and x.shape[1] == y.shape[1],
            "fused_l2_nn: shape mismatch")
    m, n = x.shape[0], y.shape[0]
    expects(n > 0, "fused_l2_nn: empty index")
    tile_n = min(tile_n, n)
    rop = reduce_op or _default_reduce
    val_dtype = _value_dtype(x)
    x = x.to(val_dtype)
    y = y.to(val_dtype)
    if mask is not None:
        mask = as_tensor(mask, dev, dtype=torch.bool)
    xn = (x * x).sum(dim=1)
    best = init_val
    if best is None:
        best = (torch.full((m,), float("inf"), dtype=val_dtype, device=dev),
                torch.full((m,), IDX_SENTINEL, dtype=torch.int32, device=dev))
    for j0 in range(0, n, tile_n):
        y_t = y[j0:j0 + tile_n]
        w = y_t.shape[0]
        d = xn[:, None] + (y_t * y_t).sum(dim=1)[None, :] - 2.0 * matmul(x, y_t.T, precision)
        d = torch.clamp(d, min=0.0).to(val_dtype)
        if mask is not None:
            d = torch.where(mask[:, j0:j0 + w], d, float("inf"))
        if tile_mask_fn is not None:
            d = torch.where(as_tensor(tile_mask_fn(j0, tile_n), dev, dtype=torch.bool)[:, :w],
                            d, float("inf"))
        if sqrt:
            d = torch.sqrt(d)
        t_val, t_idx = torch.min(d, dim=1)       # the first index among equal minima
        best = rop(best, (t_val, (t_idx + j0).to(torch.int32)))
    return best


def fused_l2_nn(
    x,
    y,
    sqrt: bool = False,
    tile_n: int = 4096,
    mask=None,
    precision: str = "highest",
    impl: Optional[str] = None,
    device="cuda",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """For each row of x (m, d): the minimum L2 distance to the rows of y
    (n, d) and its index.  Returns ``(min_dists (m,), min_idx (m,) int32)``.

    ``sqrt`` applies the square root to the reported minimum.  ``mask``
    (m, n) optionally excludes pairs (True = allowed); a fully masked row
    returns ``(inf, IDX_SENTINEL)``.  ``impl`` is ``"kernel"``, ``"scan"``
    or None (module doc).  Inputs (numpy arrays or tensors) are moved to
    ``device``.
    """
    dev = resolve_device(device)
    x = as_tensor(x, dev)
    y = as_tensor(y, dev)
    vdt = torch.promote_types(_value_dtype(x), _value_dtype(y))
    legal = mask is None and precision in PRECISIONS and vdt == torch.float32
    impl = tuning.resolve("fused_nn_impl", impl, site="fused_l2_nn", dtype=vdt,
                          n=y.shape[0], k=1, masked=mask is not None, precision=precision,
                          device=dev.type)
    if impl is None:
        impl = "kernel" if legal and dev.type == "cuda" else "scan"
    if impl == "kernel":
        vals, idx = fused_nn_tile(x.to(torch.float32), y.to(torch.float32), precision)
        return (torch.sqrt(vals) if sqrt else vals), idx
    return fused_l2_nn_min_reduce(x, y, sqrt=sqrt, tile_n=tile_n, mask=mask,
                                  precision=precision, device=dev)
