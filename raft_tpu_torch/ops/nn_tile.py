"""K4: fused squared-L2 distance + 1-nearest-neighbour, ``csrc/nn_tile.cu``.

Port of ``raft_tpu/ops/nn_tile.py:fused_nn_tile``: per row of x, the
minimum of ``max(xn + yn - 2 x.y, 0)`` over the rows of y and its int32
index, float32 inputs (float16 and bfloat16 through a float32 copy),
distances float32-faithful at ``precision="highest"`` (met in 3xTF32 on
the tensor cores as K1 meets it) or the TPU's bfloat16 single pass at
``"default"`` (the kernel's bfloat16 instance; the plain version takes
:func:`raft_tpu_torch.core.precision.matmul_bf16`).  Ties resolve to the
smaller index; a row with no finite distance keeps ``(inf,
IDX_SENTINEL)``, and a NaN distance is never taken.  An empty y is rejected.  The norms are computed here with torch
ops, as ``pad_with_norms`` computes them outside the Pallas call, and
:func:`raft_tpu_torch.ops.knn_tile.prepare_operands` pads a copy of x
and y where the depth is not a multiple of 8.

The kernel is the fused kNN body of K1 (``csrc/knn_tile.cuh``) at k = 1,
walking tiles of x as a work list (the source note of
``csrc/nn_tile.cu``).  The JAX kernel's (bm, 128) lane-strided running
minimum and its 128 -> 1 reduction in XLA have no counterpart, and its
``nn_block_n`` knob none either.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from raft_tpu_torch.core import inventory
from raft_tpu_torch.core.error import expects
from raft_tpu_torch.ops import _build, cost
from raft_tpu_torch.ops.knn_tile import as_float32, prepare_operands, products

IDX_SENTINEL = 2**31 - 1

# y rows per tile of the plain version
_PLAIN_TILE = 4096


def nn_tile_plain(x: torch.Tensor, y: torch.Tensor,
                  precision: str = "highest") -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: expanded-form distances one y tile at a time
    (one matmul each, ``products(precision)``) and a lexicographic (value,
    index) minimum."""
    dot = products(precision)
    x = x.to(torch.float32)
    y = y.to(torch.float32)
    m = x.shape[0]
    xn = (x * x).sum(dim=1)
    best_v = torch.full((m,), float("inf"), dtype=torch.float32, device=x.device)
    best_i = torch.full((m,), IDX_SENTINEL, dtype=torch.int32, device=x.device)
    for j0 in range(0, y.shape[0], _PLAIN_TILE):
        t = y[j0:j0 + _PLAIN_TILE]
        d = torch.clamp(xn[:, None] + (t * t).sum(dim=1)[None, :] - 2.0 * dot(x, t.T), min=0.0)
        v, i = torch.min(d, dim=1)          # the first index among equal minima
        i = (i + j0).to(torch.int32)
        take = (v < best_v) | ((v == best_v) & torch.isfinite(v) & (i < best_i))
        best_v = torch.where(take, v, best_v)
        best_i = torch.where(take, i, best_i)
    return best_v, best_i


def fused_nn_tile(x: torch.Tensor, y: torch.Tensor,
                  precision: str = "highest") -> Tuple[torch.Tensor, torch.Tensor]:
    """Per row of x: the minimum squared L2 distance to the rows of y and
    its index.

    x (m, d) and y (n, d) float32 (float16 and bfloat16 through a copy),
    n > 0, ``precision`` ``"highest"`` or ``"default"`` (module doc);
    returns (m,) float32 and (m,) int32.  A CUDA tensor launches the
    kernel; a CPU tensor takes :func:`nn_tile_plain`.
    """
    expects(x.ndim == 2 and y.ndim == 2 and x.shape[1] == y.shape[1],
            "fused_nn_tile: shape mismatch")
    m, d = x.shape
    n = y.shape[0]
    expects(n > 0, "fused_nn_tile: empty index")
    products(precision)
    x = as_float32(x, "fused_nn_tile")
    y = as_float32(y, "fused_nn_tile")
    expects(x.device == y.device, "fused_nn_tile: x and y on different devices")
    if x.device.type == "cpu":
        return nn_tile_plain(x, y, precision)
    fn = _entry()
    out_v = torch.empty((m,), dtype=torch.float32, device=x.device)
    out_i = torch.empty((m,), dtype=torch.int32, device=x.device)
    if m == 0:
        return out_v, out_i
    expects(d > 0, "fused_nn_tile: zero depth")
    y, x, xn, yn = prepare_operands(y, x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = fn(x.data_ptr(), y.data_ptr(), xn.data_ptr(), yn.data_ptr(), m, n, x.shape[1],
                  int(precision == "default"), out_v.data_ptr(), out_i.data_ptr(), stream)
    _build.check(code, "fused_nn_tile")
    fused_nn_tile.launches += 1
    inventory.count_launch("nn_tile", (m, n, x.shape[1], precision), lambda: (
        *cost.nn_cost(m, n, d), inventory.footprint((x, y, xn, yn), (out_v, out_i))))
    return out_v, out_i


fused_nn_tile.launches = 0


def _entry():
    return _build.entry("nn_tile", "nn_tile_launch",
                        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 3,
                        ctypes.c_int)
