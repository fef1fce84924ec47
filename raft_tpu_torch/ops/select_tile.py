"""K2: per-row selection of the k smallest keys, ``csrc/select_tile.cu``.

Port of ``raft_tpu/ops/select_tile.py:select_tile``: per row of an
(m, w) float key matrix, the k smallest keys ascending and their int32
column ids, k <= 128.  A row with fewer than k finite keys fills the rest
with +inf keys, and every id lies in [0, w - 1].  Ties resolve to the
smaller column, so the result is the first k of a stable ascending sort.

The kernel shares its selection core (``csrc/warp_select.cuh``) with the
fused kNN kernel, as the JAX kernels share ``topk_update``.  The JAX
knob ``knn_tile_merge`` (``merge``/``fullsort``/``sorttile``/``skip``)
picks between lane-network variants of the TPU's 128-lane vector unit;
a warp's shuffles have no such variants, so it has no counterpart here.
"""

from __future__ import annotations

import ctypes
from collections import Counter
from typing import Tuple

import torch

from raft_tpu_torch.core.error import expects
from raft_tpu_torch.ops import _build

MAX_K = 128


def select_tile_plain(keys: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: the first k of a stable ascending sort."""
    vals, idx = torch.sort(keys.to(torch.float32), dim=1, stable=True)
    return vals[:, :k].contiguous(), idx[:, :k].to(torch.int32)


def select_tile(keys: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k smallest keys per row and their column ids.

    keys (m, w) float (cast to float32); returns (m, k) float32 ascending
    and (m, k) int32.  A CUDA tensor launches the kernel; a CPU tensor
    takes :func:`select_tile_plain`.
    """
    expects(keys.ndim == 2, "select_tile: 2-D keys required")
    m, w = keys.shape
    expects(0 < k <= w, "select_tile: k=%d out of range for w=%d", k, w)
    expects(k <= MAX_K, "select_tile: k <= %d (got %d)", MAX_K, k)
    expects(keys.is_floating_point(),
            "select_tile: float keys required, got %s", keys.dtype)
    if keys.device.type == "cpu":
        return select_tile_plain(keys, k)
    fn = _entry()
    keys = keys.to(torch.float32).contiguous()
    out_k = torch.empty((m, k), dtype=torch.float32, device=keys.device)
    out_i = torch.empty((m, k), dtype=torch.int32, device=keys.device)
    if m == 0:
        return out_k, out_i
    with torch.cuda.device(keys.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = fn(keys.data_ptr(), m, w, k, out_k.data_ptr(), out_i.data_ptr(),
                  stream)
    _build.check(code, "select_tile")
    select_tile.launches += 1
    select_tile.shapes[(m, w, k)] += 1
    return out_k, out_i


select_tile.launches = 0
# launches by (rows, width, k): the merges and probes of a path differ in shape
select_tile.shapes = Counter()


def _entry():
    fn = _build.load("select_tile").select_tile_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn
