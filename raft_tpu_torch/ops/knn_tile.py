"""K1: fused squared-L2 distance + top-k, ``csrc/knn_tile.cu``.

Port of ``raft_tpu/ops/knn_tile.py:fused_knn_tile``: per query, the k
smallest of ``max(qn + xn - 2 q.x, 0)`` over the index rows, ascending,
with int32 ids, k <= 128, float32 inputs, distances in full float32
(the JAX ``precision="highest"`` contract).  Ties resolve to the smaller
id.

The kernel splits the index across blocks as well as the queries, so
that a thousand queries fill the card; each split writes its own top-k
and the select kernel (:mod:`raft_tpu_torch.ops.select_tile`) merges the
partials.  Because the partials are laid out split by split, a tie on
distance between splits resolves to the smaller split, which holds the
smaller ids: the merged result is the same as one pass.  The norms are
computed here with torch ops, as ``pad_with_norms`` computes them
outside the Pallas call.

The JAX ``knn_tile_merge`` knob (``merge``/``fullsort``/``sorttile``/
``skip``) picks between lane-network variants of the TPU's 128-lane
vector unit and has no counterpart: a warp's shuffle network is the one
selection core (``csrc/warp_select.cuh``).  Block shapes are constants
chosen for Hopper, not registry knobs.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from raft_tpu_torch.core.error import expects
from raft_tpu_torch.core.utils import ceildiv
from raft_tpu_torch.ops import _build
from raft_tpu_torch.ops.select_tile import select_tile

MAX_K = 128
BLOCK_Q = 64      # queries per block (csrc/knn_tile.cu kBQ)
BLOCK_N = 128     # index rows per tile (kBN)
BLOCKS_PER_SM = 4  # split the index until the grid has this many blocks per SM

# index rows per tile of the plain version
_PLAIN_TILE = 8192


def knn_tile_plain(index: torch.Tensor, queries: torch.Tensor,
                   k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: the same distances in expanded form (one
    matmul per index tile) and the same (distance, id) order, kept by a
    stable sort of the running top-k followed by the tile."""
    index = index.to(torch.float32)
    queries = queries.to(torch.float32)
    n = index.shape[0]
    nq = queries.shape[0]
    qn = (queries * queries).sum(dim=1, keepdim=True)
    best_d = queries.new_empty((nq, 0))
    best_i = torch.empty((nq, 0), dtype=torch.int64, device=queries.device)
    for j0 in range(0, n, _PLAIN_TILE):
        x = index[j0:j0 + _PLAIN_TILE]
        xn = (x * x).sum(dim=1)
        d = torch.clamp(qn + xn[None, :] - 2.0 * (queries @ x.T), min=0.0)
        ids = torch.arange(j0, j0 + x.shape[0], device=queries.device)
        cat_d = torch.cat([best_d, d], dim=1)
        cat_i = torch.cat([best_i, ids.expand(nq, -1)], dim=1)
        best_d, pos = torch.sort(cat_d, dim=1, stable=True)
        best_d = best_d[:, :k]
        best_i = torch.gather(cat_i, 1, pos[:, :k])
    return best_d.contiguous(), best_i.to(torch.int32)


def split_rows(nq: int, n: int, n_sms: int) -> int:
    """Index rows per split: enough splits for ``BLOCKS_PER_SM`` blocks on
    every SM, each a whole number of tiles."""
    n_tiles = ceildiv(n, BLOCK_N)
    splits = min(n_tiles, max(1, ceildiv(BLOCKS_PER_SM * n_sms, ceildiv(nq, BLOCK_Q))))
    return ceildiv(n_tiles, splits) * BLOCK_N


def fused_knn_tile(index: torch.Tensor, queries: torch.Tensor,
                   k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """k nearest index rows per query under squared L2.

    index (n, d) and queries (nq, d) float32; returns (nq, k) float32
    ascending and (nq, k) int32.  CUDA tensors launch the kernel (and the
    select kernel to merge the splits); CPU tensors take
    :func:`knn_tile_plain`.
    """
    expects(index.ndim == 2 and queries.ndim == 2
            and index.shape[1] == queries.shape[1],
            "fused_knn_tile: shape mismatch")
    n, d = index.shape
    nq = queries.shape[0]
    expects(0 < k <= n, "fused_knn_tile: k=%d out of range for n=%d", k, n)
    expects(k <= MAX_K, "fused_knn_tile: k <= %d (got %d)", MAX_K, k)
    expects(index.dtype == torch.float32 and queries.dtype == torch.float32,
            "fused_knn_tile: float32 inputs required, got %s and %s",
            index.dtype, queries.dtype)
    expects(index.device == queries.device,
            "fused_knn_tile: index and queries on different devices")
    if index.device.type == "cpu":
        return knn_tile_plain(index, queries, k)
    fn = _entry()
    dev = index.device
    if nq == 0:
        return (torch.empty((0, k), dtype=torch.float32, device=dev),
                torch.empty((0, k), dtype=torch.int32, device=dev))
    expects(d > 0, "fused_knn_tile: zero depth")
    index = index.contiguous()
    queries = queries.contiguous()
    qn = (queries * queries).sum(dim=1)
    xn = (index * index).sum(dim=1)
    rows = split_rows(nq, n, torch.cuda.get_device_properties(dev).multi_processor_count)
    splits = ceildiv(n, rows)
    part_d = torch.empty((nq, splits * k), dtype=torch.float32, device=dev)
    part_i = torch.empty((nq, splits * k), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        code = fn(queries.data_ptr(), index.data_ptr(), qn.data_ptr(),
                  xn.data_ptr(), nq, n, d, k, rows, part_d.data_ptr(),
                  part_i.data_ptr(), stream)
    _build.check(code, "fused_knn_tile")
    fused_knn_tile.launches += 1
    if splits == 1:
        return part_d, part_i
    out_d, pos = select_tile(part_d, k)
    return out_d, torch.gather(part_i, 1, pos.long())


fused_knn_tile.launches = 0


def _entry():
    fn = _build.load("knn_tile").knn_tile_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 3
    fn.restype = ctypes.c_int
    return fn
