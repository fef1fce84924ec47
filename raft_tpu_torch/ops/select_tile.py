"""K2: per-row selection of the k smallest keys, ``csrc/select_tile.cu``.

Port of ``raft_tpu/ops/select_tile.py:select_tile``: per row of an
(m, w) float key matrix, the k smallest keys ascending and their int32
column ids, k <= 128.

The contract, the same for the kernel and its plain version: the result
is the first k of a stable ascending sort of the row in which -0.0 equals
+0.0 and NaN is greater than every other key, so ties resolve to the
smaller column.  +inf keys are keys like any other, with their own ids.
A NaN key is never returned: where a row has fewer than k keys that are
not NaN, the remaining slots are ``(+inf, w - 1)``.  (The JAX kernel, run
in interpret mode, returns NaN with id 0 in every slot of a row that
holds a NaN; the port does not follow it there.)

The kernel is a radix select (``csrc/select_tile.cu``).  A row of up to
``HELD_MAX`` keys is held by one block; a wider row goes through three
kernels: a bound from a sample of the row, a filter over (row, chunk)
blocks (:func:`wide_chunks` of them a row) that keeps the keys at or
below it, and a select from what was kept (from the whole row where the
sample misled).  The JAX knob ``knn_tile_merge``
(``merge``/``fullsort``/``sorttile``/``skip``) picks between lane-network
variants of the TPU's 128-lane vector unit and has no counterpart here.
"""

from __future__ import annotations

import ctypes
import functools
from collections import Counter
from typing import Tuple

import torch

from raft_tpu_torch.core import inventory
from raft_tpu_torch.core.error import expects
from raft_tpu_torch.ops import _build, cost

MAX_K = 128
# csrc/select_tile.cu: the widest row one block holds, the least keys a
# block of the wide filter streams, and the blocks an SM it aims at
HELD_MAX = 8192
CHUNK_MIN = 1024
FILL_BLOCKS = 2


def order_keys(keys: torch.Tensor) -> torch.Tensor:
    """int64 keys whose ascending order is the contract's order of the
    float32 ``keys``: the kernel's unsigned image of a float (the sign
    bit flipped for a positive key, every bit for a negative one), with
    -0.0 taken as +0.0 and every NaN above +inf."""
    bits = keys.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    bits = torch.where(keys == 0, torch.zeros_like(bits), bits)
    img = torch.where(bits >= 2**31, 0xFFFFFFFF - bits, bits + 2**31)
    return torch.where(torch.isnan(keys), torch.full_like(img, 0xFFFFFFFF), img)


def select_tile_plain(keys: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: the first k of a stable sort in the
    contract's order (module doc), NaN slots made ``(+inf, w - 1)``."""
    keys = keys.to(torch.float32)
    w = keys.shape[1]
    _, idx = torch.sort(order_keys(keys), dim=1, stable=True)
    idx = idx[:, :k]
    vals = torch.gather(keys, 1, idx)
    nan = torch.isnan(vals)
    vals = torch.where(nan, torch.full_like(vals, float("inf")), vals)
    idx = torch.where(nan, torch.full_like(idx, w - 1), idx)
    return vals.contiguous(), idx.to(torch.int32)


def wide_chunks(m: int, w: int, n_sms: int) -> int:
    """Blocks a row of the wide filter for (m, w) on ``n_sms`` SMs, as
    ``select_tile_plan`` in ``csrc/select_tile.cu`` decides them: one,
    unless m rows give the card fewer than ``FILL_BLOCKS`` blocks an SM,
    then up to that many, of ``CHUNK_MIN`` keys at least; 0 where one
    block holds a row (w <= ``HELD_MAX``).  Chunk c covers columns
    ``[c * w // chunks, (c + 1) * w // chunks)``."""
    if w <= HELD_MAX:
        return 0
    fill = -(-FILL_BLOCKS * n_sms // m)
    return max(1, min(fill, -(-w // CHUNK_MIN)))


def select_tile(keys: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k smallest keys per row and their column ids (module doc).

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
    launch = _build.entry("select_tile", "select_tile_launch",
                          [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int]
                          + [ctypes.c_void_p] * 4, ctypes.c_int)
    keys = keys.to(torch.float32).contiguous()
    out_k = torch.empty((m, k), dtype=torch.float32, device=keys.device)
    out_i = torch.empty((m, k), dtype=torch.int32, device=keys.device)
    if m == 0:
        return out_k, out_i
    with torch.cuda.device(keys.device):
        # the wide route's bounds, counts and candidates
        scratch = torch.empty(_scratch_bytes(keys.device.index, m, w, k), dtype=torch.uint8,
                              device=keys.device)
        stream = torch.cuda.current_stream().cuda_stream
        code = launch(keys.data_ptr(), m, w, k, out_k.data_ptr(), out_i.data_ptr(),
                      scratch.data_ptr(), stream)
    _build.check(code, "select_tile")
    select_tile.launches += 1
    select_tile.shapes[(m, w, k)] += 1
    inventory.count_launch("select_tile", (m, w, k), lambda: (
        *cost.select_cost(m, w, k), inventory.footprint((keys,), (out_k, out_i), scratch.numel())))
    return out_k, out_i


select_tile.launches = 0
# launches by (rows, width, k): the merges and probes of a path differ in shape
select_tile.shapes = Counter()


def plan(m: int, w: int, k: int) -> int:
    """The wide filter's blocks a row that the kernel takes for (m, w, k)
    on the current device, 0 for the held route (``select_tile_plan``);
    builds the kernel library if needed."""
    fn = _build.entry("select_tile", "select_tile_plan", [ctypes.c_int] * 3, ctypes.c_int)
    chunks = fn(m, w, k)
    expects(chunks >= 0, "select_tile_plan: (m=%d, w=%d, k=%d) refused", m, w, k)
    return chunks


@functools.lru_cache(maxsize=4096)
def _scratch_bytes(device_index: int, m: int, w: int, k: int) -> int:
    """Bytes of scratch the kernel takes for (m, w, k) on the device
    (``select_tile_scratch``), asked once per shape."""
    fn = _build.entry("select_tile", "select_tile_scratch", [ctypes.c_int] * 3,
                      ctypes.c_longlong)
    return fn(m, w, k)
