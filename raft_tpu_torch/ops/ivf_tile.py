"""K3: one-pass IVF-Flat probe scan, ``csrc/ivf_tile.cu``.

Port of ``raft_tpu/ops/ivf_tile.py:fused_ivf_scan``: per query, walk its
compacted scan list (``slots``, the valid-first -1-padded output of
``spatial/ann.py:_probe_compact``), compute the expanded squared L2
``max(qn + |v|^2 - 2 q.v, 0)`` to every row of each listed slot, mask
vacant rows (id < 0) and pad steps (slot < 0), and keep the k smallest,
k <= 128.  Ties resolve to the earlier scan position (step, then row).
Returns squared distances ascending and global int32 ids, (+inf, -1)
where fewer than k candidates exist.

``accum_bf16=True`` rounds the query and the slot vectors to bfloat16
as the kernel loads them and sums the products in float32; norms and
every select operation stay float32, as in JAX.  The JAX kernel casts a
padded copy of the whole store instead (``_pad_slot_store``); here the
store is read as it is, in place.  The JAX ``knn_tile_merge`` knob has
no counterpart (the warp top-k of ``csrc/warp_select.cuh`` is the one
selection core).

One block scans one query's whole list, so a batch of few queries fills
few SMs; the list is not split across blocks.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from raft_tpu_torch.core.error import expects
from raft_tpu_torch.ops import _build

MAX_K = 128


def _bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).to(torch.float32)


def fused_ivf_scan_plain(queries: torch.Tensor, slot_vecs: torch.Tensor,
                         slot_norms: torch.Tensor, slot_ids: torch.Tensor,
                         slots: torch.Tensor, k: int,
                         accum_bf16: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: per scan step, gather the slot of every
    query, take the expanded distances, mask, and keep the first k of a
    stable sort of the running top-k followed by the step (position
    order, so ties resolve as in the kernel)."""
    q = queries.to(torch.float32)
    qn = (q * q).sum(dim=1)
    if accum_bf16:
        q = _bf16(q)
    nq = q.shape[0]
    inf = float("inf")
    best_d = torch.full((nq, k), inf, dtype=torch.float32, device=q.device)
    best_i = torch.full((nq, k), -1, dtype=torch.int32, device=q.device)
    for j in range(slots.shape[1]):
        sl = slots[:, j].long()
        slx = torch.clamp(sl, min=0)
        vecs = slot_vecs[slx].to(torch.float32)               # (nq, cap, d)
        if accum_bf16:
            vecs = _bf16(vecs)
        dot = torch.bmm(vecs, q[:, :, None])[:, :, 0]
        dist = torch.clamp(qn[:, None] + slot_norms[slx] - 2.0 * dot, min=0.0)
        ids = slot_ids[slx]
        keep = (ids >= 0) & (sl >= 0)[:, None]
        dist = torch.where(keep, dist, inf)
        ids = torch.where(keep, ids, -1).to(torch.int32)
        best_d, pos = torch.sort(torch.cat([best_d, dist], dim=1), dim=1, stable=True)
        best_d = best_d[:, :k]
        best_i = torch.gather(torch.cat([best_i, ids], dim=1), 1, pos[:, :k])
    return best_d.contiguous(), best_i.contiguous()


def fused_ivf_scan(queries: torch.Tensor, slot_vecs: torch.Tensor,
                   slot_norms: torch.Tensor, slot_ids: torch.Tensor,
                   slots: torch.Tensor, k: int,
                   accum_bf16: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k nearest rows of each query's listed slots (module doc).

    queries (nq, d) float32; slot_vecs (S, cap, d) float32; slot_norms
    (S, cap) float32 squared norms; slot_ids (S, cap) int32, -1 vacant;
    slots (nq, n_steps) int32 slot indices, -1 padded.  Returns (nq, k)
    float32 ascending and (nq, k) int32.  A CUDA tensor launches the
    kernel; a CPU tensor takes :func:`fused_ivf_scan_plain`.
    """
    expects(queries.ndim == 2 and slot_vecs.ndim == 3
            and queries.shape[1] == slot_vecs.shape[2],
            "fused_ivf_scan: shape mismatch")
    expects(slots.ndim == 2 and slots.shape[0] == queries.shape[0],
            "fused_ivf_scan: slots must be (nq, n_steps)")
    nq, d = queries.shape
    S, cap, _ = slot_vecs.shape
    n_steps = slots.shape[1]
    expects(slot_norms.shape == (S, cap) and slot_ids.shape == (S, cap),
            "fused_ivf_scan: slot_norms and slot_ids must be (%d, %d)", S, cap)
    expects(n_steps > 0, "fused_ivf_scan: empty scan list")
    expects(0 < k <= MAX_K, "fused_ivf_scan: k <= %d (got %d)", MAX_K, k)
    expects(queries.dtype == torch.float32 and slot_vecs.dtype == torch.float32
            and slot_norms.dtype == torch.float32,
            "fused_ivf_scan: float32 queries, vectors and norms required")
    expects(slot_ids.dtype == torch.int32 and slots.dtype == torch.int32,
            "fused_ivf_scan: int32 ids and slots required")
    expects(n_steps * cap < 2**31, "fused_ivf_scan: scan positions overflow int32")
    dev = queries.device
    expects(all(t.device == dev for t in (slot_vecs, slot_norms, slot_ids, slots)),
            "fused_ivf_scan: inputs on different devices")
    if dev.type == "cpu":
        return fused_ivf_scan_plain(queries, slot_vecs, slot_norms, slot_ids, slots, k,
                                    accum_bf16)
    fn = _entry()
    if nq == 0:
        return (torch.empty((0, k), dtype=torch.float32, device=dev),
                torch.empty((0, k), dtype=torch.int32, device=dev))
    expects(d > 0 and cap > 0, "fused_ivf_scan: empty slots")
    queries = queries.contiguous()
    qn = (queries * queries).sum(dim=1)
    args = [t.contiguous() for t in (slot_vecs, slot_norms, slot_ids, slots)]
    out_d = torch.empty((nq, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((nq, k), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        code = fn(queries.data_ptr(), qn.data_ptr(), *[t.data_ptr() for t in args],
                  nq, d, cap, n_steps, k, int(bool(accum_bf16)),
                  out_d.data_ptr(), out_i.data_ptr(), stream)
    _build.check(code, "fused_ivf_scan")
    fused_ivf_scan.launches += 1
    return out_d, out_i


fused_ivf_scan.launches = 0


def _entry():
    fn = _build.load("ivf_tile").ivf_tile_launch
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_void_p] * 3
    fn.restype = ctypes.c_int
    return fn
