"""K3: the IVF-Flat probe scan, queries grouped by probed slot,
``csrc/ivf_tile.cu``.

Port of ``raft_tpu/ops/ivf_tile.py:fused_ivf_scan``: per query, walk its
compacted scan list (``slots``, the valid-first -1-padded output of
``spatial/ann.py:_probe_compact``), compute the expanded squared L2
``max(qn + |v|^2 - 2 q.v, 0)`` to every row of each listed slot, mask
vacant rows (id < 0) and pad steps (slot < 0), and keep the k smallest,
k <= 128.  Ties resolve to the earlier scan position (step, then row).
Returns squared distances ascending and global int32 ids, (+inf, -1)
where fewer than k candidates exist.

:func:`fused_ivf_scan` runs three steps, all on the tensors' device:

1. :func:`scan_work_list` inverts the scan lists with torch ops: the live
   (query, step) entries, stable-sorted by slot (queries ascending), cut
   into items of at most ``n_q`` entries of one slot (16 at the main
   path's depth: the kernel is bound by its selection, and sixteen
   entries keep each of its selection warps on one), with each entry's
   output row.  The item table is
   sized from the shapes and the count in use stays on the device, so
   the host never waits for the card.
2. :func:`ivf_items` runs the kernel over the items: each entry's top-k
   with global ids, in its own row of an (nq * n_steps, k) buffer
   prefilled with (+inf, -1).  A slot's rows are read once per item.
3. K2 (:func:`raft_tpu_torch.ops.select_tile.select_tile`) merges each
   query's n_steps * k columns and the ids are gathered.  The columns are
   step-major and K2 keeps the smaller column on ties, so ties resolve to
   the earlier step, then the smaller row.

The queries go through the three steps in chunks, so that the partial
buffers of a chunk, ``chunk * n_steps`` rows of k float32 distances and
k int32 ids, stay within :data:`PARTIAL_BUDGET_BYTES` (one query a chunk
at least; :func:`queries_per_chunk`).  A full probe of a 1M-row index in
1024 lists of up to 5 slots (1024 queries, 5,120 scan steps, k 100)
would otherwise hold 4.2 GB of partial rows.  Each entry's top-k depends on its own (query, slot) pair
alone and K2 works a row at a time, so the chunking changes no result.

On the CPU the same steps run with :func:`ivf_items_plain` in the
kernel's place (and K2's plain version), so the CPU tests hold the glue
that the card runs against the JAX package; :func:`fused_ivf_scan_plain`
is the plain version of the whole function.

``accum_bf16=True`` rounds the query and the slot vectors to bfloat16
(the kernel does it where it splits its operands) and sums the products
in float32; norms and every select operation stay float32, as in JAX.
``precision="default"`` is the same arithmetic (the TPU's single pass,
:func:`raft_tpu_torch.core.precision.matmul_bf16`) and takes the same
instance.
The JAX kernel casts a padded copy of the whole store instead
(``_pad_slot_store``); here the store is read in place, and copied only
where its depth is not a multiple of 8.  The JAX ``knn_tile_merge`` knob
has no counterpart (the warp top-k of ``csrc/warp_select.cuh`` is the one
selection core).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Tuple

import torch

from raft_tpu_torch.core import inventory, tracing
from raft_tpu_torch.core import precision as _precision
from raft_tpu_torch.core.error import expects
from raft_tpu_torch.core.utils import ceildiv
from raft_tpu_torch.ops import _build, cost
from raft_tpu_torch.ops.knn_tile import DEPTH_UNIT, pad_depth, prepare_rows
from raft_tpu_torch.ops.select_tile import select_tile

MAX_K = 128
# bytes of one chunk's partial buffers (module doc)
PARTIAL_BUDGET_BYTES = 256 << 20


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
        q = _precision.round_bf16(q)
    nq = q.shape[0]
    inf = float("inf")
    best_d = torch.full((nq, k), inf, dtype=torch.float32, device=q.device)
    best_i = torch.full((nq, k), -1, dtype=torch.int32, device=q.device)
    for j in range(slots.shape[1]):
        sl = slots[:, j].long()
        slx = torch.clamp(sl, min=0)
        vecs = slot_vecs[slx].to(torch.float32)               # (nq, cap, d)
        if accum_bf16:
            vecs = _precision.round_bf16(vecs)
        dot = _precision.bmm(vecs, q[:, :, None])[:, :, 0]
        dist = torch.clamp(qn[:, None] + slot_norms[slx] - 2.0 * dot, min=0.0)
        ids = slot_ids[slx]
        keep = (ids >= 0) & (sl >= 0)[:, None]
        dist = torch.where(keep, dist, inf)
        ids = torch.where(keep, ids, -1).to(torch.int32)
        best_d, pos = torch.sort(torch.cat([best_d, dist], dim=1), dim=1, stable=True)
        best_d = best_d[:, :k]
        best_i = torch.gather(torch.cat([best_i, ids], dim=1), 1, pos[:, :k])
    return best_d.contiguous(), best_i.contiguous()


class ScanWork(NamedTuple):
    """The work list of the scan lists, grouped by slot (module doc)."""
    items: torch.Tensor     # (max_items, 4) int32: first entry, entries, first store row, 0
    n_items: torch.Tensor   # (1,) int32: the items in use, the first n_items rows
    out_rows: torch.Tensor  # (nq * n_steps,) int32: each entry's output row, q * n_steps + step
    n_steps: int            # the scan steps of a query: an entry's query is out_row // n_steps
    n_q: int                # entries an item holds at most


def scan_work_list(slots: torch.Tensor, n_slots: int, cap: int, n_q: int) -> ScanWork:
    """Invert the scan lists ``slots`` (nq, n_steps) into items of at most
    ``n_q`` entries of one slot, with torch ops on the slots' device.

    The entries, in the order of a stable sort by slot of the flat
    (query, step) positions, are the live ones first (queries ascending
    within a slot), then the pad steps, which no item names.  Item ``i``
    holds entries ``[e0, e0 + count)`` of that order, all of slot ``s``,
    whose rows start at ``s * cap`` of the (n_slots * cap, d) store.  The
    table has a row for the most items the shapes allow,
    ``min(E, n_slots + E // n_q)`` with ``E = nq * n_steps``; only the
    first ``n_items`` are in use.  Few ops, all int32 where they can be:
    each costs host time that the card waits for.
    """
    nq, n_steps = slots.shape
    e_max = nq * n_steps
    n_max = max(1, min(e_max, n_slots + e_max // n_q))
    # a pad step (-1) sorts last: -1 mod (n_slots + 1) is n_slots
    key, order = torch.sort(slots.reshape(-1).remainder(n_slots + 1), stable=True)
    ramp = torch.arange(max(n_slots + 1, n_max), dtype=torch.int32, device=slots.device)
    # each slot's first entry; the last bound is the count of live entries
    bounds = torch.searchsorted(key, ramp[:n_slots + 1], out_int32=True)
    per_slot = (bounds[1:] - bounds[:-1] + (n_q - 1)).div(n_q, rounding_mode="floor")
    end = per_slot.cumsum(0, dtype=torch.int32)
    s = torch.searchsorted(end, ramp[:n_max], right=True, out_int32=True).clamp_(max=n_slots - 1)
    # item i of slot s starts at entry bounds[s] + (i - first item of s) n_q
    e0 = (bounds[:-1] - (end - per_slot) * n_q)[s] + ramp[:n_max] * n_q
    count = (bounds[1:][s] - e0).clamp_(0, n_q)
    items = torch.stack([e0, count, s * cap, torch.zeros_like(s)], dim=1)
    return ScanWork(items, end[-1:], order.to(torch.int32), n_steps, n_q)


def ivf_items_plain(queries: torch.Tensor, store: torch.Tensor, norms: torch.Tensor,
                    ids: torch.Tensor, work: ScanWork, cap: int, k: int, n_out: int,
                    accum_bf16: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the K3 kernel: for each item in use, the
    distances of its entries' queries to the ``cap`` rows of its slot
    (the products as :func:`fused_ivf_scan_plain` takes them), vacant
    rows masked, and each entry's first k of a stable sort, with global
    ids, in its output row of an (n_out, k) buffer of (+inf, -1)."""
    q = queries.to(torch.float32)
    qn = (q * q).sum(dim=1)
    if accum_bf16:
        q = _precision.round_bf16(q)
    inf = float("inf")
    out_d = torch.full((n_out, k), inf, dtype=torch.float32, device=q.device)
    out_i = torch.full((n_out, k), -1, dtype=torch.int32, device=q.device)
    kk = min(k, cap)
    for e0, count, row0, _ in work.items[:int(work.n_items)].tolist():
        rows = work.out_rows[e0:e0 + count].long()
        qr = rows // work.n_steps
        vecs = store[row0:row0 + cap].to(torch.float32)
        if accum_bf16:
            vecs = _precision.round_bf16(vecs)
        dot = _precision.bmm(vecs.expand(count, cap, -1).contiguous(), q[qr][:, :, None])[:, :, 0]
        dist = torch.clamp(qn[qr][:, None] + norms[row0:row0 + cap] - 2.0 * dot, min=0.0)
        gid = ids[row0:row0 + cap]
        vals, pos = torch.sort(torch.where(gid >= 0, dist, inf), dim=1, stable=True)
        vals, pos = vals[:, :kk], pos[:, :kk]
        fin = vals < inf
        out_d[rows, :kk] = torch.where(fin, vals, inf)
        out_i[rows, :kk] = torch.where(fin, gid[pos], -1).to(torch.int32)
    return out_d, out_i


def ivf_items(queries: torch.Tensor, store: torch.Tensor, norms: torch.Tensor,
              ids: torch.Tensor, work: ScanWork, cap: int, k: int, n_out: int,
              accum_bf16: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """The K3 kernel over the work list: queries (nq, d) float32, the slot
    store flat (store (S * cap, d) float32, norms (S * cap,) float32, ids
    (S * cap,) int32, -1 vacant).  Returns the (n_out, k) float32 and
    int32 buffer of each entry's top-k (+inf, -1 in rows no entry names).
    A CUDA tensor launches ``csrc/ivf_tile.cu``; a CPU tensor takes
    :func:`ivf_items_plain`."""
    if queries.device.type == "cpu":
        return ivf_items_plain(queries, store, norms, ids, work, cap, k, n_out, accum_bf16)
    _build.load("ivf_tile")     # built or loaded before any work on the device
    dev = queries.device
    q, qn = prepare_rows(queries)
    dp = q.shape[1]
    x = pad_depth(store.contiguous(), dp)
    args = [t.contiguous() for t in (norms, ids, work.items, work.n_items, work.out_rows)]
    out_d = torch.full((n_out, k), float("inf"), dtype=torch.float32, device=dev)
    out_i = torch.full((n_out, k), -1, dtype=torch.int32, device=dev)
    _build.launch("ivf_tile", dev, (q, qn, x, *args, q.shape[0], work.n_steps, x.shape[0], dp,
                                    cap, work.items.shape[0], work.n_q, k, int(bool(accum_bf16)),
                                    out_d, out_i),
                  "ivf_items", (q.shape[0], n_out, x.shape[0], dp, cap, k, bool(accum_bf16)),
                  lambda: (*item_cost(ids, work, cap, queries.shape[0], queries.shape[1], k,
                                      n_out),
                           inventory.footprint((q, qn, x, *args), (out_d, out_i))))
    return out_d, out_i


def item_cost(ids: torch.Tensor, work: ScanWork, cap: int, nq: int, d: int, k: int,
              n_entries: int) -> Tuple[float, float]:
    """:func:`raft_tpu_torch.ops.cost.ivf_scan_cost` of a work list: each
    item's entries scan the stored rows of its slot, and the distinct
    slots' rows are read once.  Reads the item count from the device."""
    items = work.items[:int(work.n_items)].long()
    stored = (ids.view(-1, cap) >= 0).sum(dim=1)
    slot = items[:, 2] // cap
    rows_scanned = int((items[:, 1] * stored[slot]).sum())
    rows_distinct = int(stored[torch.unique(slot)].sum())
    return cost.ivf_scan_cost(nq, d, k, n_entries, rows_scanned, rows_distinct)


def item_queries(d: int, device: torch.device) -> int:
    """Entries an item holds at depth ``d``: the kernel's choice
    (``csrc/ivf_tile.cu:ivf_block_q``) on the card, and on the CPU the
    card's choice at the main path's depth, 16."""
    if device.type == "cpu":
        return 16
    fn = _build.entry("ivf_tile", "ivf_block_q", [ctypes.c_int], ctypes.c_int)
    return fn(ceildiv(d, DEPTH_UNIT) * DEPTH_UNIT)


def queries_per_chunk(n_steps: int, k: int, n_q: int) -> int:
    """Queries a chunk of :func:`fused_ivf_scan` takes: as many as the
    budget holds, rounded down to a multiple of the item width ``n_q``
    where it holds that many (a chunk of 65 queries that all probe a slot
    would cut it into four full items and one of a single entry, each
    reading the slot's rows), and one at least."""
    chunk = max(1, PARTIAL_BUDGET_BYTES // (n_steps * k * 8))
    return chunk - chunk % n_q if chunk >= n_q else chunk


def fused_ivf_scan(queries: torch.Tensor, slot_vecs: torch.Tensor,
                   slot_norms: torch.Tensor, slot_ids: torch.Tensor,
                   slots: torch.Tensor, k: int, accum_bf16: bool = False,
                   precision: str = "highest") -> Tuple[torch.Tensor, torch.Tensor]:
    """The k nearest rows of each query's listed slots (module doc).

    queries (nq, d) float32; slot_vecs (S, cap, d) float32; slot_norms
    (S, cap) float32 squared norms; slot_ids (S, cap) int32, -1 vacant;
    slots (nq, n_steps) int32 slot indices, -1 padded.  ``precision=
    "default"`` is ``accum_bf16=True`` (module doc).  Returns (nq, k)
    float32 ascending and (nq, k) int32.  CUDA tensors launch the kernel
    and K2; CPU tensors take their plain versions.
    """
    expects(precision in _precision.PRECISIONS, "precision must be one of %s, got %r",
            _precision.PRECISIONS, precision)
    accum_bf16 = bool(accum_bf16) or precision == "default"
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
    expects(S * cap < 2**31 and nq * n_steps < 2**31,
            "fused_ivf_scan: store rows or scan entries overflow int32")
    dev = queries.device
    expects(all(t.device == dev for t in (slot_vecs, slot_norms, slot_ids, slots)),
            "fused_ivf_scan: inputs on different devices")
    n_q = item_queries(d, dev)
    if nq == 0:
        return (torch.empty((0, k), dtype=torch.float32, device=dev),
                torch.empty((0, k), dtype=torch.int32, device=dev))
    expects(d > 0 and cap > 0, "fused_ivf_scan: empty slots")
    store = (slot_vecs.reshape(S * cap, d), slot_norms.reshape(-1), slot_ids.reshape(-1))
    chunk = queries_per_chunk(n_steps, k, n_q)
    if chunk >= nq:
        return _scan_chunk(queries, store, slots, cap, k, n_q, accum_bf16)
    out_d = torch.empty((nq, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((nq, k), dtype=torch.int32, device=dev)
    for q0 in range(0, nq, chunk):
        out_d[q0:q0 + chunk], out_i[q0:q0 + chunk] = _scan_chunk(
            queries[q0:q0 + chunk], store, slots[q0:q0 + chunk], cap, k, n_q, accum_bf16)
    return out_d, out_i


def _scan_chunk(queries, store, slots, cap, k, n_q, accum_bf16):
    """The three steps of :func:`fused_ivf_scan` for one chunk of queries."""
    nq, n_steps = slots.shape
    # one profiler range a step, so that a trace splits the function's time
    with tracing.annotate("fused_ivf_scan.work_list"):
        work = scan_work_list(slots, store[0].shape[0] // cap, cap, n_q)
    with tracing.annotate("fused_ivf_scan.kernel"):
        part_d, part_i = ivf_items(queries, *store, work, cap, k, nq * n_steps, accum_bf16)
    with tracing.annotate("fused_ivf_scan.merge"):
        out_d, pos = select_tile(part_d.view(nq, n_steps * k), k)
        return out_d, torch.gather(part_i.view(nq, n_steps * k), 1, pos.long())
