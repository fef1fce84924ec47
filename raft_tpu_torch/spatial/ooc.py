"""Out-of-core IVF-Flat search: a host-resident slot store, streamed scans.

Port of ``raft_tpu/spatial/ooc.py``.  Every search of
:mod:`raft_tpu_torch.spatial.ann` keeps the whole slot store on the
device; this module is the arm for indexes **bigger than the device's
budget**.  The split:

- **device metadata** (small: O(n_slots * cap) ints and floats): the
  centroids, ``cent_slots``, ``slot_ids``, ``slot_norms``, everything the
  probe and the candidates' bookkeeping need;
- **host vectors**: the ``(n_slots, cap, d)`` slot store, nearly all of
  the index's bytes, stays a numpy array;
- **a device working set**: a fixed *hot set* of frequency-promoted slots
  (owned by the caller, typically :class:`raft_tpu_torch.serve.ANNService`)
  and a :class:`~raft_tpu_torch.mr.tile_pool.TilePool` budget that the
  cold slots stream through.

:func:`ooc_ivf_flat_search`, a batch at a time:

1. probe on the device exactly as the resident search does
   (``spatial/ann.py:_probe_compact``), then one host read of the
   per-query probed slots (a few KB, the one device-to-host sync);
2. split the distinct probed slots into hot hits and cold misses
   (``raft_tpu_tile_{hits,misses}_total``, ``probe_hook``);
3. scan the hot set;
4. stream the cold slots through the pool in fixed-size tiles, **double
   buffered**: tile N + 1's transfer is issued right after tile N's scan
   is launched, so the copy overlaps the scan (``overlap=False`` is the
   synchronous arm the overlap is measured against); a tile staged and
   not taken when a scan fails is discarded;
5. merge each part's top-k into the running top-k with ``select_k`` (K2);
   then the sqrt of the L2Sqrt metrics, and the delta segment merges
   after (``spatial/ann.py:_merge_delta``), unchanged.

**Identity.**  A part (the hot set or one staged tile) is scanned with
the resident search's arithmetic on each route, so every probed (query,
row) distance equals the resident one bit for bit and each pair is
scanned once:

- ``scan_impl="kernel"`` (the default on CUDA for float32, k <= 128 and
  the L2 metrics, as the resident search): the part's slot ids map to
  positions in the part (pad entries and slots outside it read -1), each
  query's positions are compacted valid first, and K3
  (:func:`~raft_tpu_torch.ops.ivf_tile.fused_ivf_scan`) scans the part
  with the part's rows of ``slot_norms`` and ``slot_ids``.  K3's distance
  of a pair depends on the pair alone.
- ``scan_impl="scan"`` and every CPU call: the resident step scan's step
  (a ``precision.bmm`` of the gathered slot block), a step per position.

Either way each candidate carries an order key, its scan step and its
row in the slot, and the running top-k merges on K2 with the columns in
key order, so that ties at a distance resolve as the resident search
resolves them (to the earlier step, then the smaller row).  On the card
the expanded distances of a batch are quantised to the float32 spacing
of the norms, and exact ties are common.  So the distances equal the
resident search's bit for bit and so do the ids, in the same order: the
JAX package promises the ids only up to ties at the k-th place.  A part
that no query probes is skipped.

Unlike the JAX package, nothing here is compiled per shape, so
``force_rounds`` (warmup) streams empty tiles through the pool without
scanning them.  ``select_impl`` pins the route of the probe select and
of every merge (``"kernel"``, K2, or ``"sort"``; None resolves the knob
at each selection), as in the resident search.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from raft_tpu_torch.core import precision
from raft_tpu_torch.core.device import as_tensor, resolve_device
from raft_tpu_torch.core.error import expects
from raft_tpu_torch.core.profiler import default_profiler
from raft_tpu_torch.distance.distance_type import DistanceType
from raft_tpu_torch.mr.tile_pool import TilePool, _pool_counter
from raft_tpu_torch.ops.ivf_tile import fused_ivf_scan
from raft_tpu_torch.spatial.ann import (_SQRT_METRICS, IVFFlatIndex, _assign_labels,
                                        _extend_slot_layout, _merge_delta, _probe_compact,
                                        _validate_nprobe, _resolve_scan_impl)
from raft_tpu_torch.spatial.select_k import select_k

__all__ = ["OocIVFFlat", "ivf_flat_to_ooc", "ooc_ivf_flat_search", "ooc_extend",
           "ooc_reconstruct", "materialize_hot"]


class OocIVFFlat(NamedTuple):
    """IVF-Flat index with its slot store on the HOST (module doc).

    Immutable like :class:`~raft_tpu_torch.spatial.ann.IVFFlatIndex`: a
    compaction builds a new one, and searches in flight keep gathering
    from the old ``store``."""

    centroids: torch.Tensor      # (nlist, d) device
    slot_ids: torch.Tensor       # (n_slots, cap) int32 device, -1 pad
    slot_norms: torch.Tensor     # (n_slots, cap) float32 device
    cent_slots: torch.Tensor     # (nlist, max_slots) int32 device
    slot_centroid: np.ndarray    # (n_slots,) int32 HOST (extend, promotion)
    list_sizes: torch.Tensor     # (nlist,) int32 device
    metric: DistanceType
    nprobe: int
    store: np.ndarray            # (n_slots, cap, d) HOST: the bulk

    @property
    def n_slots(self) -> int:
        return int(self.store.shape[0])

    @property
    def cap(self) -> int:
        return int(self.store.shape[1])

    def slot_bytes(self) -> int:
        """Device bytes one resident slot of vectors costs."""
        return self.cap * int(self.store.shape[2]) * self.store.dtype.itemsize

    def store_bytes(self) -> int:
        """Bytes of the host store: what a device budget is set against."""
        return int(self.store.nbytes)


def ivf_flat_to_ooc(index: IVFFlatIndex) -> OocIVFFlat:
    """Demote a resident :class:`IVFFlatIndex` to the out-of-core form: the
    slot vectors are copied to a host numpy store (dropping the caller's
    reference to ``index`` then frees the device copy); the metadata stays
    on the index's device."""
    expects(isinstance(index, IVFFlatIndex), "ivf_flat_to_ooc: expected IVFFlatIndex, got %r",
            type(index).__name__)
    store = index.slot_vecs.detach().to("cpu", copy=True).numpy()
    norms = index.slot_norms
    if norms is None:
        norms = (index.slot_vecs * index.slot_vecs).sum(dim=-1)
    slot_centroid = index.slot_centroid.cpu().numpy().astype(np.int32)
    return OocIVFFlat(index.centroids, index.slot_ids, norms, index.cent_slots, slot_centroid,
                      index.list_sizes, index.metric, index.nprobe, store)


# --------------------------------------------------------------------- #
# scanning one part
# --------------------------------------------------------------------- #
# the order key of an empty entry of the running top-k: after every real one
_NO_KEY = 2**31 - 1


def _part_positions(slots, part_ids, n_slots, n_live):
    """The part's positions of each query's probed slots, valid first and
    cut to ``n_live`` columns, and the scan steps they come from (their
    columns of ``slots``), both int32, -1 where absent.  Pad entries of
    the part (-1) land in the overflow cell ``n_slots``, which is then
    forced back to -1, as are the invalid probed entries that look up
    through it."""
    dev = slots.device
    pos = torch.full((n_slots + 1,), -1, dtype=torch.int32, device=dev)
    pos[torch.where(part_ids >= 0, part_ids, n_slots).long()] = torch.arange(
        part_ids.shape[0], dtype=torch.int32, device=dev)
    pos[n_slots] = -1
    sp = pos[torch.where(slots >= 0, slots, n_slots).long()]
    # stable: the probe order among the entries this part holds is kept
    _, order = torch.sort((sp < 0).to(torch.int32), dim=1, stable=True)
    order = order[:, :n_live]
    sp = torch.gather(sp, 1, order)
    return sp, torch.where(sp >= 0, order.to(torch.int32), -1)


def _merge(run, d, i, key, k, select_impl=None):
    """Fold candidates (distances, ids, order keys) into the running top-k
    (distances, ids, keys).  The columns go in key order, so that K2's
    ties (to the smaller column) resolve by key."""
    cd, ci, ck = (torch.cat(pair, dim=1) for pair in zip(run, (d, i, key)))
    ck, order = torch.sort(ck, dim=1, stable=True)
    out_d, pos = select_k(torch.gather(cd, 1, order), k, select_min=True, impl=select_impl,
                          device=cd.device)
    pos = pos.long()
    return out_d, torch.gather(torch.gather(ci, 1, order), 1, pos), torch.gather(ck, 1, pos)


def _scan_part(q, qn, part_vecs, part_ids, ooc_dev, slots, n_live, run, k, route,
               select_impl=None):
    """Fold one device-resident part into the running top-k ``run``
    (distances, ids, order keys; module doc, "Identity").

    A candidate's order key is ``step * cap + row``: its scan step (its
    column of the query's probed slots) and its row in the slot.  Ties at
    a distance resolve to the smaller key, the order in which the
    resident search's kernel and step scan resolve them, so the survivors
    and their order are the resident search's."""
    slot_ids, slot_norms = ooc_dev
    cap = slot_ids.shape[1]
    sp, steps = _part_positions(slots, part_ids, slot_ids.shape[0], n_live)
    if route != "scan":
        S = part_ids.shape[0]
        rows = torch.clamp(part_ids, min=0).long()
        part_slot_ids = torch.where((part_ids >= 0)[:, None], slot_ids[rows], -1)
        # K3 carries each row's place in the part as its payload (the
        # kernel orders ties by position and row, never by payload)
        local = torch.arange(S * cap, dtype=torch.int32, device=q.device).view(S, cap)
        d, loc = fused_ivf_scan(q, part_vecs, slot_norms[rows].to(torch.float32),
                                torch.where(part_slot_ids >= 0, local, -1), sp, k,
                                accum_bf16=route == "kernel_bf16")
        valid = loc >= 0
        locl = torch.clamp(loc, min=0).long()
        ids = torch.where(valid, part_slot_ids.reshape(-1)[locl], -1)
        # each query's scan step of each part slot
        step_of = torch.zeros((q.shape[0], S + 1), dtype=torch.int32, device=q.device)
        step_of.scatter_(1, torch.where(sp >= 0, sp, S).long(), steps)
        key = torch.gather(step_of, 1, torch.div(locl, cap, rounding_mode="floor")) * cap + (
            locl % cap).to(torch.int32)
        return _merge(run, d, ids, torch.where(valid, key, _NO_KEY), k, select_impl)
    row = torch.arange(cap, dtype=torch.int32, device=q.device)
    for j in range(n_live):
        valid = sp[:, j] >= 0
        spx = torch.where(valid, sp[:, j], 0).long()
        slx = torch.where(valid, torch.gather(slots, 1, torch.clamp(steps[:, j:j + 1], min=0)
                                              .long())[:, 0], 0).long()
        vecs = part_vecs[spx]                                    # (nq, cap, d)
        # the resident step scan's step (spatial/ann.py:_ivf_flat_search_impl)
        dot = precision.bmm(vecs, q[:, :, None].to(vecs.dtype))[:, :, 0]
        dist = qn[:, None] + slot_norms[slx] - 2.0 * dot
        ids = torch.where(valid[:, None], slot_ids[slx], -1)
        dist = torch.where(ids >= 0, torch.clamp(dist, min=0.0), float("inf")).to(run[0].dtype)
        key = torch.where(ids >= 0, steps[:, j:j + 1] * cap + row, _NO_KEY)
        run = _merge(run, dist, ids, key, k, select_impl)
    return run


def _compute_idle(dev) -> bool:
    """Whether the scans launched so far have finished (the ``busy`` of
    :meth:`TilePool.take` is its negation): an event recorded on the
    compute stream after the last launch, queried."""
    if dev.type != "cuda":
        return True
    ev = torch.cuda.Event()
    ev.record(torch.cuda.current_stream(dev))
    return ev.query()


# --------------------------------------------------------------------- #
# search driver
# --------------------------------------------------------------------- #
def ooc_ivf_flat_search(ooc: OocIVFFlat, queries, k: int, nprobe: Optional[int] = None, *,
                        pool: TilePool, hot: Optional[Tuple] = None, delta=None,
                        overlap: bool = True, probe_hook=None, force_rounds: int = 0,
                        scan_impl: Optional[str] = None, select_impl: Optional[str] = None,
                        device="cuda") -> Tuple[torch.Tensor, torch.Tensor]:
    """Search the out-of-core index (module doc).

    ``hot`` is ``(hot_vecs (H, cap, d), hot_ids (H,) int32, hot_mask
    (n_slots,) bool numpy)`` on ``device`` (see :func:`materialize_hot`)
    or None (everything streams).  ``overlap=False`` is the synchronous
    arm: the running scans are drained, then each tile is transferred,
    then scanned.  ``probe_hook(distinct_slots, query_counts)`` feeds the
    caller's promotion counters.  ``force_rounds`` pads the tile loop with
    empty tiles (warmup).  ``scan_impl`` is ``"kernel"``,
    ``"kernel_bf16"``, ``"scan"`` or None, as for
    :func:`~raft_tpu_torch.spatial.ann.ivf_flat_search`.  ``delta=(vectors,
    ids)`` merges an append-only segment.  Returns (n_queries, k)
    distances and int32 ids, best-first.
    """
    dev = resolve_device(device)
    q = as_tensor(queries, dev)
    centroids = as_tensor(ooc.centroids, dev)
    expects(q.ndim == 2 and q.shape[1] == centroids.shape[1],
            "ooc_ivf_flat_search: expected (n_queries, %d) queries, got %r",
            int(centroids.shape[1]), tuple(q.shape))
    nprobe = _validate_nprobe("ooc_ivf_flat_search", ooc.nprobe if nprobe is None else nprobe,
                              int(centroids.shape[0]))
    metric = DistanceType(int(ooc.metric))
    route = _resolve_scan_impl(scan_impl, site="ooc_ivf_flat_search", q=q,
                              store_dtype=torch.from_numpy(np.empty(0, ooc.store.dtype)).dtype,
                              n=ooc.slot_ids.shape[0] * ooc.slot_ids.shape[1], k=k,
                              metric=metric)
    ooc_dev = (as_tensor(ooc.slot_ids, dev), as_tensor(ooc.slot_norms, dev))
    slots, _ = _probe_compact(q, centroids, as_tensor(ooc.cent_slots, dev), nprobe,
                              select_impl=select_impl)
    # the one device-to-host read: each query's probed slots
    slots_np = slots.cpu().numpy()
    distinct, dcounts = np.unique(slots_np[slots_np >= 0], return_counts=True)
    if hot is not None and hot[0].shape[0]:
        hot_mask = hot[2]
        cold = distinct[~hot_mask[distinct]]
    else:
        hot, hot_mask = None, None
        cold = distinct
    hits = int(distinct.size - cold.size)
    if hits:
        _pool_counter("raft_tpu_tile_hits_total",
                      "probed slots served from the device-resident hot set",
                      pool.name).inc(hits)
    if cold.size:
        _pool_counter("raft_tpu_tile_misses_total", "probed slots streamed from the host store",
                      pool.name).inc(int(cold.size))
    if probe_hook is not None:
        probe_hook(distinct, dcounts)

    T = pool.tile_slots
    chunks = [cold[i:i + T] for i in range(0, int(cold.size), T)]
    while len(chunks) < force_rounds:
        chunks.append(np.empty(0, np.int64))

    def live(mask):
        # the most probed entries of any query that the part holds
        return int(mask.sum(axis=1).max()) if mask.size else 0

    nq = q.shape[0]
    dt = torch.promote_types(q.dtype, torch.float32)
    run = (torch.full((nq, k), float("inf"), dtype=dt, device=dev),
           torch.full((nq, k), -1, dtype=torch.int32, device=dev),
           torch.full((nq, k), _NO_KEY, dtype=torch.int32, device=dev))
    qn = (q * q).sum(dim=1)
    with default_profiler().span("ooc.scan", layer="ooc"):
        if hot is not None:
            n_live = live(hot_mask[np.clip(slots_np, 0, None)] & (slots_np >= 0))
            if n_live:
                run = _scan_part(q, qn, hot[0], hot[1], ooc_dev, slots, n_live, run, k, route,
                                 select_impl)
        staged = None
        try:
            if overlap and chunks:
                # double buffering: the first transfer overlaps the hot
                # scan when there is one, each later one the previous
                # tile's scan
                staged = pool.stage(ooc.store, chunks[0], hidden=hot is not None)
            for r, chunk in enumerate(chunks):
                if not overlap:
                    # the synchronous arm: drain, transfer, scan
                    if dev.type == "cuda":
                        torch.cuda.current_stream(dev).synchronize()
                    staged = pool.stage(ooc.store, chunk, hidden=False)
                # the scans still running at the take are what make its
                # wait hidden time
                vecs, ids_d = pool.take(staged, busy=not _compute_idle(dev))
                staged = None
                n_live = live(np.isin(slots_np, chunk))
                if n_live:
                    run = _scan_part(q, qn, vecs, ids_d, ooc_dev, slots, n_live, run, k, route,
                                     select_impl)
                del vecs, ids_d
                if overlap and r + 1 < len(chunks):
                    # gathered on the host while the card runs that scan
                    staged = pool.stage(ooc.store, chunks[r + 1], hidden=True)
        except BaseException:
            # a stage or scan failure mid-stream must not strand a staged
            # tile's budget charge (the serve worker relays the error and
            # keeps dispatching)
            if staged is not None:
                pool.discard(staged)
            raise
    dist, ids, _ = run
    if metric in _SQRT_METRICS:
        dist = torch.sqrt(dist)
    out = (dist, ids)
    if delta is not None:
        out = _merge_delta(out, delta, q, k, metric, select_impl)
    return out


# --------------------------------------------------------------------- #
# hot set and maintenance
# --------------------------------------------------------------------- #
def materialize_hot(ooc: OocIVFFlat, hot_ids: np.ndarray, *, pool_name: str = "ooc",
                    device="cuda") -> Tuple[torch.Tensor, torch.Tensor, np.ndarray]:
    """Copy the slots ``hot_ids`` to ``device`` as the hot-set block;
    returns ``(hot_vecs, hot_ids_device, hot_mask)``.  The caller sized
    the set from its byte budget; the bytes count as host-to-device
    traffic like any tile.  On the card the copy runs on the current
    stream and is complete when this returns, so the block can be
    published to another thread's batches at once."""
    ids = np.asarray(hot_ids, np.int32).ravel()
    expects(ids.size == 0 or (ids.min() >= 0 and ids.max() < ooc.n_slots),
            "materialize_hot: slot ids out of range")
    dev = resolve_device(device)
    host = ooc.store[ids]
    vecs = torch.from_numpy(host).to(dev)
    ids_d = torch.from_numpy(ids).to(dev)
    if dev.type == "cuda":
        torch.cuda.current_stream(dev).synchronize()
    _pool_counter("raft_tpu_h2d_bytes_total", "bytes streamed host-to-device by tile pools",
                  pool_name).inc(int(host.nbytes) + int(ids.nbytes))
    mask = np.zeros(ooc.n_slots, bool)
    mask[ids] = True
    return vecs, ids_d, mask


def ooc_reconstruct(ooc: OocIVFFlat) -> Tuple[np.ndarray, np.ndarray]:
    """``(vectors, int64 ids)`` from the host store, valid rows in slot
    order: the twin of :func:`~raft_tpu_torch.spatial.ann.ivf_flat_reconstruct`,
    on the host."""
    ids = ooc.slot_ids.cpu().numpy().reshape(-1)
    mask = ids >= 0
    vecs = ooc.store.reshape(-1, ooc.store.shape[-1])
    return vecs[mask], ids[mask].astype(np.int64)


def ooc_extend(ooc: OocIVFFlat, vectors, ids, *, slot_multiple: int = 64) -> OocIVFFlat:
    """Fold new rows into the out-of-core index (compaction), on the host:
    the nearest-existing-centroid assignment and the slot layout of
    :func:`~raft_tpu_torch.spatial.ann.ivf_flat_extend` (``_assign_labels``
    and ``_extend_slot_layout`` are shared), but the new slot store is
    assembled in numpy and never lands on the device.  Only the small
    metadata goes back to the centroids' device."""
    new_vecs = np.asarray(vectors, ooc.store.dtype)
    expects(new_vecs.ndim == 2 and new_vecs.shape[1] == ooc.store.shape[2],
            "ooc_extend: expected (rows, %d) vectors, got %r", int(ooc.store.shape[2]),
            tuple(new_vecs.shape))
    new_ids = np.asarray(ids, np.int64).ravel()
    expects(new_ids.shape[0] == new_vecs.shape[0], "ooc_extend: %d ids for %d vectors",
            new_ids.shape[0], new_vecs.shape[0])
    dev = ooc.centroids.device
    nlist = int(ooc.centroids.shape[0])
    cap = ooc.cap

    old_vecs, old_ids = ooc_reconstruct(ooc)
    old_labels = np.repeat(ooc.slot_centroid, cap)[
        ooc.slot_ids.cpu().numpy().reshape(-1) >= 0].astype(np.int64)
    if new_vecs.shape[0]:
        new_labels = _assign_labels(torch.from_numpy(new_vecs).to(dev),
                                    ooc.centroids).cpu().numpy().astype(np.int64)
        all_vecs = np.concatenate([old_vecs, new_vecs], axis=0)
        all_ids = np.concatenate([old_ids, new_ids])
        labels = np.concatenate([old_labels, new_labels])
    else:
        all_vecs, all_ids, labels = old_vecs, old_ids, old_labels

    slot_rows, slot_cent, cent_slots, counts = _extend_slot_layout(labels, nlist, cap,
                                                                   slot_multiple)
    gather = np.clip(slot_rows, 0, None)
    store = all_vecs[gather]
    store[slot_rows < 0] = 0
    slot_ids = np.where(slot_rows >= 0, all_ids[gather].astype(np.int32), -1).astype(np.int32)
    # einsum, not (store * store).sum(-1): the square of a store-sized
    # array would double the host memory for a moment
    norms = np.einsum("scd,scd->sc", store, store)
    return OocIVFFlat(ooc.centroids, torch.from_numpy(slot_ids).to(dev),
                      torch.from_numpy(norms).to(dev), torch.from_numpy(cent_slots).to(dev),
                      slot_cent.astype(np.int32),
                      torch.from_numpy(counts.astype(np.int32)).to(dev), ooc.metric,
                      ooc.nprobe, store)
