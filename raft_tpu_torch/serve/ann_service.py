"""ANNService: serve a resident IVF index with streaming ingestion.

Port of ``raft_tpu/serve/ann_service.py`` for one IVF-Flat, IVF-PQ or
IVF-SQ index on one device.  :class:`ANNService` fronts
:func:`raft_tpu_torch.spatial.ann.approx_knn_search` through the
micro-batching engine of :class:`~raft_tpu_torch.serve.service.Service`,
and adds what a vector store needs beyond a static index:

**Recall-targeted dispatch.**  The service owns a small *ladder* of
``nprobe`` cells.  :meth:`warmup` runs every bucket rung x every cell x
both delta arms once, so that every kernel library that serving,
:meth:`calibrate` and :meth:`compact` reach is built and loaded before
traffic (K3 and K2 on the search, K2 in the delta merge, K1 and K2 in the
brute-force ground truth).  :meth:`calibrate` measures recall@k against
an exact ground truth and the latency of each cell, then pins the
smallest cell that meets the target; :meth:`set_nprobe` retargets.

**Streaming ingestion.**  :meth:`insert` appends vectors to a
fixed-capacity *delta segment*, a ``(delta_cap, dim)`` buffer scanned by
brute force and merged into each batch's result
(:func:`raft_tpu_torch.spatial.ann._delta_merge_impl`); an inserted
vector is visible to the next formed batch.  When the delta crosses
``compact_rows``, the worker's maintenance seam folds it into the IVF
slots (:func:`raft_tpu_torch.spatial.ann.ivf_flat_extend`: nearest
existing centroid, no k-means) and swaps the index between batches.
Every batch reads one immutable :class:`_AnnState` (index and delta),
so an insert or a swap never tears a batch.  An IVF-PQ or IVF-SQ store
holds codes, which nothing can extend: such a service still ingests into
the delta and serves from it, but its automatic compaction is off and
:meth:`compact` raises.  ``refine_ratio`` reaches the IVF-PQ search
(IVF-Flat and IVF-SQ ignore it).

**Durability.**  ``persist_dir`` names a directory that holds the
service's snapshots and write-ahead log (:mod:`raft_tpu_torch.persist`,
the JAX package's format).  A directory that holds state is restored at
construction: the snapshot (every chunk's CRC verified) and the WAL's
tail replayed into the delta; ``index=None`` is then legal.  A new
directory gets a snapshot of the index at construction.  Each insert is
appended to the WAL before it is acknowledged (``persist_fsync``), and
the maintenance seam takes interval snapshots of the immutable state
(``snapshot_interval_s``) and scrubs a few chunks a tick
(``scrub_chunks``); :meth:`close` takes a last snapshot.

**Out-of-core serving.**  ``ooc=True`` (or an
:class:`~raft_tpu_torch.spatial.ooc.OocIVFFlat` passed as the index)
keeps an IVF-Flat slot store on the host and serves it through
:func:`~raft_tpu_torch.spatial.ooc.ooc_ivf_flat_search` within
``device_budget_bytes`` (default: the ``serve_ann_device_budget_bytes``
knob): a tile is sized to at most an eighth of the budget and 32 slots
(``tile_slots`` overrides), the budget must hold three tiles, the hot set
takes ``(budget - 3 tiles) // slot`` slots and the
:class:`~raft_tpu_torch.mr.tile_pool.TilePool` the rest less one tile (the
tile being scanned).  The hot set starts as the slots of the largest
lists; every ``ooc_promote_batches`` batches the maintenance seam moves
it to the most-probed slots when an eighth of it would change
(``raft_tpu_tile_evictions_total``, a ``hot_promote`` flight event, the
``raft_tpu_ooc_hot_{slots,bytes}`` gauges).  The hot set is part of the
immutable snapshot, and a rebuilt one is published only after its copy
to the card has completed.  Compaction runs
:func:`~raft_tpu_torch.spatial.ooc.ooc_extend` on the host.
``ooc_overlap=False`` serves the synchronous arm (the double buffer's
yardstick).  ``persist_mmap`` restores the store as a copy-on-write
memory map, and the scrub rebuilds a corrupted host-store slot from the
snapshot.

On the card, the state's tensors live on the worker's stream: the delta
is published by a synchronous copy of a private copy of the host mirror
on that stream (finished before :meth:`insert` returns; a later append
to the mirror never reaches a published snapshot), and compaction runs
on that stream too.  A batch launched before a swap is ordered before
any reuse of the old index's memory by that stream, so the old index
outlives the batches that read it.

**Degraded dispatch.**  While the queue holds ``degrade_queue_frac`` of
its cap, or the circuit breaker is half-open, batches are served one
ladder step below the calibrated cell; :meth:`degrade` holds a number of
steps by hand and :meth:`restore` releases it.

Results are held bit for bit to the port's own
:func:`~raft_tpu_torch.spatial.ann.approx_knn_search` of the batch the
worker formed, on the same snapshot and nprobe.  The probe and the delta
merge compute their distances with a matrix product (cuBLAS on the
card), which may round a row differently at another row count, so a
served row is held to the search of the same padded batch, as for the
expanded metrics of ``PairwiseService``.

Metrics (``raft_tpu_serve_ann_*``, labelled ``service=`` and, where
noted, ``nprobe=``): ``delta_rows``, ``inserts_total``,
``compactions_total``, ``compacted_rows_total``, ``compact_seconds``,
``calls_total{nprobe=}``, and calibration's ``nprobe_seconds{nprobe=}``
and ``recall{nprobe=}``; ``raft_tpu_serve_degraded_batches_total`` and
``raft_tpu_serve_degraded_active``.  Each compaction records a
``compaction`` flight event.

**Sharded serving.**  ``mesh``/``axis`` (with ``merge`` and
``group_size``) slot-shard an IVF-Flat index over a rank mesh
(:func:`~raft_tpu_torch.spatial.mnmg_knn.shard_ivf_flat_index`): every
batch runs :func:`~raft_tpu_torch.spatial.mnmg_knn.mnmg_ivf_flat_search`
(each rank probes and scans its own slots on K3, the merge topology
gives the global top-k), and the replicated delta merges after it.  The
sharded mirror is cached by the index object, so an insert re-shards
nothing; a compaction's swap or :meth:`ANNService.repartition` (run by
``post_recover`` after a communicator rebuild) re-shards the whole
index over the current mesh, the delta carried along.  Sharded serving
is IVF-Flat only and resident only: PQ, SQ and ``ooc=True`` are refused,
as the JAX service refuses them.

``select_impl`` pins the route of every selection of a served search
(``"kernel"``, K2, or ``"sort"``; the registry's ``select_impl``
candidates), checked at construction with the registry's legality for
the service's k and dtype, as the JAX service checks it; None resolves
the knob at each selection.  Both routes are exact, so a service pinned
to either serves the same answers.  The JAX package's buffer donation
has no PyTorch counterpart (``serve/scheduler.py``).
"""

from __future__ import annotations

import threading
import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from raft_tpu_torch import config
from raft_tpu_torch.core import flight, tuning
from raft_tpu_torch.core import metrics as _metrics
from raft_tpu_torch.core.device import as_tensor
from raft_tpu_torch.core.error import ServiceOverloadError, expects, fail
from raft_tpu_torch.mr.tile_pool import TilePool
from raft_tpu_torch.ops import _build
from raft_tpu_torch.persist import PersistManager
from raft_tpu_torch.serve.resilience import BreakerState
from raft_tpu_torch.comms.mesh import as_mesh, refuse_spanning
from raft_tpu_torch.serve.service import (Service, _knob_float, _knob_int, _resolve_shard_spec,
                                          _service_device, _service_seq, _shard_gauge)
from raft_tpu_torch.spatial import ann as _ann
from raft_tpu_torch.spatial import ooc as _ooc
from raft_tpu_torch.spatial.knn import brute_force_knn
from raft_tpu_torch.spatial.mnmg_knn import mnmg_ivf_flat_search, shard_ivf_flat_index

__all__ = ["ANNService"]

_CPU = torch.device("cpu")

class _AnnState(NamedTuple):
    """One immutable serving snapshot: a batch reads exactly one, so an
    insert or a compaction swap can never tear it."""

    index: object               # IVFFlatIndex | IVFPQIndex | IVFSQIndex | OocIVFFlat
    delta_vecs: torch.Tensor    # (delta_cap, dim) on the device, zeros past the count
    delta_ids: torch.Tensor     # (delta_cap,) int32 on the device, -1 past the count
    delta_rows: int
    # the last write-ahead-log sequence number whose insert this state
    # holds: a snapshot of it records it as its replay floor
    wal_seq: int = 0
    # the out-of-core hot set (hot_vecs, hot_ids on the device, hot_mask
    # numpy) or None: swapped whole by promotion and compaction
    ooc_hot: object = None
    # the slot-sharded mirror of ``index`` (ShardedIVFFlat) on a sharded
    # service, None otherwise: rebuilt when the index or the mesh changes
    sharded: object = None


def _labeled(kind: str, name: str, help: str, service: str, **extra):
    """Registry family with ``service=`` plus optional extra labels,
    resolved per use (a registry reset gets fresh families)."""
    label_names = ("service",) + tuple(sorted(extra))
    fam = getattr(_metrics.default_registry(), kind)(name, help=help, labels=label_names)
    return fam.labels(service=service, **extra)


def _parse_ladder(spec, nlist: int) -> tuple:
    """An nprobe-ladder spec (comma string or int sequence) as an
    ascending, deduplicated tuple clamped to ``nlist``."""
    if isinstance(spec, str):
        try:
            spec = [int(tok) for tok in spec.split(",") if tok.strip()]
        except ValueError:
            raise ValueError("ANNService: nprobe ladder %r is not a comma-separated "
                             "int list" % spec) from None
    cells = sorted({min(int(c), nlist) for c in spec if int(c) >= 1})
    expects(len(cells) > 0, "ANNService: empty nprobe ladder after clamping to nlist=%d",
            nlist)
    return tuple(cells)


_KINDS = (_ann.IVFFlatIndex, _ann.IVFPQIndex, _ann.IVFSQIndex, _ooc.OocIVFFlat)
# fields of an out-of-core index that stay on the host
_HOST_FIELDS = ("slot_centroid", "store")


def _index_on(index, dev: torch.device):
    """The index with every array on ``dev`` (no copy where it is there;
    an out-of-core index's host fields stay numpy) and, for IVF-Flat, its
    squared slot norms filled in."""
    host = _HOST_FIELDS if isinstance(index, _ooc.OocIVFFlat) else ()
    fields = {name: as_tensor(value, dev)
              if isinstance(value, (torch.Tensor, np.ndarray)) and name not in host
              else value for name, value in index._asdict().items()}
    out = type(index)(**fields)
    if isinstance(out, _ann.IVFFlatIndex) and out.slot_norms is None:
        out = out._replace(slot_norms=(out.slot_vecs * out.slot_vecs).sum(dim=-1))
    return out


class ANNService(Service):
    """Micro-batched :func:`~raft_tpu_torch.spatial.ann.approx_knn_search`
    over one pinned IVF index, with streaming ingestion (module doc).

    Parameters
    ----------
    index:
        A prebuilt :class:`~raft_tpu_torch.spatial.ann.IVFFlatIndex`,
        ``IVFPQIndex`` or ``IVFSQIndex``, moved to ``device``, or an
        :class:`~raft_tpu_torch.spatial.ooc.OocIVFFlat` (which implies
        ``ooc=True``); None with a ``persist_dir`` that holds state (the
        restored index).
    k:
        Neighbours returned per query row.
    nprobe:
        Probe count served by default; None resolves the
        ``serve_ann_nprobe`` knob (0 = the index's build-time default).
    nprobe_ladder:
        Candidate cells for :meth:`warmup` and :meth:`calibrate`
        (default: the ``serve_ann_nprobe_ladder`` knob), each clamped to
        the index's ``nlist``; the served ``nprobe`` is always included.
    refine_ratio:
        The IVF-PQ search's exact re-rank ratio (None: the index's);
        IVF-Flat and IVF-SQ ignore it.
    delta_cap / compact_rows:
        Delta-segment capacity and the auto-compaction threshold
        (``serve_ann_delta_cap`` / ``serve_ann_compact_rows`` knobs);
        ``compact_rows=0`` leaves compaction to :meth:`compact`.  An
        IVF-PQ or IVF-SQ service never compacts (module doc).
    degrade_queue_frac:
        Queue fraction of the admission cap from which batches are
        served one ladder step lower (``serve_ann_degrade_frac`` knob;
        0 disables).
    slot_multiple:
        Compaction rounds the slot count up to a multiple of this, so
        that successive compactions keep their shapes.
    ooc / device_budget_bytes / tile_slots / ooc_overlap / ooc_promote_batches:
        The out-of-core arm (module doc): an IVF-Flat store kept on the
        host, the device bytes it may use (default: the
        ``serve_ann_device_budget_bytes`` knob), the slots of a streamed
        tile (default: auto-sized), the double buffer (False: the
        synchronous arm) and the batches between hot-set promotions.
        The budget and ``tile_slots`` need ``ooc=True``.
    mesh / axis / merge / group_size:
        Sharded serving (module doc): slot-shard the index over ``axis``
        of ``mesh`` (``axis`` alone takes the default mesh of ``device``;
        a session's ``serve`` passes its own), the merge topology (None:
        the ``mnmg_merge`` knob) and the hierarchical group size.
    select_impl:
        The route of every selection of a served search: ``"kernel"``
        (K2), ``"sort"`` or None (the ``select_impl`` knob at each
        selection); checked here (module doc).
    persist_dir / persist_fsync / snapshot_interval_s / persist_mmap / scrub_chunks:
        Durable state (module doc): the directory, the WAL's fsync
        policy, the least seconds between interval snapshots, a restored
        out-of-core store as a copy-on-write memory map, and the
        snapshot chunks scrubbed a tick, the defaults their ``persist_*``
        knobs; they need ``persist_dir``.
    device:
        Where the index lives and the searches run (default: the first
        rank's device of ``mesh`` when one is given, else ``"cuda"``;
        raises when CUDA is missing).
    **opts:
        The shared :class:`~raft_tpu_torch.serve.service.Service`
        options (``max_batch_rows``, ``bucket_rungs``, ``max_wait_ms``,
        ``queue_cap``, ``retry_policy``, ``breaker``, ``start``,
        ``clock``, ...).
    """

    def __init__(self, index, k: int, *,
                 nprobe: Optional[int] = None,
                 nprobe_ladder=None,
                 refine_ratio: Optional[int] = None,
                 delta_cap: Optional[int] = None,
                 compact_rows: Optional[int] = None,
                 degrade_queue_frac: Optional[float] = None,
                 slot_multiple: int = 64,
                 ooc: bool = False,
                 device_budget_bytes: Optional[int] = None,
                 tile_slots: Optional[int] = None,
                 ooc_overlap: bool = True,
                 ooc_promote_batches: int = 32,
                 persist_dir: Optional[str] = None,
                 persist_fsync: Optional[str] = None,
                 snapshot_interval_s: Optional[float] = None,
                 persist_mmap: bool = False,
                 scrub_chunks: Optional[int] = None,
                 mesh=None, axis: Optional[str] = None,
                 merge: Optional[str] = None,
                 group_size: Optional[int] = None,
                 select_impl: Optional[str] = None,
                 name: Optional[str] = None,
                 device=None, **opts):
        if select_impl is not None:
            # a misspelled or JAX-only pin fails here, not mid-dispatch
            cents = getattr(index, "centroids", None)
            tuning.check("select_impl", select_impl, site="ANNService", explicit=True,
                         k=int(k), dtype=None if cents is None else cents.dtype)
        self._select_impl = select_impl
        if mesh is not None:
            mesh = as_mesh(mesh)
        dev = _service_device(device, mesh)
        # the name first: the persist manager labels its metrics with it
        self.name = name or "ann%d" % next(_service_seq)
        self._persist = None
        self._persist_wal_seq = 0
        restored = None
        if persist_dir is not None:
            self._persist = PersistManager(
                persist_dir, service=self.name, fsync=persist_fsync,
                snapshot_interval_s=snapshot_interval_s, scrub_chunks=scrub_chunks,
                clock=opts.get("clock", time.monotonic), device=dev)
            if self._persist.has_state():
                restored = self._persist.restore(mmap_store=persist_mmap)
                if restored.index is not None:
                    if index is not None:
                        expects(int(index.centroids.shape[1])
                                == int(restored.index.centroids.shape[1]),
                                "ANNService: persist_dir %r holds a dim-%d snapshot but the "
                                "constructor index is dim-%d", persist_dir,
                                int(restored.index.centroids.shape[1]),
                                int(index.centroids.shape[1]))
                    index = restored.index
        else:
            expects(persist_fsync is None and snapshot_interval_s is None
                    and scrub_chunks is None and not persist_mmap,
                    "ANNService: persist_fsync/snapshot_interval_s/scrub_chunks/persist_mmap "
                    "are durability knobs: pass persist_dir=")
        expects(index is not None, "ANNService: index=None requires persist_dir pointing at "
                "existing durable state (no snapshot or WAL found%s)"
                % ("" if persist_dir is None else " in %r" % persist_dir))
        expects(isinstance(index, _KINDS), "ANNService: index must be an IVF index "
                "(IVFFlatIndex/IVFPQIndex/IVFSQIndex/OocIVFFlat), got %r", type(index).__name__)
        if isinstance(index, _ooc.OocIVFFlat):
            ooc = True
        # slot-sharded dispatch (module doc); the delta stays replicated
        self._sharded_cache = None       # ShardedIVFFlat of _sharded_for
        self._sharded_for = None         # the index object it mirrors
        self._group_size = group_size
        self.merge = None
        if mesh is not None or axis is not None:
            expects(isinstance(index, _ann.IVFFlatIndex),
                    "ANNService: sharded serving requires an IVFFlatIndex (PQ/SQ slot stores "
                    "hold codes, an out-of-core store lives on the host: serve them "
                    "single-device)")
            expects(refine_ratio is None, "ANNService: refine_ratio is PQ-only; sharded "
                    "serving is IVF-Flat-only: drop it")
            expects(not ooc, "ANNService: ooc=True does not compose with sharded serving "
                    "(the tier trades device memory for host streaming; shard the resident "
                    "path instead)")
            self.mesh, self.axis, self.merge = _resolve_shard_spec("ANNService", mesh, axis,
                                                                   merge, dev)
        expects(k >= 1, "ANNService: k=%d", k)
        self.k = int(k)
        self._refine_ratio = refine_ratio
        expects(ooc or (device_budget_bytes is None and tile_slots is None),
                "ANNService: device_budget_bytes/tile_slots are out-of-core knobs: pass "
                "ooc=True (a resident service silently ignoring a memory budget would be "
                "worse than an error)")
        if ooc:
            expects(refine_ratio is None, "ANNService: refine_ratio is PQ-only; the "
                    "out-of-core tier is IVF-Flat-only: drop it")
            expects(isinstance(index, (_ann.IVFFlatIndex, _ooc.OocIVFFlat)),
                    "ANNService: ooc=True requires an IVF-Flat index (PQ/SQ stores are "
                    "already memory-compressed; serve them resident)")
            if isinstance(index, _ann.IVFFlatIndex):
                index = _ooc.ivf_flat_to_ooc(index)
            if self._persist is not None and not index.store.flags.writeable:
                # the scrub rebuilds a poisoned slot in place: a read-only
                # store is copied once into writable host memory
                index = index._replace(store=index.store.copy())
        index = _index_on(index, dev)
        self._nlist = int(index.centroids.shape[0])
        dim = int(index.centroids.shape[1])
        dtype = index.centroids.dtype
        self._slot_multiple = int(slot_multiple)
        # the stream the worker adopts (the current one at construction):
        # the delta is published, and compaction runs, on it
        self._stream = torch.cuda.current_stream(dev) if dev.type == "cuda" else None

        if nprobe is None:
            nprobe = _knob_int("serve_ann_nprobe")
            if nprobe == 0:
                nprobe = int(index.nprobe)
        expects(nprobe >= 1, "ANNService: nprobe=%d", int(nprobe))
        self._nprobe = min(int(nprobe), self._nlist)
        if nprobe_ladder is None:
            nprobe_ladder = config.get_int_list("serve_ann_nprobe_ladder")
        self._nprobe_ladder = _parse_ladder(nprobe_ladder, self._nlist)
        if self._nprobe not in self._nprobe_ladder:
            self._nprobe_ladder = tuple(sorted(self._nprobe_ladder + (self._nprobe,)))

        if delta_cap is None:
            delta_cap = _knob_int("serve_ann_delta_cap")
        expects(delta_cap >= 1, "ANNService: delta_cap=%d", delta_cap)
        self._delta_cap = int(delta_cap)
        if compact_rows is None:
            compact_rows = _knob_int("serve_ann_compact_rows")
        expects(compact_rows >= 0, "ANNService: compact_rows=%d", compact_rows)
        # an IVF-PQ or IVF-SQ store holds codes: it ingests into the delta
        # but never compacts (module doc)
        self._compactable = isinstance(index, (_ann.IVFFlatIndex, _ooc.OocIVFFlat))
        self._compact_rows = min(int(compact_rows), self._delta_cap) if self._compactable else 0
        if degrade_queue_frac is None:
            degrade_queue_frac = _knob_float("serve_ann_degrade_frac")
        expects(0.0 <= degrade_queue_frac <= 1.0, "ANNService: degrade_queue_frac=%r",
                degrade_queue_frac)
        self._degrade_frac = float(degrade_queue_frac)
        # the manual brownout lever (ladder steps); the pressure and
        # breaker checks raise the level per batch without touching it
        self._degrade_hold = 0

        # the delta segment: a host mirror (the append target) and the
        # device copy published in _ann_state; rows past the count carry -1
        self._delta_lock = threading.Lock()
        self._compact_lock = threading.Lock()
        self._delta_vecs = torch.zeros((self._delta_cap, dim), dtype=dtype)
        self._delta_ids = torch.full((self._delta_cap,), -1, dtype=torch.int32)
        self._delta_count = 0
        # the last compaction's duration: the retry_after_s hint of a
        # full-delta shed
        self._last_compact_s = 0.0
        self._index = index
        self.device = dev
        self._ooc = None
        self._ooc_pool = None
        self._ooc_hot = None
        if ooc:
            self._ooc_setup(index, device_budget_bytes, tile_slots, ooc_overlap,
                            ooc_promote_batches)
        self._publish_state_locked()
        if restored is not None:
            self._apply_restore(restored)
        if self._persist is not None and self._persist.snapshot_seq == 0:
            # the bootstrap snapshot: a directory with a WAL alone could
            # not rebuild the index
            self._persist.snapshot(self._ann_state)

        def execute(padded):
            st = self._ann_state        # one snapshot per batch
            nprobe_now, degraded = self._effective_nprobe()
            delta = (st.delta_vecs, st.delta_ids) if st.delta_rows else None
            _labeled("counter", "raft_tpu_serve_ann_calls_total",
                     "ANN batches dispatched per probe count", self.name,
                     nprobe=nprobe_now).inc()
            if degraded:
                _labeled("counter", "raft_tpu_serve_degraded_batches_total",
                         "batches served below the calibrated quality cell (nprobe "
                         "brownout)", self.name).inc()
            self._degraded_gauge().set(1 if degraded else 0)
            return self._snapshot_search(st, padded, nprobe_now, delta)

        super().__init__(self.name, execute, dim=dim, dtype=dtype, device=dev,
                         maintenance=self._maintenance_tick, **opts)
        if self.axis is not None:
            _shard_gauge(self.name, int(self.mesh.shape[self.axis]))

    # ------------------------------------------------------------------ #
    # snapshot plumbing
    # ------------------------------------------------------------------ #
    def _snapshot_search(self, st: _AnnState, q, nprobe, delta, force_rounds: int = 0):
        """The one search entry of dispatch, warmup and calibrate: the
        slot-sharded search when the snapshot carries a sharded mirror,
        the streamed out-of-core search when the service owns a tile
        pool, the quantizer's search otherwise."""
        if st.sharded is not None:
            return mnmg_ivf_flat_search(st.sharded, q, self.k, nprobe=nprobe, merge=self.merge,
                                        group_size=self._group_size, delta=delta,
                                        select_impl=self._select_impl)
        if self._ooc_pool is not None:
            return _ooc.ooc_ivf_flat_search(
                st.index, q, self.k, nprobe=nprobe, pool=self._ooc_pool, hot=st.ooc_hot,
                delta=delta, overlap=self._ooc_overlap, probe_hook=self._ooc_note_probes,
                force_rounds=force_rounds, select_impl=self._select_impl, device=self.device)
        return _ann.approx_knn_search(st.index, q, self.k, nprobe=nprobe,
                                      refine_ratio=self._refine_ratio, delta=delta,
                                      select_impl=self._select_impl, device=self.device)

    def _publish_state_locked(self) -> None:
        """Rebuild the immutable snapshot from the host mirror (callers
        hold ``_delta_lock``, or are in ``__init__``).  The device copy is
        made from a private copy of the mirror, synchronously, on the
        worker's stream (module doc).  The slot-sharded mirror is cached
        by the index object: an insert re-shards nothing, a compaction's
        swap or a re-partition does."""
        vecs, ids = self._delta_vecs.clone(), self._delta_ids.clone()
        with torch.cuda.stream(self._stream):
            vecs, ids = vecs.to(self.device), ids.to(self.device)
            sharded = None
            if self.axis is not None:
                if self._sharded_cache is None or self._sharded_for is not self._index:
                    self._sharded_cache = shard_ivf_flat_index(self._index, self.mesh,
                                                               self.axis)
                    self._sharded_for = self._index
                sharded = self._sharded_cache
        self._ann_state = _AnnState(self._index, vecs, ids, self._delta_count,
                                    self._persist_wal_seq, self._ooc_hot, sharded)
        _labeled("gauge", "raft_tpu_serve_ann_delta_rows",
                 "rows in the append-only delta segment", self.name).set(self._delta_count)

    @property
    def nprobe(self) -> int:
        return self._nprobe

    @property
    def nprobe_ladder(self) -> tuple:
        return self._nprobe_ladder

    @property
    def delta_rows(self) -> int:
        return self._ann_state.delta_rows

    @property
    def index(self):
        """The index served now (compaction swaps visible)."""
        return self._ann_state.index

    def set_nprobe(self, nprobe: int) -> int:
        """Retarget the served probe count (clamped to ``nlist``); takes
        effect on the next formed batch."""
        expects(int(nprobe) >= 1, "set_nprobe: nprobe=%d", int(nprobe))
        self._nprobe = min(int(nprobe), self._nlist)
        return self._nprobe

    # ------------------------------------------------------------------ #
    # degraded dispatch
    # ------------------------------------------------------------------ #
    def _degraded_gauge(self):
        return _labeled("gauge", "raft_tpu_serve_degraded_active",
                        "whether the last dispatched batch was served below the calibrated "
                        "cell (per-batch signal; idle services keep the last value)",
                        self.name)

    def _degrade_level(self) -> int:
        """Ladder steps to walk down for the next batch: the manual hold,
        and at least one while the queue holds ``degrade_queue_frac`` of
        its cap or the breaker is half-open."""
        level = self._degrade_hold
        if (self._degrade_frac > 0.0
                and self.batcher.depth() >= self._degrade_frac * self.batcher.queue_cap):
            level = max(level, 1)
        br = self.breaker
        if br is not None and br.state is BreakerState.HALF_OPEN:
            level = max(level, 1)
        return level

    def _effective_nprobe(self):
        """(nprobe, degraded) for the next batch: the served cell, or
        ``level`` ladder steps below it (every cell is warmed)."""
        base = self._nprobe
        level = self._degrade_level()
        if level <= 0:
            return base, False
        ladder = self._nprobe_ladder
        # the served cell's place; an off-ladder value maps to the
        # nearest cell at or below it
        i = 0
        for j, cell in enumerate(ladder):
            if cell <= base:
                i = j
        eff = ladder[max(0, i - level)]
        return min(eff, base), eff < base

    def degrade(self, levels: int = 1) -> None:
        """Hold dispatch ``levels`` ladder steps below the calibrated cell
        (``levels=0`` is :meth:`restore`)."""
        expects(levels >= 0, "degrade: levels=%d", levels)
        self._degrade_hold = int(levels)

    def restore(self) -> None:
        """Release the manual hold (pressure and breaker degradation still
        apply while their cause lasts)."""
        self._degrade_hold = 0
        if self._degrade_level() == 0:
            self._degraded_gauge().set(0)

    # ------------------------------------------------------------------ #
    # durability
    # ------------------------------------------------------------------ #
    def _apply_restore(self, restored) -> None:
        """Re-enter the durable state (construction only): the snapshot's
        delta rows into the host mirror, then every WAL record past the
        snapshot's ``wal_seq``, in order.  A replay that would overflow
        the delta (a crash between a compaction and its snapshot) folds
        the delta into an IVF-Flat index first, as compaction would."""
        with self._delta_lock:
            self._persist_wal_seq = int(restored.wal_seq)
            rows = int(restored.delta_rows)
            if rows:
                expects(rows <= self._delta_cap, "%s: the restored snapshot holds %d delta rows "
                        "but delta_cap is %d: restore with the original capacity or larger",
                        self.name, rows, self._delta_cap)
                self._delta_vecs[:rows] = torch.from_numpy(
                    np.ascontiguousarray(restored.delta_vecs)).to(self._delta_vecs.dtype)
                self._delta_ids[:rows] = torch.from_numpy(
                    np.asarray(restored.delta_ids, np.int32))
                self._delta_count = rows
            dim = self._delta_vecs.shape[1]
            for seq, ids, vecs in restored.wal_records:
                expects(vecs.ndim == 2 and vecs.shape[1] == dim,
                        "%s: WAL record %d carries dim-%d vectors; this service serves dim-%d",
                        self.name, int(seq), int(vecs.shape[1]), dim)
                n = int(vecs.shape[0])
                if self._delta_count + n > self._delta_cap:
                    self._fold_delta_locked()
                expects(self._delta_count + n <= self._delta_cap, "%s: WAL record %d (%d rows) "
                        "exceeds the delta capacity %d even after folding", self.name,
                        int(seq), n, self._delta_cap)
                at = self._delta_count
                self._delta_vecs[at:at + n] = torch.from_numpy(vecs).to(self._delta_vecs.dtype)
                self._delta_ids[at:at + n] = torch.from_numpy(np.asarray(ids, np.int32))
                self._delta_count = at + n
                self._persist_wal_seq = int(seq)
            self._publish_state_locked()

    def _fold_delta_locked(self) -> None:
        """Restore-time compaction (the caller holds ``_delta_lock``): the
        whole delta folded into the index, before any traffic."""
        expects(self._compactable, "%s: WAL replay overflowed the delta segment and a PQ/SQ "
                "index cannot be extended: raise delta_cap or rebuild offline", self.name)
        n0 = self._delta_count
        if n0 == 0:
            return
        with torch.cuda.stream(self._stream):
            old_index = self._index
            self._index = self._extend(old_index, self._delta_vecs[:n0].clone(),
                                       self._delta_ids[:n0].numpy().copy())
        if self._ooc is not None:
            self._ooc_swap_locked(old_index, self._index)
        self._delta_ids[:] = -1
        self._delta_count = 0

    def _extend(self, index, vecs, keys):
        """The compaction's rebuild: on the host for an out-of-core index
        (the store never lands on the device), on the device otherwise."""
        if isinstance(index, _ooc.OocIVFFlat):
            return _ooc.ooc_extend(index, vecs, keys, slot_multiple=self._slot_multiple)
        return _ann.ivf_flat_extend(index, vecs, keys, slot_multiple=self._slot_multiple,
                                    device=self.device)

    # ------------------------------------------------------------------ #
    # the out-of-core arm
    # ------------------------------------------------------------------ #
    def _ooc_setup(self, index, budget, tile_slots, overlap, promote_batches) -> None:
        """The budget split (module doc), the tile pool and the first hot
        set (construction only)."""
        if budget is None:
            budget = _knob_int("serve_ann_device_budget_bytes")
        expects(budget > 0, "ANNService: ooc=True needs a device budget: pass "
                "device_budget_bytes= or set the serve_ann_device_budget_bytes knob")
        self._ooc = index
        self._ooc_budget = int(budget)
        self._ooc_overlap = bool(overlap)
        slot_b = index.slot_bytes()
        if tile_slots is None:
            # a tile is at most an eighth of the budget (three in flight and
            # a hot set must fit), and 32 slots at most
            tile_slots = min(32, index.n_slots, self._ooc_budget // (8 * (slot_b + 4)))
        tile_slots = max(1, min(int(tile_slots), index.n_slots))
        tile_b = tile_slots * (slot_b + 4)
        expects(self._ooc_budget >= 3 * tile_b, "ANNService: device_budget_bytes=%d holds "
                "fewer than 3 tiles of %d bytes: raise the budget or shrink tile_slots",
                self._ooc_budget, tile_b)
        # H hot slots, one taken tile being scanned, two staged (the
        # double buffer)
        self._ooc_hot_cap = min((self._ooc_budget - 3 * tile_b) // slot_b, index.n_slots)
        pool_budget = max(2 * tile_b, self._ooc_budget - self._ooc_hot_cap * slot_b - tile_b)
        self._ooc_promote_batches = max(1, int(promote_batches))
        self._ooc_batches = 0
        # the promotion signal: probe traffic per slot (distinct slots per
        # batch, weighted by the queries that probed each)
        self._ooc_counters = np.zeros(index.n_slots, np.int64)
        self._ooc_pool = TilePool(tile_slots, pool_budget, name=self.name, device=self.device)
        # the tile-miss storm check's baselines: this pool's counter now (a
        # reused service name must not inherit a dead service's total)
        self._ooc_batches_total = 0
        self._storm_batches0 = 0
        self._storm_misses0 = self._tile_misses_now()
        # the first hot set: the slots of the largest lists, the best
        # stand-in for traffic not yet seen
        self._ooc_hot_ids = self._ooc_ideal_hot()
        self._ooc_rebuild_hot()

    def _ooc_ideal_hot(self) -> np.ndarray:
        """The ``_ooc_hot_cap`` slots the hot set should hold now: the top
        by probe counters (before any traffic: by their list's size),
        ties to the lower slot id; slots of the layout's padding (no
        valid rows) sink below every real one."""
        ooc = self._ooc
        counters = self._ooc_counters
        if counters.any():
            priority = counters.astype(np.int64)
        else:
            priority = ooc.list_sizes.cpu().numpy().astype(np.int64)[ooc.slot_centroid]
        first = ooc.slot_ids[:, 0].cpu().numpy()
        priority = np.where(first >= 0, priority, -1)
        order = np.lexsort((np.arange(priority.size), -priority))
        return np.sort(order[:self._ooc_hot_cap]).astype(np.int64)

    def _ooc_rebuild_hot(self) -> None:
        """Copy ``_ooc_hot_ids`` to the device as the hot block, on the
        worker's stream, complete before this returns (so the caller may
        publish it), and refresh the gauges.  Callers publish after."""
        if self._ooc_hot_cap == 0:
            self._ooc_hot = None
        else:
            with torch.cuda.stream(self._stream):
                self._ooc_hot = _ooc.materialize_hot(self._ooc, self._ooc_hot_ids,
                                                     pool_name=self.name, device=self.device)
        hot_n = 0 if self._ooc_hot is None else len(self._ooc_hot_ids)
        _labeled("gauge", "raft_tpu_ooc_hot_slots",
                 "slots resident in the out-of-core hot set", self.name).set(hot_n)
        _labeled("gauge", "raft_tpu_ooc_hot_bytes",
                 "device bytes the out-of-core hot set occupies",
                 self.name).set(hot_n * self._ooc.slot_bytes())

    def _ooc_swap_locked(self, old, new) -> None:
        """A compaction's swap of the out-of-core index (the caller holds
        ``_delta_lock`` and publishes after): the counters carried over,
        the hot set rebuilt on the new slots."""
        self._ooc_remap_counters(old, new)
        self._ooc = new
        self._ooc_hot_ids = self._ooc_ideal_hot()
        self._ooc_rebuild_hot()

    def _ooc_note_probes(self, distinct: np.ndarray, counts: np.ndarray) -> None:
        """The search's probe hook (on whatever thread searches): feed the
        promotion counters.  ``distinct`` is unique, so the fancy-index
        add is one ufunc call; a search still reading a snapshot from
        before a compaction is bounds-guarded against the resized
        counters."""
        c = self._ooc_counters
        if distinct.size and int(distinct[-1]) < c.size:
            c[distinct] += counts
        self._ooc_batches += 1
        self._ooc_batches_total += 1

    def _ooc_promote_tick(self) -> None:
        """Maintenance hook: move the hot set to the measured top slots
        when probe traffic says the working set moved, every
        ``ooc_promote_batches`` batches and only when more than an eighth
        of the set would change (steady traffic pays no churn).  The swap
        is one snapshot publish: batches in flight keep the old block."""
        if (self._ooc_hot_cap == 0 or self._ooc_batches < self._ooc_promote_batches
                or self.batcher.draining()):
            return
        self._ooc_batches = 0
        with self._compact_lock:
            ideal = self._ooc_ideal_hot()
            cur = self._ooc_hot_ids
            fresh = np.setdiff1d(ideal, cur, assume_unique=True)
            if fresh.size <= max(1, self._ooc_hot_cap // 8):
                return
            evicted = np.setdiff1d(cur, ideal, assume_unique=True).size
            with self._delta_lock:
                self._ooc_hot_ids = ideal
                self._ooc_rebuild_hot()
                self._publish_state_locked()   # the atomic swap
        _metrics.default_registry().counter(
            "raft_tpu_tile_evictions_total", help="hot-set slots demoted by frequency promotion",
            labels=("pool",)).labels(pool=self.name).inc(int(evicted))
        flight.record("hot_promote", service=self.name, promoted=int(fresh.size),
                      evicted=int(evicted), hot_slots=int(self._ooc_hot_cap))

    def _ooc_remap_counters(self, old, new) -> None:
        """Carry the probe counters across a compaction's renumbering of
        the slots: ``ooc_extend`` keeps the centroids, so a slot's traffic
        goes to its centroid and is spread evenly over that centroid's
        new slots."""
        nlist = int(old.centroids.shape[0])
        cent_tot = np.bincount(old.slot_centroid, weights=self._ooc_counters, minlength=nlist)
        slots_per = np.maximum(np.bincount(new.slot_centroid, minlength=nlist), 1)
        self._ooc_counters = (cent_tot[new.slot_centroid]
                              // slots_per[new.slot_centroid]).astype(np.int64)

    def _tile_misses_now(self) -> float:
        """This service's pool-labelled tile-miss counter (0.0 before any
        miss)."""
        fam = _metrics.default_registry().get("raft_tpu_tile_misses_total")
        if fam is not None:
            for labels, series in fam.series():
                if labels.get("pool") == self.name:
                    return float(series.value)
        return 0.0

    def _ooc_storm_check(self) -> None:
        """Record a ``tile_miss_storm`` flight event when the working set
        has outrun the hot set and the staging window: the recent tile
        misses per batch exceed two tiles (every batch streams more than
        the double buffer holds).  Reads the counter on the maintenance
        seam only."""
        batches = self._ooc_batches_total - self._storm_batches0
        if batches < 8:
            return
        misses = self._tile_misses_now()
        per_batch = (misses - self._storm_misses0) / batches
        self._storm_batches0 = self._ooc_batches_total
        self._storm_misses0 = misses
        if per_batch > 2.0 * self._ooc_pool.tile_slots:
            flight.record("tile_miss_storm", service=self.name,
                          misses_per_batch=round(per_batch, 2),
                          tile_slots=int(self._ooc_pool.tile_slots), batches=int(batches))

    # ------------------------------------------------------------------ #
    # warmup: every bucket rung x every nprobe cell, both delta arms
    # ------------------------------------------------------------------ #
    def warmup(self) -> "ANNService":
        """Run every (bucket rung x nprobe cell) search on zeros, with an
        empty and with a blank delta, and the brute-force ground truth
        of :meth:`calibrate` once on the centroids, on the worker's
        stream, and wait.  Every kernel library serving, calibration
        and compaction reach is then built and loaded; the count taken
        here is what ``stats()`` holds still.  An out-of-core service
        also streams one tile a search (``force_rounds=1``), so the pool
        has staged before traffic."""
        st = self._ann_state
        dev = self.device
        with torch.cuda.stream(self._stream):
            blank = (torch.zeros((self._delta_cap, self.dim), dtype=self.dtype, device=dev),
                     torch.full((self._delta_cap,), -1, dtype=torch.int32, device=dev))
            force = 1 if self._ooc_pool is not None else 0
            for rung in self.policy.rungs:
                for cell in self._nprobe_ladder:
                    for delta in (None, blank):
                        self._snapshot_search(
                            st, torch.zeros((rung, self.dim), dtype=self.dtype, device=dev),
                            cell, delta, force_rounds=force)
            brute_force_knn(st.index.centroids, torch.zeros((1, self.dim), dtype=self.dtype,
                                                            device=dev),
                            min(self.k, self._nlist), device=dev)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        self._warmed = self.policy.rungs
        self._warm_kernels = _build.stats()
        return self

    # ------------------------------------------------------------------ #
    # streaming ingestion
    # ------------------------------------------------------------------ #
    def insert(self, ids, vectors) -> int:
        """Append vectors to the delta segment under caller-owned global
        ids (non-negative, disjoint from the index's: the caller's
        contract).  Visible to the next formed batch; returns the delta's
        row count after the append.

        Raises :class:`~raft_tpu_torch.core.error.ServiceOverloadError`
        when the segment lacks room: retry after compaction (automatic at
        ``compact_rows``, or :meth:`compact`)."""
        expects(self.is_open(), "%s.insert: service is closed", self.name)
        v = as_tensor(vectors, _CPU)
        if v.ndim == 1:
            v = v[None, :]
        expects(v.ndim == 2 and v.shape[1] == self.dim,
                "%s.insert: expected (rows, %d) vectors, got %r", self.name, self.dim,
                tuple(v.shape))
        v = v.to(self.dtype)
        key = as_tensor(ids, _CPU).reshape(-1).to(torch.int32)
        expects(key.shape[0] == v.shape[0], "%s.insert: %d ids for %d vectors", self.name,
                key.shape[0], v.shape[0])
        expects(key.shape[0] == 0 or bool((key >= 0).all()),
                "%s.insert: negative ids (the delta reserves -1 for unfilled capacity)",
                self.name)
        n = int(v.shape[0])
        if n == 0:
            return self._delta_count
        expects(n <= self._delta_cap, "%s.insert: %d rows exceed the whole delta capacity %d",
                self.name, n, self._delta_cap)
        with self._delta_lock:
            at = self._delta_count
            if at + n > self._delta_cap:
                raise ServiceOverloadError(
                    "%s.insert: delta segment full (%d + %d > cap %d); wait for compaction "
                    "and retry" % (self.name, at, n, self._delta_cap), at, self._delta_cap,
                    retry_after_s=max(self._last_compact_s, 0.05))
            if self._persist is not None:
                # the acknowledge contract: the record is in the WAL
                # (durable per the fsync policy) before the mirror
                # changes or the caller is answered
                self._persist_wal_seq = self._persist.wal_append(key.numpy(), v.numpy())
            self._delta_vecs[at:at + n] = v
            self._delta_ids[at:at + n] = key
            self._delta_count = at + n
            self._publish_state_locked()
        _labeled("counter", "raft_tpu_serve_ann_inserts_total",
                 "vectors ingested into the delta segment", self.name).inc(n)
        return at + n

    def _maintenance_tick(self) -> None:
        """Worker-loop hook: promote the out-of-core hot set when probe
        traffic moved and flag tile-miss storms, compact when the delta
        crosses the threshold (never while draining: drain serves out,
        it starts no rebuild), then the durability tick (deferred fsync,
        interval snapshot of the immutable state, one scrub step)."""
        if self._ooc is not None:
            self._ooc_storm_check()
            self._ooc_promote_tick()
        if (self._compact_rows and self._delta_count >= self._compact_rows
                and not self.batcher.draining()):
            self.compact()
        if self._persist is not None:
            self._persist.maintenance_tick(self._ann_state, ooc=self._ooc)

    def compact(self) -> bool:
        """Fold the delta segment into the IVF slots and swap the served
        index (module doc); False when the delta was empty.  Safe from
        any thread (serialised by a lock); rows inserted during the
        rebuild stay in the delta for the next round.  Raises for an
        IVF-PQ or IVF-SQ index."""
        expects(self._compactable, "%s.compact: compaction requires an IVFFlatIndex (PQ/SQ "
                "stores hold codes; rebuild offline)", self.name)
        with self._compact_lock:
            with self._delta_lock:
                n0 = self._delta_count
                if n0 == 0:
                    return False
                vecs = self._delta_vecs[:n0].clone()
                keys = self._delta_ids[:n0].numpy().copy()
                old_index = self._index
            t0 = self._clock()
            with torch.cuda.stream(self._stream):
                new_index = self._extend(old_index, vecs, keys)
            if self._stream is not None:
                self._stream.synchronize()
            with self._delta_lock:
                rem = self._delta_count - n0
                if rem:
                    self._delta_vecs[:rem] = self._delta_vecs[n0:self._delta_count].clone()
                    self._delta_ids[:rem] = self._delta_ids[n0:self._delta_count].clone()
                self._delta_ids[rem:] = -1
                self._delta_count = rem
                self._index = new_index
                if self._ooc is not None:
                    self._ooc_swap_locked(old_index, new_index)
                self._publish_state_locked()   # the atomic swap
        if self._persist is not None:
            # the snapshot on disk no longer matches the served index
            self._persist.note_dirty()
        _labeled("counter", "raft_tpu_serve_ann_compactions_total",
                 "delta-to-slots compactions", self.name).inc()
        _labeled("counter", "raft_tpu_serve_ann_compacted_rows_total",
                 "rows folded into IVF slots by compaction", self.name).inc(n0)
        self._last_compact_s = self._clock() - t0
        _labeled("timer", "raft_tpu_serve_ann_compact_seconds",
                 "compaction latency (re-cluster + swap)", self.name).observe(
                     self._last_compact_s)
        flight.record("compaction", service=self.name, rows=int(n0),
                      seconds=round(self._last_compact_s, 6))
        return True

    # ------------------------------------------------------------------ #
    # recall-targeted dispatch
    # ------------------------------------------------------------------ #
    def ground_truth_store(self, reference=None, *, state: Optional[_AnnState] = None):
        """(vectors, int64 global ids) as numpy for an exact ground truth:
        the caller's reference matrix (ids = row numbers) or the index's
        own content (IVF-Flat; IVF-PQ where it keeps its vectors), plus
        the live delta rows, all read from one snapshot (``state``, by
        default the current one)."""
        st = state if state is not None else self._ann_state
        if reference is not None:
            vecs = as_tensor(reference, _CPU).numpy()
            ids = np.arange(vecs.shape[0], dtype=np.int64)
        elif isinstance(st.index, _ooc.OocIVFFlat):
            vecs, ids = _ooc.ooc_reconstruct(st.index)   # the store is host memory
        elif isinstance(st.index, _ann.IVFFlatIndex):
            vecs, ids = _ann.ivf_flat_reconstruct(st.index)
        elif isinstance(st.index, _ann.IVFPQIndex) and st.index.vectors is not None:
            vecs = st.index.vectors.cpu().numpy()
            ids = np.arange(vecs.shape[0], dtype=np.int64)
        else:
            fail("%s.calibrate: pass reference=: a %s index stores quantized codes, not "
                 "vectors, so an exact ground truth cannot be read from it", self.name,
                 type(st.index).__name__)
        if st.delta_rows:
            vecs = np.concatenate([vecs, st.delta_vecs[:st.delta_rows].cpu().numpy()])
            ids = np.concatenate([ids, st.delta_ids[:st.delta_rows].cpu().numpy()
                                  .astype(np.int64)])
        return vecs, ids

    def calibrate(self, queries, target_recall: float = 0.9, *, reference=None,
                  set_default: bool = True, measure_all: bool = False) -> dict:
        """Walk the nprobe ladder for the smallest cell that reaches
        ``target_recall`` (recall@k against a brute-force ground truth
        computed once), timing each cell through the serving search.

        Returns ``{"chosen_nprobe", "target_recall", "met_target", "k",
        "table": [{nprobe, recall_at_k, latency_s}, ...]}``; with
        ``set_default`` the chosen cell becomes the served ``nprobe``.
        The walk stops at the first cell that meets the target unless
        ``measure_all``."""
        q = self._check_payload(queries)
        expects(0.0 < target_recall <= 1.0, "%s.calibrate: target_recall=%r", self.name,
                target_recall)
        # one snapshot for the ground truth and every measured search
        st = self._ann_state
        gt_vecs, gt_ids = self.ground_truth_store(reference, state=st)
        expects(gt_vecs.shape[0] >= self.k, "%s.calibrate: ground-truth store has %d rows "
                "< k=%d", self.name, gt_vecs.shape[0], self.k)
        _, gt_rows = brute_force_knn(gt_vecs, q, self.k, device=self.device)
        gt = gt_ids[gt_rows.cpu().numpy()]
        delta = (st.delta_vecs, st.delta_ids) if st.delta_rows else None
        table = []
        chosen = None
        for cell in self._nprobe_ladder:
            t0 = self._clock()
            out = self._snapshot_search(st, q, cell, delta)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            dt = self._clock() - t0
            got = out[1].cpu().numpy()
            recall = float(np.mean([len(set(got[r]) & set(gt[r])) / self.k
                                    for r in range(got.shape[0])]))
            _labeled("timer", "raft_tpu_serve_ann_nprobe_seconds",
                     "calibration search latency per probe count", self.name,
                     nprobe=cell).observe(dt)
            _labeled("gauge", "raft_tpu_serve_ann_recall", "calibration recall@k per probe "
                     "count", self.name, nprobe=cell).set(recall)
            table.append({"nprobe": cell, "recall_at_k": round(recall, 4),
                          "latency_s": round(dt, 5)})
            if chosen is None and recall >= target_recall:
                chosen = cell
                if not measure_all:
                    break   # the ladder ascends: the first hit is the cheapest
        met = chosen is not None
        if chosen is None:
            chosen = self._nprobe_ladder[-1]
        if set_default:
            self.set_nprobe(chosen)
        return {"chosen_nprobe": chosen, "target_recall": target_recall, "met_target": met,
                "k": self.k, "table": table}

    # ------------------------------------------------------------------ #
    # recovery
    # ------------------------------------------------------------------ #
    def repartition(self, mesh=None) -> bool:
        """Re-shard the slots over ``mesh`` (default: the owning session's
        current mesh), the shard-loss lever: the lost shard's slots
        redistribute over the surviving ranks, exactly (the full index is
        the source), and the delta is re-published with them.  Call
        ``warmup()`` after.  True when the mesh changed."""
        expects(self.axis is not None, "%s.repartition: service is not sharded", self.name)
        mesh = self._recovery_mesh() if mesh is None else as_mesh(mesh)
        refuse_spanning(mesh, "%s.repartition" % self.name)
        expects(self.axis in mesh.axis_names,
                "%s.repartition: replacement mesh lacks axis %r", self.name, self.axis)
        changed = mesh is not self.mesh
        if changed:
            self._drop_stale_group_size(mesh)
        with self._delta_lock:
            self.mesh = mesh
            self._sharded_cache = None       # force the re-shard
            self._publish_state_locked()     # the atomic swap
        if changed:
            self._record_repartition(mesh)
        return changed

    def post_recover(self) -> None:
        """Carry the serving snapshot across a communicator rebuild
        (:class:`~raft_tpu_torch.serve.resilience.RecoveryManager` step 4):
        a sharded service re-partitions onto the rebuilt session mesh; an
        out-of-core one re-copies its hot set from the host store; every
        service re-publishes its ``(index, delta)`` snapshot, so each row
        inserted before the failure is still found."""
        if self.axis is not None:
            self.repartition()   # republishes the snapshot
            return
        with self._delta_lock:
            if self._ooc is not None:
                self._ooc_rebuild_hot()
            self._publish_state_locked()

    def close(self, drain: bool = True, timeout: Optional[float] = None, *,
              snapshot: bool = True) -> None:
        """Drain and stop (the base contract), then, for a persistent
        service, take the last snapshot, so that a restart replays no
        WAL.  ``snapshot=False`` skips it (a simulated crash: the restart
        recovers from the last snapshot and the WAL's tail).
        Idempotent."""
        was_closed = self._closed
        super().close(drain=drain, timeout=timeout)
        if was_closed or self._persist is None:
            return
        if snapshot:
            self._persist.final_snapshot(self._ann_state)
        self._persist.close()

    # ------------------------------------------------------------------ #
    def stats(self) -> dict:
        out = super().stats()
        out.update({
            "kind": type(self._index).__name__,
            "nprobe": self._nprobe,
            "nprobe_ladder": list(self._nprobe_ladder),
            "delta_rows": self.delta_rows,
            "delta_cap": self._delta_cap,
            "compact_rows": self._compact_rows,
            "degrade_queue_frac": self._degrade_frac,
            "degrade_hold": self._degrade_hold,
            "last_compact_s": self._last_compact_s,
        })
        if self._persist is not None:
            out["persist"] = self._persist.stats()
        if self._ooc is not None:
            out["ooc"] = {
                "budget_bytes": self._ooc_budget,
                "store_bytes": self._ooc.store_bytes(),
                "hot_slots": 0 if self._ooc_hot is None else len(self._ooc_hot_ids),
                "hot_cap": self._ooc_hot_cap,
                "tile_slots": self._ooc_pool.tile_slots,
                "pool_budget_bytes": self._ooc_pool.budget_bytes,
                "staged_bytes": self._ooc_pool.staged_bytes(),
                "overlap": self._ooc_overlap,
            }
        return out
