"""Approximate nearest neighbours: IVF-Flat, IVF-PQ and IVF-SQ.

Port of ``raft_tpu/spatial/ann.py`` (reference spatial/knn/ann.hpp:45,71,
``approx_knn_build_index`` / ``approx_knn_search``, which delegate to
FAISS GPU).  Three quantizers share one coarse quantizer and one slot
layout:

- **IVF-Flat** stores the vectors;
- **IVF-PQ** stores product-quantization codes of the residuals: M
  subspaces of ``d / M`` dimensions, each with a k-means codebook of
  ``2 ** n_bits`` codewords (padded with ``inf`` rows where there are
  fewer rows than codewords), and the codes as int32 k-means labels;
  built with ``refine_ratio > 1`` it keeps the vectors too, for an exact
  re-rank of the top ``k * refine_ratio`` candidates;
- **IVF-SQ** stores 8-bit scalar codes (``QT_8bit``: per-dimension
  ``scale``/``offset``; ``QT_8bit_uniform``: one range for all
  dimensions) of the residuals, or of the vectors without
  ``encode_residual``, as uint8 on the device.

**Build.** A k-means coarse quantizer (:mod:`raft_tpu_torch.spectral.kmeans`,
whose assignment runs on K4 for nlist >= 256), optionally trained on a
seeded row subsample (``train_rows``, the same rows as the JAX package
draws), then one chunked nearest-centroid pass over all rows.  Lists are
cut on the host into fixed-length *slots* of ``cap`` rows (cap = mean list
size rounded up to 8): a hot list owns several slots, and storage stays
below ``n_rows + nlist * cap`` whatever the skew.  The lists are packed by
the native host runtime (``rt_build_lists`` through
:mod:`raft_tpu_torch.core.native`), as in the JAX package; the numpy
route runs only on a machine without ``g++``.  IVF-PQ's codebooks are M
more k-means runs (256 codewords: K4 again), one per subspace of the
residuals.  Each stage runs in a named ``torch.profiler`` range
(``ivf_*_build.*``, ``kmeans.*``), and ``stages={}`` fills a dict with
each stage's milliseconds.

**Search.** Probe the ``nprobe`` nearest centroids (``select_k``, K2 on the
card), concatenate the probed lists' slots, and move the valid ones to
the front by a stable sort (``_probe_compact``; the step scan also takes
each slot's probe rank from it).  IVF-Flat then takes one of two scans with one
contract:

- ``scan_impl="kernel"``: K3 (:func:`raft_tpu_torch.ops.ivf_tile.fused_ivf_scan`):
  the scan lists grouped by probed slot into a work list, one kernel
  launch over it that reads each slot once per group of queries, and K2
  merging each query's steps; ``"kernel_bf16"`` rounds the
  multiplicands to bfloat16.  Legal for float32 queries and
  store and k <= 128 (the metrics are all of the L2 family); an explicit
  request outside that raises.
- ``scan_impl="scan"``: one step per slot: gather the slot of every
  query, expanded distances by a batched product, and ``select_k`` of the
  running top-k followed by the step.

``scan_impl=None`` resolves the ``ivf_scan_impl`` knob
(:func:`raft_tpu_torch.core.tuning.resolve`: override, configure,
``RAFT_TPU_IVF_SCAN_IMPL``, the tuning table on the (n, k, d) shape
class), at each call; unset, it takes the kernel on CUDA wherever it is
legal, and the scan otherwise, which includes every CPU call.  The JAX
package's own auto default is its ``"xla"`` scan; the port defaults to
the kernel, as ``fused_l2_knn`` does.

``select_impl=`` pins the route of every selection of a search (the
probe, the step merges, the refine and the delta merge), as the JAX
searches thread it: ``"kernel"`` (K2) or ``"sort"``
(:func:`~raft_tpu_torch.spatial.select_k.select_k`); None resolves the
``select_impl`` knob at each selection.  Both routes are exact and break
ties to the smaller column, so they give the same answers.  K3's own
merge is part of its route and stays on K2.

IVF-PQ's ADC distance of a row is the sum over its M subspaces of a
lookup table of the query and the row's list, read at the row's codes.
On CUDA, with float32 queries, an L2 metric and ``k * refine_ratio`` <=
512, the search takes one of two kernel routes where it fits
(:mod:`raft_tpu_torch.ops.pq_scan` says which shapes each takes): K7
(:func:`~raft_tpu_torch.ops.pq_scan.ivf_pq_scan`, legality rule
:func:`~raft_tpu_torch.ops.pq_scan.takes`: M <= 64, the whole codebook
in shared memory), which builds each (query, probe) table in shared
memory from the codebooks; else its wide route
(:func:`~raft_tpu_torch.ops.pq_scan.ivf_pq_scan_wide`,
:func:`~raft_tpu_torch.ops.pq_scan.takes_wide`: M <= 96, any depth),
which builds it from list terms made once an index and query terms made
once a query.  Either reads the codes once as uint8, narrowed from the
index's int32 (by K7's route once a call; by the wide route, with its
list terms, at an index's first wide search, and kept while the index's
device tensors live unchanged: :func:`_wide_operands`), and keeps each
query's running top-k on chip, one launch a chunk; no step counts are
read.  Otherwise, which includes every CPU call, the search takes the
step scan, as the JAX package scans PQ with its XLA loop (no Pallas
kernel; :func:`~raft_tpu_torch.ops.pq_scan.ivf_pq_scan_plain`, the
kernels' plain version): the tables ``(nq, nprobe, M, 2 ** n_bits)`` by
one batched product before the scan, then one step a slot, which reads
one query's table of the slot's probe by its rank and gathers it by the
slot's codes, summed over M (the JAX package's ``"gather"`` ADC; its
one-hot formulation suits the TPU's MXU, not the card), and merges it
into the running top-k by ``select_k`` (K2 where k <= 128, a stable sort
above).  The tables of a call are ``nprobe * M * 2 ** n_bits`` floats a
query (3.3 MB at nprobe 50, M 64, 8 bits), so after one probe of the
whole call the queries go through in chunks: a chunk's tables, their
temporaries and its step transients (:func:`pq_query_bytes`; on a kernel
route its candidates and the re-rank) stay under
:data:`PQ_BUDGET_BYTES`, only one chunk's tables live at a time, and a
chunk runs as many steps as its own busiest query needs.  The ranges
``ivf_pq_search.probe``, ``.tables``, ``.scan`` and ``.refine`` and the
counters :data:`PQ_COUNTERS`, :data:`PQ_KERNEL_CHUNKS`,
:data:`PQ_WIDE_CHUNKS` and :data:`PQ_TABLE_READS` trace it (both kernel
routes run inside ``.scan``; ``.tables`` then runs nothing).  IVF-SQ
always takes the step scan and dequantises the one slot of each query
per step.

Results are (distances, int32 ids) best-first, square-rooted for the
L2Sqrt metrics, with (+inf, -1) where fewer than k rows were scanned.
``delta=(vectors, ids)`` merges an append-only segment, scanned by brute
force, into the result; the base results come first, so ties keep the
base copy.

The JAX ``handle=`` and ``donate_queries=``, its approximate selects and
its compile-cache plumbing have no counterpart here.
"""

from __future__ import annotations

import warnings
from dataclasses import dataclass
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch.utils.weak import WeakIdKeyDictionary

from raft_tpu_torch.core import native, precision, tracing, tuning
from raft_tpu_torch.core.device import as_tensor, resolve_device
from raft_tpu_torch.core.error import expects
from raft_tpu_torch.core.utils import StageTimer, ceildiv, round_up_safe
from raft_tpu_torch.distance.distance_type import DistanceType
from raft_tpu_torch.distance.pairwise import expanded_sq_dists
from raft_tpu_torch.ops import pq_scan
from raft_tpu_torch.ops.ivf_tile import MAX_K, fused_ivf_scan
from raft_tpu_torch.spatial.select_k import select_k
from raft_tpu_torch.spectral.kmeans import kmeans

D = DistanceType

SCAN_IMPLS = tuning.candidates("ivf_scan_impl")
SQ_QTYPES = ("QT_8bit", "QT_8bit_uniform")
# device bytes a chunk of an IVF-PQ search may hold besides the index and
# the call's own probes and answers (pq_query_bytes; PERF.md has the card
# sweep it was taken from)
PQ_BUDGET_BYTES = 8 << 30
# counters of the IVF-PQ search (core.tracing): chunks searched, scan
# steps launched, bytes of lookup tables built
PQ_COUNTERS = ("ivf_pq_search.chunks", "ivf_pq_search.steps", "ivf_pq_search.table_bytes")
# counter of the IVF-PQ search's chunks that a kernel route (K7 or its
# wide route) scanned
PQ_KERNEL_CHUNKS = "ivf_pq_search.kernel_chunks"
# counter of the chunks that the wide route scanned
PQ_WIDE_CHUNKS = "ivf_pq_search.wide_chunks"
# counters of the wide route's table construction: the device-memory bytes
# it reads, a model from the launch geometry (pq_scan.wide_table_read_bytes),
# and the queries of those chunks
PQ_TABLE_READS = ("ivf_pq_search.table_read_bytes", "ivf_pq_search.table_read_queries")


@dataclass
class IVFFlatParams:
    nlist: int
    nprobe: int = 8


@dataclass
class IVFPQParams:
    nlist: int
    nprobe: int = 8
    M: int = 8             # subquantizers
    n_bits: int = 8        # log2 of the codebook size
    refine_ratio: int = 1  # > 1: keep the vectors, re-rank the top k * ratio exactly


@dataclass
class IVFSQParams:
    nlist: int
    nprobe: int = 8
    qtype: str = "QT_8bit"
    encode_residual: bool = True


class IVFFlatIndex(NamedTuple):
    centroids: torch.Tensor      # (nlist, d)
    slot_vecs: torch.Tensor      # (n_slots, cap, d) vectors, zero rows where vacant
    slot_ids: torch.Tensor       # (n_slots, cap) int32 global row ids, -1 vacant
    slot_centroid: torch.Tensor  # (n_slots,) int32 owning list of each slot
    cent_slots: torch.Tensor     # (nlist, max_slots) int32 slots per list, -1 pad
    list_sizes: torch.Tensor     # (nlist,) int32
    metric: DistanceType
    nprobe: int                  # default probe count from the build params
    slot_norms: Optional[torch.Tensor] = None  # (n_slots, cap) squared norms


class IVFPQIndex(NamedTuple):
    centroids: torch.Tensor      # (nlist, d) coarse
    codebooks: torch.Tensor      # (M, ksub, dsub) codewords, inf rows where padded
    slot_codes: torch.Tensor     # (n_slots, cap, M) int32 codes (row 0's where vacant)
    slot_ids: torch.Tensor       # (n_slots, cap) int32 global row ids, -1 vacant
    slot_centroid: torch.Tensor  # (n_slots,) int32
    cent_slots: torch.Tensor     # (nlist, max_slots) int32
    list_sizes: torch.Tensor     # (nlist,) int32
    metric: DistanceType
    nprobe: int
    vectors: Optional[torch.Tensor] = None  # (m, d), kept for refine_ratio > 1
    refine_ratio: int = 1


class IVFSQIndex(NamedTuple):
    centroids: torch.Tensor      # (nlist, d)
    slot_q: torch.Tensor         # (n_slots, cap, d) uint8 codes (row 0's where vacant)
    scale: torch.Tensor          # (d,) float32 dequantisation scale
    offset: torch.Tensor         # (d,) float32 dequantisation offset
    slot_ids: torch.Tensor
    slot_centroid: torch.Tensor
    cent_slots: torch.Tensor
    list_sizes: torch.Tensor
    metric: DistanceType
    nprobe: int
    encode_residual: bool        # the build's setting, honoured by the search


# --------------------------------------------------------------------- #
# coarse quantizer
# --------------------------------------------------------------------- #
def _assign_labels(X: torch.Tensor, centroids: torch.Tensor,
                   chunk: int = 131072) -> torch.Tensor:
    """Nearest-centroid assignment in row chunks: one (chunk, nlist)
    expanded-L2 matmul + argmin per chunk, int32 labels."""
    return torch.cat([torch.argmin(expanded_sq_dists(X[s:s + chunk], centroids), dim=1)
                      for s in range(0, X.shape[0], chunk)]).to(torch.int32)


def _coarse_assign(X: torch.Tensor, nlist: int, seed: int,
                   train_rows: Optional[int] = None):
    """k-means coarse quantizer + list assignment: (centroids, labels).

    ``train_rows`` trains k-means on a seeded row subsample (the rows of
    ``numpy.random.default_rng(seed).choice``, as in the JAX package) and
    assigns all rows in one chunked pass; ``None`` trains on all rows.
    """
    m = X.shape[0]
    if train_rows is not None and train_rows < m:
        expects(train_rows >= nlist, "_coarse_assign: train_rows=%d < nlist=%d",
                train_rows, nlist)
        with tracing.annotate("ivf_flat_build.subsample"):
            rows = np.sort(np.random.default_rng(seed).choice(m, train_rows, replace=False))
            sample = X[torch.from_numpy(rows).to(X.device)]
        res = kmeans(sample, nlist, seed=seed, max_iter=25, device=X.device)
        with tracing.annotate("ivf_flat_build.assign_all_rows"):
            return res.centroids, _assign_labels(X, res.centroids)
    res = kmeans(X, nlist, seed=seed, max_iter=25, device=X.device)
    return res.centroids, res.labels


# --------------------------------------------------------------------- #
# host packing
# --------------------------------------------------------------------- #
def _pack_lists(labels: np.ndarray, nlist: int) -> Tuple[np.ndarray, int]:
    """(nlist, max_len) row-id table, -1 padded, and max_len: the native
    ``rt_build_lists``, or the numpy route where there is no ``g++``."""
    nat = native.build_lists(labels, nlist)
    if nat is not None:
        return nat
    return _pack_lists_numpy(labels, nlist)


def _pack_lists_numpy(labels: np.ndarray, nlist: int) -> Tuple[np.ndarray, int]:
    """The numpy route of :func:`_pack_lists`."""
    counts = np.bincount(labels, minlength=nlist)
    max_len = max(int(counts.max()), 1)
    order = np.argsort(labels, kind="stable")
    starts = np.zeros(nlist + 1, np.int64)
    np.cumsum(counts, out=starts[1:])
    # position of each sorted row within its list
    within = np.arange(len(labels)) - starts[labels[order]]
    table = np.full((nlist, max_len), -1, np.int64)
    table[labels[order], within] = order
    return table, max_len


def _build_slots(labels: np.ndarray, nlist: int, cap: Optional[int] = None):
    """Cut each list into ``cap``-row slots (module doc).

    Returns (slot_rows (n_slots, cap) int32 row ids -1 padded,
    slot_centroid (n_slots,) int32, cent_slots (nlist, max_slots) int32
    slot ids -1 padded, cap, counts (nlist,)).
    """
    labels = np.asarray(labels)
    counts = np.bincount(labels, minlength=nlist)
    max_count = max(int(counts.max()), 1)
    if cap is None:
        mean = -(-len(labels) // nlist)
        cap = min(max_count, max(8, round_up_safe(mean, 8)))
    table, max_len = _pack_lists(labels, nlist)
    slots_per = -(-counts // cap)       # empty lists get no slot
    max_slots = max(int(slots_per.max()), 1)
    n_slots = int(slots_per.sum())
    tab = np.full((nlist, max_slots * cap), -1, np.int64)
    tab[:, :max_len] = table
    mask = np.arange(max_slots)[None, :] < slots_per[:, None]
    slot_rows = tab.reshape(nlist, max_slots, cap)[mask]
    slot_centroid = np.repeat(np.arange(nlist, dtype=np.int32), slots_per).astype(np.int32)
    cent_slots = np.full((nlist, max_slots), -1, np.int32)
    cent_slots[mask] = np.arange(n_slots, dtype=np.int32)
    return slot_rows.astype(np.int32), slot_centroid, cent_slots, cap, counts


def _extend_slot_layout(labels: np.ndarray, nlist: int, cap: int, slot_multiple: int):
    """The slot layout of an extend: :func:`_build_slots` at the index's
    ``cap``, then the slot count rounded up to ``slot_multiple`` and the
    per-list table width to a multiple of 8, so that repeated extends
    keep their shapes.  Padding slots hold ids -1 and no ``cent_slots``
    entry points at them.  Returns (slot_rows, slot_cent, cent_slots,
    counts)."""
    expects(slot_multiple >= 1, "_extend_slot_layout: slot_multiple=%d", slot_multiple)
    slot_rows, slot_cent, cent_slots, _, counts = _build_slots(labels, nlist, cap=cap)
    n_slots = slot_rows.shape[0]
    pad_slots = round_up_safe(max(n_slots, 1), slot_multiple) - n_slots
    if pad_slots:
        slot_rows = np.concatenate([slot_rows, np.full((pad_slots, cap), -1, slot_rows.dtype)])
        slot_cent = np.concatenate([slot_cent, np.zeros(pad_slots, slot_cent.dtype)])
    max_slots = cent_slots.shape[1]
    pad_width = round_up_safe(max(max_slots, 1), 8) - max_slots
    if pad_width:
        cent_slots = np.concatenate(
            [cent_slots, np.full((nlist, pad_width), -1, cent_slots.dtype)], axis=1)
    return slot_rows, slot_cent, cent_slots, counts


def _gather_slots(vecs: torch.Tensor, slot_rows: np.ndarray):
    """(slot_vecs, slot_rows as a tensor, slot_norms): the rows of
    ``vecs`` laid out in slots, zero where vacant."""
    rows = torch.from_numpy(slot_rows).to(vecs.device)
    slot_vecs = vecs[torch.clamp(rows, min=0).long()]
    slot_vecs[rows < 0] = 0
    return slot_vecs, rows, (slot_vecs * slot_vecs).sum(dim=-1)


# --------------------------------------------------------------------- #
# validation
# --------------------------------------------------------------------- #
_L2_METRICS = (D.L2Expanded, D.L2SqrtExpanded, D.L2Unexpanded, D.L2SqrtUnexpanded)
_SQRT_METRICS = (D.L2SqrtExpanded, D.L2SqrtUnexpanded)


def _check_metric(name, metric):
    expects(metric in _L2_METRICS,
            "%s: unsupported metric %d: the IVF quantizers are L2-only (the "
            "reference FAISS path likewise restricts the metric set, "
            "ann_quantized_faiss.cuh:94-118)", name, int(metric))


# entry points that already warned about a clamped nprobe (once each)
_NPROBE_CLAMP_WARNED = set()


def _validate_nprobe(name: str, nprobe, nlist: int) -> int:
    """A probe count of at least 1; above ``nlist`` it is clamped to
    ``nlist`` with a warning, once per entry point."""
    nprobe = int(nprobe)
    expects(nprobe >= 1, "%s: nprobe must be >= 1, got %d", name, nprobe)
    if nprobe > nlist:
        if name not in _NPROBE_CLAMP_WARNED:
            _NPROBE_CLAMP_WARNED.add(name)
            warnings.warn("%s: nprobe=%d exceeds nlist=%d; clamping to nlist "
                          "(reported once per entry point)" % (name, nprobe, nlist),
                          stacklevel=3)
        nprobe = nlist
    return nprobe


# --------------------------------------------------------------------- #
# probe and scan
# --------------------------------------------------------------------- #
def _probe_compact(q, centroids, cent_slots, nprobe, probes=None, ranks=False,
                   select_impl=None):
    """Probe selection + valid-first compaction of the scan lists, shared
    by every scan so that probe ties resolve alike.

    Returns (slots (nq, nprobe * max_slots) int32 valid first and -1
    padded, n_live a 0-d tensor: the most valid slots of any query), and
    with ``ranks`` also prank (the shape of slots, int32): the probe rank
    each slot belongs to, moved by the same stable sort.  A caller that
    selected its probes already (to build per-probe tables from them)
    passes the (nq, nprobe) ``probes``, so that the ranks and its tables
    agree.  ``select_impl`` is the probe select's route.
    """
    nq = q.shape[0]
    nlist, max_slots = cent_slots.shape
    if probes is None:
        _, probes = select_k(expanded_sq_dists(q, centroids), min(nprobe, nlist),
                             select_min=True, impl=select_impl, device=q.device)
    slots = cent_slots[probes.long()].reshape(nq, -1)
    _, order = torch.sort((slots < 0).to(torch.int32), dim=1, stable=True)
    slots = torch.gather(slots, 1, order)
    n_live = (slots >= 0).sum(dim=1).max()
    if not ranks:
        return slots, n_live
    # order // max_slots is the probe rank of the slot it moved
    return slots, torch.div(order, max_slots, rounding_mode="floor").to(torch.int32), n_live


def _probe_scan_search(q, centroids, cent_slots, step_dist, k, nprobe, metric, probes=None,
                       select_impl=None):
    """Probe, then scan the probed slots one step at a time with a running
    top-k.  ``step_dist(slx, pjx) -> (dist (nq, cap), ids (nq, cap))``
    computes one step given each query's slot ``slx`` and the probe rank
    ``pjx`` it belongs to (so that per-probe tables are read, not
    rebuilt); ``probes`` as in :func:`_probe_compact`.  The loop runs as
    many steps as the query with the most valid slots has."""
    slots, prank, n_live = _probe_compact(q, centroids, cent_slots, nprobe, probes, ranks=True,
                                          select_impl=select_impl)
    return _scan_steps(q, slots, prank, int(n_live), step_dist, k, metric, select_impl)


def _scan_steps(q, slots, prank, n_live, step_dist, k, metric, select_impl=None):
    """The step loop of :func:`_probe_scan_search` over compacted scan
    lists (``_probe_compact(..., ranks=True)``): ``n_live`` steps, each
    merged into the running top-k by ``select_k``.  A query past its own
    valid slots adds only (+inf, -1), which leave its running top-k as it
    is."""
    nq = q.shape[0]
    dt = torch.promote_types(q.dtype, torch.float32)
    run_d = torch.full((nq, k), float("inf"), dtype=dt, device=q.device)
    run_i = torch.full((nq, k), -1, dtype=torch.int32, device=q.device)
    for j in range(n_live):
        sl = slots[:, j]
        valid = sl >= 0
        dist, ids = step_dist(torch.where(valid, sl, 0).long(), prank[:, j].long())
        ids = torch.where(valid[:, None], ids, -1)
        dist = torch.where(ids >= 0, torch.clamp(dist, min=0.0), float("inf")).to(dt)
        run_d, run_i = select_k(torch.cat([run_d, dist], dim=1), k, select_min=True,
                                values=torch.cat([run_i, ids], dim=1), impl=select_impl,
                                device=q.device)
    if metric in _SQRT_METRICS:
        run_d = torch.sqrt(run_d)
    return run_d, run_i


# --------------------------------------------------------------------- #
# delta segment
# --------------------------------------------------------------------- #
def _delta_merge_impl(delta_vecs, delta_ids, base_d, base_i, q, k, sqrt, select_impl=None):
    """Brute-force scan of an append-only delta segment merged into a base
    result.  ``delta_ids < 0`` marks unfilled rows (+inf, never chosen).
    Base entries come first in the concatenation, so on exact ties the
    stable selection keeps the base copy."""
    qn = (q * q).sum(dim=1)
    dn = (delta_vecs * delta_vecs).sum(dim=1)
    dist = qn[:, None] + dn[None, :] - 2.0 * precision.matmul(q, delta_vecs.T)
    valid = delta_ids >= 0
    dist = torch.where(valid[None, :], torch.clamp(dist, min=0.0), float("inf")).to(base_d.dtype)
    if sqrt:
        # the base results are already square-rooted
        dist = torch.sqrt(dist)
    ids = torch.where(valid, delta_ids, -1).to(torch.int32)[None, :].expand(dist.shape)
    return select_k(torch.cat([base_d, dist], dim=1), k, select_min=True,
                    values=torch.cat([base_i.to(torch.int32), ids], dim=1), impl=select_impl,
                    device=q.device)


def _merge_delta(out, delta, q, k, metric, select_impl=None):
    """Merge the delta segment ``delta = (vectors, ids)`` into a search
    result."""
    delta_vecs = as_tensor(delta[0], q.device)
    delta_ids = as_tensor(delta[1], q.device, dtype=torch.int32)
    expects(delta_vecs.ndim == 2 and delta_vecs.shape[1] == q.shape[1],
            "ann delta segment: expected (rows, %d) vectors, got %r",
            q.shape[1], tuple(delta_vecs.shape))
    expects(tuple(delta_ids.shape) == (delta_vecs.shape[0],),
            "ann delta segment: ids shape %r does not match %d rows",
            tuple(delta_ids.shape), delta_vecs.shape[0])
    return _delta_merge_impl(delta_vecs, delta_ids, out[0], out[1], q, k,
                             metric in _SQRT_METRICS, select_impl)


# --------------------------------------------------------------------- #
# IVF-Flat
# --------------------------------------------------------------------- #
def ivf_flat_build(X, params: IVFFlatParams, metric: DistanceType = D.L2Expanded,
                   seed: int = 1234, train_rows: Optional[int] = None,
                   device="cuda") -> IVFFlatIndex:
    """Build an IVF-Flat index (reference approx_knn_build_index IVFFlat
    path, ann_quantized_faiss.cuh:129-141).  ``X`` (a numpy array or
    tensor) is moved to ``device``; ``train_rows`` opts into subsampled
    k-means training (:func:`_coarse_assign`)."""
    dev = resolve_device(device)
    X = as_tensor(X, dev)
    expects(X.ndim == 2, "ivf_flat_build: 2-D vectors required")
    expects(params.nlist <= X.shape[0], "ivf_flat_build: nlist > n_vectors")
    _check_metric("ivf_flat_build", metric)
    centroids, labels = _coarse_assign(X, params.nlist, seed, train_rows)
    with tracing.annotate("ivf_flat_build.host_packing"):
        slot_rows, slot_cent, cent_slots, _, counts = _build_slots(labels.cpu().numpy(),
                                                                   params.nlist)
    with tracing.annotate("ivf_flat_build.gather_slots"):
        slot_vecs, slot_ids, slot_norms = _gather_slots(X, slot_rows)
        return IVFFlatIndex(centroids, slot_vecs, slot_ids,
                            torch.from_numpy(slot_cent).to(dev),
                            torch.from_numpy(cent_slots).to(dev),
                            torch.from_numpy(counts.astype(np.int32)).to(dev), metric,
                            params.nprobe, slot_norms=slot_norms)


def _resolve_scan_impl(scan_impl, *, site, q, store_dtype, n, k, metric) -> str:
    """The scan route of one search: ``scan_impl``, else the
    ``ivf_scan_impl`` knob (module doc), else K3 on CUDA where it is
    legal (float32 queries and store, k <= its ``MAX_K``, an L2 metric)
    and the step scan otherwise.  Shared with the out-of-core search."""
    # the legality check sees a dtype other than float32 wherever one is
    dt = q.dtype if q.dtype != torch.float32 else store_dtype
    impl = tuning.resolve("ivf_scan_impl", scan_impl, site=site, dtype=dt, n=n, k=k,
                          d=q.shape[1], metric=_metric_family(metric), device=q.device.type)
    if impl is None:
        legal = (q.dtype == torch.float32 and store_dtype == torch.float32 and k <= MAX_K
                 and metric in _L2_METRICS)
        impl = "kernel" if legal and q.device.type == "cuda" else "scan"
    return impl


def _metric_family(metric) -> str:
    """The registry's metric string of an IVF metric (the quantizers are
    L2-only, so this is a two-way split)."""
    return "l2sqrt" if metric in _SQRT_METRICS else "l2"


def _ivf_flat_search_impl(centroids, slot_vecs, slot_norms, slot_ids, cent_slots, q, k,
                          nprobe, metric, scan_impl=None, select_impl=None):
    scan_impl = _resolve_scan_impl(scan_impl, site="ivf_flat_search", q=q,
                                  store_dtype=slot_vecs.dtype,
                                  n=slot_vecs.shape[0] * slot_vecs.shape[1], k=k, metric=metric)
    if scan_impl != "scan":
        with tracing.annotate("ivf_flat_search.probe"):
            slots, _ = _probe_compact(q, centroids, cent_slots, nprobe,
                                      select_impl=select_impl)
        dist, ids = fused_ivf_scan(q, slot_vecs, slot_norms.to(torch.float32), slot_ids,
                                   slots, k, accum_bf16=scan_impl == "kernel_bf16")
        if metric in _SQRT_METRICS:
            dist = torch.sqrt(dist)
        return dist, ids

    qn = (q * q).sum(dim=1)

    def step_dist(slx, _pjx):
        vecs = slot_vecs[slx]                                  # (nq, cap, d)
        dot = precision.bmm(vecs, q[:, :, None].to(vecs.dtype))[:, :, 0]
        return qn[:, None] + slot_norms[slx] - 2.0 * dot, slot_ids[slx]

    return _probe_scan_search(q, centroids, cent_slots, step_dist, k, nprobe, metric,
                              select_impl=select_impl)


def _on_device(index: IVFFlatIndex, dev: torch.device):
    """The index's arrays on ``dev`` (no copy where they are there)."""
    norms = index.slot_norms
    if norms is None:
        norms = (index.slot_vecs * index.slot_vecs).sum(dim=-1)
    return [as_tensor(a, dev) for a in (index.centroids, index.slot_vecs, norms,
                                        index.slot_ids, index.cent_slots)]


def ivf_flat_search(index: IVFFlatIndex, queries, k: int, nprobe: Optional[int] = None, *,
                    delta=None, scan_impl: Optional[str] = None,
                    select_impl: Optional[str] = None,
                    device="cuda") -> Tuple[torch.Tensor, torch.Tensor]:
    """Search an IVF-Flat index (reference approx_knn_search, ann.hpp:71).

    ``nprobe`` defaults to the build params' value and is clamped to
    nlist; ``delta=(vectors, ids)`` merges an append-only segment;
    ``scan_impl`` is ``"kernel"``, ``"kernel_bf16"``, ``"scan"`` or None
    and ``select_impl`` ``"kernel"``, ``"sort"`` or None (module doc).  Queries and the index are moved to ``device``.
    Returns (n_queries, k) distances and int32 ids, best-first.
    """
    dev = resolve_device(device)
    q = as_tensor(queries, dev)
    expects(q.ndim == 2 and q.shape[1] == index.centroids.shape[1],
            "ivf_flat_search: expected (n_queries, %d) queries, got %r",
            int(index.centroids.shape[1]), tuple(q.shape))
    nprobe = _validate_nprobe("ivf_flat_search", index.nprobe if nprobe is None else nprobe,
                              int(index.centroids.shape[0]))
    metric = DistanceType(int(index.metric))
    out = _ivf_flat_search_impl(*_on_device(index, dev), q, k, nprobe, metric,
                                scan_impl=scan_impl, select_impl=select_impl)
    if delta is not None:
        out = _merge_delta(out, delta, q, k, metric, select_impl)
    return out


def ivf_flat_reconstruct(index: IVFFlatIndex) -> Tuple[np.ndarray, np.ndarray]:
    """The stored (vectors, int64 ids), valid rows only, in slot order:
    the exact inverse of the build's gather."""
    ids = index.slot_ids.cpu().numpy().reshape(-1)
    mask = ids >= 0
    vecs = index.slot_vecs.cpu().numpy().reshape(-1, index.slot_vecs.shape[-1])
    return vecs[mask], ids[mask].astype(np.int64)


def ivf_flat_extend(index: IVFFlatIndex, vectors, ids, *, slot_multiple: int = 64,
                    device="cuda") -> IVFFlatIndex:
    """Fold new rows into an IVF-Flat index without re-running k-means:
    each new vector joins its nearest existing centroid's list, and the
    slots are rebuilt over old and new rows.

    Centroids, metric, default nprobe and ``cap`` are kept; ``ids`` are
    the new rows' global ids (keeping them distinct is the caller's
    contract).  ``slot_multiple`` rounds the slot count (and the per-list
    slot table width, to a multiple of 8) up, so that successive extends
    keep their shapes; padding slots are never probed.
    """
    expects(slot_multiple >= 1, "ivf_flat_extend: slot_multiple=%d", slot_multiple)
    dev = resolve_device(device)
    new_vecs = as_tensor(vectors, dev)
    expects(new_vecs.ndim == 2 and new_vecs.shape[1] == index.centroids.shape[1],
            "ivf_flat_extend: expected (rows, %d) vectors, got %r",
            int(index.centroids.shape[1]), tuple(new_vecs.shape))
    new_ids = np.asarray(ids, np.int64).ravel()
    expects(new_ids.shape[0] == new_vecs.shape[0], "ivf_flat_extend: %d ids for %d vectors",
            new_ids.shape[0], new_vecs.shape[0])
    centroids = as_tensor(index.centroids, dev)
    nlist = int(centroids.shape[0])
    cap = int(index.slot_vecs.shape[1])

    old_vecs, old_ids = ivf_flat_reconstruct(index)
    old_labels = np.repeat(index.slot_centroid.cpu().numpy(), cap)[
        index.slot_ids.cpu().numpy().reshape(-1) >= 0].astype(np.int64)
    all_vecs = torch.cat([torch.from_numpy(old_vecs).to(dev),
                          new_vecs.to(index.slot_vecs.dtype)])
    all_ids = np.concatenate([old_ids, new_ids])
    labels = old_labels
    if new_vecs.shape[0]:
        new_labels = _assign_labels(new_vecs, centroids).cpu().numpy().astype(np.int64)
        labels = np.concatenate([old_labels, new_labels])

    slot_rows, slot_cent, cent_slots, counts = _extend_slot_layout(labels, nlist, cap,
                                                                   slot_multiple)
    slot_vecs, rows, slot_norms = _gather_slots(all_vecs, slot_rows)
    id_table = torch.from_numpy(all_ids.astype(np.int32)).to(dev)
    slot_ids = torch.where(rows >= 0, id_table[torch.clamp(rows, min=0).long()], -1)
    return IVFFlatIndex(centroids, slot_vecs, slot_ids.to(torch.int32),
                        torch.from_numpy(slot_cent).to(dev), torch.from_numpy(cent_slots).to(dev),
                        torch.from_numpy(counts.astype(np.int32)).to(dev), index.metric,
                        index.nprobe, slot_norms=slot_norms)


# --------------------------------------------------------------------- #
# IVF-PQ
# --------------------------------------------------------------------- #
def _slot_gather(table: torch.Tensor, slot_rows: np.ndarray):
    """(slot_rows as a tensor, the rows of ``table`` laid out in slots):
    vacant entries take row 0, as the JAX build's gather does."""
    rows = torch.from_numpy(slot_rows).to(table.device)
    return rows, table[torch.clamp(rows, min=0).long()]


def ivf_pq_build(X, params: IVFPQParams, metric: DistanceType = D.L2Expanded,
                 seed: int = 1234, train_rows: Optional[int] = None, device="cuda",
                 stages: Optional[dict] = None) -> IVFPQIndex:
    """Build an IVF-PQ index (reference IVFPQ path,
    ann_quantized_faiss.cuh:143-160): the coarse quantizer, then one
    k-means codebook per subspace of the residuals (``kmeans(sub,
    min(2 ** n_bits, m), seed=seed + mi, max_iter=20)``), padded with
    ``inf`` rows to ``2 ** n_bits``.  ``stages`` (a dict) receives the
    milliseconds of ``coarse``, ``codebooks`` and ``packing``."""
    dev = resolve_device(device)
    X = as_tensor(X, dev)
    expects(X.ndim == 2, "ivf_pq_build: 2-D vectors required")
    m, d = X.shape
    M, ksub = params.M, 2 ** params.n_bits
    expects(d % M == 0, "ivf_pq_build: dim %d not divisible by M=%d", d, M)
    expects(params.nlist <= m, "ivf_pq_build: nlist > n_vectors")
    _check_metric("ivf_pq_build", metric)
    dsub = d // M
    timer = StageTimer(stages, dev)
    centroids, labels = _coarse_assign(X, params.nlist, seed, train_rows)
    timer.done("coarse")
    with tracing.annotate("ivf_pq_build.codebooks"):
        resid = X - centroids[labels.long()]
        kk = min(ksub, m)
        books, codes = [], []
        for mi in range(M):
            res = kmeans(resid[:, mi * dsub:(mi + 1) * dsub], kk, seed=seed + mi, max_iter=20,
                         device=dev)
            cb = res.centroids
            if kk < ksub:
                cb = torch.cat([cb, torch.full((ksub - kk, dsub), float("inf"), dtype=cb.dtype,
                                               device=dev)])
            books.append(cb)
            codes.append(res.labels)
        del resid
    timer.done("codebooks")
    with tracing.annotate("ivf_pq_build.host_packing"):
        slot_rows, slot_cent, cent_slots, _, counts = _build_slots(labels.cpu().numpy(),
                                                                   params.nlist)
        rows, slot_codes = _slot_gather(torch.stack(codes, dim=1), slot_rows)
    ratio = max(int(params.refine_ratio), 1)
    out = IVFPQIndex(centroids, torch.stack(books), slot_codes, rows,
                     torch.from_numpy(slot_cent).to(dev), torch.from_numpy(cent_slots).to(dev),
                     torch.from_numpy(counts.astype(np.int32)).to(dev), metric, params.nprobe,
                     vectors=X if ratio > 1 else None, refine_ratio=ratio)
    timer.done("packing")
    return out


def _pq_tables(q, centroids, codebooks, probes):
    """The ADC lookup tables of each query's probed lists: (nq, nprobe, M,
    ksub) squared distances of the query's residual subvectors to the
    codewords, one batched product for all of them."""
    M, ksub, dsub = codebooks.shape
    nq, n_probe = probes.shape
    rs = (q[:, None, :] - centroids[probes.long()]).reshape(nq * n_probe, M, dsub)
    prod = precision.bmm(rs.transpose(0, 1), codebooks.transpose(1, 2))   # (M, nq*np, ksub)
    cb_norms = (codebooks * codebooks).sum(dim=-1)                          # (M, ksub)
    lut = (rs * rs).sum(dim=-1)[:, :, None] + cb_norms[None] - 2.0 * prod.transpose(0, 1)
    return lut.reshape(nq, n_probe, M, ksub)


def pq_query_bytes(nprobe: int, M: int, ksub: int, cap: int, kk: int, d: int,
                   refine: bool, kernel: bool = False) -> int:
    """The most device bytes one query holds in a chunk of an IVF-PQ search
    (4 a float32 or int32, 8 an int64).  On a kernel route (``kernel``:
    K7 or its wide route) the tables never leave the chip: the larger of
    the ``kk`` candidates the kernel writes and the re-rank.  On the step
    scan's, the largest of its three phases:

    - building its tables (:func:`_pq_tables`): the residuals, gathered
      centroids and squares, ``nprobe * d`` each; the batched product, the
      norm term, the doubled product and the tables, ``nprobe * M * ksub``
      each;
    - a scan step with its tables alive: the table of the slot's probe,
      the slot's codes as int32 and as int64, the gathered table values,
      six ``cap``-wide rows (sums, ids, masks, distances), and two
      generations of the running select over ``kk + cap`` keys (keys and
      payloads concatenated, the sort's values and int64 positions);
    - the re-rank (``refine``): the ``kk`` candidates' vectors, their
      difference and its square, and the candidates' distances and ids.
    """
    table = 4 * nprobe * M * ksub
    build = 4 * table + 3 * 4 * nprobe * d
    step = (4 * M * ksub + (4 + 8 + 4) * M * cap + 6 * 4 * cap
            + 2 * (8 + 12) * (kk + cap) + 8 * kk)
    rerank = 3 * 4 * kk * d + 16 * kk if refine else 0
    if kernel:
        return max(8 * kk, rerank)
    return max(build, table + step, rerank)


def _pq_chunk_rows(nq: int, k: int, nprobe: int, per_query: int) -> int:
    """Queries a chunk of an IVF-PQ search takes: the call's own probes
    and answers come off :data:`PQ_BUDGET_BYTES`, the rest is shared by
    the chunk's queries at ``per_query`` bytes each (at least one query),
    and the call's chunks are as even as they can be."""
    spare = PQ_BUDGET_BYTES - nq * (4 * nprobe + 8 * k)
    rows = max(1, spare // per_query)
    return max(1, ceildiv(nq, max(1, ceildiv(nq, rows))))


def _pq_probe_dists(q, centroids):
    """The squared distances the IVF-PQ probe selects from: the expanded
    form in float64, rounded to the queries' float type.  The float32
    form's rounding grows as about sqrt(d) x 6e-8 of |q|^2 + |c|^2, so at
    gist-960's depth a query could probe a list that lies past the 50th
    by more than 1e-6 of that scale."""
    return expanded_sq_dists(q.double(), centroids.double()).to(
        torch.promote_types(q.dtype, torch.float32))


# the wide route's operands that depend on the index alone, made at its
# first wide search and kept while its device tensors live, keyed by its
# codes: (centroids, codebooks, the three tensors' versions, the codes
# chunk-major, the list terms)
_WIDE_OPERANDS = WeakIdKeyDictionary()


def _wide_operands(centroids, codebooks, slot_codes):
    """The wide route's codes (``pq_scan.narrow_codes`` with ``wide``)
    and list terms (``pq_scan.wide_terms``) of an index, made again
    where its centroids, codebooks or codes are other tensors or were
    written since."""
    versions = (centroids._version, codebooks._version, slot_codes._version)
    kept = _WIDE_OPERANDS.get(slot_codes)
    if kept is None or kept[0] is not centroids or kept[1] is not codebooks or kept[2] != versions:
        kept = (centroids, codebooks, versions, pq_scan.narrow_codes(slot_codes, wide=True),
                pq_scan.wide_terms(centroids, codebooks))
        _WIDE_OPERANDS[slot_codes] = kept
    return kept[3:]


def _pq_route(q, centroids, codebooks, k, nprobe, max_slots, metric) -> str:
    """``"kernel"`` (K7), ``"wide"`` (its wide route) or ``"step"`` (the
    step scan): the first route whose legality rule takes the call."""
    if metric not in _L2_METRICS:
        return "step"
    if pq_scan.takes(q, centroids, codebooks, k, nprobe, max_slots):
        return "kernel"
    if pq_scan.takes_wide(q, centroids, codebooks, k, nprobe, max_slots):
        return "wide"
    return "step"


def _ivf_pq_search_impl(centroids, codebooks, slot_codes, slot_ids, cent_slots, q, k, nprobe,
                        metric, refine=None, select_impl=None):
    """The chunked search (module doc): ``k`` ADC candidates a query, or
    with ``refine = (vectors, k_out)`` the ``k`` candidates re-ranked
    exactly to ``k_out``."""
    nq, d = q.shape
    M, ksub = codebooks.shape[:2]
    max_slots = cent_slots.shape[1]
    cap = slot_ids.shape[1]
    k_out = k if refine is None else refine[1]
    sqrt = metric in _SQRT_METRICS
    route = _pq_route(q, centroids, codebooks, k, nprobe, max_slots, metric)
    kernel, wide = route != "step", route == "wide"
    with tracing.annotate("ivf_pq_search.probe"):
        _, probes = select_k(_pq_probe_dists(q, centroids), nprobe, select_min=True,
                             impl=select_impl, device=q.device)
        if not kernel:
            live = (cent_slots[probes.long()] >= 0).sum(dim=(1, 2))
    rows = _pq_chunk_rows(nq, k_out, nprobe,
                          pq_query_bytes(nprobe, M, ksub, cap, k, d, refine is not None, kernel))
    starts = range(0, nq, rows)
    if kernel:
        # the kernels need no step counts; K7's codes narrowed once a
        # call, the wide route's codes and terms once an index
        steps = [0] * len(starts)
        with tracing.annotate("ivf_pq_search.scan"):
            if wide:
                codes, terms = _wide_operands(centroids, codebooks, slot_codes)
            else:
                codes = pq_scan.narrow_codes(slot_codes)
    else:
        # one read of every chunk's step count: the chunks then queue unbroken
        steps = torch.nn.functional.pad(live, (0, len(starts) * rows - nq)).reshape(
            len(starts), rows).amax(dim=1).tolist()
        codes = slot_codes
    dt = torch.promote_types(q.dtype, torch.float32)
    out_d = torch.empty((nq, k_out), dtype=dt, device=q.device)
    out_i = torch.empty((nq, k_out), dtype=torch.int32, device=q.device)
    for s, n_live in zip(starts, steps):
        qc, pc = q[s:s + rows], probes[s:s + rows]
        tracing.counter_inc(PQ_COUNTERS[0])
        tracing.counter_inc(PQ_COUNTERS[1], n_live)
        tracing.counter_inc(PQ_COUNTERS[2], qc.shape[0] * nprobe * M * ksub * dt.itemsize)
        if kernel:
            tracing.counter_inc(PQ_KERNEL_CHUNKS)
            if wide:
                tracing.counter_inc(PQ_WIDE_CHUNKS)
                tracing.counter_inc(PQ_TABLE_READS[0], pq_scan.wide_table_read_bytes(
                    qc.shape[0], d, ksub, M, nprobe))
                tracing.counter_inc(PQ_TABLE_READS[1], qc.shape[0])
            with tracing.annotate("ivf_pq_search.scan"):
                if wide:
                    dist, ids = pq_scan.ivf_pq_scan_wide(qc, centroids, codebooks, codes, terms,
                                                         slot_ids, cent_slots, pc, k)
                else:
                    dist, ids = pq_scan.ivf_pq_scan(qc, centroids, codebooks, codes, slot_ids,
                                                    cent_slots, pc, k)
        else:
            dist, ids = pq_scan.ivf_pq_scan_plain(qc, centroids, codebooks, codes, slot_ids,
                                                  cent_slots, pc, k, n_live, select_impl)
        if refine is not None:
            with tracing.annotate("ivf_pq_search.refine"):
                dist, ids = _refine_impl(refine[0], qc, ids, k_out, sqrt, select_impl)
        elif sqrt:
            dist = torch.sqrt(dist)
        out_d[s:s + rows] = dist
        out_i[s:s + rows] = ids
    return out_d, out_i


def _refine_impl(vectors, q, cand_ids, k, sqrt, select_impl=None):
    """Exact re-rank of the ADC candidates against the stored vectors (the
    quality half of FAISS's IndexRefineFlat)."""
    valid = cand_ids >= 0
    vecs = vectors[torch.where(valid, cand_ids, 0).long()]     # (nq, k2, d)
    diff = vecs - q[:, None, :]
    dist = torch.where(valid, (diff * diff).sum(dim=-1), float("inf"))
    out_d, out_i = select_k(dist, k, select_min=True, values=cand_ids, impl=select_impl,
                            device=q.device)
    return (torch.sqrt(out_d) if sqrt else out_d), out_i


def ivf_pq_search(index: IVFPQIndex, queries, k: int, nprobe: Optional[int] = None,
                  refine_ratio: Optional[int] = None, *, delta=None,
                  select_impl: Optional[str] = None,
                  device="cuda") -> Tuple[torch.Tensor, torch.Tensor]:
    """ADC search of an IVF-PQ index; where the index holds its vectors and
    ``refine_ratio`` (default: the build's) is > 1, the top ``k *
    refine_ratio`` ADC candidates are re-ranked exactly; ``nprobe``,
    ``delta``, ``select_impl`` and ``device`` as in :func:`ivf_flat_search`.
    The queries go through in chunks under :data:`PQ_BUDGET_BYTES`
    (module doc); a query's answer is the same whatever its chunk."""
    dev = resolve_device(device)
    q = as_tensor(queries, dev)
    expects(q.ndim == 2 and q.shape[1] == index.centroids.shape[1],
            "ivf_pq_search: expected (n_queries, %d) queries, got %r",
            int(index.centroids.shape[1]), tuple(q.shape))
    nprobe = _validate_nprobe("ivf_pq_search", index.nprobe if nprobe is None else nprobe,
                              int(index.centroids.shape[0]))
    ratio = max(int(index.refine_ratio if refine_ratio is None else refine_ratio), 1)
    refine = ratio > 1 and index.vectors is not None
    metric = DistanceType(int(index.metric))
    arrays = [as_tensor(a, dev) for a in (index.centroids, index.codebooks, index.slot_codes,
                                          index.slot_ids, index.cent_slots)]
    out = _ivf_pq_search_impl(*arrays, q, k * ratio if refine else k, nprobe, metric,
                              (as_tensor(index.vectors, dev), k) if refine else None,
                              select_impl)
    if delta is not None:
        out = _merge_delta(out, delta, q, k, metric, select_impl)
    return out


# --------------------------------------------------------------------- #
# IVF-SQ
# --------------------------------------------------------------------- #
def ivf_sq_build(X, params: IVFSQParams, metric: DistanceType = D.L2Expanded,
                 seed: int = 1234, train_rows: Optional[int] = None,
                 device="cuda") -> IVFSQIndex:
    """8-bit scalar quantization of the residuals (or of the vectors
    without ``encode_residual``; reference IVFSQ path,
    ann_quantized_faiss.cuh:162-176): per dimension (``QT_8bit``) or one
    (``QT_8bit_uniform``) range ``[lo, hi]`` cut into 255 steps."""
    expects(params.qtype in SQ_QTYPES, "ivf_sq_build: unsupported qtype %s", params.qtype)
    _check_metric("ivf_sq_build", metric)
    dev = resolve_device(device)
    X = as_tensor(X, dev)
    expects(X.ndim == 2, "ivf_sq_build: 2-D vectors required")
    expects(params.nlist <= X.shape[0], "ivf_sq_build: nlist > n_vectors")
    centroids, labels = _coarse_assign(X, params.nlist, seed, train_rows)
    with tracing.annotate("ivf_sq_build.quantize"):
        resid = X - centroids[labels.long()] if params.encode_residual else X
        lo, hi = resid.min(dim=0).values, resid.max(dim=0).values
        if params.qtype == "QT_8bit_uniform":
            lo, hi = torch.full_like(lo, lo.min()), torch.full_like(hi, hi.max())
        scale = (hi - lo) / 255.0
        scale = torch.where(scale == 0, 1.0, scale)
        codes = torch.clamp(torch.round((resid - lo) / scale), 0, 255).to(torch.uint8)
        del resid
    with tracing.annotate("ivf_sq_build.host_packing"):
        slot_rows, slot_cent, cent_slots, _, counts = _build_slots(labels.cpu().numpy(),
                                                                   params.nlist)
        rows, slot_q = _slot_gather(codes, slot_rows)
    return IVFSQIndex(centroids, slot_q, scale, lo, rows, torch.from_numpy(slot_cent).to(dev),
                      torch.from_numpy(cent_slots).to(dev),
                      torch.from_numpy(counts.astype(np.int32)).to(dev), metric, params.nprobe,
                      bool(params.encode_residual))


def _ivf_sq_search_impl(centroids, slot_q, scale, offset, slot_ids, slot_centroid, cent_slots,
                        q, k, nprobe, encode_residual, metric, select_impl=None):
    qn = (q * q).sum(dim=1)

    def step_dist(slx, _pjx):
        # dequantise the probed slot only: the store stays uint8
        deq = slot_q[slx].to(torch.float32) * scale + offset               # (nq, cap, d)
        if encode_residual:
            deq = deq + centroids[slot_centroid[slx].long()][:, None, :]
        dot = precision.bmm(deq, q[:, :, None].to(deq.dtype))[:, :, 0]
        return qn[:, None] + (deq * deq).sum(dim=-1) - 2.0 * dot, slot_ids[slx]

    return _probe_scan_search(q, centroids, cent_slots, step_dist, k, nprobe, metric,
                              select_impl=select_impl)


def ivf_sq_search(index: IVFSQIndex, queries, k: int, nprobe: Optional[int] = None, *,
                  delta=None, select_impl: Optional[str] = None,
                  device="cuda") -> Tuple[torch.Tensor, torch.Tensor]:
    """Search an IVF-SQ index, honouring the build's ``encode_residual``;
    ``nprobe``, ``delta``, ``select_impl`` and ``device`` as in
    :func:`ivf_flat_search`."""
    dev = resolve_device(device)
    q = as_tensor(queries, dev)
    expects(q.ndim == 2 and q.shape[1] == index.centroids.shape[1],
            "ivf_sq_search: expected (n_queries, %d) queries, got %r",
            int(index.centroids.shape[1]), tuple(q.shape))
    nprobe = _validate_nprobe("ivf_sq_search", index.nprobe if nprobe is None else nprobe,
                              int(index.centroids.shape[0]))
    metric = DistanceType(int(index.metric))
    arrays = [as_tensor(a, dev) for a in (index.centroids, index.slot_q, index.scale,
                                          index.offset, index.slot_ids, index.slot_centroid,
                                          index.cent_slots)]
    out = _ivf_sq_search_impl(*arrays, q, k, nprobe, bool(index.encode_residual), metric,
                              select_impl)
    if delta is not None:
        out = _merge_delta(out, delta, q, k, metric, select_impl)
    return out


# --------------------------------------------------------------------- #
# dispatch (reference ann.hpp:45,71)
# --------------------------------------------------------------------- #
def approx_knn_build_index(X, params, metric: DistanceType = D.L2Expanded, seed: int = 1234,
                           train_rows: Optional[int] = None, device="cuda"):
    """Build the index that ``params`` names (IVF-Flat, IVF-PQ or IVF-SQ)."""
    if isinstance(params, IVFPQParams):
        return ivf_pq_build(X, params, metric, seed, train_rows=train_rows, device=device)
    if isinstance(params, IVFSQParams):
        return ivf_sq_build(X, params, metric, seed, train_rows=train_rows, device=device)
    if isinstance(params, IVFFlatParams):
        return ivf_flat_build(X, params, metric, seed, train_rows=train_rows, device=device)
    raise TypeError(f"unknown ANN params {type(params)}")


def approx_knn_search(index, queries, k: int, nprobe: Optional[int] = None,
                      refine_ratio: Optional[int] = None, *, delta=None,
                      scan_impl: Optional[str] = None, select_impl: Optional[str] = None,
                      device="cuda"):
    """Search an index by its type: ``refine_ratio`` reaches IVF-PQ only
    (IVF-Flat and IVF-SQ ignore it), ``scan_impl`` IVF-Flat only, and
    ``select_impl`` every kind (see :func:`ivf_flat_search` and
    :func:`ivf_pq_search`)."""
    if isinstance(index, IVFPQIndex):
        return ivf_pq_search(index, queries, k, nprobe, refine_ratio, delta=delta,
                             select_impl=select_impl, device=device)
    if isinstance(index, IVFSQIndex):
        return ivf_sq_search(index, queries, k, nprobe, delta=delta, select_impl=select_impl,
                             device=device)
    if isinstance(index, IVFFlatIndex):
        return ivf_flat_search(index, queries, k, nprobe, delta=delta, scan_impl=scan_impl,
                               select_impl=select_impl, device=device)
    raise TypeError(f"unknown ANN index {type(index)}")
