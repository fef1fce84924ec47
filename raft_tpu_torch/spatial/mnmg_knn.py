"""Multi-node multi-device kNN over a mesh axis: the sharded search.

Port of ``raft_tpu/spatial/mnmg_knn.py`` (reference: the MNMG mode of
``brute_force_knn``: each rank searches its row partition of the index,
then the results merge through the injected communicator, ``comms_t``,
comms.hpp:193, and ``knn_merge_parts``,
detail/knn_brute_force_faiss.cuh:55).  This is ``BASELINE.md`` config #5
as a callable function.

The JAX package runs one SPMD program over a ``jax.sharding.Mesh``; the
port runs the same steps from one process over a rank mesh
(:class:`~raft_tpu_torch.comms.mesh.Mesh`, whose rank slots may share a
card):

- the index is row-sharded over ``axis`` (:func:`shard_knn_index`; on a
  card the shards are views of the index, no copy), queries are
  replicated, or sharded over an optional second ``query_axis`` (the 2-D
  sub-communicator pattern of the reference's ``handle.set_subcomm``);
- each rank runs the local search of
  :func:`raft_tpu_torch.spatial.knn._search_one_partition` on its shard
  (K1 for the L2 family on the card) and translates its ids to global
  ones by its shard's first row;
- the cross-shard merge is a topology (:func:`_merge_topk`).  In the
  SPMD program every rank of a line ends with the same result; the one
  controller computes it once, for the line's first rank, from the
  blocks that rank receives, in the order it receives them:

  * ``"allgather"``: every rank gathers every shard's candidates and
    re-selects the global top-k;
  * ``"ring"``: candidate blocks stream around the axis with a running
    top-k, (nq, 2k) at a time;
  * ``"hierarchical"``: an allgather within groups of ``group_size``
    ranks, a ring across the groups (HiCCL's decomposition applied to
    the merge); the group size resolves from placement
    (:func:`raft_tpu_torch.comms.host_comms.axis_host_group_size`: the
    slots a process holds, None in one process) and falls back to the
    divisor of the axis size nearest its square root.

  Every re-selection is K2 (:func:`~raft_tpu_torch.spatial.select_k.select_k`)
  over candidates put in global-id order first, so ties order by
  (distance, global id) at every level: the three topologies keep the
  same survivors, and their results are equal bit for bit, ids included.

Besides the brute-force search this module owns the slot-sharded IVF-Flat
search behind the sharded ``ANNService``: :func:`shard_ivf_flat_index`
and :func:`mnmg_ivf_flat_search`.  Each rank probes the replicated
centroids (K2) and scans only the probed slots it owns, on K3 (the way
:mod:`raft_tpu_torch.spatial.ooc` scans a part; outside K3's limits, k
above its ``MAX_K`` or a store that is not float32, on the resident
search's step scan), then the same merges run.  The IVF quantizers are
L2-only, as in :mod:`raft_tpu_torch.spatial.ann`.

**Across processes** (a mesh that spans processes, built by a
multi-process session): every process makes the same call; the shard
functions place only this process's shards (a remote rank's entry is
None), each process searches its own ranks only, and :func:`_merge_line`,
the one point both searches merge through, first brings every remote
rank's (distances, ids) block to every process with one exchange of each
process's blocks in rank-id order
(:meth:`~raft_tpu_torch.comms.dist.ProcessGroup.exchange`).  Every
process then runs the same merge, so each ends with the whole result,
bitwise the one a world of the same slots gives in one process, for all
three topologies.  The ring and the hierarchy are merge orders here, not
wire patterns: every block crosses the wire once, in the exchange.

The communicator resolves from (in order) an explicit ``comms``, the
``handle``'s injected comms, an explicit ``mesh``/``axis`` pair, the
handle's mesh, or the default mesh of ``device`` (one rank a visible
card).  Results land on the first rank's device.  The merge topology
resolves through the candidate registry (``mnmg_merge``:
:func:`raft_tpu_torch.core.tuning.resolve`, the tuning table on the
(devices, n, k) shape class included); ``mnmg_ivf_flat_search``'s
``select_impl`` pins the route of every probe and merge select
(``"kernel"`` or ``"sort"``, both exact, so the topologies stay bitwise
equal).  The JAX donating twins and ``profiled_jit`` have no
counterpart.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from raft_tpu_torch.comms.dist import Remote
from raft_tpu_torch.comms.host_comms import axis_host_group_size
from raft_tpu_torch.comms.mesh import Mesh, as_mesh, default_mesh
from raft_tpu_torch.core import precision, tuning
from raft_tpu_torch.core.device import as_tensor
from raft_tpu_torch.core.error import expects
from raft_tpu_torch.core.utils import ceildiv
from raft_tpu_torch.distance.distance_type import DistanceType
from raft_tpu_torch.ops.ivf_tile import MAX_K as K3_MAX_K
from raft_tpu_torch.ops.ivf_tile import fused_ivf_scan
from raft_tpu_torch.spatial.knn import _IP_FAMILY, _search_one_partition
from raft_tpu_torch.spatial.select_k import select_k

D = DistanceType

__all__ = ["MERGE_TOPOLOGIES", "ShardedIVFFlat", "ShardedRows", "mnmg_ivf_flat_search",
           "mnmg_knn", "resolve_group_size", "resolve_merge", "shard_ivf_flat_index",
           "shard_knn_index"]

MERGE_TOPOLOGIES = tuning.candidates("mnmg_merge")
_SQRT = (D.L2SqrtExpanded, D.L2SqrtUnexpanded)


def _resolve_comms(handle, comms, mesh, axis, device) -> Tuple[Mesh, str]:
    """(mesh, axis) from the strongest available source (module doc)."""
    if comms is not None:
        return comms.mesh, comms.axis
    if handle is not None and handle.comms_initialized():
        c = handle.get_comms()
        return c.mesh, c.axis
    if mesh is not None:
        mesh = as_mesh(mesh)
        expects(axis is not None and axis in mesh.axis_names,
                "mnmg_knn: axis must name an axis of the given mesh")
        return mesh, axis
    if handle is not None and handle.mesh is not None:
        m = handle.mesh
        if axis is None:
            return m, m.axis_names[0]
        expects(axis in m.axis_names, "mnmg_knn: axis %s not in the handle's mesh", axis)
        return m, axis
    m = default_mesh(device="cuda" if device is None else device)
    expects(axis is None or axis in m.axis_names,
            "mnmg_knn: axis %s given without a mesh that has it", axis)
    return m, m.axis_names[0]


def resolve_merge(merge: Optional[str], *, devices: Optional[int] = None,
                  n: Optional[int] = None, k: Optional[int] = None) -> str:
    """The merge topology: the explicit argument, else the ``mnmg_merge``
    knob (override, configure, env ``RAFT_TPU_MNMG_MERGE``, the tuning
    table on the (devices, n, k) shape class, default)."""
    return tuning.resolve("mnmg_merge", merge, site="mnmg_knn", devices=devices, n=n, k=k)


def resolve_group_size(mesh: Mesh, axis: str, group_size: Optional[int] = None) -> int:
    """Group size of the hierarchical merge: an explicit one must divide
    the axis size; None resolves from placement
    (:func:`axis_host_group_size`) and falls back to the divisor of the
    axis size nearest its square root (equal fan-in at both levels)."""
    size = int(mesh.shape[axis])
    if group_size is not None:
        return int(tuning.check("mnmg_group_size", group_size, site="mnmg_knn",
                                explicit=True, axis_size=size))
    g = axis_host_group_size(mesh, axis)
    if g is not None and size % g == 0:
        return g
    root = size ** 0.5
    return min((d for d in range(1, size + 1) if size % d == 0),
               key=lambda d: (abs(d - root), d))


# --------------------------------------------------------------------- #
# the cross-shard top-k merge (shared by the brute-force and IVF paths)
# --------------------------------------------------------------------- #
def _select_ordered(d: torch.Tensor, i: torch.Tensor, k: int, select_min: bool,
                    select_impl=None):
    """The k best candidates of each row, ties to the smaller global id:
    the columns put in id order first (a stable sort), then the select
    (K2 or the stable sort), which keeps the smaller column on ties."""
    i, order = torch.sort(i, dim=1, stable=True)
    d = torch.gather(d, 1, order)
    return select_k(d, k, select_min=select_min, values=i, impl=select_impl, device=d.device)


def _pad_to_k(d, i, k, worst):
    """Widen a candidate block to k columns with (worst, -1) fillers."""
    if d.shape[1] >= k:
        return d, i
    pad = k - d.shape[1]
    return F.pad(d, (0, pad), value=worst), F.pad(i, (0, pad), value=-1)


def _narrow(d, i, k, select_min, select_impl=None):
    kk = min(k, d.shape[1])
    return (d, i) if kk == 0 else _select_ordered(d, i, kk, select_min, select_impl)


def _cat_at(blocks, dev):
    """Candidate blocks side by side on ``dev``."""
    return (torch.cat([d.to(dev) for d, _ in blocks], dim=1),
            torch.cat([i.to(dev) for _, i in blocks], dim=1))


def _stream(blocks, k, select_min, worst, select_impl=None):
    """The running top-k over candidate blocks in the order they reach
    the first block's rank: one selection a block after the first (the
    reference's streaming heap merge), (nq, 2k) at a time."""
    d, i = blocks[0]
    for blk in blocks[1:]:
        d, i = _narrow(*_cat_at([(d, i), blk], d.device), k, select_min, select_impl)
    if len(blocks) == 1:
        d, i = _narrow(d, i, k, select_min, select_impl)
    return _pad_to_k(d, i, k, worst)


def _merge_topk(ds: List[torch.Tensor], ids: List[torch.Tensor], k: int, select_min: bool,
                worst: float, merge: str, group_size: int, select_impl=None):
    """Merge one line's local candidates ``(ds[r], ids[r])`` (global ids,
    -1 and ``worst`` for none) into the global top-k by the topology
    (module doc).  In the SPMD program every rank of the line ends with
    this result; the one controller computes it once, for the line's
    first rank, from the blocks that rank receives, in the order it
    receives them, on its device.  ``select_impl`` is every select's
    route."""
    blocks = list(zip(ds, ids))
    if merge == "allgather":
        return _pad_to_k(*_narrow(*_cat_at(blocks, ds[0].device), k, select_min, select_impl),
                         k, worst)
    if merge == "ring":
        # rank 0 receives rank size-1's block at the first hop, then
        # rank size-2's (forwarded once), and so on
        return _stream([blocks[0]] + blocks[:0:-1], k, select_min, worst, select_impl)
    # hierarchical: an allgather within each group of group_size ranks
    # (at the group's first rank), then a ring across the groups
    g = group_size
    if g > 1:
        blocks = [_narrow(*_cat_at(blocks[b:b + g], blocks[b][0].device), k, select_min,
                          select_impl) for b in range(0, len(blocks), g)]
        if len(blocks) == 1:
            return _pad_to_k(*blocks[0], k, worst)
    return _stream([blocks[0]] + blocks[:0:-1], k, select_min, worst, select_impl)


def _merge_line(mesh: Mesh, axis: str, coord, local, k, select_min, worst, merge, group_size,
                select_impl=None):
    """The merge along the line of ``axis`` through ``coord``; ``local``
    maps a rank id to its rank's (d, ids).  Across processes a remote
    rank's entry is a pair of :class:`~raft_tpu_torch.comms.dist.Remote`
    (or None where its shape is not known here), and one exchange first
    brings every block to every process (module doc)."""
    line = mesh.line(axis, coord)
    items = [t for r in line for t in local[r.id]]
    if mesh.group is not None:
        items = mesh.group.exchange(items, [r.process for r in line for _ in (0, 1)],
                                    "mnmg_merge")
    return _merge_topk(items[0::2], items[1::2], k, select_min, worst, merge, group_size,
                       select_impl)


def _remote_block(local, rows, cols):
    """The Remote specs of a remote rank's (d, ids) block: ``rows`` x
    ``cols``, the dtypes this process's own blocks have (None, one
    metadata round, where this process holds no block of the line)."""
    mine = next((b for b in local.values() if isinstance(b[0], torch.Tensor)), None)
    if mine is None:
        return (None, None)
    return (Remote((rows, cols), mine[0].dtype), Remote((rows, cols), mine[1].dtype))


# --------------------------------------------------------------------- #
# brute force
# --------------------------------------------------------------------- #
class ShardedRows(NamedTuple):
    """An index row-sharded over a mesh axis (:func:`shard_knn_index`):
    shard j holds rows ``[bases[j], bases[j] + len)`` and lies on every
    rank at position j of the axis (``shards`` in flat mesh order, each on
    its rank's device; None for a rank of another process)."""

    mesh: Mesh
    axis: str
    shards: tuple
    bases: tuple
    n_rows: int


def shard_knn_index(index, mesh: Mesh, axis: str) -> Tuple[ShardedRows, int]:
    """Row-shard ``index`` over ``axis`` once: ``ceil(n / size)`` rows a
    shard, the last one shorter (no pad rows to mask).  Every rank's shard
    is a view of ``index`` where the rank's device holds it.  Returns
    ``(sharded, n)``, the JAX signature; pass ``sharded`` (with
    ``n_rows=n``) to :func:`mnmg_knn` to reuse the shards."""
    mesh = as_mesh(mesh)
    expects(axis in mesh.axis_names, "shard_knn_index: axis %s not in mesh", axis)
    index = as_tensor(index, mesh.home())
    expects(index.ndim == 2, "shard_knn_index: (n, d) index required")
    n = int(index.shape[0])
    ax = mesh.axis_names.index(axis)
    size = int(mesh.shape[axis])
    rows = ceildiv(n, size)
    bases = tuple(min(j * rows, n) for j in range(size))
    shards = []
    for coord in np.ndindex(mesh.ranks.shape):
        j, rank = coord[ax], mesh.ranks[coord]
        part = index[bases[j]:min(bases[j] + rows, n)]
        shards.append(part.to(rank.device) if rank.is_local else None)
    return ShardedRows(mesh, axis, tuple(shards), bases, n), n


def mnmg_knn(
    index,
    queries,
    k: int,
    metric: DistanceType = D.L2Expanded,
    metric_arg: float = 2.0,
    handle=None,
    comms=None,
    mesh=None,
    axis: Optional[str] = None,
    query_axis: Optional[str] = None,
    tile_n: int = 8192,
    precision: str = "highest",
    merge: Optional[str] = None,
    group_size: Optional[int] = None,
    n_rows: Optional[int] = None,
    device=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact kNN with the index row-sharded across a mesh axis.

    Parameters
    ----------
    index:
        (n, d) global index rows (numpy array or tensor), or the
        :class:`ShardedRows` of :func:`shard_knn_index` (with ``n_rows``).
    queries:
        (nq, d) queries, replicated (or sharded over ``query_axis``).
    k:
        Neighbours per query (k <= n).
    metric, metric_arg:
        Distance metric; the dispatch of ``brute_force_knn``.
    handle / comms / mesh+axis / device:
        Communicator resolution, strongest first (module doc); ``device``
        only picks the default mesh's kind (default ``"cuda"``).
    query_axis:
        Optional second mesh axis to shard queries over; nq must divide
        by its size.
    precision:
        ``"highest"`` (float32 products, the default) or ``"default"``.
    merge:
        ``"allgather"`` | ``"ring"`` | ``"hierarchical"``; None resolves
        the ``mnmg_merge`` knob.  Equal results bit for bit.
    group_size:
        Hierarchical group size (must divide the axis size); None
        resolves (:func:`resolve_group_size`).
    n_rows:
        The real row count of a pre-sharded ``index``.

    Returns
    -------
    (distances, indices): (nq, k) global results on the first rank's
    device, best first (ties by global id), int32 ids.
    """
    mesh_, axis_ = _resolve_comms(handle, comms, mesh, axis, device)
    size = int(mesh_.shape[axis_])
    if isinstance(index, ShardedRows):
        expects(index.mesh is mesh_ and index.axis == axis_,
                "mnmg_knn: the pre-sharded index was cut for another mesh or axis")
        expects(n_rows is None or int(n_rows) == index.n_rows,
                "mnmg_knn: n_rows=%r but the shards hold %d rows", n_rows, index.n_rows)
        sharded = index
    else:
        expects(n_rows is None, "mnmg_knn: n_rows= needs the ShardedRows of shard_knn_index")
        sharded, _ = shard_knn_index(index, mesh_, axis_)
    n = sharded.n_rows
    out_dev = mesh_.home()
    q = as_tensor(queries, out_dev)
    d_dim = next(s for s in sharded.shards if s is not None).shape[1]
    expects(q.ndim == 2 and q.shape[1] == d_dim,
            "mnmg_knn: index/query dimensionality mismatch")
    nq = q.shape[0]
    expects(0 < k <= n, "mnmg_knn: k=%d out of range for n=%d", k, n)
    n_qblocks = 1
    if query_axis is not None:
        expects(query_axis in mesh_.axis_names and query_axis != axis_,
                "mnmg_knn: query_axis %s not in mesh", query_axis)
        n_qblocks = int(mesh_.shape[query_axis])
        expects(nq % n_qblocks == 0, "mnmg_knn: nq=%d not divisible by query_axis size %d",
                nq, n_qblocks)
    merge = resolve_merge(merge, devices=size, n=n, k=k)
    group_size = resolve_group_size(mesh_, axis_, group_size) if merge == "hierarchical" else 1
    select_min = metric not in _IP_FAMILY
    worst = float("inf") if select_min else float("-inf")
    ax = mesh_.axis_names.index(axis_)
    qax = mesh_.axis_names.index(query_axis) if query_axis is not None else None
    bq = nq // n_qblocks

    # query block qi is the merged result of the line of axis_ at query
    # coordinate qi (0 on every other axis); other lines hold replicas
    blocks = []
    for qi in range(n_qblocks):
        line = [0] * len(mesh_.axis_names)
        if qax is not None:
            line[qax] = qi
        qb = q[qi * bq:(qi + 1) * bq]
        local, remote = {}, {}
        for j in range(size):
            line[ax] = j
            rank = mesh_.ranks[tuple(line)]
            shard = sharded.shards[int(np.ravel_multi_index(line, mesh_.ranks.shape))]
            end = sharded.bases[j + 1] if j + 1 < size else n
            kl = min(k, end - sharded.bases[j])
            if not rank.is_local:
                remote[rank.id] = kl
                continue
            if kl == 0:
                local[rank.id] = (
                    torch.full((bq, 0), worst, dtype=torch.float32, device=rank.device),
                    torch.full((bq, 0), -1, dtype=torch.int32, device=rank.device))
                continue
            dl, il = _search_one_partition(shard, qb.to(rank.device), kl, metric, metric_arg,
                                           tile_n, precision, 1)
            local[rank.id] = (dl, (il + sharded.bases[j]).to(torch.int32))
        for rid, kl in remote.items():
            local[rid] = _remote_block(local, bq, kl)
        blocks.append(_merge_line(mesh_, axis_, tuple(line), local, k, select_min, worst,
                                  merge, group_size))
    dist = torch.cat([d.to(out_dev) for d, _ in blocks])
    idx = torch.cat([i.to(out_dev) for _, i in blocks])
    if metric in _SQRT:
        dist = torch.sqrt(torch.clamp(dist, min=0.0))
    return dist, idx


# --------------------------------------------------------------------- #
# slot-sharded IVF-Flat (the ANN serving shard)
# --------------------------------------------------------------------- #
class ShardedIVFFlat(NamedTuple):
    """An IVF-Flat index with its slot stores row-sharded over a mesh
    axis: the serving shard of a sharded ``ANNService``.

    Every field but ``mesh``, ``axis``, ``metric``, ``nprobe`` and
    ``nlist`` is a tuple with one entry a rank (flat mesh order, each on
    its rank's device; None for a rank of another process).  Centroids
    are replicated (every rank probes the same coarse quantizer); shard
    j owns the global slots ``[j * rows, (j + 1) * rows)`` (views of the
    index's stores where the device holds them), and
    ``cent_slots_local`` maps each centroid's slot list to the
    rank's local slot ids (-1: not owned here), so a rank scans exactly
    the probed slots it holds.  ``slot_ids`` carry global row ids."""

    mesh: Mesh
    axis: str
    centroids: tuple
    slot_vecs: tuple
    slot_norms: tuple
    slot_ids: tuple
    cent_slots_local: tuple
    metric: DistanceType
    nprobe: int
    nlist: int


def shard_ivf_flat_index(index, mesh: Mesh, axis: str) -> ShardedIVFFlat:
    """Slot-shard an :class:`~raft_tpu_torch.spatial.ann.IVFFlatIndex` over
    ``axis`` (class doc above)."""
    from raft_tpu_torch.spatial.ann import IVFFlatIndex, _check_metric

    expects(isinstance(index, IVFFlatIndex),
            "shard_ivf_flat_index: IVFFlatIndex required, got %r", type(index).__name__)
    _check_metric("shard_ivf_flat_index", DistanceType(int(index.metric)))
    mesh = as_mesh(mesh)
    expects(axis in mesh.axis_names, "shard_ivf_flat_index: axis %s not in mesh", axis)
    size = int(mesh.shape[axis])
    ax = mesh.axis_names.index(axis)
    n_slots = int(index.slot_vecs.shape[0])
    rows = ceildiv(n_slots, size)
    norms = index.slot_norms
    if norms is None:
        norms = (index.slot_vecs * index.slot_vecs).sum(dim=-1)
    cs = index.cent_slots.cpu().numpy() if isinstance(index.cent_slots, torch.Tensor) \
        else np.asarray(index.cent_slots)
    local_maps = []
    for j in range(size):
        base = j * rows
        owned = (cs >= base) & (cs < base + rows)
        local_maps.append(torch.from_numpy(np.where(owned, cs - base, -1).astype(np.int32)))
    fields = {"centroids": [], "slot_vecs": [], "slot_norms": [], "slot_ids": [],
              "cent_slots_local": []}
    for coord in np.ndindex(mesh.ranks.shape):
        if not mesh.ranks[coord].is_local:
            for v in fields.values():
                v.append(None)
            continue
        dev = mesh.ranks[coord].device
        j = coord[ax]
        a, b = min(j * rows, n_slots), min((j + 1) * rows, n_slots)
        fields["centroids"].append(as_tensor(index.centroids, dev))
        fields["slot_vecs"].append(as_tensor(index.slot_vecs[a:b], dev))
        fields["slot_norms"].append(as_tensor(norms[a:b], dev))
        fields["slot_ids"].append(as_tensor(index.slot_ids[a:b], dev))
        fields["cent_slots_local"].append(local_maps[j].to(dev))
    return ShardedIVFFlat(mesh=mesh, axis=axis, metric=DistanceType(int(index.metric)),
                          nprobe=int(index.nprobe), nlist=int(index.centroids.shape[0]),
                          **{name: tuple(v) for name, v in fields.items()})


def _shard_scan(q, cent, sv, sn, si, cs, k, nprobe, select_impl=None):
    """One rank's probe and scan of the slots it owns: (nq, k) squared
    distances ascending and global ids, (+inf, -1) where fewer.  K3 where
    its limits allow (float32 queries and store, k <= its MAX_K), else the
    resident search's step scan over the owned slots (``cs`` holds -1 for
    the slots of other ranks, which the probe's compaction drops)."""
    from raft_tpu_torch.spatial.ann import _probe_compact, _probe_scan_search

    nq = q.shape[0]
    sn = sn.to(torch.float32)
    if not (q.dtype == torch.float32 and sv.dtype == torch.float32 and k <= K3_MAX_K):
        qn = (q * q).sum(dim=1)

        def step_dist(slx, _pjx):
            dot = precision.bmm(sv[slx], q[:, :, None].to(sv.dtype))[:, :, 0]
            return qn[:, None] + sn[slx] - 2.0 * dot, si[slx]

        return _probe_scan_search(q, cent, cs, step_dist, k, nprobe, D.L2Expanded,
                                  select_impl=select_impl)
    slots, _ = _probe_compact(q, cent, cs, nprobe, select_impl=select_impl)
    # a rank cannot own more live probed slots than it holds slots
    slots = slots[:, :min(slots.shape[1], sv.shape[0])].contiguous()
    if slots.shape[1] == 0:
        return (torch.full((nq, k), float("inf"), dtype=torch.float32, device=q.device),
                torch.full((nq, k), -1, dtype=torch.int32, device=q.device))
    return fused_ivf_scan(q, sv, sn, si, slots, k)


def mnmg_ivf_flat_search(sharded: ShardedIVFFlat, queries, k: int,
                         nprobe: Optional[int] = None, *,
                         select_impl: Optional[str] = None,
                         merge: Optional[str] = None,
                         group_size: Optional[int] = None,
                         delta=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Search a slot-sharded IVF-Flat index: every rank probes and scans
    its slots (K2, K3), then the merge topology gives the global top-k.
    Results match :func:`~raft_tpu_torch.spatial.ann.ivf_flat_search` at
    the same ``nprobe`` up to distance-tie order (ties here order by
    global id).  ``delta=(vectors, ids)`` merges the append-only segment
    into the result after the sharded search, as the single-device path
    does.  ``select_impl`` (``"kernel"``, ``"sort"`` or None: the knob at
    each select) is the route of every probe and merge select."""
    from raft_tpu_torch.spatial.ann import _check_metric, _merge_delta, _validate_nprobe

    _check_metric("mnmg_ivf_flat_search", sharded.metric)
    mesh = sharded.mesh
    out_dev = mesh.home()
    q = as_tensor(queries, out_dev)
    d_dim = int(next(c for c in sharded.centroids if c is not None).shape[1])
    expects(q.ndim == 2 and q.shape[1] == d_dim,
            "mnmg_ivf_flat_search: (nq, %d) queries required, got %r", d_dim, tuple(q.shape))
    nprobe = sharded.nprobe if nprobe is None else nprobe
    nprobe = _validate_nprobe("mnmg_ivf_flat_search", nprobe, sharded.nlist)
    size = int(mesh.shape[sharded.axis])
    merge = resolve_merge(merge, devices=size, k=k)
    group_size = (resolve_group_size(mesh, sharded.axis, group_size)
                  if merge == "hierarchical" else 1)
    # the line of the axis through the origin; other lines hold replicas
    ax = mesh.axis_names.index(sharded.axis)
    line = [0] * len(mesh.axis_names)
    local, remote = {}, []
    for j in range(size):
        line[ax] = j
        rank = mesh.ranks[tuple(line)]
        if not rank.is_local:
            remote.append(rank.id)
            continue
        flat = int(np.ravel_multi_index(line, mesh.ranks.shape))
        local[rank.id] = _shard_scan(q.to(rank.device), sharded.centroids[flat],
                                     sharded.slot_vecs[flat], sharded.slot_norms[flat],
                                     sharded.slot_ids[flat], sharded.cent_slots_local[flat],
                                     k, nprobe, select_impl)
    for rid in remote:
        local[rid] = _remote_block(local, q.shape[0], k)
    d, i = _merge_line(mesh, sharded.axis, tuple(line), local, k, True, float("inf"), merge,
                       group_size, select_impl)
    d, i = d.to(out_dev), i.to(out_dev)
    if sharded.metric in _SQRT:
        d = torch.sqrt(d)
    out = (d, i)
    if delta is not None:
        out = _merge_delta(out, delta, q, k, sharded.metric, select_impl)
    return out
