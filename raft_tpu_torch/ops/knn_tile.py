"""K1 and K6: fused squared-L2 distance + top-k, ``csrc/knn_tile.cu`` and
``csrc/knn_twophase.cu``.

Port of ``raft_tpu/ops/knn_tile.py:fused_knn_tile``: per query, the k
smallest of ``max(qn + xn - 2 q.x, 0)`` over the index rows, ascending,
with int32 ids, k <= 128.  Ties resolve to the smaller id.  The inputs
are float32; float16 and bfloat16 inputs go through a float32 copy, as
``pad_with_norms`` casts them.  At ``precision="highest"`` the kernels
compute the products in 3xTF32 on the tensor cores
(``csrc/knn_tile.cuh``): each operand is split into two TF32 halves and
three products are summed in float32, which keeps float32's accuracy and
so meets the JAX contract that one TF32 pass would miss.  At
``precision="default"`` they run their bfloat16 instance, the TPU's
single pass: each operand rounded to bfloat16, the exact products summed
in float32 (:func:`raft_tpu_torch.core.precision.matmul_bf16`, which the
plain versions take).  The norms stay float32 either way.

The kernel splits the index across blocks as well as the queries, so
that the grid fills whole waves of blocks on the card (:func:`index_blocks`:
a thousand queries take 8 splits of a million rows, ten thousand take 5);
each split writes its own top-k and the select kernel
(:mod:`raft_tpu_torch.ops.select_tile`) merges the partials.  Because
the partials are laid out split by split, a tie on
distance between splits resolves to the smaller split, which holds the
smaller ids: the merged result is the same as one pass.  The norms are
computed here with torch ops, as ``pad_with_norms`` computes them
outside the Pallas call, and :func:`prepare_operands` pads a copy of the
operands where the kernel's TMA copies (16-byte aligned rows) and its k8
steps (a depth that is a multiple of 8) need it.

The JAX ``knn_tile_merge`` knob (``merge``/``fullsort``/``sorttile``/
``skip``) picks between lane-network variants of the TPU's 128-lane
vector unit and has no counterpart: a warp's shuffle network is the one
selection core (``csrc/warp_select.cuh``).  Block shapes are constants
chosen for Hopper, not registry knobs.

K6 (:func:`fused_knn_twophase`, port of
``raft_tpu/ops/knn_tile.py:fused_knn_twophase``) computes the same
result in two phases with no state across index tiles: per tile of
``bn`` rows the kernel keeps the tile's 128 smallest with global ids
(:func:`twophase_tiles`), then one exact select of k over the
(nq, n_tiles * 128) candidates merges them (K2 plus a gather of the
ids).  ``block_n`` is the registry's ``knn_block_n`` knob
(:mod:`raft_tpu_torch.core.tuning`: the JAX default 1024, ladder 256 to
4096 and rounding, :func:`twophase_geometry`; None resolves it through
override, configure, env and the tuning table at each call);
``block_q`` and ``interpret`` are TPU arguments with no counterpart.
The merge is exact (``merge_select_impl="topk"``, the default, as the
JAX registry pins it); an explicit ``"approx95"`` takes the approximate
select (:mod:`raft_tpu_torch.spatial.select_k`), argument-only as in the
JAX package.  Ties resolve to the smaller id: each tile's candidates are sorted by (distance, id) and the
tiles are laid out in id order, so the select's first-column rule keeps
the smaller id.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from raft_tpu_torch.core import inventory, tracing, tuning
from raft_tpu_torch.core import precision as _precision
from raft_tpu_torch.core.error import expects
from raft_tpu_torch.core.utils import ceildiv
from raft_tpu_torch.ops import _build, cost
from raft_tpu_torch.ops.select_tile import select_tile, select_tile_plain

MAX_K = 128
BLOCK_Q = 64       # queries per block at the main path's depth, 128 (knn_block_q)
BLOCK_N = 64       # index rows per tile: wgmma's M (csrc/knn_tile.cuh kBN)
BLOCKS_PER_SM = 1  # blocks resident on an SM (some 220 KB of shared memory each)
DEPTH_UNIT = 8     # the kernels take a depth that is a multiple of wgmma's k8
# The grid's cost model (grid_time), fitted by least squares to K1 alone
# at 10,000 x 1M x 128 over 1 to 8 and 16 index splits
# (tools/torch_knn_sweep.py --splits; H100 80GB HBM3 at 700 W): a block's
# seconds a BLOCK_N-row tile of the index, and once besides (its start,
# the selection's cold top-k, its end), which grows with k: 6.8e-5 at
# k 10 and 4.9e-4 at k 100, taken as linear in k between the two; and
# K2's merge with the gather of the ids, a column of a query (64 merges
# of 2 to 16 splits, 1,024 to 10,000 queries)
TILE_S = 1.96e-6
BLOCK_S = 2.11e-5
BLOCK_K_S = 4.69e-6
MERGE_COLUMN_S = 2.8e-11
# the most blocks along the index, beyond one wave's worth beside the query
# tiles: K2 merges up to MAX_SPLITS * k columns a query in one block
MAX_SPLITS = 8
# K1's and K6's counters of the blocks launched and of the block slots of
# the waves they take: the grid fills blocks / wave slots of the card
WAVE_COUNTERS = ("knn_tile.blocks", "knn_tile.wave_slots")
TWOPHASE_WAVE_COUNTERS = ("knn_twophase.blocks", "knn_twophase.wave_slots")

# index rows per tile of the plain version
_PLAIN_TILE = 8192
# input types the kernels take through a float32 copy
_NARROW = (torch.float16, torch.bfloat16)


def products(precision: str):
    """The distance product of the plain versions at ``precision``:
    IEEE float32, or the bfloat16 single pass (module doc)."""
    expects(precision in _precision.PRECISIONS, "precision must be one of %s, got %r",
            _precision.PRECISIONS, precision)
    return _precision.matmul_bf16 if precision == "default" else _precision.matmul


def as_float32(t: torch.Tensor, what: str) -> torch.Tensor:
    """``t`` if float32, a float32 copy if float16 or bfloat16 (as
    ``pad_with_norms`` casts); any other type raises."""
    expects(t.dtype == torch.float32 or t.dtype in _NARROW,
            "%s: float32, float16 or bfloat16 inputs required, got %s", what, t.dtype)
    return t.to(torch.float32)


def knn_tile_plain(index: torch.Tensor, queries: torch.Tensor, k: int,
                   precision: str = "highest") -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: the same distances in expanded form (one
    matmul per index tile, :func:`products` at ``precision``) and the
    same (distance, id) order, kept by a stable sort of the running top-k
    followed by the tile."""
    dot = products(precision)
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
        d = torch.clamp(qn + xn[None, :] - 2.0 * dot(queries, x.T), min=0.0)
        ids = torch.arange(j0, j0 + x.shape[0], device=queries.device)
        cat_d = torch.cat([best_d, d], dim=1)
        cat_i = torch.cat([best_i, ids.expand(nq, -1)], dim=1)
        best_d, pos = torch.sort(cat_d, dim=1, stable=True)
        best_d = best_d[:, :k]
        best_i = torch.gather(cat_i, 1, pos[:, :k])
    return best_d.contiguous(), best_i.to(torch.int32)


def block_seconds(k: int) -> float:
    """A block's predicted seconds besides its index tiles, at top-``k``."""
    return BLOCK_S + k * BLOCK_K_S


def grid_time(q_tiles: int, units: int, want: int, slots: int, k: int, unit_tiles: int = 1,
              merge_s: float = 0.0) -> Tuple[float, int, int]:
    """``(predicted seconds, units per block, blocks)`` along the index
    when ``units`` runs of ``unit_tiles`` whole ``BLOCK_N`` tiles are
    shared by ``want`` blocks beside ``q_tiles`` query tiles: whole waves
    of ``slots`` blocks on the card, each block ``TILE_S`` a tile and
    :func:`block_seconds` of ``k`` besides, and ``merge_s`` a block along
    the index to merge their partials where there are two or more."""
    per = ceildiv(units, want)
    blocks = ceildiv(units, per)
    waves = ceildiv(q_tiles * blocks, slots)
    seconds = waves * (per * unit_tiles * TILE_S + block_seconds(k))
    return seconds + (blocks * merge_s if blocks > 1 else 0.0), per, blocks


def index_blocks(q_tiles: int, units: int, n_sms: int, k: int, unit_tiles: int = 1,
                 merge_s: float = 0.0) -> Tuple[int, int]:
    """``(units per block, blocks)`` along the index: of the ways to share
    ``units`` among blocks of top-``k`` (:func:`grid_time`, in waves of
    ``BLOCKS_PER_SM`` blocks on each of ``n_sms`` SMs), the one of least
    predicted time, the fewer blocks on a tie.  Up to one wave's worth of
    blocks beside the query tiles is tried, or ``MAX_SPLITS`` where that
    is more, so that a call of many queries fills whole waves and one of
    a few queries spreads the index over the card."""
    return _best_grid(q_tiles, units, BLOCKS_PER_SM * n_sms, k, unit_tiles, merge_s)


@functools.lru_cache(maxsize=1024)
def _best_grid(q_tiles, units, slots, k, unit_tiles, merge_s):
    cap = min(units, max(MAX_SPLITS, slots // q_tiles))
    _, per, blocks = min((grid_time(q_tiles, units, s, slots, k, unit_tiles, merge_s)
                          for s in range(1, cap + 1)), key=lambda t: t[0])
    return per, blocks


def split_rows(nq: int, n: int, n_sms: int, n_q: int = BLOCK_Q, k: int = MAX_K) -> int:
    """K1's index rows per split, a whole number of ``BLOCK_N`` tiles:
    :func:`index_blocks` over the ``ceil(nq / n_q)`` query tiles, each
    split past the first costing K2 the merge of k columns a query."""
    per, _ = index_blocks(ceildiv(nq, n_q), ceildiv(n, BLOCK_N), n_sms, k,
                          merge_s=nq * k * MERGE_COLUMN_S)
    return per * BLOCK_N


def count_waves(names: Tuple[str, str], blocks: int, n_sms: int) -> None:
    """Add a launch's ``blocks`` and the slots of the whole waves they
    take to the counters ``names``."""
    slots = BLOCKS_PER_SM * n_sms
    tracing.counter_inc(names[0], blocks)
    tracing.counter_inc(names[1], ceildiv(blocks, slots) * slots)


def _sms(dev: torch.device) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


def prepare_operands(index: torch.Tensor, queries: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(index, queries, qn, xn)`` as the kernels take them: both
    through :func:`prepare_rows`."""
    queries, qn = prepare_rows(queries)
    index, xn = prepare_rows(index)
    return index, queries, qn, xn


def prepare_rows(t: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(rows, norms)``: ``t`` (rows, d) as the tile kernels take it,
    contiguous rows, 16-byte aligned, with a depth that is a multiple of
    8, and the squared norms of its rows.  A strided tensor is made
    contiguous; where the depth is not a multiple of 8 or the rows are
    not 16-byte aligned, a zero-padded copy is made: zero columns leave
    every dot product unchanged, and the norms are taken on the unpadded
    rows.  The main path (contiguous, depth 128) copies nothing."""
    t = t.contiguous()
    return pad_depth(t, ceildiv(t.shape[1], DEPTH_UNIT) * DEPTH_UNIT), (t * t).sum(dim=1)


def pad_depth(t: torch.Tensor, dp: int) -> torch.Tensor:
    """``t`` (rows, d), or a zero-padded copy of depth ``dp`` where its
    depth differs or its rows are not 16-byte aligned."""
    if t.shape[1] == dp and t.data_ptr() % 16 == 0:
        return t
    out = t.new_zeros((t.shape[0], dp))
    out[:, :t.shape[1]] = t
    return out


def fused_knn_tile(index: torch.Tensor, queries: torch.Tensor, k: int,
                   precision: str = "highest") -> Tuple[torch.Tensor, torch.Tensor]:
    """k nearest index rows per query under squared L2.

    index (n, d) and queries (nq, d) float32 (float16 and bfloat16
    through a copy); ``precision`` ``"highest"`` or ``"default"`` (module
    doc); returns (nq, k) float32 ascending and (nq, k) int32.  CUDA
    tensors launch the kernel (and the select kernel to merge the
    splits); CPU tensors take :func:`knn_tile_plain`.
    """
    expects(index.ndim == 2 and queries.ndim == 2
            and index.shape[1] == queries.shape[1],
            "fused_knn_tile: shape mismatch")
    n, d = index.shape
    nq = queries.shape[0]
    expects(0 < k <= n, "fused_knn_tile: k=%d out of range for n=%d", k, n)
    expects(k <= MAX_K, "fused_knn_tile: k <= %d (got %d)", MAX_K, k)
    products(precision)
    index = as_float32(index, "fused_knn_tile")
    queries = as_float32(queries, "fused_knn_tile")
    expects(index.device == queries.device,
            "fused_knn_tile: index and queries on different devices")
    if index.device.type == "cpu":
        return knn_tile_plain(index, queries, k, precision)
    _build.load("knn_tile")     # built or loaded before any work on the device
    dev = index.device
    if nq == 0:
        return (torch.empty((0, k), dtype=torch.float32, device=dev),
                torch.empty((0, k), dtype=torch.int32, device=dev))
    expects(d > 0, "fused_knn_tile: zero depth")
    index, queries, qn, xn = prepare_operands(index, queries)
    rows = split_rows(nq, n, _sms(dev), block_q(index.shape[1]), k)
    part_d, part_i = split_partials(index, queries, qn, xn, k, rows, precision, d)
    if part_d.shape[1] == k:
        return part_d, part_i
    out_d, pos = select_tile(part_d, k)
    return out_d, torch.gather(part_i, 1, pos.long())


def split_partials(index: torch.Tensor, queries: torch.Tensor, qn: torch.Tensor,
                   xn: torch.Tensor, k: int, rows: int, precision: str = "highest",
                   d: Optional[int] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """One launch of K1 on operands as :func:`prepare_operands` gives
    them, ``rows`` index rows a split (a multiple of ``BLOCK_N``): each
    split's top-k, (nq, splits * k) float32 and int32, split by split.
    ``d`` is the depth before padding, which the inventory's operation
    count takes (the operands' depth where None)."""
    n, dp = index.shape
    nq, dev = queries.shape[0], index.device
    splits = ceildiv(n, rows)
    part_d = torch.empty((nq, splits * k), dtype=torch.float32, device=dev)
    part_i = torch.empty((nq, splits * k), dtype=torch.int32, device=dev)
    _build.launch("knn_tile", dev, (queries, index, qn, xn, nq, n, dp, k, rows,
                                    int(precision == "default"), part_d, part_i),
                  "fused_knn_tile", (nq, n, dp, k, precision), lambda: (
                      *cost.knn_cost(nq, n, dp if d is None else d, k),
                      inventory.footprint((queries, index, qn, xn), (part_d, part_i),
                                          smem_bytes(dp, k))))
    count_waves(WAVE_COUNTERS, ceildiv(nq, block_q(dp)) * splits, _sms(dev))
    return part_d, part_i


def block_q(d: int) -> int:
    """Queries per K1/K6 block at depth ``d`` (a multiple of 8), as the
    kernel decides it (``csrc/knn_tile.cuh:block_q``, exported as
    ``knn_block_q``): 64 up to depth 128, 32 up to 512, 16 up to 1216,
    then 32 with the depth in slabs.  Builds the kernel library if
    needed."""
    return _build.entry("knn_tile", "knn_block_q", [ctypes.c_int], ctypes.c_int)(d)


def smem_bytes(d: int, k: int) -> int:
    """Dynamic shared memory of a K1 block at depth ``d`` (a multiple of
    8) and ``k`` (K6's is k = 128), as the kernel counts it
    (``knn_smem_bytes``).  Builds the kernel library if needed."""
    return _build.entry("knn_tile", "knn_smem_bytes", [ctypes.c_int] * 2, ctypes.c_int)(d, k)


# --------------------------------------------------------------------- #
# K6: the two-phase fused kNN
# --------------------------------------------------------------------- #
TWOPHASE_PAD = 128                       # the JAX kpad: candidates per tile
MERGE_SELECTS = ("topk", "approx95")     # phase 2's select (module doc)
BLOCK_N_LADDER = tuple(int(b) for b in tuning.candidates("knn_block_n"))


def twophase_geometry(n: int, block_n: int = 1024) -> Tuple[int, int]:
    """``(bn, n_tiles)``: the index-tile rows and the tile count of the
    JAX ``tile_geometry(..., unit=128)`` for an index of n rows."""
    expects(block_n in BLOCK_N_LADDER,
            "fused_knn_twophase: block_n=%r not in the ladder %s",
            block_n, BLOCK_N_LADDER)
    # every rung is a multiple of 128 and at least 2 * 128, so the JAX
    # rounding max(block_n // 128, 2) * 128 leaves it unchanged
    bn = min(block_n, ceildiv(n, TWOPHASE_PAD) * TWOPHASE_PAD)
    return bn, ceildiv(n, bn)


def twophase_tiles_plain(index: torch.Tensor, queries: torch.Tensor, bn: int,
                         precision: str = "highest") -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch phase 1: per tile of ``bn`` index rows, the expanded
    squared distances (one matmul, :func:`products` at ``precision``), a
    stable ascending sort, and the first 128 with global ids; a slot with
    no finite key is (+inf, -1)."""
    dot = products(precision)
    index = index.to(torch.float32)
    queries = queries.to(torch.float32)
    n, nq, dev = index.shape[0], queries.shape[0], queries.device
    qn = (queries * queries).sum(dim=1, keepdim=True)
    inf = torch.tensor(float("inf"), device=dev)
    parts_d, parts_i = [], []
    for j0 in range(0, n, bn):
        x = index[j0:j0 + bn]
        xn = (x * x).sum(dim=1)
        d = torch.clamp(qn + xn[None, :] - 2.0 * dot(queries, x.T), min=0.0)
        if x.shape[0] < TWOPHASE_PAD:      # the tile's masked columns
            d = torch.cat([d, inf.expand(nq, TWOPHASE_PAD - x.shape[0])], dim=1)
        vals, pos = torch.sort(d, dim=1, stable=True)
        vals, pos = vals[:, :TWOPHASE_PAD], pos[:, :TWOPHASE_PAD]
        live = vals < inf
        parts_d.append(torch.where(live, vals, inf))
        parts_i.append(torch.where(live, (pos + j0).to(torch.int32),
                                   torch.full_like(pos, -1, dtype=torch.int32)))
    return torch.cat(parts_d, dim=1), torch.cat(parts_i, dim=1)


def twophase_tiles(index: torch.Tensor, queries: torch.Tensor, bn: int,
                   precision: str = "highest") -> Tuple[torch.Tensor, torch.Tensor]:
    """Phase 1 of K6: (nq, n_tiles * 128) float32 candidates and int32
    ids, tile by tile, at ``precision``.  A CUDA tensor launches
    ``csrc/knn_twophase.cu``; a CPU tensor takes
    :func:`twophase_tiles_plain`."""
    expects(bn >= BLOCK_N and bn % BLOCK_N == 0,
            "twophase_tiles: bn=%d is not a multiple of %d", bn, BLOCK_N)
    products(precision)
    index = as_float32(index, "twophase_tiles")
    queries = as_float32(queries, "twophase_tiles")
    if index.device.type == "cpu":
        return twophase_tiles_plain(index, queries, bn, precision)
    _build.load("knn_twophase")     # built or loaded before any work on the device
    dev = index.device
    n, d = index.shape
    nq = queries.shape[0]
    width = ceildiv(n, bn) * TWOPHASE_PAD
    part_d = torch.empty((nq, width), dtype=torch.float32, device=dev)
    part_i = torch.empty((nq, width), dtype=torch.int32, device=dev)
    if nq == 0:
        return part_d, part_i
    expects(d > 0, "twophase_tiles: zero depth")
    index, queries, qn, xn = prepare_operands(index, queries)
    dp = index.shape[1]
    q_tiles, sms = ceildiv(nq, block_q(dp)), _sms(dev)
    per, blocks = index_blocks(q_tiles, ceildiv(n, bn), sms, TWOPHASE_PAD,
                               bn // BLOCK_N)
    _build.launch("knn_twophase", dev, (queries, index, qn, xn, nq, n, dp, bn, per,
                                        int(precision == "default"), part_d, part_i),
                  "twophase_tiles", (nq, n, dp, bn, precision), lambda: (
                      *cost.knn_cost(nq, n, d, width),
                      inventory.footprint((queries, index, qn, xn), (part_d, part_i),
                                          smem_bytes(dp, TWOPHASE_PAD))))
    count_waves(TWOPHASE_WAVE_COUNTERS, q_tiles * blocks, sms)
    return part_d, part_i


def _check_twophase(index, queries, k, precision, merge_select_impl):
    expects(index.ndim == 2 and queries.ndim == 2
            and index.shape[1] == queries.shape[1],
            "fused_knn_twophase: shape mismatch")
    n = index.shape[0]
    expects(0 < k <= n, "fused_knn_twophase: k=%d out of range for n=%d", k, n)
    expects(k <= TWOPHASE_PAD,
            "fused_knn_twophase: k <= %d (got %d)", TWOPHASE_PAD, k)
    for t in (index, queries):
        expects(t.dtype == torch.float32 or t.dtype in _NARROW,
                "fused_knn_twophase: float32, float16 or bfloat16 inputs required, got %s",
                t.dtype)
    expects(index.device == queries.device,
            "fused_knn_twophase: index and queries on different devices")
    products(precision)
    expects(merge_select_impl in MERGE_SELECTS,
            "fused_knn_twophase: merge_select_impl=%r is not ported; the merge is the "
            "exact select ('topk') or the approximate one ('approx95')", merge_select_impl)


def _twophase_merge(part_d, part_i, k, n, select):
    out_d, pos = select(part_d, k)
    out_i = torch.gather(part_i, 1, pos.long())
    return out_d, torch.clamp(out_i, 0, n - 1)


def knn_twophase_plain(index: torch.Tensor, queries: torch.Tensor, k: int,
                       block_n: int = 1024,
                       precision: str = "highest") -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of :func:`fused_knn_twophase` with the exact
    merge: the plain phase 1, then the plain select, on any device."""
    n = index.shape[0]
    bn, _ = twophase_geometry(n, block_n)
    part_d, part_i = twophase_tiles_plain(index, queries, bn, precision)
    return _twophase_merge(part_d, part_i, k, n, select_tile_plain)


def fused_knn_twophase(index: torch.Tensor, queries: torch.Tensor, k: int,
                       block_n: Optional[int] = None, precision: str = "highest",
                       merge_select_impl: str = "topk"
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """k nearest index rows per query under squared L2, in two phases.

    index (n, d) and queries (nq, d) float32 (float16 and bfloat16
    through a copy), k <= 128; returns (nq, k) float32 ascending and
    (nq, k) int32.  ``block_n`` resolves through the registry,
    ``precision`` and ``merge_select_impl`` as in the module doc.
    CUDA tensors launch K6 for phase 1 and K2 for the merge; CPU tensors
    take the plain versions.
    """
    _check_twophase(index, queries, k, precision, merge_select_impl)
    n = index.shape[0]
    block_n = int(tuning.resolve("knn_block_n", None if block_n is None else str(block_n),
                                 site="fused_knn_twophase", dtype=index.dtype, n=n, k=k,
                                 d=index.shape[1]))
    bn, _ = twophase_geometry(n, block_n)
    part_d, part_i = twophase_tiles(index, queries, bn, precision)
    select = select_tile
    if merge_select_impl == "approx95":
        # deferred: spatial/ imports this module
        from raft_tpu_torch.spatial.select_k import approx95_cols

        select = functools.partial(approx95_cols, select_min=True)
    return _twophase_merge(part_d, part_i, k, n, select)


def _twophase_entry():
    """K6's launcher bound as :func:`raft_tpu_torch.ops._build.launch`
    binds it, for a caller that sets its tiles a block itself (the
    benchmark's card test of K6's runs)."""
    return _build.entry("knn_twophase", "knn_twophase_launch",
                        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p] * 3,
                        ctypes.c_int)
