"""Sparse pairwise distances over CSR, every metric of the dense module.

Port of ``raft_tpu/sparse/distance.py`` (reference
sparse/distance/distance.hpp:77, runtime switch :83-137).  As in the JAX
package, row blocks are **densified** and handed to the dense metric
code, and there are two engines:

- **Full width** (the default where it fits): a (block, n_cols) dense
  block of ``a`` against every (block, n_cols) block of ``b``, through
  the port's dense :func:`raft_tpu_torch.distance.pairwise.pairwise_distance`
  (K5 for the unexpanded metrics; the expanded ones are IEEE float32
  products), or :func:`_binary_expanded` for Jaccard and Dice.
- **Column-tiled** (``batch_size_k``, or when a full-width block of ``b``
  would pass 256 MiB): every metric splits into per-row statistics,
  summed straight from the entries, and a cross term accumulated over
  (row, row, column) tiles: a product (:func:`raft_tpu_torch.distance.pairwise.matmul`,
  pinned IEEE) for the "mm" family, or K5 in its accumulate-only mode
  (``pairwise_tile(..., epilog=False)``) summed or maxed over the column
  tiles for the elementwise family; the metric's finaliser runs once per
  block pair.

Determinism.  A CSR may hold one (row, col) more than once (``coo_to_csr``
keeps duplicates); a densified block holds their sum.  Each call first
sums duplicates in the order of the (row, col)-sorted entries
(:func:`raft_tpu_torch.sparse.op.sum_duplicates`), then writes the unique
entries into the block without accumulation, so a block is the same on
every run (``index_add_`` adds in an order that changes from run to run
on the card).  The row statistics are segmented sums of those unique
entries in row order.  The JAX package sums its row statistics over the
raw entries, which differs from this only where a CSR holds duplicates.

Every public function takes ``handle=`` or ``device=``
(:func:`raft_tpu_torch.core.handle.takes_handle`, default ``"cuda"``).
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional, Tuple

import torch

from raft_tpu_torch.core.error import expects, fail
from raft_tpu_torch.core.handle import takes_handle
from raft_tpu_torch.distance.distance_type import DistanceType
from raft_tpu_torch.distance.pairwise import matmul
from raft_tpu_torch.distance.pairwise import pairwise_distance as dense_pairwise
from raft_tpu_torch.ops.pairwise_tile import apply_epilog, pairwise_tile
from raft_tpu_torch.sparse.convert import csr_to_coo, sorted_rows_to_indptr
from raft_tpu_torch.sparse.formats import CSR
from raft_tpu_torch.sparse.op import _dedup

D = DistanceType

# the bytes a densified full-width block of b may take before the
# column-tiled engine takes over (the JAX package's budget)
DENSE_BUDGET_BYTES = 256 * 2**20


class Entries(NamedTuple):
    """A CSR's entries with duplicates summed, sorted by (row, col), padding
    (row == n_rows) last; ``indptr`` over them."""
    rows: torch.Tensor
    cols: torch.Tensor
    vals: torch.Tensor
    indptr: torch.Tensor
    shape: Tuple[int, int]


def unique_entries(csr: CSR) -> Entries:
    """The CSR's entries, duplicates summed in (row, col) order."""
    coo = _dedup(csr_to_coo(csr), "sum")
    return Entries(coo.rows, coo.cols, coo.vals, sorted_rows_to_indptr(coo.rows, coo.n_rows),
                   csr.shape)


def densify(ent: Entries, row_start: int, bm: int, col_start: int, bk: int,
            width: Optional[int] = None) -> torch.Tensor:
    """Dense (bm, width) block (width default bk) of rows [row_start,
    +bm) x cols [col_start, +bk) of unique entries, zero past column bk:
    each entry written once, those outside the block sent to a spare
    slot past its end."""
    n_rows = ent.shape[0]
    width = bk if width is None else width
    in_tile = ((ent.rows >= row_start) & (ent.rows < min(row_start + bm, n_rows))
               & (ent.cols >= col_start) & (ent.cols < col_start + bk))
    flat = (ent.rows.to(torch.int64) - row_start) * width + (ent.cols.to(torch.int64) - col_start)
    flat = torch.where(in_tile, flat, bm * width)
    out = torch.zeros(bm * width + 1, dtype=ent.vals.dtype, device=ent.vals.device)
    out[flat] = ent.vals
    return out[:-1].view(bm, width)


@takes_handle
def densify_block(csr: CSR, row_start: int, bm: int, col_start: int, bk: int) -> torch.Tensor:
    """Dense (bm, bk) tile of rows [row_start, +bm) x cols [col_start,
    +bk); duplicates summed (module doc), rows past n_rows zero."""
    return densify(unique_entries(csr), row_start, bm, col_start, bk)


@takes_handle
def densify_rows(csr: CSR, row_start: int, block: int) -> torch.Tensor:
    """Rows [row_start, row_start + block) as a dense (block, n_cols) block."""
    return densify(unique_entries(csr), row_start, block, 0, csr.n_cols)


def _entry_row_sum(ent: Entries, vals: torch.Tensor) -> torch.Tensor:
    """(n_rows,) float32 sums of per-entry ``vals``, each row's in row order."""
    return torch.segment_reduce(vals.to(torch.float32), "sum", offsets=ent.indptr.long(),
                                unsafe=True)


def _guarded_div(num, den):
    return torch.where(den == 0, 0.0, num / torch.where(den == 0, 1.0, den))


def _log_masked(t):
    return torch.where(t > 0, torch.log(torch.where(t > 0, t, 1.0)), 0.0)


class _Spec(NamedTuple):
    """A metric's column-tiled decomposition (:func:`_coltiled_spec`)."""
    kind: str                            # "mm", "add" or "max"
    ta: Optional[Callable]               # tile transforms before the product
    tb: Optional[Callable]
    stats_a: Dict[str, Callable]         # row statistic name -> entry function
    stats_b: Dict[str, Callable]
    k5_metric: Optional[DistanceType]    # K5's metric for the elementwise family
    finalize: Callable                   # (cross, sa (bm, 1) each, sb (1, bn) each)


def _coltiled_spec(metric: DistanceType, metric_arg: float, k_total: int) -> _Spec:
    """Column-tiled decomposition of one metric (the JAX ``_coltiled_spec``)."""
    def ident(t):
        return t

    def binz(t):
        return (t != 0).to(torch.float32)

    sq = {"sq": lambda v: v * v}
    none: Dict[str, Callable] = {}

    if metric in (D.L2Expanded, D.L2SqrtExpanded):
        def fin(ip, sa, sb):
            d = torch.clamp(sa["sq"] + sb["sq"] - 2.0 * ip, min=0.0)
            return torch.sqrt(d) if metric == D.L2SqrtExpanded else d
        return _Spec("mm", ident, ident, sq, sq, None, fin)
    if metric == D.InnerProduct:
        return _Spec("mm", ident, ident, none, none, None, lambda ip, sa, sb: ip)
    if metric == D.CosineExpanded:
        def fin(ip, sa, sb):
            return 1.0 - _guarded_div(ip, torch.sqrt(sa["sq"]) * torch.sqrt(sb["sq"]))
        return _Spec("mm", ident, ident, sq, sq, None, fin)
    if metric == D.CorrelationExpanded:
        st = {"sum": lambda v: v, "sq": lambda v: v * v}

        def fin(ip, sa, sb):
            k = float(k_total)
            numer = k * ip - sa["sum"] * sb["sum"]
            qa = k * sa["sq"] - sa["sum"] * sa["sum"]
            qb = k * sb["sq"] - sb["sum"] * sb["sum"]
            return 1.0 - numer / torch.sqrt(qa * qb)
        return _Spec("mm", ident, ident, st, st, None, fin)
    if metric == D.HellingerExpanded:
        def tr(t):
            return torch.sqrt(t.abs())
        return _Spec("mm", tr, tr, none, none, None,
                     lambda ip, sa, sb: torch.sqrt(torch.clamp(1.0 - ip, min=0.0)))
    if metric == D.RusselRaoExpanded:
        return _Spec("mm", ident, ident, none, none, None,
                     lambda ip, sa, sb: (k_total - ip) / k_total)
    if metric == D.KLDivergence:
        # 0.5 * (sum x log x - x @ masked_log(y)^T): a row statistic of a
        # and a product with the y tile log-masked
        st_a = {"xlogx": lambda v: torch.where(v > 0, v * _log_masked(v), 0.0)}
        return _Spec("mm", ident, _log_masked, st_a, none, None,
                     lambda ip, sa, sb: 0.5 * (sa["xlogx"] - ip))
    if metric in (D.JaccardExpanded, D.DiceExpanded):
        st = {"nnz": lambda v: (v != 0).to(torch.float32)}

        def fin(ip, sa, sb):
            if metric == D.JaccardExpanded:
                return 1.0 - _guarded_div(ip, sa["nnz"] + sb["nnz"] - ip)
            return 1.0 - _guarded_div(2.0 * ip, sa["nnz"] + sb["nnz"])
        return _Spec("mm", binz, binz, st, st, None, fin)

    # the elementwise family: K5's raw reduce summed (or maxed) over the
    # column tiles, its epilog once at the end
    if metric in (D.L1, D.L2Unexpanded, D.L2SqrtUnexpanded, D.Canberra, D.LpUnexpanded,
                  D.HammingUnexpanded, D.JensenShannon, D.Linf):
        p = float(metric_arg)
        return _Spec("max" if metric == D.Linf else "add", None, None, none, none, metric,
                     lambda acc, sa, sb: apply_epilog(metric, acc, p, k_total))
    if metric == D.BrayCurtis:
        st = {"sum": lambda v: v}
        return _Spec("add", None, None, st, st, D.L1,
                     lambda acc, sa, sb: _guarded_div(acc, sa["sum"] + sb["sum"]))
    fail("sparse pairwise_distance: metric %d has no column-tiled decomposition", int(metric))


def _coltiled_pairwise(a: Entries, b: Entries, metric: DistanceType, metric_arg: float,
                       bm: int, bn: int, bk: int) -> torch.Tensor:
    """The column-tiled engine: for each row block of ``a``, a (block, n)
    cross-term stripe accumulated over the column tiles, each (a, column)
    tile densified once and used against every b tile, then finalised.
    Peak temporaries O(bm bk + bn bk + bm n).  A tile's width is rounded
    up to a multiple of 4 with zero columns, which add nothing to any
    cross term (every combine maps (0, 0) to 0; the finalisers read
    ``k_total``), so that K5 stages its operands 128 bits at a time."""
    (m, k_total), n = a.shape, b.shape[0]
    spec = _coltiled_spec(metric, metric_arg, k_total)
    dev = a.vals.device
    sa_full = {name: _entry_row_sum(a, fn(a.vals)) for name, fn in spec.stats_a.items()}
    sb_full = {name: _entry_row_sum(b, fn(b.vals)) for name, fn in spec.stats_b.items()}
    out = torch.empty((m, n), dtype=torch.float32, device=dev)
    for i0 in range(0, m, bm):
        rows_a = min(bm, m - i0)
        acc = torch.zeros((rows_a, n), dtype=torch.float32, device=dev)
        for c0 in range(0, k_total, bk):
            cols = min(bk, k_total - c0)
            width = -(-cols // 4) * 4
            xa = densify(a, i0, rows_a, c0, cols, width).to(torch.float32)
            txa = spec.ta(xa) if spec.kind == "mm" else xa
            for j0 in range(0, n, bn):
                rows_b = min(bn, n - j0)
                xb = densify(b, j0, rows_b, c0, cols, width).to(torch.float32)
                cur = acc[:, j0:j0 + rows_b]
                if spec.kind == "mm":
                    cur += matmul(txa, spec.tb(xb).T)
                elif spec.kind == "add":
                    cur += pairwise_tile(xa, xb, spec.k5_metric, float(metric_arg), epilog=False)
                else:
                    cur.copy_(torch.maximum(cur, pairwise_tile(
                        xa, xb, spec.k5_metric, float(metric_arg), epilog=False)))
        sa = {k: v[i0:i0 + rows_a, None] for k, v in sa_full.items()}
        for j0 in range(0, n, bn):
            sb = {k: v[None, j0:j0 + bn] for k, v in sb_full.items()}
            out[i0:i0 + rows_a, j0:j0 + bn] = spec.finalize(acc[:, j0:j0 + bn], sa, sb)
    return out


def _binary_expanded(xa: torch.Tensor, xb: torch.Tensor, metric: DistanceType) -> torch.Tensor:
    """Jaccard and Dice from binarised inner products (reference
    sparse/distance/detail/bin_distance.cuh)."""
    ba = (xa != 0).to(torch.float32)
    bb = (xb != 0).to(torch.float32)
    ip = matmul(ba, bb.T)
    na = ba.sum(dim=1)[:, None]
    nb = bb.sum(dim=1)[None, :]
    if metric == D.JaccardExpanded:
        union = na + nb - ip
        sim = torch.where(union > 0, ip / torch.where(union == 0, 1.0, union), 0.0)
    else:
        den = na + nb
        sim = torch.where(den > 0, 2 * ip / torch.where(den == 0, 1.0, den), 0.0)
    return 1.0 - sim


def block_pairwise(xa: torch.Tensor, xb: torch.Tensor, metric: DistanceType,
                   metric_arg: float = 2.0) -> torch.Tensor:
    """Dense-block metric dispatch shared by the sparse engines (the
    blocks' device)."""
    if metric in (D.JaccardExpanded, D.DiceExpanded):
        return _binary_expanded(xa, xb, metric)
    return dense_pairwise(xa, xb, metric, metric_arg, device=xa.device)


def column_tile(m: int, n: int, n_cols: int, batch_size_a: int, batch_size_b: int,
                batch_size_k: Optional[int]) -> Optional[int]:
    """The column tile of the column-tiled engine, or None for the
    full-width one (the JAX heuristic): the full-width engine densifies
    one block of ``a`` and all of ``b``, so where that passes
    :data:`DENSE_BUDGET_BYTES` and no ``batch_size_k`` is given, the
    tile is derived from the row blocks to keep a (block, tile) dense
    tile within the budget."""
    if batch_size_k is not None:
        return batch_size_k if batch_size_k < n_cols else None
    bm, bn = min(batch_size_a, m), min(batch_size_b, n)
    if max(bm, -(-n // bn) * bn) * n_cols * 4 <= DENSE_BUDGET_BYTES:
        return None
    return min(max(512, DENSE_BUDGET_BYTES // (max(bm, bn) * 4) // 128 * 128), n_cols)


@takes_handle
def pairwise_distance(a: CSR, b: CSR, metric: DistanceType = D.L2Expanded,
                      metric_arg: float = 2.0, batch_size_a: int = 1024,
                      batch_size_b: int = 1024,
                      batch_size_k: Optional[int] = None) -> torch.Tensor:
    """All-pairs distances between CSR row sets a (m, k) and b (n, k):
    (m, n) float32 on their device.

    ``batch_size_a`` and ``batch_size_b`` are the row blocks (the
    reference's ``distances_config_t`` batching knobs,
    sparse/distance/common.h:26); ``batch_size_k`` engages the
    column-tiled engine (module doc), and when None a heuristic picks it
    where a full-width block of ``b`` would pass 256 MiB
    (:func:`column_tile`).
    """
    expects(a.n_cols == b.n_cols,
            "sparse pairwise_distance: dimensionality mismatch (%d vs %d)", a.n_cols, b.n_cols)
    m, n = a.n_rows, b.n_rows
    bm, bn = min(batch_size_a, m), min(batch_size_b, n)
    ea, eb = unique_entries(a), unique_entries(b)
    bk = column_tile(m, n, a.n_cols, batch_size_a, batch_size_b, batch_size_k)
    if bk is not None:
        return _coltiled_pairwise(ea, eb, metric, metric_arg, bm, bn, bk)
    out = torch.empty((m, n), dtype=torch.float32, device=a.device)
    # each b block densified once, as the JAX engine's b_tiles
    b_blocks = [densify(eb, j0, min(bn, n - j0), 0, b.n_cols) for j0 in range(0, n, bn)]
    for i0 in range(0, m, bm):
        xa = densify(ea, i0, min(bm, m - i0), 0, a.n_cols)
        for j0, xb in zip(range(0, n, bn), b_blocks):
            out[i0:i0 + xa.shape[0], j0:j0 + xb.shape[0]] = block_pairwise(xa, xb, metric,
                                                                           metric_arg)
    return out
