"""COO/CSR element operations: sort, dedup, filter, row ops, slicing.

Port of ``raft_tpu/sparse/op.py`` (reference sparse/op/sort.hpp
``coo_sort``, ``coo_sort_by_weight``; sparse/op/reduce.hpp:47,70
``compute_duplicates_mask``, ``max_duplicates``; sparse/op/filter.hpp:44
``coo_remove_scalar``; sparse/op/row_op.hpp:37 ``csr_row_op``;
sparse/op/slice.hpp:38,63 ``csr_row_slice_*``).

As in the JAX package, every nnz-changing op keeps the capacity: removed
entries get the sentinel row, one stable sort moves them to the tail,
and the valid count comes back as a 0-d tensor on the device, so no op
but :func:`csr_row_slice` waits for the card.  Duplicates are reduced
over their sorted runs: maxima and minima by ``scatter_reduce`` (exact in
any order), sums by ``torch.segment_reduce`` in row order, never by
``index_add_``, whose atomics add in an order that changes from run to
run on the card.  Every function takes ``handle=`` or ``device=``
(:func:`raft_tpu_torch.core.handle.takes_handle`, default ``"cuda"``).
"""

from __future__ import annotations

from typing import Callable

import torch

from raft_tpu_torch.core.handle import takes_handle
from raft_tpu_torch.sparse.convert import lexsort_rows_cols
from raft_tpu_torch.sparse.formats import COO, CSR

_INT32_MAX = 2**31 - 1


def _sorted(coo: COO) -> COO:
    order = lexsort_rows_cols(coo.rows, coo.cols, coo.n_cols)
    return COO(coo.rows[order], coo.cols[order], coo.vals[order], coo.shape, coo.nnz,
               device=coo.device)


@takes_handle
def coo_sort(coo: COO) -> COO:
    """Entries sorted by (row, col), padding last (reference coo_sort,
    sparse/op/sort.hpp)."""
    return _sorted(coo)


@takes_handle
def coo_sort_by_weight(coo: COO) -> COO:
    """Entries sorted ascending by value, padding last whatever its value
    (reference sparse/op/sort.hpp:67)."""
    key = torch.where(coo.valid_mask(), coo.vals, float("inf"))
    order = torch.sort(key, stable=True).indices
    return COO(coo.rows[order], coo.cols[order], coo.vals[order], coo.shape, coo.nnz,
               device=coo.device)


def _first_of_runs(rows: torch.Tensor, cols: torch.Tensor, n_rows: int) -> torch.Tensor:
    prev_r = torch.cat([rows.new_full((1,), -1), rows[:-1]])
    prev_c = torch.cat([cols.new_full((1,), -1), cols[:-1]])
    return (((rows != prev_r) | (cols != prev_c)) & (rows < n_rows)).to(torch.int32)


@takes_handle
def compute_duplicates_mask(rows: torch.Tensor, cols: torch.Tensor, n_rows: int) -> torch.Tensor:
    """int32: 1 at the first occurrence of each (row, col) of a (row,
    col)-sorted input, else 0; padding (row == n_rows) is 0 (reference
    compute_duplicates_mask, sparse/op/reduce.hpp:47)."""
    return _first_of_runs(rows, cols, n_rows)


def _dedup(coo: COO, reduce: str) -> COO:
    """Reduce the sorted runs of equal (row, col) into the first slots."""
    s = _sorted(coo)
    slot = torch.cumsum(_first_of_runs(s.rows, s.cols, s.n_rows), 0) - 1
    cap = s.capacity
    n_unique = (slot[-1] + 1).to(torch.int32)
    valid = s.valid_mask()
    # padding reduces into the last slot, in range only when no padding exists
    slot = torch.where(valid, slot, cap - 1)
    in_range = torch.arange(cap, device=s.device) < n_unique
    if reduce == "sum":
        # runs are contiguous and ascending: a segmented sum in row order
        lengths = torch.bincount(slot, minlength=cap)
        out_vals = torch.segment_reduce(torch.where(valid, s.vals, 0), "sum", lengths=lengths,
                                        unsafe=True)
    else:
        if s.vals.is_floating_point():
            low = float("-inf")
        else:
            low = torch.iinfo(s.vals.dtype).min
        out_vals = torch.full((cap,), low, dtype=s.vals.dtype, device=s.device).scatter_reduce(
            0, slot, torch.where(valid, s.vals, low), "amax")
    out_rows = torch.full((cap,), _INT32_MAX, dtype=torch.int32, device=s.device).scatter_reduce(
        0, slot, torch.where(valid, s.rows, s.sentinel), "amin")
    out_cols = torch.full((cap,), _INT32_MAX, dtype=torch.int32, device=s.device).scatter_reduce(
        0, slot, torch.where(valid, s.cols, 0), "amin")
    return COO(torch.where(in_range, out_rows, s.sentinel), torch.where(in_range, out_cols, 0),
               torch.where(in_range, out_vals, 0), s.shape, nnz=n_unique, device=s.device)


@takes_handle
def max_duplicates(coo: COO) -> COO:
    """Duplicate coordinates reduced to their maximum, sorted by (row,
    col), valid first (reference max_duplicates, sparse/op/reduce.hpp:70)."""
    return _dedup(coo, "max")


@takes_handle
def sum_duplicates(coo: COO) -> COO:
    """Duplicate coordinates summed, in the order of the sorted entries
    (the symmetrize path's variant of :func:`max_duplicates`)."""
    return _dedup(coo, "sum")


def _remove_scalar(coo: COO, scalar) -> COO:
    keep = coo.valid_mask() & (coo.vals != scalar)
    rows = torch.where(keep, coo.rows, coo.sentinel)
    order = torch.sort((~keep).to(torch.uint8), stable=True).indices
    return COO(rows[order], coo.cols[order], coo.vals[order], coo.shape,
               nnz=keep.sum(dtype=torch.int32), device=coo.device)


@takes_handle
def coo_remove_scalar(coo: COO, scalar) -> COO:
    """Entries whose value equals ``scalar`` dropped: marked with the
    sentinel, then a stable sort to the tail (reference
    coo_remove_scalar, sparse/op/filter.hpp:44)."""
    return _remove_scalar(coo, scalar)


@takes_handle
def coo_remove_zeros(coo: COO) -> COO:
    """:func:`coo_remove_scalar` of 0 (the reference's coo_remove_zeros)."""
    return _remove_scalar(coo, 0)


@takes_handle
def csr_row_op(csr: CSR, fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor]) -> torch.Tensor:
    """``fn(row_ids, data)``: a per-entry function with its row id
    (reference csr_row_op, sparse/op/row_op.hpp:37, which launches a
    lambda per row)."""
    return fn(csr.row_ids(), csr.data)


@takes_handle
def csr_row_slice(csr: CSR, start: int, stop: int) -> CSR:
    """Rows [start, stop) as a new CSR; the output's size depends on the
    data, so it reads two indptr entries on the host (reference
    csr_row_slice_indptr + csr_row_slice_populate, sparse/op/slice.hpp:38,63)."""
    lo, hi = (int(v) for v in csr.indptr[[start, stop]].tolist())
    return CSR(csr.indptr[start:stop + 1] - lo, csr.indices[lo:hi], csr.data[lo:hi],
               (stop - start, csr.n_cols), device=csr.device)
