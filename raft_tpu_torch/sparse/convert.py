"""Format conversions: COO <-> CSR <-> dense.

Port of ``raft_tpu/sparse/convert.py`` (reference
sparse/convert/csr.hpp:27 ``coo_to_csr``, :55-95 ``sorted_coo_to_csr``,
sparse/convert/coo.hpp:34 ``csr_to_coo``, sparse/convert/dense.hpp:44
``csr_to_dense``).  The reference's atomic histogram and exclusive scan
become one ``searchsorted`` over the sorted row ids, and the sort by
(row, col) one stable sort of the combined int64 key.  The conversions
run on their container's device; :func:`dense_to_csr` takes ``device=``.
"""

from __future__ import annotations

import torch

from raft_tpu_torch.sparse.formats import COO, CSR


def sorted_rows_to_indptr(rows: torch.Tensor, n_rows: int) -> torch.Tensor:
    """int32 indptr from row-sorted COO row ids (padding rows == n_rows
    sort last); reference sorted_coo_to_csr (sparse/convert/csr.hpp:55)."""
    targets = torch.arange(n_rows + 1, dtype=torch.int32, device=rows.device)
    return torch.searchsorted(rows.to(torch.int32), targets, out_int32=True)


def lexsort_rows_cols(rows: torch.Tensor, cols: torch.Tensor, n_cols: int) -> torch.Tensor:
    """The permutation of a stable sort by (row, col), as ``jnp.lexsort((cols,
    rows))`` gives it (int64 keys: ``row * (n_cols + 1)`` passes 2^31 on a
    graph of some 46,000 vertices)."""
    key = rows.to(torch.int64) * (n_cols + 1) + cols.to(torch.int64)
    return torch.sort(key, stable=True).indices


def coo_to_csr(coo: COO, assume_sorted: bool = False) -> CSR:
    """COO to CSR (reference sparse/convert/csr.hpp:27): sorted by (row,
    col) unless ``assume_sorted``; padding stays at the tail."""
    rows, cols, vals = coo.rows, coo.cols, coo.vals
    if not assume_sorted:
        order = lexsort_rows_cols(rows, cols, coo.n_cols)
        rows, cols, vals = rows[order], cols[order], vals[order]
    return CSR(sorted_rows_to_indptr(rows, coo.n_rows), cols, vals, coo.shape, device=coo.device)


def csr_to_coo(csr: CSR) -> COO:
    """Expand indptr to per-entry row ids (reference
    sparse/convert/coo.hpp:34); ``nnz`` stays on the device."""
    return COO(csr.row_ids(), csr.indices, csr.data, csr.shape, nnz=csr.indptr[-1],
               device=csr.device)


def csr_to_dense(csr: CSR) -> torch.Tensor:
    """Densify (reference sparse/convert/dense.hpp:44; duplicates sum)."""
    return csr.to_dense()


def dense_to_csr(dense, capacity: int | None = None, device="cuda") -> CSR:
    """Dense to CSR (on the host, then moved to ``device``, default
    ``"cuda"``), the inverse of :func:`csr_to_dense`."""
    return CSR.from_dense(dense, capacity, device=device)
