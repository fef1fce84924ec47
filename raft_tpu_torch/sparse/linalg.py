"""Sparse linear algebra: degrees, row norms, add, transpose, symmetrize,
SpMV and SpMM, weakly connected components.

Port of ``raft_tpu/sparse/linalg.py`` (reference
sparse/linalg/{add,degree,norm,symmetrize,transpose}.hpp and the weak-CC
labeller of sparse/csr.hpp:50-167).  Per-row work is a segmented
reduction over ``indptr`` (``torch.segment_reduce``), in row order, so a
sum gives the same bits on every run; maxima and minima, exact in any
order, may scatter.  Every function takes ``handle=`` or ``device=``
(:func:`raft_tpu_torch.core.handle.takes_handle`, default ``"cuda"``).

The SpMV (:func:`csr_spmv`) is the Lanczos hot loop (spectral operators
of :mod:`raft_tpu_torch.spectral.matrix_wrappers`).  The JAX function is
not a Pallas kernel, so torch ops are its port: a gather of ``x`` at the
column ids, a multiply, and a segmented sum of each row in row order.
``index_add_`` is never used: on the card it adds with atomics, in an
order that changes from run to run, and Lanczos repeats the product
thousands of times, so every solve would differ.  An operator prepares
its matrix once (:func:`spmv_plan`: padding ids zeroed, padding values
zeroed) and calls :func:`spmv` in its loop.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from raft_tpu_torch.core import tuning
from raft_tpu_torch.core.device import as_tensor
from raft_tpu_torch.core.handle import takes_handle
from raft_tpu_torch.sparse.convert import coo_to_csr, csr_to_coo
from raft_tpu_torch.sparse.formats import COO, CSR
from raft_tpu_torch.sparse.op import _dedup, _sorted

# the SpMV routes (csr_spmv's doc), the registry's spmv_impl candidates
SPMV_IMPLS = tuning.candidates("spmv_impl")
_INT32_MAX = 2**31 - 1


def resolve_spmv_impl(impl: Optional[str], csr: CSR, site: str = "csr_spmv") -> str:
    """The SpMV route of ``csr``: ``impl``, else the ``spmv_impl`` knob
    (override, configure, ``RAFT_TPU_SPMV_IMPL``, the tuning table on the
    (rows, nnz) shape class, default ``"segment"``)."""
    return tuning.resolve("spmv_impl", impl, site=site, rows=csr.n_rows, nnz=csr.capacity,
                          dtype=csr.data.dtype)


# --------------------------------------------------------------------- #
# degree (sparse/linalg/degree.hpp)
# --------------------------------------------------------------------- #
def _row_counts(rows: torch.Tensor, keep: torch.Tensor, n_rows: int) -> torch.Tensor:
    idx = torch.where(keep, rows, n_rows).long()
    return torch.bincount(idx, minlength=n_rows + 1)[:-1].to(torch.int32)


@takes_handle
def coo_degree(coo: COO) -> torch.Tensor:
    """int32 nnz per row (reference coo_degree, sparse/linalg/degree.hpp)."""
    return _row_counts(coo.rows, coo.valid_mask(), coo.n_rows)


@takes_handle
def coo_degree_scalar(coo: COO, scalar) -> torch.Tensor:
    """int32 per-row count of entries != scalar (reference
    coo_degree_scalar, sparse/linalg/degree.hpp:66)."""
    return _row_counts(coo.rows, coo.valid_mask() & (coo.vals != scalar), coo.n_rows)


@takes_handle
def csr_degree(csr: CSR) -> torch.Tensor:
    """int32 nnz per row."""
    return torch.diff(csr.indptr)


# --------------------------------------------------------------------- #
# row normalization (sparse/linalg/norm.hpp:36,57)
# --------------------------------------------------------------------- #
def _row_reduce(csr: CSR, vals: torch.Tensor, kind: str) -> torch.Tensor:
    """Each row's sum or max of ``vals`` (entries past ``indptr[-1]`` are
    padding and left out); an empty row's max is -inf."""
    if kind == "max":
        return torch.segment_reduce(vals, "max", offsets=csr.indptr, unsafe=True,
                                    initial=float("-inf"))
    return torch.segment_reduce(vals, "sum", offsets=csr.indptr, unsafe=True)


def _scale_rows(csr: CSR, denom_rows: torch.Tensor) -> CSR:
    """Each entry divided by its row's ``denom_rows``; 0 where that is 0."""
    rows = csr.row_ids().long()
    denom = torch.cat([denom_rows, denom_rows.new_ones(1)])[rows]
    data = torch.where(denom != 0, csr.data / torch.where(denom == 0, 1, denom), 0)
    return CSR(csr.indptr, csr.indices, data, csr.shape, device=csr.device)


@takes_handle
def csr_row_normalize_l1(csr: CSR) -> CSR:
    """Each row scaled to unit L1 norm; zero rows stay zero (reference
    csr_row_normalize_l1, sparse/linalg/norm.hpp:36)."""
    return _scale_rows(csr, _row_reduce(csr, csr.data.abs(), "sum"))


@takes_handle
def csr_row_normalize_max(csr: CSR) -> CSR:
    """Each row divided by its max (reference csr_row_normalize_max,
    sparse/linalg/norm.hpp:57)."""
    mx = _row_reduce(csr, csr.data, "max")
    return _scale_rows(csr, torch.where(torch.isfinite(mx), mx, 0))


@takes_handle
def csr_row_norm(csr: CSR, norm: str = "l2") -> torch.Tensor:
    """Per-row L1, squared L2 or Linf norm of the CSR values."""
    if norm == "l1":
        return _row_reduce(csr, csr.data.abs(), "sum")
    if norm == "l2":
        return _row_reduce(csr, csr.data * csr.data, "sum")
    if norm == "linf":
        r = _row_reduce(csr, csr.data.abs(), "max")
        return torch.where(torch.isfinite(r), r, 0)
    raise ValueError(norm)


# --------------------------------------------------------------------- #
# add (sparse/linalg/add.hpp: csr_add_calc_inds + csr_add_finalize)
# --------------------------------------------------------------------- #
@takes_handle
def csr_add(a: CSR, b: CSR) -> CSR:
    """C = A + B (reference csr_add_calc_inds / csr_add_finalize,
    sparse/linalg/add.hpp:75): both COO views concatenated, sorted,
    duplicates summed.  Capacity a.capacity + b.capacity."""
    ca, cb = csr_to_coo(a), csr_to_coo(b)
    dtype = torch.result_type(ca.vals, cb.vals)
    merged = COO(torch.cat([ca.rows, cb.rows]), torch.cat([ca.cols, cb.cols]),
                 torch.cat([ca.vals.to(dtype), cb.vals.to(dtype)]), a.shape, device=a.device)
    return coo_to_csr(_dedup(merged, "sum"), assume_sorted=True)


# --------------------------------------------------------------------- #
# transpose (sparse/linalg/transpose.hpp:43; cusparseCsr2cscEx2 there)
# --------------------------------------------------------------------- #
@takes_handle
def csr_transpose(csr: CSR) -> CSR:
    """The transpose, by a swap of the COO view and a sort."""
    coo = csr_to_coo(csr)
    valid = coo.valid_mask()
    # after the swap, padding carries the new sentinel (n_cols), so that
    # it keeps sorting last
    t = COO(torch.where(valid, coo.cols, csr.n_cols), torch.where(valid, coo.rows, 0), coo.vals,
            (csr.n_cols, csr.n_rows), nnz=coo.nnz, device=csr.device)
    return coo_to_csr(t)


# --------------------------------------------------------------------- #
# symmetrize (sparse/linalg/symmetrize.hpp:37,150)
# --------------------------------------------------------------------- #
def _symmetrize(coo: COO, reduce_op: Optional[Callable]) -> COO:
    if reduce_op is None:
        reduce_op = torch.add
    s = _sorted(coo)
    valid = s.valid_mask()
    width = s.n_cols + 1
    key = torch.where(valid, s.rows.to(torch.int64) * width + s.cols,
                      torch.iinfo(torch.int64).max)
    # each entry's transposed key (col, row), looked up in the sorted keys
    tkey = s.cols.to(torch.int64) * width + s.rows
    pos = torch.searchsorted(key, tkey).clamp_(0, s.capacity - 1)
    found = (key[pos] == tkey) & valid
    vt = torch.where(found, s.vals[pos], 0)
    # the directed edge (i, j) and its (j, i) copy; where both directions
    # exist both copies appear, and the dedup keeps one (equal for a
    # symmetric reduce_op)
    rows = torch.cat([s.rows, torch.where(valid, s.cols, s.sentinel)])
    cols = torch.cat([s.cols, torch.where(valid, s.rows, 0)])
    vals = torch.cat([torch.where(valid, reduce_op(s.vals, vt), 0),
                      torch.where(valid, reduce_op(vt, s.vals), 0)])
    return _dedup(COO(rows, cols, vals, s.shape, device=s.device), "max")


@takes_handle
def coo_symmetrize(coo: COO, reduce_op: Optional[Callable] = None) -> COO:
    """out(i, j) = reduce_op(v_ij, v_ji) over the union of both edge
    directions, default the sum (reference coo_symmetrize,
    sparse/linalg/symmetrize.hpp:37).  Capacity twice the input's."""
    return _symmetrize(coo, reduce_op)


@takes_handle
def symmetrize_knn(knn_indices: torch.Tensor, knn_dists: torch.Tensor, n: int) -> COO:
    """Symmetrized COO graph of kNN results, out(i, j) the max over both
    directions (reference symmetrize, sparse/linalg/symmetrize.hpp:150)."""
    m, k = knn_indices.shape
    rows = torch.arange(m, dtype=torch.int32, device=knn_indices.device).repeat_interleave(k)
    coo = COO(rows, knn_indices.reshape(-1), knn_dists.reshape(-1), (n, n),
              device=knn_indices.device)
    return _symmetrize(coo, torch.maximum)


# --------------------------------------------------------------------- #
# SpMV and SpMM
# --------------------------------------------------------------------- #
class SpmvPlan(NamedTuple):
    """A CSR prepared for repeated products (module doc)."""
    indptr: torch.Tensor    # (n_rows + 1,) int32
    indices: torch.Tensor   # (capacity,) int32, padding 0
    data: torch.Tensor      # (capacity,), padding 0


def spmv_plan(csr: CSR) -> SpmvPlan:
    """The CSR with its padding made harmless: column 0, value 0."""
    valid = torch.arange(csr.capacity, device=csr.device) < csr.indptr[-1]
    return SpmvPlan(csr.indptr, torch.where(valid, csr.indices, 0),
                    torch.where(valid, csr.data, 0))


def spmv(plan: SpmvPlan, x: torch.Tensor, impl: str = "segment") -> torch.Tensor:
    """y = A @ x for a prepared matrix (routes as in :func:`csr_spmv`)."""
    contrib = plan.data * x[plan.indices]
    if impl == "cumsum":
        cs = torch.cat([contrib.new_zeros(1), torch.cumsum(contrib, 0)])
        return cs[plan.indptr[1:]] - cs[plan.indptr[:-1]]
    return torch.segment_reduce(contrib, "sum", offsets=plan.indptr, unsafe=True)


@takes_handle
def csr_spmv(csr: CSR, x: torch.Tensor, impl: Optional[str] = None) -> torch.Tensor:
    """y = A @ x (replaces cusparseSpMV; reference
    spectral/matrix_wrappers.hpp:180).

    ``impl`` (None: :func:`resolve_spmv_impl`, at each call):

    - ``"segment"``: a gather of ``x`` at the column ids, a multiply, and
      each row's sum in row order (``torch.segment_reduce`` over
      ``indptr``): the same bits on every run.
    - ``"cumsum"``: the JAX prefix-difference form, ``y[i] = cs[indptr[i +
      1]] - cs[indptr[i]]`` over the running sum ``cs`` of the
      contributions.  Accuracy caveat (as in JAX): the difference is of
      the global running sum, so a row's absolute error scales with |cs|
      at its place, not with its own sum; rows with small sums late in a
      large same-signed matrix lose relative precision.
    - ``"sortscan"``: the same values as ``"segment"``, by the same code.
      The JAX sort-scan exists only because element gathers are serial
      on a TPU; its ``x[idx]`` is bitwise a gather, and on the card a
      gather is what it is.
    """
    return spmv(spmv_plan(csr), as_tensor(x, csr.device), resolve_spmv_impl(impl, csr))


@takes_handle
def csr_spmm(csr: CSR, x: torch.Tensor) -> torch.Tensor:
    """Y = A @ X for a dense block X (n_cols, b): the gathered rows of X
    scaled and summed per row in row order (no matrix product)."""
    plan = spmv_plan(csr)
    contrib = plan.data[:, None] * x[plan.indices]
    return torch.segment_reduce(contrib, "sum", offsets=plan.indptr, unsafe=True, axis=0)


# --------------------------------------------------------------------- #
# weakly connected components (sparse/csr.hpp:50-167)
# --------------------------------------------------------------------- #
@takes_handle
def weak_cc(csr: CSR, max_iters: int = 0) -> torch.Tensor:
    """Weakly connected component labels, int32 and 1-based: each vertex
    takes the smallest 1-based vertex id of its component (reference
    weak_cc / weak_cc_batched, sparse/csr.hpp:50,118, Hawick-style label
    propagation with atomicMin).

    A Python loop of sweeps: ``label[v] <- min(label[v], min over
    neighbours)`` in both edge directions (``scatter_reduce`` amin, exact
    in any order), then pointer jumping (``label <- label[label - 1]``),
    until a sweep changes nothing (one host read a sweep) or
    ``max_iters`` sweeps ran (0: no cap).
    """
    n = csr.n_rows
    rows = csr.row_ids()
    valid = rows < n
    src = torch.where(valid, rows, 0).long()
    dst = torch.where(valid, csr.indices, 0).long()
    big = torch.full((n,), _INT32_MAX, dtype=torch.int32, device=csr.device)

    def relax(labels):
        m1 = big.scatter_reduce(0, src, torch.where(valid, labels[dst], _INT32_MAX), "amin")
        m2 = big.scatter_reduce(0, dst, torch.where(valid, labels[src], _INT32_MAX), "amin")
        labels = torch.minimum(labels, torch.minimum(m1, m2))
        return torch.minimum(labels, labels[labels.long() - 1])

    prev = torch.arange(1, n + 1, dtype=torch.int32, device=csr.device)
    labels, it = relax(prev), 1
    while (not max_iters or it < max_iters) and not torch.equal(labels, prev):
        prev, labels = labels, relax(labels)
        it += 1
    return labels
