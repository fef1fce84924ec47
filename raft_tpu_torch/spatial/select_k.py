"""k-selection: per-row top-k of a key matrix.

Port of ``raft_tpu/spatial/select_k.py`` (reference ``select_k``,
knn.hpp:90).  Dispatch is by legality, never by failure:

- float32 (or narrower float) keys with k <= 128 go to K2
  (:func:`raft_tpu_torch.ops.select_tile.select_tile`), which selects the
  smallest; for the largest the keys are negated going in and coming
  out, as the JAX ``top_k_rows(impl="pallas")`` does.
- integer or float64 keys and k > 128 take a stable ``torch.sort``, as the JAX
  package takes ``lax.top_k`` or a sort there.

Either way ties resolve to the smaller column, and the result is sorted
best-first.  On a CPU tensor K2's wrapper takes its plain version.

``impl=`` names the route (``"kernel"``, ``"sort"`` or ``"approx95"``,
the registry's ``select_impl`` candidates); None resolves the
``select_impl`` knob through :func:`raft_tpu_torch.core.tuning.resolve`
(override, configure, ``RAFT_TPU_SELECT_IMPL``, the tuning table on the
(n, k) shape class, then the dispatch above), at each call.  An explicit
``"kernel"`` outside K2's limits raises.

``"approx95"`` is the one approximate select, the JAX ``lax.approx_max_k``
at recall target 0.95 as the TPU computes it (PartialReduce, TPU-KNN,
Chern et al. 2022, arXiv:2206.14286): :func:`approx_bins` gives the bin
count L and the fold count r of jaxlib's
``approx_top_k_reduction_output_size(n, 2, k, 0.95, False, -1)``; each
row, padded to L * 2^r with the worst key, is folded in halves r times
(:func:`approx_fold`), so that bin b keeps the best key of the columns
congruent to b modulo L (ties to the smaller column), and k of the L
winners are selected exactly (K2 for float keys and k <= 128, else the
stable sort; ties to the smaller bin).  At r = 0 the select is exact.
A top-k of a column whose bin held a better key is lost: the recall the
target names.  Float keys only, as in JAX.  (JAX on a CPU falls back to
an exact top-k; the port keeps the TPU's semantics on every device.)
The fold is torch ops, as it is an XLA operation in JAX.  The JAX
``"approx"`` (recall 1.0) and ``"chunked"`` selects give exact
membership, which ``"kernel"`` gives; their names are refused.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from raft_tpu_torch.core import tuning
from raft_tpu_torch.core.device import as_tensor, resolve_device
from raft_tpu_torch.core.error import expects
from raft_tpu_torch.core.utils import ceildiv
from raft_tpu_torch.ops.select_tile import MAX_K, select_tile


# key types K2 takes exactly (float64 keys would lose bits in float32)
_KERNEL_DTYPES = (torch.float32, torch.float16, torch.bfloat16)
# approx95's recall target, and the TPU's lane tiling of a rank-2 operand
# in jaxlib's rule (approx_bins)
APPROX_RECALL = 0.95
_LANES = 128


def _resolve_impl(impl: Optional[str], *, n: int, k: int, dtype) -> str:
    """The select route of one call: ``impl``, else the ``select_impl``
    knob (module doc), else K2 where it is legal (float keys, k <=
    ``MAX_K``) and the stable sort otherwise."""
    impl = tuning.resolve("select_impl", impl, site="select_k", dtype=dtype, n=n, k=k)
    if impl is None:
        impl = "kernel" if dtype in _KERNEL_DTYPES and k <= MAX_K else "sort"
    return impl


def _exact_min(keys: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(m, k) smallest keys ascending and their int64 columns: K2 where
    it takes the keys, else the stable sort (ties to the smaller column)."""
    if keys.dtype in _KERNEL_DTYPES and k <= MAX_K:
        vals, idx = select_tile(keys, k)
        return vals.to(keys.dtype), idx.long()
    vals, idx = torch.sort(keys, dim=1, stable=True)
    return vals[:, :k], idx[:, :k]


def _floor_log2(v: int) -> int:
    return v.bit_length() - 1 if v > 0 else 0


def _ceil_log2(v: int) -> int:
    return (v - 1).bit_length() if v > 1 else 0


def approx_bins(n: int, k: int, recall: float = APPROX_RECALL) -> Tuple[int, int]:
    """``(L, r)``: the bins and the halving folds of an approximate top-k
    of ``k`` over a row of ``n`` keys at ``recall`` (module doc), the rule
    of jaxlib's ``approx_top_k_reduction_output_size`` for a rank-2
    operand without aggregation: enough bins that a top-k key collides
    with another in its bin at the rate the target allows, ``M = (1 -
    k) / ln(recall)`` at least, so r = floor(log2(n / M)), no more than
    ceil(log2(n / 128)), and L = 128 * ceil(ceil(n / 128) / 2^r).  r = 0
    (no fold: exact) for n <= 128 or recall 1; a top-1 folds to 128 bins
    whatever the recall."""
    expects(0.0 < recall <= 1.0, "approx_bins: recall must be in (0, 1], got %r", recall)
    if n <= _LANES:
        return n, 0
    lanes = -(-n // _LANES)
    if k == 1:
        return _LANES, _ceil_log2(lanes)
    if recall == 1.0:
        return n, 0
    m = min(max(int((1.0 - k) / math.log(recall)), _LANES), n)
    r = _floor_log2(n // m)
    if r == 0:
        return n, 0
    r = min(r, _ceil_log2(n // _LANES))
    return _LANES * (-(-lanes // (1 << r))), r


def approx_fold(keys: torch.Tensor, bins: int, folds: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(m, bins) best (smallest) keys of each bin and their int32 columns:
    the row padded to ``bins * 2^folds`` with +inf, then folded in halves
    ``folds`` times; a half's key replaces the other's only where it is
    smaller or the other is NaN, so ties and NaN pairs keep the smaller
    column.  Column ``c`` ends in bin ``c mod bins``."""
    m, n = keys.shape
    width = bins << folds
    x = torch.nn.functional.pad(keys, (0, width - n), value=float("inf"))
    col = None
    for _ in range(folds):
        h = x.shape[1] // 2
        a, b = x[:, :h], x[:, h:]
        take = (b < a) | (torch.isnan(a) & ~torch.isnan(b))
        x = torch.where(take, b, a)
        if col is None:
            ramp = torch.arange(h, dtype=torch.int32, device=keys.device)
            col = ramp + take.to(torch.int32) * h
        else:
            col = torch.where(take, col[:, h:], col[:, :h])
    if col is None:
        col = torch.arange(width, dtype=torch.int32, device=keys.device).expand(m, width)
    return x, col


def approx95_cols(keys: torch.Tensor, k: int,
                  select_min: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ``"approx95"`` select (module doc): (m, k) keys best-first and
    their int64 columns."""
    expects(keys.is_floating_point(),
            "select_k: impl='approx95' needs float keys, got %s", keys.dtype)
    n = keys.shape[1]
    mk = keys if select_min else -keys
    bins, folds = approx_bins(n, k)
    if folds == 0:
        vals, idx = _exact_min(mk, k)
    else:
        win, col = approx_fold(mk, bins, folds)
        vals, pos = _exact_min(win, k)
        # a pad's column wins a bin only where every key of it is NaN
        idx = torch.clamp(torch.gather(col, 1, pos.long()), max=n - 1).long()
    return (vals if select_min else -vals).to(keys.dtype), idx.long()


def _select_cols(keys: torch.Tensor, k: int, select_min: bool,
                 impl: Optional[str] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(m, k) best keys and their int64 column ids."""
    impl = _resolve_impl(impl, n=keys.shape[1], k=k, dtype=keys.dtype)
    if impl == "approx95":
        return approx95_cols(keys, k, select_min)
    if impl == "kernel":
        vals, idx = select_tile(keys if select_min else -keys, k)
        return (vals if select_min else -vals).to(keys.dtype), idx.long()
    vals, idx = torch.sort(keys, dim=1, descending=not select_min, stable=True)
    return vals[:, :k], idx[:, :k]


def top_k_rows(sel: torch.Tensor, k: int,
               impl: Optional[str] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row k largest, with int32 column ids; ``impl`` as in
    :func:`select_k`."""
    vals, idx = _select_cols(sel, k, select_min=False, impl=impl)
    return vals, idx.to(torch.int32)


def select_k(
    keys,
    k: int,
    select_min: bool = True,
    values=None,
    impl: Optional[str] = None,
    device="cuda",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Select the k smallest (or largest) keys per row.

    Parameters
    ----------
    keys:
        (m, n) key matrix (numpy array or tensor), moved to ``device``.
    k:
        Entries to keep per row (0 < k <= n).
    select_min:
        True: k smallest (distances); False: k largest (inner products).
    values:
        Optional (m, n) payload carried through the selection; defaults
        to the column index.
    impl:
        ``"kernel"`` (K2), ``"sort"``, ``"approx95"`` or None (module
        doc).

    Returns
    -------
    (out_keys, out_values): (m, k), best-first; int32 column ids when
    ``values`` is None, else the payload's dtype.
    """
    dev = resolve_device(device)
    keys = as_tensor(keys, dev)
    expects(keys.ndim == 2, "select_k: 2-D keys required")
    n = keys.shape[1]
    expects(0 < k <= n, "select_k: k=%d out of range for n=%d", k, n)
    out_keys, cols = _select_cols(keys, k, select_min, impl)
    if values is None:
        return out_keys, cols.to(torch.int32)
    values = as_tensor(values, dev)
    expects(values.shape == keys.shape, "select_k: values shape %s != keys shape %s",
            tuple(values.shape), tuple(keys.shape))
    return out_keys, torch.gather(values, 1, cols)


def chunked_top_k(sel: torch.Tensor, k: int,
                  chunk: int = 256) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact per-row k largest as a merge tree of small selections.

    Port of the JAX ``chunked_top_k``: each row is cut into ``chunk``-wide
    pieces, each piece keeps its k best, and sorted lists are merged
    pairwise.  Pads are the minimum of the dtype (-inf for floats), and
    ids of deficit slots are clamped into the row.  Ties resolve to the
    smaller column.
    """
    nq, w = sel.shape
    if w <= max(2 * k, chunk):
        return top_k_rows(sel, k)
    pad_value = (float("-inf") if sel.is_floating_point()
                 else torch.iinfo(sel.dtype).min)
    c = ceildiv(w, chunk)
    x = torch.nn.functional.pad(sel, (0, c * chunk - w), value=pad_value)
    kc = min(k, chunk)
    vals, idx = torch.sort(x.reshape(nq, c, chunk), dim=2, descending=True, stable=True)
    vals = vals[:, :, :kc]
    idx = idx[:, :, :kc] + (torch.arange(c, device=sel.device) * chunk)[None, :, None]
    while c > 1:
        if c % 2:
            vals = torch.nn.functional.pad(vals, (0, 0, 0, 1), value=pad_value)
            idx = torch.nn.functional.pad(idx, (0, 0, 0, 1), value=w)
            c += 1
        vals = vals.reshape(nq, c // 2, 2 * kc)
        idx = idx.reshape(nq, c // 2, 2 * kc)
        kc2 = min(k, 2 * kc)
        vals, pos = torch.sort(vals, dim=2, descending=True, stable=True)
        vals = vals[:, :, :kc2]
        idx = torch.gather(idx, 2, pos[:, :, :kc2])
        kc = kc2
        c //= 2
    return vals[:, 0, :k], torch.clamp(idx[:, 0, :k], max=w - 1).to(torch.int32)
