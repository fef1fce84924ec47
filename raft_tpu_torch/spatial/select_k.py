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

``impl=`` names the route (``"kernel"`` or ``"sort"``, the registry's
``select_impl`` candidates); None resolves the
``select_impl`` knob through :func:`raft_tpu_torch.core.tuning.resolve`
(override, configure, ``RAFT_TPU_SELECT_IMPL``, the tuning table on the
(n, k) shape class, then the dispatch above), at each call.  An explicit
``"kernel"`` outside K2's limits raises.  The JAX package's approximate
and chunked selects have no counterpart, and their names are refused.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from raft_tpu_torch.core import tuning
from raft_tpu_torch.core.device import as_tensor, resolve_device
from raft_tpu_torch.core.error import expects
from raft_tpu_torch.core.utils import ceildiv
from raft_tpu_torch.ops.select_tile import MAX_K, select_tile


# key types K2 takes exactly (float64 keys would lose bits in float32)
_KERNEL_DTYPES = (torch.float32, torch.float16, torch.bfloat16)

def _resolve_impl(impl: Optional[str], *, n: int, k: int, dtype) -> str:
    """The select route of one call: ``impl``, else the ``select_impl``
    knob (module doc), else K2 where it is legal (float keys, k <=
    ``MAX_K``) and the stable sort otherwise."""
    impl = tuning.resolve("select_impl", impl, site="select_k", dtype=dtype, n=n, k=k)
    if impl is None:
        impl = "kernel" if dtype in _KERNEL_DTYPES and k <= MAX_K else "sort"
    return impl


def _select_cols(keys: torch.Tensor, k: int, select_min: bool,
                 impl: Optional[str] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(m, k) best keys and their int64 column ids."""
    if _resolve_impl(impl, n=keys.shape[1], k=k, dtype=keys.dtype) == "kernel":
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
        ``"kernel"`` (K2), ``"sort"`` or None (module doc).

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
