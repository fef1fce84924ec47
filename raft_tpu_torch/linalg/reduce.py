"""Reductions with pluggable main/reduce/final operations.

Port of ``raft_tpu/linalg/reduce.py`` (reference
cpp/include/raft/linalg/ ``coalescedReduction``
coalesced_reduction.cuh:97, ``stridedReduction``
strided_reduction.cuh:138, ``reduce`` reduce.cuh:61,
``mapThenReduce`` / ``mapThenSumReduce`` map_then_reduce.cuh:113,144).

``main_op(value, index)`` maps each element, ``reduce_op(a, b)`` combines
two tensors elementwise (a torch function such as ``torch.maximum``), and
``final_op`` maps the result; without ``reduce_op`` the reduction is a
sum.  The JAX package folds a generic ``reduce_op`` over the reduced axis
one element at a time; on the card that would be one launch a column
(4,096 at the width of ``BASELINE.md`` config #2).  Here a generic
``reduce_op`` runs as a pairwise tree instead: each step combines
neighbouring entries (0 with 1, 2 with 3, ...), log2(n) steps in all,
and ``init`` enters once at the end.  That order is valid for the
associative operations the reference assumes, and gives the fold's
result up to the rounding of a reordered sum.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from raft_tpu_torch.core.handle import takes_handle


def _identity_main(x, idx):
    return x


def _tree_reduce(mapped: torch.Tensor, dim: int, reduce_op: Callable, init) -> torch.Tensor:
    """``reduce_op`` over ``dim`` as a pairwise tree (module doc)."""
    x = mapped.movedim(dim, 0)
    acc = torch.full(x.shape[1:], init, dtype=x.dtype, device=x.device)
    if x.shape[0] == 0:
        return acc
    while x.shape[0] > 1:
        pairs = x.shape[0] // 2
        y = reduce_op(x[0:2 * pairs:2], x[1:2 * pairs:2])
        x = torch.cat([y, x[2 * pairs:]]) if x.shape[0] % 2 else y
    return reduce_op(acc, x[0])


def _apply_reduce(mapped: torch.Tensor, dim: int, reduce_op, init) -> torch.Tensor:
    if reduce_op is None:
        return mapped.sum(dim=dim)
    return _tree_reduce(mapped, dim, reduce_op, init)


def _reduce(data, dim, main_op=None, reduce_op=None, final_op=None, init=0.0,
            inplace_accumulate=None):
    """Map, reduce over ``dim`` (-1: coalesced, 0: strided), accumulate, finish."""
    main_op = main_op or _identity_main
    idx = torch.arange(data.shape[dim], device=data.device)
    out = _apply_reduce(main_op(data, idx if dim == -1 else idx[:, None]), dim, reduce_op,
                        init)
    if inplace_accumulate is not None:
        out = out + inplace_accumulate
    if final_op is not None:
        out = final_op(out)
    return out


@takes_handle
def coalesced_reduction(data: torch.Tensor, main_op: Optional[Callable] = None,
                        reduce_op: Optional[Callable] = None,
                        final_op: Optional[Callable] = None, init: float = 0.0,
                        inplace_accumulate: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Reduce along the last (contiguous) axis (reference
    coalesced_reduction.cuh:97)."""
    return _reduce(data, -1, main_op, reduce_op, final_op, init, inplace_accumulate)


@takes_handle
def strided_reduction(data: torch.Tensor, main_op: Optional[Callable] = None,
                      reduce_op: Optional[Callable] = None,
                      final_op: Optional[Callable] = None, init: float = 0.0,
                      inplace_accumulate: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Reduce along the first (strided) axis (reference
    strided_reduction.cuh:138)."""
    return _reduce(data, 0, main_op, reduce_op, final_op, init, inplace_accumulate)


@takes_handle
def reduce(data: torch.Tensor, along_rows: bool = True, row_major: bool = True,
           main_op: Optional[Callable] = None, reduce_op: Optional[Callable] = None,
           final_op: Optional[Callable] = None, init: float = 0.0) -> torch.Tensor:
    """Row or column reduction (reference reduce.cuh:61):
    ``along_rows=True`` reduces each row to one value.  ``row_major`` is
    kept for the signature; the logical view alone decides."""
    del row_major
    return _reduce(data, -1 if along_rows else 0, main_op, reduce_op, final_op, init)


@takes_handle
def map_then_reduce(op: Callable, reduce_op: Optional[Callable], init: float,
                    *arrays: torch.Tensor) -> torch.Tensor:
    """Map an n-ary operation, then reduce to a scalar (reference
    map_then_reduce.cuh:113)."""
    mapped = op(*arrays)
    if reduce_op is None:
        return mapped.sum()
    return _tree_reduce(mapped.reshape(-1), 0, reduce_op, init)


@takes_handle
def map_then_sum_reduce(op: Callable, *arrays: torch.Tensor) -> torch.Tensor:
    """Map, then sum (reference map_then_reduce.cuh:144)."""
    return op(*arrays).sum()
