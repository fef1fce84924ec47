"""Row/column norms and MSE.

Port of ``raft_tpu/linalg/norm.py`` (reference
cpp/include/raft/linalg/norm.cuh: ``NormType`` :25, ``rowNorm`` :48,
``colNorm`` :105; mean_squared_error.cuh:36), with the JAX package's
``LinfNorm``.
"""

from __future__ import annotations

import enum
from typing import Callable, Optional

import torch

from raft_tpu_torch.core.handle import takes_handle


class NormType(enum.IntEnum):
    """(reference norm.cuh:25)"""

    L1Norm = 0
    L2Norm = 1
    LinfNorm = 2


L1Norm = NormType.L1Norm
L2Norm = NormType.L2Norm
LinfNorm = NormType.LinfNorm


def _norm(data: torch.Tensor, dim: int, norm_type: NormType, do_sqrt: bool,
          fin_op: Optional[Callable]) -> torch.Tensor:
    if norm_type == NormType.L1Norm:
        out = data.abs().sum(dim=dim)
    elif norm_type == NormType.L2Norm:
        out = (data * data).sum(dim=dim)
    else:
        out = data.abs().amax(dim=dim)
    if do_sqrt:
        out = torch.sqrt(out)
    if fin_op is not None:
        out = fin_op(out)
    return out


@takes_handle
def row_norm(data: torch.Tensor, norm_type: NormType = NormType.L2Norm, do_sqrt: bool = False,
             fin_op: Optional[Callable] = None) -> torch.Tensor:
    """Per-row norm (reference norm.cuh:48 ``rowNorm``); L2 without
    sqrt gives squared norms, as the expanded distances use them."""
    return _norm(data, -1, norm_type, do_sqrt, fin_op)


@takes_handle
def col_norm(data: torch.Tensor, norm_type: NormType = NormType.L2Norm, do_sqrt: bool = False,
             fin_op: Optional[Callable] = None) -> torch.Tensor:
    """Per-column norm (reference norm.cuh:105 ``colNorm``)."""
    return _norm(data, 0, norm_type, do_sqrt, fin_op)


@takes_handle
def mean_squared_error(a: torch.Tensor, b: torch.Tensor, weight: float = 1.0) -> torch.Tensor:
    """``weight * mean((a - b)^2)`` (reference mean_squared_error.cuh:36)."""
    diff = a - b
    return weight * (diff * diff).mean()
