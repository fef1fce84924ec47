"""Transpose (port of ``raft_tpu/linalg/transpose.py``; reference
cpp/include/raft/linalg/transpose.h:36, cuBLAS geam out of place)."""

from __future__ import annotations

import torch

from raft_tpu_torch.core.handle import takes_handle


@takes_handle
def transpose(a: torch.Tensor) -> torch.Tensor:
    """Out-of-place transpose (reference transpose.h:36): a new
    contiguous tensor, not a view."""
    return a.T.contiguous()
