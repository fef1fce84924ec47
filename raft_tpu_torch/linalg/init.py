"""Sequence initialisation (port of ``raft_tpu/linalg/init.py``;
reference cpp/include/raft/linalg/init.h:40, fill with [start, end))."""

from __future__ import annotations

import torch

from raft_tpu_torch.core.handle import takes_handle


@takes_handle
def range_init(start: int, end: int, dtype=torch.int32, *, device=None) -> torch.Tensor:
    """The integer range [start, end) on the device (reference init.h:40)."""
    return torch.arange(start, end, dtype=dtype, device=device)
