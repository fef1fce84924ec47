"""Broadcast a vector operation across matrix rows or columns.

Port of ``raft_tpu/linalg/matrix_vector_op.py`` (reference
cpp/include/raft/linalg/matrix_vector_op.cuh:120 ``matrixVectorOp`` and
the two-vector variant :190).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from raft_tpu_torch.core.error import expects
from raft_tpu_torch.core.handle import takes_handle


@takes_handle
def matrix_vector_op(mat: torch.Tensor, vec: torch.Tensor, op: Callable,
                     bcast_along_rows: bool = True, vec2: Optional[torch.Tensor] = None,
                     row_major: bool = True) -> torch.Tensor:
    """Apply ``op`` between ``mat`` and the broadcast ``vec`` (and
    ``vec2``).  ``bcast_along_rows=True``: one vector entry per column,
    broadcast down the rows (the reference's ``bcastAlongRows``); False:
    one per row.  ``row_major`` is kept for the signature."""
    del row_major
    n = mat.shape[-1] if bcast_along_rows else mat.shape[0]
    expects(vec.shape[0] == n, "matrix_vector_op: vector length %d does not match matrix "
            "dim %d", vec.shape[0], n)
    v = vec[None, :] if bcast_along_rows else vec[:, None]
    if vec2 is None:
        return op(mat, v)
    v2 = vec2[None, :] if bcast_along_rows else vec2[:, None]
    return op(mat, v, v2)
