"""Rank-1 Cholesky update.

Port of ``raft_tpu/linalg/cholesky.py`` (reference
cpp/include/raft/linalg/cholesky_r1_update.cuh:125): given the Cholesky
factor of the leading (n-1, n-1) block of A, extend it to the (n, n)
block after a row and column are appended; a triangular solve
(:func:`torch.linalg.solve_triangular`) and a dot product.
"""

from __future__ import annotations

from typing import Optional

import torch

from raft_tpu_torch.core.error import expects
from raft_tpu_torch.core.handle import takes_handle


def _checked_sqrt(d: torch.Tensor, eps: Optional[float]) -> torch.Tensor:
    """sqrt of the new diagonal element, with the reference's
    positive-definiteness check (raises when d <= eps)."""
    if eps is not None:
        expects(bool(d > eps), "cholesky_rank1_update: matrix is not positive definite")
    return torch.sqrt(d)


@takes_handle
def cholesky_rank1_update(l_full: torch.Tensor, n: int, lower: bool = True,
                          eps: Optional[float] = None) -> torch.Tensor:
    """Extend a Cholesky factorisation by one row and column.

    ``l_full`` is (n, n): its leading (n-1, n-1) block holds the factor L
    of A[:n-1, :n-1] and its last row (``lower``) or column holds the new
    entries of A.  Returns a copy with the new row or column replaced by
    the updated factor.  ``eps``: positive-definiteness threshold of the
    new diagonal element."""
    expects(l_full.ndim == 2 and l_full.shape[0] == l_full.shape[1],
            "cholesky_rank1_update: square input required")
    expects(1 <= n <= l_full.shape[0], "cholesky_rank1_update: invalid n=%d", n)
    out = l_full.clone()
    if n == 1:
        out[0, 0] = _checked_sqrt(l_full[0, 0], eps)
        return out
    k = n - 1
    if lower:
        # L_21 = L^-1 a (a triangular solve), L_22 = sqrt(a_nn - |L_21|^2)
        l21 = torch.linalg.solve_triangular(l_full[:k, :k], l_full[k, :k, None],
                                            upper=False)[:, 0]
        out[k, :k] = l21
    else:
        l21 = torch.linalg.solve_triangular(l_full[:k, :k].T, l_full[:k, k, None],
                                            upper=False)[:, 0]
        out[:k, k] = l21
    out[k, k] = _checked_sqrt(l_full[k, k] - torch.dot(l21, l21), eps)
    return out
