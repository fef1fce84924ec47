"""QR decomposition (port of ``raft_tpu/linalg/qr.py``; reference
cpp/include/raft/linalg/qr.cuh:44,88, cuSOLVER geqrf/orgqr).  The JAX
package runs XLA's QR outside any Pallas kernel; the port's is
:func:`torch.linalg.qr` (cuSOLVER on the card)."""

from __future__ import annotations

from typing import Tuple

import torch

from raft_tpu_torch.core.handle import takes_handle


@takes_handle
def qr_get_q(a: torch.Tensor) -> torch.Tensor:
    """Orthonormal Q of the thin QR (reference qr.cuh:44 ``qrGetQ``)."""
    return torch.linalg.qr(a, mode="reduced").Q


@takes_handle
def qr_get_qr(a: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Thin QR ``(q, r)`` (reference qr.cuh:88 ``qrGetQR``)."""
    q, r = torch.linalg.qr(a, mode="reduced")
    return q, r
