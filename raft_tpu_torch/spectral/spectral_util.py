"""Spectral utilities: eigenvector whitening, cluster indicators.

Port of ``raft_tpu/spectral/spectral_util.py`` (reference
spectral/spectral_util.hpp: ``transform_eigen_matrix`` :109,
``construct_indicator`` :44).  Both take ``handle=`` or ``device=``
(:func:`raft_tpu_torch.core.handle.takes_handle`, default ``"cuda"``).
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from raft_tpu_torch.core.handle import takes_handle


@takes_handle
def transform_eigen_matrix(eig_vecs: torch.Tensor) -> torch.Tensor:
    """Whitened eigenvector columns: the column mean subtracted, divided
    by (column norm / sqrt(n)) (reference spectral_util.hpp:118-145).

    A column that is numerically constant (centred norm at most 1e-3 of
    its raw norm, as the trivial all-ones Laplacian eigenvector) is
    zeroed: dividing float32 eigensolver noise by its own tiny norm would
    hand k-means a unit-variance coordinate of noise."""
    n = eig_vecs.shape[0]
    centered = eig_vecs - eig_vecs.mean(dim=0, keepdim=True)
    raw = torch.linalg.vector_norm(eig_vecs, dim=0, keepdim=True)
    norms = torch.linalg.vector_norm(centered, dim=0, keepdim=True)
    degenerate = norms <= 1e-3 * torch.clamp(raw, min=torch.finfo(eig_vecs.dtype).tiny)
    scale = norms / math.sqrt(n)
    out = centered / torch.where(scale == 0, 1.0, scale)
    return torch.where(degenerate, 0.0, out)


@takes_handle
def construct_indicator(cluster_id: int, labels: torch.Tensor, op
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The 0/1 indicator x_c of one cluster and its quadratic form
    x_c^T (op) x_c (reference construct_indicator,
    spectral_util.hpp:195-225; the indicator is not normalised).
    Returns (cluster size, quadratic form, valid), valid False for an
    empty cluster."""
    part = (labels == cluster_id).to(torch.float32)
    size = part.sum()
    return size, torch.dot(part, op.mv(part)), size > 0
