"""Pairwise distance computation: every runtime-dispatchable metric.

Port of ``raft_tpu/distance/pairwise.py`` (reference distance.hpp:53-307).
Two regimes, as there:

- **Expanded metrics** (L2Expanded, L2SqrtExpanded, Cosine, Correlation,
  InnerProduct, Hellinger, RusselRao, KL): the accumulation is a dot
  product, so each metric is one ``torch.matmul`` plus row vectors and an
  element-wise epilogue.  The JAX package leaves these to XLA outside any
  kernel.  Matmuls run in full float32 (``precision="highest"``, no TF32);
  ``precision="default"`` rounds the operands to bfloat16, the
  single-pass product of the JAX ``"default"``.
- **Unexpanded metrics** (L1, L2Unexpanded, L2SqrtUnexpanded, Linf,
  Canberra, LpUnexpanded, Hamming, JensenShannon and the BrayCurtis
  numerator): the accumulation is a non-linear function of (x_ik, y_jk)
  and runs on K5 (:mod:`raft_tpu_torch.ops.pairwise_tile`).

Parity notes (as in the JAX package): cosine and correlation return
distances ``1 - sim``; KL returns 0.5 * KL; Hellinger is
``sqrt(max(0, 1 - sum sqrt(x) sqrt(y)))``; RusselRao is ``(k - x.y) / k``.
Unsupported metrics raise.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from raft_tpu_torch.core import precision as _precision
from raft_tpu_torch.core.device import as_tensor, resolve_device
from raft_tpu_torch.core.error import expects, fail
from raft_tpu_torch.distance.distance_type import DistanceType
from raft_tpu_torch.ops.pairwise_tile import pairwise_tile

D = DistanceType

PRECISIONS = ("highest", "default")


def matmul(a: torch.Tensor, b: torch.Tensor, precision: str = "highest") -> torch.Tensor:
    """``a @ b`` in IEEE float32 (:mod:`raft_tpu_torch.core.precision`), or
    with bfloat16 operands for ``"default"``."""
    expects(precision in PRECISIONS, "precision must be one of %s, got %r",
            PRECISIONS, precision)
    if precision == "default":
        return torch.matmul(a.to(torch.bfloat16), b.to(torch.bfloat16)).to(torch.float32)
    return _precision.matmul(a, b)


def expanded_sq_dists(x, y, precision: str = "highest") -> torch.Tensor:
    """(m, n) clamped squared L2 in the expanded form ``xn + yn - 2 x.yT``."""
    xn = (x * x).sum(dim=1)
    yn = (y * y).sum(dim=1)
    return torch.clamp(xn[:, None] + yn[None, :] - 2.0 * matmul(x, y.T, precision),
                       min=0.0)


def _cosine(x, y, precision):
    xn = torch.sqrt((x * x).sum(dim=1))
    yn = torch.sqrt((y * y).sum(dim=1))
    den = xn[:, None] * yn[None, :]
    sim = torch.where(den > 0, matmul(x, y.T, precision) / torch.where(den == 0, 1.0, den),
                      torch.zeros_like(den))
    return 1.0 - sim


def _correlation(x, y, precision):
    k = x.shape[1]
    dot = matmul(x, y.T, precision)
    sx, sy = x.sum(dim=1), y.sum(dim=1)
    sx2, sy2 = (x * x).sum(dim=1), (y * y).sum(dim=1)
    numer = k * dot - sx[:, None] * sy[None, :]
    q = k * sx2 - sx * sx
    r = k * sy2 - sy * sy
    return 1.0 - numer / torch.sqrt(q[:, None] * r[None, :])


def _hellinger(x, y, precision):
    acc = matmul(torch.sqrt(x.abs()), torch.sqrt(y.abs()).T, precision)
    return torch.sqrt(torch.clamp(1.0 - acc, min=0.0))


def _kl_divergence(x, y, precision):
    # 0.5 * sum_k x (log x - log y), 0 log 0 = 0, log y dropped where y == 0
    x_logx = torch.where(x > 0, x * torch.log(torch.where(x > 0, x, 1.0)),
                         torch.zeros_like(x))
    log_y = torch.where(y > 0, torch.log(torch.where(y > 0, y, 1.0)), torch.zeros_like(y))
    return 0.5 * (x_logx.sum(dim=1)[:, None] - matmul(x, log_y.T, precision))


def _bray_curtis(x, y):
    num = pairwise_tile(x, y, D.L1)
    den = x.sum(dim=1)[:, None] + y.sum(dim=1)[None, :]
    return torch.where(den == 0, torch.zeros_like(num), num / torch.where(den == 0, 1.0, den))


def pairwise_distance(
    x,
    y,
    metric: DistanceType = D.L2Expanded,
    metric_arg: float = 2.0,
    fin_op: Optional[Callable] = None,
    precision: str = "highest",
    device="cuda",
) -> torch.Tensor:
    """All-pairs distances between rows of x (m, k) and y (n, k).

    ``metric_arg`` is the Minkowski p; ``fin_op`` an optional element-wise
    final function (reference FinalLambda).  ``precision`` applies to the
    matmul-backed metrics.  Inputs (numpy arrays or tensors) are moved to
    ``device``; the result is float32 there.
    """
    dev = resolve_device(device)
    x = as_tensor(x, dev)
    y = as_tensor(y, dev)
    expects(x.ndim == 2 and y.ndim == 2, "pairwise_distance: 2-D inputs required")
    expects(x.shape[1] == y.shape[1],
            "pairwise_distance: dimensionality mismatch (%d vs %d)",
            x.shape[1], y.shape[1])
    if metric in (D.L2Expanded, D.L2SqrtExpanded, D.CosineExpanded,
                  D.CorrelationExpanded, D.InnerProduct, D.HellingerExpanded,
                  D.RusselRaoExpanded, D.KLDivergence):
        x = x.to(torch.float32)
        y = y.to(torch.float32)
    if metric == D.L2Expanded:
        out = expanded_sq_dists(x, y, precision)
    elif metric == D.L2SqrtExpanded:
        out = torch.sqrt(expanded_sq_dists(x, y, precision))
    elif metric == D.CosineExpanded:
        out = _cosine(x, y, precision)
    elif metric == D.CorrelationExpanded:
        out = _correlation(x, y, precision)
    elif metric == D.InnerProduct:
        out = matmul(x, y.T, precision)
    elif metric == D.HellingerExpanded:
        out = _hellinger(x, y, precision)
    elif metric == D.RusselRaoExpanded:
        k = x.shape[1]
        out = (k - matmul(x, y.T, precision)) / k
    elif metric == D.KLDivergence:
        out = _kl_divergence(x, y, precision)
    elif metric == D.BrayCurtis:
        out = _bray_curtis(x.to(torch.float32), y.to(torch.float32))
    elif metric in (D.L1, D.L2Unexpanded, D.L2SqrtUnexpanded, D.Linf, D.Canberra,
                    D.LpUnexpanded, D.JensenShannon, D.HammingUnexpanded):
        out = pairwise_tile(x, y, metric, float(metric_arg))
    else:
        fail("Unknown or unsupported distance metric '%d'!", int(metric))
    if fin_op is not None:
        out = fin_op(out)
    return out
