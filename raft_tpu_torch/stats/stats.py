"""Column statistics over (n_samples, n_features) data.

Port of ``raft_tpu/stats/stats.py`` (reference cpp/include/raft/stats/:
mean.hpp:44, stddev.hpp:45,76, sum.hpp:41, mean_center.hpp:41,77).  One
value per column (feature); the row- and column-major flags are kept for
the signature, the logical reduction over axis 0 is what remains.
"""

from __future__ import annotations

from typing import Optional

import torch

from raft_tpu_torch.core.handle import takes_handle


def _vars(data, mu=None, sample=True):
    if mu is None:
        mu = data.mean(dim=0)
    n = data.shape[0]
    ss = ((data - mu[None, :]) ** 2).sum(dim=0)
    return ss / (n - 1 if sample else n)


@takes_handle
def mean(data: torch.Tensor, sample: bool = False, row_major: bool = True) -> torch.Tensor:
    """Per-column mean (reference stats/mean.hpp:44; ``sample`` is kept for
    the signature: the divisor of a mean is n in the reference too)."""
    del sample, row_major
    return data.mean(dim=0)


@takes_handle
def sum_cols(data: torch.Tensor, row_major: bool = True) -> torch.Tensor:
    """Per-column sum (reference stats/sum.hpp:41)."""
    del row_major
    return data.sum(dim=0)


@takes_handle
def vars_(data: torch.Tensor, mu: Optional[torch.Tensor] = None, sample: bool = True,
          row_major: bool = True) -> torch.Tensor:
    """Per-column variance (reference stats/stddev.hpp:76 ``vars``)."""
    del row_major
    return _vars(data, mu, sample)


@takes_handle
def stddev(data: torch.Tensor, mu: Optional[torch.Tensor] = None, sample: bool = True,
           row_major: bool = True) -> torch.Tensor:
    """Per-column standard deviation (reference stats/stddev.hpp:45)."""
    del row_major
    return torch.sqrt(_vars(data, mu, sample))


@takes_handle
def mean_center(data: torch.Tensor, mu: torch.Tensor,
                bcast_along_rows: bool = True) -> torch.Tensor:
    """Subtract the mean vector (reference stats/mean_center.hpp:41)."""
    return data - (mu[None, :] if bcast_along_rows else mu[:, None])


@takes_handle
def mean_add(data: torch.Tensor, mu: torch.Tensor, bcast_along_rows: bool = True) -> torch.Tensor:
    """Add the mean vector back (reference stats/mean_center.hpp:77)."""
    return data + (mu[None, :] if bcast_along_rows else mu[:, None])
