"""Class-label utilities: unique labels, monotonic relabelling,
one-vs-rest.

Port of ``raft_tpu/label/classlabels.py`` (reference
label/classlabels.cuh: ``getUniquelabels`` :40, ``getOvrlabels`` :99,
``make_monotonic`` :159,192).  Uniqueness by a sort and a first-occurrence
mask, the output padded to ``max_labels`` as in the JAX package; the
relabel map is one ``searchsorted``.  Every function takes ``handle=`` or
``device=`` (:func:`raft_tpu_torch.core.handle.takes_handle`, default
``"cuda"``).
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from raft_tpu_torch.core.handle import takes_handle


def _unique(labels: torch.Tensor, max_labels: Optional[int]) -> Tuple[torch.Tensor, torch.Tensor]:
    n = labels.shape[0]
    cap = max_labels if max_labels is not None else n
    s = torch.sort(labels).values
    first = torch.cat([torch.ones(1, dtype=torch.bool, device=labels.device), s[1:] != s[:-1]])
    n_unique = first.sum(dtype=torch.int32)
    # the unique values to the front, in order
    order = torch.sort((~first).to(torch.uint8), stable=True).indices
    uniq = s[order][:cap]
    if uniq.shape[0] < cap:
        uniq = torch.cat([uniq, s[-1:].expand(cap - uniq.shape[0])])
    idx = torch.arange(cap, device=labels.device)
    return torch.where(idx < n_unique, uniq, s[-1]), n_unique


@takes_handle
def get_unique_labels(labels: torch.Tensor, max_labels: Optional[int] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sorted unique labels, padded to ``max_labels`` (default
    ``len(labels)``) with the largest label, and their count (a 0-d int32
    tensor).  Reference getUniquelabels (classlabels.cuh:40)."""
    return _unique(labels, max_labels)


@takes_handle
def make_monotonic(labels: torch.Tensor, zero_based: bool = False,
                   filter_op: Optional[Callable] = None,
                   max_labels: Optional[int] = None) -> torch.Tensor:
    """Each label replaced by its rank in the sorted unique set (+1 unless
    ``zero_based``); entries where ``filter_op(label)`` is True keep
    their value (the reference's noise-label passthrough,
    classlabels.cuh:159)."""
    uniq, _ = _unique(labels, max_labels)
    ranks = torch.searchsorted(uniq, labels).to(labels.dtype)
    out = ranks if zero_based else ranks + 1
    if filter_op is not None:
        out = torch.where(filter_op(labels), labels, out)
    return out


@takes_handle
def get_ovr_labels(labels: torch.Tensor, unique_labels: torch.Tensor, idx: int) -> torch.Tensor:
    """One-vs-rest labels for class ``idx``: +1 where the label is
    ``unique_labels[idx]``, else -1 (reference getOvrlabels,
    classlabels.cuh:99)."""
    return torch.where(labels == unique_labels[idx], 1, -1).to(labels.dtype)
