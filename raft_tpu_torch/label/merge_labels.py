"""Merge two labellings connected through masked points.

Port of ``raft_tpu/label/merge_labels.py`` (reference
label/merge_labels.cuh:115): the label-equivalence graph has an edge
(labels_a[k], labels_b[k]) for each masked k; its connected components,
found by repeated min-propagation, give each point its component's
smallest label.  Labels are 1-based (the weak-CC convention).

A Python loop of sweeps, each a ``scatter_reduce(..., "amin")`` over the
edges in both directions and a pointer jump, with one host read a sweep
for the fixpoint.  Minima are exact in any order, so the atomics of the
scatter on the card change nothing.
"""

from __future__ import annotations

import torch

from raft_tpu_torch.core.handle import takes_handle

_INT32_MAX = 2**31 - 1


@takes_handle
def merge_labels(labels_a: torch.Tensor, labels_b: torch.Tensor, mask: torch.Tensor
                 ) -> torch.Tensor:
    """Merged int32 labels (1-based): the components of the equivalence
    graph take their smallest member label.  All inputs (N,)."""
    n = labels_a.shape[0]
    la, lb = labels_a.to(torch.int32), labels_b.to(torch.int32)
    mask = mask.to(torch.bool)
    a_idx = torch.where(mask, la - 1, 0).long()
    b_idx = torch.where(mask, lb - 1, 0).long()
    big = torch.full((n,), _INT32_MAX, dtype=torch.int32, device=la.device)

    def relax(r):
        m = torch.where(mask, torch.minimum(r[a_idx], r[b_idx]), _INT32_MAX)
        upd = torch.minimum(big.scatter_reduce(0, a_idx, m, "amin"),
                            big.scatter_reduce(0, b_idx, m, "amin"))
        r = torch.minimum(r, upd)
        return torch.minimum(r, r[r.long() - 1])    # pointer jump

    prev = torch.arange(1, n + 1, dtype=torch.int32, device=la.device)
    r = relax(prev)
    while not torch.equal(r, prev):
        prev, r = r, relax(r)
    return r[la.long() - 1]
