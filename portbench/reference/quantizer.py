"""The reference's own coarse quantizer, in plain PyTorch float64: Lloyd's
k-means from a k-means++ start, the start and the training sample drawn
from a seed of the benchmark's, and the k-means objective of any
centroids and lists.

k-means has no one answer, so the program's quantizer is judged by what
does not need equal centroids: its objective against this one's, and its
recall against this one's (``ivf_flat.py``).
"""

from __future__ import annotations

import torch

from portbench.reference.common import Rows, rows_per_block


def _sq_to(x: torch.Tensor, xsq: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Squared distances of every row to one centroid ``c`` (d,), expanded
    form in float64, clamped at 0."""
    return (xsq - 2.0 * (x @ c) + (c * c).sum()).clamp_(min=0.0)


def nearest(x: torch.Tensor, xsq: torch.Tensor, cent: torch.Tensor) -> torch.Tensor:
    """Each row's nearest centroid (int64), by float64 distance."""
    csq = (cent * cent).sum(dim=1)
    out = torch.empty(x.shape[0], dtype=torch.int64, device=x.device)
    step = rows_per_block(cent.shape[0])
    for s in range(0, x.shape[0], step):
        dist = xsq[s:s + step, None] + csq[None, :] - 2.0 * (x[s:s + step] @ cent.T)
        out[s:s + step] = dist.argmin(dim=1)
        del dist
    return out


def kmeans_pp(x: torch.Tensor, xsq: torch.Tensor, k: int, gen: torch.Generator):
    """k-means++ seeding: the first centroid a uniform row, each next one a
    row drawn with probability proportional to its squared distance to
    the nearest centroid so far."""
    n = x.shape[0]
    pick = torch.empty(k, dtype=torch.int64, device=x.device)
    pick[0] = torch.randint(n, (1,), generator=gen, device=x.device)[0]
    d2 = _sq_to(x, xsq, x[pick[0]])
    for j in range(1, k):
        pick[j] = torch.multinomial(d2, 1, generator=gen)[0]
        torch.minimum(d2, _sq_to(x, xsq, x[pick[j]]), out=d2)
    return x[pick].clone()


def lloyd(x: torch.Tensor, xsq: torch.Tensor, cent: torch.Tensor, iters: int):
    """``iters`` Lloyd steps; an empty cluster keeps its centroid."""
    for _ in range(int(iters)):
        labels = nearest(x, xsq, cent)
        sums = torch.zeros_like(cent).index_add_(0, labels, x)
        counts = torch.bincount(labels, minlength=cent.shape[0]).to(x.dtype)
        cent = torch.where(counts[:, None] > 0, sums / counts.clamp(min=1.0)[:, None], cent)
    return cent


def build(rows: Rows, nlist: int, iters: int, seed: int, train_rows: int = None):
    """``(centroids (nlist, d) float64, each row's list (n,) int64)``:
    k-means on ``train_rows`` rows drawn from ``seed`` (every row when it
    is None or not below their count), then every row to its nearest
    centroid."""
    gen = torch.Generator(device=rows.x.device).manual_seed(int(seed))
    x, xsq = rows.x, rows.sq
    if train_rows is not None and int(train_rows) < rows.n:
        pick = torch.randperm(rows.n, generator=gen, device=x.device)[:int(train_rows)]
        x, xsq = x[pick], xsq[pick]
    cent = lloyd(x, xsq, kmeans_pp(x, xsq, int(nlist), gen), iters)
    return cent, nearest(rows.x, rows.sq, cent)


def objective(rows: Rows, cent: torch.Tensor, lists: torch.Tensor) -> float:
    """Mean squared distance (direct form, float64) from each row to the
    centroid of its list; rows with no list (``lists`` out of range) are
    left out."""
    kept = (lists >= 0) & (lists < cent.shape[0])
    total, count = 0.0, int(kept.sum())
    step = rows_per_block(cent.shape[1] * 16)
    for s in range(0, rows.n, step):
        keep = kept[s:s + step]
        diff = rows.x[s:s + step][keep] - cent[lists[s:s + step][keep]]
        total += float((diff * diff).sum())
    return total / max(count, 1)
