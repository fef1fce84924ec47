"""k-means clustering with k-means++ initialisation.

Port of ``raft_tpu/spectral/kmeans.py`` (reference spectral/kmeans.hpp:
``chooseNewCentroid`` :349, ``initializeCentroids`` :446,
``assignCentroids`` :557, ``updateCentroids`` :628, ``kmeans`` :775).

- Assignment: below k = 256, the (n, k) expanded-L2 matrix
  (``|x|^2 + |c|^2 - 2 x.c``, full float32) and its argmin; at k >= 256,
  ``fused_l2_nn(..., tile_n=512)``, which on the card is K4, so the
  (n, k) matrix never exists (4 GB at n = 1M, k = 1024).
- Update: one ``index_add_`` per sums and counts; an empty cluster keeps
  its previous centroid.
- Lloyd iterates while ``|prev - res| > tol * max(res, 1e-30)`` and fewer
  than ``max_iter`` iterations ran, the JAX ``while_loop`` condition, in
  the data's dtype.
- Restarts: ``n_init`` solves, keeping the lowest residual (a finite
  residual beats a non-finite one).

Randomness: ``jax.random`` streams cannot be reproduced, so the draws
differ from the JAX package's for the same seed.  Restart t draws from its
own CPU ``torch.Generator``, seeded with
``numpy.random.SeedSequence([seed mod 2**64, t]).generate_state(1, uint64)[0]``,
so each restart's stream depends on (seed, t) alone and is the same on
the CPU and the card.  k-means++ takes its k uniform numbers from that
generator at once and samples by inverse CDF on the data's device
(``searchsorted`` over the cumulative min-distances, in float64), which
needs no device-to-host copy per centroid; where every min-distance is 0
the draw is uniform over the rows, as in JAX.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from raft_tpu_torch.core.device import as_tensor, resolve_device
from raft_tpu_torch.core.error import expects
from raft_tpu_torch.distance.fused_l2_nn import fused_l2_nn

# from this many clusters on, assignment goes through fused_l2_nn
FUSED_ASSIGN_MIN_K = 256


class KmeansResult(NamedTuple):
    centroids: torch.Tensor  # (k, d)
    labels: torch.Tensor     # (n,) int32
    residual: torch.Tensor   # sum of squared distances to the assigned centroid
    iters: int               # Lloyd iterations executed


def restart_generator(seed: int, t: int) -> torch.Generator:
    """The CPU generator of restart ``t`` (module doc)."""
    state = np.random.SeedSequence([seed % 2**64, t]).generate_state(1, np.uint64)[0]
    return torch.Generator().manual_seed(int(state))


def init_plus_plus(X: torch.Tensor, k: int, generator: torch.Generator) -> torch.Tensor:
    """k-means++ seeding (reference initializeCentroids, kmeans.hpp:446;
    chooseNewCentroid :349 samples in proportion to the min-distance^2).
    ``generator`` is a CPU generator (module doc)."""
    n, d = X.shape
    u = torch.rand(k, generator=generator, dtype=torch.float64).to(X.device)
    # uniform row for each draw: the first centroid, and the fallback
    # where every min-distance is 0
    uniform = torch.clamp((u * n).long(), max=n - 1)
    C = X.new_zeros((k, d))
    C[0] = X[uniform[0]]
    dists = ((X - C[0]) ** 2).sum(dim=1)
    for i in range(1, k):
        cdf = torch.cumsum(dists.to(torch.float64), dim=0)
        total = cdf[-1]
        weighted = torch.clamp(torch.searchsorted(cdf, (u[i] * total).reshape(1), right=True),
                               max=n - 1)[0]
        idx = torch.where(total > 0, weighted, uniform[i])
        row = X.index_select(0, idx.reshape(1))
        C[i] = row[0]
        dists = torch.minimum(dists, ((X - row) ** 2).sum(dim=1))
    return C


def _assign(X: torch.Tensor, C: torch.Tensor, xn: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(labels (n,) int32, residual) of the nearest centroids."""
    if C.shape[0] >= FUSED_ASSIGN_MIN_K:
        vals, labels = fused_l2_nn(X, C, tile_n=512, device=X.device)
        return labels, vals.sum()
    cn = (C * C).sum(dim=1)
    dm = torch.clamp(xn[:, None] + cn[None, :] - 2.0 * (X @ C.T), min=0.0)
    res, labels = torch.min(dm, dim=1)
    return labels.to(torch.int32), res.sum()


def _update(X: torch.Tensor, C: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    k = C.shape[0]
    idx = labels.long()
    sums = torch.zeros_like(C).index_add_(0, idx, X)
    counts = torch.zeros(k, dtype=X.dtype, device=X.device).index_add_(
        0, idx, torch.ones_like(X[:, 0]))
    return torch.where(counts[:, None] > 0, sums / torch.clamp(counts, min=1.0)[:, None], C)


def _lloyd(X: torch.Tensor, C0: torch.Tensor, tol: float,
           max_iter: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, int]:
    """Lloyd iterations from the centroids ``C0``: (centroids, labels,
    residual, iterations)."""
    xn = (X * X).sum(dim=1)
    C = C0
    labels, res = _assign(X, C, xn)
    prev = torch.full_like(res, float("inf"))
    it = 0
    while it < max_iter and bool(torch.abs(prev - res) > tol * torch.clamp(res, min=1e-30)):
        C = _update(X, C, labels)
        labels, new_res = _assign(X, C, xn)
        prev, res = res, new_res
        it += 1
    return C, labels, res, it


def kmeans(X, k: int, tol: float = 1e-4, max_iter: int = 300,
           seed: int = 1234567, n_init: int = 1, device="cuda") -> KmeansResult:
    """Lloyd k-means with k-means++ init (reference kmeans, kmeans.hpp:775).

    Returns (centroids (k, d), labels (n,) int32, residual, iters);
    ``residual`` is the total within-cluster squared distance.  ``n_init``
    > 1 repeats the whole solve from fresh k-means++ draws and keeps the
    lowest residual.  ``X`` (a numpy array or tensor) is moved to
    ``device``; integer data becomes float32.
    """
    dev = resolve_device(device)
    X = as_tensor(X, dev)
    if not X.is_floating_point():
        X = X.to(torch.float32)
    expects(X.ndim == 2, "kmeans: 2-D observations required")
    expects(1 <= k <= X.shape[0], "kmeans: k=%d out of range for %d points", k, X.shape[0])
    expects(n_init >= 1, "kmeans: n_init must be >= 1, got %d", n_init)
    best = None
    for t in range(n_init):
        with record_function("kmeans.init_plus_plus"):
            C0 = init_plus_plus(X, k, restart_generator(seed, t))
        with record_function("kmeans.lloyd"):
            run = KmeansResult(*_lloyd(X, C0, tol, max_iter))
        r = float(run.residual)
        br = math.inf if best is None else float(best.residual)
        if r < br or not math.isfinite(br):
            best = run
    return best
