"""Seeded Gaussian mixtures with uneven blob sizes, made on the device.

The mixture itself is fixed by its parameters: blob ``b`` of ``n_blobs``
has weight ``(b + 1) ** -size_skew``, the counts of ``n`` rows are the
weights' shares rounded by largest remainders, and the centres are
``center_scale * N(0, I)`` drawn from ``centers_seed``.  The run's seed
draws which rows belong to which blob and the noise, so every seed
samples the same distribution with the same blob sizes.  Rows are
``centre + spread * N(0, I)``.
Queries are fresh draws from the same mixture, with the same rule for
how many fall in each blob.
"""

from __future__ import annotations

import numpy as np
import torch


def blob_counts(total: int, n_blobs: int, size_skew: float) -> np.ndarray:
    """Rows of each blob: ``total`` split by the weights, largest
    remainders first, ties to the larger blob."""
    w = np.arange(1, n_blobs + 1, dtype=np.float64) ** -float(size_skew)
    share = w / w.sum() * total
    counts = np.floor(share).astype(np.int64)
    rest = total - int(counts.sum())
    order = np.lexsort((np.arange(n_blobs), -(share - counts)))
    counts[order[:rest]] += 1
    return counts


def _draw(counts: np.ndarray, centers: torch.Tensor, spread: float,
          gen: torch.Generator) -> torch.Tensor:
    dev = centers.device
    labels = torch.repeat_interleave(torch.arange(len(counts), device=dev),
                                     torch.as_tensor(counts, device=dev))
    labels = labels[torch.randperm(len(labels), generator=gen, device=dev)]
    rows = torch.randn((len(labels), centers.shape[1]), generator=gen, device=dev)
    return rows.mul_(spread).add_(centers[labels])


def make_index(n: int, d: int, params: dict, seed: int, device) -> tuple:
    """``(rows (n, d) float32, centres (n_blobs, d))`` on ``device``."""
    fixed = torch.Generator(device=device).manual_seed(int(params["centers_seed"]))
    centers = torch.randn((params["n_blobs"], d), generator=fixed, device=device)
    centers.mul_(params["center_scale"])
    gen = torch.Generator(device=device).manual_seed(int(seed))
    counts = blob_counts(n, params["n_blobs"], params["size_skew"])
    return _draw(counts, centers, params["spread"], gen), centers


def make_queries(m: int, centers: torch.Tensor, params: dict, seed: int) -> torch.Tensor:
    """``m`` fresh rows of the mixture with these centres."""
    gen = torch.Generator(device=centers.device).manual_seed(int(seed))
    counts = blob_counts(m, params["n_blobs"], params["size_skew"])
    return _draw(counts, centers, params["spread"], gen)
