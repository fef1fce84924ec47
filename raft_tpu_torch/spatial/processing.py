"""Metric pre/post-processors for kNN.

Port of ``raft_tpu/spatial/processing.py`` (reference processing.hpp:38-187).
Cosine L2-normalises rows and correlation mean-centres them first, so
that an inner-product search finds them; ``postprocess`` maps
similarities to distances ``1 - sim``.  ``preprocess`` returns a new
tensor, so the caller's data is not changed and the JAX ``revert`` has
no counterpart.
"""

from __future__ import annotations

import torch

from raft_tpu_torch.distance.distance_type import DistanceType


class MetricProcessor:
    """Identity processor (reference DefaultMetricProcessor)."""

    def preprocess(self, data: torch.Tensor) -> torch.Tensor:
        return data

    def postprocess(self, distances: torch.Tensor) -> torch.Tensor:
        return distances


class CosineMetricProcessor(MetricProcessor):
    """Row-normalise so that inner product = cosine similarity."""

    def preprocess(self, data: torch.Tensor) -> torch.Tensor:
        norms = torch.sqrt((data * data).sum(dim=1, keepdim=True))
        return data / torch.where(norms == 0, 1.0, norms)

    def postprocess(self, distances: torch.Tensor) -> torch.Tensor:
        return 1.0 - distances


class CorrelationMetricProcessor(CosineMetricProcessor):
    """Mean-centre, then normalise, so that inner product = Pearson r."""

    def preprocess(self, data: torch.Tensor) -> torch.Tensor:
        return super().preprocess(data - data.mean(dim=1, keepdim=True))


def create_processor(metric: DistanceType) -> MetricProcessor:
    """Factory (reference create_processor, processing.hpp:173)."""
    if metric == DistanceType.CosineExpanded:
        return CosineMetricProcessor()
    if metric == DistanceType.CorrelationExpanded:
        return CorrelationMetricProcessor()
    return MetricProcessor()
