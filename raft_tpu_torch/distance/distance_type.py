"""Distance metric identifiers (the same values as the JAX package).

Reference: cpp/include/raft/linalg/distance_type.h:23-66 — 20 metric ids
(0-19) plus the ``Precomputed`` special value (=100).
"""

from __future__ import annotations

import enum


class DistanceType(enum.IntEnum):
    """(reference linalg/distance_type.h:23)"""

    L2Expanded = 0            # xn + yn - 2 x.yT
    L2SqrtExpanded = 1        # sqrt of the above
    CosineExpanded = 2
    L1 = 3
    L2Unexpanded = 4          # sum (x-y)^2 accumulated directly
    L2SqrtUnexpanded = 5
    InnerProduct = 6
    Linf = 7                  # Chebyshev
    Canberra = 8
    LpUnexpanded = 9          # generalized Minkowski
    CorrelationExpanded = 10
    JaccardExpanded = 11      # sparse-only in the reference
    HellingerExpanded = 12
    Haversine = 13
    BrayCurtis = 14
    JensenShannon = 15
    HammingUnexpanded = 16
    KLDivergence = 17
    RusselRaoExpanded = 18
    DiceExpanded = 19         # sparse-only in the reference
    Precomputed = 100
