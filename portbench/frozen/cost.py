"""Operations and device-memory bytes a kernel call needs, from its shapes.

A frozen copy of the counts in ``raft_tpu_torch/ops/cost.py`` (K1, K2
and K3), kept with the benchmark so that a change to the program cannot
move its own yardstick.  Each function returns ``(ops, bytes)``: ``ops``
are floating-point operations (two a multiply-add) of the function the
kernel computes, and bytes count every input read once and every output
written once, whatever a kernel reads again.
"""

from __future__ import annotations

from typing import Tuple

# tensor-core passes a multiply-add of K1 and K3 takes at a precision:
# three TF32 products of split halves at "highest" (3xTF32)
TENSOR_PASSES = {"highest": 3, "default": 1}


def knn_cost(nq: int, n: int, d: int, k: int) -> Tuple[float, float]:
    """K1: the product of (nq, d) queries with the (n, d) index; the index
    and queries read, (nq, k) float32 distances and int32 ids written."""
    return 2.0 * nq * n * d, 4.0 * (n + nq) * d + 8.0 * nq * k


def select_cost(m: int, w: int, k: int) -> Tuple[float, float]:
    """K2: one comparison a key of (m, w); the keys read, (m, k) float32
    and int32 written."""
    return 1.0 * m * w, 4.0 * m * w + 8.0 * m * k


def ivf_scan_cost(nq: int, d: int, k: int, n_entries: int, rows_scanned: int,
                  rows_distinct: int) -> Tuple[float, float]:
    """K3: the product of each query with every row of the lists it probes
    (``rows_scanned`` rows in all); the distinct probed rows read once (a
    vector, a norm and an id each), the queries and the ``n_entries``
    scan-list entries read, (nq, k) float32 and int32 written."""
    return (2.0 * d * rows_scanned,
            rows_distinct * (4.0 * d + 8.0) + 4.0 * nq * d + 4.0 * n_entries + 8.0 * nq * k)
