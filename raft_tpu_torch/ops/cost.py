"""Analytic work of each kernel: the operations and the device-memory
bytes a call needs, from its shapes.

One copy of the counts that two readers share: the kernel wrappers hand
them to the cost inventory (:func:`raft_tpu_torch.core.inventory.note_launch`)
at their launch seam, and ``chip_smoke.py`` divides them by the card's
peak rates for each kernel's bound.  Each function returns ``(ops,
bytes)`` as floats.  Bytes count every input read once and every output
written once, whatever a kernel reads again; where the work depends on
the data (K3's scan lists), the caller passes what the data needs.
"""

from __future__ import annotations

from typing import Tuple

__all__ = ["K5_INSTR_PER_STEP", "TENSOR_PASSES", "knn_cost", "select_cost", "ivf_scan_cost",
           "nn_cost", "pairwise_cost", "pq_scan_cost"]

# FP32 instructions a step (one element pair) of K5's L1, L2Unexpanded and
# Linf: a subtract and an absolute-add (or square-add, or max)
K5_INSTR_PER_STEP = 2

# TF32 tensor-core operations for each multiply-add of the distance tile of
# K1, K3, K4 and K6, by precision: three products of TF32 halves at
# "highest" (3xTF32), one product of bfloat16-rounded operands at
# "default".  The counts below are the function's own multiply-adds; a
# bound on the tensor cores multiplies them by this.
TENSOR_PASSES = {"highest": 3, "default": 1}


def knn_cost(nq: int, n: int, d: int, k: int) -> Tuple[float, float]:
    """K1 (and K6, whose phase 1 writes ``k`` = tiles x 128 candidates a
    query): the expanded product's multiply-adds over (nq, d) x (n, d);
    the index and queries read, (nq, k) float32 and int32 written."""
    return 2.0 * nq * n * d, 4.0 * (n + nq) * d + 8.0 * nq * k


def select_cost(m: int, w: int, k: int) -> Tuple[float, float]:
    """K2: one comparison a key of (m, w); the keys read, (m, k) float32
    and int32 written."""
    return 1.0 * m * w, 4.0 * m * w + 8.0 * m * k


def ivf_scan_cost(nq: int, d: int, k: int, n_entries: int, rows_scanned: int,
                  rows_distinct: int) -> Tuple[float, float]:
    """K3: the multiply-adds of every stored row of each listed slot, once
    per query that lists it (``rows_scanned``); the distinct slots' rows
    read once (``rows_distinct``, a vector, a norm and an id each), the
    queries and the ``n_entries`` scan-list entries read, (nq, k) float32
    and int32 written."""
    return (2.0 * d * rows_scanned,
            rows_distinct * (4.0 * d + 8.0) + 4.0 * nq * d + 4.0 * n_entries + 8.0 * nq * k)


def nn_cost(m: int, n: int, d: int) -> Tuple[float, float]:
    """K4: the multiply-adds of (m, d) x (n, d); both read, (m,) float32
    and int32 written."""
    return 2.0 * m * n * d, 4.0 * (m + n) * d + 8.0 * m


def pairwise_cost(m: int, n: int, d: int) -> Tuple[float, float]:
    """K5: :data:`K5_INSTR_PER_STEP` FP32 instructions an element pair of
    (m, d) x (n, d); both read, (m, n) float32 written."""
    return 1.0 * m * n * d * K5_INSTR_PER_STEP, 4.0 * ((m + n) * d + m * n)


def pq_scan_cost(nq: int, d: int, ksub: int, M: int, nprobe: int, kk: int, rows_scanned: int,
                 rows_distinct: int) -> Tuple[float, float]:
    """K7: 2 x d FP32 operations for each (query, probe, codeword) table
    entry and an add a code of the ``rows_scanned`` rows; the distinct
    probed rows' uint8 codes and int32 ids read once (``rows_distinct``),
    the queries read, (nq, kk) float32 and int32 written."""
    return (2.0 * d * nq * nprobe * ksub + float(M) * rows_scanned,
            rows_distinct * (M + 4.0) + 4.0 * nq * d + 8.0 * nq * kk)
