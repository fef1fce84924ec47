"""Operations and device-memory bytes of an IVF-PQ search's ADC work (its
lookup tables and its code scan), from what the inputs need.

Kept with the benchmark, as ``cost.py`` is, so that a change to the
program cannot move its own yardstick; it counts the same work whatever
implements it.  ``ops`` are floating-point operations at the FP32 rate;
bytes count every input read once and every output written once.
"""

from __future__ import annotations

from typing import Tuple


def adc_cost(nq: int, d: int, ksub: int, n_sub: int, bits: int, nprobe: int, kk: int,
             rows_scanned: int, rows_distinct: int) -> Tuple[float, float]:
    """The tables of each query's ``nprobe`` lists (2 x d operations for
    each (query, probe, codeword) entry, over the ``n_sub`` subspaces of
    ``d``) and one add per code of the ``rows_scanned`` rows; the codes
    of the distinct probed rows at ``bits`` / 8 bytes a code plus a
    4-byte id, the (nq, d) queries, and the (nq, kk) candidates (float32
    and int32) written."""
    ops = 2.0 * d * nq * nprobe * ksub + float(n_sub) * rows_scanned
    nbytes = rows_distinct * (n_sub * bits / 8.0 + 4.0) + 4.0 * nq * d + 8.0 * nq * kk
    return ops, nbytes
