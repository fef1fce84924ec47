"""Published peak rates of one NVIDIA H100 SXM (NVIDIA's data sheet, dense,
at the full 700 W power limit), and the least time a call could take."""

from __future__ import annotations

from typing import Tuple

CARD = "NVIDIA H100 SXM (data sheet, 700 W)"
TF32_FLOPS = 495e12
BF16_FLOPS = 989e12
FP32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12


def least_seconds(ops: float, nbytes: float, ops_per_s: float) -> Tuple[float, float]:
    """``(seconds by operations, seconds by bytes)``."""
    return ops / ops_per_s, nbytes / HBM_BYTES_PER_S


def roofline(least_ops_s: float, least_bytes_s: float, measured_s: float):
    """``{"value": %, "bound": "operations" | "bytes"}``: the least time
    (the larger of the two bounds) as a share of the measured time, or
    None where nothing was measured."""
    if measured_s <= 0.0:
        return None
    bound = "operations" if least_ops_s >= least_bytes_s else "bytes"
    return {"value": 100.0 * max(least_ops_s, least_bytes_s) / measured_s, "bound": bound}
