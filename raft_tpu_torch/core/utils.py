"""Integer helpers (reference cuda_utils.cuh, integer_utils.h, pow2_utils.cuh)
and the stage timer of the multi-stage builds."""

from __future__ import annotations

import time
from typing import Optional

import torch

from raft_tpu_torch.core.error import expects


def ceildiv(a: int, b: int) -> int:
    """Ceiling division (reference cuda_utils.cuh:109 ``raft::ceildiv``)."""
    return -(-a // b)


def round_up_safe(a: int, b: int) -> int:
    """Round ``a`` up to a multiple of ``b`` (integer_utils.h)."""
    return ceildiv(a, b) * b


def round_down_safe(a: int, b: int) -> int:
    """Round ``a`` down to a multiple of ``b`` (integer_utils.h)."""
    return (a // b) * b


def align(v: int, alignment: int) -> int:
    """Round ``v`` up to a multiple of ``alignment`` (``alignTo``)."""
    return round_up_safe(v, alignment)


def align_to(v: int, align: int) -> int:
    """Align ``v`` up to ``align`` (reference cuda_utils.cuh ``alignTo``)."""
    return round_up_safe(v, align)


def align_down(v: int, align: int) -> int:
    """Align ``v`` down to ``align`` (reference cuda_utils.cuh ``alignDown``)."""
    return round_down_safe(v, align)


def is_pow2(v: int) -> bool:
    """True iff ``v`` is a power of two (reference cuda_utils.cuh ``isPo2``)."""
    return v > 0 and (v & (v - 1)) == 0


def log2(v: int) -> int:
    """Floor log base 2 (reference cuda_utils.cuh ``log2``)."""
    expects(v > 0, "log2: v must be positive, got %d", v)
    return v.bit_length() - 1


class Pow2:
    """Arithmetic modulo a power of two (reference pow2_utils.cuh)."""

    def __init__(self, value: int):
        expects(is_pow2(value), "Pow2: value must be a power of two, got %d", value)
        self.value = value
        self.mask = value - 1
        self.log2 = log2(value)

    def div(self, x: int) -> int:
        return x >> self.log2

    def mod(self, x: int) -> int:
        return x & self.mask

    def round_down(self, x: int) -> int:
        return x & ~self.mask

    def round_up(self, x: int) -> int:
        return (x + self.mask) & ~self.mask

    def is_aligned(self, x: int) -> bool:
        return (x & self.mask) == 0


class StageTimer:
    """Host-clock milliseconds of the pipeline's stages, each synchronised
    with the device at its end, and the loop counts, into ``out`` (a dict
    given by the caller; nothing is timed without one)."""

    def __init__(self, out: Optional[dict], device: torch.device):
        self.out, self.device = out, device
        self.t0 = time.perf_counter()

    def done(self, name: str, **counts) -> None:
        if self.out is None:
            return
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        now = time.perf_counter()
        self.out[name + "_ms"] = self.out.get(name + "_ms", 0.0) + (now - self.t0) * 1e3
        for key, value in counts.items():
            self.out.setdefault(key, []).append(value)
        self.t0 = now
