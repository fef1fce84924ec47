"""Matrix math helpers (port of ``raft_tpu/matrix/math.py``; reference
cpp/include/raft/matrix/math.hpp:38-496): the power, root and
reciprocal families, ratio, argmax per column, the PCA sign flip, and
the row/column broadcast binary operations."""

from __future__ import annotations

from typing import Optional

import torch

from raft_tpu_torch.core.handle import takes_handle


@takes_handle
def power(inp: torch.Tensor, scalar: Optional[float] = None) -> torch.Tensor:
    """Elementwise square, optionally scaled: ``scalar * x * x``
    (reference math.hpp:46,95, where "power" means x * x)."""
    out = inp * inp
    if scalar is not None:
        out = scalar * out
    return out


@takes_handle
def seq_root(inp: torch.Tensor, scalar: float = 1.0,
             set_neg_zero: bool = False) -> torch.Tensor:
    """Elementwise sqrt of ``scalar * x`` (reference math.hpp:113-175
    ``seqRoot``); ``set_neg_zero`` clamps negatives to 0 first."""
    x = scalar * inp
    if set_neg_zero:
        x = torch.where(x < 0, 0.0, x)
    return torch.sqrt(x)


@takes_handle
def set_small_values_zero(inp: torch.Tensor, thres: float = 1e-15) -> torch.Tensor:
    """Zero the entries with |x| <= thres (reference math.hpp:182,209)."""
    return torch.where(inp.abs() <= thres, 0.0, inp)


@takes_handle
def reciprocal(inp: torch.Tensor, scalar: float = 1.0, setzero: bool = False,
               thres: float = 1e-15) -> torch.Tensor:
    """Elementwise ``scalar / x`` (reference math.hpp:228-294); with
    ``setzero`` the entries with |x| < thres give 0 instead of inf."""
    if setzero:
        small = inp.abs() < thres
        return torch.where(small, 0.0, scalar / torch.where(small, 1.0, inp))
    return scalar / inp


@takes_handle
def set_value(inp: torch.Tensor, scalar: float) -> torch.Tensor:
    """Fill with a scalar (reference math.hpp:301 ``setValue``)."""
    return torch.full_like(inp, scalar)


@takes_handle
def ratio(inp: torch.Tensor) -> torch.Tensor:
    """Each element over the sum of all (reference math.hpp:318)."""
    return inp / inp.sum()


@takes_handle
def argmax(inp: torch.Tensor) -> torch.Tensor:
    """Row index of the largest entry of each column (reference
    math.hpp:343); the first on ties."""
    return torch.argmax(inp, dim=0)


@takes_handle
def sign_flip(inp: torch.Tensor) -> torch.Tensor:
    """PCA sign stabilisation (reference math.hpp:357 ``signFlip``): a
    column whose entry of largest |value| is negative is negated."""
    idx = torch.argmax(inp.abs(), dim=0)
    pivot = inp[idx, torch.arange(inp.shape[1], device=inp.device)]
    return torch.where(pivot[None, :] < 0, -inp, inp)


def _bcast(vec: torch.Tensor, along_rows: bool) -> torch.Tensor:
    return vec[None, :] if along_rows else vec[:, None]


@takes_handle
def matrix_vector_binary_mult(data, vec, bcast_along_rows: bool = True):
    """(reference math.hpp:363)"""
    return data * _bcast(vec, bcast_along_rows)


@takes_handle
def matrix_vector_binary_mult_skip_zero(data, vec, bcast_along_rows: bool = True):
    """Multiply, leaving entries where vec == 0 unchanged (reference
    math.hpp:384)."""
    v = _bcast(vec, bcast_along_rows)
    return torch.where(v == 0, data, data * v)


@takes_handle
def matrix_vector_binary_div(data, vec, bcast_along_rows: bool = True):
    """(reference math.hpp:410)"""
    return data / _bcast(vec, bcast_along_rows)


@takes_handle
def matrix_vector_binary_div_skip_zero(data, vec, bcast_along_rows: bool = True,
                                       return_zero: bool = False):
    """Divide, skipping (or zeroing) where vec == 0 (reference math.hpp:431)."""
    v = _bcast(vec, bcast_along_rows)
    quotient = data / torch.where(v == 0, 1.0, v)
    return torch.where(v == 0, torch.zeros_like(data) if return_zero else data, quotient)


@takes_handle
def matrix_vector_binary_add(data, vec, bcast_along_rows: bool = True):
    """(reference math.hpp:476)"""
    return data + _bcast(vec, bcast_along_rows)


@takes_handle
def matrix_vector_binary_sub(data, vec, bcast_along_rows: bool = True):
    """(reference math.hpp:497)"""
    return data - _bcast(vec, bcast_along_rows)
