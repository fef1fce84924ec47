"""Elementwise operations.

Port of ``raft_tpu/linalg/elementwise.py`` (reference
cpp/include/raft/linalg/ ``unaryOp``/``writeOnlyUnaryOp``
unary_op.cuh:73,96, ``binaryOp`` binary_op.cuh:84, ``eltwiseAdd/Sub/Mul/
Div`` eltwise.cuh:37-114, the scalar variants add.cuh, subtract.cuh,
multiply.cuh, divide.cuh, and ``map`` map.cuh:65).  Each is one torch
expression; the names keep the consumers' vocabulary.  Operations passed
in are torch functions or Python arithmetic on tensors.
"""

from __future__ import annotations

import math
from typing import Callable

import torch

from raft_tpu_torch.core.handle import takes_handle


@takes_handle
def unary_op(x: torch.Tensor, op: Callable) -> torch.Tensor:
    """Apply ``op`` elementwise (reference unary_op.cuh:73)."""
    return op(x)


@takes_handle
def write_only_unary_op(shape, dtype, op: Callable, *, device=None) -> torch.Tensor:
    """A tensor made from flat indices (reference unary_op.cuh:96: the
    operation receives the output offset)."""
    idx = torch.arange(math.prod(shape), device=device)
    return op(idx).to(dtype).reshape(shape)


@takes_handle
def binary_op(x: torch.Tensor, y: torch.Tensor, op: Callable) -> torch.Tensor:
    """Apply a binary operation elementwise (reference binary_op.cuh:84)."""
    return op(x, y)


@takes_handle
def map_op(op: Callable, *arrays: torch.Tensor) -> torch.Tensor:
    """Map an n-ary operation over same-shaped tensors (reference map.cuh:65)."""
    return op(*arrays)


@takes_handle
def eltwise_add(x, y):
    """(reference eltwise.cuh:37)"""
    return x + y


@takes_handle
def eltwise_sub(x, y):
    """(reference eltwise.cuh:63)"""
    return x - y


@takes_handle
def eltwise_multiply(x, y):
    """(reference eltwise.cuh:76)"""
    return x * y


@takes_handle
def eltwise_divide(x, y):
    """(reference eltwise.cuh:89)"""
    return x / y


@takes_handle
def eltwise_divide_check_zero(x, y):
    """Divide, with 0 where the divisor is 0 (reference eltwise.cuh:102)."""
    return torch.where(y == 0, torch.zeros_like(x), x / torch.where(y == 0, 1, y))


@takes_handle
def add(x, y):
    """(reference add.cuh:58 ``add``)"""
    return x + y


@takes_handle
def subtract(x, y):
    """(reference subtract.cuh:58)"""
    return x - y


@takes_handle
def add_scalar(x, scalar):
    """(reference add.cuh:40 ``addScalar``)"""
    return x + scalar


@takes_handle
def subtract_scalar(x, scalar):
    """(reference subtract.cuh:41 ``subtractScalar``)"""
    return x - scalar


@takes_handle
def multiply_scalar(x, scalar):
    """(reference multiply.cuh:38 ``multiplyScalar``)"""
    return x * scalar


@takes_handle
def divide_scalar(x, scalar):
    """(reference divide.cuh:38 ``divideScalar``)"""
    return x / scalar
