"""GEMM / GEMV.

Port of ``raft_tpu/linalg/gemm.py`` (reference
cpp/include/raft/linalg/gemm.cuh:46,73,111 and gemv.h:29-164, cuBLAS
with alpha/beta and transpose flags).  On the card a product is one
cuBLAS call; alpha and beta are applied after it.

``precision`` follows the JAX package:

- ``"highest"`` (the default): an IEEE float32 product, through
  :func:`raft_tpu_torch.core.precision.matmul`, which pins torch's
  matmul flags for that call;
- ``"default"``: the card's TF32 mode, pinned for that call only
  (:func:`raft_tpu_torch.core.precision.matmul_tf32`).  This is the
  analogue of XLA's single-pass default for float32 on the TPU: faster,
  and about three decimal digits.  On the CPU it runs in float32.

bfloat16 operands with ``preferred_element_type=torch.float32`` give a
float32 result: the operands are widened to float32, whose products of
bfloat16 values are exact, and the sums are float32 (at ``"default"``
the TF32 tensor cores take the widened operands exactly too, since
bfloat16 has fewer mantissa bits than TF32).  Without it a bfloat16
product is bfloat16, as in JAX.
"""

from __future__ import annotations

from typing import Optional

import torch

from raft_tpu_torch.core import precision as _precision
from raft_tpu_torch.core.error import expects
from raft_tpu_torch.core.handle import takes_handle

PRECISIONS = ("highest", "default")


def _product(a: torch.Tensor, b: torch.Tensor, precision: str,
             preferred_element_type=None) -> torch.Tensor:
    expects(precision in PRECISIONS, "gemm: precision must be one of %s, got %r",
            PRECISIONS, precision)
    if preferred_element_type is not None:
        a, b = a.to(preferred_element_type), b.to(preferred_element_type)
    if precision == "default":
        return _precision.matmul_tf32(a, b)
    return _precision.matmul(a, b)


@takes_handle
def gemm(a: torch.Tensor, b: torch.Tensor, trans_a: bool = False, trans_b: bool = False,
         alpha: float = 1.0, beta: float = 0.0, c: Optional[torch.Tensor] = None,
         preferred_element_type=None, precision: str = "highest") -> torch.Tensor:
    """``alpha * op(a) @ op(b) + beta * c`` (reference gemm.cuh:73);
    ``precision`` and ``preferred_element_type`` as in the module doc."""
    opa = a.T if trans_a else a
    opb = b.T if trans_b else b
    inner = opb.shape[-2 if opb.ndim > 1 else 0]
    expects(opa.shape[-1] == inner, "gemm: inner dimensions mismatch (%d vs %d)",
            opa.shape[-1], inner)
    out = _product(opa, opb, precision, preferred_element_type)
    if alpha != 1.0:
        out = alpha * out
    if beta != 0.0:
        expects(c is not None, "gemm: beta != 0 requires c")
        out = out + beta * c
    return out


@takes_handle
def gemv(a: torch.Tensor, x: torch.Tensor, trans_a: bool = False, alpha: float = 1.0,
         beta: float = 0.0, y: Optional[torch.Tensor] = None,
         precision: str = "highest") -> torch.Tensor:
    """``alpha * op(a) @ x + beta * y`` (reference gemv.h:29-164);
    ``precision`` as for :func:`gemm`."""
    opa = a.T if trans_a else a
    expects(opa.shape[-1] == x.shape[0], "gemv: dimension mismatch (%d vs %d)",
            opa.shape[-1], x.shape[0])
    out = _product(opa, x, precision)
    if alpha != 1.0:
        out = alpha * out
    if beta != 0.0:
        expects(y is not None, "gemv: beta != 0 requires y")
        out = out + beta * y
    return out
