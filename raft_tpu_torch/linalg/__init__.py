"""Dense linear algebra primitives.

Port of ``raft_tpu/linalg`` (the reference's ``raft::linalg``,
cpp/include/raft/linalg/).  The JAX package lowers these to XLA ops
outside any Pallas kernel, so torch's own operations and library calls
(cuBLAS and cuSOLVER on the card) are the port here; its float32
products go through :mod:`raft_tpu_torch.core.precision`.  The one
iterative solver, Lanczos, is built from those primitives
(:mod:`raft_tpu_torch.linalg.lanczos`).  Every function takes
``handle=`` or ``device=`` (default ``"cuda"``;
:func:`raft_tpu_torch.core.handle.takes_handle`).
"""

from raft_tpu_torch.linalg.cholesky import cholesky_rank1_update
from raft_tpu_torch.linalg.eig import eig_dc, eig_jacobi, eig_sel_dc
from raft_tpu_torch.linalg.elementwise import (add, add_scalar, binary_op, divide_scalar,
                                               eltwise_add, eltwise_divide, eltwise_multiply,
                                               eltwise_sub, map_op, multiply_scalar, subtract,
                                               subtract_scalar, unary_op)
from raft_tpu_torch.linalg.gemm import gemm, gemv
from raft_tpu_torch.linalg.init import range_init
from raft_tpu_torch.linalg.lanczos import (compute_largest_eigenvectors,
                                           compute_smallest_eigenvectors)
from raft_tpu_torch.linalg.matrix_vector_op import matrix_vector_op
from raft_tpu_torch.linalg.norm import (L1Norm, L2Norm, LinfNorm, NormType, col_norm,
                                        mean_squared_error, row_norm)
from raft_tpu_torch.linalg.qr import qr_get_q, qr_get_qr
from raft_tpu_torch.linalg.reduce import (coalesced_reduction, map_then_reduce,
                                          map_then_sum_reduce, reduce, strided_reduction)
from raft_tpu_torch.linalg.svd import svd_eig, svd_jacobi, svd_qr, svd_reconstruction
from raft_tpu_torch.linalg.transpose import transpose

__all__ = [
    "gemm", "gemv",
    "eig_dc", "eig_sel_dc", "eig_jacobi",
    "svd_qr", "svd_eig", "svd_jacobi", "svd_reconstruction",
    "qr_get_q", "qr_get_qr",
    "cholesky_rank1_update",
    "unary_op", "binary_op", "map_op",
    "eltwise_add", "eltwise_sub", "eltwise_multiply", "eltwise_divide",
    "add", "subtract", "add_scalar", "subtract_scalar", "multiply_scalar", "divide_scalar",
    "reduce", "coalesced_reduction", "strided_reduction", "map_then_reduce",
    "map_then_sum_reduce",
    "NormType", "L1Norm", "L2Norm", "LinfNorm", "row_norm", "col_norm", "mean_squared_error",
    "matrix_vector_op",
    "transpose",
    "range_init",
    "compute_smallest_eigenvectors", "compute_largest_eigenvectors",
]
