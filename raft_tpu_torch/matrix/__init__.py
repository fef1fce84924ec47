"""Matrix manipulation and math helpers (port of ``raft_tpu/matrix``;
the reference's cpp/include/raft/matrix/ matrix.hpp and math.hpp).
Every function takes ``handle=`` or ``device=`` (default ``"cuda"``)."""

from raft_tpu_torch.matrix.math import (argmax, matrix_vector_binary_add,
                                        matrix_vector_binary_div,
                                        matrix_vector_binary_div_skip_zero,
                                        matrix_vector_binary_mult,
                                        matrix_vector_binary_mult_skip_zero,
                                        matrix_vector_binary_sub, power, ratio, reciprocal,
                                        seq_root, set_small_values_zero, set_value, sign_flip)
from raft_tpu_torch.matrix.matrix import (col_reverse, copy_rows, copy_upper_triangular,
                                          get_diagonal_inverse_matrix, get_l2_norm,
                                          initialize_diagonal_matrix, print_host, row_reverse,
                                          slice_matrix, trunc_zero_origin)

__all__ = [
    "copy_rows", "trunc_zero_origin", "col_reverse", "row_reverse", "print_host",
    "slice_matrix", "copy_upper_triangular", "initialize_diagonal_matrix",
    "get_diagonal_inverse_matrix", "get_l2_norm",
    "power", "seq_root", "set_small_values_zero", "reciprocal", "set_value", "ratio",
    "argmax", "sign_flip",
    "matrix_vector_binary_mult", "matrix_vector_binary_mult_skip_zero",
    "matrix_vector_binary_div", "matrix_vector_binary_div_skip_zero",
    "matrix_vector_binary_add", "matrix_vector_binary_sub",
]
