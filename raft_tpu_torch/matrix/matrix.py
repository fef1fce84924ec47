"""Matrix manipulation (port of ``raft_tpu/matrix/matrix.py``; reference
cpp/include/raft/matrix/matrix.hpp:49-284): gathers, slices, reverses
and diagonal helpers, each a torch operation."""

from __future__ import annotations

import torch

from raft_tpu_torch.core.error import expects
from raft_tpu_torch.core.handle import takes_handle


@takes_handle
def copy_rows(inp: torch.Tensor, indices: torch.Tensor) -> torch.Tensor:
    """Gather rows by index (reference matrix.hpp:50 ``copyRows``)."""
    return torch.index_select(inp, 0, indices.long())


@takes_handle
def trunc_zero_origin(inp: torch.Tensor, n_rows: int, n_cols: int) -> torch.Tensor:
    """Top-left submatrix copy (reference matrix.hpp:87 ``truncZeroOrigin``)."""
    expects(n_rows <= inp.shape[0] and n_cols <= inp.shape[1],
            "trunc_zero_origin: target (%d, %d) exceeds source (%d, %d)",
            n_rows, n_cols, inp.shape[0], inp.shape[1])
    return inp[:n_rows, :n_cols].clone()


@takes_handle
def col_reverse(inp: torch.Tensor) -> torch.Tensor:
    """Reverse the column order (reference matrix.hpp:113 ``colReverse``)."""
    return inp.flip(1)


@takes_handle
def row_reverse(inp: torch.Tensor) -> torch.Tensor:
    """Reverse the row order (reference matrix.hpp:143 ``rowReverse``)."""
    return inp.flip(0)


@takes_handle
def print_host(inp: torch.Tensor, h_separator: str = ";", v_separator: str = ",") -> str:
    """The reference's host printer (matrix.hpp:199 ``printHost``): the
    string, rows joined by ``h_separator``, values by ``v_separator``."""
    return h_separator.join(v_separator.join(str(v) for v in row)
                            for row in inp.cpu().numpy())


@takes_handle
def slice_matrix(inp: torch.Tensor, x1: int, y1: int, x2: int, y2: int) -> torch.Tensor:
    """Submatrix [x1:x2, y1:y2] (reference matrix.hpp:223 ``sliceMatrix``)."""
    expects(0 <= x1 < x2 <= inp.shape[0] and 0 <= y1 < y2 <= inp.shape[1],
            "slice_matrix: invalid bounds (%d,%d)-(%d,%d) for shape (%d,%d)",
            x1, y1, x2, y2, inp.shape[0], inp.shape[1])
    return inp[x1:x2, y1:y2].clone()


@takes_handle
def copy_upper_triangular(src: torch.Tensor) -> torch.Tensor:
    """The upper triangle with the diagonal, in the k x k output where
    k = min(rows, cols) (reference matrix.hpp:245 ``copyUpperTriangular``)."""
    k = min(src.shape[0], src.shape[1])
    return torch.triu(src[:k, :k])


@takes_handle
def initialize_diagonal_matrix(vec: torch.Tensor) -> torch.Tensor:
    """Diagonal matrix from a vector (reference matrix.hpp:259)."""
    return torch.diag(vec)


@takes_handle
def get_diagonal_inverse_matrix(mat: torch.Tensor) -> torch.Tensor:
    """Invert the diagonal (reference matrix.hpp:272); off-diagonal
    entries are kept, and a zero on the diagonal inverts to 0, as in the
    reference's guarded kernel."""
    d = torch.diagonal(mat)
    out = mat.clone()
    out.diagonal().copy_(torch.where(d != 0, 1.0 / torch.where(d != 0, d, 1.0), 0.0))
    return out


@takes_handle
def get_l2_norm(mat: torch.Tensor) -> torch.Tensor:
    """Frobenius norm (reference matrix.hpp:284 ``getL2Norm``)."""
    return torch.sqrt((mat * mat).sum())
