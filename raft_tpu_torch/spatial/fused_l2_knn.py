"""Fused L2 distance + k-nearest-neighbour selection.

Port of ``raft_tpu/spatial/fused_l2_knn.py`` (reference ``fusedL2Knn``,
fused_l2_knn.cuh:196).  Two implementations with one contract:

- ``impl="kernel"``: K1 (:func:`raft_tpu_torch.ops.knn_tile.fused_knn_tile`),
  the distance tile and the running top-k in one kernel.  Legal for
  float32, float16 and bfloat16 inputs (the narrower two through a
  float32 copy), ``precision="highest"`` (3xTF32) or ``"default"`` (its
  bfloat16 instance) and k <= 128; an explicit request outside those
  limits raises, as the JAX registry's legality rule does.
- ``impl="scan"``: the tile scan (:mod:`raft_tpu_torch.spatial.tiled_knn`)
  with an expanded-form matmul distance tile.

``impl=None`` resolves the ``fused_knn_impl`` knob
(:func:`raft_tpu_torch.core.tuning.resolve`: override, configure,
``RAFT_TPU_FUSED_KNN_IMPL``, the tuning table on the (n, k) shape class),
at each call; unset, it takes the kernel on CUDA wherever it is legal,
and the scan otherwise, which includes every CPU call.  Distances are *squared*
L2; the sqrt for L2Sqrt metrics is the caller's post-processing.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from raft_tpu_torch.core import tuning
from raft_tpu_torch.core.precision import PRECISIONS
from raft_tpu_torch.core.device import as_tensor, resolve_device
from raft_tpu_torch.core.error import expects
from raft_tpu_torch.distance.pairwise import expanded_sq_dists
from raft_tpu_torch.ops.knn_tile import MAX_K, fused_knn_tile
from raft_tpu_torch.spatial.tiled_knn import tiled_knn

IMPLS = tuning.candidates("fused_knn_impl")
# input types K1 takes (float16 and bfloat16 through a float32 copy)
KERNEL_DTYPES = (torch.float32, torch.float16, torch.bfloat16)


def fused_l2_knn(
    index,
    queries,
    k: int,
    tile_n: int = 8192,
    precision: str = "highest",
    impl: Optional[str] = None,
    device="cuda",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """k nearest index rows per query under squared L2.

    Parameters
    ----------
    index, queries:
        (n_index, d) and (n_queries, d) rows (numpy arrays or tensors),
        moved to ``device``.
    k:
        Neighbours per query (k <= n_index).
    tile_n:
        Index rows per step of the tile scan.
    precision:
        ``"highest"`` (float32 products) or ``"default"`` (bfloat16
        operands, float32 sums: the TPU's single pass).
    impl:
        ``"kernel"``, ``"scan"`` or None (module doc).

    Returns
    -------
    (distances, indices): (n_queries, k) squared L2 ascending, int32 ids.
    """
    dev = resolve_device(device)
    index = as_tensor(index, dev)
    queries = as_tensor(queries, dev)
    expects(index.ndim == 2 and queries.ndim == 2
            and index.shape[1] == queries.shape[1],
            "fused_l2_knn: shape mismatch")
    impl = tuning.resolve("fused_knn_impl", impl, site="fused_l2_knn", dtype=index.dtype,
                          n=index.shape[0], k=k, precision=precision, device=dev.type)
    if impl is None:
        legal = (index.dtype in KERNEL_DTYPES and queries.dtype in KERNEL_DTYPES
                 and precision in PRECISIONS and k <= MAX_K)
        impl = "kernel" if legal and dev.type == "cuda" else "scan"
    if impl == "kernel":
        expects(queries.dtype in KERNEL_DTYPES,
                "fused_l2_knn: impl='kernel' needs float32, float16 or bfloat16 queries "
                "(got %s)", queries.dtype)
        return fused_knn_tile(index, queries, k, precision)
    index = index.to(torch.float32)
    queries = queries.to(torch.float32)
    return tiled_knn(index, queries, k,
                     lambda q, x: expanded_sq_dists(q, x, precision), tile_n=tile_n)
