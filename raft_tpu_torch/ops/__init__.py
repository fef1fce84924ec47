"""Hand-written CUDA kernels for Hopper and their plain PyTorch versions.

Each wrapper follows the device of its tensors: a CPU tensor takes the
plain version, a CUDA tensor launches the kernel (built from ``csrc/`` at
first use by :mod:`raft_tpu_torch.ops._build`) or raises.  Every launch
goes through :func:`raft_tpu_torch.ops._build.launch`, which counts it
in the cost inventory (:mod:`raft_tpu_torch.core.inventory`).

- K1 :func:`~raft_tpu_torch.ops.knn_tile.fused_knn_tile`
- K2 :func:`~raft_tpu_torch.ops.select_tile.select_tile`
- K3 :func:`~raft_tpu_torch.ops.ivf_tile.ivf_items` (the scan of
  :func:`~raft_tpu_torch.ops.ivf_tile.fused_ivf_scan`, over its work list)
- K4 :func:`~raft_tpu_torch.ops.nn_tile.fused_nn_tile`
- K5 :func:`~raft_tpu_torch.ops.pairwise_tile.pairwise_tile`
- K6 :func:`~raft_tpu_torch.ops.knn_tile.twophase_tiles` (phase 1 of
  :func:`~raft_tpu_torch.ops.knn_tile.fused_knn_twophase`)
- K7 :func:`~raft_tpu_torch.ops.pq_scan.ivf_pq_scan` (the IVF-PQ ADC scan)
"""

from raft_tpu_torch.ops.ivf_tile import fused_ivf_scan
from raft_tpu_torch.ops.knn_tile import fused_knn_tile, fused_knn_twophase
from raft_tpu_torch.ops.nn_tile import fused_nn_tile
from raft_tpu_torch.ops.pairwise_tile import pairwise_tile
from raft_tpu_torch.ops.pq_scan import ivf_pq_scan

__all__ = ["fused_ivf_scan", "fused_knn_tile", "fused_knn_twophase", "fused_nn_tile",
           "ivf_pq_scan", "pairwise_tile"]
