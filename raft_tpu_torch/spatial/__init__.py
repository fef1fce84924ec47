"""Nearest-neighbour search: exact (brute force, the random ball cover,
and sharded over a rank mesh) and approximate (IVF-Flat, IVF-PQ, IVF-SQ,
and IVF-Flat slot-sharded), and k-selection."""

from raft_tpu_torch.spatial.ann import (IVFFlatIndex, IVFFlatParams, IVFPQIndex, IVFPQParams,
                                        IVFSQIndex, IVFSQParams, approx_knn_build_index,
                                        approx_knn_search, ivf_flat_build, ivf_flat_extend,
                                        ivf_flat_reconstruct, ivf_flat_search, ivf_pq_build,
                                        ivf_pq_search, ivf_sq_build, ivf_sq_search)
from raft_tpu_torch.spatial.ball_cover import (BallCoverIndex, rbc_all_knn_query,
                                               rbc_build_index, rbc_knn_query)
from raft_tpu_torch.spatial.fused_l2_knn import fused_l2_knn
from raft_tpu_torch.spatial.haversine import haversine_knn
from raft_tpu_torch.spatial.knn import brute_force_knn, knn_merge_parts
from raft_tpu_torch.spatial.mnmg_knn import mnmg_ivf_flat_search, mnmg_knn
from raft_tpu_torch.spatial.select_k import select_k

__all__ = ["BallCoverIndex", "IVFFlatIndex", "IVFFlatParams", "IVFPQIndex", "IVFPQParams",
           "IVFSQIndex", "IVFSQParams", "approx_knn_build_index", "approx_knn_search",
           "brute_force_knn", "fused_l2_knn", "haversine_knn", "ivf_flat_build",
           "ivf_flat_extend", "ivf_flat_reconstruct", "ivf_flat_search", "ivf_pq_build",
           "ivf_pq_search", "ivf_sq_build", "ivf_sq_search", "knn_merge_parts",
           "mnmg_ivf_flat_search", "mnmg_knn",
           "rbc_all_knn_query", "rbc_build_index", "rbc_knn_query", "select_k"]
