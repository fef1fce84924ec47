// K1: fused squared-L2 distance + running top-k (brute-force kNN).
//
// Replaces raft_tpu/ops/knn_tile.py:563 fused_knn_tile (body _knn_kernel
// :347, selection core topk_update :239).  Per query, the k smallest of
// max(qn + xn - 2 q.x, 0) over the index rows, ascending, with int32 ids;
// ties resolve to the smaller id.
//
// What bounds it on an H100: the distance tile, 2*nq*n*d operations.  The
// JAX contract is precision="highest", which one TF32 pass does not meet
// but 3xTF32 on the tensor cores does (knn_tile.cuh): three TF32 products
// per multiply-add, so at 1M x 128 with 1024 queries 3 x 2.6e11 operations
// against 495 TFLOP/s, 1.6 ms, where the FFMA units would need 3.9 ms at
// 67 TFLOP/s; the 512 MB index takes 0.15 ms to read at 3.35 TB/s.  So the
// kernel is bound by operations, and the design keeps the tensor cores fed
// and the selection off their path:
//
//   * The body is knn_tile.cuh (shared with K6): one warpgroup issues
//     the wgmmas on index tiles that a producer warp brings in by TMA
//     copies, and sixteen warps of their own fold the distance tiles into
//     the running top-k (warp_select.cuh).
//   * One block per SM (some 220 KB of shared memory each); 1024 queries
//     are 16 query tiles, so the index is also split across blocks
//     (grid.y, rows_per_split from ops/knn_tile.py:split_rows, 8 splits
//     at 1M on 132 SMs, from the query tile that knn_block_q below
//     reports).  Each split writes its own top-k and
//     select_tile.cu (K2) merges the partials: the twophase pattern of
//     raft_tpu/ops/knn_tile.py:474, which keeps this kernel free of any
//     state shared between blocks.
//
// The norms qn and xn come from the wrapper, as pad_with_norms computes
// them outside the Pallas call.
//
// bf16 != 0 runs the kBF16 instance, the JAX precision="default"
// (knn_tile.cuh): one pass of exact bfloat16 products, 2*nq*n*d TF32
// operations, 0.53 ms at the 1M shape, where a bf16 wgmma would take 0.27.
#include "knn_tile.cuh"

// Q (nq, d), X (n, d), qn (nq,), xn (n,): float32, row-major, contiguous,
// 16-byte aligned, d a multiple of 8.  out_d / out_i: (nq, n_splits, k),
// where n_splits = ceil(n / rows_per_split) and rows_per_split is a
// multiple of 64.  bf16: 0 for 3xTF32 products, 1 for products of the
// operands rounded to bfloat16.  Returns cudaGetLastError().
extern "C" int knn_tile_launch(const void* Q, const void* X, const void* qn,
                               const void* xn, int nq, int n, int d, int k,
                               int rows_per_split, int bf16, void* out_d, void* out_i,
                               void* stream RAFT_TPU_PHASES_PARAM) {
  using namespace raft_tpu_torch;
  if (rows_per_split < 1 || n < 1) return (int)cudaErrorInvalidValue;
  const int n_splits = (n + rows_per_split - 1) / rows_per_split;
  KnnArgs a{(const float*)Q, (const float*)X, (const float*)qn, (const float*)xn,
            nq, n, d, k, rows_per_split, 1, n_splits, (float*)out_d, (int*)out_i, {}};
  RAFT_TPU_SET_PHASES(a);
  cudaStream_t s = (cudaStream_t)stream;
  return (int)(bf16 ? launch<kSplits, true>(n_splits, s, a)
                    : launch<kSplits, false>(n_splits, s, a));
}

// The block geometry, for the wrapper and the tools, so that it is
// decided here only: the queries a block takes at depth d (a multiple of
// 8), and the dynamic shared memory of a block at that depth and k.
extern "C" int knn_block_q(int d) { return raft_tpu_torch::block_q(d); }

extern "C" int knn_smem_bytes(int d, int k) {
  using namespace raft_tpu_torch;
  const int kp = k <= 32 ? 32 : k <= 64 ? 64 : 128;
  return smem_bytes(block_q(d), kp, d);
}
