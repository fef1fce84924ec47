// K1: fused squared-L2 distance + running top-k (brute-force kNN).
//
// Replaces raft_tpu/ops/knn_tile.py:563 fused_knn_tile (body _knn_kernel
// :347, selection core topk_update :239).  Per query, the k smallest of
// max(qn + xn - 2 q.x, 0) over the index rows, ascending, with int32 ids;
// ties resolve to the smaller id.
//
// What bounds it on an H100: the distance tile is 2*nq*n*d float32
// operations done in FFMA (the JAX contract is precision="highest", so no
// TF32 tensor cores); at 1M x 128 with 1024 queries that is 2.6e11
// operations against 67 TFLOP/s, some 4 ms, while the 512 MB index takes
// 0.15 ms to read at 3.35 TB/s.  So the kernel is bound by operations, and
// the design keeps the FMA units fed and keeps the selection off the
// critical path:
//
//   * A block of 256 threads owns a tile of BQ = 64 queries and walks its
//     share of the index in tiles of BN = 128 rows (the TPU grid's
//     sequential index axis becomes this loop).  The product tile is the
//     FFMA tile of l2_tile.cuh, which K4 shares.
//   * The distance tile goes to shared memory and each warp folds 8 of its
//     query rows into their running top-k (warp_select.cuh).  The buffers
//     live in shared memory, not registers, so that the accumulators have
//     the registers and two blocks fit on an SM: one block's selection
//     overlaps the other's products.  The threshold gate skips nearly
//     every batch once the buffers are warm, and the rows that pass are
//     staged in registers so that a merge takes many of them at once.
//   * 1024 queries give only 16 query tiles for 132 SMs, so the index is
//     also split across blocks (grid.y).  Each split writes its own top-k
//     and select_tile.cu (K2) merges the partials: the twophase pattern of
//     raft_tpu/ops/knn_tile.py:474, which keeps this kernel free of any
//     state shared between blocks.
//
// The kernel body is shared with K6 (knn_tile.cuh).  The norms qn and xn
// come from the wrapper, as pad_with_norms computes them outside the
// Pallas call.
#include "knn_tile.cuh"

// Q (nq, d), X (n, d), qn (nq,), xn (n,): float32, row-major, contiguous.
// out_d / out_i: (nq, n_splits, k), where n_splits = ceil(n / rows_per_split)
// and rows_per_split is a multiple of 128.  Returns cudaGetLastError().
extern "C" int knn_tile_launch(const void* Q, const void* X, const void* qn,
                               const void* xn, int nq, int n, int d, int k,
                               int rows_per_split, void* out_d, void* out_i,
                               void* stream) {
  using namespace raft_tpu_torch;
  if (k < 1 || k > 128 || rows_per_split % kBN != 0 || nq < 1 || n < 1) {
    return (int)cudaErrorInvalidValue;
  }
  int n_splits = (n + rows_per_split - 1) / rows_per_split;
  dim3 grid((nq + kBQ - 1) / kBQ, n_splits);
  cudaStream_t s = (cudaStream_t)stream;
  auto q = (const float*)Q;
  auto x = (const float*)X;
  auto a = (const float*)qn;
  auto b = (const float*)xn;
  auto od = (float*)out_d;
  auto oi = (int*)out_i;
  if (k <= 32) return (int)launch<1, false>(grid, s, q, x, a, b, nq, n, d, k, rows_per_split, od, oi);
  if (k <= 64) return (int)launch<2, false>(grid, s, q, x, a, b, nq, n, d, k, rows_per_split, od, oi);
  return (int)launch<4, false>(grid, s, q, x, a, b, nq, n, d, k, rows_per_split, od, oi);
}
