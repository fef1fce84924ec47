// K6: phase 1 of the two-phase fused kNN — per index tile, its 128
// smallest squared-L2 distances with global ids.
//
// Replaces raft_tpu/ops/knn_tile.py:474 fused_knn_twophase (body
// _knn_twophase_kernel :383, tile selection tile_local_topk :208).  For
// each query and each index tile of bn rows (bn a multiple of 128, from
// the JAX tile_geometry), the tile's 128 smallest of max(qn + xn - 2 q.x,
// 0), ascending by (distance, id), written to part[q, tile * 128 ...];
// a slot with no finite key is (+inf, -1).  Phase 2, one exact select of k
// over the (nq, n_tiles * 128) candidates, is select_tile.cu (K2) plus a
// gather of the ids, in the wrapper.
//
// What bounds it on an H100: the same distance work as K1, 2*nq*n*d
// float32 operations in FFMA ("highest" rules out TF32): at 1M x 128 with
// 1024 queries, 2.6e11 operations, 3.9 ms at 67 TFLOP/s, against 0.5 GB
// of index read and 0.5 GB of candidates written at bn = 2048 (0.3 ms at
// 3.35 TB/s).  So it is bound by operations.  Its own cost is selection:
// the JAX kernel's point is that no state crosses index tiles, so every
// tile's buffer starts cold and takes at least 128 of its bn candidates
// (about 128 * (1 + ln(bn / 128)) on random data) where K1's warm buffer
// takes a few.
//
// Design: the kernel body is K1's (knn_tile.cuh) with one (64-query
// block, index tile) per block — grid ceil(nq / 64) x n_tiles, 16 x 489 at
// the 1M, bn = 2048 shape — so the TPU grid's two parallel axes become the
// CUDA grid and a block carries nothing between tiles.  A warp per query
// row keeps the tile's top-128 in the 128-wide shared-memory buffer of
// warp_select.cuh (64 rows x 128 x 8 bytes = 64 KB, plus the 33 KB
// distance tile: two blocks an SM), and writes the sorted buffer straight
// to the part buffers.
#include "knn_tile.cuh"

// Q (nq, d), X (n, d), qn (nq,), xn (n,): float32, row-major, contiguous.
// out_d / out_i: (nq, n_tiles, 128), n_tiles = ceil(n / bn), bn a
// multiple of 128.  Returns cudaGetLastError().
extern "C" int knn_twophase_launch(const void* Q, const void* X, const void* qn,
                                   const void* xn, int nq, int n, int d, int bn,
                                   void* out_d, void* out_i, void* stream) {
  using namespace raft_tpu_torch;
  constexpr int kPad = 128;  // the JAX kpad: every tile keeps 128
  if (bn < kBN || bn % kBN != 0 || nq < 1 || n < 1) {
    return (int)cudaErrorInvalidValue;
  }
  int n_tiles = (n + bn - 1) / bn;
  dim3 grid((nq + kBQ - 1) / kBQ, n_tiles);
  return (int)launch<4, true>(grid, (cudaStream_t)stream, (const float*)Q,
                              (const float*)X, (const float*)qn, (const float*)xn,
                              nq, n, d, kPad, bn, (float*)out_d, (int*)out_i);
}
