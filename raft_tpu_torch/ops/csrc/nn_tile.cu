// K4: fused squared-L2 distance + 1-nearest-neighbour (the k-means
// assignment).
//
// Replaces raft_tpu/ops/nn_tile.py:151 fused_nn_tile (body _nn_kernel :62,
// and the 128 -> 1 lane reduction it leaves to XLA at :178-185).  Per row
// of x, the minimum of max(xn + yn - 2 x.y, 0) over the rows of y and its
// int32 index; ties resolve to the smaller index, a row with no finite
// distance keeps (inf, INT_MAX), the JAX IDX_SENTINEL, and a NaN distance
// is never taken (raft_tpu/distance/fused_l2_nn.py _default_reduce).
//
// What bounds it on an H100: at the IVF build's assignment, x 131,072 x 128
// against y 1,024 x 128, the tile is 2*m*n*d = 3.4e10 operations: 0.21 ms
// in 3xTF32 on the tensor cores (the float32-faithful form of the JAX
// precision="highest" contract, knn_tile.cuh), 0.51 ms in float32 FFMA,
// against 68 MB to read, 0.02 ms.  So it is bound by operations on the
// tensor cores.
//
// Design: the work-list instance kNnItems of the fused kNN body
// (knn_tile.cuh), at k = 1.  The rows of x are the queries: item i is the
// x tile [i N, i N + N) (N = block_q(d), 64 at depth 128) against all of
// y, so the items are implicit, ceil(m / N) of them.  A grid of one block
// per SM walks them (15 or 16 items a block at the build's shape); for
// each, the multiplying warpgroup splits the x tile into B's TF32 halves,
// the producer streams y through the TMA ring (16 tiles of 64 rows at n =
// 1,024, from L2 after the first items), the distance tile is 3xTF32, and
// the selection warps keep each row's best (value, index) in a buffer of
// one, cold at each item, with K4's own contract at the write: a row whose
// best is not finite is written (inf, INT_MAX).  The epilogue keeps a NaN
// distance a NaN (K1 clamps with fmaxf, which would make it 0), and the
// selection never takes one.  This retires the FFMA tile that K4 had.
//
// The norms xn and yn come from the wrapper, as pad_with_norms computes
// them outside the Pallas call; the wrapper pads a copy of x and y where
// the depth is not a multiple of 8 (ops/knn_tile.py:prepare_operands).
#include "knn_tile.cuh"

// X (m, d), Y (n, d): float32, row-major, contiguous, 16-byte aligned, d a
// multiple of 8; xn (m,), yn (n,) the squared norms; out_v (m,) float32,
// out_i (m,) int32.  bf16: 0 for 3xTF32 products, 1 for products of the
// operands rounded to bfloat16 (the JAX precision="default",
// knn_tile.cuh).  Returns cudaGetLastError().
extern "C" int nn_tile_launch(const void* X, const void* Y, const void* xn, const void* yn,
                              int m, int n, int d, int bf16, void* out_v, void* out_i,
                              void* stream RAFT_TPU_PHASES_PARAM) {
  using namespace raft_tpu_torch;
  if (m < 1 || n < 1 || d < 8) return (int)cudaErrorInvalidValue;
  const int n_q = block_q(d);
  int blocks;
  cudaError_t err = work_blocks((m + n_q - 1) / n_q, &blocks);
  if (err != cudaSuccess) return (int)err;
  const WorkList wl{nullptr, nullptr, nullptr, 1, nullptr, n};
  KnnArgs a{(const float*)X, (const float*)Y, (const float*)xn, (const float*)yn,
            m, n, d, 1, 0, 0, 0, (float*)out_v, (int*)out_i, wl};
  RAFT_TPU_SET_PHASES(a);
  cudaStream_t s = (cudaStream_t)stream;
  return (int)(bf16 ? launch<kNnItems, true>(blocks, s, a, n_q)
                    : launch<kNnItems, false>(blocks, s, a, n_q));
}
