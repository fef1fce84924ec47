// K4: fused squared-L2 distance + 1-nearest-neighbour (the k-means
// assignment).
//
// Replaces raft_tpu/ops/nn_tile.py:151 fused_nn_tile (body _nn_kernel :62,
// and the 128 -> 1 lane reduction it leaves to XLA at :178-185).  Per row
// of x, the minimum of max(xn + yn - 2 x.y, 0) over the rows of y and its
// int32 index; ties resolve to the smaller index, and a row with no finite
// distance keeps (inf, INT_MAX), the JAX IDX_SENTINEL.
//
// What bounds it on an H100: at the IVF build's assignment, x 131,072 x 128
// against y 1,024 x 128, the tile is 2*m*n*d = 3.4e10 float32 operations in
// FFMA, 0.51 ms at 67 TFLOP/s, against 68 MB to read, 0.02 ms.  (3xTF32 on
// the tensor cores, as K1 and K6 compute, would meet the JAX
// precision="highest" contract too; this kernel has not been redesigned
// for it.)  So it is bound by operations, and the design is an FFMA tile
// with a running minimum:
//
//   * A block of 256 threads owns 64 rows of x and walks all of y in tiles
//     of 128 rows (the TPU grid's sequential y axis becomes this loop);
//     the products come from the FFMA tile of l2_tile.cuh.  At
//     m = 131,072 that is 2,048 blocks, enough for 132 SMs without
//     splitting y.  (A call with few rows of x, say 1,024 x 100k, gets
//     only 16 blocks: a split of y with a merge would fill the card, and
//     is not done here.)
//   * Each thread folds its 4 x 8 accumulators into a running (value,
//     index) pair per row in registers; no distance tile goes to shared
//     memory.  After the last y tile the 16 threads that share a row
//     (one half-warp) reduce their pairs by shuffles, lexicographically,
//     and one writes (m,) values and (m,) ids: the lane layout and the
//     reduction outside the kernel of the TPU version are gone.
//
// The norms xn and yn come from the wrapper, as pad_with_norms computes
// them outside the Pallas call.  Ragged edges are masked here: loads past
// the edge read 0, and columns past n are never candidates.
#include <climits>
#include <math_constants.h>

#include "l2_tile.cuh"

namespace raft_tpu_torch {
namespace {

using namespace l2_tile;

// Take (v, j) over (best, best_j): a strict improvement, or an equal finite
// value with a smaller index (raft_tpu/distance/fused_l2_nn.py
// _default_reduce).  A NaN is never taken.
__device__ __forceinline__ bool takes(float v, int j, float best, int best_j) {
  return v < best || (v == best && v < CUDART_INF_F && j < best_j);
}

__global__ void __launch_bounds__(kThreads, 2)
nn_tile_kernel(const float* __restrict__ X, const float* __restrict__ Y,
               const float* __restrict__ xn, const float* __restrict__ yn, int m,
               int n, int d, float* __restrict__ out_v, int* __restrict__ out_i) {
  __shared__ float4 smem[kLoadBytes / 16];
  char* base = reinterpret_cast<char*>(smem);
  const int tid = threadIdx.x;
  const int tx = tid & 15;  // y columns tile_col(j, tx)
  const int ty = tid >> 4;  // x rows ty*4 + i
  const int x0 = blockIdx.x * kBQ;

  float xn_reg[4], best_v[4];
  int best_i[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    int row = x0 + ty * 4 + i;
    xn_reg[i] = row < m ? xn[row] : 0.f;
    best_v[i] = CUDART_INF_F;
    best_i[i] = INT_MAX;
  }

  for (int y0 = 0; y0 < n; y0 += kBN) {
    float acc[4][8];
    dot_tile(acc, base, X, x0, m, Y, y0, n, d, tid);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      int col = y0 + tile_col(j, tx);
      if (col >= n) continue;
      float ynj = yn[col];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float v = fmaxf(xn_reg[i] + ynj - 2.f * acc[i][j], 0.f);
        if (takes(v, col, best_v[i], best_i[i])) {
          best_v[i] = v;
          best_i[i] = col;
        }
      }
    }
  }

  // the 16 threads of a row are lanes tx = 0..15 of one half-warp
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) {
      float ov = __shfl_xor_sync(0xffffffffu, best_v[i], off);
      int oi = __shfl_xor_sync(0xffffffffu, best_i[i], off);
      if (takes(ov, oi, best_v[i], best_i[i])) {
        best_v[i] = ov;
        best_i[i] = oi;
      }
    }
    int row = x0 + ty * 4 + i;
    if (tx == 0 && row < m) {
      out_v[row] = best_v[i];
      out_i[row] = best_i[i];
    }
  }
}

}  // namespace
}  // namespace raft_tpu_torch

// X (m, d), Y (n, d), xn (m,), yn (n,): float32, row-major, contiguous;
// out_v (m,) float32, out_i (m,) int32.  Returns cudaGetLastError().
extern "C" int nn_tile_launch(const void* X, const void* Y, const void* xn,
                              const void* yn, int m, int n, int d, void* out_v,
                              void* out_i, void* stream) {
  using namespace raft_tpu_torch;
  if (m < 1 || n < 1 || d < 1) return (int)cudaErrorInvalidValue;
  dim3 grid((m + l2_tile::kBQ - 1) / l2_tile::kBQ);
  nn_tile_kernel<<<grid, l2_tile::kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)X, (const float*)Y, (const float*)xn, (const float*)yn, m, n, d,
      (float*)out_v, (int*)out_i);
  return (int)cudaGetLastError();
}
