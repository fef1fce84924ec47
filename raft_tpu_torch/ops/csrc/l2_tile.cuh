// The float32 FFMA product tile of nn_tile.cu (K4): a block of
// kThreads = 256 threads computes the
// kBQ x kBN = 64 x 128 tile of dot products between rows [q0, q0 + 64) of
// one row-major (rows, d) matrix and rows [x0, x0 + 128) of another.  The
// depth is staged through shared memory kDK = 32 at a time, transposed, and
// each thread accumulates a 4 x 8 register tile (rows ty*4 + i, columns
// tile_col(j, tx)) read as three float4 loads per depth step, so that
// shared memory feeds the FMA units instead of limiting them.  Full float32
// products.  The JAX precision="highest" contract rules out one TF32 pass,
// but not 3xTF32 (two TF32 halves per operand, three products summed in
// float32, which keeps float32's accuracy): K1 and K6 compute that way on
// the tensor cores (knn_tile.cuh).
#pragma once

#include <cuda_runtime.h>

namespace raft_tpu_torch {
namespace l2_tile {

constexpr int kBQ = 64;
constexpr int kBN = 128;
constexpr int kDK = 32;
constexpr int kThreads = 256;
constexpr int kQStride = kBQ + 4;  // rows padded, keeping float4 alignment
constexpr int kXStride = kBN + 4;
// shared memory of the two depth chunks
constexpr int kLoadBytes = kDK * (kQStride + kXStride) * 4;

// Column of the tile held in accumulator column j (0..7) of thread tx.
__device__ __forceinline__ int tile_col(int j, int tx) {
  return j < 4 ? tx * 4 + j : 64 + tx * 4 + j - 4;
}

// Copy rows [row0, row0 + rows) x columns [k0, k0 + kDK) of a row-major
// (n_rows, d) matrix into dst[c][r] (transposed), zero past the edges.  A
// warp takes 4 rows x 8 columns per step: 32-byte segments of global
// memory, and 32 distinct banks for the transposed stores.
template <int kRows, int kStride>
__device__ __forceinline__ void load_chunk(float (*dst)[kStride], const float* src,
                                           int row0, int row_end, int k0, int d,
                                           int tid) {
#pragma unroll
  for (int e = tid; e < kRows * kDK; e += kThreads) {
    int g = e >> 5, l = e & 31;
    int c = (g & 3) * 8 + (l & 7);
    int r = (g >> 2) * 4 + (l >> 3);
    int row = row0 + r, col = k0 + c;
    dst[c][r] = (row < row_end && col < d) ? src[(size_t)row * d + col] : 0.f;
  }
}

// acc[i][j] = Q[q0 + ty*4 + i] . X[x0 + tile_col(j, tx)] over the whole
// depth d; rows past q_end or x_end read as zero.  `base` is kLoadBytes of
// shared memory; every thread of the block calls, and the block is in
// step (__syncthreads) when it returns.
__device__ __forceinline__ void dot_tile(float (&acc)[4][8], char* base,
                                         const float* __restrict__ Q, int q0,
                                         int q_end, const float* __restrict__ X,
                                         int x0, int x_end, int d, int tid) {
  auto qs = reinterpret_cast<float (*)[kQStride]>(base);
  auto xs = reinterpret_cast<float (*)[kXStride]>(base + kDK * kQStride * 4);
  const int tx = tid & 15;
  const int ty = tid >> 4;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < d; k0 += kDK) {
    load_chunk<kBQ, kQStride>(qs, Q, q0, q_end, k0, d, tid);
    load_chunk<kBN, kXStride>(xs, X, x0, x_end, k0, d, tid);
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < kDK; ++kk) {
      float4 a4 = *reinterpret_cast<const float4*>(&qs[kk][ty * 4]);
      float4 b0 = *reinterpret_cast<const float4*>(&xs[kk][tx * 4]);
      float4 b1 = *reinterpret_cast<const float4*>(&xs[kk][64 + tx * 4]);
      float a[4] = {a4.x, a4.y, a4.z, a4.w};
      float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
}

}  // namespace l2_tile
}  // namespace raft_tpu_torch
