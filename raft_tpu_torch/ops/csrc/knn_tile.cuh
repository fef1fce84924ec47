// The fused squared-L2 distance + top-k kernel shared by knn_tile.cu (K1)
// and knn_twophase.cu (K6).
//
// A block of 256 threads owns BQ = 64 queries and the index rows
// [split * rows_per_split, (split + 1) * rows_per_split), walked in tiles
// of BN = 128 rows: the FFMA product tile of l2_tile.cuh goes to shared
// memory as squared distances max(qn + xn - 2 q.x, 0), and each warp folds
// 8 of its query rows into their running top-k (warp_select.cuh), kept in
// shared memory so that the accumulators have the registers and two
// blocks fit on an SM.  Each (query, split) writes its k smallest, sorted,
// at out[(q * n_splits + split) * k].  The two kernels differ only in how
// a slot with no finite key is written:
//
//   * K1 (kTileParts = false) clamps its id into [0, n - 1], as the JAX
//     kernel's output contract does; K2 merges the splits.
//   * K6 (kTileParts = true) writes (+inf, -1), as the JAX two-phase
//     kernel's tile_local_topk does; its splits are the JAX index tiles.
//
// The norms qn and xn come from the wrapper.  Ragged edges (nq, n, d not
// multiples of the tile) are masked: loads past the edge read 0, and rows
// past the end of the split never enter the top-k.
#pragma once

#include "l2_tile.cuh"
#include "warp_select.cuh"

namespace raft_tpu_torch {
namespace {

using namespace l2_tile;

constexpr int kWarps = kThreads / 32;
constexpr int kQPerWarp = kBQ / kWarps;
// shared memory: the depth chunks of the two tiles, reused for the
// distance tile, then the top-k buffers and the thresholds
constexpr int kDistBytes = kBQ * kXStride * 4;
constexpr int kTileBytes = kLoadBytes > kDistBytes ? kLoadBytes : kDistBytes;

template <int NR>
constexpr int smem_bytes() {
  return kTileBytes + kBQ * 32 * NR * 8 + kBQ * 8;
}

template <int NR, bool kTileParts>
__global__ void __launch_bounds__(kThreads, 2)
knn_tile_kernel(const float* __restrict__ Q, const float* __restrict__ X,
                const float* __restrict__ qn, const float* __restrict__ xn,
                int nq, int n, int d, int k, int rows_per_split,
                float* __restrict__ out_d, int* __restrict__ out_i) {
  constexpr int kKP = 32 * NR;
  extern __shared__ float4 smem[];
  char* base = reinterpret_cast<char*>(smem);
  auto dist = reinterpret_cast<float (*)[kXStride]>(base);
  float* buf_k = reinterpret_cast<float*>(base + kTileBytes);
  int* buf_i = reinterpret_cast<int*>(buf_k + kBQ * kKP);
  float* thr_k = reinterpret_cast<float*>(buf_i + kBQ * kKP);
  int* thr_i = reinterpret_cast<int*>(thr_k + kBQ);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int tx = tid & 15;  // index columns tx*4 + j and 64 + tx*4 + j
  const int ty = tid >> 4;  // query rows ty*4 + i
  const int q0 = blockIdx.x * kBQ;
  const int split = blockIdx.y;
  const int n_splits = gridDim.y;
  const int row_begin = split * rows_per_split;
  const int row_end = min(n, row_begin + rows_per_split);

  for (int e = tid; e < kBQ * kKP; e += kThreads) {
    buf_k[e] = CUDART_INF_F;
    buf_i[e] = INT_MAX;
  }
  if (tid < kBQ) {
    thr_k[tid] = CUDART_INF_F;
    thr_i[tid] = INT_MAX;
  }
  float qn_reg[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    int q = q0 + ty * 4 + i;
    qn_reg[i] = q < nq ? qn[q] : 0.f;
  }
  Stage stage[kQPerWarp];
#pragma unroll
  for (int qq = 0; qq < kQPerWarp; ++qq) stage[qq] = Stage{CUDART_INF_F, INT_MAX, 0};

  for (int x0 = row_begin; x0 < row_end; x0 += kBN) {
    float acc[4][8];
    dot_tile(acc, base, Q, q0, nq, X, x0, row_end, d, tid);

    float xn_reg[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      int row = x0 + tile_col(j, tx);
      xn_reg[j] = row < row_end ? xn[row] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float v[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) v[j] = fmaxf(qn_reg[i] + xn_reg[j] - 2.f * acc[i][j], 0.f);
      *reinterpret_cast<float4*>(&dist[ty * 4 + i][tx * 4]) = make_float4(v[0], v[1], v[2], v[3]);
      *reinterpret_cast<float4*>(&dist[ty * 4 + i][64 + tx * 4]) =
          make_float4(v[4], v[5], v[6], v[7]);
    }
    __syncthreads();

#pragma unroll
    for (int qq = 0; qq < kQPerWarp; ++qq) {
      int r = warp * kQPerWarp + qq;
      if (q0 + r >= nq) continue;  // warp-uniform
      SharedTopK<NR> buf{buf_k + r * kKP, buf_i + r * kKP};
      float tk = thr_k[r];
      int ti = thr_i[r];
#pragma unroll 1
      for (int b = 0; b < kBN; b += 32) {
        int row = x0 + b + lane;
        float key = CUDART_INF_F;
        int id = INT_MAX;
        if (row < row_end) {
          key = dist[r][b + lane];
          id = row;
        }
        offer(buf, stage[qq], key, id, lane, k, tk, ti);
      }
      if (lane == 0) {
        thr_k[r] = tk;
        thr_i[r] = ti;
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int qq = 0; qq < kQPerWarp; ++qq) {
    int r = warp * kQPerWarp + qq;
    int q = q0 + r;
    if (q >= nq) continue;
    SharedTopK<NR> buf{buf_k + r * kKP, buf_i + r * kKP};
    float tk = thr_k[r];
    int ti = thr_i[r];
    flush(buf, stage[qq], lane, k, tk, ti);
    WarpTopK<NR> t;
    t.load(buf.key_s, buf.id_s, lane);
    size_t off = ((size_t)q * n_splits + split) * k;
    if (kTileParts) {
      // a slot with no finite key is (+inf, -1), as tile_local_topk
      // writes it
#pragma unroll
      for (int r = 0; r < NR; ++r) {
        int p = r * 32 + lane;
        if (p < k) {
          bool live = t.key[r] < CUDART_INF_F;
          out_d[off + p] = live ? t.key[r] : CUDART_INF_F;
          out_i[off + p] = live ? t.id[r] : -1;
        }
      }
    } else {
      t.store(out_d + off, out_i + off, k, lane, 0, n - 1);
    }
  }
}

template <int NR, bool kTileParts>
cudaError_t launch(dim3 grid, cudaStream_t s, const float* q, const float* x,
                   const float* a, const float* b, int nq, int n, int d, int k,
                   int rows_per_split, float* od, int* oi) {
  constexpr int bytes = smem_bytes<NR>();
  cudaError_t err = cudaFuncSetAttribute(knn_tile_kernel<NR, kTileParts>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  knn_tile_kernel<NR, kTileParts><<<grid, kThreads, bytes, s>>>(
      q, x, a, b, nq, n, d, k, rows_per_split, od, oi);
  return cudaGetLastError();
}

}  // namespace
}  // namespace raft_tpu_torch
