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
// The norms qn and xn come from the wrapper, as pad_with_norms computes
// them outside the Pallas call.  Ragged edges (nq, n, d not multiples of
// the tile) are masked here: loads past the edge read 0, and rows past the
// end of the split never enter the top-k.
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

template <int NR>
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
    t.store(out_d + off, out_i + off, k, lane, 0, n - 1);
  }
}

template <int NR>
cudaError_t launch(dim3 grid, cudaStream_t s, const float* q, const float* x,
                   const float* a, const float* b, int nq, int n, int d, int k,
                   int rows_per_split, float* od, int* oi) {
  constexpr int bytes = smem_bytes<NR>();
  cudaError_t err = cudaFuncSetAttribute(
      knn_tile_kernel<NR>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  knn_tile_kernel<NR><<<grid, kThreads, bytes, s>>>(q, x, a, b, nq, n, d, k,
                                                    rows_per_split, od, oi);
  return cudaGetLastError();
}

}  // namespace
}  // namespace raft_tpu_torch

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
  if (k <= 32) return (int)launch<1>(grid, s, q, x, a, b, nq, n, d, k, rows_per_split, od, oi);
  if (k <= 64) return (int)launch<2>(grid, s, q, x, a, b, nq, n, d, k, rows_per_split, od, oi);
  return (int)launch<4>(grid, s, q, x, a, b, nq, n, d, k, rows_per_split, od, oi);
}
