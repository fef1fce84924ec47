// K3: one-pass IVF-Flat probe scan.
//
// Replaces raft_tpu/ops/ivf_tile.py:230 fused_ivf_scan (body _ivf_kernel
// :91, selection core topk_update, positions to ids :128).  Per query, walk
// its compacted scan list (slots[q], probed slots first, -1 padded), take
// max(qn + |v|^2 - 2 q.v, 0) to every row of each listed slot, drop vacant
// rows (id < 0), and keep the k smallest (distance, scan position) pairs;
// the position j*cap + row maps back to the row's global id.  Ties resolve
// to the earlier step, then the smaller row.  Unfilled results are
// (+inf, -1).
//
// What bounds it on an H100: at the IVF search of 1M x 128 rows in 1,024
// lists (cap 984), nprobe 32, 1,024 queries, each query scans about 48
// slots of 984 rows: 2*d*rows = 1.2e10 float32 operations in all, 0.2 ms
// at 67 TFLOP/s, and the slots the batch touches are at most the whole
// 1 GB store, 0.3 ms at 3.35 TB/s.  But this kernel reads each query's
// slots for that query alone, some 24 MB a query and 25 GB a batch, so it
// is bound by those bytes (about 7.5 ms from device memory, less where the
// 50 MB L2 catches queries that share lists).  Grouping the queries by
// probed list (the reference's ivfflat_interleaved_scan) is later work.
// The design keeps the loads wide and in flight:
//
//   * One block of 4 warps owns one query.  The query (rounded to bf16
//     for the bf16 instance) sits in shared memory; warp w takes scan steps w, w + 4, ... and skips every
//     -1 entry without touching the store.  The store is read as it is:
//     the ragged cap is masked here, so there is no per-call padded copy
//     of it (the TPU version pads the whole store on every call,
//     raft_tpu/ops/ivf_tile.py:184).
//   * A warp takes a slot 32 rows at a time.  For each chunk of 32
//     dimensions, lane l loads dimension l of all 32 rows (32 coalesced
//     128-byte loads in flight) and accumulates one partial dot product
//     per row; a transposed butterfly (31 shuffles) then leaves the full
//     dot product of row r in lane r, which is the layout the warp top-k
//     of warp_select.cuh takes its candidates in.
//   * Each warp keeps its own running top-k in registers (K2's WarpTopK,
//     gate and staging).  Because the order is lexicographic on
//     (distance, position), the k smallest pairs do not depend on how the
//     steps were shared among the warps: at the end warp 0 merges the other three buffers
//     through shared memory, maps positions to ids and writes the row.
//   * A batch of few queries fills few SMs (one block each): the scan list
//     is not split across blocks.
//
// accum_bf16 is a template instance of the same kernel: the query and every
// loaded slot value are rounded to bf16 as they are loaded (products of two
// bf16 values are exact in float32, and the sums, the norms and every
// select operation stay float32), so the store is never copied.  The
// query's norm and the slot norms are the float32 ones, as in JAX.
#include <cuda_bf16.h>

#include "warp_select.cuh"

namespace raft_tpu_torch {
namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;

template <bool kBF16>
__device__ __forceinline__ float operand(float v) {
  if constexpr (kBF16) {
    return __bfloat162float(__float2bfloat16_rn(v));
  } else {
    return v;
  }
}

// part[r] in every lane holds a partial sum for row r; afterwards lane l's
// part[0] is the total over the warp for row l.  Stage `off` keeps the
// half of the rows whose bit `off` matches the lane's and sends the other
// half to lane ^ off.
__device__ __forceinline__ float transpose_sum(float (&part)[32], int lane) {
#pragma unroll
  for (int off = 16; off >= 1; off >>= 1) {
    bool upper = (lane & off) != 0;
#pragma unroll
    for (int i = 0; i < off; ++i) {
      float send = upper ? part[i] : part[i + off];
      float keep = upper ? part[i + off] : part[i];
      part[i] = keep + __shfl_xor_sync(kFullMask, send, off);
    }
  }
  return part[0];
}

template <int NR, bool kBF16>
__global__ void __launch_bounds__(kThreads)
ivf_tile_kernel(const float* __restrict__ Q, const float* __restrict__ qn,
                const float* __restrict__ SV, const float* __restrict__ SN,
                const int* __restrict__ SI, const int* __restrict__ slots, int d,
                int cap, int n_steps, int k, float* __restrict__ out_d,
                int* __restrict__ out_i) {
  constexpr int kKP = 32 * NR;
  extern __shared__ float4 smem[];
  const int d_pad = (d + 3) & ~3;
  float* qs = reinterpret_cast<float*>(smem);
  float* buf_k = qs + d_pad;
  int* buf_i = reinterpret_cast<int*>(buf_k + (kWarps - 1) * kKP);

  const int q = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  for (int c = tid; c < d; c += kThreads) qs[c] = operand<kBF16>(Q[(size_t)q * d + c]);
  __syncthreads();
  const float qnv = qn[q];
  const int* srow = slots + (size_t)q * n_steps;

  WarpTopK<NR> topk;
  topk.init();
  Stage stage{CUDART_INF_F, INT_MAX, 0};
  float thr_k = CUDART_INF_F;
  int thr_i = INT_MAX;

  for (int j = warp; j < n_steps; j += kWarps) {
    const int s = srow[j];
    if (s < 0) continue;  // warp-uniform: a pad step reads nothing
    const float* sv = SV + (size_t)s * cap * d;
    const float* sn = SN + (size_t)s * cap;
    const int* si = SI + (size_t)s * cap;
    for (int r0 = 0; r0 < cap; r0 += 32) {
      const int rows = min(32, cap - r0);
      float part[32];
#pragma unroll
      for (int r = 0; r < 32; ++r) part[r] = 0.f;
      for (int c0 = 0; c0 < d; c0 += 32) {
        const int c = c0 + lane;
        const float qv = c < d ? qs[c] : 0.f;
        const float* col = sv + (size_t)r0 * d + c;
#pragma unroll
        for (int r = 0; r < 32; ++r) {
          float v = (c < d && r < rows) ? col[(size_t)r * d] : 0.f;
          part[r] = fmaf(qv, operand<kBF16>(v), part[r]);
        }
      }
      const float dot = transpose_sum(part, lane);
      const int row = r0 + lane;
      float key = CUDART_INF_F;
      int pos = INT_MAX;
      if (row < cap && si[row] >= 0) {
        key = fmaxf(qnv + sn[row] - 2.f * dot, 0.f);
        pos = j * cap + row;
      }
      offer(topk, stage, key, pos, lane, k, thr_k, thr_i);
    }
  }
  flush(topk, stage, lane, k, thr_k, thr_i);

  if (warp > 0) topk.save(buf_k + (warp - 1) * kKP, buf_i + (warp - 1) * kKP, lane);
  __syncthreads();
  if (warp != 0) return;
  for (int w = 0; w < kWarps - 1; ++w) {
#pragma unroll
    for (int r = 0; r < NR; ++r) {
      int e = w * kKP + r * 32 + lane;
      offer(topk, stage, buf_k[e], buf_i[e], lane, k, thr_k, thr_i);
    }
  }
  flush(topk, stage, lane, k, thr_k, thr_i);
#pragma unroll
  for (int r = 0; r < NR; ++r) {
    int p = r * 32 + lane;
    if (p >= k) continue;
    int pos = topk.id[r];
    float key = CUDART_INF_F;
    int id = -1;
    if (pos != INT_MAX) {
      key = topk.key[r];
      id = SI[(size_t)srow[pos / cap] * cap + pos % cap];
    }
    size_t off = (size_t)q * k + p;
    out_d[off] = key;
    out_i[off] = id;
  }
}

template <int NR, bool kBF16>
cudaError_t launch(dim3 grid, cudaStream_t s, const float* q, const float* qn,
                   const float* sv, const float* sn, const int* si, const int* slots,
                   int d, int cap, int n_steps, int k, float* od, int* oi) {
  const int bytes = ((d + 3) & ~3) * 4 + (kWarps - 1) * 32 * NR * 8;
  cudaError_t err = cudaFuncSetAttribute(
      ivf_tile_kernel<NR, kBF16>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  ivf_tile_kernel<NR, kBF16><<<grid, kThreads, bytes, s>>>(q, qn, sv, sn, si, slots, d, cap,
                                                        n_steps, k, od, oi);
  return cudaGetLastError();
}

template <bool kBF16>
cudaError_t launch_k(dim3 grid, cudaStream_t s, const float* q, const float* qn,
                     const float* sv, const float* sn, const int* si,
                     const int* slots, int d, int cap, int n_steps, int k, float* od,
                     int* oi) {
  if (k <= 32) return launch<1, kBF16>(grid, s, q, qn, sv, sn, si, slots, d, cap, n_steps, k, od, oi);
  if (k <= 64) return launch<2, kBF16>(grid, s, q, qn, sv, sn, si, slots, d, cap, n_steps, k, od, oi);
  return launch<4, kBF16>(grid, s, q, qn, sv, sn, si, slots, d, cap, n_steps, k, od, oi);
}

}  // namespace
}  // namespace raft_tpu_torch

// Q (nq, d), qn (nq,), SV (S, cap, d), SN (S, cap): float32; SI (S, cap) and
// slots (nq, n_steps): int32; all row-major and contiguous, every slots
// entry -1 or in [0, S).  out_d (nq, k) float32, out_i (nq, k) int32: each
// query's k best, ascending, with global ids.  k <= 128,
// n_steps * cap < 2^31.  Returns cudaGetLastError().
extern "C" int ivf_tile_launch(const void* Q, const void* qn, const void* SV,
                               const void* SN, const void* SI, const void* slots,
                               int nq, int d, int cap, int n_steps, int k,
                               int accum_bf16, void* out_d, void* out_i,
                               void* stream) {
  using namespace raft_tpu_torch;
  if (k < 1 || k > 128 || nq < 1 || d < 1 || cap < 1 || n_steps < 1) {
    return (int)cudaErrorInvalidValue;
  }
  dim3 grid(nq);
  cudaStream_t s = (cudaStream_t)stream;
  auto q = (const float*)Q;
  auto a = (const float*)qn;
  auto sv = (const float*)SV;
  auto sn = (const float*)SN;
  auto si = (const int*)SI;
  auto sl = (const int*)slots;
  auto od = (float*)out_d;
  auto oi = (int*)out_i;
  if (accum_bf16) {
    return (int)launch_k<true>(grid, s, q, a, sv, sn, si, sl, d, cap, n_steps, k, od, oi);
  }
  return (int)launch_k<false>(grid, s, q, a, sv, sn, si, sl, d, cap, n_steps, k, od, oi);
}
