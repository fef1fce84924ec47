// K5: generic unexpanded pairwise distance,
//   out[i, j] = epilog(reduce_k combine(x[i, k], y[j, k])).
//
// Replaces raft_tpu/ops/pairwise_tile.py:133 pairwise_tile (body _kernel
// :45).  The TPU kernel traces a Python `combine`; CUDA cannot, so the
// metric is a template parameter, the DistanceType id of the metric:
//   3 L1             |x - y|, add
//   4 L2Unexpanded   (x - y)^2, add
//   5 L2SqrtUnexpanded (x - y)^2, add, sqrt
//   7 Linf           |x - y|, max
//   8 Canberra       |x - y| / (|x| + |y|) (0 where both are 0), add
//   9 LpUnexpanded   |x - y|^p, add, ^(1/p)
//  15 JensenShannon  x log(x/m) + y log(y/m), m = (x + y) / 2, 0 log 0 = 0,
//                    add, sqrt(max(a / 2, 0))
//  16 Hamming        x != y, add, / d
// Every combine maps (0, 0) to 0, which is how loads past the ragged edge
// of the depth (read as 0) stay harmless; rows and columns past the edge
// are masked at the store.
//
// Accumulate-only mode (kEpilog false, `epilog` 0 at the entry point):
// the raw reduce of the combine is stored, the epilog skipped.  The
// column-tiled sparse engine (sparse/distance.py) adds or maxes these
// partials across column tiles and applies the metric's epilog once, as
// the TPU kernel's epilog=None does.  It is the same kernel otherwise.
//
// What bounds it on an H100: there is no tensor-core form of these
// reductions, so it is m*n*d combine+reduce steps on the FP32 pipes
// against reading (m + n)*d*4 bytes and writing m*n*4.  A step of L1,
// L2Unexpanded or Linf is two FP32 instructions (x - y, then an add, FMA
// or max of it into the accumulator); the SMs issue 128 of them a clock
// each, so L1 at 1024 x 100,000 x 128 (1.3e10 steps) takes 0.78 ms at
// 1.98 GHz, and its 410 MB output 0.12 ms: bound by the issue of FP32
// instructions, which every other instruction takes slots from.
//
// The design is an SGEMM's: a block of 256 threads owns a 128 x 128
// output tile and each thread an 8 x 8 accumulator tile, rows
// {4ty..4ty+3, 64+4ty..} and columns {4tx..4tx+3, 64+4tx..}.  The depth
// goes through shared memory 8 at a time, stored depth-major (x and y
// transposed, rows padded to 132 floats), so that a depth step takes four
// 128-bit loads (4 rows of x twice, 4 columns of y twice) for 64 combine
// steps: 16 LDS.128 per 512 FP32 instructions.  The operands of the next
// step load while this one computes (two register fragments).  Staging is
// double-buffered through registers: the next slab's global loads
// (128-bit where d is a multiple of 4 and the rows are 16-byte aligned,
// else scalar) are issued before this slab is reduced and stored to the
// other buffer after it, one __syncthreads a slab.  A warp's stores to
// shared memory are 32 consecutive rows of one depth, free of bank
// conflicts.  The output is written row by row as 128-bit streaming
// stores, 256 contiguous bytes for each 16 threads.  Consecutive blocks
// take the m tiles of one n tile, so each y tile is read from device
// memory once.  The TPU grid's sequential depth axis is the loop inside
// the block.
#include <cuda_runtime.h>

namespace raft_tpu_torch {
namespace {

constexpr int kBM = 128;        // output rows (x) a block
constexpr int kBN = 128;        // output columns (y) a block
constexpr int kBK = 8;          // depth a slab
constexpr int kLd = kBM + 4;    // a depth row of a tile in shared memory, padded
constexpr int kThreads = 256;
static_assert(kBM == kBN, "one staging layout for x and y");

template <int M>
struct Metric;

template <>
struct Metric<3> {  // L1
  static constexpr bool kMax = false;
  __device__ static float combine(float x, float y, float) { return fabsf(x - y); }
  __device__ static float epilog(float a, float, int) { return a; }
};

template <>
struct Metric<4> {  // L2Unexpanded
  static constexpr bool kMax = false;
  __device__ static float combine(float x, float y, float) {
    float t = x - y;
    return t * t;
  }
  __device__ static float epilog(float a, float, int) { return a; }
};

template <>
struct Metric<5> : Metric<4> {  // L2SqrtUnexpanded
  __device__ static float epilog(float a, float, int) { return sqrtf(a); }
};

template <>
struct Metric<7> : Metric<3> {  // Linf
  static constexpr bool kMax = true;
};

template <>
struct Metric<8> {  // Canberra
  static constexpr bool kMax = false;
  __device__ static float combine(float x, float y, float) {
    float s = fabsf(x) + fabsf(y);
    return s == 0.f ? 0.f : fabsf(x - y) / s;
  }
  __device__ static float epilog(float a, float, int) { return a; }
};

template <>
struct Metric<9> {  // LpUnexpanded (Minkowski p)
  static constexpr bool kMax = false;
  __device__ static float combine(float x, float y, float p) {
    return powf(fabsf(x - y), p);
  }
  __device__ static float epilog(float a, float p, int) { return powf(a, 1.f / p); }
};

template <>
struct Metric<15> {  // JensenShannon
  static constexpr bool kMax = false;
  __device__ static float combine(float x, float y, float) {
    float m = 0.5f * (x + y);
    float logm = logf(m > 0.f ? m : 1.f);
    float tx = x > 0.f ? x * (logf(x) - logm) : 0.f;
    float ty = y > 0.f ? y * (logf(y) - logm) : 0.f;
    return tx + ty;
  }
  __device__ static float epilog(float a, float, int) {
    return sqrtf(fmaxf(0.5f * a, 0.f));
  }
};

template <>
struct Metric<16> {  // HammingUnexpanded
  static constexpr bool kMax = false;
  __device__ static float combine(float x, float y, float) { return x != y ? 1.f : 0.f; }
  __device__ static float epilog(float a, float, int d) { return a / (float)d; }
};

// Global -> registers -> shared memory staging of one operand's slab:
// rows r0..r0+127 of a (rows, d) matrix, depth k0..k0+7, zero past the
// edges (every combine maps (0, 0) to 0).  128-bit: thread t loads row
// t % 128 at depth 4 (t / 128); scalar: elements t + 256 e, row q / 8 at
// depth q % 8.  Either way a warp's stores are conflict-free or 2-way.
template <bool kVec>
struct Slab {
  float v[4];

  __device__ __forceinline__ void load(const float* __restrict__ A, int rows, int d, int r0,
                                       int k0, int tid) {
    if (kVec) {
      int r = r0 + (tid & (kBM - 1)), k = k0 + 4 * (tid / kBM);
      float4 t = (r < rows && k < d) ? __ldg((const float4*)(A + (size_t)r * d + k))
                                     : make_float4(0.f, 0.f, 0.f, 0.f);
      v[0] = t.x;
      v[1] = t.y;
      v[2] = t.z;
      v[3] = t.w;
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        int q = tid + kThreads * e, r = r0 + q / kBK, k = k0 + (q & (kBK - 1));
        v[e] = (r < rows && k < d) ? __ldg(A + (size_t)r * d + k) : 0.f;
      }
    }
  }

  __device__ __forceinline__ void store(float (*s)[kLd], int tid) const {
    if (kVec) {
      int r = tid & (kBM - 1), k = 4 * (tid / kBM);
#pragma unroll
      for (int e = 0; e < 4; ++e) s[k + e][r] = v[e];
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        int q = tid + kThreads * e;
        s[q & (kBK - 1)][q / kBK] = v[e];
      }
    }
  }
};

// A thread's operands of one depth step: x rows 4ty.., 64+4ty.. and y
// columns 4tx.., 64+4tx.., four 128-bit loads.
struct Frag {
  float4 a0, a1, b0, b1;

  __device__ __forceinline__ void load(const float (*xs)[kLd], const float (*ys)[kLd], int kk,
                                       int tx, int ty) {
    a0 = *(const float4*)&xs[kk][4 * ty];
    a1 = *(const float4*)&xs[kk][64 + 4 * ty];
    b0 = *(const float4*)&ys[kk][4 * tx];
    b1 = *(const float4*)&ys[kk][64 + 4 * tx];
  }
};

template <int M>
__device__ __forceinline__ void step(float (&acc)[8][8], const Frag& f, float p) {
  using Op = Metric<M>;
  const float a[8] = {f.a0.x, f.a0.y, f.a0.z, f.a0.w, f.a1.x, f.a1.y, f.a1.z, f.a1.w};
  const float b[8] = {f.b0.x, f.b0.y, f.b0.z, f.b0.w, f.b1.x, f.b1.y, f.b1.z, f.b1.w};
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float t = Op::combine(a[i], b[j], p);
      acc[i][j] = Op::kMax ? fmaxf(acc[i][j], t) : acc[i][j] + t;
    }
}

template <int M, bool kVec, bool kEpilog>
__global__ void __launch_bounds__(kThreads, 2)
pairwise_tile_kernel(const float* __restrict__ X, const float* __restrict__ Y,
                     int m, int n, int d, float p, float* __restrict__ out) {
  using Op = Metric<M>;
  __shared__ __align__(16) float xs[2][kBK][kLd];
  __shared__ __align__(16) float ys[2][kBK][kLd];
  const int tid = threadIdx.x;
  const int tx = tid & 15;  // output columns 4tx.. and 64+4tx..
  const int ty = tid >> 4;  // output rows 4ty.. and 64+4ty..
  const int m_tiles = (m + kBM - 1) / kBM;
  const int i0 = (blockIdx.x % m_tiles) * kBM;
  const int j0 = (blockIdx.x / m_tiles) * kBN;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  Slab<kVec> sx, sy;
  sx.load(X, m, d, i0, 0, tid);
  sy.load(Y, n, d, j0, 0, tid);
  sx.store(xs[0], tid);
  sy.store(ys[0], tid);
  __syncthreads();

  Frag f[2];
  f[0].load(xs[0], ys[0], 0, tx, ty);
  for (int k0 = 0, buf = 0; k0 < d; k0 += kBK, buf ^= 1) {
    const bool more = k0 + kBK < d;
    if (more) {  // the next slab's loads fly while this one is reduced
      sx.load(X, m, d, i0, k0 + kBK, tid);
      sy.load(Y, n, d, j0, k0 + kBK, tid);
    }
    // the operands of step kk + 1 load while step kk computes
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      if (kk + 1 < kBK) f[(kk + 1) & 1].load(xs[buf], ys[buf], kk + 1, tx, ty);
      step<M>(acc, f[kk & 1], p);
    }
    if (more) {
      sx.store(xs[buf ^ 1], tid);
      sy.store(ys[buf ^ 1], tid);
    }
    __syncthreads();
    if (more) f[0].load(xs[buf ^ 1], ys[buf ^ 1], 0, tx, ty);
  }

  const bool vec_out = (n & 3) == 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = i0 + (i < 4 ? 4 * ty + i : 64 + 4 * ty + i - 4);
    if (row >= m) continue;
    float* orow = out + (size_t)row * n;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int col = j0 + 64 * h + 4 * tx;
      float4 v = kEpilog ? make_float4(Op::epilog(acc[i][4 * h], p, d),
                                       Op::epilog(acc[i][4 * h + 1], p, d),
                                       Op::epilog(acc[i][4 * h + 2], p, d),
                                       Op::epilog(acc[i][4 * h + 3], p, d))
                         : make_float4(acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2],
                                       acc[i][4 * h + 3]);
      if (vec_out && col + 3 < n) {
        __stcs((float4*)(orow + col), v);
      } else {
        const float e[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int c = 0; c < 4; ++c)
          if (col + c < n) __stcs(orow + col + c, e[c]);
      }
    }
  }
}

template <int M, bool kEpilog>
void launch(const float* x, const float* y, int m, int n, int d, float p,
            float* out, cudaStream_t s) {
  // m tiles fastest, so the blocks of one y tile run together
  unsigned blocks = (unsigned)((m + kBM - 1) / kBM) * (unsigned)((n + kBN - 1) / kBN);
  bool vec = d % 4 == 0 && ((size_t)x & 15) == 0 && ((size_t)y & 15) == 0;
  if (vec)
    pairwise_tile_kernel<M, true, kEpilog><<<blocks, kThreads, 0, s>>>(x, y, m, n, d, p, out);
  else
    pairwise_tile_kernel<M, false, kEpilog><<<blocks, kThreads, 0, s>>>(x, y, m, n, d, p, out);
}

template <int M>
void launch_metric(const float* x, const float* y, int m, int n, int d, float p, bool epilog,
                   float* out, cudaStream_t s) {
  if (epilog)
    launch<M, true>(x, y, m, n, d, p, out, s);
  else
    launch<M, false>(x, y, m, n, d, p, out, s);
}

}  // namespace
}  // namespace raft_tpu_torch

// x (m, d), y (n, d) float32 row-major contiguous; out (m, n) float32.
// metric is a DistanceType id from the table above; p is the Minkowski
// exponent (read by LpUnexpanded only); epilog 0 stores the raw reduce
// (accumulate-only mode).  Returns cudaGetLastError().
extern "C" int pairwise_tile_launch(const void* x, const void* y, int m, int n,
                                    int d, int metric, float p, int epilog, void* out,
                                    void* stream) {
  using namespace raft_tpu_torch;
  if (m < 1 || n < 1 || d < 1) return (int)cudaErrorInvalidValue;
  auto a = (const float*)x;
  auto b = (const float*)y;
  auto o = (float*)out;
  cudaStream_t s = (cudaStream_t)stream;
  switch (metric) {
    case 3: launch_metric<3>(a, b, m, n, d, p, epilog != 0, o, s); break;
    case 4: launch_metric<4>(a, b, m, n, d, p, epilog != 0, o, s); break;
    case 5: launch_metric<5>(a, b, m, n, d, p, epilog != 0, o, s); break;
    case 7: launch_metric<7>(a, b, m, n, d, p, epilog != 0, o, s); break;
    case 8: launch_metric<8>(a, b, m, n, d, p, epilog != 0, o, s); break;
    case 9: launch_metric<9>(a, b, m, n, d, p, epilog != 0, o, s); break;
    case 15: launch_metric<15>(a, b, m, n, d, p, epilog != 0, o, s); break;
    case 16: launch_metric<16>(a, b, m, n, d, p, epilog != 0, o, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
