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
// What bounds it on an H100: there is no tensor-core form of these
// reductions, so it is m*n*d combine+reduce steps in FP32 (at least two
// operations each, 1.3e10 steps for 1024 x 100,000 x 128), against reading
// (m + n)*d*4 bytes and writing m*n*4.  For L1 at that size the operations
// take 0.39 ms at 67 TFLOP/s and the 410 MB output 0.12 ms: bound by
// operations.  The design is the classic register-tiled product: a block
// of 256 threads owns a 64 x 64 output tile, the depth is staged through
// shared memory 32 at a time, and each thread keeps a 4 x 4 accumulator
// tile, so each shared-memory load feeds two combine steps.  The TPU grid's
// sequential depth axis is the loop inside the block.
#include <cuda_runtime.h>

namespace raft_tpu_torch {
namespace {

constexpr int kBM = 64;
constexpr int kBN = 64;
constexpr int kDK = 32;
constexpr int kThreads = 256;

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

template <int M>
__global__ void __launch_bounds__(kThreads)
pairwise_tile_kernel(const float* __restrict__ X, const float* __restrict__ Y,
                     int m, int n, int d, float p, float* __restrict__ out) {
  using Op = Metric<M>;
  __shared__ float xs[kDK][kBM + 1];
  __shared__ float ys[kDK][kBN + 1];
  const int tid = threadIdx.x;
  const int tx = tid & 15;  // output columns tx + 16*j
  const int ty = tid >> 4;  // output rows ty + 16*i
  const int i0 = blockIdx.y * kBM;
  const int j0 = blockIdx.x * kBN;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < d; k0 += kDK) {
#pragma unroll
    for (int e = tid; e < kBM * kDK; e += kThreads) {
      int r = e / kDK, c = e % kDK;
      int row = i0 + r, col = k0 + c;
      xs[c][r] = (row < m && col < d) ? X[(size_t)row * d + col] : 0.f;
    }
#pragma unroll
    for (int e = tid; e < kBN * kDK; e += kThreads) {
      int r = e / kDK, c = e % kDK;
      int row = j0 + r, col = k0 + c;
      ys[c][r] = (row < n && col < d) ? Y[(size_t)row * d + col] : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < kDK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = xs[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = ys[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float t = Op::combine(a[i], b[j], p);
          acc[i][j] = Op::kMax ? fmaxf(acc[i][j], t) : acc[i][j] + t;
        }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    int row = i0 + ty + 16 * i;
    if (row >= m) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      int col = j0 + tx + 16 * j;
      if (col < n) out[(size_t)row * n + col] = Op::epilog(acc[i][j], p, d);
    }
  }
}

template <int M>
void launch(const float* x, const float* y, int m, int n, int d, float p,
            float* out, cudaStream_t s) {
  dim3 grid((n + kBN - 1) / kBN, (m + kBM - 1) / kBM);
  pairwise_tile_kernel<M><<<grid, kThreads, 0, s>>>(x, y, m, n, d, p, out);
}

}  // namespace
}  // namespace raft_tpu_torch

// x (m, d), y (n, d) float32 row-major contiguous; out (m, n) float32.
// metric is a DistanceType id from the table above; p is the Minkowski
// exponent (read by LpUnexpanded only).  Returns cudaGetLastError().
extern "C" int pairwise_tile_launch(const void* x, const void* y, int m, int n,
                                    int d, int metric, float p, void* out,
                                    void* stream) {
  using namespace raft_tpu_torch;
  if (m < 1 || n < 1 || d < 1) return (int)cudaErrorInvalidValue;
  auto a = (const float*)x;
  auto b = (const float*)y;
  auto o = (float*)out;
  cudaStream_t s = (cudaStream_t)stream;
  switch (metric) {
    case 3: launch<3>(a, b, m, n, d, p, o, s); break;
    case 4: launch<4>(a, b, m, n, d, p, o, s); break;
    case 5: launch<5>(a, b, m, n, d, p, o, s); break;
    case 7: launch<7>(a, b, m, n, d, p, o, s); break;
    case 8: launch<8>(a, b, m, n, d, p, o, s); break;
    case 9: launch<9>(a, b, m, n, d, p, o, s); break;
    case 15: launch<15>(a, b, m, n, d, p, o, s); break;
    case 16: launch<16>(a, b, m, n, d, p, o, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
