// K7's wide-row route: the IVF-PQ ADC scan where the codebook does not fit
// in shared memory beside K7's table (pq_scan.cu): code rows of 32, 64 or
// 96 bytes (M <= 96), any depth, up to 256 codewords.
//
// The function is K7's (pq_scan.cu, ops/pq_scan.py:ivf_pq_scan_plain):
// for each query and each of its nprobe probed lists, the squared ADC
// distance of every stored row of the list's slots, the sum over the M
// subspaces of |q_m - c_m - w_{m,code_m}|^2 (c the list's centroid, w the
// codebooks), and the kk smallest (distance, id) pairs of the query,
// ascending, ties to the smaller id; vacant rows (id < 0) are skipped and
// unfilled results are (+inf, -1).
//
// What it is built for: ann-benchmarks' gist-960-euclidean as FAISS GPU
// indexes it, IVF1024,PQ96x8 (d 960, M 96 subspaces of 10 dimensions, 256
// codewords, nprobe 50, kk 200).  There the codebook is 256 x 960 x 4 B =
// 983 KB against the 227 KB a block may hold, so building each (query,
// probe) table by direct differences would read it from L2 50,000 times a
// 1,000-query call (49 GB).  Instead each entry is split in the expanded
// form, each part built where it is shared:
//
//   |r_m - w|^2 = |q_m - c_m|^2 + (|w|^2 + 2 c_m.w) - 2 q_m.w,
//
//   * a list's terms |w|^2 + 2 c_m.w, once an index for every list
//     (terms_kernel, launched on its own by pq_scan_wide_terms_launch:
//     nlist x ksub x 32 NG floats in device memory, 100 MB at GIST's
//     shape, written in the table's layout; the search keeps them beside
//     the index, spatial/ann.py);
//   * a query's terms -2 q_m.w, once a query into shared memory, from a
//     copy of the codebooks laid out [subspace][dimension][codeword], so
//     that a warp's reads are 128 contiguous bytes;
//   * |q_m - c_m|^2, once a (query, probe), M sums of dsub squares.
//
// A (query, probe) table is then one coalesced read of the list's terms
// (96 KB), one shared-memory read of the query's, and an add: about 6.1 MB
// read from device memory a query at GIST's shape where direct differences
// read 49 MB.  An entry is clamped at 0, so that sums only grow, as K7's
// do; its float32 rounding is the expanded form's, the plain version's
// (ops/pq_scan.py:ivf_pq_scan_plain), not K7's direct differences.
//
// Shared memory (213 KB at GIST's shape): the sort area (pq_scan.cuh), the
// table and the query's terms (ksub rows of 32 NG floats each), the
// residual norms, and the query's probed lists, their slots and row
// counts.  The scan is K7's: one row a thread in rounds of 512, codes read
// as uint8 with 16-byte loads a round ahead (from chunk-major rows here:
// ops/pq_scan.py:narrow_codes with wide), a warp's early stop, the gate by
// the kk-th key and the bitonic merges between segments of a list.  The
// table's layout and each lane's walk (pq_layout.cuh, wide_*) put a warp's
// 32 lookups in 32 banks: each 32-byte group of a row is laid out and
// walked as K7's 32-byte rows are, a table row being 32 NG floats, so a
// lookup is a byte_perm, an integer multiply-add (the code times the row's
// bytes, plus the column's offset) and the read.
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "pq_layout.cuh"
#include "pq_scan.cuh"

namespace raft_tpu_torch {
namespace {

using pq_layout::wide_subspace;
using pq_layout::wide_walk_column;

struct Args {
  const float* q;          // (nq, d)
  const float* cent;       // (nlist, d)
  const float* books_t;    // (M, dsub, ksub): the codebooks, a codeword's dimensions apart
  const float* terms;      // (nlist, ksub, 32 NG): terms_kernel's, made once an index
  const uint8_t* codes;    // (2 NG, S * cap, 16): a row's 16-byte chunks a plane apart
  const int* ids;          // (S * cap)
  const int* cent_slots;   // (nlist, max_slots)
  const int* probes;       // (nq, nprobe)
  int nq, d, M, ksub, dsub, cap, rows, max_slots, nlist, nprobe, kk;  // rows = S * cap
  int* next_query;         // (1,), 0 at launch
  float* out_d;            // (nq, kk)
  int* out_i;              // (nq, kk)
};

// Shared memory, in floats or ints: sort area, table and query terms
// ksub * 32 NG each, residual norms 32 NG, per probe its list's row count
// and max_slots slots (ops/pq_scan.py:smem_bytes_wide holds the same sum).
__host__ __device__ inline size_t smem_bytes(int ng, int ksub, int nprobe, int max_slots) {
  const size_t w = 32 * (size_t)ng;
  return sizeof(unsigned long long) * kArea + sizeof(float) * (2 * (size_t)ksub * w + w) +
         sizeof(int) * (size_t)nprobe * (1 + max_slots);
}

// A list's terms, |w|^2 + 2 c_m.w at entry (list, j, wide_column(m)), 0
// past M: a block a (list, block of 32 codewords), a warp's lanes over
// the codewords (coalesced reads of books_t), staged in shared memory with
// rows of 32 NG + 1 floats (the stores of a warp in 32 banks), then
// written out whole rows at a time.
template <int NG>
__global__ void __launch_bounds__(256) terms_kernel(Args a, float* terms) {
  constexpr int kW = 32 * NG;
  __shared__ float tile[32 * (kW + 1)];
  const int blocks = (a.ksub + 31) >> 5;
  const int list = blockIdx.x / blocks, jb = (blockIdx.x % blocks) << 5;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int j = jb + lane;
  const float* c = a.cent + (size_t)list * a.d;
  for (int col = warp; col < kW; col += blockDim.x >> 5) {
    const int m = wide_subspace(col);
    float ww = 0.f, cw = 0.f;
    if (m < a.M && j < a.ksub) {
      const float* w = a.books_t + (size_t)m * a.dsub * a.ksub + j;
      for (int i = 0; i < a.dsub; ++i) {
        const float wi = __ldg(w + (size_t)i * a.ksub);
        ww = fmaf(wi, wi, ww);
        cw = fmaf(__ldg(c + m * a.dsub + i), wi, cw);
      }
    }
    tile[lane * (kW + 1) + col] = fmaf(2.f, cw, ww);
  }
  __syncthreads();
  float* out = terms + ((size_t)list * a.ksub + jb) * kW;
  const int rows = min(32, a.ksub - jb);
  for (int e = threadIdx.x; e < rows * kW; e += blockDim.x) {
    out[e] = tile[(e / kW) * (kW + 1) + e % kW];
  }
}

// The query's terms into qt: -2 q_m.w at (j, wide_column(m)), 0 past M,
// stored at float j * 32 NG + (column ^ 4 (j mod 8)), a swizzle of whole
// float4s inside a 32-float group, so that a warp's stores (its lanes over
// 32 codewords of one subspace) fall in 8 banks and the build still reads
// a row's float4s whole.
template <int NG>
__device__ void query_terms(const Args& a, const float* q, float* qt) {
  constexpr int kW = 32 * NG;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int blocks = (a.ksub + 31) >> 5;
  for (int task = warp; task < kW * blocks; task += kThreads / 32) {
    const int col = task % kW, j = ((task / kW) << 5) + lane;
    const int m = wide_subspace(col);
    if (j >= a.ksub) continue;
    float acc = 0.f;
    if (m < a.M) {
      const float* w = a.books_t + (size_t)m * a.dsub * a.ksub + j;
      const float* qm = q + m * a.dsub;
      for (int i = 0; i < a.dsub; ++i) {
        acc = fmaf(__ldg(qm + i), __ldg(w + (size_t)i * a.ksub), acc);
      }
    }
    qt[j * kW + (col ^ (j & 7) << 2)] = -2.f * acc;
  }
}

// |q_m - c_m|^2 of the probe's list at column wide_column(m), 0 past M;
// threads below 32 NG, one column each.
template <int NG>
__device__ __forceinline__ void residual_norms(const Args& a, const float* q, int list,
                                               float* r2) {
  const int col = threadIdx.x;
  if (col >= 32 * NG) return;
  const int m = wide_subspace(col);
  float acc = 0.f;
  if (m < a.M) {
    const float* qm = q + m * a.dsub;
    const float* c = a.cent + (size_t)list * a.d + m * a.dsub;
    for (int i = 0; i < a.dsub; ++i) {
      const float d = __ldg(qm + i) - __ldg(c + i);
      acc = fmaf(d, d, acc);
    }
  }
  r2[col] = acc;
}

// The (query, probe) table: entry e of the list's terms, plus the query's
// (swizzled) and the residual norm of its column, clamped at 0, a float4
// a thread at a time.
template <int NG>
__device__ __forceinline__ void build_table(const Args& a, int list, const float* qt,
                                            const float* r2, float* tab) {
  constexpr int kW4 = 8 * NG;
  const float4* t = reinterpret_cast<const float4*>(a.terms) + (size_t)list * a.ksub * kW4;
  const float4* q4 = reinterpret_cast<const float4*>(qt);
  const float4* r4 = reinterpret_cast<const float4*>(r2);
  float4* out = reinterpret_cast<float4*>(tab);
  const int n = a.ksub * kW4;
#pragma unroll 4
  for (int e = threadIdx.x; e < n; e += kThreads) {
    const int j = e / kW4, c4 = e - j * kW4;
    const float4 tv = __ldg(t + e), qv = q4[j * kW4 + (c4 ^ (j & 7))], rv = r4[c4];
    out[e] = make_float4(fmaxf(0.f, (rv.x + tv.x) + qv.x), fmaxf(0.f, (rv.y + tv.y) + qv.y),
                         fmaxf(0.f, (rv.z + tv.z) + qv.z), fmaxf(0.f, (rv.w + tv.w) + qv.w));
  }
}

// A thread's row: its id and its 2 NG chunks, chunk slot ch holding the
// row's chunk ch ^ chunk (the lane's walk), each from its own plane of the
// chunk-major codes, so that a warp's load of one chunk of 32 neighbouring
// rows reads 512 contiguous bytes (row-major 96-byte rows touched 24 lines
// a load; chunk-major took the kernel from 5.59 to 5.07 ms at GIST's
// shape, PERF.md).
template <int NCH>
__device__ __forceinline__ Row<NCH> fetch(const Args& a, const Probe& p, int r, int chunk) {
  Row<NCH> row;
  row.id = -1;
#pragma unroll
  for (int ch = 0; ch < NCH; ++ch) row.c[ch] = make_uint4(0, 0, 0, 0);
  if (r < p.rows) {
    const int s = r / a.cap;
    const int slot = p.slots[s];
    if (slot >= 0) {
      const size_t at = (size_t)slot * a.cap + (r - s * a.cap);
      row.id = __ldg(a.ids + at);
      const uint4* src = reinterpret_cast<const uint4*>(a.codes) + at;
#pragma unroll
      for (int ch = 0; ch < NCH; ++ch) row.c[ch] = __ldg(src + (size_t)(ch ^ chunk) * a.rows);
    }
  }
  return row;
}

// A lane's walk (pq_layout.cuh: K7's walk of a 32-byte row in each group):
// its row's two chunks of a group loaded in its own order, its pair of
// words and their order chosen by selects, and the byte by a byte_perm
// selector that puts it in bits 0-7.
struct Lane {
  unsigned sel[4];  // byte_perm selectors: byte i ^ lane of a word to bits 0-7, zero elsewhere
  unsigned off;     // lane * 4, the lane's part of a column's byte offset
  bool swap;        // lane bit 2: the two words of a pair swapped
  bool pair;        // lane bit 4: the pairs of a chunk swapped
  int chunk;        // lane bit 3: a group's chunks loaded chunk ^ 0, chunk ^ 1

  __device__ explicit Lane(int lane)
      : off(4u * lane),
        swap(pq_layout::lane_swap(lane)),
        pair(pq_layout::lane_pair<2>(lane)),
        chunk(pq_layout::lane_chunk<2>(lane)) {
#pragma unroll
    for (int i = 0; i < 4; ++i) sel[i] = 0x4440u | (unsigned)((i ^ lane) & 3);
  }
};

// The ADC sum of a row's codes in the lane's walk; a warp stops, at the
// end of a 16-byte chunk, once all its rows are past `thr` (the sum only
// grows; a vote every 8 lookups cost 1.5% more).  The lane's offset is
// read anew each 8 lookups through an empty asm, so that the compiler does
// not hoist its XOR with the 32 columns out of the row loop into 32
// registers: hoisted, they spilled 232 bytes of the rows and the kernel
// took 7.31 ms against 5.23 (PERF.md).
template <int NG>
__device__ __forceinline__ float adc_sum(const Row<2 * NG>& row, const char* tab, float thr,
                                         bool dead, const Lane& ln) {
  constexpr unsigned kRowBytes = 128u * NG;
  float acc = 0.f;
#pragma unroll
  for (int hh = 0; hh < 4 * NG; ++hh) {
    const int g = hh >> 2, h = hh & 3;
    unsigned off = ln.off;
    asm volatile("" : "+r"(off));
    const uint4& c = row.c[2 * g + (h >> 1)];
    const bool upper = (h & 1) != ln.pair;
    const unsigned lo = upper ? c.z : c.x, hi = upper ? c.w : c.y;
    const unsigned w[2] = {ln.swap ? hi : lo, ln.swap ? lo : hi};
    float s[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int b = 0; b < 2; ++b) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const unsigned col = 4u * wide_walk_column(32 * g + 8 * h + 4 * b + i, 0);
        const unsigned code = __byte_perm(w[b], 0u, ln.sel[i]);
        s[i] += *reinterpret_cast<const float*>(tab + code * kRowBytes + (off ^ col));
      }
    }
    acc += (s[0] + s[1]) + (s[2] + s[3]);
    if (hh % 2 == 1 && hh + 1 < 4 * NG && __all_sync(kFull, dead || acc > thr)) break;
  }
  return acc;
}

template <int NG, int KC>
__global__ void __launch_bounds__(kThreads, 1) pq_scan_wide_kernel(Args a) {
  constexpr int kW = 32 * NG, kNch = 2 * NG;
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned long long* keys = reinterpret_cast<unsigned long long*>(smem);
  float* tab = reinterpret_cast<float*>(keys + kArea);
  float* qt = tab + a.ksub * kW;
  float* r2 = qt + a.ksub * kW;
  int* p_rows = reinterpret_cast<int*>(r2 + kW);
  int* p_slots = p_rows + a.nprobe;
  __shared__ int s_query, s_count;
  __shared__ unsigned long long s_thr;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const Lane ln(lane);

  for (;;) {
    __syncthreads();  // the previous query's answer is written
    if (tid == 0) s_query = atomicAdd(a.next_query, 1);
    __syncthreads();
    const int qi = s_query;
    if (qi >= a.nq) return;
    const float* q = a.q + (size_t)qi * a.d;
    for (int e = tid; e < KC; e += kThreads) keys[e] = kFiller;
    for (int p = tid; p < a.nprobe; p += kThreads) {
      const int list = __ldg(a.probes + (size_t)qi * a.nprobe + p);
      int n_sl = 0;
      for (int s = 0; s < a.max_slots; ++s) {
        const int slot = list >= 0 && list < a.nlist
                             ? __ldg(a.cent_slots + (size_t)list * a.max_slots + s) : -1;
        p_slots[p * a.max_slots + s] = slot;
        if (slot >= 0) n_sl = s + 1;
      }
      p_rows[p] = n_sl * a.cap;
    }
    query_terms<NG>(a, q, qt);
    if (tid == 0) {
      s_count = 0;
      s_thr = kFiller;
    }
    __syncthreads();

    auto live_from = [&](int p) {
      while (p < a.nprobe && p_rows[p] == 0) ++p;
      return p;
    };
    auto probe = [&](int p) { return Probe{p_slots + p * a.max_slots, p_rows[p]}; };
    auto list_of = [&](int p) { return __ldg(a.probes + (size_t)qi * a.nprobe + p); };

    // candidates in the buffer, the same in every thread: read from
    // s_count only between two barriers with no append between them
    int cnt = 0;
    auto merge = [&]() {
      int n = KC;
      while (n < KC + cnt) n <<= 1;
      for (int e = KC + cnt + tid; e < n; e += kThreads) keys[e] = kFiller;
      __syncthreads();
      sort_keys(keys, n);
      if (tid == 0) {
        s_count = 0;
        s_thr = keys[a.kk - 1];
      }
      __syncthreads();
      cnt = 0;
    };

    int p = live_from(0);
    Row<kNch> cur;
    if (p < a.nprobe) {
      cur = fetch<kNch>(a, probe(p), tid, ln.chunk);
      residual_norms<NG>(a, q, list_of(p), r2);
    }
    __syncthreads();
    while (p < a.nprobe) {
      const Probe pr = probe(p);
      const int pn = live_from(p + 1);
      build_table<NG>(a, list_of(p), qt, r2, tab);
      cnt = s_count;
      __syncthreads();  // the table is built; the residual norms are free
      if (pn < a.nprobe) residual_norms<NG>(a, q, list_of(pn), r2);
      for (int s0 = 0; s0 < pr.rows; s0 += Sel<KC>::kSegment) {
        const int seg = min(Sel<KC>::kSegment, pr.rows - s0);
        if (s0 > 0) {  // a list longer than a segment: count the last one
          __syncthreads();
          cnt = s_count;
          __syncthreads();
        }
        if (cnt + seg > Sel<KC>::kRoom) merge();
        const unsigned long long thr = s_thr;
        const float thr_d =
            thr == kFiller ? CUDART_INF_F : __uint_as_float((unsigned)(thr >> 32));
        // rounds of one row a thread, with no barrier between them; the
        // next round's row is read while this one sums
        for (int r0 = s0; r0 < s0 + seg; r0 += kThreads) {
          const Row<kNch> nxt =
              r0 + kThreads < pr.rows ? fetch<kNch>(a, pr, r0 + kThreads + tid, ln.chunk)
              : pn < a.nprobe         ? fetch<kNch>(a, probe(pn), tid, ln.chunk)
                                      : fetch<kNch>(a, Probe{nullptr, 0}, 0, 0);
          const bool dead = cur.id < 0;
          float dist = CUDART_INF_F;
          if (!__all_sync(kFull, dead)) {
            dist = adc_sum<NG>(cur, reinterpret_cast<const char*>(tab), thr_d, dead, ln);
          }
          const unsigned long long key = make_key(dist, cur.id);
          const bool pass = !dead && dist < CUDART_INF_F && key < thr;
          const unsigned ballot = __ballot_sync(kFull, pass);
          if (ballot) {
            int base = 0;
            if (lane == 0) base = atomicAdd(&s_count, __popc(ballot));
            base = __shfl_sync(kFull, base, 0);
            if (pass) keys[KC + base + __popc(ballot & ((1u << lane) - 1))] = key;
          }
          cur = nxt;
        }
      }
      __syncthreads();  // the probe is scanned: the table is free, the next norms set
      p = pn;
    }
    cnt = s_count;
    __syncthreads();
    if (cnt > 0) merge();
    for (int e = tid; e < a.kk; e += kThreads) {
      const unsigned long long key = keys[e];
      const bool filled = key != kFiller;
      a.out_d[(size_t)qi * a.kk + e] =
          filled ? __uint_as_float((unsigned)(key >> 32)) : CUDART_INF_F;
      a.out_i[(size_t)qi * a.kk + e] = filled ? (int)(unsigned)key : -1;
    }
  }
}

// The scan.  Top-list capacity 256 keys, or 512 past kk 256, as K7's.
template <int NG, int KC>
cudaError_t launch(const Args& a, cudaStream_t s) {
  const size_t bytes = smem_bytes(NG, a.ksub, a.nprobe, a.max_slots);
  auto kernel = pq_scan_wide_kernel<NG, KC>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  int dev, sms;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  kernel<<<a.nq < sms ? a.nq : sms, kThreads, bytes, s>>>(a);
  return cudaGetLastError();
}

template <int NG>
cudaError_t launch_kc(const Args& a, cudaStream_t s) {
  if (a.kk <= 256) return launch<NG, 256>(a, s);
  return launch<NG, 512>(a, s);
}

template <int NG>
cudaError_t launch_terms(const Args& a, float* terms, cudaStream_t s) {
  terms_kernel<NG><<<a.nlist * ((a.ksub + 31) >> 5), 256, 0, s>>>(a, terms);
  return cudaGetLastError();
}

}  // namespace
}  // namespace raft_tpu_torch

// centroids (nlist, d) and books_t (M, dsub, ksub: the codebooks (M, ksub,
// dsub) transposed) float32, contiguous, d = M * dsub, ksub <= 256,
// code_bytes 32, 64 or 96 (M <= code_bytes).  Writes terms (nlist, ksub,
// code_bytes) float32: a list's terms in the scan's table layout, which
// depend on the index alone.  Returns cudaGetLastError()
// (cudaErrorInvalidValue for a shape it does not take).
extern "C" int pq_scan_wide_terms_launch(const void* centroids, const void* books_t, int nlist,
                                         int d, int M, int ksub, int dsub, int code_bytes,
                                         void* terms, void* stream) {
  using namespace raft_tpu_torch;
  if (nlist < 1 || d < 1 || M < 1 || dsub < 1 || M * dsub != d || ksub < 1 || ksub > 256 ||
      M > code_bytes) {
    return (int)cudaErrorInvalidValue;
  }
  Args a{};
  a.cent = (const float*)centroids;
  a.books_t = (const float*)books_t;
  a.d = d;
  a.M = M;
  a.ksub = ksub;
  a.dsub = dsub;
  a.nlist = nlist;
  cudaStream_t s = (cudaStream_t)stream;
  float* t = (float*)terms;
  switch (code_bytes) {
    case 32: return (int)launch_terms<1>(a, t, s);
    case 64: return (int)launch_terms<2>(a, t, s);
    case 96: return (int)launch_terms<3>(a, t, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Q (nq, d), centroids (nlist, d) and books_t (M, dsub, ksub) float32,
// contiguous, d = M * dsub; terms (nlist, ksub, code_bytes) float32,
// pq_scan_wide_terms_launch's of the same centroids and codebooks; codes
// (code_bytes / 16, S * cap, 16) uint8, chunk-major, code_bytes 32, 64 or
// 96 (M <= code_bytes, the bytes past M zero), rows = S * cap; ids (S *
// cap,) int32, -1 vacant; cent_slots (nlist, max_slots) int32, -1 padded;
// probes (nq, nprobe) int32; next_query (1,) int32, 0.  ksub <= 256, kk <=
// 512.  Writes out_d / out_i (nq, kk): each query's kk best, ascending.
// Returns cudaGetLastError() (cudaErrorInvalidValue for a shape it does
// not take).
extern "C" int pq_scan_wide_launch(const void* Q, const void* centroids, const void* books_t,
                                   const void* terms, const void* codes, const void* ids,
                                   const void* cent_slots, const void* probes, int nq, int d,
                                   int M, int ksub, int dsub, int cap, int rows, int max_slots,
                                   int nlist, int nprobe, int kk, int code_bytes,
                                   void* next_query, void* out_d, void* out_i, void* stream) {
  using namespace raft_tpu_torch;
  if (nq < 1 || d < 1 || M < 1 || dsub < 1 || M * dsub != d || ksub < 1 || ksub > 256 ||
      cap < 1 || rows < cap || max_slots < 1 || nlist < 1 || nprobe < 1 || kk < 1 ||
      kk > 512 ||
      M > code_bytes) {
    return (int)cudaErrorInvalidValue;
  }
  const Args a{(const float*)Q, (const float*)centroids, (const float*)books_t,
               (const float*)terms, (const uint8_t*)codes, (const int*)ids,
               (const int*)cent_slots, (const int*)probes, nq, d, M, ksub, dsub, cap, rows,
               max_slots, nlist, nprobe, kk, (int*)next_query, (float*)out_d, (int*)out_i};
  cudaStream_t s = (cudaStream_t)stream;
  switch (code_bytes) {
    case 32: return (int)launch_kc<1>(a, s);
    case 64: return (int)launch_kc<2>(a, s);
    case 96: return (int)launch_kc<3>(a, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
