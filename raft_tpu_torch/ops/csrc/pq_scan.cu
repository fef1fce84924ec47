// K7: the IVF-PQ ADC scan, one query a block, its tables on chip.
//
// Replaces no Pallas kernel: the JAX package scans PQ codes in its XLA
// loop (raft_tpu/spatial/ann.py, the "gather" ADC), and the port ran the
// same loop as torch ops (ops/pq_scan.py:ivf_pq_scan_plain, which is the
// plain version of this kernel).  The function: for each query and each
// of its nprobe probed lists, the squared ADC distance of every stored
// row of the list's slots, the sum over the M subspaces of
// |q_m - c_m - w_{m,code_m}|^2 (c the list's centroid, w the codebooks),
// and the kk smallest (distance, id) pairs of the query, ascending, ties
// to the smaller id; vacant rows (id < 0) are skipped and unfilled results
// are (+inf, -1).
//
// What it takes (ops/pq_scan.py:fits): code rows of 16, 32 or 64 bytes (M
// <= 64), d <= 512 (a thread a dimension of the query), at most 256
// codewords, and the whole codebook (d x ksub floats) in shared memory
// beside the table, the sort area and each probe's slots, which at 256
// codewords holds d to 145 at most.  Wider rows and larger codebooks take
// the wide route (pq_scan_wide.cu: M <= 96, any d); what neither takes,
// the step scan.
//
// What bounds it on an H100: at the sift1m_ivfpq cell (10,000 queries,
// nprobe 50 of 1,024 lists, M 64 subspaces of 2 dimensions, 256 codewords,
// kk 200) a query scans about 55,000 rows, so a call makes up to 35 G table
// lookups (fewer: a warp stops early).  The FP32 operations (the tables,
// 2 d x 256 a (query, probe), and an add a lookup) take about 1 ms at the
// card's 67 TFLOP/s; the distinct codes read are 64 MB.  Neither is the
// limit.  Each lookup is a 4-byte shared-memory read at an address the code
// picks; the table's layout and each lane's walk (pq_layout.cuh) put a
// warp's 32 reads in 32 banks, one pass, where a layout indexed by the code
// takes about 3.4.  A lookup is also fewer instructions: a byte_perm, a
// three-input logic op, the read and an add, 4.73 a lookup in the scan's
// SASS against 5.34.  Measured (PERF.md, an H100 at 700 W): 24.0 ms a call
// against 28.1; the earlier kernel with its reads sent to 32 banks and two
// instructions a lookup more read 25.7, so the bank passes cost it at least
// 2.4 ms, and the rest of the gain is not split by measurement.  The next
// bound is the code rows' 16-byte loads through L1: a warp's load touches
// 16 lines (one chunk of each of its 32 rows), and the same kernel with
// each warp's loads made contiguous (wrong rows, the same bytes) reads
// 21.0 ms.
//
// Design: a persistent grid of one 512-thread block an SM takes queries
// from an atomic counter.  A block keeps in shared memory (215 KB at the
// cell's shape)
//
//   * the codebooks (d x ksub floats, loaded once a block, laid out
//     [dimension][codeword] so that the build reads them without bank
//     conflicts);
//   * the table of the current (query, probe), 256 codeword rows of 64
//     floats, a column a (subspace, copy) so that an entry's bank is set by
//     its subspace (table_column; columns past M stay 0, so that the zero
//     bytes that pad a code row to 16 bytes add nothing), built from the
//     residual q - c by direct differences, d x ksub fused multiply-adds
//     (an unrolled instance for 256 codewords of 2 and of 8 dimensions),
//     its stores and codebook reads in 32 banks;
//   * the query's running top-kk and a buffer of new candidates, 2,048
//     64-bit keys (distance bits << 32 | id: distances are >= 0, so the
//     keys sort as (distance, id));
//   * the query's probed lists, their slots and row counts.
//
// A probe costs two barriers: the table is built, then the list's rows
// are scanned in rounds of 512, one row a thread, with no barrier between
// rounds (while the next residual is written beside the table).  A row's
// codes (uint8: the wrapper narrows the index's int32 codes once a call)
// are read with 16-byte loads issued a round ahead, and M table reads are
// summed in registers in the lane's own order of subspaces (Lane), 8 at a
// time; since every table value is
// >= 0, a warp whose rows have all passed the query's kk-th distance stops
// summing them.  A row joins the buffer only if its key is below the kk-th
// key (the gate).  Before a segment of rows that the buffer might not
// hold, the block sorts top list and buffer together (bitonic in shared
// memory; the stages inside 64-key blocks synchronise only their warp)
// and keeps the first entries, which also tightens the gate.  So no table,
// code copy or candidate list reaches device memory, and a query's answer
// does not depend on which block or chunk took it.
//
// Measured at the cell's shape (PERF.md): of the warps' cycles (a copy of
// this file with clock64 sums) 48% in the scan, 17% in the table builds,
// 11% in the sorts, almost nothing at the build's barrier, and the rest
// between (a query's set-up, the segments' barriers, the answers).
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "pq_layout.cuh"
#include "pq_scan.cuh"

namespace raft_tpu_torch {
namespace {

using pq_layout::column_subspace;
using pq_layout::kColumns;
using pq_layout::kCopies;
using pq_layout::table_column;

constexpr int kCodewords = 256;  // the codewords a subspace has at most

// The walk of a lane over its row (pq_layout.cuh: the table's layout, and
// at step p the column table_column<NCH>(p, 0) ^ lane, 32 banks a warp).
// No register is indexed by the lane: a lane loads its row's chunks in its
// own order (address arithmetic), selects its pair of words and swaps the
// two words of the pair (four selects a group of 8 subspaces), and its
// selector of one byte_perm a lookup picks the byte.
template <int NCH>
struct Lane {
  unsigned sel[4];  // byte_perm selectors: byte i ^ lane of a word to bits 8-15, zero elsewhere
  unsigned off;     // lane * 4, the lane's part of a column's byte offset
  bool swap;        // lane bit 2: the two words of a pair swapped
  bool pair;        // the pairs of a chunk swapped (lane bit 4 at 32 bytes, 3 at 16)
  int chunk;        // the row's chunks loaded chunk ^ 0, chunk ^ 1, ...

  __device__ explicit Lane(int lane)
      : off(4u * lane),
        swap(pq_layout::lane_swap(lane)),
        pair(pq_layout::lane_pair<NCH>(lane)),
        chunk(pq_layout::lane_chunk<NCH>(lane)) {
#pragma unroll
    for (int i = 0; i < 4; ++i) sel[i] = 0x4404u | (unsigned)((i ^ lane) & 3) << 4;
  }
};

// The row's codes are loaded chunk ^ ch first: chunk slot ch holds the
// row's chunk ch ^ chunk (the lane's walk).
template <int NCH>
__device__ __forceinline__ Row<NCH> fetch(const Probe& p, int r, int cap,
                                          const uint8_t* __restrict__ codes,
                                          const int* __restrict__ ids, int chunk) {
  Row<NCH> row;
  row.id = -1;
#pragma unroll
  for (int ch = 0; ch < NCH; ++ch) row.c[ch] = make_uint4(0, 0, 0, 0);
  if (r < p.rows) {
    const int s = r / cap;
    const int slot = p.slots[s];
    if (slot >= 0) {
      const size_t at = (size_t)slot * cap + (r - s * cap);
      row.id = __ldg(ids + at);
      const uint4* src = reinterpret_cast<const uint4*>(codes + at * (NCH * 16));
#pragma unroll
      for (int ch = 0; ch < NCH; ++ch) row.c[ch] = __ldg(src + (ch ^ chunk));
    }
  }
  return row;
}

// The ADC sum of a row's codes over a table, in the lane's walk, 8 steps
// at a time; a warp stops once all its rows are past `thr` (the sum only
// grows).  A lookup is a byte_perm (the code times 256 bytes), one
// three-input logic op (the column's offset) and the shared-memory read.
template <int NCH>
__device__ __forceinline__ float adc_sum(const Row<NCH>& row, const char* tab, float thr,
                                         bool dead, const Lane<NCH>& ln) {
  float acc = 0.f;
#pragma unroll
  for (int h = 0; h < 2 * NCH; ++h) {
    const uint4& c = row.c[h / 2];
    const bool upper = (h % 2 == 1) != ln.pair;
    const unsigned lo = upper ? c.z : c.x, hi = upper ? c.w : c.y;
    const unsigned w[2] = {ln.swap ? hi : lo, ln.swap ? lo : hi};
    float s[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int b = 0; b < 2; ++b) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const unsigned col = 4u * table_column<NCH>(8 * h + 4 * b + i, 0);
        const unsigned at = __byte_perm(w[b], 0u, ln.sel[i]) | (ln.off ^ col);
        s[i] += *reinterpret_cast<const float*>(tab + at);
      }
    }
    acc += (s[0] + s[1]) + (s[2] + s[3]);
    if (h + 1 < 2 * NCH && __all_sync(kFull, dead || acc > thr)) break;
  }
  return acc;
}

struct Args {
  const float* q;           // (nq, d)
  const float* cent;        // (nlist, d)
  const float* books;       // (M, ksub, dsub)
  const uint8_t* codes;     // (S * cap, NCH * 16)
  const int* ids;           // (S * cap)
  const int* cent_slots;    // (nlist, max_slots)
  const int* probes;        // (nq, nprobe)
  int nq, d, M, ksub, lg_ksub, dsub, cap, max_slots, nlist, nprobe, kk;
  int* next_query;          // (1,), 0 at launch
  float* out_d;             // (nq, kk)
  int* out_i;               // (nq, kk)
};

// Shared memory, in floats or ints: codebooks d * ksub, table 256 * 64,
// sort area, query d, residual d, per probe its list's row count and
// max_slots slots (ops/pq_scan.py:smem_bytes holds the same sum).
__host__ __device__ inline size_t smem_bytes(int d, int ksub, int nprobe, int max_slots) {
  return sizeof(unsigned long long) * kArea +
         sizeof(float) * ((size_t)d * ksub + kCodewords * kColumns + 2 * (size_t)d) +
         sizeof(int) * (size_t)nprobe * (1 + max_slots);
}

// The table of one (query, probe): entry (m, j) is the sum over the
// subspace's dimensions of (r_i - w_{m,j,i})^2, in order, written to each
// copy.  Lane l of a warp takes the subspace and copy of column l, and at
// each step one codeword of a block of 32, l + t mod 32 (the lanes that
// share a subspace, one a copy, take the others of the block), so a warp's
// codebook reads fall in 32 banks (distinct codewords) and so do its
// stores (distinct columns).  DSUB > 0 is an instance for 256 codewords of
// DSUB dimensions, where a step also takes a sibling entry at a fixed
// offset, column l + 32 of a 64-byte row (subspace m + 8), else codeword
// j + 128, so that its addresses are immediates; 0 takes any shape.
// Against the generic build, DSUB 2 saved 11 ms a call at the sift1m_ivfpq
// cell's shape and DSUB 8 about 23% of the kernel's time at M 16, d 128
// (PERF.md), for the same bits.  A lane whose subspace is past M (M below
// the row's width) reads subspace 0's residual and codebook
// (pq_layout::build_reads) and stores nothing.
template <int DSUB>
__device__ __forceinline__ float entry(const float* r, const float* w) {
  float acc = 0.f;
#pragma unroll
  for (int i = 0; i < DSUB; ++i) {
    const float d = r[i] - w[i * kCodewords];
    acc = fmaf(d, d, acc);
  }
  return acc;
}

// A subspace's residual in registers, in float2s or float4s (its
// dimensions are 8- or 16-byte aligned).
template <int DSUB>
__device__ __forceinline__ void residual(const float* src, float* r) {
  static_assert(DSUB % 4 == 0 || DSUB == 2, "the residual is read in float4s or a float2");
  if constexpr (DSUB == 2) {
    const float2 v = *reinterpret_cast<const float2*>(src);
    r[0] = v.x;
    r[1] = v.y;
  } else {
#pragma unroll
    for (int i = 0; i < DSUB; i += 4) {
      const float4 v = *reinterpret_cast<const float4*>(src + i);
      r[i] = v.x;
      r[i + 1] = v.y;
      r[i + 2] = v.z;
      r[i + 3] = v.w;
    }
  }
}

template <int NCH, int DSUB>
__device__ __forceinline__ void build_table(const Args& a, const float* res, const float* books,
                                            float* tab) {
  constexpr int kCopy = kCopies<NCH>;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int m = column_subspace<NCH>(lane), c = NCH == 1 ? lane >> 4 : 0;
  float* cols[kCopy];
#pragma unroll
  for (int k = 0; k < kCopy; ++k) cols[k] = tab + table_column<NCH>(m, c ^ k);
  if constexpr (DSUB > 0) {
    // 16 warps: blocks of 32 codewords (8, or 4 and their siblings) x parts of the block
    constexpr int kBlocks = NCH == 4 ? 8 : 4, kParts = kThreads / 32 / kBlocks;
    constexpr int kSteps = 32 / kCopy / kParts;
    constexpr int kTabSib = NCH == 4 ? 32 : 128 * kColumns;
    const int mr = pq_layout::build_reads<NCH>(lane, false, a.M);
    const int msr = pq_layout::build_reads<NCH>(lane, true, a.M);  // the sibling's
    const bool take = m < a.M, take_sib = pq_layout::build_subspace<NCH>(lane, true) < a.M;
    float r[DSUB], rs[DSUB];
    residual<DSUB>(res + mr * DSUB, r);
    residual<DSUB>(res + msr * DSUB, rs);
    const float* w = books + mr * DSUB * kCodewords + (warp / kParts) * 32;
    const float* ws = NCH == 4 ? books + msr * DSUB * kCodewords + (warp / kParts) * 32 : w + 128;
    const int j0 = (warp / kParts) * 32 * kColumns;
    int u = lane + (warp % kParts) * kSteps;
#pragma unroll 4
    for (int t = 0; t < kSteps; ++t, ++u) {
      const int j = u & 31;
      const float e = entry<DSUB>(r, w + j), es = entry<DSUB>(rs, ws + j);
      const int at = j0 + j * kColumns;
#pragma unroll
      for (int k = 0; k < kCopy; ++k) {
        if (take) cols[k][at] = e;
        if (take_sib) cols[k][at + kTabSib] = es;
      }
    }
  } else {
    // any shape: one entry a step, 2 x ceil(ksub / 32) tasks (the two
    // halves of a 64-byte row's columns, else two parts of a block)
    constexpr int kHalves = NCH == 4 ? 2 : 1, kSteps = 32 / kCopy / (2 / kHalves);
    for (int task = warp; task < 2 * ((a.ksub + 31) >> 5); task += kThreads / 32) {
      const int half = kHalves == 2 ? task & 1 : 0, mm = m + 8 * half;
      if (mm >= a.M) continue;
      const float* r = res + mm * a.dsub;
      const float* w = books + (size_t)mm * a.dsub * a.ksub;
      const int t0 = kHalves == 2 ? 0 : (task & 1) * kSteps;
      for (int t = t0; t < t0 + kSteps; ++t) {
        const int j = ((task >> 1) << 5) + ((lane + t) & 31);
        if (j >= a.ksub) continue;
        float acc = 0.f;
        for (int i = 0; i < a.dsub; ++i) {
          const float d = r[i] - w[i * a.ksub + j];
          acc = fmaf(d, d, acc);
        }
#pragma unroll
        for (int k = 0; k < kCopy; ++k) cols[k][j * kColumns + 32 * half] = acc;
      }
    }
  }
}

template <int NCH, int KC, int DSUB>
__global__ void __launch_bounds__(kThreads, 1) pq_scan_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned long long* keys = reinterpret_cast<unsigned long long*>(smem);
  float* tab = reinterpret_cast<float*>(keys + kArea);
  float* books = tab + kCodewords * kColumns;
  float* qv = books + (size_t)a.d * a.ksub;
  float* res = qv + a.d;
  int* p_rows = reinterpret_cast<int*>(res + a.d);
  int* p_slots = p_rows + a.nprobe;
  __shared__ int s_query, s_count;
  __shared__ unsigned long long s_thr;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const Lane<NCH> ln(lane);
  // the codebooks, [dimension][codeword]; the table's pad rows 0
  for (int e = tid; e < a.d * a.ksub; e += kThreads) {
    const int i = e % a.dsub, mj = e / a.dsub;  // e = (m * ksub + j) * dsub + i
    const int m = mj >> a.lg_ksub, j = mj & (a.ksub - 1);
    books[(size_t)(m * a.dsub + i) * a.ksub + j] = __ldg(a.books + e);
  }
  for (int e = tid; e < kCodewords * kColumns; e += kThreads) tab[e] = 0.f;

  for (;;) {
    __syncthreads();  // the previous query's answer is written
    if (tid == 0) s_query = atomicAdd(a.next_query, 1);
    __syncthreads();
    const int qi = s_query;
    if (qi >= a.nq) return;
    for (int t = tid; t < a.d; t += kThreads) qv[t] = __ldg(a.q + (size_t)qi * a.d + t);
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
    auto centroid = [&](int p) {  // 0 past the last probe
      if (tid >= a.d || p >= a.nprobe) return 0.f;
      const int list = __ldg(a.probes + (size_t)qi * a.nprobe + p);
      return __ldg(a.cent + (size_t)list * a.d + tid);
    };

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
    Row<NCH> cur;
    float cn = centroid(p);  // the centroid of the next residual
    if (p < a.nprobe) {
      cur = fetch<NCH>(probe(p), tid, a.cap, a.codes, a.ids, ln.chunk);
      if (tid < a.d) res[tid] = qv[tid] - cn;
      cn = centroid(live_from(p + 1));
    }
    __syncthreads();
    while (p < a.nprobe) {
      const Probe pr = probe(p);
      const int pn = live_from(p + 1);
      build_table<NCH, DSUB>(a, res, books, tab);
      cnt = s_count;
      __syncthreads();  // the table is built; the residual is free
      if (tid < a.d && pn < a.nprobe) res[tid] = qv[tid] - cn;
      cn = centroid(pn < a.nprobe ? live_from(pn + 1) : a.nprobe);
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
          const Row<NCH> nxt =
              r0 + kThreads < pr.rows
                  ? fetch<NCH>(pr, r0 + kThreads + tid, a.cap, a.codes, a.ids, ln.chunk)
              : pn < a.nprobe ? fetch<NCH>(probe(pn), tid, a.cap, a.codes, a.ids, ln.chunk)
                              : fetch<NCH>(Probe{nullptr, 0}, 0, a.cap, a.codes, a.ids, 0);
          const bool dead = cur.id < 0;
          float dist = CUDART_INF_F;
          if (!__all_sync(kFull, dead)) {
            dist = adc_sum<NCH>(cur, reinterpret_cast<const char*>(tab), thr_d, dead, ln);
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
      __syncthreads();  // the probe is scanned: the table is free, the next residual set
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

template <int NCH, int KC, int DSUB>
cudaError_t launch(const Args& a, cudaStream_t s) {
  const size_t bytes = smem_bytes(a.d, a.ksub, a.nprobe, a.max_slots);
  auto kernel = pq_scan_kernel<NCH, KC, DSUB>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)bytes);
  if (err != cudaSuccess) return err;
  int dev, sms;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const int blocks = a.nq < sms ? a.nq : sms;
  kernel<<<blocks, kThreads, bytes, s>>>(a);
  return cudaGetLastError();
}

// The instance of a launch: code row width, top-list capacity (256 keys,
// or 512 past kk 256: a 64-key list at kk 10 saved 1% at most), and the
// table build (instances for 256 codewords of 2 and 8 dimensions, the
// shapes of the benchmark and of M 16 at d 128).
template <int NCH, int KC>
cudaError_t launch_build(const Args& a, cudaStream_t s) {
  if (a.ksub == 256 && a.dsub == 2) return launch<NCH, KC, 2>(a, s);
  if (a.ksub == 256 && a.dsub == 8) return launch<NCH, KC, 8>(a, s);
  return launch<NCH, KC, 0>(a, s);
}

template <int NCH>
cudaError_t launch_kc(const Args& a, cudaStream_t s) {
  if (a.kk <= 256) return launch_build<NCH, 256>(a, s);
  return launch_build<NCH, 512>(a, s);
}

}  // namespace
}  // namespace raft_tpu_torch

// Q (nq, d), centroids (nlist, d) and books (M, ksub, dsub) float32,
// contiguous, d = M * dsub; codes (S * cap, code_bytes) uint8, code_bytes
// 16, 32 or 64 (M <= code_bytes, the bytes past M zero); ids (S * cap,)
// int32, -1 vacant; cent_slots (nlist, max_slots) int32, -1 padded; probes
// (nq, nprobe) int32; next_query (1,) int32, 0.  ksub a power of two <=
// 256, kk <= 512.  Writes out_d / out_i (nq, kk): each query's kk best,
// ascending.  Returns cudaGetLastError() (cudaErrorInvalidValue for a
// shape it does not take).
extern "C" int pq_scan_launch(const void* Q, const void* centroids, const void* books,
                              const void* codes, const void* ids, const void* cent_slots,
                              const void* probes, int nq, int d, int M, int ksub, int dsub,
                              int cap, int max_slots, int nlist, int nprobe, int kk,
                              int code_bytes, void* next_query, void* out_d, void* out_i,
                              void* stream) {
  using namespace raft_tpu_torch;
  int lg = 0;
  while ((1 << lg) < ksub) ++lg;
  if (nq < 1 || d < 1 || d > kThreads || M < 1 || M > 64 || dsub < 1 || M * dsub != d || ksub < 1 ||
      (1 << lg) != ksub || ksub > kCodewords || cap < 1 || max_slots < 1 || nprobe < 1 ||
      kk < 1 || kk > 512 || M > code_bytes) {
    return (int)cudaErrorInvalidValue;
  }
  const Args a{(const float*)Q, (const float*)centroids, (const float*)books,
               (const uint8_t*)codes, (const int*)ids, (const int*)cent_slots,
               (const int*)probes, nq, d, M, ksub, lg, dsub, cap, max_slots, nlist, nprobe, kk,
               (int*)next_query, (float*)out_d, (int*)out_i};
  cudaStream_t s = (cudaStream_t)stream;
  switch (code_bytes) {
    case 16: return (int)launch_kc<1>(a, s);
    case 32: return (int)launch_kc<2>(a, s);
    case 64: return (int)launch_kc<4>(a, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
