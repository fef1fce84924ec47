// K2: per-row k-selection of the smallest keys.
//
// Replaces raft_tpu/ops/select_tile.py:133 select_tile (body _select_kernel
// :45, which reuses topk_update).  Per row of an (m, w) float32 key
// matrix, the k smallest keys ascending and their int32 column ids,
// k <= 128: the first k of a stable ascending sort of the row in which
// -0.0 equals +0.0 and NaN is greater than every key.  +inf keys are keys
// like any other, with their own ids; a NaN is never returned: where a row
// has fewer than k keys that are not NaN, the remaining slots are
// (+inf, w - 1).
//
// What bounds it on an H100: each key is read once, so at 1024 x 100,000
// the 410 MB of keys take 0.12 ms at 3.35 TB/s and the kernel is bound by
// bytes; at the merges of the paths (1024 x 800, a few rows of 13,200) the
// bytes take a microsecond and what counts is how fast a row's selection
// ends and how many SMs take part.
//
// The selection is a radix select, as in RAFT's radix select_k and AIR
// top-k.  Each key becomes an order-preserving unsigned image (-0.0 and
// +0.0 one image, NaN above +inf), and each item the 64-bit composite
// (image << 32 | column): composites are distinct, and the k smallest
// composites are exactly the stable sort's first k.  A block finds the k
// smallest composites of a set one 8-bit digit at a time, from the top: a
// histogram of the digit over the items still in play (shared-memory
// atomics, one a warp where its digits agree), a block scan, the bucket
// that holds the k-th; the items below it are winners, the items in it
// stay in play.  It stops as soon as the bucket's items are all needed, at
// the latest when the column's digits make the composite unique, so there
// are no ties to break.  Once the items in play fit the candidate area
// they are compacted, and later digits sweep only them.  The k winners are
// ordered by rank (each counts the winners below it).
//
// Two routes, by width:
// - w <= kCap (the merges of K1's splits, of partitions, the probe): one
//   block a row holds the row in shared memory.  Up to kFilterMin items
//   it takes the first histogram while it loads; a longer row is first
//   cut down to the items at or below a bound from a sample of it (the
//   last of every 8 items, so that ascending runs, which the merges of
//   the paths select from, do not pull the bound below their k-th
//   smallest), found as the wide route finds its bound.
// - w > kCap: three kernels, so that any number of rows fills the card.
//   (1) One block a row reads a sample of 32 runs of 128 items spread
//   over the row and finds, by digits of the radix select, the bucket of
//   the sample's kq-th smallest, kq a quarter above the sample's share of
//   k plus 16: 16 bits (sign, exponent, 7 mantissa bits), finer until at
//   most kThin samples share it.  The top of that bucket bounds the row's
//   k-th smallest unless the sample misleads.  (2) Blocks over (row, chunk) stream the row once, with
//   eight loads in flight a thread, and append the composites at or below
//   the bound to the row's candidate list in device memory (one atomic a
//   warp); a block streams a whole row, unless the rows are too few to
//   fill the card: then the rows are cut into chunks by the SM count.  (3) One block a row selects the k smallest of its
//   candidates; where fewer than k or more than kRowCap were appended
//   (many equal keys: a bucket cannot split them), it streams the row in
//   runs instead, keeping the k smallest so far and taking from each run
//   only the keys below the largest of them.  The TPU grid's sequential w
//   axis becomes the chunks.
#include <cuda_runtime.h>
#include <algorithm>
#include <math_constants.h>

namespace raft_tpu_torch {
namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxK = 128;
constexpr int kCap = 8192;        // the widest row a block holds: 32 KB of images
constexpr int kCandCap = 1024;    // a held row's items in play compacted once this few
constexpr int kFilterMin = 2048;  // held rows longer than this are filtered first
constexpr int kStride = 8;        // a held row's sample: the last of every kStride items
static_assert(kFilterMin >= kCandCap, "a filtered row has room for its candidates");
constexpr int kSegs = 32;         // a wide row's sample: kSegs runs of kSegLen items
constexpr int kSegLen = 128;
constexpr int kSample = kSegs * kSegLen;
constexpr int kRowCap = 4096;     // a wide row's candidates
constexpr int kChunkMin = 1024;   // items a block of the wide filter streams, at least
constexpr int kFillBlocks = 2;    // blocks an SM the wide filter aims at
constexpr int kUnroll = 8;        // loads in flight a thread
constexpr int kSweep = 4;         // items a thread takes at once in a sweep of shared memory
constexpr int kThin = 4;          // a sampled bound's bucket is resolved to this many samples
constexpr unsigned kFull = 0xffffffffu;
static_assert(kThreads == 256, "one thread per histogram bin");

typedef unsigned long long u64;

// a < b as floats <=> image(a) < image(b), for keys that are not NaN
__device__ __forceinline__ unsigned image(float f) {
  if (f != f) return 0xffffffffu;
  unsigned b = f == 0.f ? 0u : __float_as_uint(f);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

// Add one to h[digit] for each lane where act holds: one atomic for the
// warp where its digits agree (most sweeps of keys of one magnitude), one
// a lane otherwise.  Every lane of the warp calls together.
__device__ __forceinline__ void hist_add(unsigned* h, bool act, unsigned digit, int lane) {
  unsigned am = __ballot_sync(kFull, act);
  if (!act) return;
  int leader = __ffs(am) - 1;
  unsigned d0 = __shfl_sync(am, digit, leader);
  if (__all_sync(am, digit == d0)) {
    if (lane == leader) atomicAdd(&h[d0], (unsigned)__popc(am));
  } else {
    atomicAdd(&h[digit], 1u);
  }
}

// Append key to list (count at *n, capacity cap) for each lane where take
// holds: one atomic a warp.  The count goes on past cap, and what does not
// fit is dropped.  Returns the count after this warp's items (the same in
// every lane).  Every lane of the warp calls together.
__device__ __forceinline__ int push(u64* list, int* n, int cap, bool take, u64 key, int lane) {
  unsigned tm = __ballot_sync(kFull, take);
  if (tm == 0) return 0;
  int base = 0;
  if (lane == __ffs(tm) - 1) base = atomicAdd(n, __popc(tm));
  base = __shfl_sync(kFull, base, __ffs(tm) - 1);
  int at = base + __popc(tm & ((1u << lane) - 1));
  if (take && at < cap) list[at] = key;
  return base + __popc(tm);
}

// The shift of digit j of a composite: the image's four bytes, then
// pos_bytes bytes of the column.
__device__ __forceinline__ int digit_shift(int j, int pos_bytes) {
  return j < 4 ? 56 - 8 * j : 8 * (pos_bytes - 1 - (j - 4));
}

struct Shared {
  unsigned hist[2][256];
  unsigned warp_sum[kWarps];
  u64 win[kMaxK];       // the winners, unordered
  int n_win, n_cand;
  unsigned bucket, below, count;
};

// The bucket of the need-th item counted in sh.hist[h]: sets sh.bucket,
// sh.below (the items in lower buckets) and sh.count (the bucket's), and
// zeroes sh.hist[h ^ 1] for the next digit.  Begins with a __syncthreads,
// so that the histogram is complete, and ends with one.
__device__ __forceinline__ void scan_bucket(Shared& sh, int h, int need) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  __syncthreads();
  unsigned cnt = sh.hist[h][tid];
  unsigned incl = cnt;
#pragma unroll
  for (int off = 1; off < 32; off *= 2) {
    unsigned t = __shfl_up_sync(kFull, incl, off);
    if (lane >= off) incl += t;
  }
  if (lane == 31) sh.warp_sum[warp] = incl;
  sh.hist[h ^ 1][tid] = 0;
  __syncthreads();
  for (int q = 0; q < warp; ++q) incl += sh.warp_sum[q];
  unsigned excl = incl - cnt;
  if (excl < (unsigned)need && (unsigned)need <= incl) {
    sh.bucket = tid;
    sh.below = excl;
    sh.count = cnt;
  }
  __syncthreads();
}

// The composites of a chunk held as images: item i is (img[i] << 32 | i).
struct Images {
  const unsigned* img;
  __device__ __forceinline__ u64 key(int i) const { return (u64)img[i] << 32 | (unsigned)i; }
};

// Composites held as such.
struct List {
  const u64* list;
  __device__ __forceinline__ u64 key(int i) const { return list[i]; }
};

// The k smallest of the composites src.key(0 .. count), count >= k,
// appended unordered to sh.win (sh.n_win is 0 on entry).  The digits are
// the image's four bytes, then pos_bytes bytes of the position.  With
// hist0, sh.hist[0] already holds the first digit's histogram and
// sh.hist[1] is zero.  With cand, the items in play are compacted into it
// once they fit cand_cap.  Ends with a __syncthreads.
template <class Src>
__device__ void radix_select(Src src, int count, int k, int pos_bytes, bool hist0, u64* cand,
                             int cand_cap, Shared& sh) {
  const int tid = threadIdx.x, lane = tid & 31;
  if (!hist0) {
    sh.hist[0][tid] = 0;
    sh.hist[1][tid] = 0;
    __syncthreads();
    for (int base = 0; base < count; base += kThreads * kSweep) {
      u64 key[kSweep];
#pragma unroll
      for (int u = 0; u < kSweep; ++u) {
        int i = base + u * kThreads + tid;
        key[u] = i < count ? src.key(i) : 0;
      }
#pragma unroll
      for (int u = 0; u < kSweep; ++u)
        hist_add(sh.hist[0], base + u * kThreads + tid < count, (unsigned)(key[u] >> 56), lane);
    }
  }
  const int n_digits = 4 + pos_bytes;
  u64 prefix = 0;       // the digits found so far, in place
  int need = k;         // winners still to find
  bool in_cand = false; // the items in play are in cand, not in src
  for (int j = 0;; ++j) {
    scan_bucket(sh, j & 1, need);
    const int shift = digit_shift(j, pos_bytes);
    prefix |= (u64)sh.bucket << shift;
    need -= (int)sh.below;
    // every item of the bucket is needed: they end the search
    const bool done = (int)sh.count == need || j + 1 == n_digits;
    const bool compact = !done && cand && !in_cand && count > cand_cap &&
                         (int)sh.count <= cand_cap;
    const int next = digit_shift(j + 1, pos_bytes);
    // one sweep: winners of this digit (below the bucket, or the whole
    // bucket when done) are listed; the bucket's items go into the next
    // digit's histogram, and into cand when it is their turn
    const u64 P = prefix >> shift, lowP = P & ~(u64)0xff;
    const int n = in_cand ? sh.n_cand : count;
    for (int base = 0; base < n; base += kThreads * kSweep) {
      u64 key[kSweep];  // kSweep loads in flight before any is used
#pragma unroll
      for (int u = 0; u < kSweep; ++u) {
        int i = base + u * kThreads + tid;
        key[u] = i < n ? (in_cand ? cand[i] : src.key(i)) : 0;
      }
#pragma unroll
      for (int u = 0; u < kSweep; ++u) {
        const bool valid = base + u * kThreads + tid < n;
        bool member, below;
        if (shift >= 32) {  // an image digit: 32-bit arithmetic on the image
          unsigned t = (unsigned)(key[u] >> 32) >> (shift - 32);
          member = t == (unsigned)P;
          below = t >= (unsigned)lowP && t < (unsigned)P;
        } else {
          u64 t = key[u] >> shift;
          member = t == P;
          below = t >= lowP && t < P;
        }
        member = member && valid;
        push(sh.win, &sh.n_win, kMaxK, valid && (below || (done && member)), key[u], lane);
        if (!done) {
          unsigned digit = next >= 32 ? (unsigned)(key[u] >> 32) >> (next - 32)
                                      : (unsigned)key[u] >> next;
          hist_add(sh.hist[(j + 1) & 1], member, digit & 0xff, lane);
          if (compact) push(cand, &sh.n_cand, cand_cap, member, key[u], lane);
        }
      }
    }
    if (done) break;
    if (compact) in_cand = true;
  }
  __syncthreads();
}

// An upper bound on the kq-th smallest of the composites list[0 .. n),
// n >= kq: the top of the bucket that holds it, resolved digit by digit
// until at most kThin of the list share the bucket (or all of the bucket
// is needed): a bucket of 16 bits (sign, exponent, 7 mantissa bits) for
// keys of spread values, finer where many keys are close or equal.
__device__ u64 sample_bound(const u64* list, int n, int kq, int pos_bytes, Shared& sh) {
  const int tid = threadIdx.x, lane = tid & 31;
  sh.hist[0][tid] = 0;
  sh.hist[1][tid] = 0;
  __syncthreads();
  for (int base = 0; base < n; base += kThreads * kSweep) {
    u64 key[kSweep];
#pragma unroll
    for (int u = 0; u < kSweep; ++u) {
      int i = base + u * kThreads + tid;
      key[u] = i < n ? list[i] : 0;
    }
#pragma unroll
    for (int u = 0; u < kSweep; ++u)
      hist_add(sh.hist[0], base + u * kThreads + tid < n, (unsigned)(key[u] >> 56), lane);
  }
  u64 prefix = 0;
  int need = kq;
  for (int j = 0;; ++j) {
    scan_bucket(sh, j & 1, need);
    const int shift = digit_shift(j, pos_bytes);
    prefix |= (u64)sh.bucket << shift;
    need -= (int)sh.below;
    const int count = (int)sh.count;
    if (count == need || (j >= 1 && count <= kThin)) return prefix | (((u64)1 << shift) - 1);
    if (j + 1 == 4 + pos_bytes) return prefix;
    const int next = digit_shift(j + 1, pos_bytes);
    const u64 P = prefix >> shift;
    for (int base = 0; base < n; base += kThreads * kSweep) {
      u64 key[kSweep];
#pragma unroll
      for (int u = 0; u < kSweep; ++u) {
        int i = base + u * kThreads + tid;
        key[u] = i < n ? list[i] : 0;
      }
#pragma unroll
      for (int u = 0; u < kSweep; ++u)
        hist_add(sh.hist[(j + 1) & 1], base + u * kThreads + tid < n && key[u] >> shift == P,
                 (unsigned)(key[u] >> next) & 0xff, lane);
    }
  }
}

// A row of keys in device memory: item i is (image(keys[i]) << 32 | i).
struct Row {
  const float* keys;
  __device__ __forceinline__ u64 key(int i) const {
    return (u64)image(__ldg(keys + i)) << 32 | (unsigned)i;
  }
};

__device__ __forceinline__ int pos_bytes_of(int n) {
  return n > 1 ? (32 - __clz(n - 1) + 7) / 8 : 0;
}

// Rank the k winners in sh.win and write them, ascending, to out_k /
// out_i: the key re-read from the row (its bits as they were), the
// column as its id; NaN slots become (+inf, w - 1).
__device__ __forceinline__ void write_ranked(const float* keys, int k, int w, float* out_k,
                                             int* out_i, const Shared& sh) {
  const int tid = threadIdx.x;
  if (tid >= k) return;
  const u64 mine = sh.win[tid];
  int rank = 0;
#pragma unroll 8
  for (int q = 0; q < k; ++q) rank += sh.win[q] < mine;
  const int col = (int)(unsigned)mine;
  float v = keys[col];
  int id = col;
  if (v != v) {
    v = CUDART_INF_F;
    id = w - 1;
  }
  out_k[rank] = v;
  out_i[rank] = id;
}

// The held route: one block a row of w <= kCap items, held in shared
// memory as images (img), with a candidate area of kCandCap composites
// (cand) where w > kCandCap.
__global__ void __launch_bounds__(kThreads)
select_rows(const float* __restrict__ keys, int w, int k, float* __restrict__ out_k,
            int* __restrict__ out_i) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ Shared sh;
  const int tid = threadIdx.x, lane = tid & 31, row = blockIdx.x;
  const float* src = keys + (size_t)row * w;
  unsigned* img = (unsigned*)smem;                                   // [w]
  u64* cand = (u64*)(smem + (((size_t)w * 4 + 15) & ~(size_t)15));    // [kCandCap]
  const bool filter = w > kFilterMin;
  const int pos_bytes = pos_bytes_of(w);

  sh.hist[0][tid] = 0;
  sh.hist[1][tid] = 0;
  if (tid == 0) sh.n_win = sh.n_cand = 0;
  __syncthreads();

  // load the row, with the first digit's histogram unless it is filtered
  for (int base = 0; base < w; base += kThreads * kUnroll) {
    float v[kUnroll];
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) {
      int i = base + j * kThreads + tid;
      v[j] = i < w ? __ldg(src + i) : 0.f;
    }
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) {
      int i = base + j * kThreads + tid;
      unsigned u = image(v[j]);
      if (i < w) img[i] = u;
      if (!filter) hist_add(sh.hist[0], i < w, u >> 24, lane);
    }
  }

  if (!filter) {
    radix_select(Images{img}, w, k, pos_bytes, true, w > kCandCap ? cand : nullptr, kCandCap,
                 sh);
  } else {
    // A bound from a sample, the last item of every kStride items: the top
    // of the bucket that holds its kq-th smallest (sample_bound), kq a
    // quarter above the sample's share of k, plus 16.  If at least k and
    // at most kCandCap items lie at or below the bound, the row's k
    // smallest are among them; otherwise every item takes part.
    __syncthreads();
    const int n_sample = w / kStride;
    for (int s = tid; s < n_sample; s += kThreads) cand[s] = Images{img}.key(kStride * s + kStride - 1);
    __syncthreads();
    const int kq = min(n_sample, (5 * k * n_sample + 4 * w - 1) / (4 * w) + 16);
    const u64 thr = sample_bound(cand, n_sample, kq, pos_bytes, sh);
    if (tid == 0) sh.n_cand = 0;
    __syncthreads();
    for (int base = 0; base < w; base += kThreads * kUnroll) {
      u64 key[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        int i = base + u * kThreads + tid;
        key[u] = i < w ? Images{img}.key(i) : ~(u64)0;
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) push(cand, &sh.n_cand, kCandCap, key[u] <= thr, key[u], lane);
    }
    __syncthreads();
    const int n_cand = sh.n_cand;
    if (k <= n_cand && n_cand <= kCandCap) {
      radix_select(List{cand}, n_cand, k, pos_bytes, false, nullptr, 0, sh);
    } else {
      __syncthreads();  // every thread has read n_cand
      if (tid == 0) sh.n_cand = 0;
      radix_select(Images{img}, w, k, pos_bytes, false, cand, kCandCap, sh);
    }
  }
  write_ranked(src, k, w, out_k + (size_t)row * k, out_i + (size_t)row * k, sh);
}

// The wide route's state in device memory (scratch): per row, the bound
// and the count of candidates, and kRowCap candidates.
struct Wide {
  const float* keys;
  int w, k, chunks;
  u64* bound;   // [m]
  int* count;   // [m]
  u64* cand;    // [m][kRowCap]
};

// Sample run s of a row of w items starts at this column: the runs spread
// evenly from the first column to the last.
__host__ __device__ __forceinline__ int seg_start(int s, int w) {
  return (int)((long long)s * (w - kSegLen) / (kSegs - 1));
}

// (1) One block a row: the bound from the sample; zeroes the row's count.
__global__ void __launch_bounds__(kThreads)
wide_bound(Wide p) {
  __shared__ u64 sample[kSample];
  __shared__ Shared sh;
  const int tid = threadIdx.x, row = blockIdx.x;
  const Row src{p.keys + (size_t)row * p.w};
  for (int t = tid; t < kSample; t += kThreads) sample[t] = src.key(seg_start(t / kSegLen, p.w) + t % kSegLen);
  __syncthreads();
  const int kq = min(kSample, (int)((5LL * p.k * kSample + 4LL * p.w - 1) / (4LL * p.w)) + 16);
  const u64 thr = sample_bound(sample, kSample, kq, pos_bytes_of(p.w), sh);
  if (tid == 0) {
    p.bound[row] = thr;
    p.count[row] = 0;
  }
}

// (2) Blocks over (row, chunk): append the chunk's composites at or below
// the row's bound to its candidates.
__global__ void __launch_bounds__(kThreads)
wide_filter(Wide p) {
  const int tid = threadIdx.x, lane = tid & 31;
  const int row = blockIdx.x / p.chunks, c = blockIdx.x % p.chunks;
  const float* src = p.keys + (size_t)row * p.w;
  const u64 thr = p.bound[row];
  int* count = p.count + row;
  u64* cand = p.cand + (size_t)row * kRowCap;
  bool full = false;  // this warp saw the row's room run out: the row is taken whole
  const int lo = (int)((long long)c * p.w / p.chunks);
  const int hi = (int)((long long)(c + 1) * p.w / p.chunks);
  for (int base = lo; base < hi && !full; base += kThreads * kUnroll) {
    float v[kUnroll];
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) {
      int i = base + j * kThreads + tid;
      v[j] = i < hi ? __ldg(src + i) : 0.f;
    }
    int after = 0;
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) {
      int i = base + j * kThreads + tid;
      u64 key = (u64)image(v[j]) << 32 | (unsigned)i;
      after = max(after, push(cand, count, kRowCap, i < hi && key <= thr, key, lane));
    }
    full = after > kRowCap;
  }
}

// (3) One block a row: the k smallest of its candidates.  Where the
// bound misled (fewer than k or more than kRowCap candidates), the block
// streams the row in runs of kRowCap - kMaxK keys, each time selecting
// the k smallest of the winners so far and the run's keys below the
// largest of them.
__global__ void __launch_bounds__(kThreads)
wide_select(Wide p, float* __restrict__ out_k, int* __restrict__ out_i) {
  __shared__ u64 list[kRowCap];
  __shared__ u64 top;
  __shared__ Shared sh;
  const int tid = threadIdx.x, lane = tid & 31, row = blockIdx.x;
  const float* src = p.keys + (size_t)row * p.w;
  const int pos_bytes = pos_bytes_of(p.w);
  const int n = p.count[row];
  if (tid == 0) sh.n_win = sh.n_cand = 0;
  if (p.k <= n && n <= kRowCap) {
    const u64* cand = p.cand + (size_t)row * kRowCap;
    for (int t = tid; t < n; t += kThreads) list[t] = cand[t];
    __syncthreads();
    radix_select(List{list}, n, p.k, pos_bytes, false, nullptr, 0, sh);
  } else {
    constexpr int kRun = kRowCap - kMaxK;
    __syncthreads();
    for (int lo = 0; lo < p.w; lo += kRun) {
      // the winners so far lead the list; the run's keys below the
      // largest of them follow
      const int held = sh.n_win;  // 0 or k
      if (tid == 0) top = 0;
      __syncthreads();
      if (tid < held) {
        list[tid] = sh.win[tid];
        atomicMax(&top, sh.win[tid]);
      }
      if (tid == 0) sh.n_cand = held;
      __syncthreads();
      const u64 bound = held ? top : ~(u64)0;
      const int hi = min(p.w, lo + kRun);
      for (int base = lo; base < hi; base += kThreads * kUnroll) {
        float v[kUnroll];
#pragma unroll
        for (int j = 0; j < kUnroll; ++j) {
          int i = base + j * kThreads + tid;
          v[j] = i < hi ? __ldg(src + i) : 0.f;
        }
#pragma unroll
        for (int j = 0; j < kUnroll; ++j) {
          int i = base + j * kThreads + tid;
          u64 key = (u64)image(v[j]) << 32 | (unsigned)i;
          push(list, &sh.n_cand, kRowCap, i < hi && key < bound, key, lane);
        }
      }
      __syncthreads();
      const int n_list = sh.n_cand;
      if (n_list > held) {  // something new: select again
        if (tid == 0) sh.n_win = 0;
        radix_select(List{list}, n_list, min(p.k, n_list), pos_bytes, false, nullptr, 0, sh);
      }
    }
  }
  write_ranked(src, p.k, p.w, out_k + (size_t)row * p.k, out_i + (size_t)row * p.k, sh);
}

// Blocks a row of the wide filter: one (a block streams a whole row best)
// unless m rows give the card fewer than kFillBlocks blocks an SM, then
// up to that many, of kChunkMin items at least; 0 for a row the held
// route takes (w <= kCap).
int wide_chunks(int m, int w, int n_sm) {
  if (w <= kCap) return 0;
  long long fill = ((long long)kFillBlocks * n_sm + m - 1) / m;
  return (int)std::max(1LL, std::min(fill, (long long)(w + kChunkMin - 1) / kChunkMin));
}

int sm_count() {
  int dev = 0, n = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) return 0;
  return n;
}

size_t align16(size_t n) { return (n + 15) & ~(size_t)15; }

}  // namespace
}  // namespace raft_tpu_torch

// The wide route's blocks a row for (m, w, k) on this device's SM count,
// 0 where the held route takes the rows, -1 for arguments the kernel does
// not take.
extern "C" int select_tile_plan(int m, int w, int k) {
  using namespace raft_tpu_torch;
  if (k < 1 || k > kMaxK || k > w || m < 1) return -1;
  return wide_chunks(m, w, sm_count());
}

// Bytes of scratch that select_tile_launch needs for (m, w, k): the wide
// route's bounds, counts and candidates; 0 for the held route.
extern "C" long long select_tile_scratch(int m, int w, int k) {
  using namespace raft_tpu_torch;
  if (select_tile_plan(m, w, k) <= 0) return 0;
  return (long long)(align16((size_t)m * 12) + (size_t)m * kRowCap * 8);
}

// keys (m, w) float32 row-major contiguous; out_k (m, k) float32, out_i
// (m, k) int32; scratch holds select_tile_scratch(m, w, k) bytes, 16-byte
// aligned.  k <= 128 and k <= w.  Returns cudaGetLastError().
extern "C" int select_tile_launch(const void* keys, int m, int w, int k, void* out_k,
                                  void* out_i, void* scratch, void* stream) {
  using namespace raft_tpu_torch;
  const int chunks = select_tile_plan(m, w, k);
  if (chunks < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  auto in = (const float*)keys;
  auto ok = (float*)out_k;
  auto oi = (int*)out_i;
  if (chunks == 0) {
    size_t smem = align16((size_t)w * 4) + (w > kCandCap ? kCandCap * 8 : 0);
    select_rows<<<m, kThreads, smem, s>>>(in, w, k, ok, oi);
    return (int)cudaGetLastError();
  }
  auto base = (unsigned char*)scratch;
  Wide p{in, w, k, chunks, (u64*)base, (int*)(base + (size_t)m * 8),
         (u64*)(base + align16((size_t)m * 12))};
  wide_bound<<<m, kThreads, 0, s>>>(p);
  wide_filter<<<(unsigned)m * chunks, kThreads, 0, s>>>(p);
  wide_select<<<m, kThreads, 0, s>>>(p, ok, oi);
  return (int)cudaGetLastError();
}
