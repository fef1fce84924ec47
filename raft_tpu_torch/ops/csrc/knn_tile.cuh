// The fused squared-L2 distance + top-k kernel shared by knn_tile.cu (K1),
// knn_twophase.cu (K6), ivf_tile.cu (K3) and nn_tile.cu (K4), designed for
// Hopper (sm_90a).
//
// Precision: the JAX contract is precision="highest", float32-faithful
// products.  The distance tile runs on the tensor cores in 3xTF32: each
// operand x splits into big = tf32(x) and small = tf32(x - big) (rounded
// to nearest, ties away, as cvt.rna.tf32.f32 rounds; sm90.cuh), and each
// k8 step issues three wgmmas: small*big and big*small into a float32
// accumulator of their own, big*big into the dot product's (kSplitAcc
// below).  The dropped small*small term is about 2^-22 of the product, so
// the dot products carry float32's error, not TF32's (one TF32 pass misses
// the float32 tolerance by 50-100x; tests/test_torch_knn_tf32x3.py
// emulates both, and the tensor cores' truncating sums).
//
// A block of six warpgroups owns a tile of N queries (64, 32 or 16 by
// depth: block_q below) and walks a contiguous range of
// index rows in tiles of kBN = 64, with each role in warps of its own:
//
//   * warp 20 produces: one TMA copy (cp.async.bulk.tensor, a 2-D tensor
//     map with the 128-byte swizzle) per box of 64 index rows x 32 of
//     depth, into a ring of kStages boxes.  The swizzle spreads a warp's
//     fragment loads over all 32 banks; rows and depth past the end of the
//     index arrive as zeros.  Warps 21-23 only complete its warpgroup, since
//     setmaxnreg takes a whole warpgroup, and leave.
//   * warps 0-3, one warpgroup, multiply.  The index tile is wgmma's A:
//     64 rows x 8 of depth per step, loaded from shared memory into
//     registers (float4s) and split there into big and small, never
//     written back.  The queries are B, split when the block (or an
//     item) starts and kept in shared memory in wgmma's canonical K-major layout (no
//     swizzle): the whole depth where it fits (up to 1216 at N = 16), else
//     one slab of it, which the multiply refills for each slab of each
//     index tile while the accumulator carries over, so that any depth
//     runs.  Each box's 12 wgmmas are one commit group; the next box's
//     fragments load while it runs (two register sets, so the depth is
//     walked in pairs of boxes), and only a tile's last box is waited for,
//     before the epilogue writes max(qn + xn - 2 q.x, 0) to one of two
//     distance tiles in shared memory (query-major, for the selection).
//   * warps 4-19 select.  Each owns N / 16 query rows and folds the
//     tile's 64 candidates of each into its running top-k with
//     warp_select.cuh's core (gate, stage, bitonic merge), the buffers in
//     shared memory.  The gate runs first for all
//     of the warp's rows at once (independent loads and ballots); only a
//     row with a candidate that passes takes the stage-and-merge path,
//     whose state waits in shared memory between tiles, so that one copy
//     of that path serves every row.
//
// The ring hands over through full/empty mbarriers (the tensor copies
// complete on the full barrier's transaction count), the distance tiles
// through two more pairs.  setmaxnreg gives the multiplying warpgroup the
// registers that the producer and the selection do not use.
//
// What a block works on, and how it writes a finished top-k, is the
// kernel's mode (Mode below).  K1 and K6 take it from blockIdx: a block
// owns one query tile and an index range of `parts_per_block` parts of
// `rows_per_part` rows, each a multiple of kBN; the selection writes each
// (query, part) top-k at out[(q * n_parts + part) * k] and resets its
// buffers.
//
//   * K1 (kSplits): one part per block, a split of the index; the id is
//     clamped into [0, n - 1], as the JAX kernel's output contract does;
//     K2 merges the splits.
//   * K6 (kTileParts): the parts are the JAX index tiles of bn rows; a
//     slot with no finite key is (+inf, -1), as tile_local_topk writes it.
//
// K3 and K4 walk a work list: a grid of one block per SM takes items it,
// it + gridDim.x, ... (the count read on the device for K3, so that the
// host never waits to size the grid).  An item is up to N query rows and
// a run of index rows that starts at any row (a TMA box needs no
// alignment); its rows past the run, which a box reads all the same, and
// for K3 the vacant ones, never enter the top-k.  For each item the
// multiplying warpgroup refills the queries' halves (the slab path's
// refill) and the selection warps start cold and write once at its end;
// barriers, setmaxnreg and the ring's fill are paid once a block.  The
// modes are template arguments, so K1's and K6's loops are as they were.
//
//   * K3 (kIvfItems): an item is up to N entries of the scan lists (the
//     entry's output row out_row, its query row out_row / steps) against
//     one slot's cap rows; ids map through the
//     slot ids, a slot with no finite key is (+inf, -1).
//   * K4 (kNnItems): item i is the x rows [i N, i N + N) against all of
//     y, k = 1; a row with no finite distance is (+inf, INT_MAX), and a
//     NaN distance stays NaN, which the selection never takes.
//
// Every mode has a kBF16 instance, the JAX precision="default": each
// operand is rounded to bfloat16 (to nearest even) where it would be split,
// and only big x big is issued.  A bfloat16 value is a TF32 value, so its
// small half is 0 and the products of two are exact in float32; the sums
// stay the tensor cores' float32 (truncating, as above), and the norms and
// every select operation stay float32.
//
// The depth d is a multiple of 8 and the rows 16-byte aligned (the
// wrapper pads a copy otherwise); the norms qn and xn come from the
// wrapper.  Rows past the end of a segment's range never enter the top-k;
// query rows past its queries are zero and never selected.
#pragma once

#include "sm90.cuh"
#include "warp_select.cuh"

namespace raft_tpu_torch {
namespace {

constexpr int kBN = 64;                  // index rows per tile: wgmma's M
constexpr int kBox = 32;                 // depth per TMA box: 128 bytes, the swizzle span
constexpr int kBoxBytes = kBN * kBox * 4;
constexpr int kStages = 5;               // boxes in the ring
constexpr int kDistStride = kBN + 4;     // distance tile row, floats
constexpr int kSelWarps = 16;
constexpr int kMmaThreads = 128;
constexpr int kThreads = kMmaThreads + kSelWarps * 32 + 128;  // + the producer's warpgroup
// registers a thread of each role may use (setmaxnreg), and what the
// launch must hand out for them: kThreads x the kernel's count.  A
// multiplying warpgroup with two accumulators of the 64-query tile takes
// 32 more, and the selection 8 fewer.
constexpr int kMmaRegs = 168;
constexpr int kSelRegs = 72;
constexpr int kMmaRegsWide = 200;
constexpr int kSelRegsWide = 64;
constexpr int kProducerRegs = 24;
constexpr int kRegsNeeded = kMmaThreads * kMmaRegs + kSelWarps * 32 * kSelRegs + 128 * kProducerRegs;
static_assert(kMmaThreads * kMmaRegsWide + kSelWarps * 32 * kSelRegsWide +
                      128 * kProducerRegs == kRegsNeeded,
              "both splits of the registers take what the launch hands out");
constexpr int kSmemLimit = 232448;       // 227 KB a block
constexpr int kAlign = 1024;             // the 128-byte swizzle repeats every 1024 bytes
constexpr int kBarBytes = 128;

// Boxes of depth the multiply walks: an even number, so that its loop
// alternates between two register sets with no branch (the boxes past d
// are zeros).
__host__ __device__ constexpr int depth_boxes(int d) { return 2 * ((d + 2 * kBox - 1) / (2 * kBox)); }

// Dynamic shared memory of a block besides the queries: alignment slack,
// the ring, barriers, two distance tiles, the top-k buffers (N x kp
// pairs), the selection's per-row state (32 staged pairs, their count, the
// threshold pair) and the slack that 128-byte aligns the queries.
__host__ __device__ constexpr int smem_fixed(int n_q, int kp) {
  return kAlign + kStages * kBoxBytes + kBarBytes + 2 * n_q * kDistStride * 4 + n_q * kp * 8 +
         n_q * (2 * 32 + 3) * 4 + 128;
}

// Boxes of the queries' depth a block of n_q queries holds, their big and
// small halves, at the widest buffer (k = 128): an even number, so that a
// depth always gets the same slab whatever k.
__host__ __device__ constexpr int slab_boxes(int n_q) {
  return ((kSmemLimit - smem_fixed(n_q, 128)) / (2 * n_q * kBox * 4)) & ~1;
}

// Boxes of the queries' depth held at once: all of them, or one slab.
__host__ __device__ constexpr int held_boxes(int n_q, int d) {
  return depth_boxes(d) < slab_boxes(n_q) ? depth_boxes(d) : slab_boxes(n_q);
}

__host__ __device__ constexpr int smem_bytes(int n_q, int kp, int d) {
  return smem_fixed(n_q, kp) + 2 * n_q * held_boxes(n_q, d) * kBox * 4;
}

// Queries per block: the widest tile of 64, 32 or 16 whose whole depth
// fits beside the rest (to depths 128, 512 and 1216), else kDeepQ with the
// depth in slabs of 512: the multiply refills the queries' halves for
// each slab of each index tile.  The multiply's time goes mostly to
// loading and splitting the index boxes, once for every N queries, so a
// wide tile pays; but a refill stalls the multiply, so a tile that holds
// its whole depth beats a wider one in slabs.
constexpr int kDeepQ = 32;

__host__ __device__ constexpr bool whole_depth(int n_q, int d) {
  return depth_boxes(d) <= slab_boxes(n_q);
}

__host__ __device__ constexpr int block_q(int d) {
  return whole_depth(64, d) ? 64 : whole_depth(32, d) ? 32 : whole_depth(16, d) ? 16 : kDeepQ;
}
static_assert(block_q(128) == 64 && block_q(512) == 32 && block_q(1216) == 16 &&
              block_q(1224) == kDeepQ, "the tiles by depth");

// A's registers for one box: four k8 steps of the m16n8k8 fragment, big
// and small halves.
struct Frag {
  uint32_t big[4][4];
  uint32_t small[4][4];
};

// What a block's work is and how a finished top-k is written.
enum Mode : int {
  // K1: a query tile x an index split (blockIdx); ids clamped into [0, n - 1]
  kSplits = 0,
  // K6: a query tile x a run of JAX tiles (blockIdx); no finite key: (+inf, -1)
  kTileParts = 1,
  // K3: the items of a table in device memory, each some entries of the
  // scan lists (query rows from out_rows) x one slot's rows; vacant rows
  // (id < 0) masked; ids mapped through the slot ids, no finite key: -1
  kIvfItems = 2,
  // K4: tiles of N rows of x x all of y, k = 1; no finite key: (+inf,
  // INT_MAX); a NaN distance stays NaN and is never taken
  kNnItems = 3,
};

__host__ __device__ constexpr bool work_list(int mode) { return mode >= kIvfItems; }

// The tensor cores add each wgmma's products into the accumulator with
// truncation, about half an ulp of its magnitude a wgmma, toward zero: at
// 3 d / 8 wgmmas a dot product that is too many where the data are large
// and alike in sign (the IVF build's Gaussian mixture at depth 128 misses
// l2_atol).  With the two small products in an accumulator of their own,
// 2^-11 as large, the dot product's accumulator takes d / 8 (kSplitAcc
// in the kernel; the 64-query tile takes the registers of kMmaRegsWide
// for it).  bfloat16 operands issue big x big alone, into one.

// The work list of K3 and K4 (unused by K1 and K6).
struct WorkList {
  const int4* items;    // K3: (first entry, entries, first index row, 0)
  const int* n_items;   // K3: the item count, on the device
  const int* out_rows;  // K3: the output row of each entry, q * steps + step
  int steps;            // K3: the scan steps of a query
  const int* ids;       // K3: the global id of each index row, -1 vacant
  int rows_per_item;    // index rows of an item: the slot's cap (K3), n (K4)
};

// One stretch of a block's work: query rows [q0, q0 + q_cnt) (entries of
// the scan lists for K3) against index rows [row_begin, row_end), which
// start at part first_part (K1 and K6; one part an item otherwise).
struct Segment {
  int q0, q_cnt, row_begin, row_end, first_part;
};

template <int N, int kMode>
__device__ __forceinline__ Segment segment(int it, const WorkList& wl, int nq, int n,
                                           int rows_per_part, int parts_per_block) {
  Segment s;
  if constexpr (kMode == kIvfItems) {
    const int4 v = wl.items[it];
    s = {v.x, v.y, v.z, v.z + wl.rows_per_item, 0};
  } else if constexpr (kMode == kNnItems) {
    s = {it * N, min(N, nq - it * N), 0, n, 0};
  } else {
    const int first_part = blockIdx.y * parts_per_block;
    s = {(int)blockIdx.x * N, nq - (int)blockIdx.x * N, first_part * rows_per_part,
         (int)min((long long)n, (long long)(first_part + parts_per_block) * rows_per_part),
         first_part};
  }
  return s;
}

// The segments of this block: it = first, first + stride, ... below count.
// K1 and K6 have one; a work list's items go round the grid.
template <int N, int kMode>
__device__ __forceinline__ int segment_count(const WorkList& wl, int nq) {
  if constexpr (kMode == kIvfItems) return *wl.n_items;
  if constexpr (kMode == kNnItems) return (nq + N - 1) / N;
  return 1;
}

// The distance from the expanded form: clamped at 0, as the JAX kernels
// take max(., 0); K4 keeps a NaN (fmaxf would turn it into 0), which its
// selection never takes.
template <int kMode>
__device__ __forceinline__ float clamp0(float v) {
  if constexpr (kMode == kNnItems) return v < 0.f ? 0.f : v;
  return fmaxf(v, 0.f);
}

// Split the queries' depth boxes [box0, box0 + boxes) of the query rows
// [q0, q0 + q_cnt) (for K3, the rows of entries q0, ... through out_rows)
// into B's halves, in wgmma's canonical K-major layout from the start of
// q_big and q_small: thread i of `count` takes the float4 chunks i,
// i + count, ...  Rows past
// q_cnt are zero.  A thread's float4 load of an index box row (chunk
// 2 t4 + L in the multiply) holds, for k8 steps 2L and 2L + 1 of the box,
// its A values at logical k = t4 and t4 + 4; so box column p (chunk
// j = p / 4, element f = p % 4) is logical k = j / 2 + 4 (f & 1) of step
// 4 box + 2 (j & 1) + f / 2.  Any order of k gives the same dot product,
// as long as A and B share it.  B's logical k = 4h + e sits in core
// matrix h, element e; columns past d are zero.  kBF16 rounds each value
// to bfloat16 into q_big and leaves q_small alone.
template <int N, bool kGather, bool kBF16>
__device__ __forceinline__ void fill_queries(float* q_big, float* q_small,
                                             const float* __restrict__ Q, int d,
                                             const WorkList& wl, int q0, int q_cnt,
                                             int box0, int boxes, int i, int count) {
  const int chunks = boxes * (kBox / 4);  // float4s of a row
#pragma unroll 4
  for (int e = i; e < N * chunks; e += count) {
    const int r = e / chunks;
    const int cl = (e - r * chunks) * 4;  // column in the slab
    const int c = box0 * kBox + cl;       // column of Q
    const bool live = r < q_cnt && c < d;
    int q = q0 + r;
    if constexpr (kGather) q = live ? wl.out_rows[q] / wl.steps : 0;
    // d is a multiple of 8: a chunk lies wholly inside the depth or past it
    const float4 v = live ? *reinterpret_cast<const float4*>(Q + (size_t)q * d + c)
                          : make_float4(0.f, 0.f, 0.f, 0.f);
    const float vs[4] = {v.x, v.y, v.z, v.w};
    const int j = (cl & 31) >> 2;
    const int base =
        ((cl >> 5) * 4 + 2 * (j & 1)) * N * 8 + (r >> 3) * 64 + (r & 7) * 4 + (j >> 1);
#pragma unroll
    for (int f = 0; f < 4; ++f) {
      const int off = base + (f >> 1) * N * 8 + (f & 1) * 32;
      if constexpr (kBF16) {
        q_big[off] = __uint_as_float(sm90::bf16_rne(vs[f]));
      } else {
        uint32_t big, small;
        sm90::split_tf32(vs[f], big, small);
        q_big[off] = __uint_as_float(big);
        q_small[off] = __uint_as_float(small);
      }
    }
  }
}

template <int N, int NR, int kMode, bool kBF16>
__global__ void __launch_bounds__(kThreads, 1)
knn_tile_kernel(const __grid_constant__ CUtensorMap x_map, const float* __restrict__ Q,
                const float* __restrict__ qn, const float* __restrict__ xn, int nq, int n,
                int d, int k, int rows_per_part, int parts_per_block, int n_parts,
                const WorkList wl, float* __restrict__ out_d, int* __restrict__ out_i) {
  using namespace sm90;
  constexpr int kKP = 32 * NR;
  constexpr bool kWork = work_list(kMode);
  constexpr bool kGather = kMode == kIvfItems;
  constexpr bool kSplitAcc = !kBF16;
  constexpr bool kWideRegs = kSplitAcc && N == 64;
  static_assert(N % kSelWarps == 0, "whole query rows a selection warp");
  constexpr int kRowsPerWarp = N / kSelWarps;
  extern __shared__ char smem_raw[];
  char* smem = smem_raw + ((kAlign - (smem_addr(smem_raw) & (kAlign - 1))) & (kAlign - 1));
  float* ring = reinterpret_cast<float*>(smem);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kStages * kBoxBytes);
  uint64_t* empty = full + kStages;
  uint64_t* dist_full = empty + kStages;
  uint64_t* dist_empty = dist_full + 2;
  float* dist = reinterpret_cast<float*>(smem + kStages * kBoxBytes + kBarBytes);
  float* buf_k = dist + 2 * N * kDistStride;
  int* buf_i = reinterpret_cast<int*>(buf_k + N * kKP);
  float* st_k = reinterpret_cast<float*>(buf_i + N * kKP);  // staged pairs, a row of 32 each
  int* st_i = reinterpret_cast<int*>(st_k + N * 32);
  int* st_n = st_i + N * 32;
  float* th_k = reinterpret_cast<float*>(st_n + N);
  int* th_i = reinterpret_cast<int*>(th_k + N);
  char* q_base = reinterpret_cast<char*>(th_i + N);
  float* q_big = reinterpret_cast<float*>(q_base + ((128 - (smem_addr(q_base) & 127)) & 127));
  const int n_boxes = depth_boxes(d);
  const int held = held_boxes(N, d);  // the slab: n_boxes, or fewer at depth
  float* q_small = q_big + held * kBox * N;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  // the block's segments (module note): one, or items round the grid
  const int seg_first = kWork ? blockIdx.x : 0;
  const int seg_stride = kWork ? gridDim.x : 1;
  const int n_segs = segment_count<N, kMode>(wl, nq);
  // index tiles of a segment: a work list's items all have the same count
  auto tiles_of = [&](const Segment& s) {
    return ((kWork ? wl.rows_per_item : s.row_end - s.row_begin) + kBN - 1) / kBN;
  };

  if (tid == 0) {
    // one arrival per warp: lane 0, after __syncwarp orders the lanes'
    // shared-memory accesses before it
    for (int s = 0; s < kStages; ++s) {
      bar_init(&full[s], 1);
      bar_init(&empty[s], kMmaThreads / 32);
    }
    for (int b = 0; b < 2; ++b) {
      bar_init(&dist_full[b], kMmaThreads / 32);
      bar_init(&dist_empty[b], kSelWarps);
    }
    bar_init_fence();
  }
  if constexpr (!kWork) {
    // the query tile's first slab (its whole depth, but for the deepest)
    const Segment s = segment<N, kMode>(0, wl, nq, n, rows_per_part, parts_per_block);
    fill_queries<N, false, kBF16>(q_big, q_small, Q, d, wl, s.q0, s.q_cnt, 0, held, tid,
                                  kThreads);
    fence_proxy_async();
  }
  __syncthreads();

  if (warp < 4) {
    // ---- multiply: one warpgroup -----------------------------------
    setmaxnreg_inc<kWideRegs ? kMmaRegsWide : kMmaRegs>();
    const int g8 = lane >> 2;  // fragment row (and row + 8); the row's swizzle
    const int t4 = lane & 3;
    // core matrices 128 bytes apart along K, 8-row groups 256 bytes apart
    const uint64_t desc_big = desc_kmajor(q_big, 128, 256);
    const uint64_t desc_small = desc_kmajor(q_small, 128, 256);
    const int row_lo = (warp * 16 + g8) * kBox;  // this thread's rows in a box
    const int row_hi = row_lo + 8 * kBox;
    float acc[N / 2];
    float acc_lo[N / 2];
    Frag frag[2];
    int tt = 0;  // tiles of the block so far: the ring's and the distance tiles' count
    // The control flow around the wgmmas is uniform loops only: a branch
    // the compiler cannot prove uniform makes it serialise them.
    for (int it = seg_first; it < n_segs; it += seg_stride) {
      const Segment sg = segment<N, kMode>(it, wl, nq, n, rows_per_part, parts_per_block);
      if constexpr (kWork) {
        // the item's queries replace the last item's, whose wgmmas are done
        mma_bar_sync();
        fill_queries<N, kGather, kBF16>(q_big, q_small, Q, d, wl, sg.q0, sg.q_cnt, 0, held,
                                        tid, kMmaThreads);
        fence_proxy_async();
        mma_bar_sync();
      }
      float qn_r[N / 4];  // qn of tile columns 8j + 2 t4 + {0, 1}
#pragma unroll
      for (int j = 0; j < N / 8; ++j) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = 8 * j + 2 * t4 + h;
          int q = sg.q0 + r;
          if constexpr (kGather) q = r < sg.q_cnt ? wl.out_rows[q] / wl.steps : 0;
          qn_r[2 * j + h] = r < sg.q_cnt ? qn[q] : 0.f;
        }
      }
      const int n_tiles = tiles_of(sg);
      for (int t = 0; t < n_tiles; ++t, ++tt) {
        const int ra = sg.row_begin + t * kBN + warp * 16 + g8;
        const float xa = ra < sg.row_end ? xn[ra] : 0.f;
        const float xb = ra + 8 < sg.row_end ? xn[ra + 8] : 0.f;
#pragma unroll
        for (int i = 0; i < N / 2; ++i) {
          acc[i] = 0.f;
          fence_operand(acc[i]);
          if constexpr (kSplitAcc) {
            acc_lo[i] = 0.f;
            fence_operand(acc_lo[i]);
          }
        }
        // box g of the block is depth box g % n_boxes of tile g / n_boxes;
        // boxes alternate between the two register sets, and a box's group
        // retires while the next one's fragments load.  The depth goes in
        // slabs of `held` boxes: past the first slab of a segment's first
        // tile, each slab's query halves replace the last ones once the
        // wgmmas that read those are done, and the accumulator carries over.
        for (int c0 = 0; c0 < n_boxes; c0 += held) {
          if (held < n_boxes && (t > 0 || c0 > 0)) {
            wgmma_wait<0>();
            mma_bar_sync();
            fill_queries<N, kGather, kBF16>(q_big, q_small, Q, d, wl, sg.q0, sg.q_cnt, c0,
                                            min(held, n_boxes - c0), tid, kMmaThreads);
            fence_proxy_async();
            mma_bar_sync();
          }
          const int c_end = min(n_boxes, c0 + held);
          for (int c = c0; c < c_end; c += 2) {
#pragma unroll
            for (int S = 0; S < 2; ++S) {
              const int g = tt * n_boxes + c + S;
              const int slot = g % kStages;
              bar_wait(&full[slot], (g / kStages) & 1);
              const float* b = ring + slot * (kBN * kBox);
#pragma unroll
              for (int L = 0; L < 2; ++L) {
                const int chunk = ((2 * t4 + L) ^ g8) * 4;
                const float4 lo = *reinterpret_cast<const float4*>(b + row_lo + chunk);
                const float4 hi = *reinterpret_cast<const float4*>(b + row_hi + chunk);
                uint32_t(&b0)[4] = frag[S].big[2 * L];
                uint32_t(&s0)[4] = frag[S].small[2 * L];
                uint32_t(&b1)[4] = frag[S].big[2 * L + 1];
                uint32_t(&s1)[4] = frag[S].small[2 * L + 1];
                if constexpr (kBF16) {
                  b0[0] = bf16_rne(lo.x);
                  b0[1] = bf16_rne(hi.x);
                  b0[2] = bf16_rne(lo.y);
                  b0[3] = bf16_rne(hi.y);
                  b1[0] = bf16_rne(lo.z);
                  b1[1] = bf16_rne(hi.z);
                  b1[2] = bf16_rne(lo.w);
                  b1[3] = bf16_rne(hi.w);
                } else {
                  split_tf32(lo.x, b0[0], s0[0]);  // row g8,     k t4
                  split_tf32(hi.x, b0[1], s0[1]);  // row g8 + 8, k t4
                  split_tf32(lo.y, b0[2], s0[2]);  // row g8,     k t4 + 4
                  split_tf32(hi.y, b0[3], s0[3]);  // row g8 + 8, k t4 + 4
                  split_tf32(lo.z, b1[0], s1[0]);
                  split_tf32(hi.z, b1[1], s1[1]);
                  split_tf32(lo.w, b1[2], s1[2]);
                  split_tf32(hi.w, b1[3], s1[3]);
                }
              }
              __syncwarp();
              bar_arrive_if(&empty[slot], lane == 0);
              // the box's descriptors, settled before the fence like every
              // other register the wgmmas read
              uint64_t d_big[4], d_small[4];
#pragma unroll
              for (int s = 0; s < 4; ++s) {
                const uint64_t step = (uint64_t)(((c - c0 + S) * 4 + s) * N * 32) >> 4;
                d_big[s] = desc_big + step;
                d_small[s] = desc_small + step;
                fence_operand(d_big[s]);
                fence_operand(d_small[s]);
              }
              wgmma_fence();
#pragma unroll
              for (int s = 0; s < 4; ++s) {
                if constexpr (kBF16) {
                  // bfloat16 operands: small is 0, big x big is exact
                  Wgmma<N>::mma(acc, frag[S].big[s], d_big[s]);
                } else if constexpr (kSplitAcc) {
                  Wgmma<N>::mma(acc_lo, frag[S].small[s], d_big[s]);
                  Wgmma<N>::mma(acc_lo, frag[S].big[s], d_small[s]);
                  Wgmma<N>::mma(acc, frag[S].big[s], d_big[s]);
                } else {
                  Wgmma<N>::mma(acc, frag[S].small[s], d_big[s]);
                  Wgmma<N>::mma(acc, frag[S].big[s], d_small[s]);
                  Wgmma<N>::mma(acc, frag[S].big[s], d_big[s]);
                }
              }
              wgmma_commit();
              wgmma_wait<1>();  // the previous box's group: its register set is free
            }
          }
        }
        wgmma_wait<0>();
#pragma unroll
        for (int i = 0; i < N / 2; ++i) {
          fence_operand(acc[i]);
          if constexpr (kSplitAcc) {
            fence_operand(acc_lo[i]);
            acc[i] += acc_lo[i];
          }
        }
        // epilogue: accumulator (row 16 warp + g8 (+8), column 8j + 2 t4
        // (+1)) to the query-major distance tile
        const int buf = tt & 1;
        bar_wait(&dist_empty[buf], ((tt >> 1) & 1) ^ 1);
        float* dt = dist + buf * N * kDistStride + warp * 16 + g8;
#pragma unroll
        for (int j = 0; j < N / 8; ++j) {
          const int col = 8 * j + 2 * t4;
          dt[col * kDistStride] = clamp0<kMode>(qn_r[2 * j] + xa - 2.f * acc[4 * j]);
          dt[(col + 1) * kDistStride] = clamp0<kMode>(qn_r[2 * j + 1] + xa - 2.f * acc[4 * j + 1]);
          dt[col * kDistStride + 8] = clamp0<kMode>(qn_r[2 * j] + xb - 2.f * acc[4 * j + 2]);
          dt[(col + 1) * kDistStride + 8] =
              clamp0<kMode>(qn_r[2 * j + 1] + xb - 2.f * acc[4 * j + 3]);
        }
        __syncwarp();
        bar_arrive_if(&dist_full[buf], lane == 0);
      }
    }
  } else if (warp < 4 + kSelWarps) {
    // ---- select: kSelWarps warps, kRowsPerWarp query rows each ------
    setmaxnreg_dec<kWideRegs ? kSelRegsWide : kSelRegs>();
    const int r0 = (warp - 4) * kRowsPerWarp;
    int tt = 0;
    for (int it = seg_first; it < n_segs; it += seg_stride) {
      const Segment sg = segment<N, kMode>(it, wl, nq, n, rows_per_part, parts_per_block);
      // rows of this warp with a query: bit qq for row r0 + qq
      const int n_live = max(0, min(kRowsPerWarp, sg.q_cnt - r0));
      const unsigned live = (1u << n_live) - 1;
      bool fresh = true;  // the next tile starts a part
      int part = sg.first_part;
      int part_end = kWork ? sg.row_end
                           : (int)min((long long)n, (long long)(part + 1) * rows_per_part);
      const int n_tiles = tiles_of(sg);
      for (int t = 0; t < n_tiles; ++t, ++tt) {
        if (fresh) {
          // cold buffers, nothing staged, no threshold
          for (int r = r0; r < r0 + kRowsPerWarp; ++r) {
#pragma unroll
            for (int p = 0; p < NR; ++p) {
              buf_k[r * kKP + p * 32 + lane] = CUDART_INF_F;
              buf_i[r * kKP + p * 32 + lane] = INT_MAX;
            }
            if (lane == 0) {
              st_n[r] = 0;
              th_k[r] = CUDART_INF_F;
              th_i[r] = INT_MAX;
            }
          }
          __syncwarp();
          fresh = false;
        }
        const int row0 = sg.row_begin + t * kBN;
        const int tile_end = min(row0 + kBN, sg.row_end);
        bool ok0 = row0 + lane < tile_end;
        bool ok1 = row0 + 32 + lane < tile_end;
        if constexpr (kMode == kIvfItems) {
          // vacant rows, and the next slot's rows that a box reads past the
          // item, never enter
          ok0 = ok0 && wl.ids[row0 + lane] >= 0;
          ok1 = ok1 && wl.ids[row0 + 32 + lane] >= 0;
        }
        const int id0 = ok0 ? row0 + lane : INT_MAX;
        const int id1 = ok1 ? row0 + 32 + lane : INT_MAX;
        const int buf = tt & 1;
        bar_wait(&dist_full[buf], (tt >> 1) & 1);
        const float* dt = dist + buf * N * kDistStride;
        // the gate, every row at once: which rows have a candidate that
        // beats their k-th best
        unsigned pass = 0;
#pragma unroll
        for (int qq = 0; qq < kRowsPerWarp; ++qq) {
          const int r = r0 + qq;
          const float tk = th_k[r];
          const int ti = th_i[r];
          const float k0 = id0 < INT_MAX ? dt[r * kDistStride + lane] : CUDART_INF_F;
          const float k1 = id1 < INT_MAX ? dt[r * kDistStride + 32 + lane] : CUDART_INF_F;
          const bool p = lex_less(k0, id0, tk, ti) || lex_less(k1, id1, tk, ti);
          if (__any_sync(kFullMask, p)) pass |= 1u << qq;
        }
        pass &= live;
        // stage and merge, one row at a time, its state from shared memory
#pragma unroll 1
        while (pass != 0) {
          const int r = r0 + __ffs(pass) - 1;
          pass &= pass - 1;
          SharedTopK<NR> top{buf_k + r * kKP, buf_i + r * kKP};
          Stage st{st_k[r * 32 + lane], st_i[r * 32 + lane], st_n[r]};
          float tk = th_k[r];
          int ti = th_i[r];
          offer(top, st, id0 < INT_MAX ? dt[r * kDistStride + lane] : CUDART_INF_F, id0, lane, k,
                tk, ti);
          offer(top, st, id1 < INT_MAX ? dt[r * kDistStride + 32 + lane] : CUDART_INF_F, id1,
                lane, k, tk, ti);
          st_k[r * 32 + lane] = st.key;
          st_i[r * 32 + lane] = st.id;
          __syncwarp();
          if (lane == 0) {
            st_n[r] = st.n;
            th_k[r] = tk;
            th_i[r] = ti;
          }
        }
        __syncwarp();
        bar_arrive_if(&dist_empty[buf], lane == 0);
        if (row0 + kBN < part_end) continue;
        // the part's last tile: write each row's k smallest, sorted
#pragma unroll 1
        for (int qq = 0; qq < n_live; ++qq) {
          const int r = r0 + qq;
          SharedTopK<NR> top{buf_k + r * kKP, buf_i + r * kKP};
          Stage st{st_k[r * 32 + lane], st_i[r * 32 + lane], st_n[r]};
          float tk = th_k[r];
          int ti = th_i[r];
          flush(top, st, lane, k, tk, ti);
          WarpTopK<NR> w;
          w.load(top.key_s, top.id_s, lane);
          if constexpr (kMode == kSplits) {
            const size_t off = ((size_t)(sg.q0 + r) * n_parts + part) * k;
            w.store(out_d + off, out_i + off, k, lane, 0, n - 1);
          } else {
            size_t off;
            if constexpr (kMode == kTileParts) off = ((size_t)(sg.q0 + r) * n_parts + part) * k;
            if constexpr (kMode == kIvfItems) off = (size_t)wl.out_rows[sg.q0 + r] * k;
            if constexpr (kMode == kNnItems) off = (size_t)(sg.q0 + r) * k;
#pragma unroll
            for (int p = 0; p < NR; ++p) {
              const int pos = p * 32 + lane;
              if (pos < k) {
                const bool fin = w.key[p] < CUDART_INF_F;
                int id = fin ? w.id[p] : -1;
                if constexpr (kMode == kIvfItems) id = fin ? wl.ids[w.id[p]] : -1;
                if constexpr (kMode == kNnItems) id = fin ? w.id[p] : INT_MAX;
                out_d[off + pos] = fin ? w.key[p] : CUDART_INF_F;
                out_i[off + pos] = id;
              }
            }
          }
        }
        __syncwarp();
        fresh = true;
        ++part;
        part_end = (int)min((long long)n, (long long)part_end + rows_per_part);
      }
    }
  } else {
    // ---- produce: one thread ---------------------------------------
    setmaxnreg_dec<kProducerRegs>();
    if (warp != 4 + kSelWarps || lane != 0) return;
    int g = 0;
    for (int it = seg_first; it < n_segs; it += seg_stride) {
      const Segment sg = segment<N, kMode>(it, wl, nq, n, rows_per_part, parts_per_block);
      const int n_tiles = tiles_of(sg);
      for (int t = 0; t < n_tiles; ++t) {
        for (int c = 0; c < n_boxes; ++c, ++g) {
          const int slot = g % kStages;
          bar_wait(&empty[slot], ((g / kStages) & 1) ^ 1);
          bar_arrive_tx(&full[slot], kBoxBytes);
          tma_load_2d(ring + slot * (kBN * kBox), &x_map, c * kBox, sg.row_begin + t * kBN,
                      &full[slot]);
        }
      }
    }
  }
}

struct KnnArgs {
  const float* q;
  const float* x;
  const float* qn;
  const float* xn;
  int nq, n, d, k, rows_per_part, parts_per_block, n_parts;
  float* out_d;
  int* out_i;
  WorkList wl;
};

// The index as a 2-D tensor map: (n, d) row-major float32, boxes of 64
// rows x 32 floats with the 128-byte swizzle, zeros past the edges.
// cuTensorMapEncodeTiled comes through the runtime's driver entry point,
// so that the library needs no link to libcuda.
inline cudaError_t make_index_map(CUtensorMap* map, const KnnArgs& a) {
  using Encode = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                              const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                              const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                              CUtensorMapL2promotion, CUtensorMapFloatOOBfill);
  static Encode encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
    if (err != cudaSuccess) return err;
    if (found != cudaDriverEntryPointSuccess || fn == nullptr) return cudaErrorNotSupported;
    encode = reinterpret_cast<Encode>(fn);
  }
  const cuuint64_t dims[2] = {(cuuint64_t)a.d, (cuuint64_t)a.n};
  const cuuint64_t strides[1] = {(cuuint64_t)a.d * 4};
  const cuuint32_t box[2] = {kBox, kBN};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r =
      encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<float*>(a.x), dims, strides,
             box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// `blocks`: K1's and K6's blocks along the index (grid.y, beside one
// along the queries for each query tile), a work list's whole grid.
template <int N, int NR, int kMode, bool kBF16>
cudaError_t launch_tile(int blocks, cudaStream_t s, const KnnArgs& a) {
  auto kernel = knn_tile_kernel<N, NR, kMode, kBF16>;
  // setmaxnreg only moves registers between the warps of a block: the
  // launch must hand out what the roles take, or the multiplying
  // warpgroup would wait for registers forever
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  if (attr.numRegs * kThreads < kRegsNeeded) return cudaErrorInvalidConfiguration;
  const int bytes = smem_bytes(N, 32 * NR, a.d);
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  CUtensorMap map;
  err = make_index_map(&map, a);
  if (err != cudaSuccess) return err;
  const dim3 grid = work_list(kMode) ? dim3(blocks) : dim3((a.nq + N - 1) / N, blocks);
  kernel<<<grid, kThreads, bytes, s>>>(map, a.q, a.qn, a.xn, a.nq, a.n, a.d, a.k,
                                        a.rows_per_part, a.parts_per_block, a.n_parts, a.wl,
                                        a.out_d, a.out_i);
  return cudaGetLastError();
}

// The buffer width for k: K6 keeps 128 a tile, K4 one, K1 and K3 the least
// of 32, 64, 128.
template <int N, int kMode, bool kBF16>
cudaError_t launch_nr(int blocks, cudaStream_t s, const KnnArgs& a) {
  if constexpr (kMode == kTileParts) {
    if (a.k != 128) return cudaErrorInvalidValue;
    return launch_tile<N, 4, kMode, kBF16>(blocks, s, a);
  } else if constexpr (kMode == kNnItems) {
    if (a.k != 1) return cudaErrorInvalidValue;
    return launch_tile<N, 1, kMode, kBF16>(blocks, s, a);
  } else {
    if (a.k <= 32) return launch_tile<N, 1, kMode, kBF16>(blocks, s, a);
    if (a.k <= 64) return launch_tile<N, 2, kMode, kBF16>(blocks, s, a);
    return launch_tile<N, 4, kMode, kBF16>(blocks, s, a);
  }
}

// The tile of N queries, then the buffer width.  K1 and K6 take the tile
// of the depth (block_q); a work list's caller names it (n_q: 64, 32 or
// 16; its items hold that many queries at most), since the items are cut
// to it before the launch.
template <int kMode, bool kBF16 = false>
cudaError_t launch(int blocks, cudaStream_t s, const KnnArgs& a, int n_q = 0) {
  if (a.d < 8 || a.d % 8 != 0 || a.k < 1 || a.k > 128 ||
      (!work_list(kMode) && a.rows_per_part % kBN != 0) || a.nq < 1 || a.n < 1 || blocks < 1 ||
      reinterpret_cast<uintptr_t>(a.x) % 16 != 0 || reinterpret_cast<uintptr_t>(a.q) % 16 != 0) {
    return cudaErrorInvalidValue;
  }
  switch (work_list(kMode) ? n_q : block_q(a.d)) {
    case 64: return launch_nr<64, kMode, kBF16>(blocks, s, a);
    case 32: return launch_nr<32, kMode, kBF16>(blocks, s, a);
    case 16: return launch_nr<16, kMode, kBF16>(blocks, s, a);
    default: return cudaErrorInvalidValue;
  }
}

// Blocks of a work list's grid: one per SM, no more than its items.
inline cudaError_t work_blocks(int max_items, int* blocks) {
  int dev, sms;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  *blocks = max_items < 1 ? 1 : max_items < sms ? max_items : sms;
  return cudaSuccess;
}

}  // namespace
}  // namespace raft_tpu_torch
