// Warp-wide running top-k: the selection core of the fused kernels of
// knn_tile.cuh (K1, K3, K4, K6).
//
// Replaces raft_tpu/ops/knn_tile.py:239 topk_update, the threshold-gated
// extract-merge loop over 128-lane bitonic networks that K1, K2 and K3
// share on the TPU.  On Hopper the natural unit is a warp: one warp owns
// one row's running top-k, kept sorted ascending as KP = 32*NR (key, id)
// pairs, position p = r*32 + lane in register r of lane `lane`.  This is
// the warp-select design of the reference's fusedL2Knn and
// warp_select_faiss.cuh.  The buffer lives in shared memory, where the
// registers go to the distance tile, and is loaded only to merge
// (SharedTopK over WarpTopK).  K2 (select_tile.cu) selects by radix
// instead.
//
// Candidates arrive 32 at a time, one per lane.  The gate compares each
// against the current k-th best (broadcast from its lane); a batch where
// no lane passes costs one ballot and nothing else, which is what happens
// to almost every batch once the buffer is warm.  Candidates that pass are
// compacted into a staging slot per lane (a ballot, a prefix count and one
// shuffle), and the buffer merges only when min(k, 32) slots are full, so
// that a merge does the work of many insertions: while the buffer warms up
// most batches pass only a few lanes.  The gate uses the buffer's k-th
// best, which bounds the true k-th best from above, so staging drops
// nothing.  A merge sorts the 32 staged pairs descending across the warp
// (15 shuffle compare-exchange stages), folds them into the buffer's last
// 32 slots by an element-wise min (the first half-cleaner of a bitonic
// merge of the buffer with the candidates padded to KP), and re-sorts the
// buffer by the log2(KP) tail of the bitonic merge: stages of stride >= 32
// pair registers inside a lane, stages of stride < 32 pair lanes through
// __shfl_xor_sync.
//
// Order is lexicographic on (key, id), so the result is exactly the k
// smallest pairs: equal keys resolve to the smaller id, and no id is ever
// duplicated or lost.  Empty slots are (+inf, INT_MAX); a NaN key never
// passes the gate.
#pragma once

#include <cuda_runtime.h>
#include <climits>
#include <math_constants.h>

namespace raft_tpu_torch {

constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ bool lex_less(float ka, int ia, float kb, int ib) {
  return ka < kb || (ka == kb && ia < ib);
}

// One compare-exchange between this lane and lane ^ stride.
__device__ __forceinline__ void lane_exchange(float& key, int& id, int stride,
                                              bool keep_min) {
  float pk = __shfl_xor_sync(kFullMask, key, stride);
  int pi = __shfl_xor_sync(kFullMask, id, stride);
  bool take = keep_min ? lex_less(pk, pi, key, id) : lex_less(key, id, pk, pi);
  if (take) {
    key = pk;
    id = pi;
  }
}

// Sort one (key, id) per lane descending across the warp: lane 0 ends up
// with the largest pair.
__device__ __forceinline__ void warp_sort_desc(float& key, int& id, int lane) {
#pragma unroll
  for (int size = 2; size <= 32; size *= 2) {
    bool asc = (lane & size) != 0;  // mirrored so that size 32 runs descending
#pragma unroll
    for (int stride = size / 2; stride > 0; stride /= 2) {
      bool lower = (lane & stride) == 0;
      lane_exchange(key, id, stride, lower == asc);
    }
  }
}

// The sorted buffer in registers.
template <int NR>
struct WarpTopK {
  static_assert(NR == 1 || NR == 2 || NR == 4, "KP must be 32, 64 or 128");
  float key[NR];
  int id[NR];

  __device__ __forceinline__ void init() {
#pragma unroll
    for (int r = 0; r < NR; ++r) {
      key[r] = CUDART_INF_F;
      id[r] = INT_MAX;
    }
  }

  __device__ __forceinline__ void load(const float* key_s, const int* id_s, int lane) {
#pragma unroll
    for (int r = 0; r < NR; ++r) {
      key[r] = key_s[r * 32 + lane];
      id[r] = id_s[r * 32 + lane];
    }
  }

  __device__ __forceinline__ void save(float* key_s, int* id_s, int lane) const {
#pragma unroll
    for (int r = 0; r < NR; ++r) {
      key_s[r * 32 + lane] = key[r];
      id_s[r * 32 + lane] = id[r];
    }
  }

  // The pair at sorted position kth (0-based), broadcast to every lane.
  __device__ __forceinline__ void at(int kth, float& k_out, int& i_out) const {
    int reg = kth >> 5;
    float k = key[0];
    int i = id[0];
#pragma unroll
    for (int r = 1; r < NR; ++r) {
      if (r == reg) {
        k = key[r];
        i = id[r];
      }
    }
    k_out = __shfl_sync(kFullMask, k, kth & 31);
    i_out = __shfl_sync(kFullMask, i, kth & 31);
  }

  // Merge one candidate per lane ((+inf, INT_MAX) for none) into the
  // buffer.  Every lane of the warp must call it together.
  __device__ __forceinline__ void merge(float ck, int ci, int lane) {
    warp_sort_desc(ck, ci, lane);
    if (lex_less(ck, ci, key[NR - 1], id[NR - 1])) {
      key[NR - 1] = ck;
      id[NR - 1] = ci;
    }
#pragma unroll
    for (int s = NR / 2; s >= 1; s /= 2) {
#pragma unroll
      for (int r = 0; r < NR; ++r) {
        if ((r & s) == 0 && lex_less(key[r + s], id[r + s], key[r], id[r])) {
          float tk = key[r];
          int ti = id[r];
          key[r] = key[r + s];
          id[r] = id[r + s];
          key[r + s] = tk;
          id[r + s] = ti;
        }
      }
    }
#pragma unroll
    for (int stride = 16; stride > 0; stride /= 2) {
      bool lower = (lane & stride) == 0;
#pragma unroll
      for (int r = 0; r < NR; ++r) lane_exchange(key[r], id[r], stride, lower);
    }
  }

  // Merge, then refresh the k-th best.
  __device__ __forceinline__ void merge(float ck, int ci, int lane, int k,
                                        float& thr_k, int& thr_i) {
    merge(ck, ci, lane);
    at(k - 1, thr_k, thr_i);
  }

  // Write positions [0, k) of the buffer, ids clamped to [id_lo, id_hi].
  __device__ __forceinline__ void store(float* out_k, int* out_i, int k,
                                        int lane, int id_lo, int id_hi) const {
#pragma unroll
    for (int r = 0; r < NR; ++r) {
      int p = r * 32 + lane;
      if (p < k) {
        out_k[p] = key[r];
        out_i[p] = min(max(id[r], id_lo), id_hi);
      }
    }
  }
};

// The sorted buffer in shared memory (position p of the keys at key_s[p],
// of the ids at id_s[p]), brought into registers only for a merge.
template <int NR>
struct SharedTopK {
  float* key_s;
  int* id_s;

  __device__ __forceinline__ void merge(float ck, int ci, int lane, int k,
                                        float& thr_k, int& thr_i) {
    WarpTopK<NR> t;
    t.load(key_s, id_s, lane);
    t.merge(ck, ci, lane, k, thr_k, thr_i);
    t.save(key_s, id_s, lane);
  }
};

// Candidates that passed the gate and wait for a merge: one slot a lane,
// `n` slots in use (the same in every lane).
struct Stage {
  float key;
  int id;
  int n;
};

// Fill this lane's slot with the passing candidate of the given rank
// (0-based among the lanes set in mask) where take holds.
__device__ __forceinline__ void stage_from(Stage& st, float ck, int ci,
                                           unsigned mask, int rank, bool take) {
  int src = take ? (int)__fns(mask, 0, rank + 1) : 0;
  float vk = __shfl_sync(kFullMask, ck, src);
  int vi = __shfl_sync(kFullMask, ci, src);
  if (take) {
    st.key = vk;
    st.id = vi;
  }
}

// Offer one candidate per lane to `buf`.  Candidates that beat the
// current k-th best (thr_k, thr_i) are staged; once min(k, 32) wait, the
// stage merges and (thr_k, thr_i) is refreshed: k staged candidates
// already bound the true k-th best below the stale threshold, so waiting
// longer would only let more through the gate.  Every lane of the warp
// calls together.
template <class Buffer>
__device__ __forceinline__ void offer(Buffer& buf, Stage& st, float ck, int ci,
                                      int lane, int k, float& thr_k, int& thr_i) {
  unsigned mask = __ballot_sync(kFullMask, lex_less(ck, ci, thr_k, thr_i));
  if (mask == 0) return;
  int before = st.n;
  int total = before + __popc(mask);
  // slot `lane` takes the passing candidate of rank lane - before
  int rank = lane - before;
  stage_from(st, ck, ci, mask, rank, rank >= 0 && lane < total);
  if (total < min(k, 32)) {
    st.n = total;
    return;
  }
  if (lane >= total) {
    st.key = CUDART_INF_F;
    st.id = INT_MAX;
  }
  buf.merge(st.key, st.id, lane, k, thr_k, thr_i);
  // candidates that did not fit start the next stage
  st.n = max(total - 32, 0);
  stage_from(st, ck, ci, mask, lane + 32 - before, lane < st.n);
}

// Merge what is staged; call once after the last offer.
template <class Buffer>
__device__ __forceinline__ void flush(Buffer& buf, Stage& st, int lane, int k,
                                      float& thr_k, int& thr_i) {
  if (st.n == 0) return;
  if (lane >= st.n) {
    st.key = CUDART_INF_F;
    st.id = INT_MAX;
  }
  buf.merge(st.key, st.id, lane, k, thr_k, thr_i);
  st.n = 0;
}

}  // namespace raft_tpu_torch
