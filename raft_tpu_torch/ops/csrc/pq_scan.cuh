// What both routes of K7 share (pq_scan.cu's kernel for codebooks held in
// shared memory, pq_scan_wide.cu's for wider rows): the block of 512
// threads, the sort area of 64-bit keys (distance bits << 32 | id) with its
// bitonic sort, and a thread's row (its id and uint8 codes) and probe.
// Both include it at the top; its names join raft_tpu_torch's anonymous
// namespace of the file.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace raft_tpu_torch {
namespace {

constexpr int kThreads = 512;
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned long long kFiller = 0xffffffffffffffffull;

__device__ __forceinline__ unsigned long long make_key(float d, int id) {
  return (unsigned long long)__float_as_uint(d) << 32 | (unsigned)id;
}

// The sort area: the top list [0, KC), then the buffer of candidates,
// which takes a segment of a probe's rows without a merge: a list's rows
// go through in segments of whole rounds that fit it.
constexpr int kArea = 2048;
template <int KC>
struct Sel {
  static constexpr int kRoom = kArea - KC;
  static constexpr int kSegment = kRoom / kThreads * kThreads;
};

// Bitonic sort of keys[0, n) ascending, n a power of two; every thread
// of the block calls it.  A warp's compare-exchanges at strides up to 32
// stay inside 64-key blocks of its own, so those stages need only the
// warp's barrier (the last stage of each size ends with the block's).
__device__ void sort_keys(unsigned long long* keys, int n) {
  for (int size = 2; size <= n; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int t = threadIdx.x; t < (n >> 1); t += kThreads) {
        const int lo = 2 * t - (t & (stride - 1));
        const int hi = lo + stride;
        const unsigned long long a = keys[lo], b = keys[hi];
        if ((a > b) == ((lo & size) == 0)) {
          keys[lo] = b;
          keys[hi] = a;
        }
      }
      if (stride >= 64 || stride == 1) {
        __syncthreads();
      } else {
        __syncwarp();
      }
    }
  }
}

// One row a thread: its id (-1 where the round has no row for it) and its
// codes, zero where it has none.
template <int NCH>
struct Row {
  int id;
  uint4 c[NCH];
};

struct Probe {
  const int* slots;  // the list's slots (max_slots, -1 padded)
  int rows;          // its valid slots x cap
};

}  // namespace
}  // namespace raft_tpu_torch
