// K3: the IVF-Flat probe scan, queries grouped by probed slot.
//
// Replaces raft_tpu/ops/ivf_tile.py:230 fused_ivf_scan (body _ivf_kernel
// :91, selection core topk_update, positions to ids :128).  The function:
// per query, walk its compacted scan list (slots[q], probed slots first,
// -1 padded), take max(qn + |v|^2 - 2 q.v, 0) to every row of each listed
// slot, drop vacant rows (id < 0), and keep the k smallest (distance, scan
// position) pairs; the position j*cap + row maps back to the row's global
// id.  Ties resolve to the earlier step, then the smaller row.  Unfilled
// results are (+inf, -1).
//
// What bounds it on an H100: at the IVF search of 1M x 128 rows in 1,024
// lists (slots of cap 984), nprobe 32, 1,024 queries, each query scans
// about 48 slots: 2*d*rows = 1.2e10 float32 operations, 0.08 ms in 3xTF32
// on the tensor cores, against the distinct slots the batch touches, about
// 0.52 GB, 0.16 ms at 3.35 TB/s.  So the least time is the bytes, read
// once for all the queries that probe a slot.  A kernel that reads each
// query's slots for that query alone reads some 17.6 GB a batch.
//
// Design: the scan lists are inverted (ops/ivf_tile.py:scan_work_list,
// torch ops on the device): the live (query, step) entries, stable-sorted
// by slot, in groups of at most N (ivf_block_q below: 16 at depth 128)
// entries of one slot.  Each group is one item
// of a work list: (first entry, entries, the slot's first row).  This
// kernel is the work-list instance (kIvfItems) of the fused kNN body
// (knn_tile.cuh): a grid of one block per SM walks the items, and for
// each one
//
//   * the multiplying warpgroup gathers the entries' query rows (an
//     entry's output row is q * n_steps + step) and splits them into TF32
//     halves in shared memory (wgmma's B), while the producer streams the
//     slot's cap rows through the TMA ring (a box may start at any row of
//     the (S*cap, d) store);
//   * the distance tile is 3xTF32 on the tensor cores, as K1's;
//   * the selection warps fold each entry's distances into a cold buffer,
//     masking the rows past the slot and the vacant ones, and write its
//     top-k with global ids to the entry's own row (out_rows) of an
//     (nq * n_steps, k) buffer that the wrapper prefilled with (+inf, -1).
//
// So a slot's rows are read once per item, not once per query, and the
// block's start (barriers, setmaxnreg, the ring) is paid once a block.
// The wrapper merges each query's n_steps * k columns with K2
// (select_tile.cu): the layout is step-major and K2 keeps the smaller
// column on ties, so ties resolve to the earlier step, then the smaller
// row (the selection's ids are store rows), as the JAX contract says.
//
// accum_bf16 is a template instance of the same kernel: each operand is
// rounded to bfloat16 where it is split (a bfloat16 value is a TF32 value,
// so its small half is 0) and only big x big is issued, whose products of
// two bfloat16 values are exact in float32, as the JAX accum_bf16 path
// computes them; the norms and every select operation stay float32.
#include "knn_tile.cuh"

// Q (nq, d) and X (n_rows, d) = the slot store (S * cap, d): float32,
// row-major, contiguous, 16-byte aligned, d a multiple of 8; qn (nq,), xn
// (n_rows,) the squared norms; ids (n_rows,) int32, -1 vacant.  The work
// list: items (max_items, 4) int32, n_items (1,) int32 (the items in use,
// read on the device), out_rows (entries,) int32, each q * steps + step; an item's
// entries are at most n_q, 64, 32 or 16 (ivf_block_q(d) by default: the
// query tile of K1 at the depth).  out_d / out_i
// (rows, k), rows the largest out_rows entry and more: each entry's k
// best, ascending; rows no entry names are left alone.  Returns
// cudaGetLastError().
extern "C" int ivf_tile_launch(const void* Q, const void* qn, const void* X, const void* xn,
                               const void* ids, const void* items, const void* n_items,
                               const void* out_rows, int nq, int steps, int n_rows, int d,
                               int cap, int max_items, int n_q, int k, int accum_bf16,
                               void* out_d, void* out_i, void* stream) {
  using namespace raft_tpu_torch;
  if (cap < 1 || n_rows < cap || max_items < 1 || d < 8 || steps < 1) {
    return (int)cudaErrorInvalidValue;
  }
  int blocks;
  cudaError_t err = work_blocks(max_items, &blocks);
  if (err != cudaSuccess) return (int)err;
  const WorkList wl{(const int4*)items, (const int*)n_items, (const int*)out_rows, steps,
                    (const int*)ids, cap};
  KnnArgs a{(const float*)Q, (const float*)X, (const float*)qn, (const float*)xn,
            nq, n_rows, d, k, 0, 0, 0, (float*)out_d, (int*)out_i, wl};
  cudaStream_t s = (cudaStream_t)stream;
  return (int)(accum_bf16 ? launch<kIvfItems, true>(blocks, s, a, n_q)
                          : launch<kIvfItems, false>(blocks, s, a, n_q));
}

// The entries an item holds by default at depth d (a multiple of 8): 16
// where the depth fits whole (to 1216), else the slab tile kDeepQ.  The
// kernel is bound by its selection (each entry starts cold, as K6's JAX
// tiles do), so the tile that keeps all sixteen selection warps busy on
// one row each beats the one that splits each slot box for more queries
// at the search's shape (tools/torch_ivf_profile.py --widths times each
// width; PERF.md section 6).
extern "C" int ivf_block_q(int d) {
  using namespace raft_tpu_torch;
  return whole_depth(16, d) ? 16 : kDeepQ;
}
