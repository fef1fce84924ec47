// K6: phase 1 of the two-phase fused kNN — per index tile, its 128
// smallest squared-L2 distances with global ids.
//
// Replaces raft_tpu/ops/knn_tile.py:474 fused_knn_twophase (body
// _knn_twophase_kernel :383, tile selection tile_local_topk :208).  For
// each query and each index tile of bn rows (bn a multiple of 128, from
// the JAX tile_geometry), the tile's 128 smallest of max(qn + xn - 2 q.x,
// 0), ascending by (distance, id), written to part[q, tile * 128 ...];
// a slot with no finite key is (+inf, -1).  Phase 2, one exact select of k
// over the (nq, n_tiles * 128) candidates, is select_tile.cu (K2) plus a
// gather of the ids, in the wrapper.
//
// What bounds it on an H100: the same distance work as K1, 2*nq*n*d
// operations in 3xTF32 on the tensor cores (the float32-faithful form of
// the JAX precision="highest" contract, knn_tile.cuh): at 1M x 128 with
// 1024 queries, 3 x 2.6e11 TF32 operations, 1.6 ms at 495 TFLOP/s, against
// 0.5 GB of index read and 0.5 GB of candidates written at bn = 2048 (0.3
// ms at 3.35 TB/s).  Its own cost is selection: no state crosses index
// tiles, so every tile's buffer starts cold and takes at least 128 of its
// bn candidates (about 128 * (1 + ln(bn / 128)) on random data) where K1's
// warm buffer takes a few.
//
// Design: K1's body (knn_tile.cuh), whose selection warps run beside the
// tensor cores, with the JAX tiles as its parts: a block owns a query tile
// and a run of whole JAX tiles, writes each tile's sorted top-128 to the
// part buffers when its last 64-row sub-tile has passed, and starts the
// next tile with cold buffers.  The grid is sized to the card (one block
// per SM: 16 query tiles x 8 runs of 62 tiles at the 1M, bn = 2048 shape),
// not one block per JAX tile, so that a block's pipeline fills once.
#include "knn_tile.cuh"

namespace raft_tpu_torch {
namespace {

constexpr int kBlocksPerSm = 1;

// Blocks along the index for `units` tiles when `q_tiles` query tiles
// share `sms` SMs: (tiles per block, blocks).  ops/knn_tile.py:index_blocks
// mirrors it.
void index_blocks(int q_tiles, int units, int sms, int* per_block, int* blocks) {
  int want = kBlocksPerSm * sms / q_tiles;
  want = want < 1 ? 1 : want > units ? units : want;
  *per_block = (units + want - 1) / want;
  *blocks = (units + *per_block - 1) / *per_block;
}

}  // namespace
}  // namespace raft_tpu_torch

// Q (nq, d), X (n, d), qn (nq,), xn (n,): float32, row-major, contiguous,
// 16-byte aligned, d a multiple of 8.  out_d / out_i: (nq, n_tiles, 128),
// n_tiles = ceil(n / bn), bn a multiple of 64.  bf16: 0 for 3xTF32
// products, 1 for products of the operands rounded to bfloat16 (the JAX
// precision="default", knn_tile.cuh).  Returns cudaGetLastError().
extern "C" int knn_twophase_launch(const void* Q, const void* X, const void* qn,
                                   const void* xn, int nq, int n, int d, int bn, int bf16,
                                   void* out_d, void* out_i,
                                   void* stream RAFT_TPU_PHASES_PARAM) {
  using namespace raft_tpu_torch;
  constexpr int kPad = 128;  // the JAX kpad: every tile keeps 128
  const int n_q = block_q(d);
  if (bn < kBN || n < 1 || nq < 1) return (int)cudaErrorInvalidValue;
  int dev, sms;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const int n_tiles = (n + bn - 1) / bn;
  int per_block, blocks;
  index_blocks((nq + n_q - 1) / n_q, n_tiles, sms, &per_block, &blocks);
  KnnArgs a{(const float*)Q, (const float*)X, (const float*)qn, (const float*)xn,
            nq, n, d, kPad, bn, per_block, n_tiles, (float*)out_d, (int*)out_i, {}};
  RAFT_TPU_SET_PHASES(a);
  cudaStream_t s = (cudaStream_t)stream;
  return (int)(bf16 ? launch<kTileParts, true>(blocks, s, a)
                    : launch<kTileParts, false>(blocks, s, a));
}
