// K7's ADC table layout and each lane's walk over it (pq_scan.cu), for
// code rows of NCH 16-byte chunks (16, 32 or 64 bytes), and the wide
// route's (pq_scan_wide.cu, rows of 32, 64 or 96 bytes; below).  Plain C++ with
// no CUDA dependency, so that the host can compile it too: the CPU tests
// (tests/test_torch_pq_scan.py) build it with g++ and check the bank rule
// on these functions, the ones the kernel calls.
//
// A table is 256 codeword rows of 64 floats.  Entry (m, j) of copy c lies
// at float j * 64 + table_column<NCH>(m, c), and a float's shared-memory
// bank is its index mod 32, so an entry's bank is set by its subspace and
// copy, never by its codeword.  Column bits 0-2 are the subspace's bits
// 0-2; bits 3-4 are the two bits of (subspace, copy) that a lane's bits
// 3-4 flip in its walk: the row's 16-byte chunk (subspace bits 4-5) as
// far as the row has chunks, then the pair of words (subspace bit 3), then
// the copy; what is left (subspace bit 3 of a 64-byte row) is bit 5.  Rows
// of 16 bytes keep two copies.
//
// The walk: at step p lane l reads column table_column<NCH>(p, 0) ^ l,
// the row's subspace column_subspace<NCH>(that column), which is the byte
// walk_byte<NCH>(p, l) of its row.  So at every step the 32 lanes of a
// warp read 32 columns that differ in their low five bits, 32 banks, and
// each lane sums each subspace of its row once.
#pragma once

#ifdef __CUDACC__
#define PQ_HD __host__ __device__
#else
#define PQ_HD
#endif

namespace raft_tpu_torch {
namespace pq_layout {

constexpr int kColumns = 64;  // floats of a codeword's table row: one a (subspace, copy)

template <int NCH>
constexpr int kCopies = NCH == 1 ? 2 : 1;

template <int NCH>
PQ_HD constexpr int table_column(int m, int c) {
  return NCH == 4   ? (m & 7) | (m >> 4) << 3 | (m & 8) << 2
         : NCH == 2 ? (m & 7) | (m & 16) >> 1 | (m & 8) << 1
                    : (m & 15) | c << 4;
}

// The subspace of a column (its copy is column >> 4 at NCH 1, else 0).
template <int NCH>
PQ_HD constexpr int column_subspace(int col) {
  return NCH == 4   ? (col & 7) | (col >> 3 & 3) << 4 | (col >> 5) << 3
         : NCH == 2 ? (col & 7) | (col >> 3 & 1) << 4 | (col >> 4) << 3
                    : col & 15;
}

// A lane's walk, in the terms in which adc_sum reads a row: the row's
// chunks are loaded chunk ^ lane_chunk first, a chunk's two pairs of words
// swapped where lane_pair, a pair's two words where lane_swap, and the
// byte i of a word read is i ^ lane (mod 4).
template <int NCH>
PQ_HD constexpr int lane_chunk(int lane) {
  return (lane >> 3) & (NCH - 1);
}
template <int NCH>
PQ_HD constexpr bool lane_pair(int lane) {
  return NCH == 2 ? (lane & 16) != 0 : NCH == 1 ? (lane & 8) != 0 : false;
}
PQ_HD constexpr bool lane_swap(int lane) { return (lane & 4) != 0; }

// The byte of its row that lane reads at step p = 8h + 4b + i: word b of
// pair h (the chunk's lower pair at even h), as adc_sum takes them.
template <int NCH>
PQ_HD constexpr int walk_byte(int p, int lane) {
  const int h = p >> 3, b = (p >> 2) & 1, i = p & 3;
  return 16 * ((h >> 1) ^ lane_chunk<NCH>(lane)) + 8 * ((h & 1) ^ (lane_pair<NCH>(lane) ? 1 : 0)) +
         4 * (b ^ (lane_swap(lane) ? 1 : 0)) + ((i ^ lane) & 3);
}

// The build: lane l of a warp stores the entries of column l (subspace
// column_subspace(l), copy l >> 4 at NCH 1) and, in the unrolled builds,
// a sibling at a fixed offset: column l + 32 of a 64-byte row (subspace
// m + 8), else codeword j + 128 of the same subspace.  The subspace whose
// residual and codebook that entry reads, or 0 where the subspace is past
// M (the entry is stored nowhere, and its reads stay inside the
// codebooks).
template <int NCH>
PQ_HD constexpr int build_subspace(int lane, bool sibling) {
  return column_subspace<NCH>(lane) + (NCH == 4 && sibling ? 8 : 0);
}
template <int NCH>
PQ_HD constexpr int build_reads(int lane, bool sibling, int M) {
  return build_subspace<NCH>(lane, sibling) < M ? build_subspace<NCH>(lane, sibling) : 0;
}

// The wide route (pq_scan_wide.cu): code rows of 32, 64 or 96 bytes, a
// table row of as many floats, one a subspace.  Each 32-byte group g of a
// row is laid out as a 32-byte row above, offset by 32 g: subspace m's
// column is wide_column(m), whose bank is that of table_column<2>(m mod
// 32), and at step p lane l reads column wide_walk_column(p, l), the
// subspace wide_subspace(that column), which is the byte wide_walk_byte(p,
// l) of its row (group p / 32, loaded and walked as NCH 2 walks a row).
// So every step reads 32 banks, and each lane sums each subspace once.
PQ_HD constexpr int wide_column(int m) { return (m & ~31) | table_column<2>(m & 31, 0); }
PQ_HD constexpr int wide_subspace(int col) { return (col & ~31) | column_subspace<2>(col & 31); }
PQ_HD constexpr int wide_walk_column(int p, int lane) {
  return (p & ~31) | (table_column<2>(p & 31, 0) ^ lane);
}
PQ_HD constexpr int wide_walk_byte(int p, int lane) {
  return (p & ~31) | walk_byte<2>(p & 31, lane);
}

}  // namespace pq_layout
}  // namespace raft_tpu_torch
