// Hopper (sm_90a) primitives for the fused kNN kernels (knn_tile.cuh):
// mbarriers, 2-D tensor copies (cp.async.bulk.tensor, TMA), warpgroup matrix
// multiplies in TF32 with A from registers and B from shared memory
// (wgmma.mma_async m64nNk8), the TF32 big/small split of a float32, and
// register reallocation between warpgroups (setmaxnreg), and the SM's cycle
// counter for the phase-timed build.  Raw PTX, no
// CUTLASS, so that the plain-C build stays at seconds.
#pragma once

#include <cstdint>
#include <cuda.h>
#include <cuda_runtime.h>

namespace raft_tpu_torch {
namespace sm90 {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarriers ---------------------------------------------------------

__device__ __forceinline__ void bar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

// Make the initialised barriers visible to every thread and to the async
// proxy (the tensor copies that complete on them).
__device__ __forceinline__ void bar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// Arrive where `pred` holds, as one predicated instruction: a branch
// around it would be divergent code in a warpgroup that has wgmmas in
// flight, which the compiler answers by serialising them.
__device__ __forceinline__ void bar_arrive_if(uint64_t* bar, bool pred) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.u32 p, %1, 0;\n"
      "@p mbarrier.arrive.shared::cta.b64 _, [%0];\n}\n" ::"r"(smem_addr(bar)),
      "r"((uint32_t)pred)
      : "memory");
}

// Arrive and add `bytes` to the transaction count the phase waits for.
__device__ __forceinline__ void bar_arrive_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// Wait until the phase of the given parity has completed.  Each try may
// suspend the thread until the phase completes, for up to 1 ms (the
// hint), so that a waiting warp takes no issue slots from the working
// ones.  The loop is one asm block, so that the compiler sees no
// divergent branch (see bar_arrive_if).  A wait of 2^32 cycles (two
// seconds and more) can only be a broken pipeline: it traps, so that the
// launch fails with an error instead of holding the card.
__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p_done, p_stuck;\n.reg .u64 r_t0, r_t1;\n"
      "mov.u64 r_t0, %%clock64;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p_done, [%0], %1, 1000000;\n"
      "@p_done bra LAB_DONE;\n"
      "mov.u64 r_t1, %%clock64;\n"
      "sub.u64 r_t1, r_t1, r_t0;\n"
      "setp.gt.u64 p_stuck, r_t1, 4294967296;\n"
      "@p_stuck trap;\n"
      "bra LAB_WAIT;\n"
      "LAB_DONE:\n}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// The SM's cycle counter.  The memory clobber keeps the read in its place
// among the loads and stores around it.
__device__ __forceinline__ uint64_t clock_now() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%clock64;" : "=l"(t)::"memory");
  return t;
}

// bar_wait that returns the cycles it took, from its first try to the
// completed one.
__device__ __forceinline__ uint64_t bar_wait_cycles(uint64_t* bar, uint32_t parity) {
  uint64_t waited;
  asm volatile(
      "{\n.reg .pred p_done, p_stuck;\n.reg .u64 r_t0, r_t1;\n"
      "mov.u64 r_t0, %%clock64;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p_done, [%1], %2, 1000000;\n"
      "mov.u64 r_t1, %%clock64;\n"
      "sub.u64 %0, r_t1, r_t0;\n"
      "@p_done bra LAB_DONE;\n"
      "setp.gt.u64 p_stuck, %0, 4294967296;\n"
      "@p_stuck trap;\n"
      "bra LAB_WAIT;\n"
      "LAB_DONE:\n}\n"
      : "=l"(waited)
      : "r"(smem_addr(bar)), "r"(parity)
      : "memory");
  return waited;
}

// Wait for the 128 threads of warps 0-3, the multiplying warpgroup, on
// named barrier 1 (__syncthreads takes barrier 0).
__device__ __forceinline__ void mma_bar_sync() { asm volatile("bar.sync 1, 128;" ::: "memory"); }

// ---- tensor copies (TMA) -----------------------------------------------

// Copy the box at (x, y) (innermost coordinate first) of the tensor that
// `map` describes into shared memory at `dst`; completion counts on
// `bar`'s transactions.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, int x, int y,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];"
      ::"r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y),
        "r"(smem_addr(bar))
      : "memory");
}

// Order this thread's generic-proxy writes to shared memory before later
// reads by the async proxy (wgmma's operand fetch).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// ---- TF32 --------------------------------------------------------------

// Round a float32 to TF32 (10 mantissa bits) to nearest, ties away from
// zero: the rounding of cvt.rna.tf32.f32, done as integer add-and-mask,
// which issues at twice the rate of the conversion unit (finite inputs
// round the same).  The empty volatile asm keeps the result before the
// wgmma fence that follows it; sunk past it, each step's registers would
// be written inside the wgmma pipeline and the compiler would fence (and
// stall) every step.
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r = (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
  asm volatile("" : "+r"(r));
  return r;
}

// x = big + small to about 2^-22 relative: big = tf32(x), small =
// tf32(x - big), both rounded to nearest (x - big is exact in float32).
__device__ __forceinline__ void split_tf32(float x, uint32_t& big, uint32_t& small) {
  big = tf32_rna(x);
  small = tf32_rna(x - __uint_as_float(big));
}

// Round a float32 to bfloat16, to nearest even, as the bits of a float32
// with the low 16 zero (torch's rounding for finite values).  A bfloat16
// value is a TF32 value, so its TF32 small half is 0 and the tensor cores
// take it exactly; the volatile asm is tf32_rna's.
__device__ __forceinline__ uint32_t bf16_rne(float x) {
  const uint32_t u = __float_as_uint(x);
  uint32_t r = (u + 0x7FFFu + ((u >> 16) & 1u)) & 0xFFFF0000u;
  asm volatile("" : "+r"(r));
  return r;
}

// ---- wgmma ---------------------------------------------------------------

// Descriptor of a K-major operand without swizzle: 8-row x 16-byte core
// matrices, `lbo` bytes apart along K and `sbo` bytes apart along M/N.
__device__ __forceinline__ uint64_t desc_kmajor(const void* p, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((smem_addr(p) & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(kPending) : "memory");
}

// Keep the compiler from moving accesses of `r` across a wgmma wait or
// fence.
__device__ __forceinline__ void fence_operand(float& r) { asm volatile("" : "+f"(r)::"memory"); }
__device__ __forceinline__ void fence_operand(uint64_t& r) { asm volatile("" : "+l"(r)::"memory"); }

template <int kRegs>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(kRegs));
}

template <int kRegs>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(kRegs));
}

// D (64 x N, float32, the wgmma accumulator layout) += A (64 x 8, tf32 in
// registers, the m16n8k8 fragment of each warp's 16 rows) * B (8 x N, tf32,
// K-major in shared memory, `desc`).  The accumulate flag is an immediate:
// a register operand defined after the wgmma fence would make the compiler
// fence again before each instruction.
template <int N>
struct Wgmma;

template <>
struct Wgmma<16> {
  static __device__ __forceinline__ void mma(float (&d)[8], const uint32_t (&a)[4],
                                             uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7}, "
        "{%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc));
  }
};

template <>
struct Wgmma<32> {
  static __device__ __forceinline__ void mma(float (&d)[16], const uint32_t (&a)[4],
                                             uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "{%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
          "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc));
  }
};

template <>
struct Wgmma<64> {
  static __device__ __forceinline__ void mma(float (&d)[32], const uint32_t (&a)[4],
                                             uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
          "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
          "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
          "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc));
  }
};

}  // namespace sm90
}  // namespace raft_tpu_torch
