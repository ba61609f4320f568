// Hopper (sm_90a) building blocks of the tensor-core flash bodies
// (flash_fwd.cuh, flash_bwd_dq.cuh, flash_bwd_dkv.cuh): 16-byte cp.async
// with zero fill, the 128-byte swizzle of shared-memory tiles, wgmma
// matrix descriptors, and the one wgmma shape the bodies issue, m64n64k16
// (bf16 in, f32 accumulate), with A from shared memory or from registers.
//
// Shared-memory tiles. An operand tile of R rows by W bf16 columns (W a
// multiple of 64) is stored as W / 64 column blocks, each R rows of 128
// bytes, block c64 at byte c64 * R * 128. Within a block the 16-byte chunk
// c of row r sits at chunk c ^ (r % 8): the 128-byte swizzle that wgmma's
// SWIZZLE_128B layout reads. Every block starts 1024-byte aligned.
//
// - K-major operand (the reduction runs along the row, as q, k, v and do
//   are stored for q k^T, do v^T, k q^T and v do^T): a k16 step is 32
//   bytes within the 128-byte row, so step kk starts at block kk / 4, byte
//   32 * (kk % 4); groups of 8 rows lie 1024 bytes apart (SBO).
// - MN-major operand (the reduction runs down the rows, as v, k, do and q
//   are stored for p v, ds k, p^T do and ds^T q): a k16 step is 16 rows,
//   2048 bytes; the two groups of 8 rows in it lie 1024 bytes apart. Each
//   instruction covers one 64-column block (n = 64), so the stride
//   between column blocks is never read from the descriptor.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace hopper {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Byte offset of the 16-byte chunk `chunk` (8 bf16 columns) of row r in
// a swizzled tile of `rows` rows.
__device__ __forceinline__ uint32_t swizzled(int rows, int r, int chunk) {
  return (uint32_t)((chunk >> 3) * rows * 128 + r * 128 +
                    (((chunk & 7) ^ (r & 7)) << 4));
}

// cp.async of 16 (or 4) bytes; when !valid nothing is read and the
// destination is zero-filled (src must still be a mapped address).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// Makes this thread's completed cp.async writes visible to wgmma, which
// reads shared memory through the async proxy. Then a barrier.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// wgmma matrix descriptor, SWIZZLE_128B: start address, leading and
// stride byte offsets (all in 16-byte units), layout type 1 in bits 62-63.
__device__ __forceinline__ uint64_t descriptor(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}
__device__ __forceinline__ uint64_t k_major(uint32_t addr) {
  return descriptor(addr, 16, 1024);  // LBO unused for a swizzled K-major
}
__device__ __forceinline__ uint64_t mn_major(uint32_t addr) {
  // The 8-row group stride is 1024 bytes whichever of the two offsets the
  // unit reads for it; with one 64-column block per instruction the other
  // (the column-block stride) is never used.
  return descriptor(addr, 1024, 1024);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving reads or writes of registers that an
// in-flight wgmma owns across the fence (it sees the asm's operands as
// consumed and produced at the issue point).
__device__ __forceinline__ void fence_regs(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
__device__ __forceinline__ void fence_regs(uint32_t (&a)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(a[i])::"memory");
}

#define HOPPER_ACC32(d)                                                    \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),  \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),         \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),     \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),     \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),     \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),     \
      "+f"(d[31])
#define HOPPER_D32                                                           \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31}"

// d (+)= A B for a warpgroup: A [64, 16] K-major and B [16, 64] K-major,
// both from shared memory; accumulate = 0 overwrites d.
__device__ __forceinline__ void mma_ss(float (&d)[32], uint64_t a,
                                       uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " HOPPER_D32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : HOPPER_ACC32(d)
      : "l"(a), "l"(b), "r"(accumulate));
}

// d += A B: A [64, 16] from registers (a_fragment), B [16, 64] MN-major
// from shared memory.
__device__ __forceinline__ void mma_rs(float (&d)[32], const uint32_t (&a)[4],
                                       uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " HOPPER_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : HOPPER_ACC32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// The m64n64 f32 accumulator of a warpgroup: warp w holds rows 16w..16w+15;
// lane l holds, for each 8-column block j, element i = 4j + 2hh + e at row
// 16w + l/4 + 8hh, column 8j + 2(l%4) + e.
__device__ __forceinline__ int acc_row(int i) { return ((i >> 1) & 1) * 8; }
__device__ __forceinline__ int acc_col(int i) { return (i >> 2) * 8 + (i & 1); }

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The bf16 A fragments of the four k16 steps (a[kk]: accumulator columns
// 16kk..16kk+15) of an m64n64 accumulator: the register A operand's layout
// is the accumulator's, so no data moves between lanes.
__device__ __forceinline__ void a_fragments(const float (&d)[32],
                                            uint32_t (&a)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    a[kk][0] = pack_bf16(d[8 * kk + 0], d[8 * kk + 1]);
    a[kk][1] = pack_bf16(d[8 * kk + 2], d[8 * kk + 3]);
    a[kk][2] = pack_bf16(d[8 * kk + 4], d[8 * kk + 5]);
    a[kk][3] = pack_bf16(d[8 * kk + 6], d[8 * kk + 7]);
  }
}

// Sum / max over the four lanes that share an accumulator row.
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

}  // namespace hopper
