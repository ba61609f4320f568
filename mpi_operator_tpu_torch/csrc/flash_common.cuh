// Shared pieces of the three flat flash-attention kernels (flash_fwd.cu,
// flash_bwd_dq.cu, flash_bwd_dkv.cu).
//
// Layout: every operand stays in the projection layout [B, S, nh * D] that
// the q/k/v projections produce; head `h` of row `s` starts at
// ((b * S + s) * nh + h) * D. lse and delta are f32 [B, Sq, H]. No
// transposes and no host-side padding: rows past the sequence length are
// masked inside the kernels.
//
// Tiles: 64 rows of q by 64 rows of k, 256 threads. Thread t owns tile
// rows 4 * (t / 16) + i (i < 4) and tile columns (t % 16) + 16 * j (j < 4);
// for the [rows, D] accumulators it owns head-dim columns (t % 16) + 16 * j
// (j < 8, so D <= 128). The 16 threads that share a row are one half of a
// warp, so row max / row sum are four xor-shuffles.
//
// Arithmetic is f32 FMA on tiles staged in shared memory as f32 (bf16
// inputs are widened on load). Masking follows the JAX kernels exactly:
// finite NEG_INF = -1e30 (never -inf, so inf - inf never makes a NaN),
// p = exp(visible ? s - m : NEG_INF), bottom-right-aligned causal mask
// col <= row + (kv_len - q_len), and a fully masked row gives out = 0,
// lse = NEG_INF.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

#ifndef FLASH_BLOCK_Q
#define FLASH_BLOCK_Q 64
#endif
#ifndef FLASH_BLOCK_K
#define FLASH_BLOCK_K 64
#endif

namespace flash {

constexpr int BQ = FLASH_BLOCK_Q;
constexpr int BK = FLASH_BLOCK_K;
static_assert(BQ == 64 && BK == 64, "the thread map assumes 64 x 64 tiles");
constexpr int THREADS = 256;
constexpr int RPT = 4;        // tile rows per thread (64 rows / 16 row groups)
constexpr int CPT = 4;        // tile columns per thread (64 columns / 16 lanes)
constexpr int MAX_D = 128;
constexpr int DPT = MAX_D / 16;  // head-dim columns per thread
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ size_t offset(int b, int row, int seq_len, int nh,
                                         int head, int D) {
  return (((size_t)b * seq_len + row) * nh + head) * (size_t)D;
}

// 64 rows of one head from a [B, seq_len, nh * D] tensor into shared memory
// as f32 [64][D + 1] (the +1 keeps column walks free of bank conflicts).
// Rows at or past seq_len read as zero.
template <typename T>
__device__ void load_tile(float* dst, const T* __restrict__ src, int b,
                          int row0, int seq_len, int nh, int head, int D) {
  const int ld = D + 1;
  for (int idx = threadIdx.x; idx < 64 * D; idx += THREADS) {
    const int r = idx / D;
    const int c = idx - r * D;
    const int row = row0 + r;
    float x = 0.f;
    if (row < seq_len) x = to_f(src[offset(b, row, seq_len, nh, head, D) + c]);
    dst[r * ld + c] = x;
  }
}

// 64 entries of one head from an f32 [B, seq_len, nh] tensor (lse, delta).
__device__ __forceinline__ void load_stats(float* dst,
                                           const float* __restrict__ src,
                                           int b, int row0, int seq_len,
                                           int nh, int head) {
  for (int r = threadIdx.x; r < 64; r += THREADS) {
    const int row = row0 + r;
    dst[r] = row < seq_len ? src[((size_t)b * seq_len + row) * nh + head]
                           : 0.f;
  }
}

__device__ __forceinline__ bool visible(int row, int col, int q_len,
                                        int kv_len, int causal) {
  return row < q_len && col < kv_len &&
         (!causal || col <= row + (kv_len - q_len));
}

// Reductions over the 16 lanes that share a tile row (half a warp).
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Number of k tiles a q tile starting at q0 must visit: with causal masking
// the tiles past the last visible column are dead and skipped.
__device__ __forceinline__ int live_k_tiles(int q0, int q_len, int kv_len,
                                            int causal) {
  int end = kv_len;
  if (causal) end = min(kv_len, q0 + BQ + (kv_len - q_len));
  return end > 0 ? (end + BK - 1) / BK : 0;
}

// First q tile that can see any column of a k tile starting at k0.
__device__ __forceinline__ int first_live_q_tile(int k0, int q_len,
                                                 int kv_len, int causal) {
  if (!causal) return 0;
  return max(0, k0 - (kv_len - q_len)) / BQ;
}

inline bool bad_shape(int B, int q_len, int kv_len, int H, int Hkv, int D) {
  return B < 1 || q_len < 1 || kv_len < 1 || Hkv < 1 || H % Hkv != 0 ||
         D < 1 || D > MAX_D;
}

}  // namespace flash
