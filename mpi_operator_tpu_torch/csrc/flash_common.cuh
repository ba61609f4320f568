// Shared pieces of the flash-attention kernels. Each kernel has one body
// (flash_fwd.cuh, flash_bwd_dq.cuh, flash_bwd_dkv.cuh) and two C entry
// points, one per layout: the flat kernels (flash_fwd.cu, flash_bwd_dq.cu,
// flash_bwd_dkv.cu) and the [B*H, S, D] kernels (flash_bhsd_fwd.cu,
// flash_bhsd_bwd_dq.cu, flash_bhsd_bwd_dkv.cu).
//
// Layout: the body reads every operand through strides (Geom). Element d of
// row r of head h of batch b sits at b * batch + h * head + r * row + d:
// - flat, the projection layout [B, S, nh * D] that the q/k/v projections
//   produce: batch = S * nh * D, head = D, row = nh * D; lse and delta are
//   f32 [B, Sq, H]. No transposes surround these kernels.
// - bhsd, [B*H, S, D] with kv [B*Hkv, S, D]: the entry point views it as
//   B*Hkv batches of groups = H / Hkv q heads that share one kv head, so q
//   row b*H + h reads kv row (b*H + h) / groups, as the JAX index map
//   b // groups does; lse is f32 [B*H, Sq].
// No host-side padding: rows past the sequence length are masked inside
// the kernels.
//
// Two kinds of body:
// - bf16 (forward, dq and dk/dv): tensor-core bodies (wgmma, cp.async
//   rings; flash_fwd.cuh, flash_bwd_dq.cuh and flash_bwd_dkv.cuh say their
//   tiles);
// - f32 (forward, dq and dk/dv): SIMT bodies, f32 FMA on tiles staged in
//   shared memory, with the thread map below. f32 has no tensor-core path
//   of its precision (TF32 keeps 10 mantissa bits).
//
// SIMT tiles: 64 rows of q by 64 rows of k, 256 threads. Thread t owns tile
// rows 4 * (t / 16) + i (i < 4) and tile columns (t % 16) + 16 * j (j < 4);
// for the [rows, D] accumulators it owns head-dim columns (t % 16) + 16 * j
// (j < 8, so D <= 128). The 16 threads that share a row are one half of a
// warp, so row max / row sum are four xor-shuffles.
//
// Masking follows the JAX kernels exactly:
// finite NEG_INF = -1e30 (never -inf, so inf - inf never makes a NaN),
// p = exp(visible ? s - m : NEG_INF), and a fully masked row gives
// out = 0, lse = NEG_INF. Without ids the causal mask is bottom-right
// aligned, col <= row + (kv_len - q_len); with ids (bhsd only) a pair is
// visible iff col_ids[col] <= row_ids[row], whatever causal says. The
// bound checks row < q_len, col < kv_len take the place of JAX's +-2^30
// padding ids.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include <initializer_list>

#include "hopper.cuh"

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
constexpr float LOG2E = 1.4426950408889634f;  // exp(x) = exp2(x * LOG2E)
constexpr float LN2 = 0.6931471805599453f;
constexpr int MAX_GRID_YZ = 65535;

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

// Element offsets of (batch, head, row) in one operand.
struct Strides {
  size_t batch, head, row;
  __host__ __device__ __forceinline__ size_t at(int b, int h, int r) const {
    return (size_t)b * batch + (size_t)h * head + (size_t)r * row;
  }
};

// What a launch computes: q head h reads kv head h / (H / Hkv); the SIMT
// grids are (q or k tiles, H, B), the tensor-core grids (B * H or B * Hkv,
// tiles). qs covers q, out, do and dq; kvs k, v, dk and dv; stats lse and
// delta.
struct Geom {
  int B, H, Hkv, q_len, kv_len, D;
  float scale;
  int causal;
  const int* row_ids;  // [q_len] or null
  const int* col_ids;  // [kv_len] or null
  Strides qs, kvs, stats;
};

inline Geom flat_geom(int B, int q_len, int kv_len, int H, int Hkv, int D,
                      float scale, int causal) {
  const size_t d = (size_t)D;
  return Geom{B, H, Hkv, q_len, kv_len, D, scale, causal, nullptr, nullptr,
              {(size_t)q_len * H * d, d, (size_t)H * d},
              {(size_t)kv_len * Hkv * d, d, (size_t)Hkv * d},
              {(size_t)q_len * H, 1, (size_t)H}};
}

inline Geom bhsd_geom(int BH, int BHkv, int q_len, int kv_len, int D,
                      float scale, int causal, const void* row_ids,
                      const void* col_ids) {
  // H = 0 (refused by bad_shape) when the kv rows do not divide the q rows.
  const int groups = (BHkv > 0 && BH % BHkv == 0) ? BH / BHkv : 0;
  const size_t d = (size_t)D;
  return Geom{BHkv, groups, 1, q_len, kv_len, D, scale, causal,
              static_cast<const int*>(row_ids),
              static_cast<const int*>(col_ids),
              {(size_t)groups * q_len * d, (size_t)q_len * d, d},
              {(size_t)kv_len * d, 0, d},
              {(size_t)groups * q_len, (size_t)q_len, 1}};
}

inline bool bad_shape(const Geom& g) {
  return g.B < 1 || g.B > MAX_GRID_YZ || g.H < 1 || g.H > MAX_GRID_YZ ||
         g.Hkv < 1 || g.H % g.Hkv != 0 || g.q_len < 1 || g.kv_len < 1 ||
         g.D < 1 || g.D > MAX_D ||
         (g.row_ids == nullptr) != (g.col_ids == nullptr);
}

// 64 rows of one head into shared memory as f32 [64][D + 1] (the +1 keeps
// column walks free of bank conflicts). Rows at or past seq_len read as
// zero.
template <typename T>
__device__ void load_tile(float* dst, const T* __restrict__ src,
                          const Strides& s, int b, int head, int row0,
                          int seq_len, int D) {
  const int ld = D + 1;
  for (int idx = threadIdx.x; idx < 64 * D; idx += THREADS) {
    const int r = idx / D;
    const int c = idx - r * D;
    const int row = row0 + r;
    float x = 0.f;
    if (row < seq_len) x = to_f(src[s.at(b, head, row) + c]);
    dst[r * ld + c] = x;
  }
}

// ROWS rows of one head (from row0) of a bf16 operand into a swizzled
// shared tile DP columns wide (hopper.cuh), by 16-byte cp.async from the
// NT threads of the block; the caller commits. Rows at or past seq_len and
// columns at or past D (D a multiple of 8) are zero-filled, so they add
// nothing to any product.
template <int ROWS, int DP, int NT>
__device__ __forceinline__ void load_tile_async(
    uint32_t dst, const __nv_bfloat16* __restrict__ src, const Strides& s,
    int b, int head, int row0, int seq_len, int D) {
  constexpr int CPR = DP / 8;  // 16-byte chunks per row
  static_assert((ROWS * CPR) % NT == 0, "whole chunks per thread");
#pragma unroll
  for (int n = 0; n < ROWS * CPR / NT; ++n) {
    const int idx = n * NT + (int)threadIdx.x;
    const int r = idx / CPR;
    const int c = idx % CPR;
    const int row = row0 + r;
    const bool ok = row < seq_len && c * 8 < D;
    hopper::cp_async16(dst + hopper::swizzled(ROWS, r, c),
                       ok ? src + s.at(b, head, row) + c * 8 : src, ok);
  }
}

// 64 entries of one head of an f32 statistic (lse, delta).
__device__ __forceinline__ void load_stats(float* dst,
                                           const float* __restrict__ src,
                                           const Strides& s, int b, int head,
                                           int row0, int seq_len) {
  for (int r = threadIdx.x; r < 64; r += THREADS) {
    const int row = row0 + r;
    dst[r] = row < seq_len ? src[s.at(b, head, row)] : 0.f;
  }
}

__device__ __forceinline__ bool visible(const Geom& g, int row, int col) {
  if (row >= g.q_len || col >= g.kv_len) return false;
  if (g.row_ids != nullptr) return g.col_ids[col] <= g.row_ids[row];
  return !g.causal || col <= row + (g.kv_len - g.q_len);
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

// Number of k tiles (of TK rows) a q tile of TQ rows starting at q0 must
// visit: with causal masking the tiles past the last visible column are
// dead and skipped. With ids the live set depends on the data, so every
// tile is visited.
template <int TQ = BQ, int TK = BK>
__device__ __forceinline__ int live_k_tiles(const Geom& g, int q0) {
  int end = g.kv_len;
  if (g.causal && g.row_ids == nullptr)
    end = min(g.kv_len, q0 + TQ + (g.kv_len - g.q_len));
  return end > 0 ? (end + TK - 1) / TK : 0;
}

// First q tile (of TQ rows) that can see any column of a k tile starting
// at k0.
template <int TQ = BQ>
__device__ __forceinline__ int first_live_q_tile(const Geom& g, int k0) {
  if (!g.causal || g.row_ids != nullptr) return 0;
  return max(0, k0 - (g.kv_len - g.q_len)) / TQ;
}

// True when every (row, col) of the q tile [q0, q0 + TQ) x k tile
// [k0, k0 + TK) is visible, so the tile needs no mask: no ids, both tiles
// inside their sequences, and (causal) the tile's last column visible to
// its first row. Uniform across a block.
template <int TQ, int TK>
__device__ __forceinline__ bool fully_visible(const Geom& g, int q0, int k0) {
  return g.row_ids == nullptr && q0 + TQ <= g.q_len && k0 + TK <= g.kv_len &&
         (!g.causal || k0 + TK - 1 <= q0 + (g.kv_len - g.q_len));
}

// The bf16 tensor-core bodies read 16-byte chunks of rows: the head dim
// must be a multiple of 8 and every operand 16-byte aligned.
inline bool bad_tc_operands(const Geom& g,
                            std::initializer_list<const void*> ptrs) {
  if (g.D % 8 != 0) return true;
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return true;
  return false;
}

}  // namespace flash
