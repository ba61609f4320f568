// Shared pieces of the row-normalisation kernels (norm_fwd.cu,
// norm_bwd.cu): LayerNorm (Flax's: f32 statistics, variance
// max(E[x^2] - E[x]^2, 0), f32 scale and bias) and RMSNorm (f32
// rsqrt(E[x^2] + eps), f32 scale), over the last axis of x viewed as
// [M, D], row r at offset r * D.
//
// Thread map (ops/_common.py norm_geometry computes vec and tpr; the
// wrapper passes them in): `tpr` threads (a power of two, 1 to 512) share
// a row; a block holds max(NORM_BLOCK, tpr) threads, so blockDim / tpr rows.
// Lane l of a row loads the vectors l, l + tpr, l + 2 tpr, ... of vec
// elements each (one 16-byte load at vec * sizeof = 16), NV = ITEMS / vec
// of them at most, so a row of D <= tpr * ITEMS elements sits in
// registers, ITEMS f32 values a thread. A vector past D / vec (the masked
// tail) or a row past M is never loaded. Widths that are not a multiple of
// 8 take a narrower vec that divides D (down to 1).
//
// Row sums are f32: a butterfly over the row's lanes inside a warp (every
// lane ends with the same bits), then, for rows wider than a warp, the
// warps' sums added in a fixed order through shared memory. Nothing here
// uses atomics, so a result does not change from run to run.
//
// Offsets are 64-bit: M * D passes 2^31 at large batches.
#pragma once

#include "bn_common.cuh"

#ifndef NORM_ITEMS
#define NORM_ITEMS 32
#endif
#ifndef NORM_BLOCK
#define NORM_BLOCK 256
#endif

namespace rownorm {

constexpr int ITEMS = NORM_ITEMS;    // f32 values of a row a thread holds
constexpr int BLOCK = NORM_BLOCK;    // threads a block at tpr <= BLOCK
constexpr int MAX_TPR = 512;         // threads a row at most (a block):
                                     // 128 registers a thread, D <= 16384
static_assert(ITEMS % 8 == 0, "ITEMS holds whole 8-wide vectors");
static_assert(BLOCK % 32 == 0 && BLOCK <= MAX_TPR, "BLOCK is whole warps");

using bn::load_f32;
using bn::Pack;

__device__ __forceinline__ void from_f(float v, float& out) { out = v; }
__device__ __forceinline__ void from_f(float v, __nv_bfloat16& out) {
  out = __float2bfloat16(v);
}

// One aligned store of VEC f32 values, narrowed to T.
template <typename T, int VEC>
__device__ __forceinline__ void store_from_f32(T* p, const float (&v)[VEC]) {
  Pack<T, VEC> pk;
#pragma unroll
  for (int i = 0; i < VEC; ++i) from_f(v[i], pk.v[i]);
  *reinterpret_cast<Pack<T, VEC>*>(p) = pk;
}

// v[i] <- the sum of v[i] over the tpr threads of this thread's row, the
// same bits on every one of them. Every thread of the block calls it
// (tpr is uniform across the block, so the barrier is too).
template <int N>
__device__ __forceinline__ void row_sum(float (&v)[N], int tpr) {
  __shared__ float red[MAX_TPR / 32][N];
  const int width = tpr < 32 ? tpr : 32;
  for (int off = width / 2; off > 0; off >>= 1) {
#pragma unroll
    for (int i = 0; i < N; ++i)
      v[i] += __shfl_xor_sync(0xffffffffu, v[i], off);
  }
  if (tpr <= 32) return;
  const int warp = threadIdx.x / 32;
  const int per_row = tpr / 32;
  const int first = warp / per_row * per_row;
  if (threadIdx.x % 32 == 0) {
#pragma unroll
    for (int i = 0; i < N; ++i) red[warp][i] = v[i];
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < N; ++i) {
    float s = 0.f;
    for (int w = 0; w < per_row; ++w) s += red[first + w][i];
    v[i] = s;
  }
  __syncthreads();  // red is read before the next call writes it
}

// The threads a block launches at tpr threads a row.
inline int block_threads(int tpr) { return tpr > BLOCK ? tpr : BLOCK; }

// The geometry the wrapper computed must hold every row in registers.
inline bool bad_geometry(int M, int D, int vec, int elem_bytes, int tpr) {
  const bool vec_ok = (vec == 1 || vec == 2 || vec == 4 || vec == 8) &&
                      vec * elem_bytes <= 16 && D % vec == 0;
  const bool tpr_ok = tpr >= 1 && tpr <= MAX_TPR && (tpr & (tpr - 1)) == 0;
  return M < 1 || D < 1 || !vec_ok || !tpr_ok ||
         (long long)D > (long long)tpr * ITEMS;
}

}  // namespace rownorm
