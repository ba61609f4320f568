// Shared pieces of the two BN reduction kernels (bn_stats.cu, bn_grads.cu).
//
// Layout: every operand is [M, C] with C innermost (NHWC activations
// flattened over N, H, W), row r at offset r * C. Per-channel vectors are
// f32 [C].
//
// Work split (ops/_common.py bn_geometry computes it and the wrapper
// passes it in): a block of BN_THREADS threads covers `lanes * vec`
// channels (grid y) of one chunk of `rows_per_chunk` rows (grid x). Thread
// t reads channels c0 .. c0 + vec - 1 with c0 = (blockIdx.y * lanes +
// t % lanes) * vec, on rows chunk_begin + t / lanes, stepping by
// BN_THREADS / lanes rows, with one load of vec elements per row. Rows
// past M and channels past C are never loaded. Sums are f32 in
// registers; a fixed tree in shared memory folds the block's rows into
// one partial per channel, written to part[which][chunk][c]. The second
// pass (finalize_kernel) adds the chunks' partials in a fixed order, so a
// result does not change from run to run. No float atomics.
//
// Offsets are 64-bit: M * C passes 2^31 at large batches.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

#ifndef BN_THREADS
#define BN_THREADS 256
#endif

namespace bn {

constexpr int THREADS = BN_THREADS;
static_assert(THREADS == 256, "the thread map assumes 256 threads a block");
constexpr int MAX_VEC = 8;      // 16 bytes of bf16
constexpr int MAX_LANES = 32;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

// One aligned load of VEC elements, widened to f32.
template <typename T, int VEC>
__device__ __forceinline__ void load_f32(const T* p, float (&out)[VEC]) {
  const Pack<T, VEC> pk = *reinterpret_cast<const Pack<T, VEC>*>(p);
#pragma unroll
  for (int i = 0; i < VEC; ++i) out[i] = to_f(pk.v[i]);
}

// Fold the block's per-thread sums a[] and b[] (threads on the same lane
// hold the same channels, on different rows) into one partial per
// channel, and write them to part[0][chunk][c] and part[1][chunk][c].
// The tree's order is fixed by the thread map alone.
template <int VEC>
__device__ __forceinline__ void store_partials(const float (&a)[VEC],
                                               const float (&b)[VEC],
                                               float* __restrict__ part,
                                               int lanes, int c0, int C,
                                               int chunk, int n_chunks) {
  __shared__ float red[2][THREADS * MAX_VEC];
  const int t = threadIdx.x;
  const int lane = t % lanes;
  const int row = t / lanes;
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    red[0][t * VEC + i] = a[i];
    red[1][t * VEC + i] = b[i];
  }
  __syncthreads();
  for (int half = THREADS / lanes / 2; half > 0; half >>= 1) {
    if (row < half) {
      const int o = (row + half) * lanes + lane;
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        red[0][t * VEC + i] += red[0][o * VEC + i];
        red[1][t * VEC + i] += red[1][o * VEC + i];
      }
    }
    __syncthreads();
  }
  if (row == 0) {
    const size_t base = (size_t)chunk * C;
    const size_t plane = (size_t)n_chunks * C;
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      if (c0 + i < C) {
        part[base + c0 + i] = red[0][t * VEC + i];
        part[plane + base + c0 + i] = red[1][t * VEC + i];
      }
    }
  }
}

// out[w][c] = sum over chunks k (in a fixed order) of part[w][k][c], for
// w in {0, 1} (grid y). A block covers 32 channels; its 8 warps take
// every 8th chunk, then a fixed tree adds the 8 sums.
__global__ void __launch_bounds__(THREADS)
    finalize_kernel(const float* __restrict__ part, float* __restrict__ out,
                    int n_chunks, int C) {
  __shared__ float red[THREADS / 32][32];
  const int lane = threadIdx.x % 32;
  const int group = threadIdx.x / 32;
  const int c = blockIdx.x * 32 + lane;
  const float* p = part + (size_t)blockIdx.y * n_chunks * C;
  float acc = 0.f;
  if (c < C)
    for (int k = group; k < n_chunks; k += THREADS / 32)
      acc += p[(size_t)k * C + c];
  red[group][lane] = acc;
  __syncthreads();
  for (int half = THREADS / 64; half > 0; half >>= 1) {
    if (group < half) red[group][lane] += red[group + half][lane];
    __syncthreads();
  }
  if (group == 0 && c < C) out[(size_t)blockIdx.y * C + c] = red[0][lane];
}

// The geometry the wrapper computed must cover [M, C] exactly once.
inline bool bad_geometry(int M, int C, int vec, int elem_bytes, int lanes,
                         int rows_per_chunk, int n_chunks) {
  const bool vec_ok = (vec == 1 || vec == 2 || vec == 4 || vec == 8) &&
                      vec * elem_bytes <= 16 && C % vec == 0;
  const bool lanes_ok = lanes >= 1 && lanes <= MAX_LANES &&
                        (lanes & (lanes - 1)) == 0;
  return M < 1 || C < 1 || !vec_ok || !lanes_ok || rows_per_chunk < 1 ||
         n_chunks < 1 || (long long)(n_chunks - 1) * rows_per_chunk >= M ||
         (long long)n_chunks * rows_per_chunk < M;
}

inline cudaError_t launch_finalize(const float* part, float* out,
                                   int n_chunks, int C, cudaStream_t stream) {
  const dim3 grid((C + 31) / 32, 2);
  finalize_kernel<<<grid, THREADS, 0, stream>>>(part, out, n_chunks, C);
  return cudaGetLastError();
}

}  // namespace bn
