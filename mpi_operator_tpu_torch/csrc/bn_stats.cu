// Per-channel batch-norm moments in one pass over x.
//
// Replaces: mpi_operator_tpu/ops/bn.py:_stats_kernel (the Pallas kernel
// launched by bn_stats).
//
// Computes, for x [M, C] (bf16 or f32): sum[c] = sum_r x[r, c] and
// sumsq[c] = sum_r x[r, c]^2, both accumulated in f32, from a single read
// of x. out is f32 [2, C]: row 0 the sums, row 1 the sums of squares.
//
// What bounds it on an H100: bytes. It reads M * C elements once and does
// two FLOPs per element (~1 FLOP/byte in bf16, against the ~20 FLOP/byte
// of f32 FMA and ~295 of the tensor cores at the card's 3.35 TB/s). At
// the ResNet-101 stem (M = 802,816, C = 64, bf16, B = 64) the bound is
// ~31 us.
//
// Design (bn_common.cuh): threads across channels with 16-byte loads,
// rows split into chunks across ~4 blocks per SM so the narrow stem fills
// the card, per-chunk partials folded by a fixed tree in shared memory,
// then a second short kernel adds the partials in a fixed order. The
// TPU kernel's sequential grid accumulation becomes the per-thread loop
// over a chunk's rows; its select-zeroed padding rows become rows that
// are never loaded.
#include "bn_common.cuh"

namespace bn {

template <typename T, int VEC>
__global__ void __launch_bounds__(THREADS)
    stats_kernel(const T* __restrict__ x, float* __restrict__ part, int M,
                 int C, int lanes, int rows_per_chunk, int n_chunks) {
  const int lane = threadIdx.x % lanes;
  const int row_step = THREADS / lanes;
  const int c0 = (blockIdx.y * lanes + lane) * VEC;
  const int chunk = blockIdx.x;
  const long long r_end =
      min((long long)M, (long long)(chunk + 1) * rows_per_chunk);
  float s[VEC], q[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) s[i] = q[i] = 0.f;
  if (c0 < C) {
    for (long long r = (long long)chunk * rows_per_chunk + threadIdx.x / lanes;
         r < r_end; r += row_step) {
      float v[VEC];
      load_f32<T, VEC>(x + r * C + c0, v);
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        s[i] += v[i];
        q[i] = fmaf(v[i], v[i], q[i]);
      }
    }
  }
  store_partials<VEC>(s, q, part, lanes, c0, C, chunk, n_chunks);
}

template <typename T, int VEC>
cudaError_t launch_stats(const void* x, float* part, float* out, int M,
                         int C, int lanes, int rows_per_chunk, int n_chunks,
                         cudaStream_t stream) {
  const int tiles = (C / VEC + lanes - 1) / lanes;
  const dim3 grid(n_chunks, tiles);
  stats_kernel<T, VEC><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(x), part, M, C, lanes, rows_per_chunk, n_chunks);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_finalize(part, out, n_chunks, C, stream);
}

template <typename T>
cudaError_t dispatch(int vec, const void* x, float* part, float* out, int M,
                     int C, int lanes, int rows_per_chunk, int n_chunks,
                     cudaStream_t s) {
  switch (vec) {
    case 1:
      return launch_stats<T, 1>(x, part, out, M, C, lanes, rows_per_chunk,
                                n_chunks, s);
    case 2:
      return launch_stats<T, 2>(x, part, out, M, C, lanes, rows_per_chunk,
                                n_chunks, s);
    case 4:
      return launch_stats<T, 4>(x, part, out, M, C, lanes, rows_per_chunk,
                                n_chunks, s);
    default:
      return launch_stats<T, 8>(x, part, out, M, C, lanes, rows_per_chunk,
                                n_chunks, s);
  }
}

}  // namespace bn

// x [M, C] (bf16 when is_bf16, else f32); part f32 [2, n_chunks, C]
// scratch; out f32 [2, C]. vec, lanes, rows_per_chunk and n_chunks come
// from ops/_common.py bn_geometry. Returns a cudaError_t (0 = launched).
extern "C" int bn_stats(const void* x, void* part, void* out, int M, int C,
                        int vec, int lanes, int rows_per_chunk, int n_chunks,
                        int is_bf16, void* stream) {
  if (bn::bad_geometry(M, C, vec, is_bf16 ? 2 : 4, lanes, rows_per_chunk,
                       n_chunks))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* p = static_cast<float*>(part);
  float* o = static_cast<float*>(out);
  const cudaError_t err =
      is_bf16 ? bn::dispatch<__nv_bfloat16>(vec, x, p, o, M, C, lanes,
                                            rows_per_chunk, n_chunks, s)
              : bn::dispatch<float>(vec, x, p, o, M, C, lanes,
                                    rows_per_chunk, n_chunks, s);
  return (int)err;
}
