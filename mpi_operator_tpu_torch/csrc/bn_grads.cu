// Per-channel batch-norm parameter gradients in one pass over (dy, x).
//
// Replaces: mpi_operator_tpu/ops/bn.py:_grads_kernel (the Pallas kernel
// launched by bn_grads).
//
// Computes, for dy and x [M, C] (each bf16 or f32) and f32 [C] mean and
// inv (= rsqrt(var + eps)): db[c] = sum_r dy[r, c] and
// dg[c] = sum_r dy[r, c] * (x[r, c] - mean[c]) * inv[c], accumulated in
// f32, from a single read of dy and x. out is f32 [2, C]: row 0 db, row
// 1 dg. These feed the training-mode dx formula, which the wrapper
// computes in elementwise PyTorch ops, as the JAX package leaves it to
// XLA.
//
// What bounds it on an H100: bytes. It reads 2 * M * C elements once and
// does ~4 FLOPs per element pair. At the ResNet-101 stem (M = 802,816,
// C = 64, bf16, B = 64) the bound is ~61 us.
//
// Design: bn_stats.cu's (bn_common.cuh), with two operands read at the
// same offsets and each thread's mean and inv held in registers for the
// whole chunk.
#include "bn_common.cuh"

namespace bn {

template <typename TD, typename TX, int VEC>
__global__ void __launch_bounds__(THREADS)
    grads_kernel(const TD* __restrict__ dy, const TX* __restrict__ x,
                 const float* __restrict__ mean,
                 const float* __restrict__ inv, float* __restrict__ part,
                 int M, int C, int lanes, int rows_per_chunk, int n_chunks) {
  const int lane = threadIdx.x % lanes;
  const int row_step = THREADS / lanes;
  const int c0 = (blockIdx.y * lanes + lane) * VEC;
  const int chunk = blockIdx.x;
  const long long r_end =
      min((long long)M, (long long)(chunk + 1) * rows_per_chunk);
  float db[VEC], dg[VEC], mu[VEC], iv[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    db[i] = dg[i] = 0.f;
    mu[i] = c0 + i < C ? mean[c0 + i] : 0.f;
    iv[i] = c0 + i < C ? inv[c0 + i] : 0.f;
  }
  if (c0 < C) {
    for (long long r = (long long)chunk * rows_per_chunk + threadIdx.x / lanes;
         r < r_end; r += row_step) {
      float g[VEC], v[VEC];
      load_f32<TD, VEC>(dy + r * C + c0, g);
      load_f32<TX, VEC>(x + r * C + c0, v);
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        db[i] += g[i];
        dg[i] = fmaf(g[i], (v[i] - mu[i]) * iv[i], dg[i]);
      }
    }
  }
  store_partials<VEC>(db, dg, part, lanes, c0, C, chunk, n_chunks);
}

template <typename TD, typename TX, int VEC>
cudaError_t launch_grads(const void* dy, const void* x, const float* mean,
                         const float* inv, float* part, float* out, int M,
                         int C, int lanes, int rows_per_chunk, int n_chunks,
                         cudaStream_t stream) {
  const int tiles = (C / VEC + lanes - 1) / lanes;
  const dim3 grid(n_chunks, tiles);
  grads_kernel<TD, TX, VEC><<<grid, THREADS, 0, stream>>>(
      static_cast<const TD*>(dy), static_cast<const TX*>(x), mean, inv, part,
      M, C, lanes, rows_per_chunk, n_chunks);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_finalize(part, out, n_chunks, C, stream);
}

template <typename TD, typename TX>
cudaError_t dispatch(int vec, const void* dy, const void* x,
                     const float* mean, const float* inv, float* part,
                     float* out, int M, int C, int lanes, int rows_per_chunk,
                     int n_chunks, cudaStream_t s) {
  switch (vec) {
    case 1:
      return launch_grads<TD, TX, 1>(dy, x, mean, inv, part, out, M, C,
                                     lanes, rows_per_chunk, n_chunks, s);
    case 2:
      return launch_grads<TD, TX, 2>(dy, x, mean, inv, part, out, M, C,
                                     lanes, rows_per_chunk, n_chunks, s);
    case 4:
      return launch_grads<TD, TX, 4>(dy, x, mean, inv, part, out, M, C,
                                     lanes, rows_per_chunk, n_chunks, s);
    default:
      return launch_grads<TD, TX, 8>(dy, x, mean, inv, part, out, M, C,
                                     lanes, rows_per_chunk, n_chunks, s);
  }
}

template <typename TD>
cudaError_t dispatch_x(int x_bf16, int vec, const void* dy, const void* x,
                       const float* mean, const float* inv, float* part,
                       float* out, int M, int C, int lanes,
                       int rows_per_chunk, int n_chunks, cudaStream_t s) {
  return x_bf16 ? dispatch<TD, __nv_bfloat16>(vec, dy, x, mean, inv, part,
                                               out, M, C, lanes,
                                               rows_per_chunk, n_chunks, s)
                : dispatch<TD, float>(vec, dy, x, mean, inv, part, out, M, C,
                                      lanes, rows_per_chunk, n_chunks, s);
}

}  // namespace bn

// dy, x [M, C] (each bf16 when its flag is set, else f32); mean, inv f32
// [C]; part f32 [2, n_chunks, C] scratch; out f32 [2, C]. vec, lanes,
// rows_per_chunk and n_chunks come from ops/_common.py bn_geometry for
// the wider of the two types. Returns a cudaError_t (0 = launched).
extern "C" int bn_grads(const void* dy, const void* x, const void* mean,
                        const void* inv, void* part, void* out, int M, int C,
                        int vec, int lanes, int rows_per_chunk, int n_chunks,
                        int dy_bf16, int x_bf16, void* stream) {
  const int elem_bytes = (dy_bf16 && x_bf16) ? 2 : 4;
  if (bn::bad_geometry(M, C, vec, elem_bytes, lanes, rows_per_chunk,
                       n_chunks))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* mu = static_cast<const float*>(mean);
  const float* iv = static_cast<const float*>(inv);
  float* p = static_cast<float*>(part);
  float* o = static_cast<float*>(out);
  const cudaError_t err =
      dy_bf16 ? bn::dispatch_x<__nv_bfloat16>(x_bf16, vec, dy, x, mu, iv, p,
                                              o, M, C, lanes, rows_per_chunk,
                                              n_chunks, s)
              : bn::dispatch_x<float>(x_bf16, vec, dy, x, mu, iv, p, o, M, C,
                                      lanes, rows_per_chunk, n_chunks, s);
  return (int)err;
}
