// Row normalisation, forward: LayerNorm or RMSNorm of each row of x in one
// read of the row.
//
// Replaces no TPU kernel: the JAX package leaves its norms
// (models/bert.py LayerNorm, models/llama.py RMSNorm) to XLA, which fuses
// them. The port's plain expressions (ops/norm.py layer_norm_plain,
// rms_norm_plain) ran as about nine separate passes over the row, most of
// them reading and writing f32.
//
// Computes, for x [M, D] (bf16 or f32), per row in f32: s = sum x,
// q = sum x^2; LayerNorm mean = s / D, var = max(q / D - mean^2, 0),
// rstd = rsqrt(var + eps), y = (x - mean) * (rstd * scale) + bias;
// RMSNorm rstd = rsqrt(q / D + eps), y = (x * rstd) * scale. y is written
// in bf16 or f32. Saved for the backward: LayerNorm's mean [M] and rstd
// [M], rstd negated on a row whose q / D - mean^2 fell below 0 (the clamp
// cut its variance from the gradient); RMSNorm's rstd alone.
//
// What bounds it on an H100: bytes. It reads x once and writes y once,
// about 5 FLOPs an element (~1.3 FLOP/byte in bf16 against ~20 for the
// f32 FMA pipes at the card's 3.35 TB/s). BERT-base's 32,768 rows of 768
// in bf16: 100.7 MB, 30 us; Mixtral's 4,096 rows of 4,096: 67 MB, 20 us.
//
// Design (norm_common.cuh): the row is loaded once into registers with
// 16-byte loads, the two sums reduced across the row's threads (a warp a
// row at 768, several warps at 4096: the width picks the thread count),
// and the output formed from the registers, so x is read once and nothing
// but y and 8 bytes of statistics a row is written.
#include "norm_common.cuh"

namespace rownorm {

template <typename TX, typename TY, int VEC, bool LAYER>
__global__ void __launch_bounds__(MAX_TPR)
    fwd_kernel(const TX* __restrict__ x, const float* __restrict__ scale,
               const float* __restrict__ bias, TY* __restrict__ y,
               float* __restrict__ mean_out, float* __restrict__ rstd_out,
               int M, int D, int tpr, float eps) {
  constexpr int NV = ITEMS / VEC;
  const int lane = threadIdx.x % tpr;
  const long long row =
      (long long)blockIdx.x * (blockDim.x / tpr) + threadIdx.x / tpr;
  const bool live = row < M;
  const int nvec = D / VEC;
  const TX* xr = x + row * D;
  float v[NV][VEC];
  float s[2] = {0.f, 0.f};
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    const int j = lane + k * tpr;
    if (live && j < nvec) {
      load_f32<TX, VEC>(xr + (long long)j * VEC, v[k]);
    } else {
#pragma unroll
      for (int i = 0; i < VEC; ++i) v[k][i] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      s[0] += v[k][i];
      s[1] = fmaf(v[k][i], v[k][i], s[1]);
    }
  }
  row_sum(s, tpr);
  const float inv_d = 1.f / D;
  float mean = 0.f, rstd, saved;
  if (LAYER) {
    mean = s[0] * inv_d;
    const float raw = s[1] * inv_d - mean * mean;
    rstd = rsqrtf(fmaxf(raw, 0.f) + eps);
    saved = raw < 0.f ? -rstd : rstd;
  } else {
    rstd = rsqrtf(s[1] * inv_d + eps);
    saved = rstd;
  }
  if (!live) return;
  TY* yr = y + row * D;
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    const int j = lane + k * tpr;
    if (j >= nvec) break;
    float g[VEC], out[VEC];
    load_f32<float, VEC>(scale + j * VEC, g);
    if (LAYER) {
      float b[VEC];
      load_f32<float, VEC>(bias + j * VEC, b);
#pragma unroll
      for (int i = 0; i < VEC; ++i)
        out[i] = (v[k][i] - mean) * (rstd * g[i]) + b[i];
    } else {
#pragma unroll
      for (int i = 0; i < VEC; ++i) out[i] = (v[k][i] * rstd) * g[i];
    }
    store_from_f32<TY, VEC>(yr + (long long)j * VEC, out);
  }
  if (lane == 0) {
    if (LAYER) mean_out[row] = mean;
    rstd_out[row] = saved;
  }
}

template <typename TX, typename TY, int VEC, bool LAYER>
cudaError_t launch_fwd(const void* x, const float* scale, const float* bias,
                       void* y, float* mean, float* rstd, int M, int D,
                       int tpr, float eps, cudaStream_t stream) {
  const int threads = block_threads(tpr);
  const int rows = threads / tpr;
  const unsigned blocks = (unsigned)((M + (long long)rows - 1) / rows);
  fwd_kernel<TX, TY, VEC, LAYER><<<blocks, threads, 0, stream>>>(
      static_cast<const TX*>(x), scale, bias, static_cast<TY*>(y), mean,
      rstd, M, D, tpr, eps);
  return cudaGetLastError();
}

template <typename TX, typename TY, bool LAYER>
cudaError_t by_vec(int vec, const void* x, const float* scale,
                   const float* bias, void* y, float* mean, float* rstd,
                   int M, int D, int tpr, float eps, cudaStream_t s) {
  switch (vec) {
    case 1:
      return launch_fwd<TX, TY, 1, LAYER>(x, scale, bias, y, mean, rstd, M,
                                          D, tpr, eps, s);
    case 2:
      return launch_fwd<TX, TY, 2, LAYER>(x, scale, bias, y, mean, rstd, M,
                                          D, tpr, eps, s);
    case 4:
      return launch_fwd<TX, TY, 4, LAYER>(x, scale, bias, y, mean, rstd, M,
                                          D, tpr, eps, s);
    default:
      if constexpr (sizeof(TX) == 2 && sizeof(TY) == 2)
        return launch_fwd<TX, TY, 8, LAYER>(x, scale, bias, y, mean, rstd,
                                            M, D, tpr, eps, s);
      return cudaErrorInvalidValue;
  }
}

template <typename TX, bool LAYER>
cudaError_t by_y(int y_bf16, int vec, const void* x, const float* scale,
                 const float* bias, void* y, float* mean, float* rstd, int M,
                 int D, int tpr, float eps, cudaStream_t s) {
  return y_bf16 ? by_vec<TX, __nv_bfloat16, LAYER>(vec, x, scale, bias, y,
                                                   mean, rstd, M, D, tpr,
                                                   eps, s)
                : by_vec<TX, float, LAYER>(vec, x, scale, bias, y, mean,
                                           rstd, M, D, tpr, eps, s);
}

template <bool LAYER>
cudaError_t by_x(int x_bf16, int y_bf16, int vec, const void* x,
                 const float* scale, const float* bias, void* y, float* mean,
                 float* rstd, int M, int D, int tpr, float eps,
                 cudaStream_t s) {
  return x_bf16 ? by_y<__nv_bfloat16, LAYER>(y_bf16, vec, x, scale, bias, y,
                                             mean, rstd, M, D, tpr, eps, s)
                : by_y<float, LAYER>(y_bf16, vec, x, scale, bias, y, mean,
                                     rstd, M, D, tpr, eps, s);
}

}  // namespace rownorm

// x [M, D] (bf16 when x_bf16, else f32); scale, bias f32 [D] (bias and mean
// unused, and may be null, unless layer); y [M, D] (bf16 when y_bf16, else
// f32); mean, rstd f32 [M]. vec and tpr come from ops/_common.py
// norm_geometry; every pointer is aligned to vec elements. Returns a
// cudaError_t (0 = launched).
extern "C" int norm_fwd(const void* x, const void* scale, const void* bias,
                        void* y, void* mean, void* rstd, int M, int D,
                        int vec, int tpr, float eps, int layer, int x_bf16,
                        int y_bf16, void* stream) {
  const int widest = (x_bf16 && y_bf16) ? 2 : 4;
  if (rownorm::bad_geometry(M, D, vec, widest, tpr))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* g = static_cast<const float*>(scale);
  const float* b = static_cast<const float*>(bias);
  float* mu = static_cast<float*>(mean);
  float* r = static_cast<float*>(rstd);
  const cudaError_t err =
      layer ? rownorm::by_x<true>(x_bf16, y_bf16, vec, x, g, b, y, mu, r, M, D,
                               tpr, eps, s)
            : rownorm::by_x<false>(x_bf16, y_bf16, vec, x, g, b, y, mu, r, M, D,
                                tpr, eps, s);
  return (int)err;
}
