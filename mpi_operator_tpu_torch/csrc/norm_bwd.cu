// Row normalisation, backward: dx of LayerNorm or RMSNorm from one read of
// each row of x and dy, and the f32 gradients of scale (and bias) summed
// over the rows without atomics.
//
// Replaces no TPU kernel: the JAX package leaves its norms to XLA, which
// fuses them. Autograd of the port's plain expressions ran about twice the
// forward's passes, most in f32, plus two column reductions.
//
// Computes, per row, from the forward's saved mean and rstd (rstd < 0 on
// a LayerNorm row whose variance the forward clamped): x^ = (x - mean) *
// |rstd| (RMSNorm: x * rstd), g = dy * scale, a = mean(g), b = mean(g x^);
// LayerNorm dx = |rstd| (g - a - x^ b), with b = 0 on a clamped row (the
// clamp's gradient is 0 below 0, as autograd of the plain expression
// gives); RMSNorm dx = rstd (g - x^ b). dx is written in x's type. Over the
// rows: dscale = sum dy x^, dbias = sum dy.
//
// What bounds it on an H100: bytes. It reads x and dy once and writes dx
// once: BERT-base's 32,768 rows of 768 in bf16 151 MB, 45 us; Mixtral's
// 4,096 rows of 4,096 101 MB, 30 us. The column sums add a partial a block
// and column (a few MB, read once by the second kernel).
//
// Design (norm_common.cuh's thread map): the rows are walked by one wave
// of blocks (as many as fit on the card, the row groups shared out
// evenly). A thread keeps its vectors of x and dy in registers in their
// own type while the row's two sums are reduced, then forms dx from them.
// It adds dy x^ and dy into f32 registers for its columns over every row
// it walks; at the end the block folds its rows' registers by a fixed tree
// in shared memory into one partial a column, and bn_common.cuh's
// finalize_kernel adds the blocks' partials in a fixed order. So dscale
// and dbias are bit-identical from run to run.
#include "norm_common.cuh"

namespace rownorm {

template <typename TX, typename TY, int VEC, bool LAYER>
__global__ void __launch_bounds__(MAX_TPR)
    bwd_kernel(const TX* __restrict__ x, const TY* __restrict__ dy,
               const float* __restrict__ mean,
               const float* __restrict__ rstd,
               const float* __restrict__ scale, TX* __restrict__ dx,
               float* __restrict__ part, int M, int D, int tpr) {
  constexpr int NV = ITEMS / VEC;
  constexpr int PLANES = LAYER ? 2 : 1;
  const int lane = threadIdx.x % tpr;
  const int rows = blockDim.x / tpr;
  const int group = threadIdx.x / tpr;
  const int nvec = D / VEC;
  const float inv_d = 1.f / D;
  float acc[PLANES][NV][VEC];
#pragma unroll
  for (int p = 0; p < PLANES; ++p)
#pragma unroll
    for (int k = 0; k < NV; ++k)
#pragma unroll
      for (int i = 0; i < VEC; ++i) acc[p][k][i] = 0.f;

  for (long long r0 = (long long)blockIdx.x * rows; r0 < M;
       r0 += (long long)gridDim.x * rows) {
    const long long row = r0 + group;
    const bool live = row < M;
    float mu = 0.f, rs = 0.f;
    if (live) {
      if (LAYER) mu = mean[row];
      rs = rstd[row];
    }
    const float r = fabsf(rs);
    Pack<TX, VEC> xp[NV];
    Pack<TY, VEC> dp[NV];
    float s[2] = {0.f, 0.f};
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      const int j = lane + k * tpr;
      if (!live || j >= nvec) continue;
      xp[k] = *reinterpret_cast<const Pack<TX, VEC>*>(x + row * D +
                                                      (long long)j * VEC);
      dp[k] = *reinterpret_cast<const Pack<TY, VEC>*>(dy + row * D +
                                                      (long long)j * VEC);
      float g[VEC];
      load_f32<float, VEC>(scale + j * VEC, g);
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        const float xh = (bn::to_f(xp[k].v[i]) - mu) * r;
        const float d = bn::to_f(dp[k].v[i]);
        const float gi = d * g[i];
        s[0] += gi;
        s[1] = fmaf(gi, xh, s[1]);
        acc[0][k][i] = fmaf(d, xh, acc[0][k][i]);
        if (LAYER) acc[PLANES - 1][k][i] += d;
      }
    }
    row_sum(s, tpr);
    const float a = LAYER ? s[0] * inv_d : 0.f;
    const float b = (LAYER && rs < 0.f) ? 0.f : s[1] * inv_d;
    if (!live) continue;
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      const int j = lane + k * tpr;
      if (j >= nvec) break;
      float g[VEC], out[VEC];
      load_f32<float, VEC>(scale + j * VEC, g);
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        const float xh = (bn::to_f(xp[k].v[i]) - mu) * r;
        const float gi = bn::to_f(dp[k].v[i]) * g[i];
        out[i] = r * (gi - a - xh * b);
      }
      store_from_f32<TX, VEC>(dx + row * D + (long long)j * VEC, out);
    }
  }

  // One partial a column for this block: the rows' registers (threads of
  // one lane hold the same columns) folded by a fixed tree.
  __shared__ float fold[BLOCK * 8];
#pragma unroll
  for (int p = 0; p < PLANES; ++p) {
    float* dst = part + ((long long)p * gridDim.x + blockIdx.x) * D;
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      const int j = lane + k * tpr;
      if (rows == 1) {
        if (j < nvec) store_from_f32<float, VEC>(dst + j * VEC, acc[p][k]);
        continue;
      }
      const int t = threadIdx.x;
#pragma unroll
      for (int i = 0; i < VEC; ++i) fold[t * VEC + i] = acc[p][k][i];
      __syncthreads();
      for (int half = rows / 2; half > 0; half >>= 1) {
        if (group < half) {
          const int o = t + half * tpr;
#pragma unroll
          for (int i = 0; i < VEC; ++i)
            fold[t * VEC + i] += fold[o * VEC + i];
        }
        __syncthreads();
      }
      if (group == 0 && j < nvec) {
        float out[VEC];
#pragma unroll
        for (int i = 0; i < VEC; ++i) out[i] = fold[t * VEC + i];
        store_from_f32<float, VEC>(dst + j * VEC, out);
      }
      __syncthreads();  // fold is read before the next round writes it
    }
  }
}

template <typename TX, typename TY, int VEC, bool LAYER>
cudaError_t launch_bwd(const void* x, const void* dy, const float* mean,
                       const float* rstd, const float* scale, void* dx,
                       float* part, float* out, int M, int D, int tpr,
                       int max_blocks, cudaStream_t stream) {
  const int threads = block_threads(tpr);
  const int rows = threads / tpr;
  // Blocks of this instance that fit on an SM, by block size (BLOCK or
  // MAX_TPR threads), asked of the CUDA runtime once.
  static int fits[2] = {0, 0};
  int& per_sm = fits[threads == BLOCK ? 0 : 1];
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
  if (err == cudaSuccess && per_sm == 0)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, bwd_kernel<TX, TY, VEC, LAYER>, threads, 0);
  if (err != cudaSuccess) return err;
  // One wave: as many blocks as fit, at most max_blocks (the partials'
  // rows), each walking the same number of row groups.
  const long long groups = (M + (long long)rows - 1) / rows;
  long long blocks = (long long)per_sm * sms;
  if (blocks > max_blocks) blocks = max_blocks;
  if (blocks > groups) blocks = groups;
  if (blocks < 1) blocks = 1;
  const long long walks = (groups + blocks - 1) / blocks;
  blocks = (groups + walks - 1) / walks;
  bwd_kernel<TX, TY, VEC, LAYER><<<(unsigned)blocks, threads, 0, stream>>>(
      static_cast<const TX*>(x), static_cast<const TY*>(dy), mean, rstd,
      scale, static_cast<TX*>(dx), part, M, D, tpr);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  constexpr int PLANES = LAYER ? 2 : 1;
  bn::finalize_kernel<<<dim3((D + 31) / 32, PLANES), bn::THREADS, 0,
                        stream>>>(part, out, (int)blocks, D);
  return cudaGetLastError();
}

template <typename TX, typename TY, bool LAYER>
cudaError_t by_vec(int vec, const void* x, const void* dy, const float* mean,
                   const float* rstd, const float* scale, void* dx,
                   float* part, float* out, int M, int D, int tpr,
                   int max_blocks, cudaStream_t s) {
  switch (vec) {
    case 1:
      return launch_bwd<TX, TY, 1, LAYER>(x, dy, mean, rstd, scale, dx, part,
                                          out, M, D, tpr, max_blocks, s);
    case 2:
      return launch_bwd<TX, TY, 2, LAYER>(x, dy, mean, rstd, scale, dx, part,
                                          out, M, D, tpr, max_blocks, s);
    case 4:
      return launch_bwd<TX, TY, 4, LAYER>(x, dy, mean, rstd, scale, dx, part,
                                          out, M, D, tpr, max_blocks, s);
    default:
      if constexpr (sizeof(TX) == 2 && sizeof(TY) == 2)
        return launch_bwd<TX, TY, 8, LAYER>(x, dy, mean, rstd, scale, dx,
                                            part, out, M, D, tpr, max_blocks,
                                            s);
      return cudaErrorInvalidValue;
  }
}

template <typename TX, bool LAYER>
cudaError_t by_dy(int dy_bf16, int vec, const void* x, const void* dy,
                  const float* mean, const float* rstd, const float* scale,
                  void* dx, float* part, float* out, int M, int D, int tpr,
                  int max_blocks, cudaStream_t s) {
  return dy_bf16
             ? by_vec<TX, __nv_bfloat16, LAYER>(vec, x, dy, mean, rstd,
                                                scale, dx, part, out, M, D,
                                                tpr, max_blocks, s)
             : by_vec<TX, float, LAYER>(vec, x, dy, mean, rstd, scale, dx,
                                        part, out, M, D, tpr, max_blocks, s);
}

template <bool LAYER>
cudaError_t by_x(int x_bf16, int dy_bf16, int vec, const void* x,
                 const void* dy, const float* mean, const float* rstd,
                 const float* scale, void* dx, float* part, float* out,
                 int M, int D, int tpr, int max_blocks, cudaStream_t s) {
  return x_bf16 ? by_dy<__nv_bfloat16, LAYER>(dy_bf16, vec, x, dy, mean,
                                              rstd, scale, dx, part, out, M,
                                              D, tpr, max_blocks, s)
                : by_dy<float, LAYER>(dy_bf16, vec, x, dy, mean, rstd, scale,
                                      dx, part, out, M, D, tpr, max_blocks,
                                      s);
}

}  // namespace rownorm

// x and dx [M, D] (bf16 when x_bf16, else f32); dy [M, D] (bf16 when
// dy_bf16, else f32); mean (unused, and may be null, unless layer) and
// rstd f32 [M] from norm_fwd; scale f32 [D]; part f32 scratch [planes,
// max_blocks, D] and out f32 [planes, D], planes 2 (dscale, dbias) when
// layer else 1 (dscale). vec and tpr come from ops/_common.py
// norm_geometry; every pointer is aligned to vec elements. Returns a
// cudaError_t (0 = launched).
extern "C" int norm_bwd(const void* x, const void* dy, const void* mean,
                        const void* rstd, const void* scale, void* dx,
                        void* part, void* out, int M, int D, int vec,
                        int tpr, int max_blocks, int layer, int x_bf16,
                        int dy_bf16, void* stream) {
  const int widest = (x_bf16 && dy_bf16) ? 2 : 4;
  if (rownorm::bad_geometry(M, D, vec, widest, tpr) || max_blocks < 1)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* mu = static_cast<const float*>(mean);
  const float* r = static_cast<const float*>(rstd);
  const float* g = static_cast<const float*>(scale);
  float* p = static_cast<float*>(part);
  float* o = static_cast<float*>(out);
  const cudaError_t err =
      layer ? rownorm::by_x<true>(x_bf16, dy_bf16, vec, x, dy, mu, r, g, dx, p,
                               o, M, D, tpr, max_blocks, s)
            : rownorm::by_x<false>(x_bf16, dy_bf16, vec, x, dy, mu, r, g, dx, p,
                                o, M, D, tpr, max_blocks, s);
  return (int)err;
}
