// The flash-attention dq body, for both layouts (flash_common.cuh): the
// entry points are flash_bwd_dq.cu (flat) and flash_bhsd_bwd_dq.cu.
//
// Computes, per (batch, q head, q row): p = exp(scale * q k^T - lse) over
// the visible columns (recomputed from the forward's lse, never stored),
// ds = p * (do v^T - delta), dq = scale * ds k, where delta = rowsum(do * o)
// (less the lse cotangent, when there is one) comes from the wrapper in
// the layout of lse.
//
// Design: one block per (q tile, q head, batch); the k tiles are a loop
// inside the block with the [64, D] dq accumulator in registers, so dq is
// written once, with no atomics. Causal dead k tiles are skipped as in the
// forward.
#pragma once

#include "flash_common.cuh"

namespace flash {

template <typename T>
__global__ void __launch_bounds__(THREADS)
    bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, const T* __restrict__ dout,
                  const float* __restrict__ lse,
                  const float* __restrict__ delta, T* __restrict__ dq,
                  const Geom g) {
  extern __shared__ float smem[];
  const int D = g.D;
  const int ld = D + 1;
  float* Qs = smem;            // [BQ][ld]
  float* dOs = Qs + BQ * ld;   // [BQ][ld]
  float* Ks = dOs + BQ * ld;   // [BK][ld]
  float* Vs = Ks + BK * ld;    // [BK][ld]
  float* DSs = Vs + BK * ld;   // [BQ][BK + 1]

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (g.H / g.Hkv);
  const int tr = threadIdx.x / 16;
  const int tc = threadIdx.x % 16;

  load_tile(Qs, q, g.qs, b, h, q0, g.q_len, D);
  load_tile(dOs, dout, g.qs, b, h, q0, g.q_len, D);

  float lse_r[RPT], delta_r[RPT], acc[RPT][DPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int row = q0 + tr * RPT + i;
    const size_t o = g.stats.at(b, h, row);
    lse_r[i] = row < g.q_len ? lse[o] : 0.f;
    delta_r[i] = row < g.q_len ? delta[o] : 0.f;
#pragma unroll
    for (int jd = 0; jd < DPT; ++jd) acc[i][jd] = 0.f;
  }

  const int n_kt = live_k_tiles(g, q0);
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();
    load_tile(Ks, k, g.kvs, b, hk, k0, g.kv_len, D);
    load_tile(Vs, v, g.kvs, b, hk, k0, g.kv_len, D);
    __syncthreads();

    float s[RPT][CPT], dp[RPT][CPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j) s[i][j] = dp[i][j] = 0.f;
    for (int d = 0; d < D; ++d) {
      float qv[RPT], dov[RPT], kv[CPT], vv[CPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        qv[i] = Qs[(tr * RPT + i) * ld + d];
        dov[i] = dOs[(tr * RPT + i) * ld + d];
      }
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        kv[j] = Ks[(tc + 16 * j) * ld + d];
        vv[j] = Vs[(tc + 16 * j) * ld + d];
      }
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < CPT; ++j) {
          s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
          dp[i][j] = fmaf(dov[i], vv[j], dp[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int r = tr * RPT + i;
      const int row = q0 + r;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const bool vis = visible(g, row, k0 + tc + 16 * j);
        const float p = expf(vis ? s[i][j] * g.scale - lse_r[i] : NEG_INF);
        DSs[r * (BK + 1) + tc + 16 * j] = p * (dp[i][j] - delta_r[i]);
      }
    }
    __syncthreads();

    for (int kk = 0; kk < BK; ++kk) {
      float dsv[RPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) dsv[i] = DSs[(tr * RPT + i) * (BK + 1) + kk];
#pragma unroll
      for (int jd = 0; jd < DPT; ++jd) {
        const int c = tc + 16 * jd;
        if (c < D) {
          const float kv = Ks[kk * ld + c];
#pragma unroll
          for (int i = 0; i < RPT; ++i) acc[i][jd] = fmaf(dsv[i], kv, acc[i][jd]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int row = q0 + tr * RPT + i;
    if (row >= g.q_len) continue;
    const size_t o = g.qs.at(b, h, row);
#pragma unroll
    for (int jd = 0; jd < DPT; ++jd) {
      const int c = tc + 16 * jd;
      if (c < D) dq[o + c] = from_f<T>(g.scale * acc[i][jd]);
    }
  }
}

template <typename T>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* dout, const void* lse, const void* delta,
                      void* dq, const Geom& g, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * ((size_t)(2 * BQ + 2 * BK) * (g.D + 1) + BQ * (BK + 1));
  cudaError_t err = cudaFuncSetAttribute(
      bwd_dq_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((g.q_len + BQ - 1) / BQ, g.H, g.B);
  bwd_dq_kernel<T><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dq), g);
  return cudaGetLastError();
}

// Checks the geometry and launches on bf16 (is_bf16) or f32 operands.
// Returns a cudaError_t (0 = launched).
inline int bwd_dq(const void* q, const void* k, const void* v,
                  const void* dout, const void* lse, const void* delta,
                  void* dq, const Geom& g, int is_bf16, void* stream) {
  if (bad_shape(g)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(is_bf16 ? launch_dq<__nv_bfloat16>(q, k, v, dout, lse, delta,
                                                  dq, g, s)
                       : launch_dq<float>(q, k, v, dout, lse, delta, dq, g,
                                          s));
}

}  // namespace flash
