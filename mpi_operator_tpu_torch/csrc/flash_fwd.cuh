// The flash-attention forward body, for both layouts (flash_common.cuh):
// the entry points are flash_fwd.cu (flat) and flash_bhsd_fwd.cu.
//
// Computes, per (batch, q head, q row): out = softmax(scale * q k^T) v over
// the visible columns of kv head h / (H / Hkv), and lse = m + log(l), with
// the online-softmax recurrence in f32.
//
// Design: one block per (q tile of 64 rows, q head, batch). The TPU grid's
// sequential k axis is a loop inside the block; the running max m, sum l
// and the [64, D] accumulator stay in registers, so the [Sq, Sk] score
// matrix never reaches device memory. Causal dead k tiles are never loaded
// (live_k_tiles), and GQA shares kv heads by index, never by copy.
#pragma once

#include "flash_common.cuh"

namespace flash {

template <typename T>
__global__ void __launch_bounds__(THREADS)
    fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, T* __restrict__ out,
               float* __restrict__ lse, const Geom g) {
  extern __shared__ float smem[];
  const int D = g.D;
  const int ld = D + 1;
  float* Qs = smem;           // [BQ][ld]
  float* Ks = Qs + BQ * ld;   // [BK][ld]
  float* Vs = Ks + BK * ld;   // [BK][ld]
  float* Ps = Vs + BK * ld;   // [BQ][BK + 1]

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (g.H / g.Hkv);
  const int tr = threadIdx.x / 16;
  const int tc = threadIdx.x % 16;

  load_tile(Qs, q, g.qs, b, h, q0, g.q_len, D);

  float m[RPT], l[RPT], acc[RPT][DPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int jd = 0; jd < DPT; ++jd) acc[i][jd] = 0.f;
  }

  const int n_kt = live_k_tiles(g, q0);
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile's readers are done
    load_tile(Ks, k, g.kvs, b, hk, k0, g.kv_len, D);
    load_tile(Vs, v, g.kvs, b, hk, k0, g.kv_len, D);
    __syncthreads();

    float s[RPT][CPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j) s[i][j] = 0.f;
    for (int d = 0; d < D; ++d) {
      float qv[RPT], kv[CPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) qv[i] = Qs[(tr * RPT + i) * ld + d];
#pragma unroll
      for (int j = 0; j < CPT; ++j) kv[j] = Ks[(tc + 16 * j) * ld + d];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < CPT; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int r = tr * RPT + i;
      const int row = q0 + r;
      bool vis[CPT];
      float mc = NEG_INF;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        vis[j] = visible(g, row, k0 + tc + 16 * j);
        s[i][j] *= g.scale;
        if (vis[j]) mc = fmaxf(mc, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mc));
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const float p = expf(vis[j] ? s[i][j] - m_new : NEG_INF);
        Ps[r * (BK + 1) + tc + 16 * j] = p;
        ps += p;
      }
      const float corr = expf(m[i] - m_new);
      l[i] = corr * l[i] + row_sum(ps);
      m[i] = m_new;
#pragma unroll
      for (int jd = 0; jd < DPT; ++jd) acc[i][jd] *= corr;
    }
    __syncthreads();

    for (int kk = 0; kk < BK; ++kk) {
      float pv[RPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) pv[i] = Ps[(tr * RPT + i) * (BK + 1) + kk];
#pragma unroll
      for (int jd = 0; jd < DPT; ++jd) {
        const int c = tc + 16 * jd;
        if (c < D) {
          const float vv = Vs[kk * ld + c];
#pragma unroll
          for (int i = 0; i < RPT; ++i) acc[i][jd] = fmaf(pv[i], vv, acc[i][jd]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int row = q0 + tr * RPT + i;
    if (row >= g.q_len) continue;
    const bool live = l[i] > 0.f;
    const float safe_l = live ? l[i] : 1.f;
    const size_t o = g.qs.at(b, h, row);
#pragma unroll
    for (int jd = 0; jd < DPT; ++jd) {
      const int c = tc + 16 * jd;
      if (c < D) out[o + c] = from_f<T>(acc[i][jd] / safe_l);
    }
    if (tc == 0)
      lse[g.stats.at(b, h, row)] = live ? m[i] + logf(safe_l) : NEG_INF;
  }
}

template <typename T>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, void* out,
                       void* lse, const Geom& g, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * ((size_t)(BQ + 2 * BK) * (g.D + 1) + BQ * (BK + 1));
  cudaError_t err = cudaFuncSetAttribute(
      fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((g.q_len + BQ - 1) / BQ, g.H, g.B);
  fwd_kernel<T><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out),
      static_cast<float*>(lse), g);
  return cudaGetLastError();
}

// Checks the geometry and launches on bf16 (is_bf16) or f32 operands.
// Returns a cudaError_t (0 = launched).
inline int fwd(const void* q, const void* k, const void* v, void* out,
               void* lse, const Geom& g, int is_bf16, void* stream) {
  if (bad_shape(g)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(is_bf16 ? launch_fwd<__nv_bfloat16>(q, k, v, out, lse, g, s)
                       : launch_fwd<float>(q, k, v, out, lse, g, s));
}

}  // namespace flash
