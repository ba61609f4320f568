// The flash-attention dk/dv body, for both layouts (flash_common.cuh): the
// entry points are flash_bwd_dkv.cu (flat) and flash_bhsd_bwd_dkv.cu.
//
// Computes, per (batch, kv head, k row): over the H / Hkv q heads that share
// the kv head and every visible q row, p = exp(scale * q k^T - lse),
// ds = p * (do v^T - delta), dv = sum p^T do, dk = scale * sum ds^T q.
//
// Design: one block per (k tile of 64 rows, kv head, batch). The TPU grid
// walked (q head in group, q block) as its sequential axis; here both the
// group's q heads and the q tiles are loops inside the block, with the
// [64, D] dk and dv accumulators in registers, so each kv head's sum over
// its group happens in one block and dk/dv are written once, with no
// atomics. Causal q tiles that see none of the k tile are skipped
// (first_live_q_tile).
#pragma once

#include "flash_common.cuh"

namespace flash {

template <typename T>
__global__ void __launch_bounds__(THREADS)
    bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const T* __restrict__ dout,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta, T* __restrict__ dk,
                   T* __restrict__ dv, const Geom g) {
  extern __shared__ float smem[];
  const int D = g.D;
  const int ld = D + 1;
  float* Ks = smem;              // [BK][ld]
  float* Vs = Ks + BK * ld;      // [BK][ld]
  float* Qs = Vs + BK * ld;      // [BQ][ld]
  float* dOs = Qs + BQ * ld;     // [BQ][ld]
  float* PTs = dOs + BQ * ld;    // [BK][BQ + 1]: p transposed
  float* DSTs = PTs + BK * (BQ + 1);   // [BK][BQ + 1]: ds transposed
  float* lse_s = DSTs + BK * (BQ + 1);  // [BQ]
  float* delta_s = lse_s + BQ;          // [BQ]

  const int k0 = blockIdx.x * BK;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int groups = g.H / g.Hkv;
  const int tr = threadIdx.x / 16;  // owns k rows tr * RPT + i
  const int tc = threadIdx.x % 16;  // owns q columns tc + 16 * j

  load_tile(Ks, k, g.kvs, b, hk, k0, g.kv_len, D);
  load_tile(Vs, v, g.kvs, b, hk, k0, g.kv_len, D);

  float dk_acc[RPT][DPT], dv_acc[RPT][DPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int jd = 0; jd < DPT; ++jd) dk_acc[i][jd] = dv_acc[i][jd] = 0.f;

  const int qt_begin = first_live_q_tile(g, k0);
  const int n_qt = (g.q_len + BQ - 1) / BQ;
  for (int gi = 0; gi < groups; ++gi) {
    const int h = hk * groups + gi;
    for (int qt = qt_begin; qt < n_qt; ++qt) {
      const int q0 = qt * BQ;
      __syncthreads();
      load_tile(Qs, q, g.qs, b, h, q0, g.q_len, D);
      load_tile(dOs, dout, g.qs, b, h, q0, g.q_len, D);
      load_stats(lse_s, lse, g.stats, b, h, q0, g.q_len);
      load_stats(delta_s, delta, g.stats, b, h, q0, g.q_len);
      __syncthreads();

      float st[RPT][CPT], dpt[RPT][CPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < CPT; ++j) st[i][j] = dpt[i][j] = 0.f;
      for (int d = 0; d < D; ++d) {
        float kv[RPT], vv[RPT], qv[CPT], dov[CPT];
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
          kv[i] = Ks[(tr * RPT + i) * ld + d];
          vv[i] = Vs[(tr * RPT + i) * ld + d];
        }
#pragma unroll
        for (int j = 0; j < CPT; ++j) {
          qv[j] = Qs[(tc + 16 * j) * ld + d];
          dov[j] = dOs[(tc + 16 * j) * ld + d];
        }
#pragma unroll
        for (int i = 0; i < RPT; ++i)
#pragma unroll
          for (int j = 0; j < CPT; ++j) {
            st[i][j] = fmaf(kv[i], qv[j], st[i][j]);
            dpt[i][j] = fmaf(vv[i], dov[j], dpt[i][j]);
          }
      }

#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const int r = tr * RPT + i;
        const int col = k0 + r;
#pragma unroll
        for (int j = 0; j < CPT; ++j) {
          const int qc = tc + 16 * j;
          const bool vis = visible(g, q0 + qc, col);
          const float p =
              expf(vis ? st[i][j] * g.scale - lse_s[qc] : NEG_INF);
          PTs[r * (BQ + 1) + qc] = p;
          DSTs[r * (BQ + 1) + qc] = p * (dpt[i][j] - delta_s[qc]);
        }
      }
      __syncthreads();

      for (int qq = 0; qq < BQ; ++qq) {
        float pv[RPT], dsv[RPT];
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
          pv[i] = PTs[(tr * RPT + i) * (BQ + 1) + qq];
          dsv[i] = DSTs[(tr * RPT + i) * (BQ + 1) + qq];
        }
#pragma unroll
        for (int jd = 0; jd < DPT; ++jd) {
          const int c = tc + 16 * jd;
          if (c < D) {
            const float dov = dOs[qq * ld + c];
            const float qv = Qs[qq * ld + c];
#pragma unroll
            for (int i = 0; i < RPT; ++i) {
              dv_acc[i][jd] = fmaf(pv[i], dov, dv_acc[i][jd]);
              dk_acc[i][jd] = fmaf(dsv[i], qv, dk_acc[i][jd]);
            }
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int row = k0 + tr * RPT + i;
    if (row >= g.kv_len) continue;
    const size_t o = g.kvs.at(b, hk, row);
#pragma unroll
    for (int jd = 0; jd < DPT; ++jd) {
      const int c = tc + 16 * jd;
      if (c < D) {
        dk[o + c] = from_f<T>(g.scale * dk_acc[i][jd]);
        dv[o + c] = from_f<T>(dv_acc[i][jd]);
      }
    }
  }
}

template <typename T>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* dout, const void* lse, const void* delta,
                       void* dk, void* dv, const Geom& g,
                       cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * ((size_t)(2 * BK + 2 * BQ) * (g.D + 1) +
                       2 * BK * (BQ + 1) + 2 * BQ);
  cudaError_t err = cudaFuncSetAttribute(
      bwd_dkv_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((g.kv_len + BK - 1) / BK, g.Hkv, g.B);
  bwd_dkv_kernel<T><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dk), static_cast<T*>(dv), g);
  return cudaGetLastError();
}

// Checks the geometry and launches on bf16 (is_bf16) or f32 operands.
// Returns a cudaError_t (0 = launched).
inline int bwd_dkv(const void* q, const void* k, const void* v,
                   const void* dout, const void* lse, const void* delta,
                   void* dk, void* dv, const Geom& g, int is_bf16,
                   void* stream) {
  if (bad_shape(g)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(is_bf16 ? launch_dkv<__nv_bfloat16>(q, k, v, dout, lse, delta,
                                                   dk, dv, g, s)
                       : launch_dkv<float>(q, k, v, dout, lse, delta, dk, dv,
                                           g, s));
}

}  // namespace flash
