// Flash-attention forward over the projection layout.
//
// Replaces: mpi_operator_tpu/ops/attention.py:_fwd_flat_kernel (the Pallas
// forward launched by _flash_flat_fwd_impl), unpacked (pack == 1) math.
//
// Computes, per (batch, q head, q row): out = softmax(scale * q k^T) v over
// the visible columns of kv head h / (H / Hkv), and lse = m + log(l), with
// the online-softmax recurrence in f32.
//
// What bounds it on an H100: at the Llama shape (B=2, S=2048, H=32, Hkv=8,
// D=128, bf16, causal) the work is ~6.9e10 FLOPs against ~84 MB of
// operands, so the bound is the tensor cores (~0.07 ms at 989 TFLOP/s).
// This first kernel does its products with f32 FMA from shared memory, so
// in practice it is bound by the FMA pipes and shared-memory reads, far
// above that bound; the later work is wgmma + TMA.
//
// Design: one block per (q tile of 64 rows, q head, batch) -- heads sit on
// the grid, where the TPU kernel looped over them inside the program. The
// TPU grid's sequential k axis is a loop inside the block; the running max
// m, sum l and the [64, D] accumulator stay in registers, so the [Sq, Sk]
// score matrix never reaches device memory. Causal dead k tiles are never
// loaded (live_k_tiles), and GQA shares kv heads by index, never by copy.
#include "flash_common.cuh"

namespace flash {

template <typename T>
__global__ void __launch_bounds__(THREADS)
    fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, T* __restrict__ out,
               float* __restrict__ lse, int q_len, int kv_len, int H,
               int Hkv, int D, float scale, int causal) {
  extern __shared__ float smem[];
  const int ld = D + 1;
  float* Qs = smem;           // [BQ][ld]
  float* Ks = Qs + BQ * ld;   // [BK][ld]
  float* Vs = Ks + BK * ld;   // [BK][ld]
  float* Ps = Vs + BK * ld;   // [BQ][BK + 1]

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int tr = threadIdx.x / 16;
  const int tc = threadIdx.x % 16;

  load_tile(Qs, q, b, q0, q_len, H, h, D);

  float m[RPT], l[RPT], acc[RPT][DPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int jd = 0; jd < DPT; ++jd) acc[i][jd] = 0.f;
  }

  const int n_kt = live_k_tiles(q0, q_len, kv_len, causal);
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile's readers are done
    load_tile(Ks, k, b, k0, kv_len, Hkv, hk, D);
    load_tile(Vs, v, b, k0, kv_len, Hkv, hk, D);
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
        vis[j] = visible(row, k0 + tc + 16 * j, q_len, kv_len, causal);
        s[i][j] *= scale;
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
    if (row >= q_len) continue;
    const bool live = l[i] > 0.f;
    const float safe_l = live ? l[i] : 1.f;
    const size_t o = offset(b, row, q_len, H, h, D);
#pragma unroll
    for (int jd = 0; jd < DPT; ++jd) {
      const int c = tc + 16 * jd;
      if (c < D) out[o + c] = from_f<T>(acc[i][jd] / safe_l);
    }
    if (tc == 0)
      lse[((size_t)b * q_len + row) * H + h] =
          live ? m[i] + logf(safe_l) : NEG_INF;
  }
}

template <typename T>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, void* out,
                       void* lse, int B, int q_len, int kv_len, int H,
                       int Hkv, int D, float scale, int causal,
                       cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * ((size_t)(BQ + 2 * BK) * (D + 1) + BQ * (BK + 1));
  cudaError_t err = cudaFuncSetAttribute(
      fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((q_len + BQ - 1) / BQ, H, B);
  fwd_kernel<T><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out),
      static_cast<float*>(lse), q_len, kv_len, H, Hkv, D, scale, causal);
  return cudaGetLastError();
}

}  // namespace flash

// q [B, q_len, H*D], k/v [B, kv_len, Hkv*D] (bf16 when is_bf16, else f32),
// out like q, lse f32 [B, q_len, H]. Returns a cudaError_t (0 = launched).
extern "C" int flash_fwd(const void* q, const void* k, const void* v,
                         void* out, void* lse, int B, int q_len, int kv_len,
                         int H, int Hkv, int D, float scale, int causal,
                         int is_bf16, void* stream) {
  if (flash::bad_shape(B, q_len, kv_len, H, Hkv, D))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_bf16 ? flash::launch_fwd<__nv_bfloat16>(q, k, v, out, lse, B, q_len,
                                                 kv_len, H, Hkv, D, scale,
                                                 causal, s)
              : flash::launch_fwd<float>(q, k, v, out, lse, B, q_len, kv_len,
                                         H, Hkv, D, scale, causal, s);
  return (int)err;
}
