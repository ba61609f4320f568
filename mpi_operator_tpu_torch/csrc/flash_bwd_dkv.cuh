// The flash-attention dk/dv body, for both layouts (flash_common.cuh): the
// entry points are flash_bwd_dkv.cu (flat) and flash_bhsd_bwd_dkv.cu.
//
// Replaces mpi_operator_tpu/ops/attention.py:_bwd_flat_dkv_kernel and
// _bwd_dkv_kernel. Computes, per (batch, kv head, k row): over the H / Hkv
// q heads that share the kv head and every visible q row,
// p = exp(scale * q k^T - lse), ds = p * (do v^T - delta), dv = sum p^T do,
// dk = scale * sum ds^T q.
//
// What bounds it on an H100: four S x S x D products per q head, 8 * D
// FLOPs per visible pair on the tensor cores at 989 TFLOP/s in bf16:
// 1.4e11 FLOPs, 0.14 ms, at the causal Llama shape and 1.0e11, 0.10 ms, at
// the BERT-base shape, against 0.1-0.2 GB of operands (0.03-0.06 ms).
//
// bf16 design (bwd_dkv_kernel_tc): one block per (k tile of 128 rows, kv
// head, batch), 256 threads = two warpgroups of 64 k rows; the group's q
// heads and their q tiles of 64 rows are a loop inside the block, so each
// kv head's sum over its group happens in one block and dk / dv are
// written once, with no atomics and no expanded kv. Every product is a
// wgmma whose A operand is K or V from shared memory or a register
// accumulator, so no tile is ever transposed:
// - S^T = K Q^T and dP^T = V dO^T: A is K or V, B is Q or dO as stored
//   (K-major), both in swizzled shared memory;
// - P^T = exp(scale S^T - lse) and dS^T = P^T (dP^T - delta) in registers,
//   in f32, with the mask (visible(), skipped on tiles that need none);
// - dV += P^T dO and dK += dS^T Q: A is the bf16 rounding of the register
//   accumulator, B is dO or Q read MN-major.
// The dK and dV accumulators stay in f32 registers across the whole loop;
// dk is scaled once, at the end. K and V are loaded once; Q, dO, lse and
// delta arrive by cp.async in a 2-stage ring, step j + 1 in flight while
// step j is multiplied. Causal q tiles that see none of the k tile are
// skipped (first_live_q_tile); the k tile index runs slowest on the grid,
// from the first tile, so the heaviest tiles (every later q row sees the
// first k columns) are launched first.
//
// Tiles and budget: BK = 128, BQ = 64 at both instantiated head dims (64
// and 128; another D that is a multiple of 8 runs on the next one, zero-
// filled). Shared memory K + V 128 x DP, 2 stages x (Q + dO) 64 x DP in
// bf16, lse and delta: 66 KB at DP = 64, 130 KB at DP = 128. Registers: dK
// and dV DP / 2 each, S^T and dP^T 32 each, so 192 accumulator registers a
// thread at DP = 128: one block of 256 threads an SM (<= 255 a thread).
//
// f32 (bwd_dkv_kernel_simt): f32 FMA on tiles staged in shared memory, the
// 64 x 64 SIMT thread map of flash_common.cuh; for the f32 checks.
#pragma once

#include "flash_common.cuh"

namespace flash {

// ---------------------------------------------------------------------------
// bf16: the tensor-core body
// ---------------------------------------------------------------------------

template <int DP>
struct DkvTc {
  static constexpr int BK = 128;      // two warpgroups of 64 k rows
  static constexpr int BQ = 64;       // q rows per ring stage
  static constexpr int THREADS = 256;
  static constexpr int NB = DP / 64;  // 64-column blocks of the head dim
  static constexpr int KV_BYTES = BK * DP * 2;  // K or V
  static constexpr int Q_BYTES = BQ * DP * 2;   // one Q or dO tile
  static constexpr int STATS_BYTES = 2 * BQ * 4;  // lse, delta of a stage
  // K, V, then per stage Q and dO, then per stage lse and delta.
  static constexpr int SMEM =
      2 * KV_BYTES + 4 * Q_BYTES + 2 * STATS_BYTES + 1024;
};

// P^T and dS^T of one step, in place of the S^T and dP^T accumulators.
// lse_s and delta_s hold the step's q rows; lse is in natural units.
template <bool MASK>
__device__ __forceinline__ void dkv_probs(float (&s)[32], float (&dp)[32],
                                          const float* lse_s,
                                          const float* delta_s, const Geom& g,
                                          int q0, int krow0, int qc0,
                                          float scale_log2) {
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int qc = qc0 + hopper::acc_col(i);
    const bool vis =
        !MASK || visible(g, q0 + qc, krow0 + hopper::acc_row(i));
    const float p =
        vis ? exp2f(s[i] * scale_log2 - lse_s[qc] * LOG2E) : 0.f;
    s[i] = p;
    dp[i] = p * (dp[i] - delta_s[qc]);
  }
}

template <int DP>
__global__ void __launch_bounds__(DkvTc<DP>::THREADS, 1)
    bwd_dkv_kernel_tc(const __nv_bfloat16* __restrict__ q,
                      const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v,
                      const __nv_bfloat16* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta,
                      __nv_bfloat16* __restrict__ dk,
                      __nv_bfloat16* __restrict__ dv, const Geom g) {
  using T = DkvTc<DP>;
  constexpr int BQ = T::BQ, BK = T::BK, NT = T::THREADS, NB = T::NB;
  extern __shared__ __align__(1024) unsigned char smem[];
  const uint32_t raw = hopper::smem_addr(smem);
  const uint32_t sK = (raw + 1023u) & ~1023u;
  const uint32_t sV = sK + T::KV_BYTES;
  const uint32_t sQ0 = sV + T::KV_BYTES;  // stage st: Q, then dO
  const uint32_t sStats0 = sQ0 + 4 * T::Q_BYTES;
  const float* stats0 =
      reinterpret_cast<const float*>(smem + (sStats0 - raw));

  const int wg = threadIdx.x / 128;
  const int warp = (threadIdx.x / 32) % 4;
  const int lane = threadIdx.x % 32;
  const int k0 = blockIdx.y * BK;
  const int hk = blockIdx.x % g.Hkv;
  const int b = blockIdx.x / g.Hkv;
  const int groups = g.H / g.Hkv;
  const float scale_log2 = g.scale * LOG2E;

  const int qt_begin = first_live_q_tile<BQ>(g, k0);
  const int per_head = (g.q_len + BQ - 1) / BQ - qt_begin;
  const int steps = groups * per_head;

  // Step j: q tile qt_begin + j % per_head of q head hk * groups +
  // j / per_head, into stage j % 2.
  auto load_step = [&](int j) {
    const int h = hk * groups + j / per_head;
    const int q0 = (qt_begin + j % per_head) * BQ;
    const uint32_t sQ = sQ0 + (j & 1) * 2 * T::Q_BYTES;
    load_tile_async<BQ, DP, NT>(sQ, q, g.qs, b, h, q0, g.q_len, g.D);
    load_tile_async<BQ, DP, NT>(sQ + T::Q_BYTES, dout, g.qs, b, h, q0,
                                g.q_len, g.D);
    if (threadIdx.x < 2 * BQ) {  // lse by the first BQ threads, delta next
      const int r = threadIdx.x % BQ;
      const float* src = threadIdx.x < BQ ? lse : delta;
      const bool ok = q0 + r < g.q_len;
      hopper::cp_async4(sStats0 + (j & 1) * T::STATS_BYTES + threadIdx.x * 4,
                        ok ? src + g.stats.at(b, h, q0 + r) : src, ok);
    }
    hopper::cp_async_commit();
  };

  load_tile_async<BK, DP, NT>(sK, k, g.kvs, b, hk, k0, g.kv_len, g.D);
  load_tile_async<BK, DP, NT>(sV, v, g.kvs, b, hk, k0, g.kv_len, g.D);
  hopper::cp_async_commit();
  if (steps > 0) load_step(0);

  float dk_acc[NB][32], dv_acc[NB][32];
#pragma unroll
  for (int cb = 0; cb < NB; ++cb)
#pragma unroll
    for (int i = 0; i < 32; ++i) dk_acc[cb][i] = dv_acc[cb][i] = 0.f;
  const int krow0 = k0 + wg * 64 + warp * 16 + lane / 4;
  const int qc0 = 2 * (lane % 4);
  const uint32_t wrows = wg * 64 * 128;  // this warpgroup's 64 k rows

  for (int j = 0; j < steps; ++j) {
    const int q0 = (qt_begin + j % per_head) * BQ;
    const uint32_t sQ = sQ0 + (j & 1) * 2 * T::Q_BYTES;
    const uint32_t sdO = sQ + T::Q_BYTES;
    const float* lse_s = stats0 + (j & 1) * 2 * BQ;
    const float* delta_s = lse_s + BQ;
    if (j + 1 < steps) {
      load_step(j + 1);
      hopper::cp_async_wait<1>();
    } else {
      hopper::cp_async_wait<0>();
    }
    hopper::fence_proxy_async();
    __syncthreads();

    // S^T = K Q^T and dP^T = V dO^T over the head dim.
    float s[32], dp[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      const uint32_t a = (kk / 4) * BK * 128 + wrows + (kk % 4) * 32;
      const uint32_t bo = (kk / 4) * BQ * 128 + (kk % 4) * 32;
      hopper::mma_ss(s, hopper::k_major(sK + a), hopper::k_major(sQ + bo),
                     kk > 0);
      hopper::mma_ss(dp, hopper::k_major(sV + a), hopper::k_major(sdO + bo),
                     kk > 0);
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(s);
    hopper::fence_regs(dp);

    if (fully_visible<BQ, BK>(g, q0, k0))
      dkv_probs<false>(s, dp, lse_s, delta_s, g, q0, krow0, qc0, scale_log2);
    else
      dkv_probs<true>(s, dp, lse_s, delta_s, g, q0, krow0, qc0, scale_log2);

    // dV += P^T dO and dK += dS^T Q, A from registers.
    uint32_t pa[4][4], da[4][4];
    hopper::a_fragments(s, pa);
    hopper::a_fragments(dp, da);
#pragma unroll
    for (int cb = 0; cb < NB; ++cb) {
      hopper::fence_regs(dk_acc[cb]);
      hopper::fence_regs(dv_acc[cb]);
    }
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk)
#pragma unroll
      for (int cb = 0; cb < NB; ++cb) {
        const uint32_t bo = cb * BQ * 128 + kk * 16 * 128;
        hopper::mma_rs(dv_acc[cb], pa[kk], hopper::mn_major(sdO + bo));
        hopper::mma_rs(dk_acc[cb], da[kk], hopper::mn_major(sQ + bo));
      }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
#pragma unroll
    for (int cb = 0; cb < NB; ++cb) {
      hopper::fence_regs(dk_acc[cb]);
      hopper::fence_regs(dv_acc[cb]);
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      hopper::fence_regs(pa[kk]);
      hopper::fence_regs(da[kk]);
    }
    __syncthreads();  // both warpgroups are done with the stage
  }
  hopper::cp_async_wait<0>();  // K and V, when there was no step

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = krow0 + 8 * hh;
    if (row >= g.kv_len) continue;
    const size_t o = g.kvs.at(b, hk, row);
#pragma unroll
    for (int cb = 0; cb < NB; ++cb)
#pragma unroll
      for (int jc = 0; jc < 8; ++jc) {
        const int col = cb * 64 + 8 * jc + qc0;
        if (col >= g.D) continue;
        const int i = 4 * jc + 2 * hh;
        *reinterpret_cast<uint32_t*>(dk + o + col) = hopper::pack_bf16(
            g.scale * dk_acc[cb][i], g.scale * dk_acc[cb][i + 1]);
        *reinterpret_cast<uint32_t*>(dv + o + col) =
            hopper::pack_bf16(dv_acc[cb][i], dv_acc[cb][i + 1]);
      }
  }
}

template <int DP>
cudaError_t launch_dkv_tc(const void* q, const void* k, const void* v,
                          const void* dout, const void* lse, const void* delta,
                          void* dk, void* dv, const Geom& g,
                          cudaStream_t stream) {
  using T = DkvTc<DP>;
  const int n_kt = (g.kv_len + T::BK - 1) / T::BK;
  if (n_kt > MAX_GRID_YZ || (long long)g.B * g.Hkv > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      bwd_dkv_kernel_tc<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      T::SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)(g.B * g.Hkv), n_kt);
  bwd_dkv_kernel_tc<DP><<<grid, T::THREADS, T::SMEM, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v),
      static_cast<const __nv_bfloat16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), g);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// f32: the SIMT body
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(THREADS)
    bwd_dkv_kernel_simt(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta, T* __restrict__ dk,
                        T* __restrict__ dv, const Geom g) {
  extern __shared__ float smem_f[];
  const int D = g.D;
  const int ld = D + 1;
  float* Ks = smem_f;            // [BK][ld]
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
cudaError_t launch_dkv_simt(const void* q, const void* k, const void* v,
                            const void* dout, const void* lse,
                            const void* delta, void* dk, void* dv,
                            const Geom& g, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * ((size_t)(2 * BK + 2 * BQ) * (g.D + 1) +
                       2 * BK * (BQ + 1) + 2 * BQ);
  cudaError_t err = cudaFuncSetAttribute(
      bwd_dkv_kernel_simt<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((g.kv_len + BK - 1) / BK, g.Hkv, g.B);
  bwd_dkv_kernel_simt<T><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dk), static_cast<T*>(dv), g);
  return cudaGetLastError();
}

// Checks the geometry and launches: bf16 operands (is_bf16) on the
// tensor-core body at the instantiated head dim that covers D, f32 on the
// SIMT body. Returns a cudaError_t (0 = launched).
inline int bwd_dkv(const void* q, const void* k, const void* v,
                   const void* dout, const void* lse, const void* delta,
                   void* dk, void* dv, const Geom& g, int is_bf16,
                   void* stream) {
  if (bad_shape(g)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!is_bf16)
    return (int)launch_dkv_simt<float>(q, k, v, dout, lse, delta, dk, dv, g,
                                       s);
  if (bad_tc_operands(g, {q, k, v, dout, dk, dv}))
    return (int)cudaErrorInvalidValue;
  return (int)(g.D <= 64 ? launch_dkv_tc<64>(q, k, v, dout, lse, delta, dk,
                                             dv, g, s)
                         : launch_dkv_tc<128>(q, k, v, dout, lse, delta, dk,
                                              dv, g, s));
}

}  // namespace flash
