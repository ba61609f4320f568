// The flash-attention forward body, for both layouts (flash_common.cuh):
// the entry points are flash_fwd.cu (flat) and flash_bhsd_fwd.cu.
//
// Replaces mpi_operator_tpu/ops/attention.py:_fwd_flat_kernel and
// _fwd_kernel (and, at D = 64, hack/headdim_probe.py:_fwd_packed_kernel).
// Computes, per (batch, q head, q row): out = softmax(scale * q k^T) v over
// the visible columns of kv head h / (H / Hkv), and lse = m + log(l), with
// the online-softmax recurrence in f32.
//
// What bounds it on an H100: 4 * D FLOPs per visible (q, k) pair, on the
// tensor cores at 989 TFLOP/s in bf16: 6.9e10 FLOPs, 0.07 ms, at the causal
// Llama shape; at the BERT-base shape (D = 64, non-causal) the operands'
// 0.2 GB at 3.35 TB/s (0.061 ms) weigh a little more than its 5.2e10 FLOPs.
// Either way the products have to run on the tensor cores, and the k / v
// loads have to overlap them.
//
// bf16 design (fwd_kernel_tc): one block per (q tile of 128 rows, q head,
// batch), 256 threads = two warpgroups of 64 q rows that share each k / v
// tile. S = Q K^T is a wgmma with both operands in swizzled shared memory
// (K as stored is the K-major B operand); the mask (skipped on tiles that
// need none), the running max m, the sum l and the [64, D] O
// accumulator stay in registers in f32; P, rounded to bf16, is the register
// A operand of O += P V, with V read MN-major (no transpose pass). K and V
// arrive by 16-byte cp.async into a 2-stage ring, tile j + 1 in flight
// while tile j is multiplied. Dead k tiles are never loaded: causal ones
// past the diagonal (live_k_tiles) and, with ids, those the id ranges
// rule out (live_tiles: the block walks its list of live k tiles, each
// one's column ids arriving in the ring beside K and V, its rows' ids in
// registers; a fully visible tile takes the unmasked softmax; a q tile
// with no live k tile writes its zeros in 16-byte stores). The last
// (heaviest) q tiles are launched first, and GQA shares kv heads by
// index, never by copy.
//
// Tiles and budget: BQ = 128, BK = 64 at both instantiated head dims (64
// and 128; another D that is a multiple of 8 runs on the next one with its
// columns past D zero-filled). Shared memory Q 128 x DP + 2 stages x (K +
// V) 64 x DP in bf16: 49 KB at DP = 64, 97 KB at DP = 128, so two blocks
// fit an SM's 228 KB; with ids 512 B of column ids and the live list, 4 B
// a k tile, more; registers (launch bound 2 blocks of 256 threads, <= 128
// a thread): O DP / 2, S 32, m and l 4, P 16 (reusing S). Each body is
// instantiated without and with ids (IDS), so that neither carries the
// other's state: the no-id one is the design above unchanged, and at
// DP = 128 it sits at the 128-register bound.
//
// f32 (fwd_kernel_simt): f32 FMA on tiles staged in shared memory, the
// 64 x 64 SIMT thread map of flash_common.cuh, with the same tile walk (its
// ids classified on 64 x 64 tiles). It is for checks that hold f32 to
// 2e-5; f32 has no tensor-core path of that precision.
#pragma once

#include "flash_common.cuh"

namespace flash {

// ---------------------------------------------------------------------------
// bf16: the tensor-core body
// ---------------------------------------------------------------------------

template <int DP>
struct FwdTc {
  static constexpr int BQ = 128;       // two warpgroups of 64 q rows
  static constexpr int BK = 64;        // k / v rows per ring stage
  static constexpr int THREADS = 256;
  static constexpr int NB = DP / 64;   // 64-column blocks of the head dim
  static constexpr int Q_BYTES = BQ * DP * 2;
  static constexpr int KV_BYTES = BK * DP * 2;  // one K or V tile
  static constexpr int SMEM = Q_BYTES + 4 * KV_BYTES + 1024;  // + alignment
  static constexpr int IDS_BYTES = 2 * BK * 4;  // with ids: column ids
};

// One k tile's online-softmax step on a warpgroup's S accumulator: s
// becomes p = exp(scale * s - m_new) (0 where bit i of vis is clear, when
// MASK), and l and o are rescaled to the new running max. m is kept in
// the log2 domain (m * log2 e), so p is one exp2f per element.
template <bool MASK, int NB>
__device__ __forceinline__ void fwd_softmax(float (&s)[32], float (&m)[2],
                                            float (&l)[2],
                                            float (&o)[NB][32], uint32_t vis,
                                            float scale_log2) {
  float mc[2] = {NEG_INF, NEG_INF};
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    s[i] *= scale_log2;
    if (!MASK || ((vis >> i) & 1u))
      mc[(i >> 1) & 1] = fmaxf(mc[(i >> 1) & 1], s[i]);
  }
  float corr[2], ps[2] = {0.f, 0.f};
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const float m_new = fmaxf(m[hh], hopper::quad_max(mc[hh]));
    corr[hh] = exp2f(m[hh] - m_new);
    m[hh] = m_new;
  }
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int hh = (i >> 1) & 1;
    const float p =
        (!MASK || ((vis >> i) & 1u)) ? exp2f(s[i] - m[hh]) : 0.f;
    s[i] = p;
    ps[hh] += p;
  }
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) l[hh] = corr[hh] * l[hh] + ps[hh];
#pragma unroll
  for (int cb = 0; cb < NB; ++cb)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[cb][i] *= corr[(i >> 1) & 1];
}

// IDS: the instantiation for launches with row/col ids (the other never
// reads them), so neither carries the other's state in registers.
template <int DP, bool IDS>
__global__ void __launch_bounds__(FwdTc<DP>::THREADS, 2)
    fwd_kernel_tc(const __nv_bfloat16* __restrict__ q,
                  const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v,
                  __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
                  const Geom g) {
  using T = FwdTc<DP>;
  constexpr int BQ = T::BQ, BK = T::BK, NT = T::THREADS, NB = T::NB;
  extern __shared__ __align__(1024) unsigned char smem[];
  const uint32_t raw = hopper::smem_addr(smem);
  const uint32_t sQ = (raw + 1023u) & ~1023u;
  const uint32_t sKV = sQ + T::Q_BYTES;  // stage st: K, then V
  constexpr uint32_t KVB = T::KV_BYTES;
  // With ids: stage st's column ids, then the live k tiles.
  const uint32_t sCid = sKV + 4 * KVB;
  const int* cids = reinterpret_cast<const int*>(smem + (sCid - raw));
  int* list = reinterpret_cast<int*>(smem + (sCid + T::IDS_BYTES - raw));

  const int wg = threadIdx.x / 128;
  const int warp = (threadIdx.x / 32) % 4;
  const int lane = threadIdx.x % 32;
  // Heads and batches vary fastest on the grid; the last q tiles, the
  // heaviest under causal masking, go first.
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const int h = blockIdx.x % g.H;
  const int b = blockIdx.x / g.H;
  const int hk = h / (g.H / g.Hkv);
  const float scale_log2 = g.scale * LOG2E;

  // Step kt walks every k tile up to the causal bound, or with ids the
  // live list's kt-th.
  const int n_kt =
      IDS ? live_tiles<BQ, BK, true>(list, g, q0) : live_k_tiles<BQ, BK>(g, q0);
  if (IDS && n_kt == 0) {  // no row sees any column: out 0, lse NEG_INF
    write_dead_rows<BQ>(out, g.qs, b, h, q0, g.q_len, g.D, lse, g.stats,
                        NEG_INF);
    return;
  }
  if (n_kt > 0) {
    const int k1 = IDS ? (list[0] >> 1) * BK : 0;
    load_tile_async<BQ, DP, NT>(sQ, q, g.qs, b, h, q0, g.q_len, g.D);
    load_tile_async<BK, DP, NT>(sKV, k, g.kvs, b, hk, k1, g.kv_len, g.D);
    load_tile_async<BK, DP, NT>(sKV + KVB, v, g.kvs, b, hk, k1, g.kv_len,
                                g.D);
    if constexpr (IDS) load_ids_async(sCid, g.col_ids, k1, g.kv_len);
    hopper::cp_async_commit();
  }

  float o[NB][32];
#pragma unroll
  for (int cb = 0; cb < NB; ++cb)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[cb][i] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  const int row0 = q0 + wg * 64 + warp * 16 + lane / 4;
  int rid[2];  // with ids, the ids of the thread's two rows
  if constexpr (IDS) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
      rid[hh] = row0 + 8 * hh < g.q_len ? g.row_ids[row0 + 8 * hh] : 0;
  }
  const uint32_t sQw = sQ + wg * 64 * 128;  // this warpgroup's 64 rows

  for (int kt = 0; kt < n_kt; ++kt) {
    const uint32_t sK = sKV + (kt & 1) * 2 * KVB;
    const uint32_t sV = sK + KVB;
    if (kt + 1 < n_kt) {
      const uint32_t nK = sKV + ((kt + 1) & 1) * 2 * KVB;
      const int k1 = (IDS ? list[kt + 1] >> 1 : kt + 1) * BK;
      load_tile_async<BK, DP, NT>(nK, k, g.kvs, b, hk, k1, g.kv_len, g.D);
      load_tile_async<BK, DP, NT>(nK + KVB, v, g.kvs, b, hk, k1, g.kv_len,
                                  g.D);
      if constexpr (IDS)
        load_ids_async(sCid + ((kt + 1) & 1) * BK * 4, g.col_ids, k1,
                       g.kv_len);
      hopper::cp_async_commit();
      hopper::cp_async_wait<1>();
    } else {
      hopper::cp_async_wait<0>();
    }
    hopper::fence_proxy_async();
    __syncthreads();

    // S = Q K^T over the head dim, 16 at a time.
    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk)
      hopper::mma_ss(s,
                     hopper::k_major(sQw + (kk / 4) * BQ * 128 + (kk % 4) * 32),
                     hopper::k_major(sK + (kk / 4) * BK * 128 + (kk % 4) * 32),
                     kk > 0);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(s);

    const int e = IDS ? list[kt] : 0;  // with ids: the tile, TILE_FULL
    const int k0 = (IDS ? e >> 1 : kt) * BK;
    const int col0 = k0 + 2 * (lane % 4);
    if (IDS ? (e & TILE_FULL) != 0 : fully_visible<BQ, BK>(g, q0, k0))
      fwd_softmax<false, NB>(s, m, l, o, 0u, scale_log2);
    else
      fwd_softmax<true, NB>(
          s, m, l, o,
          IDS ? acc_visible_ids(rid, cids + (kt & 1) * BK, col0 - k0,
                                g.kv_len - k0)
              : acc_visible(g, row0, col0),
          scale_log2);

    // O += P V, P from registers.
    uint32_t pa[4][4];
    hopper::a_fragments(s, pa);
#pragma unroll
    for (int cb = 0; cb < NB; ++cb) hopper::fence_regs(o[cb]);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
      for (int cb = 0; cb < NB; ++cb)
        hopper::mma_rs(o[cb], pa[kk],
                       hopper::mn_major(sV + cb * BK * 128 + kk * 16 * 128));
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
#pragma unroll
    for (int cb = 0; cb < NB; ++cb) hopper::fence_regs(o[cb]);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) hopper::fence_regs(pa[kk]);
    __syncthreads();  // both warpgroups are done with the stage
  }

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = row0 + 8 * hh;
    const float lsum = hopper::quad_sum(l[hh]);
    if (row >= g.q_len) continue;
    const float inv = lsum > 0.f ? 1.f / lsum : 0.f;  // a dead row: o = 0
    __nv_bfloat16* orow = out + g.qs.at(b, h, row);
#pragma unroll
    for (int cb = 0; cb < NB; ++cb)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = cb * 64 + 8 * j + 2 * (lane % 4);
        if (col < g.D)
          *reinterpret_cast<uint32_t*>(orow + col) = hopper::pack_bf16(
              o[cb][4 * j + 2 * hh] * inv, o[cb][4 * j + 2 * hh + 1] * inv);
      }
    if (lane % 4 == 0)
      lse[g.stats.at(b, h, row)] =
          lsum > 0.f ? (m[hh] + log2f(lsum)) * LN2 : NEG_INF;
  }
}

template <int DP>
cudaError_t launch_fwd_tc(const void* q, const void* k, const void* v,
                          void* out, void* lse, const Geom& g,
                          cudaStream_t stream) {
  using T = FwdTc<DP>;
  const int n_qt = (g.q_len + T::BQ - 1) / T::BQ;
  if (n_qt > MAX_GRID_YZ || (long long)g.B * g.H > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  const bool ids = g.row_ids != nullptr;
  const auto kernel = ids ? fwd_kernel_tc<DP, true> : fwd_kernel_tc<DP, false>;
  const int smem =
      T::SMEM + (ids ? T::IDS_BYTES + id_list_bytes(g.kv_len, T::BK) : 0);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)(g.B * g.H), n_qt);
  kernel<<<grid, T::THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out),
      static_cast<float*>(lse), g);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// f32: the SIMT body
// ---------------------------------------------------------------------------

// IDS: the instantiation for launches with row/col ids.
template <typename T, bool IDS>
__global__ void __launch_bounds__(THREADS)
    fwd_kernel_simt(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, T* __restrict__ out,
                    float* __restrict__ lse, const Geom g) {
  extern __shared__ float smem_f[];
  const int D = g.D;
  const int ld = D + 1;
  float* Qs = smem_f;         // [BQ][ld]
  float* Ks = Qs + BQ * ld;   // [BK][ld]
  float* Vs = Ks + BK * ld;   // [BK][ld]
  float* Ps = Vs + BK * ld;   // [BQ][BK + 1]
  // With ids: the k tile's column ids, then the live k tiles.
  int* Cid = reinterpret_cast<int*>(Ps + BQ * (BK + 1));  // [BK]
  int* list = Cid + BK;

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (g.H / g.Hkv);
  const int tr = threadIdx.x / 16;
  const int tc = threadIdx.x % 16;
  constexpr bool ids = IDS;

  load_tile(Qs, q, g.qs, b, h, q0, g.q_len, D);

  float m[RPT], l[RPT], acc[RPT][DPT];
  int rid[RPT];  // with ids, the ids of the thread's rows
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int jd = 0; jd < DPT; ++jd) acc[i][jd] = 0.f;
    const int row = q0 + tr * RPT + i;
    rid[i] = ids && row < g.q_len ? g.row_ids[row] : 0;
  }

  // Step it walks every k tile up to the causal bound, or with ids the
  // live list's it-th (e: the entry, with its TILE_FULL bit).
  const int n_kt = ids ? live_tiles<BQ, BK, true>(list, g, q0)
                       : live_k_tiles(g, q0);
  for (int it = 0; it < n_kt; ++it) {
    const int e = ids ? list[it] : 0;
    const int k0 = (ids ? e >> 1 : it) * BK;
    __syncthreads();  // the previous tile's readers are done
    load_tile(Ks, k, g.kvs, b, hk, k0, g.kv_len, D);
    load_tile(Vs, v, g.kvs, b, hk, k0, g.kv_len, D);
    if (ids) load_ids(Cid, g.col_ids, k0, g.kv_len);
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
        const int c = tc + 16 * j;
        vis[j] = ids ? (e & TILE_FULL) ||
                           (c < g.kv_len - k0 && Cid[c] <= rid[i])
                     : visible(g, row, k0 + c);
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
cudaError_t launch_fwd_simt(const void* q, const void* k, const void* v,
                            void* out, void* lse, const Geom& g,
                            cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * ((size_t)(BQ + 2 * BK) * (g.D + 1) + BQ * (BK + 1)) +
      (g.row_ids != nullptr ? 4 * BK + id_list_bytes(g.kv_len, BK) : 0);
  const auto kernel =
      g.row_ids != nullptr ? fwd_kernel_simt<T, true> : fwd_kernel_simt<T, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((g.q_len + BQ - 1) / BQ, g.H, g.B);
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out),
      static_cast<float*>(lse), g);
  return cudaGetLastError();
}

// Checks the geometry and launches: bf16 operands (is_bf16) on the
// tensor-core body at the instantiated head dim that covers D, f32 on the
// SIMT body. Returns a cudaError_t (0 = launched).
inline int fwd(const void* q, const void* k, const void* v, void* out,
               void* lse, const Geom& g, int is_bf16, void* stream) {
  if (bad_shape(g)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!is_bf16) return (int)launch_fwd_simt<float>(q, k, v, out, lse, g, s);
  if (bad_tc_operands(g, {q, k, v, out})) return (int)cudaErrorInvalidValue;
  return (int)(g.D <= 64 ? launch_fwd_tc<64>(q, k, v, out, lse, g, s)
                         : launch_fwd_tc<128>(q, k, v, out, lse, g, s));
}

}  // namespace flash
