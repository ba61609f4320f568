// The flash-attention dq body, for both layouts (flash_common.cuh): the
// entry points are flash_bwd_dq.cu (flat) and flash_bhsd_bwd_dq.cu.
//
// Replaces mpi_operator_tpu/ops/attention.py:_bwd_flat_dq_kernel and
// _bwd_dq_kernel. Computes, per (batch, q head, q row): p = exp(scale *
// q k^T - lse) over the visible columns (recomputed from the forward's
// lse, never stored), ds = p * (do v^T - delta), dq = scale * ds k, where
// delta = rowsum(do * o) (less the lse cotangent, when there is one) comes
// from the wrapper in the layout of lse.
//
// What bounds it on an H100: three S x S x D products per q head, 6 * D
// FLOPs per visible pair on the tensor cores at 989 TFLOP/s in bf16:
// 1.0e11 FLOPs, 0.10 ms, at the causal Llama shape and 7.7e10, 0.078 ms,
// at the BERT-base shape, against 0.1-0.26 GB of operands (0.03-0.08 ms).
//
// bf16 design (bwd_dq_kernel_tc): one block per (q tile of 128 rows, q
// head, batch), 256 threads = two warpgroups of 64 q rows that share each
// k / v tile (at DP = 256: 64 rows, one warpgroup; see the budget below);
// the k tiles are a loop inside the block with the dQ
// accumulator in f32 registers, so dq is scaled and written once, with no
// atomics and no expanded kv (GQA by index). Every product is a wgmma, and
// no tile is ever transposed:
// - S = Q K^T and dP = dO V^T: A is Q or dO, B is K or V as stored
//   (K-major), all in swizzled shared memory;
// - P = exp(scale S - lse) and dS = P (dP - delta) in registers, in f32,
//   with the mask (skipped on tiles that need none); each thread keeps
//   lse and delta of its two accumulator rows in registers, and with ids
//   their ids too;
// - dQ += dS K: A is the bf16 rounding of dS (as the reference rounds ds
//   to the operand type), B is the same swizzled K tile read MN-major.
// Q and dO are loaded once; K and V arrive by cp.async in a 2-stage ring,
// tile j + 1 in flight while tile j is multiplied. Dead k tiles are never
// loaded: causal ones (live_k_tiles) and, with ids, those the id ranges
// rule out (live_tiles; each live tile's column ids arrive in the ring
// beside K and V, and a fully visible tile takes no mask), as in the
// forward; the q tile index runs slowest on the grid, from the last tile,
// so the heaviest causal tiles are launched first.
//
// Tiles and budget: BK = 64 at the three instantiated head dims (64, 128
// and 256; another D that is a multiple of 8 runs on the next one,
// zero-filled), BQ = 128 at DP <= 128. Shared memory Q + dO BQ x DP and 2
// stages x (K + V) 64 x DP in bf16: 65 KB at DP = 64 (two blocks an SM),
// 129 KB at DP = 128 (one). At DP = 256 that layout would take 256 KB,
// over the 227 KB a block may have, so the block holds BQ = 64 q rows, one
// warpgroup of 128 threads, and keeps the 2-stage ring: 193 KB (one block
// an SM). Registers: dQ DP / 2, S 32, dP 32 f32 accumulators a thread, so
// 128 at DP = 128 (launch bound one block, <= 255 a thread), 96 at DP = 64
// (two blocks, <= 128 a thread) and 192 at DP = 256 (one block of 128
// threads, <= 255 a thread). With ids, 512 B of column ids and the live
// list, 4 B a k tile; instantiated without and with ids (IDS), as the
// forward.
//
// Past D = 256 (bwd_dq_kernel_tc_split): a cluster of n = ceil(D / 256)
// blocks takes each (q tile of 64 rows, head, batch), each on 256 of the
// columns (flash_common.cuh), with the partial S and dP summed across the
// cluster after each step's products; its note below says how.
//
// f32 (bwd_dq_kernel_simt): f32 FMA on tiles staged in shared memory, the
// 64 x 64 SIMT thread map of flash_common.cuh, with the same tile walk, at
// width W = 128 or 256; for the f32 checks. At W = 256, Q, dO, K and V in
// f32 would take 263 KB, so K and V share one buffer: V is staged for
// dP = dO V^T, then K for S = Q K^T and dQ += dS K (each read once, as
// before), 214 KB at D = 256.
// Past 256 it splits the same way at W = 256, the partial dP and then S
// crossing through dS's buffer.
#pragma once

#include "flash_common.cuh"

namespace flash {

// ---------------------------------------------------------------------------
// bf16: the tensor-core body
// ---------------------------------------------------------------------------

template <int DP>
struct DqTc {
  // Two warpgroups of 64 q rows, or one at DP = 256 (shared memory).
  static constexpr int BQ = DP <= 128 ? 128 : 64;
  static constexpr int BK = 64;        // k / v rows per ring stage
  static constexpr int THREADS = 2 * BQ;
  static constexpr int MIN_BLOCKS = DP <= 64 ? 2 : 1;  // blocks an SM
  static constexpr int NB = DP / 64;   // 64-column blocks of the head dim
  static constexpr int Q_BYTES = BQ * DP * 2;   // Q or dO
  static constexpr int KV_BYTES = BK * DP * 2;  // one K or V tile
  // Q, dO, then per stage K and V.
  static constexpr int SMEM = 2 * Q_BYTES + 4 * KV_BYTES + 1024;
  static constexpr int IDS_BYTES = 2 * BK * 4;  // with ids: column ids
};

// dS of one k tile, in place of the dP accumulator (s is spent). lse2 is
// lse * log2 e and delta the row's delta, for accumulator rows row0 and
// row0 + 8. When MASK, a pair whose bit of vis is clear gets p = 0
// exactly, so a row that sees nothing (lse = NEG_INF) gets dS = 0 and
// dq = 0.
template <bool MASK>
__device__ __forceinline__ void dq_grads(const float (&s)[32],
                                         float (&dp)[32],
                                         const float (&lse2)[2],
                                         const float (&delta)[2],
                                         uint32_t vis, float scale_log2) {
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int hh = (i >> 1) & 1;
    const bool seen = !MASK || ((vis >> i) & 1u);
    const float p = seen ? exp2f(s[i] * scale_log2 - lse2[hh]) : 0.f;
    dp[i] = p * (dp[i] - delta[hh]);
  }
}

// IDS: the instantiation for launches with row/col ids.
template <int DP, bool IDS>
__global__ void __launch_bounds__(DqTc<DP>::THREADS, DqTc<DP>::MIN_BLOCKS)
    bwd_dq_kernel_tc(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     const __nv_bfloat16* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta,
                     __nv_bfloat16* __restrict__ dq, const Geom g) {
  using T = DqTc<DP>;
  constexpr int BQ = T::BQ, BK = T::BK, NT = T::THREADS, NB = T::NB;
  extern __shared__ __align__(1024) unsigned char smem[];
  const uint32_t raw = hopper::smem_addr(smem);
  const uint32_t sQ = (raw + 1023u) & ~1023u;
  const uint32_t sdO = sQ + T::Q_BYTES;
  const uint32_t sKV = sdO + T::Q_BYTES;  // stage st: K, then V
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
  constexpr bool ids = IDS;

  // Step j walks every k tile up to the causal bound, or with ids the
  // live list's j-th.
  const int n_kt =
      ids ? live_tiles<BQ, BK, true>(list, g, q0) : live_k_tiles<BQ, BK>(g, q0);
  auto load_kv = [&](int j) {  // into stage j % 2
    const uint32_t st = sKV + (j & 1) * 2 * KVB;
    const int k1 = (ids ? list[j] >> 1 : j) * BK;
    load_tile_async<BK, DP, NT>(st, k, g.kvs, b, hk, k1, g.kv_len, g.D);
    load_tile_async<BK, DP, NT>(st + KVB, v, g.kvs, b, hk, k1, g.kv_len,
                                g.D);
    if (ids) load_ids_async(sCid + (j & 1) * BK * 4, g.col_ids, k1, g.kv_len);
  };
  if (ids && n_kt == 0) {  // no row sees any column: dq 0
    write_dead_rows<BQ>(dq, g.qs, b, h, q0, g.q_len, g.D);
    return;
  }
  if (n_kt > 0) {
    load_tile_async<BQ, DP, NT>(sQ, q, g.qs, b, h, q0, g.q_len, g.D);
    load_tile_async<BQ, DP, NT>(sdO, dout, g.qs, b, h, q0, g.q_len, g.D);
    load_kv(0);
    hopper::cp_async_commit();
  }

  const int row0 = q0 + wg * 64 + warp * 16 + lane / 4;
  float lse2[2], dlt[2];
  int rid[2];  // with ids, the ids of the thread's two rows
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = row0 + 8 * hh;
    const bool ok = row < g.q_len;
    const size_t o = g.stats.at(b, h, ok ? row : 0);
    lse2[hh] = ok ? lse[o] * LOG2E : 0.f;
    dlt[hh] = ok ? delta[o] : 0.f;
    rid[hh] = ids && ok ? g.row_ids[row] : 0;
  }
  float acc[NB][32];
#pragma unroll
  for (int cb = 0; cb < NB; ++cb)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[cb][i] = 0.f;
  const uint32_t wrows = wg * 64 * 128;  // this warpgroup's 64 q rows

  for (int j = 0; j < n_kt; ++j) {
    const uint32_t sK = sKV + (j & 1) * 2 * KVB;
    const uint32_t sV = sK + KVB;
    const int e = ids ? list[j] : 0;
    if (j + 1 < n_kt) {
      load_kv(j + 1);
      hopper::cp_async_commit();
      hopper::cp_async_wait<1>();
    } else {
      hopper::cp_async_wait<0>();
    }
    hopper::fence_proxy_async();
    __syncthreads();

    // S = Q K^T and dP = dO V^T over the head dim, 16 at a time.
    float s[32], dp[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      const uint32_t a = (kk / 4) * BQ * 128 + wrows + (kk % 4) * 32;
      const uint32_t bo = (kk / 4) * BK * 128 + (kk % 4) * 32;
      hopper::mma_ss(s, hopper::k_major(sQ + a), hopper::k_major(sK + bo),
                     kk > 0);
      hopper::mma_ss(dp, hopper::k_major(sdO + a), hopper::k_major(sV + bo),
                     kk > 0);
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(s);
    hopper::fence_regs(dp);

    const int k0 = (ids ? e >> 1 : j) * BK;
    if (ids ? (e & TILE_FULL) != 0 : fully_visible<BQ, BK>(g, q0, k0))
      dq_grads<false>(s, dp, lse2, dlt, 0u, scale_log2);
    else
      dq_grads<true>(
          s, dp, lse2, dlt,
          ids ? acc_visible_ids(rid, cids + (j & 1) * BK, 2 * (lane % 4),
                                g.kv_len - k0)
              : acc_visible(g, row0, k0 + 2 * (lane % 4)),
          scale_log2);

    // dQ += dS K, dS from registers, K read MN-major.
    uint32_t da[4][4];
    hopper::a_fragments(dp, da);
#pragma unroll
    for (int cb = 0; cb < NB; ++cb) hopper::fence_regs(acc[cb]);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
      for (int cb = 0; cb < NB; ++cb)
        hopper::mma_rs(acc[cb], da[kk],
                       hopper::mn_major(sK + cb * BK * 128 + kk * 16 * 128));
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
#pragma unroll
    for (int cb = 0; cb < NB; ++cb) hopper::fence_regs(acc[cb]);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) hopper::fence_regs(da[kk]);
    __syncthreads();  // both warpgroups are done with the stage
  }

  // Every row of the tile is written, also when no k tile was live.
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = row0 + 8 * hh;
    if (row >= g.q_len) continue;
    __nv_bfloat16* drow = dq + g.qs.at(b, h, row);
#pragma unroll
    for (int cb = 0; cb < NB; ++cb)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = cb * 64 + 8 * j + 2 * (lane % 4);
        if (col < g.D)
          *reinterpret_cast<uint32_t*>(drow + col) =
              hopper::pack_bf16(g.scale * acc[cb][4 * j + 2 * hh],
                                g.scale * acc[cb][4 * j + 2 * hh + 1]);
      }
  }
}

template <int DP>
cudaError_t launch_dq_tc(const void* q, const void* k, const void* v,
                         const void* dout, const void* lse, const void* delta,
                         void* dq, const Geom& g, cudaStream_t stream) {
  using T = DqTc<DP>;
  const int n_qt = (g.q_len + T::BQ - 1) / T::BQ;
  if (n_qt > MAX_GRID_YZ || (long long)g.B * g.H > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  const bool ids = g.row_ids != nullptr;
  const auto kernel =
      ids ? bwd_dq_kernel_tc<DP, true> : bwd_dq_kernel_tc<DP, false>;
  const int smem =
      T::SMEM + (ids ? T::IDS_BYTES + id_list_bytes(g.kv_len, T::BK) : 0);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)(g.B * g.H), n_qt);
  kernel<<<grid, T::THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v),
      static_cast<const __nv_bfloat16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<__nv_bfloat16*>(dq), g);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16 past DP = 256: the column split
// ---------------------------------------------------------------------------
//
// A cluster of n = split_blocks(D) blocks takes each (q tile of 64 rows,
// head, batch), block r holding columns [256 r, 256 r + 256) of Q, dO, K
// and V. The one-warpgroup body above sits at 255 registers (dQ 128, S and
// dP 32 each), and the partial sums' reads would spill it, so a split
// block has two warpgroups over the same 64 q rows: warpgroup 0 computes
// the partial S = Q K^T, warpgroup 1 the partial dP = dO V^T, each stashes
// it into the step's V slot (spent once both products are done: S in its
// first 16 KB, dP in its second), a cluster barrier, and both warpgroups
// add the n partials of each in rank order (the same bits in every block
// and warpgroup), form P and dS, and accumulate dQ += dS K over their own
// 128 of the block's columns (dQ 64 registers). The next load into that
// stage waits for every block's reads (the barrier's second half). Shared
// memory is the body's above: 193 KB.

template <bool IDS>
__global__ void __launch_bounds__(256, 1)
    bwd_dq_kernel_tc_split(const __nv_bfloat16* __restrict__ q,
                           const __nv_bfloat16* __restrict__ k,
                           const __nv_bfloat16* __restrict__ v,
                           const __nv_bfloat16* __restrict__ dout,
                           const float* __restrict__ lse,
                           const float* __restrict__ delta,
                           __nv_bfloat16* __restrict__ dq, const Geom g) {
  using T = DqTc<SPLIT_W>;
  constexpr int DP = SPLIT_W, BQ = T::BQ, BK = T::BK, NT = 256;
  constexpr int NBW = T::NB / 2;  // 64-column blocks of a warpgroup's dQ
  static_assert(BQ == 64 && T::KV_BYTES == 2 * 32 * 128 * 4,
                "64 q rows; the partial S and dP fill the V slot");
  extern __shared__ __align__(1024) unsigned char smem[];
  const uint32_t raw = hopper::smem_addr(smem);
  const uint32_t sQ = (raw + 1023u) & ~1023u;
  const uint32_t sdO = sQ + T::Q_BYTES;
  const uint32_t sKV = sdO + T::Q_BYTES;  // stage st: K, then V
  constexpr uint32_t KVB = T::KV_BYTES;
  // With ids: stage st's column ids, then the live k tiles.
  const uint32_t sCid = sKV + 4 * KVB;
  const int* cids = reinterpret_cast<const int*>(smem + (sCid - raw));
  int* list = reinterpret_cast<int*>(smem + (sCid + T::IDS_BYTES - raw));

  const int wg = threadIdx.x / 128;  // 0: S; 1: dP
  const int t = threadIdx.x % 128;
  const int warp = t / 32;
  const int lane = threadIdx.x % 32;
  // The cluster's blocks side by side on the grid's x, then heads and
  // batches; the last q tiles, the heaviest under causal masking, first.
  const int ncol = (int)hopper::cluster_size();
  const int crank = (int)hopper::cluster_rank();
  const int c0 = crank * DP;  // this block's first column
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const int h = blockIdx.x / ncol % g.H;
  const int b = blockIdx.x / ncol / g.H;
  const int hk = h / (g.H / g.Hkv);
  const float scale_log2 = g.scale * LOG2E;
  constexpr bool ids = IDS;

  const int n_kt =
      ids ? live_tiles<BQ, BK, true>(list, g, q0) : live_k_tiles<BQ, BK>(g, q0);
  auto load_kv = [&](int j) {  // into stage j % 2
    const uint32_t st = sKV + (j & 1) * 2 * KVB;
    const int k1 = (ids ? list[j] >> 1 : j) * BK;
    load_tile_async<BK, DP, NT>(st, k, g.kvs, b, hk, k1, g.kv_len, g.D, c0);
    load_tile_async<BK, DP, NT>(st + KVB, v, g.kvs, b, hk, k1, g.kv_len, g.D,
                                c0);
    if (ids) load_ids_async(sCid + (j & 1) * BK * 4, g.col_ids, k1, g.kv_len);
  };
  if (ids && n_kt == 0) {  // no row sees any column: dq 0
    if (crank == 0)  // every column, for the whole cluster
      write_dead_rows<BQ>(dq, g.qs, b, h, q0, g.q_len, g.D);
    return;
  }
  if (n_kt > 0) {
    load_tile_async<BQ, DP, NT>(sQ, q, g.qs, b, h, q0, g.q_len, g.D, c0);
    load_tile_async<BQ, DP, NT>(sdO, dout, g.qs, b, h, q0, g.q_len, g.D, c0);
    load_kv(0);
    hopper::cp_async_commit();
  }

  const int row0 = q0 + warp * 16 + lane / 4;
  float lse2[2], dlt[2];
  int rid[2];  // with ids, the ids of the thread's two rows
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = row0 + 8 * hh;
    const bool ok = row < g.q_len;
    const size_t o = g.stats.at(b, h, ok ? row : 0);
    lse2[hh] = ok ? lse[o] * LOG2E : 0.f;
    dlt[hh] = ok ? delta[o] : 0.f;
    rid[hh] = ids && ok ? g.row_ids[row] : 0;
  }
  float acc[NBW][32];  // dQ over this warpgroup's 128 columns
#pragma unroll
  for (int cb = 0; cb < NBW; ++cb)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[cb][i] = 0.f;
  const uint32_t sA = wg == 0 ? sQ : sdO;  // A of S or dP

  for (int j = 0; j < n_kt; ++j) {
    const uint32_t sK = sKV + (j & 1) * 2 * KVB;
    const uint32_t sV = sK + KVB;
    const int e = ids ? list[j] : 0;
    // Every block has read step j - 1's partials from the V slot the next
    // load takes.
    if (j > 0) hopper::cluster_wait();
    if (j + 1 < n_kt) {
      load_kv(j + 1);
      hopper::cp_async_commit();
      hopper::cp_async_wait<1>();
    } else {
      hopper::cp_async_wait<0>();
    }
    hopper::fence_proxy_async();
    __syncthreads();

    // S = Q K^T (warpgroup 0) or dP = dO V^T (warpgroup 1) over the
    // block's columns, 16 at a time.
    const uint32_t sB = wg == 0 ? sK : sV;
    float s[32], dp[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk)
      hopper::mma_ss(s,
                     hopper::k_major(sA + (kk / 4) * BQ * 128 + (kk % 4) * 32),
                     hopper::k_major(sB + (kk / 4) * BK * 128 + (kk % 4) * 32),
                     kk > 0);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(s);
    __syncthreads();  // both products have read V: it takes the partials
    stash_partial(sV + wg * (KVB / 2), s, t, 128);
    hopper::cluster_sync();  // every block's partials have landed
    sum_partials<4>(s, sV, t, 128, 0, ncol, crank);
    sum_partials<4>(dp, sV + KVB / 2, t, 128, 0, ncol, crank);
    hopper::cluster_arrive();  // read; the wait is the next step's

    const int k0 = (ids ? e >> 1 : j) * BK;
    if (ids ? (e & TILE_FULL) != 0 : fully_visible<BQ, BK>(g, q0, k0))
      dq_grads<false>(s, dp, lse2, dlt, 0u, scale_log2);
    else
      dq_grads<true>(
          s, dp, lse2, dlt,
          ids ? acc_visible_ids(rid, cids + (j & 1) * BK, 2 * (lane % 4),
                                g.kv_len - k0)
              : acc_visible(g, row0, k0 + 2 * (lane % 4)),
          scale_log2);

    // dQ += dS K over this warpgroup's columns, dS from registers, K read
    // MN-major.
    uint32_t da[4][4];
    hopper::a_fragments(dp, da);
#pragma unroll
    for (int cb = 0; cb < NBW; ++cb) hopper::fence_regs(acc[cb]);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
      for (int cb = 0; cb < NBW; ++cb)
        hopper::mma_rs(acc[cb], da[kk],
                       hopper::mn_major(sK + (wg * NBW + cb) * BK * 128 +
                                        kk * 16 * 128));
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
#pragma unroll
    for (int cb = 0; cb < NBW; ++cb) hopper::fence_regs(acc[cb]);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) hopper::fence_regs(da[kk]);
    __syncthreads();  // both warpgroups are done with the stage
  }
  // No block leaves while another may still read its shared memory.
  if (n_kt > 0) hopper::cluster_wait();

  // Every row of the tile is written, also when no k tile was live.
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = row0 + 8 * hh;
    if (row >= g.q_len) continue;
    __nv_bfloat16* drow = dq + g.qs.at(b, h, row) + c0 + wg * NBW * 64;
#pragma unroll
    for (int cb = 0; cb < NBW; ++cb)
#pragma unroll
      for (int jc = 0; jc < 8; ++jc) {
        const int col = cb * 64 + 8 * jc + 2 * (lane % 4);
        if (c0 + wg * NBW * 64 + col < g.D)
          *reinterpret_cast<uint32_t*>(drow + col) =
              hopper::pack_bf16(g.scale * acc[cb][4 * jc + 2 * hh],
                                g.scale * acc[cb][4 * jc + 2 * hh + 1]);
      }
  }
}

// D past SPLIT_W: clusters of split_blocks(D) blocks, side by side on the
// grid's x.
inline cudaError_t launch_dq_tc_split(const void* q, const void* k,
                                      const void* v, const void* dout,
                                      const void* lse, const void* delta,
                                      void* dq, const Geom& g,
                                      cudaStream_t stream) {
  using T = DqTc<SPLIT_W>;
  const int n = split_blocks(g.D);
  const int n_qt = (g.q_len + T::BQ - 1) / T::BQ;
  if (n_qt > MAX_GRID_YZ || (long long)n * g.B * g.H > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  const bool ids = g.row_ids != nullptr;
  const int smem =
      T::SMEM + (ids ? T::IDS_BYTES + id_list_bytes(g.kv_len, T::BK) : 0);
  return launch_cluster(
      ids ? bwd_dq_kernel_tc_split<true> : bwd_dq_kernel_tc_split<false>,
      dim3((unsigned)(n * g.B * g.H), n_qt), 256, smem, n, stream,
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v),
      static_cast<const __nv_bfloat16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<__nv_bfloat16*>(dq), g);
}

// ---------------------------------------------------------------------------
// f32: the SIMT body
// ---------------------------------------------------------------------------

// W: the body's width (D <= W; at 256 K and V share one buffer); IDS:
// the instantiation for launches with row/col ids; SPLIT: for head dims
// past W = SPLIT_W, on clusters whose blocks split the columns
// (flash_common.cuh), the partial dP and then S exchanged through DSs
// before dS takes it.
template <typename T, int W, bool IDS, bool SPLIT>
__global__ void __launch_bounds__(THREADS)
    bwd_dq_kernel_simt(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, const T* __restrict__ dout,
                       const float* __restrict__ lse,
                       const float* __restrict__ delta, T* __restrict__ dq,
                       const Geom g) {
  extern __shared__ float smem_f[];
  constexpr bool ONE_KV = W > SIMT_NARROW;  // K and V share one buffer
  constexpr int DPT = W / 16;  // head-dim columns per thread
  const int ncol = SPLIT ? (int)hopper::cluster_size() : 1;
  const int crank = SPLIT ? (int)hopper::cluster_rank() : 0;
  const int c0 = crank * W;  // this block's first column
  // The block's columns, and a row stride the same in every block.
  const int D = SPLIT ? min(W, g.D - c0) : g.D;
  const int ld = SPLIT ? W + 1 : D + 1;
  float* Qs = smem_f;          // [BQ][ld]
  float* dOs = Qs + BQ * ld;   // [BQ][ld]
  float* Ks = dOs + BQ * ld;   // [BK][ld]
  float* Vs = ONE_KV ? Ks : Ks + BK * ld;  // [BK][ld]
  float* DSs = Vs + BK * ld;   // [BQ][BK + 1]
  // With ids: the k tile's column ids, then the live k tiles.
  int* Cid = reinterpret_cast<int*>(DSs + BQ * (BK + 1));  // [BK]
  int* list = Cid + BK;
  const uint32_t xbuf = (uint32_t)__cvta_generic_to_shared(DSs);

  const int q0 = blockIdx.x / ncol * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (g.H / g.Hkv);
  const int tr = threadIdx.x / 16;
  const int tc = threadIdx.x % 16;
  constexpr bool ids = IDS;

  load_tile(Qs, q, g.qs, b, h, q0, g.q_len, D, ld, c0);
  load_tile(dOs, dout, g.qs, b, h, q0, g.q_len, D, ld, c0);

  float lse_r[RPT], delta_r[RPT], acc[RPT][DPT];
  int rid[RPT];  // with ids, the ids of the thread's rows
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int row = q0 + tr * RPT + i;
    const size_t o = g.stats.at(b, h, row);
    lse_r[i] = row < g.q_len ? lse[o] : 0.f;
    delta_r[i] = row < g.q_len ? delta[o] : 0.f;
#pragma unroll
    for (int jd = 0; jd < DPT; ++jd) acc[i][jd] = 0.f;
    rid[i] = ids && row < g.q_len ? g.row_ids[row] : 0;
  }

  // Step it walks every k tile up to the causal bound, or with ids the
  // live list's it-th (e: the entry, with its TILE_FULL bit).
  const int n_kt = ids ? live_tiles<BQ, BK, true>(list, g, q0)
                       : live_k_tiles(g, q0);
  for (int it = 0; it < n_kt; ++it) {
    const int e = ids ? list[it] : 0;
    const int k0 = (ids ? e >> 1 : it) * BK;
    float s[RPT][CPT], dp[RPT][CPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j) s[i][j] = dp[i][j] = 0.f;
    __syncthreads();
    if constexpr (ONE_KV) {
      // dP = dO V^T with V in the shared buffer, then K takes its place.
      load_tile(Vs, v, g.kvs, b, hk, k0, g.kv_len, D, ld, c0);
      if (ids) load_ids(Cid, g.col_ids, k0, g.kv_len);
      __syncthreads();
      for (int d = 0; d < D; ++d) {
        float dov[RPT], vv[CPT];
#pragma unroll
        for (int i = 0; i < RPT; ++i) dov[i] = dOs[(tr * RPT + i) * ld + d];
#pragma unroll
        for (int j = 0; j < CPT; ++j) vv[j] = Vs[(tc + 16 * j) * ld + d];
#pragma unroll
        for (int i = 0; i < RPT; ++i)
#pragma unroll
          for (int j = 0; j < CPT; ++j) dp[i][j] = fmaf(dov[i], vv[j], dp[i][j]);
      }
      __syncthreads();
      load_tile(Ks, k, g.kvs, b, hk, k0, g.kv_len, D, ld, c0);
      __syncthreads();
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
    } else {
      load_tile(Ks, k, g.kvs, b, hk, k0, g.kv_len, D, ld, c0);
      load_tile(Vs, v, g.kvs, b, hk, k0, g.kv_len, D, ld, c0);
      if (ids) load_ids(Cid, g.col_ids, k0, g.kv_len);
      __syncthreads();

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
    }
    // The cluster's dP and S, each summed in rank order, through DSs.
    if constexpr (SPLIT) {
      exchange_partials(dp, xbuf, ncol);
      exchange_partials(s, xbuf, ncol);
    }

#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int r = tr * RPT + i;
      const int row = q0 + r;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int c = tc + 16 * j;
        const bool vis =
            ids ? (e & TILE_FULL) || (c < g.kv_len - k0 && Cid[c] <= rid[i])
                : visible(g, row, k0 + c);
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
    const size_t o = g.qs.at(b, h, row) + c0;
#pragma unroll
    for (int jd = 0; jd < DPT; ++jd) {
      const int c = tc + 16 * jd;
      if (c < D) dq[o + c] = from_f<T>(g.scale * acc[i][jd]);
    }
  }
}

// W: the body's width; past SPLIT_W, clusters of split_blocks(D) blocks
// of width SPLIT_W side by side on the grid's x.
template <typename T, int W>
cudaError_t launch_dq_simt(const void* q, const void* k, const void* v,
                           const void* dout, const void* lse,
                           const void* delta, void* dq, const Geom& g,
                           cudaStream_t stream) {
  const int n = split_blocks(g.D);
  const int kv_tiles = W > SIMT_NARROW ? 1 : 2;  // K and V, or one buffer
  const size_t smem =
      sizeof(float) * ((size_t)(2 * BQ + kv_tiles * BK) * (min(g.D, W) + 1) +
                       BQ * (BK + 1)) +
      (g.row_ids != nullptr ? 4 * BK + id_list_bytes(g.kv_len, BK) : 0);
  const dim3 grid(n * ((g.q_len + BQ - 1) / BQ), g.H, g.B);
  if constexpr (W == SPLIT_W) {
    if (n > 1)
      return launch_cluster(
          g.row_ids != nullptr ? bwd_dq_kernel_simt<T, W, true, true>
                               : bwd_dq_kernel_simt<T, W, false, true>,
          grid, THREADS, (int)smem, n, stream, static_cast<const T*>(q),
          static_cast<const T*>(k), static_cast<const T*>(v),
          static_cast<const T*>(dout), static_cast<const float*>(lse),
          static_cast<const float*>(delta), static_cast<T*>(dq), g);
  }
  const auto kernel = g.row_ids != nullptr
                          ? bwd_dq_kernel_simt<T, W, true, false>
                          : bwd_dq_kernel_simt<T, W, false, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dq), g);
  return cudaGetLastError();
}

// Checks the geometry and launches: bf16 operands (is_bf16) on the
// tensor-core body at the instantiated head dim that covers D, f32 on the
// SIMT body. Returns a cudaError_t (0 = launched).
inline int bwd_dq(const void* q, const void* k, const void* v,
                  const void* dout, const void* lse, const void* delta,
                  void* dq, const Geom& g, int is_bf16, void* stream) {
  if (bad_shape(g)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!is_bf16)
    return (int)(g.D <= SIMT_NARROW
                     ? launch_dq_simt<float, SIMT_NARROW>(q, k, v, dout, lse,
                                                          delta, dq, g, s)
                     : launch_dq_simt<float, SPLIT_W>(q, k, v, dout, lse,
                                                      delta, dq, g, s));
  if (bad_tc_operands(g, {q, k, v, dout, dq})) return (int)cudaErrorInvalidValue;
  return (int)(g.D <= 64
                   ? launch_dq_tc<64>(q, k, v, dout, lse, delta, dq, g, s)
               : g.D <= 128
                   ? launch_dq_tc<128>(q, k, v, dout, lse, delta, dq, g, s)
               : g.D <= SPLIT_W
                   ? launch_dq_tc<256>(q, k, v, dout, lse, delta, dq, g, s)
                   : launch_dq_tc_split(q, k, v, dout, lse, delta, dq, g, s));
}

}  // namespace flash
