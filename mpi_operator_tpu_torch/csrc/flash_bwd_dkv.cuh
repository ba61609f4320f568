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
//   in f32, with the mask (skipped on tiles that need none);
// - dV += P^T dO and dK += dS^T Q: A is the bf16 rounding of the register
//   accumulator, B is dO or Q read MN-major.
// The dK and dV accumulators stay in f32 registers across the whole loop;
// dk is scaled once, at the end. K and V are loaded once; Q, dO, lse and
// delta arrive by cp.async in a 2-stage ring, step j + 1 in flight while
// step j is multiplied. Q tiles that see none of the k tile are skipped:
// causal ones (first_live_q_tile) and, with ids, those the id ranges rule
// out (live_tiles over the q tiles: the block walks its list of live q
// tiles for each q head, each one's row ids arriving in the ring beside
// lse and delta, its own k rows' column ids in registers; a fully visible
// step takes no mask, and a k tile with no live q tile writes dk = dv = 0
// in 16-byte stores and loads nothing); the k tile index runs slowest on
// the grid, from the first tile, so the heaviest tiles (every later q row
// sees the first k columns) are launched first.
//
// Tiles and budget: BK = 128, BQ = 64 at the instantiated head dims 64
// and 128 (another D that is a multiple of 8 runs on the next one, zero-
// filled; above 128 the split body below takes it). Shared memory K + V
// 128 x DP, 2 stages x (Q + dO) 64 x DP in bf16, lse and delta: 66 KB at
// DP = 64, 130 KB at DP = 128. Registers: dK
// and dV DP / 2 each, S^T and dP^T 32 each, so 192 accumulator registers a
// thread at DP = 128: one block of 256 threads an SM (<= 255 a thread).
// With ids, 512 B of q row ids and the live list, 4 B a q tile;
// instantiated without and with ids (IDS), as the forward.
//
// bf16 at DP = 256 (bwd_dkv_kernel_tc_split): dK and dV do not fit one
// thread map, so the two warpgroups split them over 64 k rows, and a
// cluster of two blocks splits each k tile's walk; past 256 each of those
// is a cluster of ceil(D / 256) blocks that split the columns. Its note
// below says how.
//
// f32 (bwd_dkv_kernel_simt): f32 FMA on tiles staged in shared memory, the
// 64 x 64 SIMT thread map of flash_common.cuh, with the same tile walk, at
// width W = 128 or 256 (one buffer for Q and dO, and one for P^T and dS^T,
// at 256: 210 KB at D = 256); for the f32 checks. Past 256 it splits the
// same way at W = 256, the partial S^T crossing through P^T's buffer
// before P^T takes it and the partial dP^T after the dV product.
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
  static constexpr int IDS_BYTES = 2 * BQ * 4;  // with ids: row ids
};

// Without ids, the visible bits of a step's S^T accumulator: rows are k
// rows from krow0, columns q rows q0 + qc0 + acc_col(i).
__device__ __forceinline__ uint32_t acc_visible_t(const Geom& g, int q0,
                                                  int krow0, int qc0) {
  uint32_t vis = 0;
#pragma unroll
  for (int i = 0; i < 32; ++i)
    if (visible(g, q0 + qc0 + hopper::acc_col(i), krow0 + hopper::acc_row(i)))
      vis |= 1u << i;
  return vis;
}

// P^T and dS^T of one step, in place of the S^T and dP^T accumulators.
// lse_s and delta_s hold the step's q rows; lse is in natural units. When
// MASK, a pair whose bit of vis is clear gets p = 0.
template <bool MASK>
__device__ __forceinline__ void dkv_probs(float (&s)[32], float (&dp)[32],
                                          const float* lse_s,
                                          const float* delta_s, uint32_t vis,
                                          int qc0, float scale_log2) {
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int qc = qc0 + hopper::acc_col(i);
    const bool seen = !MASK || ((vis >> i) & 1u);
    const float p =
        seen ? exp2f(s[i] * scale_log2 - lse_s[qc] * LOG2E) : 0.f;
    s[i] = p;
    dp[i] = p * (dp[i] - delta_s[qc]);
  }
}

// IDS: the instantiation for launches with row/col ids.
template <int DP, bool IDS>
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
  // With ids: stage st's q row ids, then the live q tiles.
  const uint32_t sRid = sStats0 + 2 * T::STATS_BYTES;
  const int* rids = reinterpret_cast<const int*>(smem + (sRid - raw));
  int* list = reinterpret_cast<int*>(smem + (sRid + T::IDS_BYTES - raw));

  const int wg = threadIdx.x / 128;
  const int warp = (threadIdx.x / 32) % 4;
  const int lane = threadIdx.x % 32;
  const int k0 = blockIdx.y * BK;
  const int hk = blockIdx.x % g.Hkv;
  const int b = blockIdx.x / g.Hkv;
  const int groups = g.H / g.Hkv;
  const float scale_log2 = g.scale * LOG2E;
  constexpr bool ids = IDS;

  // Each q head walks per_head q tiles: from the causal bound, or with
  // ids the live list.
  const int qt_begin = ids ? 0 : first_live_q_tile<BQ>(g, k0);
  const int per_head = ids ? live_tiles<BK, BQ, false>(list, g, k0)
                           : (g.q_len + BQ - 1) / BQ - qt_begin;
  const int steps = groups * per_head;
  // Step j's list entry (with its TILE_FULL bit) and q tile.
  auto entry = [&](int j) { return ids ? list[j % per_head] : 0; };
  auto q_tile = [&](int j) {
    return ids ? entry(j) >> 1 : qt_begin + j % per_head;
  };

  // Step j: q tile q_tile(j) of q head hk * groups + j / per_head, into
  // stage j % 2.
  auto load_step = [&](int j) {
    const int h = hk * groups + j / per_head;
    const int q0 = q_tile(j) * BQ;
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
    if (ids) load_ids_async(sRid + (j & 1) * BQ * 4, g.row_ids, q0, g.q_len);
    hopper::cp_async_commit();
  };

  if (ids && steps == 0) {  // no row sees any of these columns: dk, dv 0
    write_dead_rows<BK>(dk, g.kvs, b, hk, k0, g.kv_len, g.D);
    write_dead_rows<BK>(dv, g.kvs, b, hk, k0, g.kv_len, g.D);
    return;
  }
  if (steps > 0) {
    load_tile_async<BK, DP, NT>(sK, k, g.kvs, b, hk, k0, g.kv_len, g.D);
    load_tile_async<BK, DP, NT>(sV, v, g.kvs, b, hk, k0, g.kv_len, g.D);
    hopper::cp_async_commit();
    load_step(0);
  }

  float dk_acc[NB][32], dv_acc[NB][32];
#pragma unroll
  for (int cb = 0; cb < NB; ++cb)
#pragma unroll
    for (int i = 0; i < 32; ++i) dk_acc[cb][i] = dv_acc[cb][i] = 0.f;
  const int krow0 = k0 + wg * 64 + warp * 16 + lane / 4;
  const int qc0 = 2 * (lane % 4);
  const uint32_t wrows = wg * 64 * 128;  // this warpgroup's 64 k rows
  int cid[2];  // with ids, the column ids of the thread's two k rows
#pragma unroll
  for (int hh = 0; hh < 2; ++hh)
    cid[hh] = ids && krow0 + 8 * hh < g.kv_len ? g.col_ids[krow0 + 8 * hh]
                                               : 0;

  for (int j = 0; j < steps; ++j) {
    const int q0 = q_tile(j) * BQ;
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

    if (ids ? (entry(j) & TILE_FULL) != 0 : fully_visible<BQ, BK>(g, q0, k0))
      dkv_probs<false>(s, dp, lse_s, delta_s, 0u, qc0, scale_log2);
    else
      dkv_probs<true>(
          s, dp, lse_s, delta_s,
          ids ? acc_visible_ids_t(cid, rids + (j & 1) * BQ, qc0, g.q_len - q0)
              : acc_visible_t(g, q0, krow0, qc0),
          qc0, scale_log2);

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
  const bool ids = g.row_ids != nullptr;
  const auto kernel =
      ids ? bwd_dkv_kernel_tc<DP, true> : bwd_dkv_kernel_tc<DP, false>;
  const int smem =
      T::SMEM + (ids ? T::IDS_BYTES + id_list_bytes(g.q_len, T::BQ) : 0);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)(g.B * g.Hkv), n_kt);
  kernel<<<grid, T::THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v),
      static_cast<const __nv_bfloat16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), g);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16 at DP = 256: the split tensor-core body
// ---------------------------------------------------------------------------
//
// At DP = 256 the body above cannot hold its accumulators: dK and dV take
// DP / 2 = 128 f32 registers a thread each, 256 before S^T and dP^T, over
// the 255 a thread may have; and K + V 128 x 256 with the Q / dO ring
// would take 256 KB of shared memory. So the block owns BK = 64 k rows and
// its two warpgroups split the work by output, each over all 64 rows:
// - warpgroup 0 computes S^T = K Q^T, P^T = exp(scale S^T - lse) (masked),
//   hands P^T (f32) to warpgroup 1 through shared memory, and accumulates
//   dV += P^T dO;
// - warpgroup 1 computes dP^T = V dO^T, takes P^T, forms dS^T = P^T (dP^T
//   - delta) and accumulates dK += dS^T Q.
// The products and the rounding are the body's above (P^T and dS^T rounded
// to bf16 as register A operands; dk scaled once at the end). The hand-over
// is a named barrier that warpgroup 0 arrives at and warpgroup 1 waits on,
// so warpgroup 0's dV product runs while warpgroup 1 forms dS^T. Each
// thread stores its 32 accumulator elements where the thread of the same
// index in the other warpgroup, whose accumulator map is the same, loads
// them: 16-byte stores and loads, no bank conflicts. Registers: one [64,
// DP] accumulator (128), S^T or dP^T (32) and the A fragments (16), under
// the launch bound of one block of 256 threads. Shared memory: K and V
// 64 x DP, the 2-stage Q / dO ring 64 x DP, lse and delta, P^T 16 KB: 210
// KB, one block an SM; with ids the ring's row ids and the live list. The
// walk (q heads of the group, live q tiles, the causal bound, ids by
// live_tiles) is the body's above.
//
// A k tile of 64 rows gives few blocks: B * Hkv * S / 64, 128 at the
// Qwen3-Next shape, under one an SM, and under causal masking the first k
// tile walks every q tile of the group's 8 heads while the last walks one.
// So each k tile is a cluster of two blocks on neighbouring SMs that split
// its walk in halves (every q head and q tile of the group, in order).
// After the walk the second block stores its partial dK or dV into the
// first one's Q / dO ring (free by then: 128 KB, 128 floats a thread) by
// distributed shared memory, and the first adds them to its own and
// writes: the sum over the group stays in the kernel, with no atomics and
// no second pass.
//
// Past DP = 256 (COLS) each of those blocks is itself a column split of
// n = split_blocks(D) blocks (flash_common.cuh), so a k tile is a cluster
// of 2n (at most 8, the portable limit): rank = part * n + col, part the
// walk's half, col the block's 256 columns. Both warpgroups then need the
// whole S^T, and there is no room for a second 16 KB buffer beside the
// P^T one, so the partials cross in two rounds through the P^T buffer:
// warpgroup 0's S^T partials, from which both warpgroups form the same
// P^T (no hand-over), then warpgroup 1's dP^T partials. Every block of the
// cluster walks `half` steps (the second part's last one idle when the
// walk is odd), so all pass the same cluster barriers.

template <int DP>
struct DkvSplit {
  static constexpr int BK = 64;       // k rows, shared by both warpgroups
  static constexpr int BQ = 64;       // q rows per ring stage
  static constexpr int THREADS = 256;
  static constexpr int NB = DP / 64;  // 64-column blocks of the head dim
  static constexpr int KV_BYTES = BK * DP * 2;  // K or V
  static constexpr int Q_BYTES = BQ * DP * 2;   // one Q or dO tile
  static constexpr int STATS_BYTES = 2 * BQ * 4;  // lse, delta of a stage
  static constexpr int P_BYTES = BK * BQ * 4;     // P^T in f32
  // K, V, then per stage Q and dO, then per stage lse and delta, then P^T.
  static constexpr int SMEM =
      2 * KV_BYTES + 4 * Q_BYTES + 2 * STATS_BYTES + P_BYTES + 1024;
  static constexpr int IDS_BYTES = 2 * BQ * 4;  // with ids: row ids
  static constexpr int HANDOVER = 1;  // the named barrier of P^T
  static constexpr int CLUSTER = 2;   // blocks that split a k tile's walk
  // The second block's partial sums, 128 floats a thread, fit the ring.
  static_assert(NB * 32 * THREADS * 4 <= 4 * Q_BYTES, "sums fit the ring");
  // A warpgroup's partial S^T or dP^T, 32 floats a thread, fits P^T's.
  static_assert(32 * 128 * 4 == P_BYTES, "partials fit the P^T buffer");
};

// P^T = exp(scale S^T - lse) of one step in place of the S^T accumulator,
// 0 where bit i of vis is clear.
__device__ __forceinline__ void dkv_p(float (&s)[32], const float* lse_s,
                                      uint32_t vis, int qc0,
                                      float scale_log2) {
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int qc = qc0 + hopper::acc_col(i);
    s[i] = ((vis >> i) & 1u) ? exp2f(s[i] * scale_log2 - lse_s[qc] * LOG2E)
                             : 0.f;
  }
}

// IDS: the instantiation for launches with row/col ids; COLS: for head
// dims past DP = SPLIT_W, the column split above.
template <int DP, bool IDS, bool COLS>
__global__ void __launch_bounds__(DkvSplit<DP>::THREADS, 1)
    bwd_dkv_kernel_tc_split(const __nv_bfloat16* __restrict__ q,
                            const __nv_bfloat16* __restrict__ k,
                            const __nv_bfloat16* __restrict__ v,
                            const __nv_bfloat16* __restrict__ dout,
                            const float* __restrict__ lse,
                            const float* __restrict__ delta,
                            __nv_bfloat16* __restrict__ dk,
                            __nv_bfloat16* __restrict__ dv, const Geom g) {
  using T = DkvSplit<DP>;
  constexpr int BQ = T::BQ, BK = T::BK, NT = T::THREADS, NB = T::NB;
  static_assert(!COLS || DP == SPLIT_W, "a split block holds SPLIT_W columns");
  extern __shared__ __align__(1024) unsigned char smem[];
  const uint32_t raw = hopper::smem_addr(smem);
  const uint32_t sK = (raw + 1023u) & ~1023u;
  const uint32_t sV = sK + T::KV_BYTES;
  const uint32_t sQ0 = sV + T::KV_BYTES;  // stage st: Q, then dO
  const uint32_t sStats0 = sQ0 + 4 * T::Q_BYTES;
  const float* stats0 =
      reinterpret_cast<const float*>(smem + (sStats0 - raw));
  const uint32_t sP = sStats0 + 2 * T::STATS_BYTES;
  float4* pt = reinterpret_cast<float4*>(smem + (sP - raw));
  // With ids: stage st's q row ids, then the live q tiles.
  const uint32_t sRid = sP + T::P_BYTES;
  const int* rids = reinterpret_cast<const int*>(smem + (sRid - raw));
  int* list = reinterpret_cast<int*>(smem + (sRid + T::IDS_BYTES - raw));

  const int wg = threadIdx.x / 128;  // 0: S^T, P^T, dV; 1: dP^T, dS^T, dK
  const int t = threadIdx.x % 128;
  const int warp = t / 32;
  const int lane = threadIdx.x % 32;
  const int k0 = blockIdx.y * BK;
  // The cluster along x: CLUSTER parts of the walk, each (with COLS) ncol
  // blocks of SPLIT_W columns; rank = part * ncol + col.
  const int ncol = COLS ? (int)hopper::cluster_size() / T::CLUSTER : 1;
  const int rank = (int)hopper::cluster_rank();
  const int part = rank / ncol, col = rank % ncol;
  const int c0 = col * DP;  // this block's first column
  const int hk = blockIdx.x / (T::CLUSTER * ncol) % g.Hkv;
  const int b = blockIdx.x / (T::CLUSTER * ncol) / g.Hkv;
  const int groups = g.H / g.Hkv;
  const float scale_log2 = g.scale * LOG2E;
  constexpr bool ids = IDS;

  // The walk of the body above: per_head q tiles for each q head; this
  // block takes steps [j0, j1) of it, the other part the rest.
  const int qt_begin = ids ? 0 : first_live_q_tile<BQ>(g, k0);
  const int per_head = ids ? live_tiles<BK, BQ, false>(list, g, k0)
                           : (g.q_len + BQ - 1) / BQ - qt_begin;
  const int steps = groups * per_head;
  const int half = (steps + 1) / 2;
  const int j0 = part == 0 ? 0 : half, j1 = part == 0 ? half : steps;
  auto entry = [&](int j) { return ids ? list[j % per_head] : 0; };
  auto q_tile = [&](int j) {
    return ids ? entry(j) >> 1 : qt_begin + j % per_head;
  };
  auto load_step = [&](int j) {
    const int h = hk * groups + j / per_head;
    const int q0 = q_tile(j) * BQ;
    const uint32_t sQ = sQ0 + (j & 1) * 2 * T::Q_BYTES;
    load_tile_async<BQ, DP, NT>(sQ, q, g.qs, b, h, q0, g.q_len, g.D, c0);
    load_tile_async<BQ, DP, NT>(sQ + T::Q_BYTES, dout, g.qs, b, h, q0,
                                g.q_len, g.D, c0);
    if (threadIdx.x < 2 * BQ) {  // lse by the first BQ threads, delta next
      const int r = threadIdx.x % BQ;
      const float* src = threadIdx.x < BQ ? lse : delta;
      const bool ok = q0 + r < g.q_len;
      hopper::cp_async4(sStats0 + (j & 1) * T::STATS_BYTES + threadIdx.x * 4,
                        ok ? src + g.stats.at(b, h, q0 + r) : src, ok);
    }
    if (ids) load_ids_async(sRid + (j & 1) * BQ * 4, g.row_ids, q0, g.q_len);
    hopper::cp_async_commit();
  };

  if (ids && steps == 0) {  // no row sees any of these columns: dk, dv 0
    if (rank == 0) {  // every block of the cluster returns here
      write_dead_rows<BK>(dk, g.kvs, b, hk, k0, g.kv_len, g.D);
      write_dead_rows<BK>(dv, g.kvs, b, hk, k0, g.kv_len, g.D);
    }
    return;
  }
  if (j0 < j1) {
    load_tile_async<BK, DP, NT>(sK, k, g.kvs, b, hk, k0, g.kv_len, g.D, c0);
    load_tile_async<BK, DP, NT>(sV, v, g.kvs, b, hk, k0, g.kv_len, g.D, c0);
    hopper::cp_async_commit();
    load_step(j0);
  }

  float acc[NB][32];  // dV in warpgroup 0, dK in warpgroup 1
#pragma unroll
  for (int cb = 0; cb < NB; ++cb)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[cb][i] = 0.f;
  const int krow0 = k0 + warp * 16 + lane / 4;
  const int qc0 = 2 * (lane % 4);
  int cid[2];  // with ids, the column ids of the thread's two k rows
#pragma unroll
  for (int hh = 0; hh < 2; ++hh)
    cid[hh] = ids && krow0 + 8 * hh < g.kv_len ? g.col_ids[krow0 + 8 * hh]
                                               : 0;
  const uint32_t sA = wg == 0 ? sK : sV;  // A of S^T or dP^T

  const int n_iter = COLS ? half : j1 - j0;
  for (int it = 0; it < n_iter; ++it) {
    const int j = j0 + it;
    const bool live = !COLS || j < j1;  // else only the cluster barriers
    const int q0 = live ? q_tile(j) * BQ : 0;
    const uint32_t sQ = sQ0 + (j & 1) * 2 * T::Q_BYTES;
    const uint32_t sdO = sQ + T::Q_BYTES;
    const float* lse_s = stats0 + (j & 1) * 2 * BQ;
    const float* delta_s = lse_s + BQ;
    // Every block has read the previous step's dP^T partials.
    if (COLS && it > 0) hopper::cluster_wait();
    float s[32];
    if (live) {
      if (j + 1 < j1) {
        load_step(j + 1);
        hopper::cp_async_wait<1>();
      } else {
        hopper::cp_async_wait<0>();
      }
      hopper::fence_proxy_async();
      __syncthreads();

      // S^T = K Q^T (warpgroup 0) or dP^T = V dO^T (warpgroup 1) over the
      // head dim.
      const uint32_t sB = wg == 0 ? sQ : sdO;
#pragma unroll
      for (int i = 0; i < 32; ++i) s[i] = 0.f;
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk)
        hopper::mma_ss(
            s, hopper::k_major(sA + (kk / 4) * BK * 128 + (kk % 4) * 32),
            hopper::k_major(sB + (kk / 4) * BQ * 128 + (kk % 4) * 32),
            kk > 0);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(s);
    }

    const bool full = ids ? (entry(j) & TILE_FULL) != 0
                          : fully_visible<BQ, BK>(g, q0, k0);
    auto vis = [&]() {
      return full ? 0xffffffffu
             : ids ? acc_visible_ids_t(cid, rids + (j & 1) * BQ, qc0,
                                       g.q_len - q0)
                   : acc_visible_t(g, q0, krow0, qc0);
    };
    if constexpr (COLS) {
      // Round 1: warpgroup 0's partial S^T, summed by both warpgroups of
      // every block of this part; both form P^T from it.
      if (live && wg == 0) stash_partial(sP, s, t, 128);
      hopper::cluster_sync();
      float p[32];
      if (live) sum_partials<2>(p, sP, t, 128, part * ncol, ncol, rank);
      hopper::cluster_arrive();
      if (live) dkv_p(p, lse_s, vis(), qc0, scale_log2);
      hopper::cluster_wait();
      // Round 2: warpgroup 1's partial dP^T, and dS^T = P^T (dP^T - delta).
      if (live && wg == 1) stash_partial(sP, s, t, 128);
      hopper::cluster_sync();
      if (live && wg == 1)
        sum_partials<2>(s, sP, t, 128, part * ncol, ncol, rank);
      hopper::cluster_arrive();  // read; the wait is the next step's
      if (live) {
#pragma unroll
        for (int n = 0; n < 32; ++n)
          s[n] = wg == 0 ? p[n]
                         : p[n] * (s[n] - delta_s[qc0 + hopper::acc_col(n)]);
      }
    } else if (wg == 0) {
      // P^T in place of S^T (p = 0 where masked), handed to warpgroup 1.
      dkv_p(s, lse_s, vis(), qc0, scale_log2);
#pragma unroll
      for (int i = 0; i < 8; ++i)
        pt[i * 128 + t] =
            make_float4(s[4 * i], s[4 * i + 1], s[4 * i + 2], s[4 * i + 3]);
      hopper::bar_arrive(T::HANDOVER, NT);
    } else {
      // dS^T = P^T (dP^T - delta) in place of dP^T.
      hopper::bar_sync(T::HANDOVER, NT);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float4 p = pt[i * 128 + t];
        const float pv[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int n = 4 * i + e;
          s[n] = pv[e] * (s[n] - delta_s[qc0 + hopper::acc_col(n)]);
        }
      }
    }
    if (!live) continue;

    // dV += P^T dO (warpgroup 0) or dK += dS^T Q (warpgroup 1), A from
    // registers, B read MN-major.
    uint32_t fa[4][4];
    hopper::a_fragments(s, fa);
    const uint32_t sM = wg == 0 ? sdO : sQ;
#pragma unroll
    for (int cb = 0; cb < NB; ++cb) hopper::fence_regs(acc[cb]);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk)
#pragma unroll
      for (int cb = 0; cb < NB; ++cb)
        hopper::mma_rs(acc[cb], fa[kk],
                       hopper::mn_major(sM + cb * BQ * 128 + kk * 16 * 128));
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
#pragma unroll
    for (int cb = 0; cb < NB; ++cb) hopper::fence_regs(acc[cb]);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) hopper::fence_regs(fa[kk]);
    __syncthreads();  // the stage and P^T are free
  }
  if (COLS && n_iter > 0) hopper::cluster_wait();

  // The second part hands its partial sums to the first (the block of the
  // same columns) through that block's ring; the first adds them to its
  // own.
  const float4* sums = reinterpret_cast<const float4*>(smem + (sQ0 - raw));
  hopper::cluster_sync();  // every block is done with its ring
  if (part != 0) {
    const uint32_t peer = hopper::map_to_rank(sQ0, (uint32_t)col);
#pragma unroll
    for (int cb = 0; cb < NB; ++cb)
#pragma unroll
      for (int i = 0; i < 8; ++i)
        hopper::st_cluster(
            peer + ((cb * 8 + i) * NT + threadIdx.x) * 16,
            make_float4(acc[cb][4 * i], acc[cb][4 * i + 1],
                        acc[cb][4 * i + 2], acc[cb][4 * i + 3]));
  }
  hopper::cluster_sync();  // the second part's sums have landed
  if (part != 0) return;
#pragma unroll
  for (int cb = 0; cb < NB; ++cb)
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float4 p = sums[(cb * 8 + i) * NT + threadIdx.x];
      acc[cb][4 * i] += p.x;
      acc[cb][4 * i + 1] += p.y;
      acc[cb][4 * i + 2] += p.z;
      acc[cb][4 * i + 3] += p.w;
    }

  __nv_bfloat16* out = wg == 0 ? dv : dk;
  const float mul = wg == 0 ? 1.f : g.scale;  // dk is scaled once, here
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = krow0 + 8 * hh;
    if (row >= g.kv_len) continue;
    const size_t o = g.kvs.at(b, hk, row) + c0;
#pragma unroll
    for (int cb = 0; cb < NB; ++cb)
#pragma unroll
      for (int jc = 0; jc < 8; ++jc) {
        const int cl = cb * 64 + 8 * jc + qc0;
        if (c0 + cl >= g.D) continue;
        const int i = 4 * jc + 2 * hh;
        *reinterpret_cast<uint32_t*>(out + o + cl) =
            hopper::pack_bf16(mul * acc[cb][i], mul * acc[cb][i + 1]);
      }
  }
}

// Clusters of CLUSTER blocks (each, past SPLIT_W, of split_blocks(D)
// blocks of SPLIT_W columns) along x: (b, kv head) = x / the cluster.
inline cudaError_t launch_dkv_tc_split(const void* q, const void* k,
                                       const void* v, const void* dout,
                                       const void* lse, const void* delta,
                                       void* dk, void* dv, const Geom& g,
                                       cudaStream_t stream) {
  using T = DkvSplit<SPLIT_W>;
  const int cluster = T::CLUSTER * split_blocks(g.D);
  const int n_kt = (g.kv_len + T::BK - 1) / T::BK;
  if (n_kt > MAX_GRID_YZ || (long long)cluster * g.B * g.Hkv > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  const bool ids = g.row_ids != nullptr, cols = g.D > SPLIT_W;
  const auto kernel =
      cols ? (ids ? bwd_dkv_kernel_tc_split<SPLIT_W, true, true>
                  : bwd_dkv_kernel_tc_split<SPLIT_W, false, true>)
           : (ids ? bwd_dkv_kernel_tc_split<SPLIT_W, true, false>
                  : bwd_dkv_kernel_tc_split<SPLIT_W, false, false>);
  const int smem =
      T::SMEM + (ids ? T::IDS_BYTES + id_list_bytes(g.q_len, T::BQ) : 0);
  return launch_cluster(
      kernel, dim3((unsigned)(cluster * g.B * g.Hkv), n_kt), T::THREADS, smem,
      cluster, stream, static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v),
      static_cast<const __nv_bfloat16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), g);
}

// ---------------------------------------------------------------------------
// f32: the SIMT body
// ---------------------------------------------------------------------------

// W: the body's width (D <= W; at 256 Q and dO share one buffer, as do
// P^T and dS^T); IDS: the instantiation for launches with row/col ids;
// SPLIT: for head dims past W = SPLIT_W, on clusters whose blocks split
// the columns (flash_common.cuh), the partial S^T exchanged through PTs
// before P^T takes it, and the partial dP^T after the dV product.
template <typename T, int W, bool IDS, bool SPLIT>
__global__ void __launch_bounds__(THREADS)
    bwd_dkv_kernel_simt(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta, T* __restrict__ dk,
                        T* __restrict__ dv, const Geom g) {
  extern __shared__ float smem_f[];
  // At W = 256 one buffer holds Q, then dO, then Q again, and P^T becomes
  // dS^T in place: K, V, Q, dO, P^T and dS^T in f32 would take 296 KB.
  constexpr bool ONE_Q = W > SIMT_NARROW;
  constexpr int DPT = W / 16;  // head-dim columns per thread
  const int ncol = SPLIT ? (int)hopper::cluster_size() : 1;
  const int crank = SPLIT ? (int)hopper::cluster_rank() : 0;
  const int c0 = crank * W;  // this block's first column
  // The block's columns, and a row stride the same in every block.
  const int D = SPLIT ? min(W, g.D - c0) : g.D;
  const int ld = SPLIT ? W + 1 : D + 1;
  float* Ks = smem_f;            // [BK][ld]
  float* Vs = Ks + BK * ld;      // [BK][ld]
  float* Qs = Vs + BK * ld;      // [BQ][ld]
  float* dOs = ONE_Q ? Qs : Qs + BQ * ld;  // [BQ][ld]
  float* PTs = dOs + BQ * ld;    // [BK][BQ + 1]: p transposed
  float* DSTs = ONE_Q ? PTs : PTs + BK * (BQ + 1);  // ds transposed
  float* lse_s = DSTs + BK * (BQ + 1);  // [BQ]
  float* delta_s = lse_s + BQ;          // [BQ]
  // With ids: the q tile's row ids, then the live q tiles.
  int* Rid = reinterpret_cast<int*>(delta_s + BQ);  // [BQ]
  int* list = Rid + BQ;
  const uint32_t xbuf = (uint32_t)__cvta_generic_to_shared(PTs);

  const int k0 = blockIdx.x / ncol * BK;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int groups = g.H / g.Hkv;
  const int tr = threadIdx.x / 16;  // owns k rows tr * RPT + i
  const int tc = threadIdx.x % 16;  // owns q columns tc + 16 * j
  constexpr bool ids = IDS;

  load_tile(Ks, k, g.kvs, b, hk, k0, g.kv_len, D, ld, c0);
  load_tile(Vs, v, g.kvs, b, hk, k0, g.kv_len, D, ld, c0);

  float dk_acc[RPT][DPT], dv_acc[RPT][DPT];
  int cid[RPT];  // with ids, the column ids of the thread's k rows
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
#pragma unroll
    for (int jd = 0; jd < DPT; ++jd) dk_acc[i][jd] = dv_acc[i][jd] = 0.f;
    const int col = k0 + tr * RPT + i;
    cid[i] = ids && col < g.kv_len ? g.col_ids[col] : 0;
  }

  // Each q head walks n_steps q tiles: from the causal bound, or with ids
  // the live list (e: the entry, with its TILE_FULL bit).
  const int qt_begin = first_live_q_tile(g, k0);
  const int n_steps = ids ? live_tiles<BK, BQ, false>(list, g, k0)
                          : (g.q_len + BQ - 1) / BQ - qt_begin;
  for (int gi = 0; gi < groups; ++gi) {
    const int h = hk * groups + gi;
    for (int it = 0; it < n_steps; ++it) {
      const int e = ids ? list[it] : 0;
      const int q0 = (ids ? e >> 1 : qt_begin + it) * BQ;
      if constexpr (ONE_Q) {
        // S^T = K Q^T, P^T staged; dP^T = V dO^T and dV += P^T dO; then
        // dS^T over P^T in place and dK += dS^T Q, Q loaded again.
        __syncthreads();
        load_tile(Qs, q, g.qs, b, h, q0, g.q_len, D, ld, c0);
        load_stats(lse_s, lse, g.stats, b, h, q0, g.q_len);
        load_stats(delta_s, delta, g.stats, b, h, q0, g.q_len);
        if (ids) load_ids(Rid, g.row_ids, q0, g.q_len);
        __syncthreads();

        float st[RPT][CPT], dpt[RPT][CPT];
#pragma unroll
        for (int i = 0; i < RPT; ++i)
#pragma unroll
          for (int j = 0; j < CPT; ++j) st[i][j] = dpt[i][j] = 0.f;
        for (int d = 0; d < D; ++d) {
          float kv[RPT], qv[CPT];
#pragma unroll
          for (int i = 0; i < RPT; ++i) kv[i] = Ks[(tr * RPT + i) * ld + d];
#pragma unroll
          for (int j = 0; j < CPT; ++j) qv[j] = Qs[(tc + 16 * j) * ld + d];
#pragma unroll
          for (int i = 0; i < RPT; ++i)
#pragma unroll
            for (int j = 0; j < CPT; ++j)
              st[i][j] = fmaf(kv[i], qv[j], st[i][j]);
        }
        // The cluster's S^T, summed in rank order, through PTs.
        if constexpr (SPLIT) exchange_partials(st, xbuf, ncol);
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
          const int r = tr * RPT + i;
          const int col = k0 + r;
#pragma unroll
          for (int j = 0; j < CPT; ++j) {
            const int qc = tc + 16 * j;
            const bool vis =
                ids ? (e & TILE_FULL) ||
                          (qc < g.q_len - q0 && cid[i] <= Rid[qc])
                    : visible(g, q0 + qc, col);
            st[i][j] = expf(vis ? st[i][j] * g.scale - lse_s[qc] : NEG_INF);
            PTs[r * (BQ + 1) + qc] = st[i][j];
          }
        }
        __syncthreads();
        load_tile(dOs, dout, g.qs, b, h, q0, g.q_len, D, ld, c0);
        __syncthreads();

        for (int d = 0; d < D; ++d) {
          float vv[RPT], dov[CPT];
#pragma unroll
          for (int i = 0; i < RPT; ++i) vv[i] = Vs[(tr * RPT + i) * ld + d];
#pragma unroll
          for (int j = 0; j < CPT; ++j) dov[j] = dOs[(tc + 16 * j) * ld + d];
#pragma unroll
          for (int i = 0; i < RPT; ++i)
#pragma unroll
            for (int j = 0; j < CPT; ++j)
              dpt[i][j] = fmaf(vv[i], dov[j], dpt[i][j]);
        }
        for (int qq = 0; qq < BQ; ++qq) {
          float pv[RPT];
#pragma unroll
          for (int i = 0; i < RPT; ++i)
            pv[i] = PTs[(tr * RPT + i) * (BQ + 1) + qq];
#pragma unroll
          for (int jd = 0; jd < DPT; ++jd) {
            const int c = tc + 16 * jd;
            if (c < D) {
              const float dov = dOs[qq * ld + c];
#pragma unroll
              for (int i = 0; i < RPT; ++i)
                dv_acc[i][jd] = fmaf(pv[i], dov, dv_acc[i][jd]);
            }
          }
        }
        __syncthreads();
        // The cluster's dP^T, summed in rank order, through PTs (P^T is
        // spent: each thread keeps its own in st).
        if constexpr (SPLIT) exchange_partials(dpt, xbuf, ncol);
#pragma unroll
        for (int i = 0; i < RPT; ++i)
#pragma unroll
          for (int j = 0; j < CPT; ++j) {
            const int qc = tc + 16 * j;
            DSTs[(tr * RPT + i) * (BQ + 1) + qc] =
                st[i][j] * (dpt[i][j] - delta_s[qc]);
          }
        load_tile(Qs, q, g.qs, b, h, q0, g.q_len, D, ld, c0);
        __syncthreads();

        for (int qq = 0; qq < BQ; ++qq) {
          float dsv[RPT];
#pragma unroll
          for (int i = 0; i < RPT; ++i)
            dsv[i] = DSTs[(tr * RPT + i) * (BQ + 1) + qq];
#pragma unroll
          for (int jd = 0; jd < DPT; ++jd) {
            const int c = tc + 16 * jd;
            if (c < D) {
              const float qv = Qs[qq * ld + c];
#pragma unroll
              for (int i = 0; i < RPT; ++i)
                dk_acc[i][jd] = fmaf(dsv[i], qv, dk_acc[i][jd]);
            }
          }
        }
      } else {
        __syncthreads();
        load_tile(Qs, q, g.qs, b, h, q0, g.q_len, D, ld, c0);
        load_tile(dOs, dout, g.qs, b, h, q0, g.q_len, D, ld, c0);
        load_stats(lse_s, lse, g.stats, b, h, q0, g.q_len);
        load_stats(delta_s, delta, g.stats, b, h, q0, g.q_len);
        if (ids) load_ids(Rid, g.row_ids, q0, g.q_len);
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
            const bool vis =
                ids ? (e & TILE_FULL) ||
                          (qc < g.q_len - q0 && cid[i] <= Rid[qc])
                    : visible(g, q0 + qc, col);
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
  }

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int row = k0 + tr * RPT + i;
    if (row >= g.kv_len) continue;
    const size_t o = g.kvs.at(b, hk, row) + c0;
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

// W: the body's width; past SPLIT_W, clusters of split_blocks(D) blocks
// of width SPLIT_W side by side on the grid's x.
template <typename T, int W>
cudaError_t launch_dkv_simt(const void* q, const void* k, const void* v,
                            const void* dout, const void* lse,
                            const void* delta, void* dk, void* dv,
                            const Geom& g, cudaStream_t stream) {
  const int n = split_blocks(g.D);
  const int shared = W > SIMT_NARROW ? 1 : 2;  // Q and dO, P^T and dS^T
  const size_t smem =
      sizeof(float) * ((size_t)(2 * BK + shared * BQ) * (min(g.D, W) + 1) +
                       shared * BK * (BQ + 1) + 2 * BQ) +
      (g.row_ids != nullptr ? 4 * BQ + id_list_bytes(g.q_len, BQ) : 0);
  const dim3 grid(n * ((g.kv_len + BK - 1) / BK), g.Hkv, g.B);
  if constexpr (W == SPLIT_W) {
    if (n > 1)
      return launch_cluster(
          g.row_ids != nullptr ? bwd_dkv_kernel_simt<T, W, true, true>
                               : bwd_dkv_kernel_simt<T, W, false, true>,
          grid, THREADS, (int)smem, n, stream, static_cast<const T*>(q),
          static_cast<const T*>(k), static_cast<const T*>(v),
          static_cast<const T*>(dout), static_cast<const float*>(lse),
          static_cast<const float*>(delta), static_cast<T*>(dk),
          static_cast<T*>(dv), g);
  }
  const auto kernel = g.row_ids != nullptr
                          ? bwd_dkv_kernel_simt<T, W, true, false>
                          : bwd_dkv_kernel_simt<T, W, false, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dk), static_cast<T*>(dv), g);
  return cudaGetLastError();
}

// Checks the geometry and launches: bf16 operands (is_bf16) on the
// tensor-core body at the instantiated head dim that covers D (the split
// body at 256), f32 on the SIMT body of the width that covers it. Returns
// a cudaError_t (0 = launched).
inline int bwd_dkv(const void* q, const void* k, const void* v,
                   const void* dout, const void* lse, const void* delta,
                   void* dk, void* dv, const Geom& g, int is_bf16,
                   void* stream) {
  if (bad_shape(g)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!is_bf16)
    return (int)(g.D <= SIMT_NARROW
                     ? launch_dkv_simt<float, SIMT_NARROW>(
                           q, k, v, dout, lse, delta, dk, dv, g, s)
                     : launch_dkv_simt<float, SPLIT_W>(q, k, v, dout, lse,
                                                       delta, dk, dv, g, s));
  if (bad_tc_operands(g, {q, k, v, dout, dk, dv}))
    return (int)cudaErrorInvalidValue;
  return (int)(g.D <= 64 ? launch_dkv_tc<64>(q, k, v, dout, lse, delta, dk,
                                             dv, g, s)
               : g.D <= 128
                   ? launch_dkv_tc<128>(q, k, v, dout, lse, delta, dk, dv, g,
                                        s)
                   : launch_dkv_tc_split(q, k, v, dout, lse, delta, dk, dv,
                                         g, s));
}

}  // namespace flash
