// Shared pieces of the flash-attention kernels. Each kernel has one body
// (flash_fwd.cuh, flash_bwd_dq.cuh, flash_bwd_dkv.cuh) and two C entry
// points, one per layout: the flat kernels (flash_fwd.cu, flash_bwd_dq.cu,
// flash_bwd_dkv.cu) and the [B*H, S, D] kernels (flash_bhsd_fwd.cu,
// flash_bhsd_bwd_dq.cu, flash_bhsd_bwd_dkv.cu).
//
// Layout: the body reads every operand through strides (Geom). Element d of
// row r of head h of batch b sits at b * batch + h * head + r * row + d:
// - flat, the projection layout [B, S, nh * D] that the q/k/v projections
//   produce: batch = S * nh * D, head = D, row = nh * D; lse and delta are
//   f32 [B, Sq, H]. No transposes surround these kernels.
// - bhsd, [B*H, S, D] with kv [B*Hkv, S, D]: the entry point views it as
//   B*Hkv batches of groups = H / Hkv q heads that share one kv head, so q
//   row b*H + h reads kv row (b*H + h) / groups, as the JAX index map
//   b // groups does; lse is f32 [B*H, Sq].
// No host-side padding: rows past the sequence length are masked inside
// the kernels.
//
// Two kinds of body:
// - bf16 (forward, dq and dk/dv): tensor-core bodies (wgmma, cp.async
//   rings; flash_fwd.cuh, flash_bwd_dq.cuh and flash_bwd_dkv.cuh say their
//   tiles);
// - f32 (forward, dq and dk/dv): SIMT bodies, f32 FMA on tiles staged in
//   shared memory, with the thread map below. f32 has no tensor-core path
//   of its precision (TF32 keeps 10 mantissa bits).
//
// SIMT tiles: 64 rows of q by 64 rows of k, 256 threads. Thread t owns tile
// rows 4 * (t / 16) + i (i < 4) and tile columns (t % 16) + 16 * j (j < 4);
// for the [rows, D] accumulators it owns head-dim columns (t % 16) + 16 * j
// (j < W / 16). Each SIMT body is instantiated at two widths W, 128 for
// D <= 128 (SIMT_NARROW) and 256 above (SPLIT_W), so that D <= 128 keeps its
// registers. The 16 threads that share a row are one half of a warp, so
// row max / row sum are four xor-shuffles.
//
// Masking follows the JAX kernels exactly:
// finite NEG_INF = -1e30 (never -inf, so inf - inf never makes a NaN),
// p = exp(visible ? s - m : NEG_INF), and a fully masked row gives
// out = 0, lse = NEG_INF. Without ids the causal mask is bottom-right
// aligned, col <= row + (kv_len - q_len); with ids (either layout) a pair
// is visible iff col_ids[col] <= row_ids[row], whatever causal says. The
// bound checks row < q_len, col < kv_len take the place of JAX's +-2^30
// padding ids.
//
// Head dims past SPLIT_W (256) up to MAX_D (1024) split each head's
// columns across a thread-block cluster (ops/_common.py:flash_split_plan
// is the same plan in Python): n = ceil(D / SPLIT_W) blocks share one
// tile, block r holding columns [r SPLIT_W, (r + 1) SPLIT_W) of q, k, v
// and do (past D zero-filled) and running the SPLIT_W-wide body on them.
// Every score product (S = q k^T, dP = do v^T, or their transposes) is
// then a partial sum over the block's columns: each block stores its
// partial in its own shared memory, and after a cluster barrier every
// block reads all n partials by distributed shared memory and adds them
// in cluster-rank order (stash_partial, sum_partials), so every block
// holds the same bits of S and dP, and so the same m, l and p. Each block
// then stores only its own columns of out, dq, dk and dv; rank 0 writes
// lse. The buffer a partial lands in is free for the next step's partial
// once every block has passed the barrier's second half (cluster_arrive
// after its reads, cluster_wait before the buffer is written again).
//
// Ids (a ring attention hop's global positions, or any int32 values,
// sorted or not) are handled by tile, not by element (live_tiles below):
// a block classifies every tile it walks by the id ranges of the two
// tiles, loads only the live ones, drops the mask from fully visible
// ones, and masks the rest with its own rows' ids in registers and the
// walked tile's ids staged in shared memory beside its operands.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include <initializer_list>

#include "hopper.cuh"

#ifndef FLASH_BLOCK_Q
#define FLASH_BLOCK_Q 64
#endif
#ifndef FLASH_BLOCK_K
#define FLASH_BLOCK_K 64
#endif

namespace flash {

constexpr int BQ = FLASH_BLOCK_Q;
constexpr int BK = FLASH_BLOCK_K;
static_assert(BQ == 64 && BK == 64, "the thread map assumes 64 x 64 tiles");
constexpr int THREADS = 256;
constexpr int RPT = 4;        // tile rows per thread (64 rows / 16 row groups)
constexpr int CPT = 4;        // tile columns per thread (64 columns / 16 lanes)
constexpr int SPLIT_W = 256;      // the widest body; past it, a cluster
constexpr int MAX_D = 1024;       // the widest head dim any launch takes
// dk/dv's cluster, two walk halves of MAX_D / SPLIT_W blocks each, stays
// within the 8 blocks a portable cluster may hold.
static_assert(2 * (MAX_D / SPLIT_W) <= 8, "portable clusters");
constexpr int SIMT_NARROW = 128;  // the SIMT bodies' width for D <= 128
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;  // exp(x) = exp2(x * LOG2E)
constexpr float LN2 = 0.6931471805599453f;
constexpr int MAX_GRID_YZ = 65535;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Element offsets of (batch, head, row) in one operand.
struct Strides {
  size_t batch, head, row;
  __host__ __device__ __forceinline__ size_t at(int b, int h, int r) const {
    return (size_t)b * batch + (size_t)h * head + (size_t)r * row;
  }
};

// What a launch computes: q head h reads kv head h / (H / Hkv); the SIMT
// grids are (q or k tiles, H, B), the tensor-core grids (B * H or B * Hkv,
// tiles). qs covers q, out, do and dq; kvs k, v, dk and dv; stats lse and
// delta.
struct Geom {
  int B, H, Hkv, q_len, kv_len, D;
  float scale;
  int causal;
  const int* row_ids;  // [q_len] or null
  const int* col_ids;  // [kv_len] or null
  Strides qs, kvs, stats;
};

inline Geom flat_geom(int B, int q_len, int kv_len, int H, int Hkv, int D,
                      float scale, int causal, const void* row_ids,
                      const void* col_ids) {
  const size_t d = (size_t)D;
  return Geom{B, H, Hkv, q_len, kv_len, D, scale, causal,
              static_cast<const int*>(row_ids),
              static_cast<const int*>(col_ids),
              {(size_t)q_len * H * d, d, (size_t)H * d},
              {(size_t)kv_len * Hkv * d, d, (size_t)Hkv * d},
              {(size_t)q_len * H, 1, (size_t)H}};
}

inline Geom bhsd_geom(int BH, int BHkv, int q_len, int kv_len, int D,
                      float scale, int causal, const void* row_ids,
                      const void* col_ids) {
  // H = 0 (refused by bad_shape) when the kv rows do not divide the q rows.
  const int groups = (BHkv > 0 && BH % BHkv == 0) ? BH / BHkv : 0;
  const size_t d = (size_t)D;
  return Geom{BHkv, groups, 1, q_len, kv_len, D, scale, causal,
              static_cast<const int*>(row_ids),
              static_cast<const int*>(col_ids),
              {(size_t)groups * q_len * d, (size_t)q_len * d, d},
              {(size_t)kv_len * d, 0, d},
              {(size_t)groups * q_len, (size_t)q_len, 1}};
}

inline bool bad_shape(const Geom& g) {
  return g.B < 1 || g.B > MAX_GRID_YZ || g.H < 1 || g.H > MAX_GRID_YZ ||
         g.Hkv < 1 || g.H % g.Hkv != 0 || g.q_len < 1 || g.kv_len < 1 ||
         g.D < 1 || g.D > MAX_D ||
         (g.row_ids == nullptr) != (g.col_ids == nullptr);
}

// 64 rows of one head into shared memory as f32 [64][ld], ld = D + 1 by
// default (the +1 keeps column walks free of bank conflicts): D columns
// from col0. Rows at or past seq_len read as zero.
template <typename T>
__device__ void load_tile(float* dst, const T* __restrict__ src,
                          const Strides& s, int b, int head, int row0,
                          int seq_len, int D, int ld = 0, int col0 = 0) {
  if (ld == 0) ld = D + 1;
  for (int idx = threadIdx.x; idx < 64 * D; idx += THREADS) {
    const int r = idx / D;
    const int c = idx - r * D;
    const int row = row0 + r;
    float x = 0.f;
    if (row < seq_len) x = to_f(src[s.at(b, head, row) + col0 + c]);
    dst[r * ld + c] = x;
  }
}

// ROWS rows of one head (from row0) of a bf16 operand into a swizzled
// shared tile DP columns wide (hopper.cuh), the head's columns from col0
// (a multiple of 8), by 16-byte cp.async from the NT threads of the
// block; the caller commits. Rows at or past seq_len and columns at or
// past D (D a multiple of 8) are zero-filled, so they add nothing to any
// product.
template <int ROWS, int DP, int NT>
__device__ __forceinline__ void load_tile_async(
    uint32_t dst, const __nv_bfloat16* __restrict__ src, const Strides& s,
    int b, int head, int row0, int seq_len, int D, int col0 = 0) {
  constexpr int CPR = DP / 8;  // 16-byte chunks per row
  static_assert((ROWS * CPR) % NT == 0, "whole chunks per thread");
#pragma unroll
  for (int n = 0; n < ROWS * CPR / NT; ++n) {
    const int idx = n * NT + (int)threadIdx.x;
    const int r = idx / CPR;
    const int c = idx % CPR;
    const int row = row0 + r;
    const bool ok = row < seq_len && col0 + c * 8 < D;
    hopper::cp_async16(dst + hopper::swizzled(ROWS, r, c),
                       ok ? src + s.at(b, head, row) + col0 + c * 8 : src,
                       ok);
  }
}

// 64 entries of one head of an f32 statistic (lse, delta).
__device__ __forceinline__ void load_stats(float* dst,
                                           const float* __restrict__ src,
                                           const Strides& s, int b, int head,
                                           int row0, int seq_len) {
  for (int r = threadIdx.x; r < 64; r += THREADS) {
    const int row = row0 + r;
    dst[r] = row < seq_len ? src[s.at(b, head, row)] : 0.f;
  }
}

// Without ids: inside both sequences and, when causal, on or below the
// bottom-right-aligned diagonal. (With ids the bodies mask by tile,
// live_tiles, and by id on mixed tiles.)
__device__ __forceinline__ bool visible(const Geom& g, int row, int col) {
  if (row >= g.q_len || col >= g.kv_len) return false;
  return !g.causal || col <= row + (g.kv_len - g.q_len);
}

// Reductions over the 16 lanes that share a tile row (half a warp).
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Number of k tiles (of TK rows) a q tile of TQ rows starting at q0 must
// visit by position: with causal masking the tiles past the last visible
// column are dead and skipped. Positions say nothing of ids: with ids the
// bodies walk live_tiles' list instead.
template <int TQ = BQ, int TK = BK>
__device__ __forceinline__ int live_k_tiles(const Geom& g, int q0) {
  int end = g.kv_len;
  if (g.causal && g.row_ids == nullptr)
    end = min(g.kv_len, q0 + TQ + (g.kv_len - g.q_len));
  return end > 0 ? (end + TK - 1) / TK : 0;
}

// First q tile (of TQ rows) that can see any column of a k tile starting
// at k0, by position (as live_k_tiles).
template <int TQ = BQ>
__device__ __forceinline__ int first_live_q_tile(const Geom& g, int k0) {
  if (!g.causal || g.row_ids != nullptr) return 0;
  return max(0, k0 - (g.kv_len - g.q_len)) / TQ;
}

// True when positions alone show that every (row, col) of the q tile
// [q0, q0 + TQ) x k tile [k0, k0 + TK) is visible, so the tile needs no
// mask: no ids, both tiles inside their sequences, and (causal) the
// tile's last column visible to its first row. Uniform across a block.
// (With ids, live_tiles marks such tiles TILE_FULL.)
template <int TQ, int TK>
__device__ __forceinline__ bool fully_visible(const Geom& g, int q0, int k0) {
  return g.row_ids == nullptr && q0 + TQ <= g.q_len && k0 + TK <= g.kv_len &&
         (!g.causal || k0 + TK - 1 <= q0 + (g.kv_len - g.q_len));
}

// ---------------------------------------------------------------------------
// Ids: tiles classified by id range
// ---------------------------------------------------------------------------
//
// Over the rows of a q tile that lie inside q_len (ids rmin..rmax) and the
// columns of a k tile that lie inside kv_len (ids cmin..cmax), the pair of
// tiles is
// - dead iff cmin > rmax: no pair is visible. Exact: otherwise the column
//   holding cmin is visible to the row holding rmax;
// - full iff cmax <= rmin and both tiles lie inside their sequences: every
//   pair is visible, and the tile takes the unmasked softmax;
// - mixed otherwise, masked by element (acc_visible_ids and the f32
//   bodies' own compare).
// On a ring's ids (one run, or two half-chunk runs under zigzag) only the
// tiles on a diagonal are mixed. ops/attention.py:tile_classes is the
// plain version of this classification.

// The list entry of a live tile: (tile << 1) | TILE_FULL when full.
constexpr int TILE_FULL = 1;

// Bytes of shared memory live_tiles needs for a walk over len rows in
// tiles of T (its list and count), rounded up to 16.
__host__ __device__ constexpr int id_list_bytes(int len, int T) {
  return (4 * ((len + T - 1) / T + 1) + 15) / 16 * 16;
}

// [min, max] of ids[i] over i in [i0, min(i0 + n, len)), reduced over the
// calling warp; (INT_MAX, INT_MIN) when empty.
__device__ __forceinline__ int2 warp_id_range(const int* __restrict__ ids,
                                              int i0, int n, int len) {
  int lo = 0x7fffffff, hi = (int)0x80000000;
  for (int i = (int)threadIdx.x % 32; i < n && i0 + i < len; i += 32) {
    const int x = ids[i0 + i];
    lo = min(lo, x);
    hi = max(hi, x);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, o));
    hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, o));
  }
  return make_int2(lo, hi);
}

// Classifies, with ids, every tile of TWALK rows that a block walks
// against its own tile of TOWN rows starting at own0: its own tile is a q
// tile and it walks k tiles (OWN_ROWS: the forward and dq), or the
// reverse (dk/dv). Writes the live tiles in order to list, (tile << 1) |
// TILE_FULL when full, and returns their count to every thread. list
// holds id_list_bytes(walk length, TWALK) bytes of shared memory. Called
// by every thread of the block; ends with a barrier.
template <int TOWN, int TWALK, bool OWN_ROWS>
__device__ int live_tiles(int* list, const Geom& g, int own0) {
  const int* own_ids = OWN_ROWS ? g.row_ids : g.col_ids;
  const int* walk_ids = OWN_ROWS ? g.col_ids : g.row_ids;
  const int own_len = OWN_ROWS ? g.q_len : g.kv_len;
  const int walk_len = OWN_ROWS ? g.kv_len : g.q_len;
  const int n_walk = (walk_len + TWALK - 1) / TWALK;
  const int lane = (int)threadIdx.x % 32, warp = (int)threadIdx.x / 32;
  const int n_warps = (int)blockDim.x / 32;
  // Every warp reduces its block's own range (TOWN ids) for itself, then
  // the walked tiles in turn: one warp a tile, one flag each.
  const int2 own = warp_id_range(own_ids, own0, TOWN, own_len);
  const bool own_inside = own0 + TOWN <= own_len;
  for (int t = warp; t < n_walk; t += n_warps) {
    const int2 w = warp_id_range(walk_ids, t * TWALK, TWALK, walk_len);
    const int2 r = OWN_ROWS ? own : w;
    const int2 c = OWN_ROWS ? w : own;
    const bool full =
        c.y <= r.x && own_inside && (t + 1) * TWALK <= walk_len;
    if (lane == 0) list[t] = c.x <= r.y ? (t << 1) | (full ? TILE_FULL : 0)
                                        : -1;
  }
  __syncthreads();
  // Warp 0 compacts the flags in place, in order: chunk by chunk every
  // lane reads before any lane writes, and a chunk's entries move only
  // down, below the next chunk.
  if (warp == 0) {
    int n = 0;
    for (int base = 0; base < n_walk; base += 32) {
      const int e = base + lane < n_walk ? list[base + lane] : -1;
      __syncwarp();
      const unsigned live = __ballot_sync(0xffffffffu, e >= 0);
      if (e >= 0) list[n + __popc(live & ((1u << lane) - 1u))] = e;
      n += __popc(live);
      __syncwarp();
    }
    if (lane == 0) list[n_walk] = n;
  }
  __syncthreads();
  return list[n_walk];
}

// Rows [row0, row0 + ROWS) of one head of a bf16 operand that no pair
// reaches, set to 0 in 16-byte stores by the block's threads (D a multiple
// of 8, rows 16-byte aligned, as the tensor-core bodies require), and
// when stat is given its entries to value: the output of a block whose
// list of live tiles is empty, written at the memory's rate.
template <int ROWS>
__device__ void write_dead_rows(__nv_bfloat16* __restrict__ dst,
                                const Strides& s, int b, int head, int row0,
                                int seq_len, int D,
                                float* __restrict__ stat = nullptr,
                                const Strides& ss = Strides{0, 0, 0},
                                float value = 0.f) {
  const int cpr = D / 8;  // 16-byte chunks a row
  for (int idx = threadIdx.x; idx < ROWS * cpr; idx += blockDim.x) {
    const int row = row0 + idx / cpr;
    if (row < seq_len)
      *reinterpret_cast<uint4*>(dst + s.at(b, head, row) + idx % cpr * 8) =
          make_uint4(0u, 0u, 0u, 0u);
  }
  if (stat != nullptr)
    for (int r = threadIdx.x; r < ROWS && row0 + r < seq_len; r += blockDim.x)
      stat[ss.at(b, head, row0 + r)] = value;
}

// ids[i0 + r] for r < 64 into shared memory (0 past len: the bound checks
// mask those), by the block's threads; the caller synchronises.
__device__ __forceinline__ void load_ids(int* dst, const int* __restrict__ ids,
                                         int i0, int len) {
  for (int r = threadIdx.x; r < 64; r += blockDim.x)
    dst[r] = i0 + r < len ? ids[i0 + r] : 0;
}

// The same by 4-byte cp.async from threads 0..63, into the shared address
// dst, zero-filled past len; the caller commits.
__device__ __forceinline__ void load_ids_async(uint32_t dst,
                                               const int* __restrict__ ids,
                                               int i0, int len) {
  if (threadIdx.x < 64) {
    const int r = threadIdx.x;
    const bool ok = i0 + r < len;
    hopper::cp_async4(dst + 4 * r, ok ? ids + i0 + r : ids, ok);
  }
}

// The visible bits of a warpgroup's m64n64 accumulator (hopper.cuh's
// element map: element i at accumulator row acc_row(i), column
// acc_col(i)), bit i for element i.
// - acc_visible: no ids, accumulator rows are q rows from row0 and columns
//   k columns from col0;
// - acc_visible_ids: the same with ids, the thread's two rows' ids in
//   registers and the tile's column ids staged in shared memory (cids, 64
//   of them; n_cols inside kv_len), c0 the thread's first column in the
//   tile;
// - acc_visible_ids_t: transposed (dk/dv), accumulator rows are k rows
//   whose column ids the thread holds and columns q rows whose ids are
//   staged (rids; n_rows inside q_len).
// An accumulator row past its sequence is never written and feeds no
// other row, so its bits are immaterial: only the walked tile's bound is
// checked (the f32 bodies mask the same way).
__device__ __forceinline__ uint32_t acc_visible(const Geom& g, int row0,
                                                int col0) {
  // visible(g, row0 + acc_row(i), col0 + acc_col(i)) with the offsets
  // folded into three per-tile bounds, so each element compares its
  // compile-time acc_row / acc_col and nothing per element stays live.
  const int n_rows = g.q_len - row0, n_cols = g.kv_len - col0;
  const int diag =
      g.causal ? row0 - col0 + (g.kv_len - g.q_len) : 0x7fffffff;
  uint32_t vis = 0;
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int r = hopper::acc_row(i), c = hopper::acc_col(i);
    if (r < n_rows && c < n_cols && c - r <= diag) vis |= 1u << i;
  }
  return vis;
}
__device__ __forceinline__ uint32_t acc_visible_ids(const int (&rid)[2],
                                                    const int* cids, int c0,
                                                    int n_cols) {
  uint32_t vis = 0;
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int c = c0 + hopper::acc_col(i);
    if (c < n_cols && cids[c] <= rid[(i >> 1) & 1]) vis |= 1u << i;
  }
  return vis;
}
__device__ __forceinline__ uint32_t acc_visible_ids_t(const int (&cid)[2],
                                                      const int* rids, int c0,
                                                      int n_rows) {
  uint32_t vis = 0;
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int c = c0 + hopper::acc_col(i);
    if (c < n_rows && cid[(i >> 1) & 1] <= rids[c]) vis |= 1u << i;
  }
  return vis;
}

// ---------------------------------------------------------------------------
// Head dims past SPLIT_W: the cluster's partial sums
// ---------------------------------------------------------------------------

// Stores a thread's N partial sums (N a multiple of 4) at slot `slot` of
// `slots` in the exchange buffer at shared address buf: float4 i at
// (i * slots + slot) * 16, so a warp's stores and loads are contiguous.
template <int N>
__device__ __forceinline__ void stash_partial(uint32_t buf,
                                              const float (&x)[N], int slot,
                                              int slots) {
#pragma unroll
  for (int i = 0; i < N / 4; ++i)
    hopper::st_shared(buf + (i * slots + slot) * 16,
                      make_float4(x[4 * i], x[4 * i + 1], x[4 * i + 2],
                                  x[4 * i + 3]));
}

// x = the sum of the partials that the blocks of cluster ranks rank0,
// rank0 + 1, ..., rank0 + n - 1 stashed at the same slot of the same
// buffer, added in that order, so every block gets the same bits; own is
// this block's rank, whose partial it reads from its own shared memory
// (the others by distributed shared memory). G float4s of a block are
// read at a time: 8 G registers of loads in flight, N / (4 G) round trips
// a block.
template <int G, int N>
__device__ __forceinline__ void sum_partials(float (&x)[N], uint32_t buf,
                                             int slot, int slots, int rank0,
                                             int n, int own) {
  static_assert((N / 4) % G == 0, "whole groups of float4s");
  auto load = [&](int rank, int i) {
    const uint32_t off = (i * slots + slot) * 16;
    return rank == own
               ? hopper::ld_shared(buf + off)
               : hopper::ld_cluster(
                     hopper::map_to_rank(buf, (uint32_t)rank) + off);
  };
#pragma unroll
  for (int i0 = 0; i0 < N / 4; i0 += G) {
    float4 a[G];
#pragma unroll
    for (int i = 0; i < G; ++i) a[i] = load(rank0, i0 + i);
#pragma unroll 1
    for (int c = 1; c < n; ++c) {
      float4 p[G];
#pragma unroll
      for (int i = 0; i < G; ++i) p[i] = load(rank0 + c, i0 + i);
#pragma unroll
      for (int i = 0; i < G; ++i) {
        a[i].x += p[i].x;
        a[i].y += p[i].y;
        a[i].z += p[i].z;
        a[i].w += p[i].w;
      }
    }
#pragma unroll
    for (int i = 0; i < G; ++i) {
      x[4 * (i0 + i)] = a[i].x;
      x[4 * (i0 + i) + 1] = a[i].y;
      x[4 * (i0 + i) + 2] = a[i].z;
      x[4 * (i0 + i) + 3] = a[i].w;
    }
  }
}

// A SIMT thread's [RPT][CPT] score tile exchanged whole: stash, a cluster
// barrier, the sum, and a second barrier after which the buffer is free
// again.
__device__ __forceinline__ void exchange_partials(float (&x)[RPT][CPT],
                                                  uint32_t buf, int n) {
  float f[RPT * CPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int j = 0; j < CPT; ++j) f[i * CPT + j] = x[i][j];
  stash_partial(buf, f, (int)threadIdx.x, THREADS);
  hopper::cluster_sync();  // every block's partial has landed
  sum_partials<1>(f, buf, (int)threadIdx.x, THREADS, 0, n,
                  (int)hopper::cluster_rank());
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int j = 0; j < CPT; ++j) x[i][j] = f[i * CPT + j];
  hopper::cluster_sync();  // every block has read them
}

// Launches `kernel` on clusters of `cluster` blocks along x (grid.x a
// multiple of it) with `smem` bytes of dynamic shared memory.
template <typename... Params, typename... Args>
cudaError_t launch_cluster(void (*kernel)(Params...), dim3 grid, int threads,
                           int smem, int cluster, cudaStream_t stream,
                           Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3((unsigned)threads);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// Blocks a cluster splits a head of D columns into (1 up to MAX_D /
// SPLIT_W).
inline int split_blocks(int D) { return (D + SPLIT_W - 1) / SPLIT_W; }

// The bf16 tensor-core bodies read 16-byte chunks of rows: the head dim
// must be a multiple of 8 and every operand 16-byte aligned (the wrappers
// pad another head dim with zero columns to the next multiple of 8).
inline bool bad_tc_operands(const Geom& g,
                            std::initializer_list<const void*> ptrs) {
  if (g.D % 8 != 0) return true;
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return true;
  return false;
}

}  // namespace flash
