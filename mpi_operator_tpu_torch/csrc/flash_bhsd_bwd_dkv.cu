// Flash-attention backward, dk and dv, over [B*H, S, D] operands.
//
// Replaces: mpi_operator_tpu/ops/attention.py:_bwd_dkv_kernel (the second
// Pallas kernel of _flash_bwd_impl, grid (B*Hkv, nk, groups*nq)), with or
// without row/col ids.
//
// What bounds it on an H100: four S x S x D products per q head, ~1.0e11
// FLOPs at the BERT-base shape (B=64, S=512, H=12, D=64, bf16, non-causal)
// against ~0.2 GB of operands, so the tensor cores bound it (~0.10 ms).
// bf16 runs on the tensor-core body, f32 on the SIMT body
// (flash_bwd_dkv.cuh).
//
// Design: the body is the flat kernel's (flash_bwd_dkv.cuh): one block per
// (k tile, kv row b*Hkv + hk), looping inside the block over the groups q
// rows that share it, with no atomics and no expanded kv. With ids, only
// live q tiles are visited (flash_common.cuh:live_tiles).
#include "flash_bwd_dkv.cuh"

// q/dout [BH, q_len, D], k/v/dk/dv [BHkv, kv_len, D] (bf16 when is_bf16,
// else f32), lse/delta f32 [BH, q_len]; row_ids int32 [q_len] and col_ids
// int32 [kv_len], both or neither (null). Returns a cudaError_t.
extern "C" int flash_bhsd_bwd_dkv(const void* q, const void* k,
                                  const void* v, const void* dout,
                                  const void* lse, const void* delta,
                                  void* dk, void* dv, const void* row_ids,
                                  const void* col_ids, int BH, int BHkv,
                                  int q_len, int kv_len, int D, float scale,
                                  int causal, int is_bf16, void* stream) {
  return flash::bwd_dkv(q, k, v, dout, lse, delta, dk, dv,
                        flash::bhsd_geom(BH, BHkv, q_len, kv_len, D, scale,
                                         causal, row_ids, col_ids),
                        is_bf16, stream);
}
