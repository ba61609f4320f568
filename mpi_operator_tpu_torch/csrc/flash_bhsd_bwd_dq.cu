// Flash-attention backward, dq, over [B*H, S, D] operands.
//
// Replaces: mpi_operator_tpu/ops/attention.py:_bwd_dq_kernel (the first
// Pallas kernel of _flash_bwd_impl), with or without row/col ids.
//
// What bounds it on an H100: three S x S x D products per head, ~7.7e10
// FLOPs at the BERT-base shape (B=64, S=512, H=12, D=64, bf16, non-causal)
// against ~0.26 GB of operands, so the tensor cores bound it (~0.078 ms).
// bf16 runs on the tensor-core body, f32 on the SIMT body
// (flash_bwd_dq.cuh).
//
// Design: the body is the flat kernel's (flash_bwd_dq.cuh), reading these
// operands by strides, GQA by index; delta = rowsum(do * o) - dlse comes
// from the wrapper as f32 [BH, Sq]. With ids, only live k tiles are
// visited (flash_common.cuh:live_tiles).
#include "flash_bwd_dq.cuh"

// q/dout/dq [BH, q_len, D], k/v [BHkv, kv_len, D] (bf16 when is_bf16, else
// f32), lse/delta f32 [BH, q_len]; row_ids int32 [q_len] and col_ids int32
// [kv_len], both or neither (null). Returns a cudaError_t.
extern "C" int flash_bhsd_bwd_dq(const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse,
                                 const void* delta, void* dq,
                                 const void* row_ids, const void* col_ids,
                                 int BH, int BHkv, int q_len, int kv_len,
                                 int D, float scale, int causal, int is_bf16,
                                 void* stream) {
  return flash::bwd_dq(q, k, v, dout, lse, delta, dq,
                       flash::bhsd_geom(BH, BHkv, q_len, kv_len, D, scale,
                                        causal, row_ids, col_ids),
                       is_bf16, stream);
}
