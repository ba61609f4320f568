// Flash-attention backward, dk and dv, over the projection layout.
//
// Replaces: mpi_operator_tpu/ops/attention.py:_bwd_flat_dkv_kernel (the
// second Pallas kernel of _flash_flat_bwd_impl), unpacked (pack == 1) math.
//
// What bounds it on an H100: four S x S x D products per q head, ~1.4e11
// FLOPs at the causal Llama shape against ~0.1 GB of operands, so the bound
// is the tensor cores (~0.14 ms). bf16 runs on the tensor-core body
// (wgmma, cp.async ring), f32 on the SIMT body (flash_bwd_dkv.cuh).
//
// Design: the body (flash_bwd_dkv.cuh) reads the [B, S, H*D] operands by
// strides and sums each kv head over its q heads inside one block. With
// row/col ids every q tile is visited.
#include "flash_bwd_dkv.cuh"

// q/dout [B, q_len, H*D], k/v/dk/dv [B, kv_len, Hkv*D] (bf16 when is_bf16,
// else f32), lse/delta f32 [B, q_len, H]; row_ids int32 [q_len] and
// col_ids int32 [kv_len], both or neither (null). Returns a cudaError_t.
extern "C" int flash_bwd_dkv(const void* q, const void* k, const void* v,
                             const void* dout, const void* lse,
                             const void* delta, void* dk, void* dv,
                             const void* row_ids, const void* col_ids, int B,
                             int q_len, int kv_len, int H, int Hkv, int D,
                             float scale, int causal, int is_bf16,
                             void* stream) {
  return flash::bwd_dkv(q, k, v, dout, lse, delta, dk, dv,
                        flash::flat_geom(B, q_len, kv_len, H, Hkv, D, scale,
                                         causal, row_ids, col_ids),
                        is_bf16, stream);
}
