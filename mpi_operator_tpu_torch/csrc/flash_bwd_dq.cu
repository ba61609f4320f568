// Flash-attention backward, dq, over the projection layout.
//
// Replaces: mpi_operator_tpu/ops/attention.py:_bwd_flat_dq_kernel (the
// first Pallas kernel of _flash_flat_bwd_impl), unpacked (pack == 1) math.
//
// What bounds it on an H100: three S x S x D products per head, ~1.0e11
// FLOPs at the causal Llama shape against ~0.1 GB of operands, so the bound
// is the tensor cores (~0.1 ms). bf16 runs on the tensor-core body
// (wgmma, cp.async ring), f32 on the SIMT body (flash_bwd_dq.cuh).
//
// Design: the body (flash_bwd_dq.cuh) reads the [B, S, H*D] operands by
// strides; delta = rowsum(do * o) comes from the wrapper as f32 [B, Sq, H].
#include "flash_bwd_dq.cuh"

// q/dout/dq [B, q_len, H*D], k/v [B, kv_len, Hkv*D] (bf16 when is_bf16,
// else f32), lse/delta f32 [B, q_len, H]. Returns a cudaError_t.
extern "C" int flash_bwd_dq(const void* q, const void* k, const void* v,
                            const void* dout, const void* lse,
                            const void* delta, void* dq, int B, int q_len,
                            int kv_len, int H, int Hkv, int D, float scale,
                            int causal, int is_bf16, void* stream) {
  return flash::bwd_dq(q, k, v, dout, lse, delta, dq,
                       flash::flat_geom(B, q_len, kv_len, H, Hkv, D, scale,
                                        causal),
                       is_bf16, stream);
}
