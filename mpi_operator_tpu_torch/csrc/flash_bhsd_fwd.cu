// Flash-attention forward over [B*H, S, D] operands.
//
// Replaces: mpi_operator_tpu/ops/attention.py:_fwd_kernel (the Pallas
// forward launched by _flash_fwd_impl), behind flash_attention and
// flash_attention_lse, with or without row/col ids.
//
// What bounds it on an H100: at the BERT-base shape (B=64, S=512, H=12,
// D=64, bf16, non-causal) the work is ~5.2e10 FLOPs against ~0.2 GB of
// operands, so the memory bounds it (~0.061 ms); at the causal Llama
// shape the tensor cores do (~0.07 ms). bf16 runs on the tensor-core body,
// f32 on the SIMT body (flash_fwd.cuh).
//
// Design: the body is the flat kernel's (flash_fwd.cuh), reading these
// operands by strides: q row b*H + h reads kv row (b*H + h) / groups, never
// an expanded kv. With ids, a pair is visible iff col_ids[col] <=
// row_ids[row] and every k tile is visited.
#include "flash_fwd.cuh"

// q/out [BH, q_len, D], k/v [BHkv, kv_len, D] (bf16 when is_bf16, else
// f32), lse f32 [BH, q_len]; row_ids int32 [q_len] and col_ids int32
// [kv_len], both or neither (null). Returns a cudaError_t (0 = launched).
extern "C" int flash_bhsd_fwd(const void* q, const void* k, const void* v,
                              void* out, void* lse, const void* row_ids,
                              const void* col_ids, int BH, int BHkv,
                              int q_len, int kv_len, int D, float scale,
                              int causal, int is_bf16, void* stream) {
  return flash::fwd(q, k, v, out, lse,
                    flash::bhsd_geom(BH, BHkv, q_len, kv_len, D, scale,
                                     causal, row_ids, col_ids),
                    is_bf16, stream);
}
