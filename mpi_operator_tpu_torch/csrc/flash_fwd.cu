// Flash-attention forward over the projection layout.
//
// Replaces: mpi_operator_tpu/ops/attention.py:_fwd_flat_kernel (the Pallas
// forward launched by _flash_flat_fwd_impl), unpacked (pack == 1) math. At
// head dim 64 it also stands for hack/headdim_probe.py:_fwd_packed_kernel,
// which computes the same function with the TPU's 128-lane head packing.
//
// What bounds it on an H100: at the Llama shape (B=2, S=2048, H=32, Hkv=8,
// D=128, bf16, causal) the work is ~6.9e10 FLOPs against ~84 MB of
// operands, so the bound is the tensor cores (~0.07 ms at 989 TFLOP/s).
// bf16 runs on the tensor-core body (wgmma, cp.async ring), f32 on the
// SIMT body; flash_fwd.cuh says how.
//
// Design: heads sit on the grid, where the TPU kernel looped over them
// inside the program; the body (flash_fwd.cuh) reads the [B, S, H*D]
// operands by strides, so no transpose surrounds it.
#include "flash_fwd.cuh"

// q [B, q_len, H*D], k/v [B, kv_len, Hkv*D] (bf16 when is_bf16, else f32),
// out like q, lse f32 [B, q_len, H]. Returns a cudaError_t (0 = launched).
extern "C" int flash_fwd(const void* q, const void* k, const void* v,
                         void* out, void* lse, int B, int q_len, int kv_len,
                         int H, int Hkv, int D, float scale, int causal,
                         int is_bf16, void* stream) {
  return flash::fwd(q, k, v, out, lse,
                    flash::flat_geom(B, q_len, kv_len, H, Hkv, D, scale,
                                     causal),
                    is_bf16, stream);
}
