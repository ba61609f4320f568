"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense,
without sparsity), at its full 700 W power limit."""

FLOPS = {"bf16": 989e12, "fp16": 989e12, "tf32": 495e12, "f32": 67e12}
BYTES_PER_S = 3.35e12
