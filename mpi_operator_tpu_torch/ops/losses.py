"""Memory-lean LM losses (port of ``mpi_operator_tpu/ops/losses.py``).

The standard next-token loss materializes f32 logits of shape [B, S, V];
for Llama-class vocabularies that one tensor dwarfs every activation.
``lm_xent_chunked`` computes the same cross-entropy ``chunk`` sequence
positions at a time, each chunk under ``torch.utils.checkpoint``, so the
backward pass recomputes a chunk's logits instead of saving them: the
[B, S, V] logits never exist in either pass.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ._common import clamp_tile


def f32_logits(h, w):
    """``h @ w`` with w rounded to h's compute dtype and f32 logits.

    w is [D, V] (the JAX layout). Both operands are upcast to f32 before
    the product: exact for bf16 values, so the result is the bf16 x bf16
    product with f32 accumulation that the JAX version asks for
    (``preferred_element_type=f32``), where a bf16 matmul here would
    round the logits to bf16. TF32 stays off
    (``torch.backends.cuda.matmul.allow_tf32`` is False by default)."""
    return h.float() @ w.to(h.dtype).float()


def _chunk_loss(hc, tc, wc, w32):
    logits = hc.float() @ w32
    ce = F.cross_entropy(
        logits.reshape(-1, logits.shape[-1]), tc.reshape(-1), reduction="none"
    )
    return torch.sum(ce * wc.reshape(-1))


def lm_xent_chunked(h, w, targets, weights=None, *, chunk: int = 512):
    """Mean cross-entropy of ``softmax(h @ w)`` against ``targets``,
    computed ``chunk`` sequence positions at a time.

    h: [B, S, D] hidden states (any float dtype; logits are f32).
    w: [D, V] head kernel (stored f32; the product runs with w rounded to
    h.dtype and f32 accumulation, as :func:`f32_logits`).
    targets: [B, S] int labels.
    weights: optional [B, S] float mask; defaults to all-ones. The
    result is sum(ce * weights) / max(sum(weights), 1) -- identical to
    the unchunked masked mean.

    S need not divide ``chunk``: the tail is padded with weight 0.
    """
    b, s, d = h.shape
    chunk = clamp_tile(chunk, s)
    if weights is None:
        weights = torch.ones(b, s, dtype=torch.float32, device=h.device)
    weights = weights.float()
    targets = targets.long()

    pad = (-s) % chunk
    if pad:
        h = F.pad(h, (0, 0, 0, pad))
        targets = F.pad(targets, (0, pad))
        weights = F.pad(weights, (0, pad))
    # Cast once, outside the chunk loop: inside the checkpointed chunk the
    # [D, V] kernel would be re-converted per chunk on the forward AND on
    # every backward recompute.
    w32 = w.to(h.dtype).float()

    total = torch.zeros((), dtype=torch.float32, device=h.device)
    for i in range(0, s + pad, chunk):
        total = total + checkpoint(
            _chunk_loss, h[:, i:i + chunk], targets[:, i:i + chunk],
            weights[:, i:i + chunk], w32, use_reentrant=False,
        )
    return total / torch.clamp(weights.sum(), min=1.0)
