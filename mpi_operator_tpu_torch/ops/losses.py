"""Memory-lean LM losses and the f32-logits head product (port of
``mpi_operator_tpu/ops/losses.py``).

The standard next-token loss materializes f32 logits of shape [B, S, V];
for Llama-class vocabularies that one tensor dwarfs every activation.
``lm_xent_chunked`` computes the same cross-entropy ``chunk`` sequence
positions at a time, each chunk under ``torch.utils.checkpoint``, so the
backward pass recomputes a chunk's logits instead of saving them: the
[B, S, V] logits never exist in either pass.

Every head (Llama, BERT, ViT, seq2seq) multiplies through
:class:`HeadProduct`, which gives the product and its gradients the
dtypes of the JAX version's ``jnp.dot(h, w.astype(h.dtype),
preferred_element_type=f32)`` and its VJP.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ._common import clamp_tile


def head_logits_plain(h, w):
    """Plain version of the head product: f32 ``h @ w`` from bf16 h
    [N, D] and w [D, V], both upcast (exact for bf16 values) and
    multiplied in f32."""
    return h.float() @ w.float()


def head_grads_plain(h, w, g):
    """Plain version of the head product's backward, in the dtypes of
    the JAX VJP: the f32 cotangent g [N, V] times the bf16 values of w
    and h in f32, each result rounded to bf16 once: (dh [N, D], dw
    [D, V])."""
    return ((g @ w.float().t()).to(h.dtype),
            (h.float().t() @ g).to(w.dtype))


class HeadProduct(torch.autograd.Function):
    """f32 logits ``h @ w`` from bf16 h [N, D] and bf16 w [D, V].

    The backward gives what JAX's VJP of ``f32_logits`` gives: dh and dw
    from f32 products, each rounded to bf16, so that the gradient of a w
    used by several products (the chunks of ``lm_xent_chunked``) is summed
    in bf16 by autograd as the reference's scan sums it, and turned into
    f32 once by the backward of the caller's ``w.to(bfloat16)``.

    On the card all three products are cuBLAS's bf16 x bf16 GEMM with f32
    accumulation (``aten::mm.dtype``), the f32 cotangent first rounded to
    bf16 as the TPU's default-precision product takes an f32 operand in
    one bf16 pass. An operand of another dtype raises: a CUDA tensor
    never runs an f32 x f32 head GEMM. On the CPU, which has no kernel
    for ``aten::mm.dtype``, both directions take the plain versions."""

    @staticmethod
    def forward(ctx, h, w):
        if h.dtype != torch.bfloat16 or w.dtype != torch.bfloat16:
            raise TypeError(
                f"HeadProduct takes bf16 operands, got {h.dtype} x {w.dtype}")
        ctx.save_for_backward(h, w)
        if not h.is_cuda:
            return head_logits_plain(h, w)
        return torch.mm(h, w, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        h, w = ctx.saved_tensors
        if not g.is_cuda:
            return head_grads_plain(h, w, g)
        g = g.to(torch.bfloat16)
        return (torch.mm(g, w.t(), out_dtype=torch.float32).to(h.dtype),
                torch.mm(h.t(), g, out_dtype=torch.float32).to(w.dtype))


def _head(h, w):
    """f32 logits ``h [..., D] @ w [D, V]``, w already in h's dtype: bf16
    through :class:`HeadProduct`, f32 as a plain f32 product."""
    if h.dtype != torch.bfloat16:
        return h.float() @ w.float()
    lead = h.shape[:-1]
    out = HeadProduct.apply(h.reshape(-1, h.shape[-1]), w)
    return out.reshape(*lead, w.shape[1])


def f32_logits(h, w):
    """``h @ w`` with w rounded to h's compute dtype and f32 logits.

    w is [D, V] (the JAX layout). A bf16 h multiplies bf16 x bf16 with
    f32 accumulation through :class:`HeadProduct` (the JAX version's
    ``preferred_element_type=f32``); an f32 h stays an f32 product. TF32
    stays off (``torch.backends.cuda.matmul.allow_tf32`` is False by
    default)."""
    return _head(h, w.to(h.dtype))


def _chunk_loss(hc, tc, wc, w_head):
    logits = _head(hc, w_head)
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
    # every backward recompute. Each chunk's bf16 dw is summed into this
    # one tensor's gradient in bf16, as the reference's scan sums them.
    w_head = w.to(h.dtype)

    total = torch.zeros((), dtype=torch.float32, device=h.device)
    for i in range(0, s + pad, chunk):
        total = total + checkpoint(
            _chunk_loss, h[:, i:i + chunk], targets[:, i:i + chunk],
            weights[:, i:i + chunk], w_head, use_reentrant=False,
        )
    return total / torch.clamp(weights.sum(), min=1.0)
