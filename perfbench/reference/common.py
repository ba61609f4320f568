"""What the reference families share: the products at a stated precision,
RMSNorm, LayerNorm, RoPE, attention, GELU, cross-entropy, and the batches
of the token stream (the Feistel order and BERT's masking) worked out
again from the token file."""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

PRECISIONS = ("f32", "fp8")
FP8_MAX = 448.0  # the largest finite float8_e4m3fn


def _fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 under one scale for the tensor (its
    largest magnitude to the format's largest), back in x's dtype."""
    scale = x.detach().abs().amax().clamp_min(1e-30) / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale


class _Fp8Matmul(torch.autograd.Function):
    """``a @ b`` with every operand of the forward and of both backward
    products rounded to float8 first: a product computed in fp8."""

    @staticmethod
    def forward(ctx, a, b):
        qa, qb = _fp8(a), _fp8(b)
        ctx.save_for_backward(qa, qb)
        return qa @ qb

    @staticmethod
    def backward(ctx, g):
        qa, qb = ctx.saved_tensors
        qg = _fp8(g)
        return qg @ qb.transpose(-1, -2), qa.transpose(-1, -2) @ qg


def matmul(a, b, precision: str):
    """``a @ b`` in f32, or with fp8 operands (the control)."""
    if precision == "f32":
        return a @ b
    if precision == "fp8":
        return _Fp8Matmul.apply(a, b)
    raise ValueError(f"precision {precision!r}; want one of {PRECISIONS}")


def linear(x, w, precision: str, b=None):
    """``x @ w.T (+ b)`` for a [out, in] weight."""
    y = matmul(x, w.t(), precision)
    return y if b is None else y + b


def rms_norm(x, scale, eps: float):
    return x / torch.sqrt((x * x).mean(-1, keepdim=True) + eps) * scale


def layer_norm(x, scale, bias, eps: float):
    mean = x.mean(-1, keepdim=True)
    var = ((x - mean) ** 2).mean(-1, keepdim=True)
    return (x - mean) / torch.sqrt(var + eps) * scale + bias


def gelu_tanh(x):
    return 0.5 * x * (1.0 + torch.tanh(
        math.sqrt(2.0 / math.pi) * (x + 0.044715 * x ** 3)))


def rope(x, theta: float):
    """Rotary position embedding on [B, H, S, Dh], the rotate-half
    convention: pairs (i, i + Dh/2) turned by position x theta^(-2i/Dh)."""
    s, dh = x.shape[-2], x.shape[-1]
    inv = theta ** (-torch.arange(0, dh, 2, dtype=torch.float64,
                                  device=x.device) / dh)
    ang = torch.arange(s, dtype=torch.float64, device=x.device)[:, None] * inv
    cos, sin = torch.cos(ang).to(x.dtype), torch.sin(ang).to(x.dtype)
    a, b = x[..., :dh // 2], x[..., dh // 2:]
    return torch.cat([a * cos - b * sin, b * cos + a * sin], dim=-1)


def _attention_core(q, k, v, causal: bool, precision: str):
    scores = matmul(q, k.transpose(-1, -2), precision) / math.sqrt(q.shape[-1])
    if causal:
        s = q.shape[-2]
        mask = torch.ones(s, s, dtype=torch.bool, device=q.device).triu(1)
        scores = scores.masked_fill(mask, float("-inf"))
    return matmul(torch.softmax(scores, dim=-1), v, precision)


def attention(q, k, v, causal: bool, precision: str, heads_at_once: int):
    """softmax(q k^T / sqrt(Dh)) v on [B, H, S, Dh], k and v with H / Hkv
    q heads each (grouped-query); ``heads_at_once`` q heads at a time,
    each group recomputed in the backward so that its [S, S] scores are
    never kept."""
    h, hkv = q.shape[1], k.shape[1]
    rep = h // hkv
    outs = []
    for lo in range(0, h, heads_at_once):
        hi = min(h, lo + heads_at_once)
        kv = torch.arange(lo, hi, device=q.device) // rep
        outs.append(checkpoint(_attention_core, q[:, lo:hi], k[:, kv],
                               v[:, kv], causal, precision,
                               use_reentrant=False))
    return torch.cat(outs, dim=1)


def cross_entropy_sum(logits, targets):
    """The summed cross-entropy of f32 logits [N, V] against [N]."""
    lse = torch.logsumexp(logits, dim=-1)
    return (lse - logits.gather(1, targets[:, None])[:, 0]).sum()


# -- the token stream, worked out again ------------------------------------

_MASK64 = (1 << 64) - 1
_GOLDEN = 0x9E3779B97F4A7C15


def _mix64(z: int) -> int:
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return z ^ (z >> 31)


def shuffled(n: int, seed: int, i: int) -> int:
    """Position ``i`` of an ``n``-sequence epoch in the trainer's stateless
    order: a 4-round balanced Feistel network over 2b bits whose keys
    come from ``seed``, cycle-walked down to [0, n)."""
    if n <= 1:
        return 0
    half = max((max(n - 1, 1).bit_length() + 1) // 2, 1)
    mask = (1 << half) - 1
    keys = [_mix64((seed + _GOLDEN * (r + 1)) & _MASK64) for r in range(4)]

    def once(v: int) -> int:
        left, right = v >> half, v & mask
        for key in keys:
            left, right = right, left ^ (_mix64(right ^ key) & mask)
        return (left << half) | right

    v = once(i)
    while v >= n:
        v = once(v)
    return v


def batch_rows(path, seq_len: int, global_batch: int, step: int,
               data_seed: int, vocab: int) -> np.ndarray:
    """The [B, S] token rows of step ``step``: shuffled positions
    [step B, (step + 1) B) of the corpus, each epoch under the data seed
    plus its number, ids taken modulo the vocabulary."""
    corpus = np.fromfile(str(path), dtype="<u4")
    n = corpus.size // seq_len
    corpus = corpus[:n * seq_len].reshape(n, seq_len)
    rows = []
    for j in range(global_batch):
        epoch, pos = divmod(step * global_batch + j, n)
        rows.append(corpus[shuffled(n, (data_seed + epoch) & _MASK64, pos)])
    return np.stack(rows).astype(np.int64) % vocab


def mlm_batch(rows: np.ndarray, data_seed: int, step: int):
    """BERT's masked batch of ``rows``: each row's max(1, int(0.15 S))
    positions with the smallest of a uniform draw from RandomState(data
    seed + step) become its slots, sorted; their inputs are set to id 0.
    Returns (inputs, positions, targets, weights)."""
    b, s = rows.shape
    rand = np.random.RandomState(data_seed + step).rand(b, s)
    n_pred = max(int(s * 0.15), 1)
    pos = np.sort(np.argsort(rand, axis=1)[:, :n_pred], axis=1)
    targets = np.take_along_axis(rows, pos, axis=1)
    inputs = rows.copy()
    np.put_along_axis(inputs, pos, 0, axis=1)
    return inputs, pos, targets, np.ones((b, n_pred), np.float32)
