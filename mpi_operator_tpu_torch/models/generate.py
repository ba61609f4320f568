"""Autoregressive decoding for Llama with a static KV cache (port of
``mpi_operator_tpu/models/generate.py``).

- **static cache**: ``init_cache`` preallocates [B, H_kv, S_max, D] per
  layer in the compute dtype; each step writes its position in place and
  attention scores the query against the whole cache in f32 under a
  ``<= pos`` mask;
- **one step for prompt and output**: the prompt is teacher-forced one
  token a step through the same single-token step that then emits argmax
  tokens or samples;
- **GQA-aware**: the cache holds the n_kv_heads; query heads map onto
  them group-wise, the kv heads never expand;
- MoE configs decode through ``_moe_step``: every expert on every token,
  weighted by the normalized top-k gates (no capacity, so no drops).

The step re-implements the block forward on the model's parameters by
name; teacher-forced decode logits equal the training forward's
(``tests/test_torch_generate.py``). Decode attention is plain torch
products, as the JAX package's is plain ``jnp.einsum``: no attention
kernel runs here. :func:`decode_weights` casts the matmul weights to the
compute dtype once, before the steps (the JAX step casts them each step:
the same numbers); RMSNorm scales and the MoE router stay f32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..ops.attention import NEG_INF
from ..ops.losses import f32_logits
from .llama import Llama, LlamaConfig, _rope
from .moe import topk_gates


def decode_weights(model: Llama) -> dict:
    """The model's parameters by name for decoding: matmul weights (and
    the embedding) in the compute dtype, norm scales and the router in
    f32. Detached: decoding takes no gradient."""
    dtype = model.config.dtype
    out = {}
    for name, p in model.named_parameters():
        keep = name.endswith((".scale", ".router"))
        out[name] = p.detach() if keep else p.detach().to(dtype)
    return out


def _layer(weights: dict, i: int) -> dict:
    prefix = f"layer_{i}."
    return {k[len(prefix):]: v for k, v in weights.items()
            if k.startswith(prefix)}


def _rms(x, scale, eps):
    xf = x.float()
    norm = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return (norm * scale).to(x.dtype)


def _attn_step(p, cache_k, cache_v, x, pos: int, cfg: LlamaConfig):
    """One position through one attention block. x: [B, D]; cache_k/v:
    [B, H_kv, S_max, Dh], written at ``pos`` in place. Returns out."""
    b = x.shape[0]
    hd = cfg.head_dim
    q = F.linear(x, p["attn.wq.weight"]).reshape(b, cfg.n_heads, hd)
    k = F.linear(x, p["attn.wk.weight"]).reshape(b, cfg.n_kv_heads, hd)
    v = F.linear(x, p["attn.wv.weight"]).reshape(b, cfg.n_kv_heads, hd)
    positions = torch.full((b, 1), pos, device=x.device)
    q = _rope(q[:, None], positions, cfg.rope_theta)[:, 0]
    k = _rope(k[:, None], positions, cfg.rope_theta)[:, 0]
    cache_k[:, :, pos] = k.to(cache_k.dtype)
    cache_v[:, :, pos] = v.to(cache_v.dtype)

    groups = cfg.n_heads // cfg.n_kv_heads
    qg = q.reshape(b, cfg.n_kv_heads, groups, hd)
    scores = torch.einsum("bkgd,bksd->bkgs", qg.float(),
                          cache_k.float()) * (hd ** -0.5)
    visible = torch.arange(cache_k.shape[2], device=x.device) <= pos
    scores = torch.where(visible, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgs,bksd->bkgd", probs, cache_v.float()).reshape(
        b, cfg.n_heads * hd).to(cfg.dtype)
    return F.linear(out, p["attn.wo.weight"])


def _mlp_step(p, x):
    gate = F.linear(x, p["mlp.w_gate.weight"])
    up = F.linear(x, p["mlp.w_up.weight"])
    return F.linear(F.silu(gate) * up, p["mlp.w_down.weight"])


def _moe_step(p, x, cfg: LlamaConfig):
    """One position through a sparse-MoE FFN. Each token routes alone at
    decode, so no capacity competes and nothing drops: the training
    semantics reduce to all E experts weighted by the normalized top-k
    gates (dense weights, zero off the top k)."""
    probs = torch.softmax(x.float() @ p["moe.router"], dim=-1)  # [B, E]
    _, _, w = topk_gates(probs, cfg.moe_top_k)
    hg = torch.einsum("bd,edf->bef", x, p["moe.expert_wg"])
    hu = torch.einsum("bd,edf->bef", x, p["moe.expert_wu"])
    out_e = torch.einsum("bef,efd->bed", F.silu(hg) * hu, p["moe.expert_wd"])
    return torch.einsum("be,bed->bd", w, out_e.float()).to(x.dtype)


def _decode_step(weights: dict, layers: list, cfg: LlamaConfig, caches,
                 token, pos: int):
    """One token through the whole model. token: [B] int; caches: one
    (k, v) a layer, written in place; ``layers``: each layer's weights
    (``_layer``). Returns logits [B, V] f32."""
    x = weights["embed.weight"][token].to(cfg.dtype)  # [B, D]
    for p, (ck, cv) in zip(layers, caches):
        h = _rms(x, p["attn_norm.scale"], cfg.norm_eps)
        x = x + _attn_step(p, ck, cv, h, pos, cfg)
        h = _rms(x, p["mlp_norm.scale"], cfg.norm_eps)
        x = x + (_moe_step(p, h, cfg) if cfg.is_moe else _mlp_step(p, h))
    x = _rms(x, weights["final_norm.scale"], cfg.norm_eps)
    head = (weights["embed.weight"] if cfg.tie_embeddings
            else weights["lm_head.weight"])
    # bf16 x bf16 -> f32 logits (ops/losses.py:f32_logits), head [D, V].
    return f32_logits(x, head.t())


def init_cache(cfg: LlamaConfig, batch: int, max_len: int, dtype=None,
               device=None) -> list:
    dtype = dtype or cfg.dtype
    shape = (batch, cfg.n_kv_heads, max_len, cfg.head_dim)
    return [(torch.zeros(shape, dtype=dtype, device=device),
             torch.zeros(shape, dtype=dtype, device=device))
            for _ in range(cfg.n_layers)]


class Decoder:
    """Decode state for one batch: the weights cast once, each layer's
    view of them and the static cache. ``step(token, pos)`` runs one
    position and returns its f32 logits."""

    def __init__(self, model: Llama, batch: int, max_len: int,
                 weights: dict = None):
        cfg = self.config = model.config
        self.weights = weights if weights is not None else decode_weights(
            model)
        self.layers = [_layer(self.weights, i) for i in range(cfg.n_layers)]
        device = self.weights["embed.weight"].device
        self.caches = init_cache(cfg, batch, max_len, device=device)

    def step(self, token, pos: int):
        return _decode_step(self.weights, self.layers, self.config,
                            self.caches, token, pos)


@torch.no_grad()
def decode_logits_teacher_forced(model: Llama, tokens,
                                 weights: dict = None) -> torch.Tensor:
    """The decode path's logits [B, S, V] with ``tokens`` [B, S] teacher-
    forced: position t's equal the training forward's at t. ``weights``
    as for :func:`generate`."""
    tokens = tokens.long()
    dec = Decoder(model, tokens.shape[0], tokens.shape[1], weights)
    return torch.stack([dec.step(tokens[:, t], t)
                        for t in range(tokens.shape[1])], dim=1)


@torch.no_grad()
def generate(model: Llama, prompt, *, max_new: int,
             temperature: float = 0.0, generator: torch.Generator = None,
             weights: dict = None) -> torch.Tensor:
    """Decode ``max_new`` tokens after ``prompt`` [B, S0]: for the first
    S0-1 steps the next input is the prompt's token, afterwards the
    model's own. temperature 0 = greedy (argmax, the first of equal
    maxima); > 0 = softmax sampling at that temperature, drawn from
    ``generator`` (required). ``weights``: :func:`decode_weights` made
    beforehand (else made here). Returns [B, S0 + max_new] tokens."""
    if temperature > 0 and generator is None:
        raise ValueError(
            "sampling (temperature > 0) needs a torch.Generator")
    prompt = prompt.long()
    b, s0 = prompt.shape
    dec = Decoder(model, b, s0 + max_new, weights)
    out = [prompt[:, :1]]
    token = prompt[:, 0]
    for t in range(s0 + max_new - 1):
        logits = dec.step(token, t)
        if t + 1 < s0:  # teacher-forced inside the prompt
            token = prompt[:, t + 1]
        elif temperature > 0:
            token = torch.multinomial(
                torch.softmax(logits / temperature, dim=-1), 1,
                generator=generator)[:, 0]
        else:
            token = logits.argmax(dim=-1)
        out.append(token[:, None])
    return torch.cat(out, dim=1)
