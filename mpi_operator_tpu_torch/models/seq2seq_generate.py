"""Autoregressive decoding for the seq2seq family (port of
``mpi_operator_tpu/models/seq2seq_generate.py``), on the port's
``models/seq2seq.py`` parameters.

As the Llama decoder (``models/generate.py``): a static decoder
self-attention cache written in place, one single-token step for every
position, and the block math re-implemented on the parameters by name;
teacher-forced decode logits equal ``Seq2Seq.forward``'s
(``tests/test_torch_seq2seq_generate.py``). Encoder-decoder specifics:

- the encoder runs once, as a full-sequence pass (:func:`encode`);
- each decoder layer's cross-attention K/V are computed from the encoder
  output once (:func:`init_caches`); a step adds only the query
  projection and its [B, H, S_src] cross scores.

Attention here is plain torch products in f32 (the JAX package's plain
``jnp.einsum`` and its dense ``attention_reference``): no attention
kernel runs. Weights are cast to the compute dtype where they are used,
as in the JAX version.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..ops.attention import attention_reference
from ..ops.losses import f32_logits
from .seq2seq import Seq2Seq, Seq2SeqConfig


def _params(model: Seq2Seq) -> dict:
    return {k: p.detach() for k, p in model.named_parameters()}


def _ln(x, p, name, eps):
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(-1, keepdim=True)
    norm = (xf - mu) * torch.rsqrt(var + eps)
    return (norm * p[f"{name}.scale"] + p[f"{name}.bias"]).to(x.dtype)


def _proj(p, name, x, cfg):
    return F.linear(x, p[f"{name}.weight"].to(cfg.dtype))


def _mlp(p, prefix, x, cfg):
    h = F.gelu(_proj(p, f"{prefix}.ffn_in", x, cfg), approximate="tanh")
    return _proj(p, f"{prefix}.ffn_out", h, cfg)


def _full_self_attention(p, prefix, x, cfg, causal):
    """Full-sequence attention for the one-shot encoder pass.
    x: [B, S, D_model]."""
    b, s, _ = x.shape
    q, k, v = (_proj(p, f"{prefix}.{n}", x, cfg).reshape(
        b, s, cfg.n_heads, cfg.head_dim).transpose(1, 2)
        for n in ("wq", "wk", "wv"))
    att = attention_reference(q, k, v, causal=causal).transpose(1, 2)
    return _proj(p, f"{prefix}.wo", att.reshape(b, s, cfg.dim), cfg)


@torch.no_grad()
def encode(model: Seq2Seq, src_tokens, params: dict = None):
    """The training encoder, re-implemented: [B, S_src] -> [B, S_src, D]."""
    cfg = model.config
    p = params if params is not None else _params(model)
    s = src_tokens.shape[1]
    pos = torch.arange(s, device=src_tokens.device)
    x = (p["embed.weight"][src_tokens.long()]
         + p["pos_embed.weight"][pos][None]).to(cfg.dtype)
    for i in range(cfg.n_enc_layers):
        e = f"enc_{i}"
        h = _ln(x, p, f"{e}.attn_norm", cfg.norm_eps)
        x = x + _full_self_attention(p, f"{e}.self_attn", h, cfg, False)
        x = x + _mlp(p, f"{e}.mlp", _ln(x, p, f"{e}.mlp_norm", cfg.norm_eps),
                     cfg)
    return _ln(x, p, "enc_norm", cfg.norm_eps)


@torch.no_grad()
def init_caches(model: Seq2Seq, enc, batch: int, max_len: int,
                params: dict = None):
    """(self-attention caches [B, max_len, H, Dh], cross K/V [B, S_src, H,
    Dh]) for every decoder layer; the cross K/V are computed once."""
    cfg = model.config
    p = params if params is not None else _params(model)
    hd, s_src = cfg.head_dim, enc.shape[1]
    shape = (batch, max_len, cfg.n_heads, hd)
    self_caches, cross_kvs = [], []
    for i in range(cfg.n_dec_layers):
        c = f"dec_{i}.cross_attn"
        self_caches.append((
            torch.zeros(shape, dtype=cfg.dtype, device=enc.device),
            torch.zeros(shape, dtype=cfg.dtype, device=enc.device)))
        cross_kvs.append(tuple(
            _proj(p, f"{c}.{n}", enc, cfg).reshape(batch, s_src, cfg.n_heads,
                                                   hd)
            for n in ("wk", "wv")))
    return self_caches, cross_kvs


def _attend_one(q, k, v, visible=None):
    """One-position attention: q [B, H, Dh]; k, v [B, S, H, Dh]."""
    s = torch.einsum("bhd,bshd->bhs", q.float(), k.float()) * (
        q.shape[-1] ** -0.5)
    if visible is not None:
        s = torch.where(visible, s, -1e30)
    return torch.einsum("bhs,bshd->bhd", torch.softmax(s, dim=-1), v.float())


def _decode_step(p: dict, cfg: Seq2SeqConfig, self_caches, cross_kvs, token,
                 pos: int):
    """One decoder position against the caches (written in place). token
    [B]. Returns logits [B, V] f32."""
    b, hd = token.shape[0], cfg.head_dim
    x = (p["embed.weight"][token] + p["pos_embed.weight"][pos]).to(cfg.dtype)
    for i in range(cfg.n_dec_layers):
        d = f"dec_{i}"
        # Causal self-attention against the cache.
        h = _ln(x, p, f"{d}.self_norm", cfg.norm_eps)
        q, k, v = (_proj(p, f"{d}.self_attn.{n}", h, cfg).reshape(
            b, cfg.n_heads, hd) for n in ("wq", "wk", "wv"))
        ck, cv = self_caches[i]
        ck[:, pos] = k
        cv[:, pos] = v
        visible = torch.arange(ck.shape[1], device=x.device) <= pos
        att = _attend_one(q, ck, cv, visible)
        x = x + _proj(p, f"{d}.self_attn.wo",
                      att.reshape(b, cfg.dim).to(cfg.dtype), cfg)
        # Cross-attention against the precomputed encoder K/V.
        h = _ln(x, p, f"{d}.cross_norm", cfg.norm_eps)
        qc = _proj(p, f"{d}.cross_attn.wq", h, cfg).reshape(b, cfg.n_heads,
                                                            hd)
        catt = _attend_one(qc, *cross_kvs[i])
        x = x + _proj(p, f"{d}.cross_attn.wo",
                      catt.reshape(b, cfg.dim).to(cfg.dtype), cfg)
        x = x + _mlp(p, f"{d}.mlp", _ln(x, p, f"{d}.mlp_norm", cfg.norm_eps),
                     cfg)
    x = _ln(x, p, "dec_norm", cfg.norm_eps)
    return f32_logits(x, p["embed.weight"].t())


@torch.no_grad()
def generate(model: Seq2Seq, src_tokens, max_new: int,
             bos_id: int = 0) -> torch.Tensor:
    """Greedy decode ``max_new`` tokens conditioned on ``src_tokens``
    [B, S_src], starting from ``bos_id``. Returns [B, max_new]."""
    cfg, p = model.config, _params(model)
    b = src_tokens.shape[0]
    enc = encode(model, src_tokens, p)
    self_caches, cross_kvs = init_caches(model, enc, b, max_new, p)
    token = torch.full((b,), bos_id, dtype=torch.long,
                       device=src_tokens.device)
    out = []
    for t in range(max_new):
        logits = _decode_step(p, cfg, self_caches, cross_kvs, token, t)
        token = logits.argmax(dim=-1)
        out.append(token)
    return torch.stack(out, dim=1)


@torch.no_grad()
def decode_logits_teacher_forced(model: Seq2Seq, src_tokens,
                                 dec_tokens) -> torch.Tensor:
    """Teacher-forced logits [B, S_dec, V] through the cached decode path:
    equal to ``model(src_tokens, dec_tokens)``."""
    cfg, p = model.config, _params(model)
    dec_tokens = dec_tokens.long()
    b, s_dec = dec_tokens.shape
    enc = encode(model, src_tokens, p)
    self_caches, cross_kvs = init_caches(model, enc, b, s_dec, p)
    return torch.stack([
        _decode_step(p, cfg, self_caches, cross_kvs, dec_tokens[:, t], t)
        for t in range(s_dec)], dim=1)
