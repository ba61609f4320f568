"""Encoder-decoder (seq2seq) transformer in PyTorch (port of
``mpi_operator_tpu/models/seq2seq.py``): teacher-forced training with
cross attention, bfloat16 compute with float32 parameters.

- the three attention kinds (encoder self, decoder causal self, decoder
  cross with Sq != Sk) run the flat flash kernels (``flash``) or the
  dense oracle (``dense``);
- pre-LN blocks with bias-free ``Dense`` layers, Flax's f32-statistics
  ``LayerNorm`` and tanh-approximated GELU (``models/llama.py``'s
  ``Dense``, ``models/bert.py``'s ``LayerNorm``); learned absolute
  positions;
- one ``embed`` table for the encoder, the decoder and the tied head,
  rounded to the compute dtype once a pass (as the port's BERT does), so
  its three uses' gradients meet on one bf16 tensor; the head multiplies
  through the bf16 x bf16 -> f32 head product (``ops/losses.py``).

Module names follow the Flax tree (``embed``, ``pos_embed``,
``enc_{i}.attn_norm``, ``self_attn.wq``, ``mlp.ffn_in``, ``enc_norm``,
``dec_{i}.self_norm``, ``cross_norm``, ``cross_attn``, ``dec_norm``), so
``interop`` carries weights across leaf by leaf. The TPU tile knobs
``flash_block_q/k`` are not carried over.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import attention_reference, flash_attention_bshd
from ..ops.losses import f32_logits
from .bert import LayerNorm, flax_default_init
from .llama import Dense


@dataclasses.dataclass(frozen=True)
class Seq2SeqConfig:
    vocab_size: int = 32128
    dim: int = 512
    n_enc_layers: int = 6
    n_dec_layers: int = 6
    n_heads: int = 8
    ffn_dim: int = 2048
    max_seq_len: int = 512
    norm_eps: float = 1e-6
    dtype: Any = torch.bfloat16
    attention_impl: str = "flash"  # 'flash' (flat kernels) | 'dense'

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_heads


def t5_small_shape(**overrides) -> Seq2SeqConfig:
    """t5-small-shaped config (~60M params; structure, not weights)."""
    return dataclasses.replace(Seq2SeqConfig(), **overrides)


def tiny(**overrides) -> Seq2SeqConfig:
    base = Seq2SeqConfig(
        vocab_size=128, dim=32, n_enc_layers=2, n_dec_layers=2, n_heads=2,
        ffn_dim=64, max_seq_len=64, dtype=torch.float32,
        attention_impl="dense",
    )
    return dataclasses.replace(base, **overrides)


CONFIGS = {"seq2seq-small": t5_small_shape, "seq2seq-tiny": tiny}


def _attend(cfg, q, k, v, causal):
    """Attention dispatch: flat flash or the dense oracle.
    q [B, Sq, H, D]; k, v [B, Sk, H, D]."""
    if cfg.attention_impl == "flash":
        return flash_attention_bshd(q, k, v, causal=causal)
    if cfg.attention_impl == "dense":
        return attention_reference(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            causal=causal).transpose(1, 2)
    raise ValueError(
        f"seq2seq attention_impl must be 'flash' or 'dense', got "
        f"{cfg.attention_impl!r}"
    )


class _Attention(nn.Module):
    """One attention sublayer (self or cross) in projection layout."""

    def __init__(self, config: Seq2SeqConfig, causal: bool, device=None):
        super().__init__()
        self.config, self.causal = config, causal
        for name in ("wq", "wk", "wv", "wo"):
            self.add_module(name, Dense(config.dim, config.dim,
                                        dtype=config.dtype, device=device))

    def forward(self, x, kv):
        cfg = self.config
        b, sq, _ = x.shape
        sk = kv.shape[1]
        # -1: the heads this process holds (all of them, or n/tp under a
        # tensor-parallel plan, which shards the projections by head).
        hd = cfg.head_dim
        q = self.wq(x).reshape(b, sq, -1, hd)
        k = self.wk(kv).reshape(b, sk, -1, hd)
        v = self.wv(kv).reshape(b, sk, -1, hd)
        att = _attend(cfg, q, k, v, self.causal)
        return self.wo(att.reshape(b, sq, -1))


class _MLP(nn.Module):
    def __init__(self, config: Seq2SeqConfig, device=None):
        super().__init__()
        self.config = config
        kw = dict(dtype=config.dtype, device=device)
        self.ffn_in = Dense(config.dim, config.ffn_dim, **kw)
        self.ffn_out = Dense(config.ffn_dim, config.dim, **kw)

    def forward(self, x):
        return self.ffn_out(F.gelu(self.ffn_in(x), approximate="tanh"))


def _norm(cfg: Seq2SeqConfig, device) -> LayerNorm:
    return LayerNorm(cfg.dim, cfg.norm_eps, cfg.dtype, device)


class _EncoderBlock(nn.Module):
    def __init__(self, config: Seq2SeqConfig, device=None):
        super().__init__()
        self.attn_norm = _norm(config, device)
        self.self_attn = _Attention(config, causal=False, device=device)
        self.mlp_norm = _norm(config, device)
        self.mlp = _MLP(config, device)

    def forward(self, x):
        h = self.attn_norm(x)
        x = x + self.self_attn(h, h)
        return x + self.mlp(self.mlp_norm(x))


class _DecoderBlock(nn.Module):
    def __init__(self, config: Seq2SeqConfig, device=None):
        super().__init__()
        self.self_norm = _norm(config, device)
        self.self_attn = _Attention(config, causal=True, device=device)
        self.cross_norm = _norm(config, device)
        self.cross_attn = _Attention(config, causal=False, device=device)
        self.mlp_norm = _norm(config, device)
        self.mlp = _MLP(config, device)

    def forward(self, x, enc):
        h = self.self_norm(x)
        x = x + self.self_attn(h, h)
        x = x + self.cross_attn(self.cross_norm(x), enc)
        return x + self.mlp(self.mlp_norm(x))


class Seq2Seq(nn.Module):
    def __init__(self, config: Seq2SeqConfig, device=None):
        super().__init__()
        cfg = self.config = config
        self.embed = nn.Embedding(cfg.vocab_size, cfg.dim, device=device)
        self.pos_embed = nn.Embedding(cfg.max_seq_len, cfg.dim, device=device)
        for i in range(cfg.n_enc_layers):
            self.add_module(f"enc_{i}", _EncoderBlock(cfg, device))
        self.enc_norm = _norm(cfg, device)
        for i in range(cfg.n_dec_layers):
            self.add_module(f"dec_{i}", _DecoderBlock(cfg, device))
        self.dec_norm = _norm(cfg, device)

    def forward(self, src_tokens, dec_tokens):
        """src_tokens [B, S_src], dec_tokens [B, S_dec] (teacher-forced
        decoder inputs) -> f32 logits [B, S_dec, V]. A sequence longer
        than the position table raises (JAX's gather would clamp it)."""
        cfg = self.config
        # Embed(dtype=compute) rounds its tables before the lookup; the
        # tied head reads the same rounded table.
        table = self.embed.weight.to(cfg.dtype)
        pos_table = self.pos_embed.weight.to(cfg.dtype)

        def with_pos(tokens):
            s = tokens.shape[1]
            if s > cfg.max_seq_len:
                raise ValueError(
                    f"sequence length {s} exceeds max_seq_len "
                    f"{cfg.max_seq_len} (the position table's rows)")
            positions = torch.arange(s, device=tokens.device)
            return (F.embedding(tokens.long(), table)
                    + F.embedding(positions, pos_table))

        enc = with_pos(src_tokens)
        for i in range(cfg.n_enc_layers):
            enc = getattr(self, f"enc_{i}")(enc)
        enc = self.enc_norm(enc)

        dec = with_pos(dec_tokens)
        for i in range(cfg.n_dec_layers):
            dec = getattr(self, f"dec_{i}")(dec, enc)
        dec = self.dec_norm(dec)
        # Tied head on the shared table, f32 logits.
        return f32_logits(dec, table.t())


@torch.no_grad()
def init_params(model: Seq2Seq, generator: torch.Generator) -> Seq2Seq:
    """Initialize ``model`` in place from Flax's default distributions
    (``models/bert.py:flax_default_init``). ``generator`` (seeded, on the
    parameters' device) makes it reproducible; its numbers differ from
    jax.random's."""
    flax_default_init(model, generator)
    return model


def loss_fn(model: Seq2Seq, src_tokens, targets, bos_id: int = 0):
    """Teacher-forced seq2seq CE: decoder inputs are the targets shifted
    right behind ``bos_id``."""
    targets = targets.long()
    dec_in = torch.cat(
        [torch.full_like(targets[:, :1], bos_id), targets[:, :-1]], dim=1)
    logits = model(src_tokens, dec_in)
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                           targets.reshape(-1))


def make_train_step(model: Seq2Seq, optimizer, accum_steps: int = 1,
                    lr_schedule=None):
    """``step(src_tokens, targets) -> loss``: one optimizer update;
    ``accum_steps > 1`` averages gradients over that many sequential
    microbatches -- see ``parallel.accum``."""
    from ..parallel.accum import make_update_step

    return make_update_step(
        lambda s, t: loss_fn(model, s, t), optimizer, accum_steps,
        lr_schedule=lr_schedule,
    )


def tensor_parallel_plan(model: Seq2Seq, tp: int) -> dict:
    """Megatron tensor parallelism over ``tp`` ranks, the JAX package's
    ``param_sharding_rules`` (models/seq2seq.py:230) on DTensor, over the
    encoder's self-attention, the decoder's self- and cross-attention and
    every MLP: q/k/v and ffn_in column-parallel, wo and ffn_out
    row-parallel. The shared token table (encoder, decoder and the tied
    head) and the position table stay whole on every tp rank (JAX splits
    the token table's vocab over tp): same result, replicated."""
    from torch.distributed.tensor.parallel import (
        ColwiseParallel,
        RowwiseParallel,
    )

    cfg = model.config
    if cfg.n_heads % tp or cfg.ffn_dim % tp:
        raise SystemExit(f"--mesh tp={tp} must divide n_heads={cfg.n_heads} "
                         f"and ffn_dim={cfg.ffn_dim}")
    sublayers = ([f"enc_{i}.self_attn" for i in range(cfg.n_enc_layers)]
                 + [f"dec_{i}.{kind}" for i in range(cfg.n_dec_layers)
                    for kind in ("self_attn", "cross_attn")])
    mlps = ([f"enc_{i}.mlp" for i in range(cfg.n_enc_layers)]
            + [f"dec_{i}.mlp" for i in range(cfg.n_dec_layers)])
    plan = {}
    for at in sublayers:
        plan.update({f"{at}.{name}": ColwiseParallel()
                     for name in ("wq", "wk", "wv")})
        plan[f"{at}.wo"] = RowwiseParallel()
    for at in mlps:
        plan[f"{at}.ffn_in"] = ColwiseParallel()
        plan[f"{at}.ffn_out"] = RowwiseParallel()
    return plan
