"""BERT-family encoder in PyTorch (port of ``mpi_operator_tpu/models/bert.py``):
masked-language-model pretraining, bidirectional attention, bfloat16
compute with float32 parameters.

- q/k/v/o and the FFN are biased ``Dense`` layers; post-LN blocks with
  Flax's ``LayerNorm`` (f32 statistics, ``E[x^2] - E[x]^2`` variance);
  tanh-approximated GELU, as ``flax.linen.gelu``;
- attention through the flat flash kernels on the projection layout
  (``flash``), the [B*H, S, D] kernels behind transposes (``flash-bhsd``,
  the layout A/B) or the dense oracle (``dense``); over an sp process
  group, the non-causal ring or Ulysses, each rank holding a contiguous
  slice of the sequence whose global positions the learned position
  table reads;
- the MLM head: ``mlm_dense`` -> gelu -> ``mlm_norm`` -> f32 logits
  against the tied ``tok_embed`` table (no bias), optionally only at
  gathered ``mlm_positions``.

Module names follow the Flax tree (``tok_embed``, ``pos_embed``,
``type_embed``, ``embed_norm``, ``layer_{i}.wq``, ``attn_norm``,
``ffn_in``, ``ffn_norm``, ``mlm_dense``, ``mlm_norm``), so ``interop``
carries weights across leaf by leaf. Flax creates ``type_embed`` only
when ``token_types`` are passed; here it always exists and, without
token types, gets no gradient (and AdamW leaves it alone). The TPU tile
knobs ``flash_block_q/k`` are not carried over.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.losses import f32_logits
from ..ops.norm import layer_norm
from ..ops.ring_attention import sp_attention, sp_attention_bshd
from ..utils import torchtrace
from .llama import Dense, checkpointed, dense_params, remat_policy_for


@dataclasses.dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    dim: int = 768
    n_layers: int = 12
    n_heads: int = 12
    ffn_dim: int = 3072
    max_seq_len: int = 512
    type_vocab_size: int = 2
    norm_eps: float = 1e-12
    dtype: Any = torch.bfloat16
    # 'flash' (the flat CUDA kernels), 'flash-bhsd' (the [B*H, S, D]
    # kernels behind transposes) or 'dense' (the oracle); plain versions
    # on the CPU. 'ring'/'ulysses' run over the sp group of
    # Bert(sp_group=...).
    attention_impl: str = "flash"
    # Per-layer activation checkpointing; 'full' recomputes each layer
    # in the backward pass, 'dots' keeps its matmul outputs and flash
    # residuals (llama.remat_policy_for).
    remat: bool = False
    remat_policy: str = "dots"


def bert_base(**overrides) -> BertConfig:
    return dataclasses.replace(BertConfig(), **overrides)


def tiny(**overrides) -> BertConfig:
    base = BertConfig(
        vocab_size=128, dim=32, n_layers=2, n_heads=2, ffn_dim=64,
        max_seq_len=64, dtype=torch.float32, attention_impl="dense",
    )
    return dataclasses.replace(base, **overrides)


CONFIGS = {"bert-base": bert_base, "bert-tiny": tiny}


class LayerNorm(nn.Module):
    """Flax ``LayerNorm(dtype=compute)``: f32 statistics with the variance
    as ``max(E[x^2] - E[x]^2, 0)``, f32 scale and bias, output in the
    compute dtype (``ops/norm.py``: the kernels on the card)."""

    def __init__(self, dim: int, eps: float, dtype, device=None):
        super().__init__()
        self.eps, self.dtype = eps, dtype
        self.scale = nn.Parameter(
            torch.ones(dim, dtype=torch.float32, device=device))
        self.bias = nn.Parameter(
            torch.zeros(dim, dtype=torch.float32, device=device))

    def forward(self, x):
        with torchtrace.timed_range("norm") as r:
            x, scale, bias = r.enter(x, self.scale, self.bias)
            return r.leave(layer_norm(x, scale, bias, self.eps, self.dtype))


class EncoderLayer(nn.Module):
    def __init__(self, config: BertConfig, device=None, sp_group=None):
        super().__init__()
        cfg = self.config = config
        self.sp_group = sp_group
        for name, n_in, n_out in (
            ("wq", cfg.dim, cfg.dim), ("wk", cfg.dim, cfg.dim),
            ("wv", cfg.dim, cfg.dim), ("wo", cfg.dim, cfg.dim),
            ("ffn_in", cfg.dim, cfg.ffn_dim), ("ffn_out", cfg.ffn_dim, cfg.dim),
        ):
            self.add_module(name, Dense(n_in, n_out, dtype=cfg.dtype,
                                        bias=True, device=device))
        self.attn_norm = LayerNorm(cfg.dim, cfg.norm_eps, cfg.dtype, device)
        self.ffn_norm = LayerNorm(cfg.dim, cfg.norm_eps, cfg.dtype, device)

    def forward(self, x):
        with torchtrace.cast_block(self.config.dtype,
                                   lambda: dense_params(self)):
            return self._forward(x)

    def _forward(self, x):
        cfg = self.config
        b, s, _ = x.shape
        # -1: the heads this process holds (n/tp under a tensor-parallel
        # plan, which shards the projections by head).
        shape = (b, s, -1, cfg.dim // cfg.n_heads)
        q = self.wq(x).reshape(shape)
        k = self.wk(x).reshape(shape)
        v = self.wv(x).reshape(shape)
        # Transpose-free dispatch first (flash on the projection layout);
        # flash-bhsd and the dense oracle need [B, H, S, D].
        sp = dict(group=self.sp_group)
        att = sp_attention_bshd(q, k, v, cfg.attention_impl, causal=False,
                                **sp)
        if att is None:
            q, k, v = (t.transpose(1, 2) for t in (q, k, v))
            att = sp_attention(q, k, v, cfg.attention_impl, causal=False,
                               **sp).transpose(1, 2)
        att = att.reshape(b, s, -1)
        x = self.attn_norm(x + self.wo(att))
        h = F.gelu(self.ffn_in(x), approximate="tanh")
        return self.ffn_norm(x + self.ffn_out(h))


class Bert(nn.Module):
    """``sp_group``: the sp process group that ``ring``/``ulysses``
    attention runs over (None on one device)."""

    def __init__(self, config: BertConfig, device=None, sp_group=None):
        super().__init__()
        if config.remat:
            remat_policy_for(config.remat_policy)  # refuses an unknown one
        cfg = self.config = config
        self.tok_embed = nn.Embedding(cfg.vocab_size, cfg.dim, device=device)
        self.pos_embed = nn.Embedding(cfg.max_seq_len, cfg.dim, device=device)
        self.type_embed = nn.Embedding(cfg.type_vocab_size, cfg.dim,
                                       device=device)
        self.embed_norm = LayerNorm(cfg.dim, cfg.norm_eps, cfg.dtype, device)
        for i in range(cfg.n_layers):
            self.add_module(f"layer_{i}", EncoderLayer(cfg, device, sp_group))
        self.mlm_dense = Dense(cfg.dim, cfg.dim, dtype=cfg.dtype, bias=True,
                               device=device)
        self.mlm_norm = LayerNorm(cfg.dim, cfg.norm_eps, cfg.dtype, device)

    def layers(self) -> list[EncoderLayer]:
        return [getattr(self, f"layer_{i}") for i in range(self.config.n_layers)]

    def forward(self, tokens, token_types=None, mlm_positions=None,
                positions=None):
        """Logits, f32: [B, S, V], or [B, P, V] with ``mlm_positions``
        ([B, P] int), which gathers the encoder output at those positions
        before the MLM head, so the head runs on P masked slots instead of
        all S; they index the columns of ``tokens`` (on an sp rank its
        own, :func:`mlm_loss_positions` maps them). ``positions`` ([S]
        int, default ``arange(S)``): the global positions of the tokens'
        columns (an sp rank's slice)."""
        cfg = self.config
        b, s = tokens.shape
        # Embed(dtype=compute) rounds its table before the lookup; the
        # tied decoder reads the same rounded table.
        table = self.tok_embed.weight.to(cfg.dtype)
        h = F.embedding(tokens.long(), table)
        if positions is None:
            positions = torch.arange(s, device=tokens.device)
        h = h + F.embedding(positions.to(tokens.device).long(),
                            self.pos_embed.weight.to(cfg.dtype))
        if token_types is not None:
            h = h + F.embedding(token_types.long(),
                                self.type_embed.weight.to(cfg.dtype))
        h = self.embed_norm(h)
        remat = cfg.remat and torch.is_grad_enabled()
        for layer in self.layers():
            h = (checkpointed(layer, h, policy=cfg.remat_policy) if remat
                 else layer(h))
        with torchtrace.timed_range("head") as r:
            h, table = r.enter(h, table)
            if mlm_positions is not None:
                index = mlm_positions.long()[..., None].expand(-1, -1,
                                                               cfg.dim)
                h = torch.gather(h, 1, index)
            h = F.gelu(self.mlm_dense(h), approximate="tanh")
            h = self.mlm_norm(h)
            return r.leave(f32_logits(h, table.t()))


@torch.no_grad()
def flax_default_init(model: nn.Module, generator: torch.Generator):
    """Initialize ``model``'s ``nn.Linear``, ``nn.Embedding`` and
    :class:`LayerNorm` modules in place from Flax's default
    distributions: ``nn.Dense`` kernels lecun-normal (truncated at two
    standard deviations, std 1/sqrt(fan_in)) with zero biases,
    ``nn.Embed`` tables normal(std 1/sqrt(dim)), LayerNorm scale 1 and
    bias 0, drawing from ``generator`` in module order. Parameters of
    other modules are left as they are."""
    for module in model.modules():
        if isinstance(module, LayerNorm):
            module.scale.fill_(1.0)
            module.bias.zero_()
        elif isinstance(module, nn.Embedding):
            p = module.weight
            p.normal_(0.0, p.shape[1] ** -0.5, generator=generator)
        elif isinstance(module, nn.Linear):  # weight [out, in]: fan_in = in
            p = module.weight
            # 0.8796...: the std of a unit normal truncated to [-2, 2].
            std = p.shape[1] ** -0.5 / 0.87962566103423978
            nn.init.trunc_normal_(p, 0.0, std, -2 * std, 2 * std,
                                  generator=generator)
            if module.bias is not None:
                module.bias.zero_()


def init_params(model: Bert, generator: torch.Generator) -> Bert:
    """Initialize ``model`` in place from Flax's default distributions
    (:func:`flax_default_init`). ``generator`` (seeded, on the
    parameters' device) makes it reproducible; its numbers differ from
    jax.random's."""
    flax_default_init(model, generator)
    return model


def _weighted_xent(logits, targets, weights):
    """sum(ce * w) / max(sum(w), 1) over the GLOBAL batch, as GSPMD takes
    it. In a world of several processes each holds part of the batch: the
    weight count is summed across the world, and the local sum scaled by
    the world size, so that the mean of the ranks' losses (and of their
    gradients, as dp and FSDP average them) is the global batch's. A tp
    rank holds the same rows as its peers; its factor cancels."""
    from ..parallel.mesh import world_size
    from ..parallel.sharding import all_reduce_sum

    with torchtrace.timed_range("head") as r:
        logits = r.enter(logits)
        ce = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                             targets.reshape(-1).long(), reduction="none")
        w = weights.reshape(-1).float()
        total, count = torch.sum(ce * w), torch.sum(w)
        n = world_size()
        if n > 1:
            total, count = total * n, all_reduce_sum(count.detach())
        return r.leave(total / torch.clamp(count, min=1.0))


def mlm_loss(model: Bert, tokens, mlm_positions_mask, mlm_targets,
             positions=None):
    """Masked-LM cross-entropy; ``mlm_positions_mask`` is 1.0 where the
    token was masked out (loss counted), 0.0 elsewhere. Computes the
    full [B, S, V] logits -- :func:`mlm_loss_positions` is the
    gathered-head variant (same value for matching masks). ``positions``:
    the columns' global positions on an sp rank."""
    return _weighted_xent(model(tokens, positions=positions), mlm_targets,
                          mlm_positions_mask)


def mlm_loss_positions(model: Bert, tokens, mlm_positions, mlm_targets,
                       mlm_weights, positions=None):
    """Masked-LM cross-entropy over gathered positions (the TF-BERT
    ``max_predictions_per_seq`` interface): ``mlm_positions`` [B, P]
    indexes the masked slots, ``mlm_targets`` [B, P] their original
    tokens, ``mlm_weights`` [B, P] 1.0 for real predictions, 0.0 for
    padding slots. The MLM head runs on P positions, not S.

    ``positions``: the global positions of an sp rank's columns. The
    slots still index the whole sequence; the rank gathers the ones that
    fall in its columns and weighs the others 0, so each slot counts on
    exactly one rank and the sum over sp is the whole batch's."""
    if positions is not None:
        from ..parallel.sharding import owned_slots

        mlm_positions, owned = owned_slots(mlm_positions, positions)
        mlm_weights = mlm_weights * owned
    logits = model(tokens, mlm_positions=mlm_positions, positions=positions)
    return _weighted_xent(logits, mlm_targets, mlm_weights)


def make_train_step(model: Bert, optimizer, accum_steps: int = 1,
                    lr_schedule=None, positions=None):
    """``step(tokens, mask, targets) -> loss``: one optimizer update.
    ``accum_steps > 1`` averages gradients over that many sequential
    microbatches (the mean of the microbatches' weighted means, as in
    JAX) -- see ``parallel.accum``. ``positions``: the global positions
    of an sp rank's columns."""
    from ..parallel.accum import make_update_step

    return make_update_step(
        lambda t, m, tg: mlm_loss(model, t, m, tg, positions), optimizer,
        accum_steps, lr_schedule=lr_schedule,
    )


def make_train_step_positions(model: Bert, optimizer, accum_steps: int = 1,
                              lr_schedule=None, positions=None):
    """The train step over the gathered-positions batch
    ``(tokens, mlm_positions, mlm_targets, mlm_weights)``; ``positions``
    as in :func:`make_train_step`."""
    from ..parallel.accum import make_update_step

    return make_update_step(
        lambda t, pos, tg, w: mlm_loss_positions(model, t, pos, tg, w,
                                                 positions),
        optimizer, accum_steps, lr_schedule=lr_schedule,
    )


def tensor_parallel_plan(model: Bert, tp: int) -> dict:
    """Megatron tensor parallelism over ``tp`` ranks, the JAX package's
    ``param_sharding_rules`` (models/bert.py:222) on DTensor: q/k/v and
    ffn_in column-parallel (their biases split with their features), wo
    and ffn_out row-parallel (each bias added once, to the sum across
    tp). The token table (which the MLM head reads, tied) stays whole on
    every tp rank (JAX splits its vocab over tp): same result,
    replicated. ViT's encoder layers carry the same names, and this is
    its plan too."""
    from torch.distributed.tensor.parallel import (
        ColwiseParallel,
        RowwiseParallel,
    )

    cfg = model.config
    if cfg.n_heads % tp or cfg.ffn_dim % tp:
        raise SystemExit(f"--mesh tp={tp} must divide n_heads={cfg.n_heads} "
                         f"and ffn_dim={cfg.ffn_dim}")
    plan = {}
    for i in range(cfg.n_layers):
        for name in ("wq", "wk", "wv", "ffn_in"):
            plan[f"layer_{i}.{name}"] = ColwiseParallel()
        for name in ("wo", "ffn_out"):
            plan[f"layer_{i}.{name}"] = RowwiseParallel()
    return plan
