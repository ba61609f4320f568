"""Llama-family decoder transformer in PyTorch, dense and sparse MoE
(port of ``mpi_operator_tpu/models/llama.py``).

- bfloat16 compute, float32 parameters, f32 logits for the loss;
- attention through the hand-written flash kernels
  (``ops.attention.flash_attention_bshd``) on the projection layout, the
  [B*H, S, D] kernels (``flash-bhsd``, behind transposes) or the dense
  oracle;
- per-layer activation checkpointing (``remat_policy="full"``) trades
  FLOPs for memory;
- MoE configs (``mixtral-8x7b``, ``llama-moe-tiny``) replace every
  block's MLP by ``models/moe.py:MoEMLP`` (``layer_{i}.moe``); the
  blocks' router aux losses are summed and the train loss adds
  ``router_aux_coef`` times that sum.

Module names follow the Flax tree (``embed``, ``layer_{i}.attn.wq``,
``attn_norm``, ``mlp.w_gate``, ``final_norm``, ``lm_head``), so
``interop`` carries weights across leaf by leaf. The ``"dots"`` remat
policy is a later slice of the port.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops.losses import f32_logits, lm_xent_chunked
from ..ops.ring_attention import sp_attention, sp_attention_bshd


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 128256
    dim: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 8
    ffn_dim: int = 14336
    # The context cmd.eval holds --seq-len to (RoPE itself has no table).
    max_seq_len: int = 8192
    rope_theta: float = 500000.0
    norm_eps: float = 1e-5
    dtype: Any = torch.bfloat16
    remat: bool = True
    # 'full' recomputes each block in the backward pass; 'dots' (save
    # the matmul outputs and the flash residuals) is not ported yet.
    remat_policy: str = "full"
    tie_embeddings: bool = False
    # 'flash' (the CUDA kernels; plain versions on the CPU), 'flash-bhsd'
    # (the [B*H, S, D] kernels behind transposes: the layout A/B) or
    # 'dense' (the oracle). 'ring'/'ulysses' raise until sequence
    # parallelism is ported.
    attention_impl: str = "flash"
    # Sparse MoE FFN (models/moe.py): 0 = dense SwiGLU; > 0 replaces every
    # block's MLP with n_experts experts routed top-k, experts sharded over
    # the ep mesh axis. The train loss adds router_aux_coef x the Switch
    # load-balance loss.
    n_experts: int = 0
    moe_top_k: int = 2
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01
    # > 0: the train loss computes cross-entropy in sequence chunks of
    # this size (ops/losses.py:lm_xent_chunked); 0 = full [B, S, V] logits.
    xent_chunk: int = 0

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_heads

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0


def llama3_8b(**overrides) -> LlamaConfig:
    return dataclasses.replace(LlamaConfig(), **overrides)


def tiny(**overrides) -> LlamaConfig:
    """Test-scale config: real structure, toy widths."""
    base = LlamaConfig(
        vocab_size=256, dim=64, n_layers=2, n_heads=4, n_kv_heads=2,
        ffn_dim=128, max_seq_len=128, dtype=torch.float32, remat=False,
        attention_impl="dense",
    )
    return dataclasses.replace(base, **overrides)


def mixtral_8x7b(**overrides) -> LlamaConfig:
    """Mixtral-style sparse MoE: Llama structure, 8 experts routed top-2."""
    base = LlamaConfig(
        vocab_size=32000, dim=4096, n_layers=32, n_heads=32, n_kv_heads=8,
        ffn_dim=14336, max_seq_len=32768, rope_theta=1e6,
        n_experts=8, moe_top_k=2,
    )
    return dataclasses.replace(base, **overrides)


def tiny_moe(**overrides) -> LlamaConfig:
    """Test-scale MoE config (4 experts, top-2)."""
    return tiny(**{"n_experts": 4, "moe_top_k": 2, **overrides})


# The one name -> config mapping of cmd.train, cmd.eval and cmd.generate:
# a checkpoint trained under a name loads under it.
CONFIGS = {
    "llama3-8b": llama3_8b,
    "llama-tiny": tiny,
    "mixtral-8x7b": mixtral_8x7b,
    "llama-moe-tiny": tiny_moe,
}


def config_for(name: str, **overrides) -> LlamaConfig:
    if name not in CONFIGS:
        raise KeyError(
            f"unknown llama model {name!r}; want one of {sorted(CONFIGS)}"
        )
    return CONFIGS[name](**overrides)


def _rope(x, positions, theta: float):
    """Rotary embeddings. x: [B, S, H, D_head]; positions: [B, S]."""
    d = x.shape[-1]
    exponents = torch.arange(0, d, 2, dtype=torch.float32, device=x.device) / d
    freqs = 1.0 / (theta ** exponents)
    angles = positions[..., None].float() * freqs  # [B, S, D/2]
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


class Dense(nn.Linear):
    """``nn.Dense(dtype=compute, param_dtype=f32)``: f32 weight (and
    bias), both operands rounded to the compute dtype (bf16 on the card),
    output in it; the bias, where there is one, added after the product
    in the compute dtype. A module call, so that a tensor-parallel plan's
    hooks fire (``parallel/sharding.py``)."""

    def __init__(self, n_in: int, n_out: int, *, dtype, bias: bool = False,
                 device=None):
        super().__init__(n_in, n_out, bias=bias, device=device)
        self.compute_dtype = dtype

    def forward(self, x):
        dtype = self.compute_dtype
        y = F.linear(x.to(dtype), self.weight.to(dtype))
        return y if self.bias is None else y + self.bias.to(dtype)


class F32LogitsDense(nn.Module):
    """Bias-free projection producing f32 logits from compute-dtype
    operands; the weight lives in f32 as [features, in]."""

    def __init__(self, in_features: int, features: int, device=None):
        super().__init__()
        self.weight = nn.Parameter(
            torch.empty(features, in_features, dtype=torch.float32,
                        device=device)
        )

    def forward(self, x):
        return f32_logits(x, self.weight.t())


class RMSNorm(nn.Module):
    def __init__(self, dim: int, eps: float = 1e-5, device=None):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(
            torch.ones(dim, dtype=torch.float32, device=device)
        )

    def forward(self, x):
        xf = x.float()
        norm = xf * torch.rsqrt(
            torch.mean(xf * xf, dim=-1, keepdim=True) + self.eps
        )
        return (norm * self.scale).to(x.dtype)


class Attention(nn.Module):
    def __init__(self, config: LlamaConfig, device=None):
        super().__init__()
        cfg = self.config = config
        hd, kw = cfg.head_dim, dict(dtype=cfg.dtype, device=device)
        self.wq = Dense(cfg.dim, cfg.n_heads * hd, **kw)
        self.wk = Dense(cfg.dim, cfg.n_kv_heads * hd, **kw)
        self.wv = Dense(cfg.dim, cfg.n_kv_heads * hd, **kw)
        self.wo = Dense(cfg.n_heads * hd, cfg.dim, **kw)

    def forward(self, x, positions):
        cfg = self.config
        b, s, _ = x.shape
        hd = cfg.head_dim
        # -1: the heads this process holds (all of them, or n/tp under a
        # tensor-parallel plan, which shards the projections by head).
        q = self.wq(x).reshape(b, s, -1, hd)
        k = self.wk(x).reshape(b, s, -1, hd)
        v = self.wv(x).reshape(b, s, -1, hd)

        q = _rope(q, positions, cfg.rope_theta)
        k = _rope(k, positions, cfg.rope_theta)

        # Transpose-free dispatch first: flash runs the projection-layout
        # kernels on q/k/v exactly as RoPE produced them ([B, S, H, D]).
        out = sp_attention_bshd(q, k, v, cfg.attention_impl, causal=True)
        if out is None:
            # [B, H, S, D] layout: flash-bhsd and the dense oracle.
            q, k, v = (t.transpose(1, 2) for t in (q, k, v))
            out = sp_attention(
                q, k, v, cfg.attention_impl, causal=True
            ).transpose(1, 2)
        return self.wo(out.reshape(b, s, -1))


class MLP(nn.Module):
    def __init__(self, config: LlamaConfig, device=None):
        super().__init__()
        self.config = config
        kw = dict(dtype=config.dtype, device=device)
        self.w_gate = Dense(config.dim, config.ffn_dim, **kw)
        self.w_up = Dense(config.dim, config.ffn_dim, **kw)
        self.w_down = Dense(config.ffn_dim, config.dim, **kw)

    def forward(self, x):
        return self.w_down(F.silu(self.w_gate(x)) * self.w_up(x))


class Block(nn.Module):
    def __init__(self, config: LlamaConfig, device=None):
        super().__init__()
        self.attn_norm = RMSNorm(config.dim, config.norm_eps, device)
        self.attn = Attention(config, device)
        self.mlp_norm = RMSNorm(config.dim, config.norm_eps, device)
        if config.is_moe:
            from .moe import MoEMLP

            self.moe = MoEMLP(
                config.dim, config.ffn_dim, config.n_experts,
                top_k=config.moe_top_k,
                capacity_factor=config.capacity_factor, dtype=config.dtype,
                device=device)
        else:
            self.mlp = MLP(config, device)

    def forward(self, x, positions):
        """Returns (x, aux): aux is the router load-balance loss of an MoE
        block, 0.0 for a dense one."""
        x = x + self.attn(self.attn_norm(x), positions)
        h = self.mlp_norm(x)
        if hasattr(self, "moe"):
            y, aux = self.moe(h)
            return x + y, aux
        return x + self.mlp(h), 0.0


class Llama(nn.Module):
    def __init__(self, config: LlamaConfig, device=None):
        super().__init__()
        if config.remat_policy != "full":
            raise NotImplementedError(
                f"remat_policy={config.remat_policy!r} is not ported yet "
                f"(ROADMAP.md queue (a) item 4); use 'full'"
            )
        self.config = config
        self.embed = nn.Embedding(config.vocab_size, config.dim, device=device)
        for i in range(config.n_layers):
            self.add_module(f"layer_{i}", Block(config, device))
        self.final_norm = RMSNorm(config.dim, config.norm_eps, device)
        if not config.tie_embeddings:
            self.lm_head = F32LogitsDense(config.dim, config.vocab_size, device)

    def blocks(self) -> list[Block]:
        return [getattr(self, f"layer_{i}") for i in range(self.config.n_layers)]

    def head_kernel(self) -> torch.Tensor:
        """The LM head as [D, V] (the JAX kernel layout; a free view)."""
        if self.config.tie_embeddings:
            return self.embed.weight.t()
        return self.lm_head.weight.t()

    def forward(self, tokens, return_hidden: bool = False,
                chunked_loss: bool = False, aux_coef: float = 0.0):
        """f32 logits; ``(logits, aux)`` for an MoE config, aux the blocks'
        summed router loss. ``return_hidden=True`` skips the LM head and
        returns the final hidden states (``(hidden, aux)`` for MoE).
        ``chunked_loss=True`` returns the next-token loss, plus
        ``aux_coef`` x aux for MoE, with the head and cross-entropy
        applied ``cfg.xent_chunk`` positions at a time (ops/losses.py),
        so full logits never materialize; it runs inside the forward,
        where a sharded root's parameters (the head) are gathered."""
        cfg = self.config
        tokens = tokens.long()
        positions = torch.arange(
            tokens.shape[1], device=tokens.device
        ).expand(tokens.shape)
        h = self.embed(tokens).to(cfg.dtype)
        remat = cfg.remat and torch.is_grad_enabled()
        aux = 0.0
        for block in self.blocks():
            if remat:
                h, a = checkpoint(block, h, positions, use_reentrant=False)
            else:
                h, a = block(h, positions)
            aux = aux + a
        h = self.final_norm(h)
        if return_hidden:
            return (h, aux) if cfg.is_moe else h
        if chunked_loss:
            ce = lm_xent_chunked(h[:, :-1], self.head_kernel(),
                                 tokens[:, 1:], chunk=cfg.xent_chunk)
            return ce + aux_coef * aux if cfg.is_moe and aux_coef else ce
        # Untied head (Llama-3 does not tie embeddings); f32 logits.
        logits = f32_logits(h, self.head_kernel())
        return (logits, aux) if cfg.is_moe else logits


@torch.no_grad()
def init_params(model: Llama, generator: torch.Generator) -> Llama:
    """Initialize ``model`` in place from Flax's default distributions:
    ``nn.Dense``'s lecun-normal (truncated at two standard deviations,
    std 1/sqrt(fan_in)), ``nn.Embed``'s normal(std 1/sqrt(dim)) and ones
    for RMSNorm. ``generator`` (seeded from --seed, on the parameters'
    device) makes it reproducible; its numbers differ from jax.random's."""
    for name, p in model.named_parameters():
        if name.endswith("scale"):
            p.fill_(1.0)
        elif name == "embed.weight":
            p.normal_(0.0, p.shape[1] ** -0.5, generator=generator)
        else:
            # [out, in] kernels: fan_in = in; MoE, in the Flax layout:
            # router [in, E], experts [E, in, out] (batch axis 0).
            fan_in = p.shape[0] if name.endswith("router") else p.shape[1]
            # 0.8796...: the std of a unit normal truncated to [-2, 2].
            std = fan_in ** -0.5 / 0.87962566103423978
            nn.init.trunc_normal_(p, 0.0, std, -2 * std, 2 * std,
                                  generator=generator)
    return model


def loss_fn(model: Llama, tokens, include_aux: bool = True):
    """Next-token cross-entropy (+ ``router_aux_coef`` x the router aux
    loss for MoE configs). The full sequence goes through the model; the
    shift happens on the logits.

    ``include_aux=False`` returns the pure CE: evaluation (cmd.eval) does
    not fold the load-balance regularizer into its number.

    With ``cfg.xent_chunk > 0`` the head + CE run chunked
    (ops/losses.py:lm_xent_chunked): same mean, but the [B, S, V] f32
    logits never materialize."""
    cfg = model.config
    tokens = tokens.long()
    aux_coef = cfg.router_aux_coef if include_aux else 0.0
    if cfg.xent_chunk > 0:
        return model(tokens, chunked_loss=True, aux_coef=aux_coef)
    logits, aux = model(tokens) if cfg.is_moe else (model(tokens), 0.0)
    ce = F.cross_entropy(
        logits[:, :-1].reshape(-1, cfg.vocab_size), tokens[:, 1:].reshape(-1)
    )
    return ce + aux_coef * aux if cfg.is_moe and aux_coef else ce


def make_train_step(model: Llama, optimizer, accum_steps: int = 1,
                    lr_schedule=None):
    """``step(tokens) -> loss``: one optimizer update. ``accum_steps > 1``
    averages gradients over that many sequential microbatches (split on
    the batch dim) first -- see ``parallel.accum``."""
    from ..parallel.accum import make_update_step

    return make_update_step(
        lambda toks: loss_fn(model, toks), optimizer, accum_steps,
        lr_schedule=lr_schedule,
    )


def tensor_parallel_plan(model: Llama, tp: int) -> dict:
    """Megatron tensor parallelism over ``tp`` ranks, the JAX package's
    ``param_sharding_rules`` (models/llama.py:446) on DTensor:
    column-parallel q/k/v, gate and up (output features, so heads and ffn
    width, split over tp), row-parallel wo and down (their products
    summed across tp). Attention runs on the local heads and the MLP on
    the local ffn width. The embedding and the LM head stay whole on
    every tp rank (JAX splits the vocab over tp): same result, the head
    replicated instead of sharded."""
    from torch.distributed.tensor.parallel import (
        ColwiseParallel,
        RowwiseParallel,
    )

    cfg = model.config
    if cfg.is_moe:
        raise SystemExit(
            f"--mesh tp={tp} with an MoE model is not ported yet (ROADMAP.md "
            f"queue (a) item 13)")
    if cfg.n_kv_heads % tp or cfg.n_heads % tp or cfg.ffn_dim % tp:
        raise SystemExit(
            f"--mesh tp={tp} must divide n_kv_heads={cfg.n_kv_heads}, "
            f"n_heads={cfg.n_heads} and ffn_dim={cfg.ffn_dim}")
    plan = {}
    for i in range(cfg.n_layers):
        for name in ("attn.wq", "attn.wk", "attn.wv", "mlp.w_gate",
                     "mlp.w_up"):
            plan[f"layer_{i}.{name}"] = ColwiseParallel()
        for name in ("attn.wo", "mlp.w_down"):
            plan[f"layer_{i}.{name}"] = RowwiseParallel()
    return plan
