"""Vision Transformer (ViT) in PyTorch (port of
``mpi_operator_tpu/models/vit.py``): image classification on the
transformer stack, bfloat16 compute with float32 parameters.

- patchify is a reshape of the NHWC images ([B, H/p, p, W/p, p, C] ->
  [B, N, p*p*C], the JAX order) followed by the biased ``embed`` Dense,
  not a convolution, so a carried-over ``embed`` kernel means the same;
- a zero-initialised CLS token is prepended and ``pos_embed`` [1, N+1,
  dim] added;
- pre-LN blocks with biased ``Dense`` layers (``wq``/``wk``/``wv``/``wo``,
  ``ffn_in``/``ffn_out``), Flax's f32-statistics ``LayerNorm`` and
  tanh-approximated GELU (``models/llama.py``'s ``Dense``,
  ``models/bert.py``'s ``LayerNorm``);
- attention through the flat flash kernels (``flash``) or the dense
  oracle (``dense``);
- the head reads the CLS token through the bf16 x bf16 -> f32 head
  product (``ops/losses.py``); ``head`` is stored [dim, classes], as in
  JAX.

Module and parameter names follow the Flax tree (``embed``, ``cls``,
``pos_embed``, ``layer_{i}.attn_norm``, ``wq``, ..., ``mlp_norm``,
``final_norm``, ``head``), so ``interop`` carries weights across leaf by
leaf. The TPU tile knobs ``flash_block_q/k`` are not carried over.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import attention_reference, flash_attention_bshd
from ..ops.losses import f32_logits
# The tensor-parallel plan is BERT's: the JAX package's ViT rules
# (models/vit.py:219) split the same encoder layers, named alike
# (``layer_{i}.wq`` ...), and the embed, cls, pos_embed and head stay whole.
from .bert import LayerNorm, flax_default_init, tensor_parallel_plan  # noqa: F401
from .llama import Dense, checkpointed, remat_policy_for


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    image_size: int = 224
    patch_size: int = 16
    num_classes: int = 1000
    dim: int = 768
    n_layers: int = 12
    n_heads: int = 12
    ffn_dim: int = 3072
    norm_eps: float = 1e-6
    dtype: Any = torch.bfloat16
    # 'flash' (the flat CUDA kernels; plain versions on the CPU) or
    # 'dense' (the oracle).
    attention_impl: str = "flash"
    # Per-layer activation checkpointing; 'full' recomputes each layer
    # in the backward pass, 'dots' keeps its matmul outputs and flash
    # residuals (llama.remat_policy_for).
    remat: bool = False
    remat_policy: str = "dots"

    @property
    def n_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_heads


def vit_base(**overrides) -> ViTConfig:
    """ViT-B/16 (86M params)."""
    return dataclasses.replace(ViTConfig(), **overrides)


def tiny(**overrides) -> ViTConfig:
    base = ViTConfig(
        image_size=32, patch_size=8, num_classes=16, dim=32, n_layers=2,
        n_heads=2, ffn_dim=64, dtype=torch.float32, attention_impl="dense",
    )
    return dataclasses.replace(base, **overrides)


CONFIGS = {"vit-base": vit_base, "vit-tiny": tiny}


class EncoderBlock(nn.Module):
    def __init__(self, config: ViTConfig, device=None):
        super().__init__()
        cfg = self.config = config
        self.attn_norm = LayerNorm(cfg.dim, cfg.norm_eps, cfg.dtype, device)
        for name, n_in, n_out in (
            ("wq", cfg.dim, cfg.dim), ("wk", cfg.dim, cfg.dim),
            ("wv", cfg.dim, cfg.dim), ("wo", cfg.dim, cfg.dim),
        ):
            self.add_module(name, Dense(n_in, n_out, dtype=cfg.dtype,
                                        bias=True, device=device))
        self.mlp_norm = LayerNorm(cfg.dim, cfg.norm_eps, cfg.dtype, device)
        self.ffn_in = Dense(cfg.dim, cfg.ffn_dim, dtype=cfg.dtype, bias=True,
                            device=device)
        self.ffn_out = Dense(cfg.ffn_dim, cfg.dim, dtype=cfg.dtype, bias=True,
                             device=device)

    def forward(self, x):
        cfg = self.config
        b, s, _ = x.shape
        # -1: the heads this process holds (all of them, or n/tp under a
        # tensor-parallel plan, which shards the projections by head).
        shape = (b, s, -1, cfg.head_dim)
        h = self.attn_norm(x)
        q = self.wq(h).reshape(shape)
        k = self.wk(h).reshape(shape)
        v = self.wv(h).reshape(shape)
        if cfg.attention_impl == "flash":
            att = flash_attention_bshd(q, k, v, causal=False)
        elif cfg.attention_impl == "dense":
            att = attention_reference(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                causal=False).transpose(1, 2)
        else:
            raise ValueError(
                f"vit attention_impl must be 'flash' or 'dense', got "
                f"{cfg.attention_impl!r}"
            )
        x = x + self.wo(att.reshape(b, s, -1))
        h = F.gelu(self.ffn_in(self.mlp_norm(x)), approximate="tanh")
        return x + self.ffn_out(h)


class ViT(nn.Module):
    def __init__(self, config: ViTConfig, device=None):
        super().__init__()
        if config.remat:
            remat_policy_for(config.remat_policy)  # refuses an unknown one
        cfg = self.config = config
        p = cfg.patch_size
        self.embed = Dense(p * p * 3, cfg.dim, dtype=cfg.dtype, bias=True,
                           device=device)
        self.cls = nn.Parameter(
            torch.zeros(1, 1, cfg.dim, dtype=torch.float32, device=device))
        self.pos_embed = nn.Parameter(
            torch.zeros(1, cfg.n_patches + 1, cfg.dim, dtype=torch.float32,
                        device=device))
        for i in range(cfg.n_layers):
            self.add_module(f"layer_{i}", EncoderBlock(cfg, device))
        self.final_norm = LayerNorm(cfg.dim, cfg.norm_eps, cfg.dtype, device)
        self.head = nn.Parameter(
            torch.zeros(cfg.dim, cfg.num_classes, dtype=torch.float32,
                        device=device))

    def layers(self) -> list[EncoderBlock]:
        return [getattr(self, f"layer_{i}") for i in range(self.config.n_layers)]

    def forward(self, images):
        """images [B, H, W, C] (NHWC, as in JAX) -> logits [B, classes],
        f32."""
        cfg = self.config
        b, hh, ww, c = images.shape
        p = cfg.patch_size
        if hh % p or ww % p:
            raise ValueError(
                f"image {hh}x{ww} not divisible by patch size {p}"
            )
        patches = images.to(cfg.dtype).reshape(
            b, hh // p, p, ww // p, p, c
        ).permute(0, 1, 3, 2, 4, 5).reshape(b, -1, p * p * c)
        x = self.embed(patches)
        cls = self.cls.to(cfg.dtype).expand(b, 1, cfg.dim)
        x = torch.cat([cls, x], dim=1) + self.pos_embed.to(cfg.dtype)
        remat = cfg.remat and torch.is_grad_enabled()
        for layer in self.layers():
            x = (checkpointed(layer, x, policy=cfg.remat_policy) if remat
                 else layer(x))
        x = self.final_norm(x)
        # Classification from the CLS token, f32 logits.
        return f32_logits(x[:, 0], self.head)


@torch.no_grad()
def init_params(model: ViT, generator: torch.Generator) -> ViT:
    """Initialize ``model`` in place from the Flax model's initializers:
    Flax's defaults for the Dense and LayerNorm layers
    (``models/bert.py:flax_default_init``), then ``cls`` zeros and
    ``pos_embed`` and ``head`` normal(std 0.02). ``generator`` (seeded,
    on the parameters' device) makes it reproducible; its numbers differ
    from jax.random's."""
    flax_default_init(model, generator)
    model.cls.zero_()
    model.pos_embed.normal_(0.0, 0.02, generator=generator)
    model.head.normal_(0.0, 0.02, generator=generator)
    return model


def loss_fn(model: ViT, images, labels):
    """Mean softmax cross-entropy of the class logits."""
    return F.cross_entropy(model(images), labels.long())


def make_train_step(model: ViT, optimizer, accum_steps: int = 1,
                    lr_schedule=None):
    """``step(images, labels) -> loss``: one optimizer update;
    ``accum_steps > 1`` averages gradients over that many sequential
    microbatches -- see ``parallel.accum``."""
    from ..parallel.accum import make_update_step

    return make_update_step(
        lambda im, lb: loss_fn(model, im, lb), optimizer, accum_steps,
        lr_schedule=lr_schedule,
    )


def flops_per_image(cfg: ViTConfig) -> float:
    """Forward FLOPs per image (2 x MAC convention, matmul params only,
    as the JAX version counts them): the patch embed, each layer's
    qkv/o/ffn, attention's 4*N*d per token, and the head."""
    n = cfg.n_patches + 1
    per_token_params = (
        cfg.patch_size ** 2 * 3 * cfg.dim
        + cfg.n_layers * (4 * cfg.dim ** 2 + 2 * cfg.dim * cfg.ffn_dim)
    )
    attn = cfg.n_layers * 4 * n * n * cfg.dim
    return 2.0 * per_token_params * n + attn + 2.0 * cfg.dim * cfg.num_classes

