"""ResNet v1.5 in PyTorch (port of ``mpi_operator_tpu/models/resnet.py``):
the trainer's default model and the reference project's headline
benchmark (ResNet-101 on synthetic ImageNet).

- bfloat16 compute (convolution inputs and kernels cast to bf16, as
  Flax's ``dtype=bf16``), float32 parameters and batch statistics, f32
  logits for the loss;
- ``[N, C, H, W]`` tensors in ``torch.channels_last`` memory (activations
  and conv kernels), so each BN layer's ``[M, C]`` operand is a view;
- Flax's ``padding="SAME"`` exactly: a stride-2 3×3 conv pads (0, 1), the
  extra row and column at the end, where PyTorch's symmetric
  ``padding=1`` would shift the result;
- BN through ``ops/bn.py``: ``bn_impl="pallas"`` runs the hand-written
  stats and grads kernels (:class:`~..ops.bn.TpuBatchNorm`), ``"xla"``
  the same Flax semantics in plain ops (:class:`~..ops.bn.BatchNorm`).

Module names follow the Flax tree (``conv_init``, ``bn_init``,
``stage{i}_block{j}.Conv_k``, ``conv_proj``, ``norm_proj``, ``head``);
each block's norms are ``BatchNorm_k`` on both routes (Flax names them
``TpuBatchNorm_k`` under ``"pallas"``; ``interop`` takes both).
``space_to_depth`` and ``scan_stages`` are later slices of the port.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import bn as bn_lib

# Stage layouts per depth.
STAGE_SIZES = {
    18: (2, 2, 2, 2),
    34: (3, 4, 6, 3),
    50: (3, 4, 6, 3),
    101: (3, 4, 23, 3),
    152: (3, 8, 36, 3),
}
BOTTLENECK = {18: False, 34: False, 50: True, 101: True, 152: True}


def _same_pads(size: int, k: int, stride: int) -> tuple[int, int]:
    """Flax/XLA ``SAME`` padding of one spatial axis: the output has
    ceil(size / stride) positions and the odd pad goes at the end."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


class Conv(nn.Module):
    """``nn.Conv(use_bias=False, dtype=compute, param_dtype=f32)``: a f32
    ``weight [out, in, kh, kw]`` (Flax ``kernel [kh, kw, in, out]``),
    operands cast to the compute type, ``SAME`` padding unless
    ``padding`` is given."""

    def __init__(self, in_ch: int, out_ch: int, k: int, stride: int = 1,
                 padding: Optional[int] = None, dtype=torch.bfloat16,
                 device=None):
        super().__init__()
        self.stride, self.padding, self.dtype = stride, padding, dtype
        self.weight = nn.Parameter(torch.empty(
            out_ch, in_ch, k, k, dtype=torch.float32, device=device
        ).to(memory_format=torch.channels_last))

    def forward(self, x):
        x = x.to(self.dtype)
        w = self.weight.to(self.dtype)
        if self.padding is not None:
            return F.conv2d(x, w, stride=self.stride, padding=self.padding)
        k = w.shape[-1]
        (top, bottom), (left, right) = (
            _same_pads(n, k, self.stride) for n in x.shape[2:])
        if top == bottom and left == right:
            return F.conv2d(x, w, stride=self.stride, padding=(top, left))
        x = F.pad(x, (left, right, top, bottom))
        return F.conv2d(x, w, stride=self.stride)


def _norm_factory(bn_impl: str, dtype, device, pallas_min_elems: int):
    if bn_impl == "pallas":
        def make(c, scale_init=1.0):
            return bn_lib.TpuBatchNorm(
                c, momentum=0.9, epsilon=1e-5, dtype=dtype,
                scale_init=scale_init, device=device,
                pallas_min_elems=pallas_min_elems)
    elif bn_impl == "xla":
        def make(c, scale_init=1.0):
            return bn_lib.BatchNorm(
                c, momentum=0.9, epsilon=1e-5, dtype=dtype,
                scale_init=scale_init, device=device)
    else:
        raise ValueError(f"unknown bn_impl {bn_impl!r}")
    return make


class BottleneckBlock(nn.Module):
    """1×1 → 3×3 (carries the stride, v1.5) → 1×1 ×4, with a projection
    shortcut when the shape changes; the last BN's scale starts at 0."""

    def __init__(self, in_ch: int, filters: int, strides: int, norm,
                 dtype, device=None):
        super().__init__()
        out_ch = filters * 4
        self.Conv_0 = Conv(in_ch, filters, 1, dtype=dtype, device=device)
        self.BatchNorm_0 = norm(filters)
        self.Conv_1 = Conv(filters, filters, 3, strides, dtype=dtype,
                           device=device)
        self.BatchNorm_1 = norm(filters)
        self.Conv_2 = Conv(filters, out_ch, 1, dtype=dtype, device=device)
        self.BatchNorm_2 = norm(out_ch, scale_init=0.0)
        if strides != 1 or in_ch != out_ch:
            self.conv_proj = Conv(in_ch, out_ch, 1, strides, dtype=dtype,
                                  device=device)
            self.norm_proj = norm(out_ch)
        self.out_ch = out_ch

    def forward(self, x):
        y = F.relu(self.BatchNorm_0(self.Conv_0(x)))
        y = F.relu(self.BatchNorm_1(self.Conv_1(y)))
        y = self.BatchNorm_2(self.Conv_2(y))
        residual = x
        if hasattr(self, "conv_proj"):
            residual = self.norm_proj(self.conv_proj(x))
        return F.relu(residual + y)


class BasicBlock(nn.Module):
    """3×3 (carries the stride) → 3×3, with a projection shortcut when the
    shape changes; the last BN's scale starts at 0."""

    def __init__(self, in_ch: int, filters: int, strides: int, norm,
                 dtype, device=None):
        super().__init__()
        self.Conv_0 = Conv(in_ch, filters, 3, strides, dtype=dtype,
                           device=device)
        self.BatchNorm_0 = norm(filters)
        self.Conv_1 = Conv(filters, filters, 3, dtype=dtype, device=device)
        self.BatchNorm_1 = norm(filters, scale_init=0.0)
        if strides != 1 or in_ch != filters:
            self.conv_proj = Conv(in_ch, filters, 1, strides, dtype=dtype,
                                  device=device)
            self.norm_proj = norm(filters)
        self.out_ch = filters

    def forward(self, x):
        y = F.relu(self.BatchNorm_0(self.Conv_0(x)))
        y = self.BatchNorm_1(self.Conv_1(y))
        residual = x
        if hasattr(self, "conv_proj"):
            residual = self.norm_proj(self.conv_proj(x))
        return F.relu(residual + y)


class ResNet(nn.Module):
    """ResNet v1.5 over ``[N, 3, H, W]`` images (f32 in, f32 logits out).
    ``.train()`` normalizes with batch moments and updates the running
    statistics; ``.eval()`` uses the running statistics."""

    def __init__(self, stage_sizes: Sequence[int], bottleneck: bool = True,
                 num_classes: int = 1000, num_filters: int = 64,
                 dtype=torch.bfloat16, space_to_depth: bool = False,
                 bn_impl: str = "xla", scan_stages: bool = False,
                 bn_pallas_min_elems: Optional[int] = None, device=None):
        super().__init__()
        if space_to_depth:
            raise NotImplementedError(
                "space_to_depth=True is not ported (ROADMAP.md queue (a) "
                "item 18): the 2x2 regrouped stem exists for the TPU MXU's "
                "contraction depth")
        if scan_stages:
            raise NotImplementedError(
                "scan_stages=True is not ported (ROADMAP.md queue (a) item "
                "18): scanning a stage's blocks exists for XLA compile time")
        min_elems = (bn_lib.PALLAS_MIN_ELEMS if bn_pallas_min_elems is None
                     else bn_pallas_min_elems)
        norm = _norm_factory(bn_impl, dtype, device, min_elems)
        self.dtype = dtype
        self.bn_impl = bn_impl
        self.conv_init = Conv(3, num_filters, 7, 2, padding=3, dtype=dtype,
                              device=device)
        self.bn_init = norm(num_filters)
        block = BottleneckBlock if bottleneck else BasicBlock
        in_ch = num_filters
        self.block_names = []
        for i, count in enumerate(stage_sizes):
            for j in range(count):
                name = f"stage{i}_block{j}"
                mod = block(in_ch, num_filters * 2**i,
                            2 if i > 0 and j == 0 else 1, norm, dtype, device)
                self.add_module(name, mod)
                self.block_names.append(name)
                in_ch = mod.out_ch
        self.head = nn.Linear(in_ch, num_classes, device=device)

    def forward(self, x):
        x = x.to(self.dtype)
        x = F.relu(self.bn_init(self.conv_init(x)))
        # -inf padding, as Flax's max_pool pads.
        x = F.max_pool2d(x, 3, stride=2, padding=1)
        for name in self.block_names:
            x = getattr(self, name)(x)
        x = x.mean(dim=(2, 3))
        w, b = self.head.weight, self.head.bias
        return F.linear(x, w.to(self.dtype), b.to(self.dtype)).float()


def resnet(depth: int, num_classes: int = 1000, dtype=torch.bfloat16,
           space_to_depth: bool = False, bn_impl: str = "xla",
           scan_stages: bool = False,
           bn_pallas_min_elems: Optional[int] = None,
           device=None) -> ResNet:
    return ResNet(
        stage_sizes=STAGE_SIZES[depth], bottleneck=BOTTLENECK[depth],
        num_classes=num_classes, dtype=dtype, space_to_depth=space_to_depth,
        bn_impl=bn_impl, scan_stages=scan_stages,
        bn_pallas_min_elems=bn_pallas_min_elems, device=device,
    )


def resnet50(**kw) -> ResNet:
    return resnet(50, **kw)


def resnet101(**kw) -> ResNet:
    return resnet(101, **kw)


def flops_per_image(depth: int, image_size: int = 224) -> float:
    """Forward FLOPs/image at 224x224 in the 2xMAC convention (the one
    peak-FLOP/s specs use, so FLOP/s / peak = MFU). The commonly quoted
    "ResNet-101 = 7.8 GFLOPs" is GMACs; x2 gives these (torchvision /
    ptflops figures). Scales quadratically in resolution."""
    base = {18: 3.6e9, 34: 7.3e9, 50: 8.2e9, 101: 15.7e9, 152: 23.1e9}[depth]
    return base * (image_size / 224) ** 2


def bn_layers(model: ResNet) -> list[nn.Module]:
    """Every BN module of ``model``, in forward order."""
    return [m for m in model.modules()
            if isinstance(m, bn_lib._BatchNormBase)]


@torch.no_grad()
def init_params(model: ResNet, generator: torch.Generator) -> ResNet:
    """Initialize ``model`` in place from Flax's default distributions:
    ``nn.Conv`` and ``nn.Dense`` kernels lecun-normal (truncated at two
    standard deviations, std 1/sqrt(fan_in)/0.8796, fan_in = kh·kw·in),
    Dense bias zeros, BN scale ones (zeros on each block's last BN), bias
    zeros, running mean zeros and var ones. ``generator`` (on the
    parameters' device) makes it reproducible; its numbers differ from
    jax.random's."""
    for mod in model.modules():
        if isinstance(mod, bn_lib._BatchNormBase):
            mod.reset_parameters()
        elif isinstance(mod, (Conv, nn.Linear)):
            w = mod.weight
            fan_in = w[0].numel()
            # 0.8796...: the std of a unit normal truncated to [-2, 2].
            std = fan_in ** -0.5 / 0.87962566103423978
            nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std,
                                  generator=generator)
            if getattr(mod, "bias", None) is not None:
                mod.bias.zero_()
    return model


def loss_fn(model: ResNet, images, labels):
    """Mean one-hot cross-entropy over f32 logits."""
    return F.cross_entropy(model(images), labels.long())


def make_train_step(model: ResNet, optimizer, lr_schedule=None):
    """``step(images, labels) -> loss``: one optimizer update of the
    parameters; the forward pass updates the running statistics (the
    model must be in ``.train()`` mode)."""
    from ..parallel.accum import make_update_step

    return make_update_step(
        lambda images, labels: loss_fn(model, images, labels), optimizer,
        lr_schedule=lr_schedule,
    )
