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

The JAX model's two TPU-shaped options keep its layouts:

- ``space_to_depth``: the images regrouped into 2x2 pixel blocks
  (:func:`space_to_depth`, channels in JAX's ``(dy, dx, c)`` order), then
  a 4x4 stride-1 ``conv_init`` padded (2, 1) on each spatial axis. Any
  7x7 stride-2 stem maps onto it exactly (:func:`s2d_stem_kernel` in
  JAX's layout, :func:`s2d_stem_weight` in the port's); the extra taps
  multiply zeros, so :func:`flops_per_image` stays the plain model's;
- ``scan_stages``: each stage's blocks after the first under
  ``stage{i}_rest.{BasicBlock_0|BottleneckBlock_0}``, every parameter
  and BN buffer stacked with a leading ``[n_rest]`` dimension, as
  ``nn.scan`` stacks them (:class:`ScannedBlocks`). In eager PyTorch it
  is a layout, not a compile-time device: a scanned JAX checkpoint loads
  as is, and :func:`stack_stages` / :func:`unstack_stages` move a state
  dict between it and the plain one.
"""

from __future__ import annotations

import math
import re
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call

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


def _stacked(t: torch.Tensor, n: int) -> torch.Tensor:
    """``t`` repeated along a new leading [n] dimension; a conv kernel's
    slices keep its channels_last layout."""
    if t.dim() == 4:
        o, i, kh, kw = t.shape
        out = t.new_empty(n, o, kh, kw, i).permute(0, 1, 4, 2, 3)
    else:
        out = t.new_empty(n, *t.shape)
    return out.copy_(t.expand_as(out))


class ScannedBlocks(nn.Module):
    """A stage's repeated blocks in the JAX model's ``scan_stages`` layout:
    one template block under Flax's name for it (``BasicBlock_0`` or
    ``BottleneckBlock_0``), each of whose parameters and BN buffers is
    stacked with a leading [n] dimension. The forward applies the
    template to the k-th slices for k in order
    (``torch.func.functional_call``): each slice's gradient lands in its
    stacked parameter, and each BN's in-place running-statistics update
    writes through the slice, a view of the stacked buffer. The stacked
    kernels are 5-D, which ``Module.to(memory_format=...)`` refuses: build
    the model on its device instead (its kernels' slices are already
    channels_last)."""

    def __init__(self, block: nn.Module, n: int):
        super().__init__()
        self.n = n
        self.inner = f"{type(block).__name__}_0"
        with torch.no_grad():
            for mod in block.modules():
                for name, p in list(mod.named_parameters(recurse=False)):
                    setattr(mod, name, nn.Parameter(_stacked(p, n)))
                for name, b in list(mod.named_buffers(recurse=False)):
                    mod.register_buffer(name, _stacked(b, n))
        self.add_module(self.inner, block)

    def forward(self, x):
        block = getattr(self, self.inner)
        tensors = {**dict(block.named_parameters()),
                   **dict(block.named_buffers())}
        # One unbind a tensor: its backward stacks the n slices' gradients
        # once, where n selects would each add a whole-size zero tensor.
        slices = {name: t.unbind(0) for name, t in tensors.items()}
        for k in range(self.n):
            x = functional_call(
                block, {name: s[k] for name, s in slices.items()}, (x,))
        return x


def space_to_depth(x: torch.Tensor) -> torch.Tensor:
    """``[N, C, H, W]`` images as ``[N, 4C, H/2, W/2]`` 2x2 pixel blocks,
    channel ``(dy, dx, c)`` as the JAX model regroups NHWC
    (``reshape(b, h/2, 2, w/2, 2, c).transpose(0, 1, 3, 2, 4, 5)``), here
    on the channels-last view, so the result is channels_last memory."""
    b, c, h, w = x.shape
    if h % 2 or w % 2:
        raise ValueError(
            f"space_to_depth stem needs even spatial dims, got {h}x{w}; "
            f"pad the input or use space_to_depth=False")
    x = x.permute(0, 2, 3, 1).reshape(b, h // 2, 2, w // 2, 2, c)
    x = x.permute(0, 1, 3, 2, 4, 5).reshape(b, h // 2, w // 2, 4 * c)
    return x.permute(0, 3, 1, 2)


def s2d_stem_kernel(k7):
    """Map a [7, 7, C, O] stem kernel (Flax's layout) onto the
    space_to_depth [4, 4, 4C, O] layout, exactly: embed into 8x8 with a
    leading zero row/col (the kernel tap at original offset -4, which the
    7x7 never reads), then regroup rows/cols into (tap, subpixel) pairs
    matching the s2d input channel order (dy, dx, c). numpy in and out,
    as the JAX package's own."""
    k7 = np.asarray(k7)
    c, o = k7.shape[2], k7.shape[3]
    k8 = np.zeros((8, 8, c, o), k7.dtype)
    k8[1:, 1:] = k7
    return (
        k8.reshape(4, 2, 4, 2, c, o)
        .transpose(0, 2, 1, 3, 4, 5)
        .reshape(4, 4, 4 * c, o)
    )


def s2d_stem_weight(w7: torch.Tensor) -> torch.Tensor:
    """:func:`s2d_stem_kernel` in the port's layout: the plain model's
    ``conv_init.weight`` [O, C, 7, 7] as the space_to_depth model's
    [O, 4C, 4, 4], channel ``(dy, dx, c)``, channels_last."""
    o, c = w7.shape[:2]
    k8 = w7.new_zeros(o, c, 8, 8)
    k8[:, :, 1:, 1:] = w7
    k4 = k8.reshape(o, c, 4, 2, 4, 2).permute(0, 3, 5, 1, 2, 4)
    return k4.reshape(o, 4 * c, 4, 4).contiguous(
        memory_format=torch.channels_last)


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
        min_elems = (bn_lib.PALLAS_MIN_ELEMS if bn_pallas_min_elems is None
                     else bn_pallas_min_elems)
        norm = _norm_factory(bn_impl, dtype, device, min_elems)
        self.dtype = dtype
        self.bn_impl = bn_impl
        self.space_to_depth = space_to_depth
        if space_to_depth:
            # Padded (2, 1) in forward: the 4x4 taps sit at the original
            # offsets -4..+3 around each output's 2x2 block.
            self.conv_init = Conv(12, num_filters, 4, 1, padding=0,
                                  dtype=dtype, device=device)
        else:
            self.conv_init = Conv(3, num_filters, 7, 2, padding=3,
                                  dtype=dtype, device=device)
        self.bn_init = norm(num_filters)
        block = BottleneckBlock if bottleneck else BasicBlock
        in_ch = num_filters
        self.block_names = []
        for i, count in enumerate(stage_sizes):
            for j in range(count):
                mod = block(in_ch, num_filters * 2**i,
                            2 if i > 0 and j == 0 else 1, norm, dtype, device)
                in_ch = mod.out_ch
                name = f"stage{i}_block{j}"
                scan = scan_stages and j == 1
                if scan:  # blocks 1.. of the stage, stacked
                    name, mod = f"stage{i}_rest", ScannedBlocks(mod, count - 1)
                self.add_module(name, mod)
                self.block_names.append(name)
                if scan:
                    break
        self.head = nn.Linear(in_ch, num_classes, device=device)

    def forward(self, x):
        x = x.to(self.dtype)
        if self.space_to_depth:
            x = F.pad(space_to_depth(x), (2, 1, 2, 1))
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


_BLOCK_KEY = re.compile(r"^stage(\d+)_block(\d+)\.(.+)$")
_REST_KEY = re.compile(r"^stage(\d+)_rest\.(\w+_0)\.(.+)$")
_THIRD_LAYER = re.compile(r"\.(Conv|BatchNorm)_2\.")


def stack_stages(state: dict) -> dict:
    """A plain model's state dict (or any name -> tensor map of its names:
    gradients, the running statistics alone) in the ``scan_stages``
    layout, exactly: each stage's blocks 1.. stacked in order into
    ``stage{i}_rest.{BasicBlock_0|BottleneckBlock_0}.*`` (the JAX model's
    ``nn.scan`` names), every other entry as it is. A block with a third
    conv or norm is a bottleneck block."""
    inner = ("BottleneckBlock_0"
             if any(_THIRD_LAYER.search(k) for k in state)
             else "BasicBlock_0")
    count: dict = {}
    for key in state:
        if m := _BLOCK_KEY.match(key):
            i, j = int(m[1]), int(m[2])
            count[i] = max(count.get(i, 0), j + 1)
    out = {}
    for key, t in state.items():
        m = _BLOCK_KEY.match(key)
        if m is None or m[2] == "0":
            out[key] = t
        elif m[2] == "1":
            i, leaf = int(m[1]), m[3]
            out[f"stage{i}_rest.{inner}.{leaf}"] = torch.stack(
                [state[f"stage{i}_block{j}.{leaf}"]
                 for j in range(1, count[i])])
    return out


def unstack_stages(state: dict) -> dict:
    """Invert :func:`stack_stages`: each ``stage{i}_rest.*`` slice k back
    into ``stage{i}_block{k+1}.*``, exactly, blocks in order."""
    rest: dict = {}
    for key, t in state.items():
        if m := _REST_KEY.match(key):
            rest.setdefault(int(m[1]), {})[m[3]] = t
    out = {}
    for key, t in state.items():
        m = _REST_KEY.match(key)
        if m is None:
            out[key] = t
        elif int(m[1]) in rest:
            i = int(m[1])
            leaves = rest.pop(i)
            n = next(iter(leaves.values())).shape[0]
            for k in range(n):
                for leaf, stacked in leaves.items():
                    out[f"stage{i}_block{k + 1}.{leaf}"] = stacked[k].clone()
    return out


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
            # A kernel's [in, kh, kw] (each slice's, when stacked).
            fan_in = (math.prod(w.shape[-3:]) if isinstance(mod, Conv)
                      else w.shape[1])
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


def tensor_parallel_plan(model: ResNet, tp: int) -> dict:
    """The replicated layout over ``tp`` ranks: an empty plan. The JAX
    package has no rule for ResNet (``mpi_operator_tpu/cmd/train.py``
    shards its params with the default rules), so GSPMD replicates its
    parameters and work over tp: each tp rank computes its dp x fsdp
    coordinate's whole batch, and no sum runs across tp. The BN moments
    of the ``xla`` route, summed over the world, count each tp rank's
    rows and its element count alike."""
    return {}
