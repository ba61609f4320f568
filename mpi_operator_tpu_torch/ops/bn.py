"""Training batch norm through two hand-written reduction kernels (port of
``mpi_operator_tpu/ops/bn.py``).

The Pallas kernels ``_stats_kernel`` and ``_grads_kernel`` become the
CUDA kernels in ``csrc/bn_stats.cu`` and ``csrc/bn_grads.cu``: per
channel ``(Σx, Σx²)`` from one read of an ``[M, C]`` operand, and
``(Σdy, Σdy·x̂)`` from one read of ``(dy, x)``, both accumulated in f32.
Everything around them (mean and variance from the sums, the normalize,
the training-mode dx formula) is elementwise PyTorch, as the JAX package
leaves it to XLA.

Layout: the functions here take channels-last arrays ``[..., C]``, as the
JAX functions do. The modules take PyTorch's ``[N, C, H, W]``; run in
``torch.channels_last``, the ``[M, C]`` operand is then a view of the
activation and no BN layer copies it.

Every kernel has a plain PyTorch version beside it (``bn_stats_plain``,
``bn_grads_plain``), of the same signature. A wrapper takes the plain
version only for tensors on the CPU; for a CUDA tensor it launches the
kernel or raises. Each wrapper counts its launches in :data:`LAUNCHES`.

Two modules: :class:`TpuBatchNorm` (``bn_impl="pallas"``, the kernels;
the JAX name is kept so that a TPUJob's ``--bn-kernel pallas`` means the
same on both packages) and :class:`BatchNorm` (``bn_impl="xla"``: Flax
``nn.BatchNorm``'s semantics in plain ops, population variance
``E[x²] − E[x]²`` in f32, not ``nn.BatchNorm2d``'s unbiased running
variance). Both hold ``scale``, ``bias`` and the running ``mean``, ``var``
buffers, with Flax's momentum 0.9 and eps 1e-5.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from ..parallel.mesh import world_size
from ..parallel.sharding import all_reduce_sum
from . import _build
from ._common import bn_geometry

# Kernel launches since the last reset_launch_counts(), by C entry point.
# Incremented by the wrappers right after a launch succeeds, and nowhere
# else (the CPU's plain versions do not count).
LAUNCHES = {"bn_stats": 0, "bn_grads": 0}

_KERNEL_DTYPES = (torch.bfloat16, torch.float32)

# Layers below this many elements take plain-PyTorch reductions. The JAX
# package's 20,000,000 exists only because Mosaic compiles every
# pallas_call instance separately (~1 s each on the TPU). One nvcc build
# serves every shape here, so every BN layer goes through the kernels:
# ResNet-101 launches each kernel 104 times a training step. Kept as a
# parameter: the parity tests route both branches with it.
PALLAS_MIN_ELEMS = 0


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# ---------------------------------------------------------------------------
# Plain versions of the two kernels (CPU path; the card's yardstick)
# ---------------------------------------------------------------------------


def bn_stats_plain(x2d):
    """Plain version of the stats kernel: (Σx, Σx²) over the rows of an
    [M, C] array, in f32. Returns two f32 [C]."""
    xf = x2d.float()
    return xf.sum(0), (xf * xf).sum(0)


def bn_grads_plain(dy2d, x2d, mean, inv_std):
    """Plain version of the grads kernel: (Σdy, Σdy·x̂) with
    x̂ = (x − mean)·inv_std, in f32. Returns two f32 [C]."""
    dyf = dy2d.float()
    xhat = (x2d.float() - mean) * inv_std
    return dyf.sum(0), (dyf * xhat).sum(0)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------


def _check_rows(name: str, *tensors) -> torch.device:
    """[M, C] operands on one device; on CUDA of a kernel type and
    contiguous."""
    shape = tensors[0].shape
    for t in tensors:
        if t.ndim != 2 or t.shape != shape or t.shape[0] < 1:
            raise ValueError(
                f"{name} takes [M, C] operands of one shape with M >= 1; "
                f"got {[tuple(t.shape) for t in tensors]}"
            )
    if len({t.device for t in tensors}) != 1:
        raise ValueError(f"{name} operands must lie on one device")
    device = tensors[0].device
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {device}")
    if device.type == "cuda":
        for t in tensors:
            if t.dtype not in _KERNEL_DTYPES:
                raise TypeError(
                    f"{name} takes bfloat16 or float32 operands, got {t.dtype}"
                )
            if not t.is_contiguous():
                raise ValueError(
                    f"{name} takes contiguous [M, C] operands (C innermost); "
                    f"got strides {t.stride()}"
                )
    return device


def _channel_vector(name: str, v, c: int, device) -> torch.Tensor:
    if v.shape != (c,) or v.device != device:
        raise ValueError(
            f"{name}: per-channel operands must be [{c}] on {device}; got "
            f"{tuple(v.shape)} on {v.device}"
        )
    return v.float().contiguous()


def _launch(name: str, device, *args) -> None:
    fn = _build.kernel(name)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        _build.check(name, fn(*args, stream))
    LAUNCHES[name] += 1


def bn_stats(x2d):
    """Stats kernel: per-channel (Σx, Σx²) of an [M, C] array in ONE pass,
    f32 accumulation whatever the input type. Returns two f32 [C]."""
    device = _check_rows("bn_stats", x2d)
    if device.type == "cpu":
        return bn_stats_plain(x2d)
    m, c = x2d.shape
    vec, lanes, rows, chunks = bn_geometry(m, c, x2d.element_size(),
                                           (x2d.data_ptr(),))
    part = torch.empty(2, chunks, c, dtype=torch.float32, device=device)
    out = torch.empty(2, c, dtype=torch.float32, device=device)
    _launch("bn_stats", device, x2d.data_ptr(), part.data_ptr(),
            out.data_ptr(), m, c, vec, lanes, rows, chunks,
            int(x2d.dtype == torch.bfloat16))
    return out[0], out[1]


def bn_grads(dy2d, x2d, mean, inv_std):
    """Grads kernel: per-channel (dβ, dγ) = (Σdy, Σdy·x̂) from ONE fused
    pass over (dy, x). Returns two f32 [C]."""
    device = _check_rows("bn_grads", dy2d, x2d)
    c = x2d.shape[1]
    mean = _channel_vector("bn_grads", mean, c, device)
    inv_std = _channel_vector("bn_grads", inv_std, c, device)
    if device.type == "cpu":
        return bn_grads_plain(dy2d, x2d, mean, inv_std)
    m = x2d.shape[0]
    vec, lanes, rows, chunks = bn_geometry(
        m, c, max(dy2d.element_size(), x2d.element_size()),
        (dy2d.data_ptr(), x2d.data_ptr()))
    part = torch.empty(2, chunks, c, dtype=torch.float32, device=device)
    out = torch.empty(2, c, dtype=torch.float32, device=device)
    _launch("bn_grads", device, dy2d.data_ptr(), x2d.data_ptr(),
            mean.data_ptr(), inv_std.data_ptr(), part.data_ptr(),
            out.data_ptr(), m, c, vec, lanes, rows, chunks,
            int(dy2d.dtype == torch.bfloat16), int(x2d.dtype == torch.bfloat16))
    return out[0], out[1]


# ---------------------------------------------------------------------------
# Fused training batch norm (custom backward around the two kernels)
# ---------------------------------------------------------------------------


def _rows(x: torch.Tensor) -> torch.Tensor:
    """[..., C] -> the [M, C] operand: a view when x is contiguous (a
    channels_last activation permuted to [N, H, W, C] is), else a copy."""
    return x.reshape(-1, x.shape[-1]).contiguous()


def _at_least_f32(x: torch.Tensor) -> torch.Tensor:
    """x promoted to at least float32 (f64 stays f64), as Flax promotes
    BN's statistics and normalize."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def _normalize(x, mean, var, gamma, beta, eps):
    """The shared apply step both stats paths feed: at least f32 math,
    population variance already clamped at 0 by the caller, output in
    x.dtype. Returns (y, inv)."""
    inv = torch.rsqrt(var + eps)
    y = (_at_least_f32(x) - mean) * (inv * gamma) + beta
    return y.to(x.dtype), inv


class _FusedBatchNorm(torch.autograd.Function):
    """``fused_batch_norm``'s custom VJP (``_fbn_fwd`` / ``_fbn_bwd`` in
    JAX): the stats kernel forward, the grads kernel backward."""

    @staticmethod
    def forward(ctx, x, gamma, beta, eps):
        x2d = _rows(x)
        m = x2d.shape[0]
        s, q = bn_stats(x2d)
        mean = s / m
        # E[x²]−E[x]² (both moments from one read); clamp the catastrophic-
        # cancellation tail at 0 as the JAX package does.
        var = torch.clamp_min(q / m - mean * mean, 0.0)
        y, inv = _normalize(x, mean, var, gamma, beta, eps)
        ctx.save_for_backward(x, gamma, mean, inv)
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        x, gamma, mean, inv = ctx.saved_tensors
        x2d = _rows(x)
        m = x2d.shape[0]
        db, dg = bn_grads(_rows(dy), x2d, mean, inv)
        # Training-mode BN backward (mean and var differentiate through):
        # dx = γ·inv/M · (M·dy − dβ − x̂·dγ)
        xhat = (x.float() - mean) * inv
        dx = ((gamma * inv) * (dy.float() - db / m - xhat * (dg / m)))
        return dx.to(x.dtype), dg.to(gamma.dtype), db.to(gamma.dtype), None


def fused_batch_norm(x, gamma, beta, eps: float):
    """Training batch norm over the last axis of ``x`` ([..., C]):
    returns (y, mean, var). mean and var are the batch moments (population
    variance), returned so that the running-stat update reuses the same
    stats pass; they carry no gradient."""
    return _FusedBatchNorm.apply(x, gamma, beta, eps)


def batch_norm_train(x, gamma, beta, eps: float, *,
                     pallas_min_elems: int = PALLAS_MIN_ELEMS):
    """Fused BN plus the (detached) batch moments for the running-stat
    update. Layers of fewer than ``pallas_min_elems`` elements take
    plain-PyTorch reductions, differentiated by autograd."""
    if x.numel() < pallas_min_elems:
        xf = _at_least_f32(x)
        dims = tuple(range(x.ndim - 1))
        n = world_size()
        if n == 1:
            mean = xf.mean(dims)
            var = torch.clamp_min((xf * xf).mean(dims) - mean * mean, 0.0)
        else:
            # Each process holds part of the batch: its sums, added across
            # the world (differentiably), give the global batch's moments,
            # as GSPMD takes them over a batch-sharded mesh.
            m = n * (x.numel() // x.shape[-1])
            sums = all_reduce_sum(torch.stack([xf.sum(dims),
                                               (xf * xf).sum(dims)]))
            mean = sums[0] / m
            var = torch.clamp_min(sums[1] / m - mean * mean, 0.0)
        y, _ = _normalize(x, mean, var, gamma, beta, eps)
        return y, mean.detach(), var.detach()
    return fused_batch_norm(x, gamma, beta, eps)


def require_single_device(n_devices: int) -> None:
    """The invariant every bn_impl='pallas' entry point holds, as in the
    JAX package (which has no partitioning rule for its stats kernels):
    the kernels reduce over the rows one device holds, so a batch split
    across devices would normalize each shard by its own moments. The
    plain route (bn_impl='xla') sums its moments across the world."""
    if n_devices > 1:
        raise SystemExit(
            f"--bn-kernel pallas runs the single-device path only; this "
            f"mesh has {n_devices} devices"
        )


# ---------------------------------------------------------------------------
# Modules
# ---------------------------------------------------------------------------


class _BatchNormBase(nn.Module):
    """``scale`` and ``bias`` parameters and the running ``mean`` and
    ``var`` buffers (Flax's ``batch_stats``), f32, over ``[N, C, H, W]``
    inputs (any rank with channels at dim 1). ``scale_init`` is 1.0, or
    0.0 for the last BN of a residual block. Eval mode (``.eval()``)
    normalizes with the running statistics."""

    def __init__(self, num_features: int, *, momentum: float = 0.9,
                 epsilon: float = 1e-5, dtype=torch.bfloat16,
                 scale_init: float = 1.0, device=None):
        super().__init__()
        self.momentum = momentum
        self.epsilon = epsilon
        self.dtype = dtype
        self.scale_init = scale_init
        f32 = dict(dtype=torch.float32, device=device)
        self.scale = nn.Parameter(torch.empty(num_features, **f32))
        self.bias = nn.Parameter(torch.empty(num_features, **f32))
        self.register_buffer("mean", torch.empty(num_features, **f32))
        self.register_buffer("var", torch.empty(num_features, **f32))
        self.reset_parameters()

    @torch.no_grad()
    def reset_parameters(self) -> None:
        self.scale.fill_(self.scale_init)
        self.bias.zero_()
        self.mean.zero_()
        self.var.fill_(1.0)

    def _train_moments(self, x_last):
        """(y [..., C] in x's type, batch mean, batch var), moments
        detached."""
        raise NotImplementedError

    def forward(self, x):
        # [N, C, ...] -> [N, ..., C]: a free view under channels_last.
        x_last = x.movedim(1, -1)
        if self.training:
            y, mean, var = self._train_moments(x_last)
            with torch.no_grad():
                m = self.momentum
                self.mean.copy_(m * self.mean + (1 - m) * mean)
                self.var.copy_(m * self.var + (1 - m) * var)
        else:
            y, _ = _normalize(x_last, self.mean, self.var, self.scale,
                              self.bias, self.epsilon)
        return y.to(self.dtype).movedim(-1, 1)

    def extra_repr(self) -> str:
        return (f"{self.scale.shape[0]}, momentum={self.momentum}, "
                f"epsilon={self.epsilon}, dtype={self.dtype}")


class TpuBatchNorm(_BatchNormBase):
    """The ``bn_impl="pallas"`` route: the moments from the stats kernel
    and the parameter gradients from the grads kernel (plain versions on
    the CPU). Layers of fewer than ``pallas_min_elems`` elements take
    plain reductions (see :data:`PALLAS_MIN_ELEMS`)."""

    def __init__(self, num_features: int, *,
                 pallas_min_elems: int = PALLAS_MIN_ELEMS, **kw):
        super().__init__(num_features, **kw)
        self.pallas_min_elems = pallas_min_elems

    def _train_moments(self, x_last):
        return batch_norm_train(x_last, self.scale, self.bias, self.epsilon,
                                pallas_min_elems=self.pallas_min_elems)


class BatchNorm(_BatchNormBase):
    """The ``bn_impl="xla"`` route: Flax ``nn.BatchNorm`` in plain PyTorch
    ops, differentiated by autograd (moments ``E[x]``, ``E[x²]`` in at
    least f32, variance clamped at 0)."""

    def _train_moments(self, x_last):
        return batch_norm_train(x_last, self.scale, self.bias, self.epsilon,
                                pallas_min_elems=math.inf)
