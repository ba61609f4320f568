"""Row normalisation through two hand-written kernels: LayerNorm (BERT,
ViT, seq2seq) and RMSNorm (the Llama family), forward and backward.

The JAX package leaves its norms to XLA, which fuses each into a pass or
two. Their plain expressions in PyTorch ran as about nine separate passes
over the row, most in f32, and autograd added twice that. The kernels
(``csrc/norm_fwd.cu``, ``csrc/norm_bwd.cu``) read a row once: the forward
writes y and the row's f32 statistics, the backward recomputes x^ from
them, writes dx and sums the gradients of scale and bias over the rows in
a fixed order.

Semantics, the same on both paths: LayerNorm is Flax's (f32 statistics,
variance ``max(E[x²] − E[x]², 0)``, f32 scale and bias, output in the
compute dtype); RMSNorm ``x · rsqrt(E[x²] + eps) · scale`` in f32, output
in x's dtype.

Every kernel has a plain PyTorch version beside it: the forward's
(``layer_norm_plain``, ``rms_norm_plain``, the models' expressions as they
were) and explicit backward formulas (``layer_norm_bwd_plain``,
``rms_norm_bwd_plain``) from the saved statistics (``*_stats_plain``). The
wrappers take the plain forward, differentiated by autograd, only for
tensors on the CPU; for a CUDA tensor they launch the kernels or raise.
Each launch counts in :data:`LAUNCHES`.

A training step calls the norms about fifty times, each on the host's
critical path, so a call does no more Python than it must: the launch
geometry is computed once for each width, types and alignment, the
card's SM count is looked up once, and the device is switched only when
the tensor is not on the current one.
"""

from __future__ import annotations

import torch

from . import _build
from ._common import NORM_MAX_D, norm_bwd_blocks, norm_geometry

# Kernel launches since the last reset_launch_counts(), by C entry point.
# Incremented by the wrappers right after a launch succeeds, and nowhere
# else (the CPU's plain versions do not count).
LAUNCHES = {"norm_fwd": 0, "norm_bwd": 0}

_KERNEL_DTYPES = (torch.bfloat16, torch.float32)


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# ---------------------------------------------------------------------------
# Plain versions (CPU path; the card's yardstick)
# ---------------------------------------------------------------------------


def layer_norm_plain(x, scale, bias, eps: float, out_dtype):
    """Flax ``LayerNorm`` over the last axis in plain ops."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = torch.clamp_min(
        (xf * xf).mean(dim=-1, keepdim=True) - mean * mean, 0.0)
    y = (xf - mean) * (torch.rsqrt(var + eps) * scale)
    return (y + bias).to(out_dtype)


def rms_norm_plain(x, scale, eps: float):
    """RMSNorm over the last axis in plain ops, output in x's dtype."""
    xf = x.float()
    norm = xf * torch.rsqrt(
        torch.mean(xf * xf, dim=-1, keepdim=True) + eps
    )
    return (norm * scale).to(x.dtype)


def layer_norm_stats_plain(x, eps: float):
    """What the forward kernel saves of each row, f32 [...]: the mean and
    rsqrt(var + eps), the latter negated where E[x²] − E[x]² fell below 0
    and the clamp cut the variance out of the gradient."""
    xf = x.float()
    mean = xf.mean(dim=-1)
    raw = (xf * xf).mean(dim=-1) - mean * mean
    rstd = torch.rsqrt(torch.clamp_min(raw, 0.0) + eps)
    return mean, torch.where(raw < 0, -rstd, rstd)


def rms_norm_stats_plain(x, eps: float):
    """rsqrt(E[x²] + eps) of each row, f32 [...]."""
    xf = x.float()
    return torch.rsqrt((xf * xf).mean(dim=-1) + eps)


def layer_norm_bwd_plain(x, dy, mean, rstd, scale):
    """(dx in x's dtype, dscale, dbias) of :func:`layer_norm_plain` from
    its saved statistics (:func:`layer_norm_stats_plain`): with
    x̂ = (x − mean)·|rstd| and g = dy·scale, dx = |rstd|·(g − mean(g) −
    x̂·mean(g·x̂)), the last term absent on a clamped row (rstd < 0)."""
    xf, dyf = x.float(), dy.float()
    r = rstd.abs()[..., None]
    xhat = (xf - mean[..., None]) * r
    g = dyf * scale
    b = (g * xhat).mean(dim=-1, keepdim=True)
    b = torch.where(rstd[..., None] < 0, torch.zeros_like(b), b)
    dx = r * (g - g.mean(dim=-1, keepdim=True) - xhat * b)
    rows = tuple(range(x.ndim - 1))
    return dx.to(x.dtype), (dyf * xhat).sum(rows), dyf.sum(rows)


def rms_norm_bwd_plain(x, dy, rstd, scale):
    """(dx in x's dtype, dscale) of :func:`rms_norm_plain` from its saved
    rstd: with x̂ = x·rstd and g = dy·scale, dx = rstd·(g − x̂·mean(g·x̂))."""
    xf, dyf = x.float(), dy.float()
    r = rstd[..., None]
    xhat = xf * r
    g = dyf * scale
    dx = r * (g - xhat * (g * xhat).mean(dim=-1, keepdim=True))
    return dx.to(x.dtype), (dyf * xhat).sum(tuple(range(x.ndim - 1)))


# ---------------------------------------------------------------------------
# Kernel wrappers (CUDA tensors)
# ---------------------------------------------------------------------------


def _rows(name: str, t: torch.Tensor) -> torch.Tensor:
    """The [M, D] view of a row operand the kernels take: bf16 or f32,
    D <= NORM_MAX_D, M >= 1 (a copy when t is not contiguous)."""
    if t.dtype not in _KERNEL_DTYPES:
        raise TypeError(f"{name} takes bfloat16 or float32 rows, got "
                        f"{t.dtype}")
    if t.ndim < 1 or not 1 <= t.shape[-1] <= NORM_MAX_D or t.numel() < 1:
        raise ValueError(f"{name} takes rows of 1 to {NORM_MAX_D} elements, "
                         f"at least one row; got {tuple(t.shape)}")
    return t.reshape(-1, t.shape[-1]).contiguous()


def _vector(name: str, v, d: int, device) -> torch.Tensor:
    """A per-column f32 [D] operand on ``device``. No plan shards a norm's
    parameters or hands them over as DTensors, so a DTensor is refused:
    its local tensor would take a gradient summed over this rank's rows
    alone."""
    if hasattr(v, "placements"):
        raise TypeError(f"{name}: scale and bias must be plain tensors, not "
                        f"a DTensor ({v.placements})")
    if v.shape != (d,) or v.device != device or v.dtype != torch.float32:
        raise ValueError(f"{name}: scale and bias must be float32 [{d}] on "
                         f"{device}; got {v.dtype} {tuple(v.shape)} on "
                         f"{v.device}")
    return v.contiguous()


# Looked up once a process: (d, widest element bytes, each operand's
# (address % _ALIGN, element bytes)) -> (vec, tpr); device index -> its SM
# count.
_GEOMETRY: dict = {}
_SMS: dict = {}
# A multiple of every vector's bytes: 16 of a row operand, 32 of f32
# scale and bias beside 8 bf16 row elements.
_ALIGN = 64


def _geometry(d: int, elem_bytes: int, operands) -> tuple:
    """:func:`norm_geometry` of ``operands``, computed once for each
    width, element sizes and alignment."""
    key = (d, elem_bytes, tuple((t.data_ptr() % _ALIGN, t.element_size())
                                for t in operands))
    got = _GEOMETRY.get(key)
    if got is None:
        got = _GEOMETRY[key] = norm_geometry(d, elem_bytes, key[2])
    return got


def _sms(device) -> int:
    got = _SMS.get(device.index)
    if got is None:
        got = _SMS[device.index] = torch.cuda.get_device_properties(
            device).multi_processor_count
    return got


def _launch(name: str, device, *args) -> None:
    fn = _build.kernel(name)
    if device.index != torch.cuda.current_device():
        with torch.cuda.device(device):
            return _launch(name, device, *args)
    _build.check(name, fn(*args, torch.cuda.current_stream().cuda_stream))
    LAUNCHES[name] += 1


def _bf16(t: torch.Tensor) -> int:
    return int(t.dtype == torch.bfloat16)


def _norm_fwd(x2d, scale, bias, eps: float, out_dtype):
    """:func:`norm_fwd` with the statistics as one f32 [planes, M]
    tensor: (mean, rstd) for LayerNorm, (rstd,) for RMSNorm."""
    if out_dtype not in _KERNEL_DTYPES:
        raise TypeError(f"norm_fwd writes bfloat16 or float32, not "
                        f"{out_dtype}")
    m, d = x2d.shape
    device = x2d.device
    layer = bias is not None
    y = torch.empty(m, d, dtype=out_dtype, device=device)
    stats = torch.empty(2 if layer else 1, m, dtype=torch.float32,
                        device=device)
    at = stats.data_ptr()
    vec, tpr = _geometry(
        d, max(x2d.element_size(), y.element_size()),
        (x2d, y, scale, bias) if layer else (x2d, y, scale))
    _launch("norm_fwd", device, x2d.data_ptr(), scale.data_ptr(),
            bias.data_ptr() if layer else None, y.data_ptr(),
            at if layer else None, at + 4 * m if layer else at,
            m, d, vec, tpr, eps, int(layer), _bf16(x2d), _bf16(y))
    return y, stats


def norm_fwd(x2d, scale, bias, eps: float, out_dtype):
    """Forward kernel over the rows of ``x2d`` ([M, D] contiguous, bf16 or
    f32): LayerNorm with ``bias``, RMSNorm without (``bias`` None).
    Returns (y [M, D] in ``out_dtype``, mean f32 [M] or None, rstd f32
    [M]); rstd as :func:`layer_norm_stats_plain` saves it."""
    y, stats = _norm_fwd(x2d, scale, bias, eps, out_dtype)
    return y, (stats[0] if bias is not None else None), stats[-1]


def _norm_bwd(x2d, dy2d, mean_at, rstd_at: int, scale):
    """:func:`norm_bwd` from the addresses of the saved statistics
    (``mean_at`` None for RMSNorm)."""
    m, d = x2d.shape
    device = x2d.device
    layer = mean_at is not None
    dx = torch.empty_like(x2d)
    vec, tpr = _geometry(
        d, max(x2d.element_size(), dy2d.element_size()),
        (x2d, dy2d, dx, scale))
    planes = 2 if layer else 1
    max_blocks = norm_bwd_blocks(m, tpr, _sms(device))
    part = torch.empty(planes, max_blocks, d, dtype=torch.float32,
                       device=device)
    out = torch.empty(planes, d, dtype=torch.float32, device=device)
    _launch("norm_bwd", device, x2d.data_ptr(), dy2d.data_ptr(), mean_at,
            rstd_at, scale.data_ptr(), dx.data_ptr(), part.data_ptr(),
            out.data_ptr(), m, d, vec, tpr, max_blocks, int(layer),
            _bf16(x2d), _bf16(dy2d))
    grads = out.unbind(0)
    return dx, grads[0], (grads[1] if layer else None)


def norm_bwd(x2d, dy2d, mean, rstd, scale):
    """Backward kernel: (dx [M, D] in x's dtype, dscale f32 [D], dbias f32
    [D] or None) from the forward's saved (mean, rstd); LayerNorm's with
    ``mean``, RMSNorm's without (``mean`` None)."""
    return _norm_bwd(x2d, dy2d, None if mean is None else mean.data_ptr(),
                     rstd.data_ptr(), scale)


class _Norm(torch.autograd.Function):
    """The two kernels as one differentiable op: LayerNorm with ``bias``,
    RMSNorm with ``bias`` None."""

    @staticmethod
    def forward(ctx, x, scale, bias, eps, out_dtype):
        x2d = _rows("norm", x)
        y, stats = _norm_fwd(x2d, scale, bias, eps, out_dtype)
        ctx.save_for_backward(x2d, scale, stats)
        return y.view(x.shape)

    @staticmethod
    def backward(ctx, dy):
        x2d, scale, stats = ctx.saved_tensors
        # dy has y's type, one the kernels take.
        dy2d = dy.reshape(x2d.shape).contiguous()
        at = stats.data_ptr()
        layer = stats.shape[0] == 2
        dx, dscale, dbias = _norm_bwd(x2d, dy2d, at if layer else None,
                                      at + 4 * x2d.shape[0] if layer else at,
                                      scale)
        return dx.view(dy.shape), dscale, dbias, None, None


def _norm(x, scale, bias, eps: float, out_dtype):
    """The kernels for a CUDA tensor; raises on one they cannot take."""
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    d = x.shape[-1]
    scale = _vector("norm", scale, d, x.device)
    if bias is not None:
        bias = _vector("norm", bias, d, x.device)
    return _Norm.apply(x, scale, bias, eps, out_dtype)


def layer_norm(x, scale, bias, eps: float, out_dtype):
    """Flax ``LayerNorm`` over the last axis of ``x``: the kernels on the
    card, :func:`layer_norm_plain` on the CPU."""
    if x.device.type == "cpu":
        return layer_norm_plain(x, scale, bias, eps, out_dtype)
    return _norm(x, scale, bias, eps, out_dtype)


def rms_norm(x, scale, eps: float):
    """RMSNorm over the last axis of ``x``, output in x's dtype: the
    kernels on the card, :func:`rms_norm_plain` on the CPU."""
    if x.device.type == "cpu":
        return rms_norm_plain(x, scale, eps)
    return _norm(x, scale, None, eps, x.dtype)
