"""Flash attention over the projection layout, forward and backward.

Port of the flat path of ``mpi_operator_tpu/ops/attention.py``: the
three Pallas kernels ``_fwd_flat_kernel``, ``_bwd_flat_dq_kernel`` and
``_bwd_flat_dkv_kernel`` become the hand-written CUDA kernels in
``csrc/flash_fwd.cu``, ``csrc/flash_bwd_dq.cu`` and
``csrc/flash_bwd_dkv.cu``. Operands keep the projection layout
``[B, S, H*D]`` that the q/k/v projections produce, so no transpose
surrounds the kernels.

Every kernel has a plain PyTorch version beside it, of the same
signature and the kernel's conventions (a fully masked row gives
``out = 0`` and ``lse = NEG_INF``). A wrapper takes the plain version
only for tensors on the CPU; for a CUDA tensor it launches the kernel
or raises. Each wrapper counts its launches in :data:`LAUNCHES`, so a
run can show that its attention went through the kernels.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import _build

NEG_INF = -1e30  # safe "minus infinity": avoids inf-inf -> nan in masking

# Kernel launches since the last reset_launch_counts(), by C entry point.
# Incremented by the wrappers right after a launch succeeds, and nowhere
# else (the CPU's plain versions do not count).
LAUNCHES = {"flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0}

_KERNEL_DTYPES = (torch.bfloat16, torch.float32)
_KERNEL_MAX_D = 128  # csrc/flash_common.cuh MAX_D


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def attention_reference(
    q, k, v, *, causal: bool = False, sm_scale: Optional[float] = None
):
    """Plain attention (f32 softmax) -- the dense oracle.

    Shapes: q [B, H, Sq, D]; k, v [B, H, Sk, D]. A fully masked row
    (causal with Sq > Sk) softmaxes into a uniform distribution here;
    the flash kernels return 0 for it instead."""
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * sm_scale
    if causal:
        s = s.masked_fill(
            ~_visible(q.shape[-2], k.shape[-2], True, s.device), NEG_INF
        )
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)


# ---------------------------------------------------------------------------
# Plain versions of the three kernels (CPU path; the card's yardstick)
# ---------------------------------------------------------------------------


def _visible(q_len: int, kv_len: int, causal: bool, device) -> torch.Tensor:
    """[Sq, Sk] bool: bottom-right-aligned causal mask (the last q row
    sees the last k column), all True without causal."""
    row = torch.arange(q_len, device=device)[:, None]
    col = torch.arange(kv_len, device=device)[None, :]
    if not causal:
        return torch.ones(q_len, kv_len, dtype=torch.bool, device=device)
    return col <= row + (kv_len - q_len)


def _heads(x: torch.Tensor, n: int, repeat: int = 1) -> torch.Tensor:
    """[B, S, n*D] -> f32 [B, n*repeat, S, D]; ``repeat`` expands GQA kv
    heads so q head hh reads kv head hh // repeat."""
    b, s, hd = x.shape
    out = x.float().reshape(b, s, n, hd // n).permute(0, 2, 1, 3)
    return out.repeat_interleave(repeat, dim=1) if repeat > 1 else out


def _flat(x: torch.Tensor, dtype) -> torch.Tensor:
    """[B, n, S, D] -> [B, S, n*D] in ``dtype``."""
    b, n, s, d = x.shape
    return x.permute(0, 2, 1, 3).reshape(b, s, n * d).to(dtype)


def _geometry(qf, kf, h):
    b, q_len, hd = qf.shape
    d = hd // h
    return b, q_len, kf.shape[1], d, kf.shape[2] // d


def flash_fwd_plain(qf, kf, vf, h: int, sm_scale: float, causal: bool):
    """Plain version of the forward kernel: (out [B, Sq, H*D] like q,
    lse f32 [B, Sq, H])."""
    _, q_len, kv_len, _, h_kv = _geometry(qf, kf, h)
    q = _heads(qf, h)
    k = _heads(kf, h_kv, h // h_kv)
    v = _heads(vf, h_kv, h // h_kv)
    mask = _visible(q_len, kv_len, causal, qf.device)
    s = q @ k.transpose(-1, -2) * sm_scale
    m = torch.where(mask, s, NEG_INF).amax(dim=-1, keepdim=True)
    p = torch.exp(torch.where(mask, s - m, NEG_INF))
    l = p.sum(dim=-1, keepdim=True)
    safe_l = torch.where(l > 0, l, 1.0)
    out = (p @ v) / safe_l
    lse = torch.where(l > 0, m + torch.log(safe_l), NEG_INF)
    return _flat(out, qf.dtype), lse[..., 0].transpose(1, 2).contiguous()


def _bwd_plain(qf, kf, vf, do, lse, delta, h, sm_scale, causal):
    """(p, ds, q, k, do) per q head, f32 [B, H, ...], recomputing p from
    lse exactly as the backward kernels do."""
    _, q_len, kv_len, _, h_kv = _geometry(qf, kf, h)
    q = _heads(qf, h)
    k = _heads(kf, h_kv, h // h_kv)
    v = _heads(vf, h_kv, h // h_kv)
    dout = _heads(do, h)
    mask = _visible(q_len, kv_len, causal, qf.device)
    s = q @ k.transpose(-1, -2)
    lse_c = lse.transpose(1, 2)[..., None]      # [B, H, Sq, 1]
    delta_c = delta.transpose(1, 2)[..., None]  # [B, H, Sq, 1]
    p = torch.exp(torch.where(mask, s * sm_scale - lse_c, NEG_INF))
    ds = p * (dout @ v.transpose(-1, -2) - delta_c)
    return p, ds, q, k, dout


def flash_bwd_dq_plain(qf, kf, vf, do, lse, delta, h: int, sm_scale: float,
                       causal: bool):
    """Plain version of the dq kernel: dq [B, Sq, H*D] like q."""
    _, ds, _, k, _ = _bwd_plain(qf, kf, vf, do, lse, delta, h, sm_scale,
                                causal)
    return _flat(sm_scale * (ds @ k), qf.dtype)


def flash_bwd_dkv_plain(qf, kf, vf, do, lse, delta, h: int, sm_scale: float,
                        causal: bool):
    """Plain version of the dkv kernel: (dk, dv) [B, Sk, Hkv*D] like k, v;
    each kv head sums over the H / Hkv q heads that share it."""
    b, _, kv_len, d, h_kv = _geometry(qf, kf, h)
    p, ds, q, _, dout = _bwd_plain(qf, kf, vf, do, lse, delta, h, sm_scale,
                                   causal)

    def per_kv_head(x):  # [B, H, Sk, D] -> [B, Hkv, Sk, D]
        return x.reshape(b, h_kv, h // h_kv, kv_len, d).sum(dim=2)

    dk = per_kv_head(sm_scale * (ds.transpose(-1, -2) @ q))
    dv = per_kv_head(p.transpose(-1, -2) @ dout)
    return _flat(dk, kf.dtype), _flat(dv, vf.dtype)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------


def _check_flat(qf, kf, vf, h, *extra):
    tensors = (qf, kf, vf, *extra)
    if qf.ndim != 3 or kf.ndim != 3 or kf.shape != vf.shape:
        raise ValueError(
            f"expected q [B, Sq, H*D] and k, v [B, Sk, Hkv*D]; got "
            f"{tuple(qf.shape)}, {tuple(kf.shape)}, {tuple(vf.shape)}"
        )
    if qf.shape[2] % h or kf.shape[2] % (qf.shape[2] // h):
        raise ValueError(
            f"q width {qf.shape[2]} is not H={h} heads of a head dim that "
            f"divides the kv width {kf.shape[2]}"
        )
    if h % (kf.shape[2] // (qf.shape[2] // h)):
        raise ValueError(f"q heads {h} not a multiple of the kv heads")
    if len({t.device for t in tensors}) != 1:
        raise ValueError("flash operands must lie on one device")
    device = qf.device
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {device}")
    if device.type == "cuda":
        if qf.dtype not in _KERNEL_DTYPES:
            raise TypeError(
                f"the flash kernels take bfloat16 or float32, got {qf.dtype}"
            )
        # q, k, v (and do) share one type; lse and delta are f32.
        if len({t.dtype for t in tensors[:4]}) != 1:
            raise TypeError(
                f"flash operands must share one dtype, got "
                f"{[t.dtype for t in tensors[:4]]}"
            )
        if qf.shape[2] // h > _KERNEL_MAX_D:
            raise ValueError(
                f"the flash kernels take head_dim <= {_KERNEL_MAX_D}, got "
                f"{qf.shape[2] // h}"
            )
    return device


def _launch(name: str, device, *args) -> None:
    fn = _build.kernel(name)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        _build.check(name, fn(*args, stream))
    LAUNCHES[name] += 1


def flash_fwd(qf, kf, vf, h: int, sm_scale: float, causal: bool):
    """Forward kernel: (out [B, Sq, H*D] like q, lse f32 [B, Sq, H])."""
    device = _check_flat(qf, kf, vf, h)
    if device.type == "cpu":
        return flash_fwd_plain(qf, kf, vf, h, sm_scale, causal)
    qf, kf, vf = (t.contiguous() for t in (qf, kf, vf))
    b, q_len, kv_len, d, h_kv = _geometry(qf, kf, h)
    out = torch.empty_like(qf)
    lse = torch.empty(b, q_len, h, dtype=torch.float32, device=device)
    _launch(
        "flash_fwd", device, qf.data_ptr(), kf.data_ptr(), vf.data_ptr(), out.data_ptr(),
        lse.data_ptr(), b, q_len, kv_len, h, h_kv, d, float(sm_scale),
        int(causal), int(qf.dtype == torch.bfloat16),
    )
    return out, lse


def _bwd_operands(qf, kf, vf, do, lse, delta):
    return (
        qf.contiguous(), kf.contiguous(), vf.contiguous(), do.contiguous(),
        lse.float().contiguous(), delta.float().contiguous(),
    )


def flash_bwd_dq(qf, kf, vf, do, lse, delta, h: int, sm_scale: float,
                 causal: bool):
    """dq kernel: dq [B, Sq, H*D] like q."""
    device = _check_flat(qf, kf, vf, h, do, lse, delta)
    if device.type == "cpu":
        return flash_bwd_dq_plain(qf, kf, vf, do, lse, delta, h, sm_scale,
                                  causal)
    qf, kf, vf, do, lse, delta = _bwd_operands(qf, kf, vf, do, lse, delta)
    b, q_len, kv_len, d, h_kv = _geometry(qf, kf, h)
    dq = torch.empty_like(qf)
    _launch(
        "flash_bwd_dq", device, qf.data_ptr(), kf.data_ptr(), vf.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), b, q_len, kv_len, h, h_kv, d,
        float(sm_scale), int(causal), int(qf.dtype == torch.bfloat16),
    )
    return dq


def flash_bwd_dkv(qf, kf, vf, do, lse, delta, h: int, sm_scale: float,
                  causal: bool):
    """dkv kernel: (dk, dv) [B, Sk, Hkv*D] like k, v."""
    device = _check_flat(qf, kf, vf, h, do, lse, delta)
    if device.type == "cpu":
        return flash_bwd_dkv_plain(qf, kf, vf, do, lse, delta, h, sm_scale,
                                   causal)
    qf, kf, vf, do, lse, delta = _bwd_operands(qf, kf, vf, do, lse, delta)
    b, q_len, kv_len, d, h_kv = _geometry(qf, kf, h)
    dk = torch.empty_like(kf)
    dv = torch.empty_like(vf)
    _launch(
        "flash_bwd_dkv", device, qf.data_ptr(), kf.data_ptr(), vf.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, q_len, kv_len, h,
        h_kv, d, float(sm_scale), int(causal),
        int(qf.dtype == torch.bfloat16),
    )
    return dk, dv


# ---------------------------------------------------------------------------
# The differentiable op
# ---------------------------------------------------------------------------


class _FlashFlat(torch.autograd.Function):
    """``_flash_flat``'s custom VJP (``_flash_flat_fwd_impl`` and
    ``_flash_flat_bwd_impl`` in JAX): the forward kernel, then the dq and
    dkv kernels recomputing p from the saved lse."""

    @staticmethod
    def forward(ctx, qf, kf, vf, h, sm_scale, causal):
        out, lse = flash_fwd(qf, kf, vf, h, sm_scale, causal)
        ctx.save_for_backward(qf, kf, vf, out, lse)
        ctx.h, ctx.sm_scale, ctx.causal = h, sm_scale, causal
        return out

    @staticmethod
    def backward(ctx, do):
        qf, kf, vf, out, lse = ctx.saved_tensors
        h, sm_scale, causal = ctx.h, ctx.sm_scale, ctx.causal
        b, q_len, hd = qf.shape
        # delta = rowsum(do * o) per head, straight into the [B, S, H]
        # layout the kernels read: a plain reduction, outside the kernels
        # as in JAX.
        delta = (do.float() * out.float()).reshape(b, q_len, h, hd // h).sum(-1)
        dq = flash_bwd_dq(qf, kf, vf, do, lse, delta, h, sm_scale, causal)
        dk, dv = flash_bwd_dkv(qf, kf, vf, do, lse, delta, h, sm_scale, causal)
        return dq, dk, dv, None, None, None


def flash_attention_bshd(
    q, k, v,
    *,
    causal: bool = False,
    sm_scale: Optional[float] = None,
):
    """Flash attention over the PROJECTION layout: q [B, Sq, H, D];
    k, v [B, Sk, Hkv, D] -> [B, Sq, H, D], the layout the projections
    and RoPE already produce, so no transpose surrounds the kernels.

    GQA (Hkv dividing H) shares kv heads by index. Causal masking is
    bottom-right aligned: query row ``r`` sees key column ``c`` when
    ``c <= r + (Sk - Sq)``.

    Masked-row convention: a query row that sees no key at all (causal
    with Sq > Sk) gives ``out = 0`` and, in the kernel's lse,
    ``lse = NEG_INF``. :func:`attention_reference` does not share it: its
    softmax spreads such a row uniformly over the keys.

    Differentiable: the backward runs the dq and dkv kernels. Tensors on
    a CUDA device go through the kernels (bfloat16 or float32, head_dim
    <= 128); tensors on the CPU through the plain versions.
    """
    if q.ndim != 4:
        raise ValueError(f"expected [B, S, H, D] inputs, got rank {q.ndim}")
    b, q_len, h, d = q.shape
    kv_len, h_kv = k.shape[1], k.shape[2]
    if h % h_kv:
        raise ValueError(f"q heads {h} not a multiple of kv heads {h_kv}")
    if h > 128:
        raise ValueError(
            f"flash_attention_bshd lane-packs per-head stats (<=128 "
            f"heads); got {h} — use flash_attention for wider models"
        )
    if sm_scale is None:
        sm_scale = d ** -0.5
    out = _FlashFlat.apply(
        q.reshape(b, q_len, h * d),        # free: H, D are contiguous
        k.reshape(b, kv_len, h_kv * d),
        v.reshape(b, kv_len, h_kv * d),
        h, sm_scale, causal,
    )
    return out.reshape(b, q_len, h, d)
