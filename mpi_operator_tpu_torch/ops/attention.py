"""Flash attention, forward and backward, in both layouts of the JAX
package (port of ``mpi_operator_tpu/ops/attention.py``):

- the flat path: the three Pallas kernels ``_fwd_flat_kernel``,
  ``_bwd_flat_dq_kernel`` and ``_bwd_flat_dkv_kernel`` become the
  hand-written CUDA kernels in ``csrc/flash_fwd.cu``,
  ``csrc/flash_bwd_dq.cu`` and ``csrc/flash_bwd_dkv.cu``. Operands keep
  the projection layout ``[B, S, H*D]`` that the q/k/v projections
  produce, so no transpose surrounds the kernels
  (:func:`flash_attention_bshd`, and :func:`flash_attention_bshd_lse`
  with optional row/col ids, the ring attention hop);
- the ``[B*H, S, D]`` path: ``_fwd_kernel``, ``_bwd_dq_kernel`` and
  ``_bwd_dkv_kernel`` become ``csrc/flash_bhsd_fwd.cu``,
  ``csrc/flash_bhsd_bwd_dq.cu`` and ``csrc/flash_bhsd_bwd_dkv.cu``, with
  optional row/col ids (:func:`flash_attention`,
  :func:`flash_attention_lse`). Each kernel shares its body with its flat
  twin; only the strides differ.

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
import torch.nn.functional as F

from . import _build
from ._common import FLASH_MAX_HEAD_DIM, flash_padded_head_dim

NEG_INF = -1e30  # safe "minus infinity": avoids inf-inf -> nan in masking

# Kernel launches since the last reset_launch_counts(), by C entry point.
# Incremented by the wrappers right after a launch succeeds, and nowhere
# else (the CPU's plain versions do not count).
LAUNCHES = {
    "flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0,
    "flash_bhsd_fwd": 0, "flash_bhsd_bwd_dq": 0, "flash_bhsd_bwd_dkv": 0,
}

_KERNEL_DTYPES = (torch.bfloat16, torch.float32)
_KERNEL_MAX_D = FLASH_MAX_HEAD_DIM  # csrc/flash_common.cuh MAX_D


# The flat kernels' launches since the last reset_launch_counts(), by
# entry point and the q and kv head counts the launch was given ("flash_fwd
# 16/4"): a tensor-parallel rank's local heads. Counted beside LAUNCHES.
LAUNCH_HEADS: dict = {}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
    LAUNCH_HEADS.clear()


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
# Plain versions of the kernels (CPU path; the card's yardstick)
# ---------------------------------------------------------------------------


def _visible(q_len: int, kv_len: int, causal: bool, device) -> torch.Tensor:
    """[Sq, Sk] bool: bottom-right-aligned causal mask (the last q row
    sees the last k column), all True without causal."""
    row = torch.arange(q_len, device=device)[:, None]
    col = torch.arange(kv_len, device=device)[None, :]
    if not causal:
        return torch.ones(q_len, kv_len, dtype=torch.bool, device=device)
    return col <= row + (kv_len - q_len)


def _attend(q, k, v, mask, sm_scale):
    """The forward's math on f32 q [..., Sq, D], k, v [..., Sk, D] and a
    bool mask broadcastable to [..., Sq, Sk]: (out [..., Sq, D],
    lse [..., Sq]); a row that sees nothing gives 0 and NEG_INF."""
    s = q @ k.transpose(-1, -2) * sm_scale
    m = torch.where(mask, s, NEG_INF).amax(dim=-1, keepdim=True)
    p = torch.exp(torch.where(mask, s - m, NEG_INF))
    l = p.sum(dim=-1, keepdim=True)
    safe_l = torch.where(l > 0, l, 1.0)
    lse = torch.where(l > 0, m + torch.log(safe_l), NEG_INF)
    return (p @ v) / safe_l, lse[..., 0]


def _attend_grads(q, k, v, dout, lse, delta, mask, sm_scale):
    """(p, ds), f32 [..., Sq, Sk], recomputing p from lse [..., Sq]
    exactly as the backward kernels do."""
    s = q @ k.transpose(-1, -2)
    p = torch.exp(torch.where(mask, s * sm_scale - lse[..., None], NEG_INF))
    ds = p * (dout @ v.transpose(-1, -2) - delta[..., None])
    return p, ds


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


def _mask(q, k, causal, row_ids, col_ids):
    """[Sq, Sk] bool for the kernels of either layout (dim 1 of q and k is
    the sequence): ``col_id <= row_id`` when ids are given (``causal``
    then plays no part), else :func:`_visible`."""
    if row_ids is not None:
        return col_ids.to(q.device)[None, :] <= row_ids.to(q.device)[:, None]
    return _visible(q.shape[1], k.shape[1], causal, q.device)


# The kernels' classes of a (q tile, k tile) pair under ids
# (csrc/flash_common.cuh:live_tiles): no pair visible, some, every one.
TILE_DEAD, TILE_MIXED, TILE_FULL = 0, 1, 2


def tile_classes(row_ids, col_ids, q_len: int, kv_len: int, tq: int,
                 tk: int) -> torch.Tensor:
    """Plain version of the kernels' tile classification: int8
    ``[ceil(q_len / tq), ceil(kv_len / tk)]``. Over a q tile's rows inside
    ``q_len`` (ids ``rmin..rmax``) and a k tile's columns inside
    ``kv_len`` (``cmin..cmax``) the pair is ``TILE_DEAD`` iff ``cmin >
    rmax``, ``TILE_FULL`` iff ``cmax <= rmin`` and both tiles lie inside
    their sequences, else ``TILE_MIXED``. Exact for any ids: a dead pair
    has no visible (row, col), a full one no masked one."""
    def ranges(ids, n, t):
        # Past n: 2^32 (above any int32 id) for the minimum, -2^32 for
        # the maximum.
        x = ids[:n].to(torch.int64)
        pad = torch.full(((-n) % t,), 2 ** 32, dtype=torch.int64)
        lo, hi = torch.cat([x, pad]), torch.cat([x, -pad])
        inside = torch.arange(1, lo.numel() // t + 1) * t <= n
        return lo.view(-1, t).amin(1), hi.view(-1, t).amax(1), inside

    rmin, rmax, q_in = ranges(row_ids.cpu(), q_len, tq)
    cmin, cmax, k_in = ranges(col_ids.cpu(), kv_len, tk)
    live = cmin[None, :] <= rmax[:, None]
    full = (cmax[None, :] <= rmin[:, None]) & q_in[:, None] & k_in[None, :]
    return torch.where(full, TILE_FULL,
                       torch.where(live, TILE_MIXED, TILE_DEAD)).to(torch.int8)


def flash_fwd_plain(qf, kf, vf, h: int, sm_scale: float, causal: bool,
                    row_ids=None, col_ids=None):
    """Plain version of the forward kernel: (out [B, Sq, H*D] like q,
    lse f32 [B, Sq, H])."""
    h_kv = _geometry(qf, kf, h)[4]
    out, lse = _attend(
        _heads(qf, h), _heads(kf, h_kv, h // h_kv), _heads(vf, h_kv, h // h_kv),
        _mask(qf, kf, causal, row_ids, col_ids), sm_scale,
    )
    return _flat(out, qf.dtype), lse.transpose(1, 2).contiguous()


def _bwd_plain(qf, kf, vf, do, lse, delta, h, sm_scale, causal, row_ids,
               col_ids):
    """(p, ds, q, k, do) per q head, f32 [B, H, ...]."""
    h_kv = _geometry(qf, kf, h)[4]
    q = _heads(qf, h)
    k = _heads(kf, h_kv, h // h_kv)
    dout = _heads(do, h)
    p, ds = _attend_grads(
        q, k, _heads(vf, h_kv, h // h_kv), dout, lse.transpose(1, 2),
        delta.transpose(1, 2), _mask(qf, kf, causal, row_ids, col_ids),
        sm_scale,
    )
    return p, ds, q, k, dout


def flash_bwd_dq_plain(qf, kf, vf, do, lse, delta, h: int, sm_scale: float,
                       causal: bool, row_ids=None, col_ids=None):
    """Plain version of the dq kernel: dq [B, Sq, H*D] like q."""
    _, ds, _, k, _ = _bwd_plain(qf, kf, vf, do, lse, delta, h, sm_scale,
                                causal, row_ids, col_ids)
    return _flat(sm_scale * (ds @ k), qf.dtype)


def flash_bwd_dkv_plain(qf, kf, vf, do, lse, delta, h: int, sm_scale: float,
                        causal: bool, row_ids=None, col_ids=None):
    """Plain version of the dkv kernel: (dk, dv) [B, Sk, Hkv*D] like k, v;
    each kv head sums over the H / Hkv q heads that share it."""
    b, _, kv_len, d, h_kv = _geometry(qf, kf, h)
    p, ds, q, _, dout = _bwd_plain(qf, kf, vf, do, lse, delta, h, sm_scale,
                                   causal, row_ids, col_ids)

    def per_kv_head(x):  # [B, H, Sk, D] -> [B, Hkv, Sk, D]
        return x.reshape(b, h_kv, h // h_kv, kv_len, d).sum(dim=2)

    dk = per_kv_head(sm_scale * (ds.transpose(-1, -2) @ q))
    dv = per_kv_head(p.transpose(-1, -2) @ dout)
    return _flat(dk, kf.dtype), _flat(dv, vf.dtype)


def _kv_rows(x, groups: int):
    """f32 [B*Hkv, S, D] -> [B*H, S, D]: q row r reads kv row r // groups."""
    return x.float().repeat_interleave(groups, dim=0)


def flash_bhsd_fwd_plain(q, k, v, sm_scale: float, causal: bool,
                         row_ids=None, col_ids=None):
    """Plain version of the [B*H, S, D] forward kernel: (out like q,
    lse f32 [B*H, Sq])."""
    groups = q.shape[0] // k.shape[0]
    out, lse = _attend(q.float(), _kv_rows(k, groups), _kv_rows(v, groups),
                       _mask(q, k, causal, row_ids, col_ids), sm_scale)
    return out.to(q.dtype), lse


def _bhsd_bwd_plain(q, k, v, do, lse, delta, sm_scale, causal, row_ids,
                    col_ids):
    groups = q.shape[0] // k.shape[0]
    kx = _kv_rows(k, groups)
    p, ds = _attend_grads(q.float(), kx, _kv_rows(v, groups), do.float(),
                          lse, delta,
                          _mask(q, k, causal, row_ids, col_ids), sm_scale)
    return p, ds, kx


def flash_bhsd_bwd_dq_plain(q, k, v, do, lse, delta, sm_scale: float,
                            causal: bool, row_ids=None, col_ids=None):
    """Plain version of the [B*H, S, D] dq kernel: dq like q."""
    _, ds, kx = _bhsd_bwd_plain(q, k, v, do, lse, delta, sm_scale, causal,
                                row_ids, col_ids)
    return (sm_scale * (ds @ kx)).to(q.dtype)


def flash_bhsd_bwd_dkv_plain(q, k, v, do, lse, delta, sm_scale: float,
                             causal: bool, row_ids=None, col_ids=None):
    """Plain version of the [B*H, S, D] dkv kernel: (dk, dv) like k, v;
    each kv row sums over the q rows that share it."""
    p, ds, _ = _bhsd_bwd_plain(q, k, v, do, lse, delta, sm_scale, causal,
                               row_ids, col_ids)

    def per_kv_row(x):  # [B*H, Sk, D] -> [B*Hkv, Sk, D]
        return x.reshape(k.shape[0], -1, *x.shape[1:]).sum(dim=1)

    dk = per_kv_row(sm_scale * (ds.transpose(-1, -2) @ q.float()))
    dv = per_kv_row(p.transpose(-1, -2) @ do.float())
    return dk.to(k.dtype), dv.to(v.dtype)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------


def _kernel_device(same_type, others, head_dim: int):
    """The one device of the operands, after the checks a CUDA launch
    needs: ``same_type`` (q, k, v and, in the backward, do) share q's
    type; ``others`` are the f32 statistics and the int ids. A CUDA
    operand the kernels cannot take raises: it never falls back to the
    plain version."""
    tensors = (*same_type, *others)
    if len({t.device for t in tensors}) != 1:
        raise ValueError("flash operands must lie on one device")
    device = tensors[0].device
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {device}")
    if device.type == "cuda":
        if tensors[0].dtype not in _KERNEL_DTYPES:
            raise TypeError(
                f"the flash kernels take bfloat16 or float32, got "
                f"{tensors[0].dtype}"
            )
        if len({t.dtype for t in same_type}) != 1:
            raise TypeError(
                f"flash operands must share one dtype, got "
                f"{[t.dtype for t in same_type]}"
            )
        if head_dim > _KERNEL_MAX_D:
            raise ValueError(
                f"the flash kernels take head_dim <= {_KERNEL_MAX_D}, got "
                f"{head_dim}"
            )
    return device


def _launch_head_dim(dtype, d: int) -> int:
    """The head dim a launch hands the kernel: ``d``, or in bf16 ``d``
    rounded up to a multiple of 8 (flash_padded_head_dim)."""
    return flash_padded_head_dim(d) if dtype == torch.bfloat16 else d


def _pad_head_dim(x: torch.Tensor, d: int, dp: int) -> torch.Tensor:
    """[..., n*d] -> [..., n*dp]: each head's d columns, then dp - d
    zeros, which add nothing to q k^T, p v or any gradient (a copy only
    when dp > d)."""
    if dp == d:
        return x
    return F.pad(x.unflatten(-1, (-1, d)), (0, dp - d)).flatten(-2)


def _cut_head_dim(x: torch.Tensor, dp: int, d: int) -> torch.Tensor:
    """The inverse of :func:`_pad_head_dim` on an output: [..., n*dp] ->
    [..., n*d]."""
    if dp == d:
        return x
    return x.unflatten(-1, (-1, dp))[..., :d].flatten(-2)


def _dense(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous with its first element 16-byte aligned, as the
    bf16 bodies' 16-byte loads need: a copy only when it is not so."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _check_ids(row_ids, col_ids, q_len: int, kv_len: int) -> tuple:
    """The ids as a tuple (empty without them), after checking that they
    come together, one per q row and one per k column."""
    if (row_ids is None) != (col_ids is None):
        raise ValueError("row_ids and col_ids must be given together")
    if row_ids is None:
        return ()
    for name, x, n, what in (("row_ids", row_ids, q_len, "q_len"),
                             ("col_ids", col_ids, kv_len, "kv_len")):
        if tuple(x.shape) != (n,):
            raise ValueError(
                f"{name} shape {tuple(x.shape)} != ({what},) = ({n},)")
    return (row_ids, col_ids)


def _check_flat(qf, kf, vf, h, row_ids, col_ids, *extra):
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
    ids = _check_ids(row_ids, col_ids, qf.shape[1], kf.shape[1])
    return _kernel_device((qf, kf, vf, *extra[:1]), (*extra[1:], *ids),
                          qf.shape[2] // h)


def _check_bhsd(q, k, v, row_ids, col_ids, *extra):
    if q.ndim != 3 or k.ndim != 3 or k.shape != v.shape or \
            q.shape[2] != k.shape[2]:
        raise ValueError(
            f"expected q [B*H, Sq, D] and k, v [B*Hkv, Sk, D]; got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )
    if q.shape[0] % k.shape[0]:
        raise ValueError(
            f"q rows {q.shape[0]} not a multiple of the kv rows {k.shape[0]}"
        )
    ids = _check_ids(row_ids, col_ids, q.shape[1], k.shape[1])
    return _kernel_device((q, k, v, *extra[:1]), (*extra[1:], *ids),
                          q.shape[2])


def _launch(name: str, device, *args, heads=None) -> None:
    fn = _build.kernel(name)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        _build.check(name, fn(*args, stream))
    LAUNCHES[name] += 1
    if heads is not None:
        key = f"{name} {heads[0]}/{heads[1]}"
        LAUNCH_HEADS[key] = LAUNCH_HEADS.get(key, 0) + 1


# The two forward kernels are operators of their own (``torch.library``),
# so that a selective activation checkpoint can keep their (out, lse)
# and replay them in its recompute instead of launching the kernel again
# (``models/llama.py:remat_policy_for``, the "dots" policy: JAX names
# these residuals for its checkpoint policy, ``ATTN_OUT_NAME`` and
# ``ATTN_LSE_NAME``). Each launches, and counts, as its wrapper did.
@torch.library.custom_op(
    "mpi_operator_tpu_torch::flash_fwd", mutates_args=(),
    schema="(Tensor qf, Tensor kf, Tensor vf, Tensor? row_ids, "
           "Tensor? col_ids, int h, float sm_scale, bool causal) "
           "-> (Tensor, Tensor)")
def _flash_fwd_op(qf, kf, vf, row_ids, col_ids, h, sm_scale, causal):
    device = qf.device  # checked by flash_fwd
    if device.type == "cpu":
        return flash_fwd_plain(qf, kf, vf, h, sm_scale, causal, row_ids,
                               col_ids)
    b, q_len, kv_len, d, h_kv = _geometry(qf, kf, h)
    dp = _launch_head_dim(qf.dtype, d)
    qf, kf, vf = (_dense(_pad_head_dim(t, d, dp)) for t in (qf, kf, vf))
    out = torch.empty_like(qf)
    lse = torch.empty(b, q_len, h, dtype=torch.float32, device=device)
    id_ptrs, _ids = _id_pointers(row_ids, col_ids)
    _launch(
        "flash_fwd", device, qf.data_ptr(), kf.data_ptr(), vf.data_ptr(), out.data_ptr(),
        lse.data_ptr(), *id_ptrs, b, q_len, kv_len, h, h_kv, dp,
        float(sm_scale), int(causal), int(qf.dtype == torch.bfloat16),
        heads=(h, h_kv),
    )
    return _cut_head_dim(out, dp, d), lse


@_flash_fwd_op.register_fake
def _flash_fwd_fake(qf, kf, vf, row_ids, col_ids, h, sm_scale, causal):
    return (torch.empty_like(qf),
            qf.new_empty((qf.shape[0], qf.shape[1], h), dtype=torch.float32))


def flash_fwd(qf, kf, vf, h: int, sm_scale: float, causal: bool,
              row_ids=None, col_ids=None):
    """Forward kernel: (out [B, Sq, H*D] like q, lse f32 [B, Sq, H]); with
    ids a pair is visible iff ``col_ids[col] <= row_ids[row]``."""
    _check_flat(qf, kf, vf, h, row_ids, col_ids)
    return _flash_fwd_op(qf, kf, vf, row_ids, col_ids, int(h),
                         float(sm_scale), bool(causal))


def _bwd_operands(qf, kf, vf, do, lse, delta, d: int):
    """The backward kernels' operands, q, k, v and do padded to the
    launch's head dim (returned last)."""
    dp = _launch_head_dim(qf.dtype, d)
    return (
        *(_dense(_pad_head_dim(t, d, dp)) for t in (qf, kf, vf, do)),
        lse.float().contiguous(), delta.float().contiguous(), dp,
    )


def flash_bwd_dq(qf, kf, vf, do, lse, delta, h: int, sm_scale: float,
                 causal: bool, row_ids=None, col_ids=None):
    """dq kernel: dq [B, Sq, H*D] like q."""
    device = _check_flat(qf, kf, vf, h, row_ids, col_ids, do, lse, delta)
    if device.type == "cpu":
        return flash_bwd_dq_plain(qf, kf, vf, do, lse, delta, h, sm_scale,
                                  causal, row_ids, col_ids)
    b, q_len, kv_len, d, h_kv = _geometry(qf, kf, h)
    qf, kf, vf, do, lse, delta, dp = _bwd_operands(qf, kf, vf, do, lse,
                                                   delta, d)
    dq = torch.empty_like(qf)
    id_ptrs, _ids = _id_pointers(row_ids, col_ids)
    _launch(
        "flash_bwd_dq", device, qf.data_ptr(), kf.data_ptr(), vf.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), *id_ptrs, b, q_len,
        kv_len, h, h_kv, dp, float(sm_scale), int(causal),
        int(qf.dtype == torch.bfloat16), heads=(h, h_kv),
    )
    return _cut_head_dim(dq, dp, d)


def flash_bwd_dkv(qf, kf, vf, do, lse, delta, h: int, sm_scale: float,
                  causal: bool, row_ids=None, col_ids=None):
    """dkv kernel: (dk, dv) [B, Sk, Hkv*D] like k, v."""
    device = _check_flat(qf, kf, vf, h, row_ids, col_ids, do, lse, delta)
    if device.type == "cpu":
        return flash_bwd_dkv_plain(qf, kf, vf, do, lse, delta, h, sm_scale,
                                   causal, row_ids, col_ids)
    b, q_len, kv_len, d, h_kv = _geometry(qf, kf, h)
    qf, kf, vf, do, lse, delta, dp = _bwd_operands(qf, kf, vf, do, lse,
                                                   delta, d)
    dk = torch.empty_like(kf)
    dv = torch.empty_like(vf)
    id_ptrs, _ids = _id_pointers(row_ids, col_ids)
    _launch(
        "flash_bwd_dkv", device, qf.data_ptr(), kf.data_ptr(), vf.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), *id_ptrs, b,
        q_len, kv_len, h, h_kv, dp, float(sm_scale), int(causal),
        int(qf.dtype == torch.bfloat16), heads=(h, h_kv),
    )
    return _cut_head_dim(dk, dp, d), _cut_head_dim(dv, dp, d)


def _id_pointers(row_ids, col_ids):
    """int32 copies of the ids for the kernels (None -> NULL). They stay
    alive past the launch as far as the kernel needs: the caching
    allocator reuses their memory only for later work on this stream."""
    if row_ids is None:
        return (None, None), ()
    ids = tuple(t.to(torch.int32).contiguous() for t in (row_ids, col_ids))
    return tuple(t.data_ptr() for t in ids), ids


@torch.library.custom_op(
    "mpi_operator_tpu_torch::flash_bhsd_fwd", mutates_args=(),
    schema="(Tensor q, Tensor k, Tensor v, Tensor? row_ids, "
           "Tensor? col_ids, float sm_scale, bool causal) "
           "-> (Tensor, Tensor)")
def _flash_bhsd_fwd_op(q, k, v, row_ids, col_ids, sm_scale, causal):
    device = q.device  # checked by flash_bhsd_fwd
    if device.type == "cpu":
        return flash_bhsd_fwd_plain(q, k, v, sm_scale, causal, row_ids,
                                    col_ids)
    d = q.shape[2]
    dp = _launch_head_dim(q.dtype, d)
    q, k, v = (_dense(_pad_head_dim(t, d, dp)) for t in (q, k, v))
    out = torch.empty_like(q)
    lse = torch.empty(q.shape[:2], dtype=torch.float32, device=device)
    id_ptrs, _ids = _id_pointers(row_ids, col_ids)
    _launch(
        "flash_bhsd_fwd", device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
        out.data_ptr(), lse.data_ptr(), *id_ptrs, q.shape[0], k.shape[0],
        q.shape[1], k.shape[1], dp, float(sm_scale), int(causal),
        int(q.dtype == torch.bfloat16),
    )
    return _cut_head_dim(out, dp, d), lse


@_flash_bhsd_fwd_op.register_fake
def _flash_bhsd_fwd_fake(q, k, v, row_ids, col_ids, sm_scale, causal):
    return torch.empty_like(q), q.new_empty(q.shape[:2], dtype=torch.float32)


def flash_bhsd_fwd(q, k, v, sm_scale: float, causal: bool, row_ids=None,
                   col_ids=None):
    """[B*H, S, D] forward kernel: (out like q, lse f32 [B*H, Sq]). q row
    r reads kv row r // (B*H / B*Hkv); with ids a pair is visible iff
    ``col_ids[col] <= row_ids[row]``."""
    _check_bhsd(q, k, v, row_ids, col_ids)
    return _flash_bhsd_fwd_op(q, k, v, row_ids, col_ids, float(sm_scale),
                              bool(causal))


# The forward kernels' operators, whose outputs the "dots" remat policy
# keeps.
FORWARD_OPS = (torch.ops.mpi_operator_tpu_torch.flash_fwd.default,
               torch.ops.mpi_operator_tpu_torch.flash_bhsd_fwd.default)


def flash_bhsd_bwd_dq(q, k, v, do, lse, delta, sm_scale: float,
                      causal: bool, row_ids=None, col_ids=None):
    """[B*H, S, D] dq kernel: dq like q."""
    device = _check_bhsd(q, k, v, row_ids, col_ids, do, lse, delta)
    if device.type == "cpu":
        return flash_bhsd_bwd_dq_plain(q, k, v, do, lse, delta, sm_scale,
                                       causal, row_ids, col_ids)
    d = q.shape[2]
    q, k, v, do, lse, delta, dp = _bwd_operands(q, k, v, do, lse, delta, d)
    dq = torch.empty_like(q)
    id_ptrs, _ids = _id_pointers(row_ids, col_ids)
    _launch(
        "flash_bhsd_bwd_dq", device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
        do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
        *id_ptrs, q.shape[0], k.shape[0], q.shape[1], k.shape[1], dp,
        float(sm_scale), int(causal), int(q.dtype == torch.bfloat16),
    )
    return _cut_head_dim(dq, dp, d)


def flash_bhsd_bwd_dkv(q, k, v, do, lse, delta, sm_scale: float,
                       causal: bool, row_ids=None, col_ids=None):
    """[B*H, S, D] dkv kernel: (dk, dv) like k, v."""
    device = _check_bhsd(q, k, v, row_ids, col_ids, do, lse, delta)
    if device.type == "cpu":
        return flash_bhsd_bwd_dkv_plain(q, k, v, do, lse, delta, sm_scale,
                                        causal, row_ids, col_ids)
    d = q.shape[2]
    q, k, v, do, lse, delta, dp = _bwd_operands(q, k, v, do, lse, delta, d)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    id_ptrs, _ids = _id_pointers(row_ids, col_ids)
    _launch(
        "flash_bhsd_bwd_dkv", device, q.data_ptr(), k.data_ptr(),
        v.data_ptr(), do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), *id_ptrs, q.shape[0], k.shape[0],
        q.shape[1], k.shape[1], dp, float(sm_scale), int(causal),
        int(q.dtype == torch.bfloat16),
    )
    return _cut_head_dim(dk, dp, d), _cut_head_dim(dv, dp, d)


# ---------------------------------------------------------------------------
# The differentiable ops
# ---------------------------------------------------------------------------


def flat_delta(do, out, h: int, dlse=None):
    """delta = rowsum(do * o) per head, straight into the f32 [B, S, H]
    layout the flat backward kernels read, less the lse cotangent when
    there is one (it enters every ds of its row as -delta does): a plain
    reduction, outside the kernels as in JAX."""
    b, q_len, hd = out.shape
    delta = (do.float() * out.float()).reshape(b, q_len, h, hd // h).sum(-1)
    return delta if dlse is None else delta - dlse.float()


def _flat_grads(ctx, do, dlse):
    """The backward of both flat ops (``_flash_flat_bwd_impl``): delta,
    then the dq and dkv kernels recomputing p from the saved lse."""
    qf, kf, vf, out, lse, row_ids, col_ids = ctx.saved_tensors
    delta = flat_delta(do, out, ctx.h, dlse)
    args = (ctx.h, ctx.sm_scale, ctx.causal, row_ids, col_ids)
    dq = flash_bwd_dq(qf, kf, vf, do, lse, delta, *args)
    dk, dv = flash_bwd_dkv(qf, kf, vf, do, lse, delta, *args)
    return dq, dk, dv


class _FlashFlat(torch.autograd.Function):
    """``_flash_flat``'s custom VJP (``_flash_flat_fwd_impl`` and
    ``_flash_flat_bwd_impl`` in JAX): the forward kernel, then the dq and
    dkv kernels recomputing p from the saved lse."""

    @staticmethod
    def forward(ctx, qf, kf, vf, h, sm_scale, causal):
        out, lse = flash_fwd(qf, kf, vf, h, sm_scale, causal)
        ctx.save_for_backward(qf, kf, vf, out, lse, None, None)
        ctx.h, ctx.sm_scale, ctx.causal = h, sm_scale, causal
        return out

    @staticmethod
    def backward(ctx, do):
        return (*_flat_grads(ctx, do, None), None, None, None)


class _FlashFlatLse(torch.autograd.Function):
    """``_flash_flat_lse``'s custom VJP: (out, lse), both differentiable;
    the ids get no gradient."""

    @staticmethod
    def forward(ctx, qf, kf, vf, row_ids, col_ids, h, sm_scale, causal):
        out, lse = flash_fwd(qf, kf, vf, h, sm_scale, causal, row_ids,
                             col_ids)
        ctx.save_for_backward(qf, kf, vf, out, lse, row_ids, col_ids)
        ctx.h, ctx.sm_scale, ctx.causal = h, sm_scale, causal
        return out, lse

    @staticmethod
    def backward(ctx, do, dlse):
        return (*_flat_grads(ctx, do, dlse), None, None, None, None, None)


def _flat_views(q, k, v, name: str):
    """Checks of the public [B, S, H, D] entry points, then the flat
    [B, S, H*D] views of q, k, v (free: H and D are contiguous)."""
    if q.ndim != 4:
        raise ValueError(f"expected [B, S, H, D] inputs, got rank {q.ndim}")
    b, q_len, h, d = q.shape
    if h % k.shape[2]:
        raise ValueError(f"q heads {h} not a multiple of kv heads {k.shape[2]}")
    if h > 128:
        raise ValueError(
            f"{name} lane-packs per-head stats (<=128 heads); got {h} — use "
            f"flash_attention for wider models"
        )
    return [x.reshape(b, x.shape[1], x.shape[2] * d) for x in (q, k, v)]


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
    <= 1024, past 256 each head's columns split across a cluster of
    blocks, ``flash_split_plan``; in bfloat16 a head dim that is not a
    multiple of 8 is padded with zero columns around the launch); tensors
    on the CPU through the plain versions, at any head dim.
    """
    qf, kf, vf = _flat_views(q, k, v, "flash_attention_bshd")
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    return _FlashFlat.apply(qf, kf, vf, q.shape[2], sm_scale,
                            causal).reshape(q.shape)


def flash_attention_bshd_lse(q, k, v, *, row_ids=None, col_ids=None,
                             causal: bool = False,
                             sm_scale: Optional[float] = None):
    """Projection-layout flash attention returning ``(out, lse)``:
    :func:`flash_attention_lse`'s flat twin (q [B, Sq, H, D]; k, v
    [B, Sk, Hkv, D] -> out [B, Sq, H, D], lse f32 [B, Sq, H]), the
    building block of the ring's per-hop partials.

    ``row_ids``/``col_ids`` (1-D int, the global positions of the q rows
    / k columns) switch masking to ``col_id <= row_id`` over any position
    labeling (ring hops, zigzag layouts); without them ``causal`` applies
    the bottom-right-aligned mask. A fully masked row gives out = 0,
    lse = NEG_INF. Differentiable in q, k, v and lse (the lse cotangent
    folds into the backward kernels' delta)."""
    qf, kf, vf = _flat_views(q, k, v, "flash_attention_bshd_lse")
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    out, lse = _FlashFlatLse.apply(qf, kf, vf, row_ids, col_ids, q.shape[2],
                                   sm_scale, causal)
    return out.reshape(q.shape), lse


def _bhsd_grads(ctx, do, dlse):
    """The backward of both [B*H, S, D] ops (``_flash_bwd_impl``): delta =
    rowsum(do * o), less the lse cotangent when there is one (it enters
    every ds of its row as -delta does), then the dq and dkv kernels."""
    q, k, v, out, lse, row_ids, col_ids = ctx.saved_tensors
    delta = (do.float() * out.float()).sum(-1)
    if dlse is not None:
        delta = delta - dlse.float()
    args = (ctx.sm_scale, ctx.causal, row_ids, col_ids)
    dq = flash_bhsd_bwd_dq(q, k, v, do, lse, delta, *args)
    dk, dv = flash_bhsd_bwd_dkv(q, k, v, do, lse, delta, *args)
    return dq, dk, dv


class _FlashBhsd(torch.autograd.Function):
    """``_flash``'s custom VJP: the [B*H, S, D] forward kernel, then the
    dq and dkv kernels recomputing p from the saved lse."""

    @staticmethod
    def forward(ctx, q, k, v, sm_scale, causal):
        out, lse = flash_bhsd_fwd(q, k, v, sm_scale, causal)
        ctx.save_for_backward(q, k, v, out, lse, None, None)
        ctx.sm_scale, ctx.causal = sm_scale, causal
        return out

    @staticmethod
    def backward(ctx, do):
        return (*_bhsd_grads(ctx, do, None), None, None)


class _FlashBhsdLse(torch.autograd.Function):
    """``_flash_lse``'s custom VJP: (out, lse), both differentiable; the
    ids get no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, row_ids, col_ids, sm_scale, causal):
        out, lse = flash_bhsd_fwd(q, k, v, sm_scale, causal, row_ids,
                                  col_ids)
        ctx.save_for_backward(q, k, v, out, lse, row_ids, col_ids)
        ctx.sm_scale, ctx.causal = sm_scale, causal
        return out, lse

    @staticmethod
    def backward(ctx, do, dlse):
        return (*_bhsd_grads(ctx, do, dlse), None, None, None, None)


def _bhsd_rows(q, k, v):
    """Checks of the public [B, H, S, D] entry points, then the
    [B*H, S, D] views of q, k, v (a copy when the caller handed in a
    transposed view: the layout cost this path exists to show)."""
    if q.ndim != 4:
        raise ValueError(f"expected [B, H, S, D] inputs, got rank {q.ndim}")
    b, h, _, d = q.shape
    if h % k.shape[1]:
        raise ValueError(f"q heads {h} not a multiple of kv heads {k.shape[1]}")
    return [x.reshape(b * x.shape[1], x.shape[2], d) for x in (q, k, v)]


def flash_attention(q, k, v, *, causal: bool = False,
                    sm_scale: Optional[float] = None):
    """Flash attention. q [B, H, Sq, D]; k, v [B, Hkv, Sk, D] ->
    [B, H, Sq, D].

    Hkv may divide H (grouped-query attention): kv heads are shared by
    H/Hkv query heads through the kernels' indexing, never expanded.
    Causal masking is bottom-right aligned; a row that sees no key gives
    0. Differentiable: the backward runs the dq and dkv kernels. Tensors
    on a CUDA device go through the [B*H, S, D] kernels (bfloat16 or
    float32, head_dim <= 1024, past 256 split across a cluster of blocks;
    in bfloat16 a head dim that is not a multiple of 8 is padded with zero
    columns around the launch); tensors on the CPU through their plain
    versions, at any head dim."""
    qr, kr, vr = _bhsd_rows(q, k, v)
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    return _FlashBhsd.apply(qr, kr, vr, sm_scale, causal).reshape(q.shape)


def flash_attention_lse(q, k, v, *, row_ids=None, col_ids=None,
                        causal: bool = False,
                        sm_scale: Optional[float] = None):
    """Flash attention returning ``(out, lse)``, out [B, H, Sq, D] and
    lse f32 [B, H, Sq] -- the building block of ring attention's per-hop
    partials, which merge through lse.

    ``row_ids``/``col_ids`` (1-D int, the global positions of the q rows
    / k columns) switch masking to ``col_id <= row_id``, causal attention
    over any position labeling (ring hops, zigzag layouts); without ids
    ``causal`` applies the bottom-right-aligned mask. A fully masked row
    gives out = 0, lse = NEG_INF. Differentiable in q, k, v and lse (the
    lse cotangent folds into the backward kernels' delta). The ids are
    checked (given together, one per row / column) by the kernel
    wrapper."""
    qr, kr, vr = _bhsd_rows(q, k, v)
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    out, lse = _FlashBhsdLse.apply(qr, kr, vr, row_ids, col_ids, sm_scale,
                                   causal)
    return out.reshape(q.shape), lse.reshape(q.shape[:3])
