"""Ring attention and the attention dispatch for model code (port of
``mpi_operator_tpu/ops/ring_attention.py``).

Sequence parallelism over the ``sp`` process group: each rank keeps its
q shard and the k/v shards travel around the ring (rank i sends to
i + 1 and receives from i - 1, ``parallel.sharding.ring_pass``). Every
hop is one flash call over the local q and the visiting k/v, with the
global positions of both as row/col ids, so one kernel serves the
contiguous layout and the zigzag one (rank i holds chunks i and
2n - 1 - i of 2n, which balances causal work across the ring). The
hops' partial outputs merge in f32 by their logsumexp:
``lse' = logaddexp(lse, lse_t)``, ``o' = o e^{lse - lse'} + o_t
e^{lse_t - lse'}``, one softmax over the whole row.

The backward is the ring's own (:class:`_Ring`), as FlashAttention's
ring backward: the k/v shards circulate again with their dk/dv
accumulators travelling beside them, and each hop runs the dq and dk/dv
kernels with that hop's ids, the merged output's lse and ``delta =
rowsum(do * o)`` of the merged output. A rank never holds more than one
foreign k/v shard and its accumulators; the gradients are those of
JAX's autodiff through its scan of hops.

Two layouts, as the single-device kernels: :func:`ring_attention_bshd`
on the projection layout [B, S, H, D] (the flat kernels, what the
models run) and :func:`ring_attention` on [B, H, S, D] (the [B*H, S, D]
kernels). Ulysses is ``ops/ulysses.py``.

The dispatch (:func:`sp_attention_bshd`, :func:`sp_attention`): one
device runs ``flash`` (projection-layout kernels), ``flash-bhsd`` (the
layout A/B) or ``dense`` (the plain oracle); ``ring`` and ``ulysses`` need
the sp group. The JAX pipeline's in-stage names ``ring-shard`` and
``ulysses-shard`` (the per-shard kernels inside its manual region) are
the same ring and Ulysses here: the port's models already hold their
local shard and run over the caller's sp group.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..parallel.sharding import ring_pass
from .attention import (
    NEG_INF,
    attention_reference,
    flash_attention,
    flash_attention_bshd,
    flash_attention_bshd_lse,
    flash_attention_lse,
    flash_bhsd_bwd_dkv,
    flash_bhsd_bwd_dkv_plain,
    flash_bhsd_bwd_dq,
    flash_bhsd_bwd_dq_plain,
    flash_bwd_dkv,
    flash_bwd_dq,
)

# The JAX pipeline's in-stage names for the sequence-parallel impls.
_SHARD_IMPLS = {"ring-shard": "ring", "ulysses-shard": "ulysses"}


# ---------------------------------------------------------------------------
# Zigzag layout
# ---------------------------------------------------------------------------


def zigzag_indices(seq_len: int, n: int) -> np.ndarray:
    """Permutation p with ``x_zig = x[..., p]``: chunk pairs (i, 2n-1-i)
    land on rank i, so every rank holds one early and one late chunk and
    causal work is balanced across the ring."""
    if seq_len % (2 * n):
        raise ValueError(f"seq_len {seq_len} not divisible by 2*{n}")
    ids = np.arange(seq_len).reshape(2 * n, seq_len // (2 * n))
    order = [c for i in range(n) for c in (i, 2 * n - 1 - i)]
    return ids[order].reshape(-1)


def zigzag_inverse(seq_len: int, n: int) -> np.ndarray:
    """Inverse permutation: ``x == x_zig[..., zigzag_inverse(S, n)]``."""
    perm = zigzag_indices(seq_len, n)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(seq_len)
    return inv


def _shard_ids(idx: int, n: int, s_loc: int, zigzag: bool,
               device=None) -> torch.Tensor:
    """Global sequence positions (int32) of the s_loc rows ring rank
    ``idx`` holds: one run, or with ``zigzag`` two half-chunk runs (idx
    and 2n-1-idx)."""
    if not zigzag:
        return torch.arange(idx * s_loc, (idx + 1) * s_loc,
                            dtype=torch.int32, device=device)
    half = s_loc // 2
    return torch.cat([
        torch.arange(idx * half, (idx + 1) * half, dtype=torch.int32,
                     device=device),
        torch.arange((2 * n - 1 - idx) * half, (2 * n - idx) * half,
                     dtype=torch.int32, device=device),
    ])


# ---------------------------------------------------------------------------
# Per-hop partials
# ---------------------------------------------------------------------------


def _dense_partial(q, k, v, row, col, causal, sm_scale):
    """Oracle per-hop partial on [B, H, S, D]: dense f32 scores
    (O(S_local^2) memory), (o f32, lse f32 [B, H, S]); a row that sees
    nothing gives 0 and NEG_INF. The reference the flash hop is held
    against, and the ring's ``impl='dense'``."""
    b, h, s_loc, d = q.shape
    h_kv = k.shape[1]
    qf = q.float().reshape(b, h_kv, h // h_kv, s_loc, d)
    s = torch.einsum("bhgqd,bhkd->bhgqk", qf, k.float()) * sm_scale
    if causal:
        mask = col.to(q.device)[None, :] <= row.to(q.device)[:, None]
        s = torch.where(mask, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True).clamp_min(NEG_INF)
    p = torch.exp(s - m)
    if causal:
        p = torch.where(mask, p, 0.0)
    l = p.sum(dim=-1, keepdim=True)
    safe = torch.where(l > 0.0, l, 1.0)
    o = torch.einsum("bhgqk,bhkd->bhgqd", p, v.float()) / safe
    lse = torch.where(l > 0.0, m + torch.log(safe), NEG_INF)
    return o.reshape(b, h, s_loc, d), lse.reshape(b, h, s_loc)


def _flash_partial(q, k, v, row, col, causal, sm_scale):
    """Per-hop partial on [B, H, S, D] through the [B*H, S, D] kernels
    (:func:`flash_attention_lse`): with ids when causal, none (and no
    mask) otherwise. (o f32, lse f32 [B, H, S])."""
    ids = dict(row_ids=row, col_ids=col) if causal else {}
    out, lse = flash_attention_lse(q, k, v, sm_scale=sm_scale, **ids)
    return out.float(), lse


def _flat_partial(q, k, v, row, col, causal, sm_scale):
    """Per-hop partial on [B, S, H, D] through the flat kernels
    (:func:`flash_attention_bshd_lse`). (o f32, lse f32 [B, S, H])."""
    ids = dict(row_ids=row, col_ids=col) if causal else {}
    out, lse = flash_attention_bshd_lse(q, k, v, sm_scale=sm_scale, **ids)
    return out.float(), lse


def _bhsd_rows(*xs):
    return [x.reshape(-1, *x.shape[2:]) for x in xs]


def _bhsd_hop_grads(q, k, v, do, lse, delta, row, col, causal, sm_scale,
                    dense=False):
    """One hop's (dq, dk, dv) on [B, H, S, D] through the [B*H, S, D]
    kernels (their plain versions with ``dense``), p recomputed from the
    merged lse."""
    dq_fn, dkv_fn = ((flash_bhsd_bwd_dq_plain, flash_bhsd_bwd_dkv_plain)
                     if dense else (flash_bhsd_bwd_dq, flash_bhsd_bwd_dkv))
    qr, kr, vr, dor = _bhsd_rows(q, k, v, do)
    lr, dr = lse.reshape(qr.shape[:2]), delta.reshape(qr.shape[:2])
    ids = (row, col) if causal else (None, None)
    dq = dq_fn(qr, kr, vr, dor, lr, dr, sm_scale, False, *ids)
    dk, dv = dkv_fn(qr, kr, vr, dor, lr, dr, sm_scale, False, *ids)
    return dq.reshape(q.shape), dk.reshape(k.shape), dv.reshape(v.shape)


def _flat_hop_grads(q, k, v, do, lse, delta, row, col, causal, sm_scale):
    """One hop's (dq, dk, dv) on [B, S, H, D] through the flat kernels."""
    b, s, h, _ = q.shape
    qf, kf, vf, dof = (x.reshape(b, x.shape[1], -1) for x in (q, k, v, do))
    ids = (row, col) if causal else (None, None)
    dq = flash_bwd_dq(qf, kf, vf, dof, lse, delta, h, sm_scale, False, *ids)
    dk, dv = flash_bwd_dkv(qf, kf, vf, dof, lse, delta, h, sm_scale, False,
                           *ids)
    return dq.reshape(q.shape), dk.reshape(k.shape), dv.reshape(v.shape)


# layout -> (per-hop partial, per-hop gradients, the sequence dim).
_LAYOUTS = {
    "bhsd": (_flash_partial, _bhsd_hop_grads, 2),
    "bhsd-dense": (_dense_partial,
                   lambda *a: _bhsd_hop_grads(*a, dense=True), 2),
    "bshd": (_flat_partial, _flat_hop_grads, 1),
}


# ---------------------------------------------------------------------------
# The ring
# ---------------------------------------------------------------------------


class _Ring(torch.autograd.Function):
    """The ring's forward (hops merged by lse) and its own backward (the
    k/v shards and their dk/dv accumulators circulating once more)."""

    @staticmethod
    def forward(ctx, q, k, v, group, layout, causal, sm_scale, zigzag):
        import torch.distributed as dist

        partial, _, seq_dim = _LAYOUTS[layout]
        n, my = dist.get_world_size(group), dist.get_rank(group)
        s_loc = q.shape[seq_dim]
        row = _shard_ids(my, n, s_loc, zigzag, q.device)
        o = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        lse = torch.full(q.shape[:-1], NEG_INF, dtype=torch.float32,
                         device=q.device)
        k_cur, v_cur = k, v
        for t in range(n):
            # k_cur originated on rank (my - t) mod n.
            col = _shard_ids((my - t) % n, n, s_loc, zigzag, q.device)
            o_t, lse_t = partial(q, k_cur, v_cur, row, col, causal, sm_scale)
            lse_new = torch.logaddexp(lse, lse_t)
            o = (o * torch.exp(lse - lse_new)[..., None]
                 + o_t * torch.exp(lse_t - lse_new)[..., None])
            lse = lse_new
            if t < n - 1:
                k_cur, v_cur = ring_pass([k_cur, v_cur], group)
        out = o.to(q.dtype)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (group, layout, causal, sm_scale, zigzag)
        return out

    @staticmethod
    def backward(ctx, do):
        import torch.distributed as dist

        q, k, v, out, lse = ctx.saved_tensors
        group, layout, causal, sm_scale, zigzag = ctx.args
        _, hop_grads, seq_dim = _LAYOUTS[layout]
        n, my = dist.get_world_size(group), dist.get_rank(group)
        s_loc = q.shape[seq_dim]
        row = _shard_ids(my, n, s_loc, zigzag, q.device)
        do = do.to(q.dtype).contiguous()
        # Of the merged output, in the stats' layout ([B, H, S] or
        # [B, S, H]); the same for every hop.
        delta = (do.float() * out.float()).sum(-1)
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        k_cur, v_cur = k, v
        dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
        dv = torch.zeros_like(dk)
        for t in range(n):
            col = _shard_ids((my - t) % n, n, s_loc, zigzag, q.device)
            dq_t, dk_t, dv_t = hop_grads(q, k_cur, v_cur, do, lse, delta,
                                         row, col, causal, sm_scale)
            dq += dq_t.float()
            dk += dk_t.float()
            dv += dv_t.float()
            # The accumulators follow their shard; after the last hop
            # they go home (the next rank owns the shard held now).
            if t < n - 1:
                k_cur, v_cur, dk, dv = ring_pass([k_cur, v_cur, dk, dv],
                                                 group)
            else:
                dk, dv = ring_pass([dk, dv], group)
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype),
                None, None, None, None, None)


def _check_heads(h: int, h_kv: int) -> None:
    if h % h_kv:
        raise ValueError(f"q heads {h} not a multiple of kv heads {h_kv}")


def ring_attention(q, k, v, group, *, causal: bool = False,
                   sm_scale: Optional[float] = None, zigzag: bool = False,
                   impl: str = "flash"):
    """Ring attention on this rank's shards over the process ``group``:
    q [B, H, S_local, D]; k, v [B, Hkv, S_local, D]. The global sequence
    is the concatenation over the group's ranks (contiguous: rank i holds
    rows [i*S_local, (i+1)*S_local)); with ``zigzag`` rank i holds chunks
    i and 2n-1-i of 2n. Returns this rank's output shard, like q.
    ``impl='dense'`` runs the hops on the plain oracle instead of the
    [B*H, S, D] kernels. Differentiable."""
    if impl not in ("flash", "dense"):
        raise ValueError(f"impl must be 'flash' or 'dense', got {impl!r}")
    _check_heads(q.shape[1], k.shape[1])
    if zigzag and q.shape[2] % 2:
        raise ValueError(f"zigzag needs an even local seq, got {q.shape[2]}")
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    layout = "bhsd" if impl == "flash" else "bhsd-dense"
    return _Ring.apply(q, k, v, group, layout, causal, sm_scale, zigzag)


def ring_attention_bshd(q, k, v, group, *, causal: bool = False,
                        sm_scale: Optional[float] = None,
                        zigzag: bool = False):
    """Ring attention over the PROJECTION layout, the sequence-parallel
    twin of ``attention.flash_attention_bshd``: q [B, S_local, H, D];
    k, v [B, S_local, Hkv, D], sequence-sharded over ``group``
    (contiguous, or zigzag chunk pairs). Every hop is the flat kernel and
    the merge runs on [B, S, H] lse: no layout change anywhere on the
    path. Differentiable."""
    _check_heads(q.shape[2], k.shape[2])
    if zigzag and q.shape[1] % 2:
        raise ValueError(f"zigzag needs an even local seq, got {q.shape[1]}")
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    return _Ring.apply(q, k, v, group, "bshd", causal, sm_scale, zigzag)


# ---------------------------------------------------------------------------
# Dispatch
# ---------------------------------------------------------------------------


def _need_group(impl: str, group) -> None:
    if group is None:
        raise ValueError(f"attention_impl={impl!r} needs a mesh with an sp "
                         f"axis")


def sp_attention_bshd(q, k, v, impl: str, *, causal: bool, group=None,
                      zigzag: bool = False):
    """Projection-layout dispatch on the raw [B, S, H, D] projections.

    'flash' runs the flat kernel; 'ring' and 'ulysses' their
    sequence-parallel twins over the sp ``group`` (``zigzag``: the ring's
    layout). Returns ``None`` for the impls that live on the [B, H, S, D]
    path ('flash-bhsd', 'dense'): the caller then transposes and falls
    through to :func:`sp_attention`, which raises on unknown names."""
    impl = _SHARD_IMPLS.get(impl, impl)
    if impl == "flash":
        return flash_attention_bshd(q, k, v, causal=causal)
    if impl in ("ring", "ulysses"):
        _need_group(impl, group)
        if impl == "ulysses":
            from .ulysses import ulysses_attention_bshd

            return ulysses_attention_bshd(q, k, v, group, causal=causal)
        return ring_attention_bshd(q, k, v, group, causal=causal,
                                   zigzag=zigzag)
    return None


def sp_attention(q, k, v, impl: str, *, causal: bool, group=None,
                 zigzag: bool = False):
    """The [B, H, S, D] dispatch: 'flash'/'flash-bhsd' (the [B*H, S, D]
    kernels through :func:`flash_attention`; model code routes 'flash' to
    the projection-layout kernels before transposing, 'flash-bhsd' is the
    layout A/B), 'dense' (the plain oracle; GQA kv heads are expanded here
    since the reference has no grouped path), 'ring' (over the sp
    ``group``, honouring ``zigzag``) or 'ulysses' (the all-to-all
    strategy). Unknown names raise: a typo must not silently train the
    dense path."""
    impl = _SHARD_IMPLS.get(impl, impl)
    if impl in ("flash", "flash-bhsd"):
        return flash_attention(q, k, v, causal=causal)
    if impl == "dense":
        groups = q.shape[1] // k.shape[1]
        if groups > 1:
            k = torch.repeat_interleave(k, groups, dim=1)
            v = torch.repeat_interleave(v, groups, dim=1)
        return attention_reference(q, k, v, causal=causal)
    if impl in ("ring", "ulysses"):
        _need_group(impl, group)
        if impl == "ulysses":
            from .ulysses import ulysses_attention

            return ulysses_attention(q, k, v, group, causal=causal)
        return ring_attention(q, k, v, group, causal=causal, zigzag=zigzag)
    raise ValueError(
        f"unknown attention impl {impl!r}; want "
        f"flash|flash-bhsd|dense|ring|ulysses"
    )
