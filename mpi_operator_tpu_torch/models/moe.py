"""Sparse Mixture-of-Experts FFN with expert parallelism over an ``ep``
mesh axis (port of ``mpi_operator_tpu/models/moe.py``).

Routing is GShard's static-shape formulation, as in the JAX package:
top-k gates become a 0/1 ``dispatch`` and a gate-weighted ``combine``
tensor, and the experts run as products against them, with no
data-dependent gather.

Shapes (G groups = batch rows, S tokens a group, E experts, C capacity,
D model dim, F expert hidden dim):

    router probs    [G, S, E]     f32 softmax
    dispatch        [G, S, E, C]  0/1: token (g, s) -> slot (e, c)
    combine         [G, S, E, C]  dispatch x gate weight
    expert inputs   [E, G, C, D]  = einsum('gsec,gsd->egcd', dispatch, x)
    expert SwiGLU   [E, D, F] / [E, F, D] stacked weights
    output          [G, S, D]     = einsum('gsec,egcd->gsd', combine, h)

Capacity is per group: C = ceil(top_k * S / E * capacity_factor). A
choice that overflows its expert's slots is dropped (combine weight 0),
Switch semantics; the residual around the FFN carries the token on.
Every token's first choice claims a slot before any second choice.

The load-balance loss is Switch's ``E * sum_e f_e * p_e`` (f_e: the
share of tokens whose top-1 choice is e; p_e: the mean router
probability), 1.0 at perfect balance.

Expert and tensor parallelism: the expert weights may be DTensors
sharded on dim 0 over the ``ep`` axis and on the hidden dim F over the
``tp`` axis (``parallel/sharding.py:shard_experts``; the JAX rules'
``P(ep, fsdp, tp)``). Each rank then routes its batch rows over all E
experts, runs its E/ep experts on their slots with its F/tp columns of
the hidden layer (a SwiGLU is elementwise in F, and the down projection
sums over F) and combines them into a partial output; the partial
outputs are summed over the ep and the tp group in f32
(``sum_partials``), which is what GSPMD makes of the JAX package's
shardings (all-reduces, not an all-to-all). In the backward the
gradients of the expert branch's two inputs from the replicated part,
the tokens and the combine weights, are summed over the same groups
(``sum_grads``), as GSPMD's transposed products sum them: every rank
then holds the whole gradient of the router, the attention and the
embeddings, and each expert block's own.
"""

from __future__ import annotations

import math
from typing import Any, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.losses import HeadProduct
from ..utils import torchtrace

EXPERT_PARAMS = ("expert_wg", "expert_wu", "expert_wd")
# The dim of each that holds the expert hidden dim F (split over tp).
EXPERT_HIDDEN_DIM = {"expert_wg": 2, "expert_wu": 2, "expert_wd": 1}


def expert_capacity(tokens_per_group: int, n_experts: int, top_k: int,
                    capacity_factor: float) -> int:
    return max(1, math.ceil(top_k * tokens_per_group / n_experts
                            * capacity_factor))


def topk_gates(probs, top_k: int, *, normalize: bool = True):
    """Top-k selection and the gate-weight convention, shared by the
    training dispatch (:func:`routing`) and the decode path
    (``generate._moe_step``): returns (gates [..., K], idx [..., K],
    dense [..., E] combine weights). ``normalize=True`` is Mixtral's
    convention (the selected gates sum to 1)."""
    e = probs.shape[-1]
    gates, idx = torch.topk(probs, top_k, dim=-1)
    if normalize:
        gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    dense_w = (F.one_hot(idx, e).to(probs.dtype) * gates[..., None]).sum(-2)
    return gates, idx, dense_w


def routing(probs, top_k: int, capacity: int, *, normalize: bool = True):
    """Static-shape top-k routing -> (dispatch, combine, aux_loss).

    probs: [G, S, E] router probabilities (f32). Choice priority is
    k-major: every token's first choice claims its slot before any
    second choice, so a token's primary expert is the last to drop it.
    """
    g, s, e = probs.shape
    gates, idx, _ = topk_gates(probs, top_k, normalize=normalize)

    oh_k = F.one_hot(idx, e).float().transpose(1, 2)  # [G, K, S, E]
    # Slot assignment: the running count over (k, s) within each group.
    pos = torch.cumsum(oh_k.reshape(g, top_k * s, e), dim=1).reshape(
        g, top_k, s, e)
    pos_sel = ((pos - 1.0) * oh_k).sum(-1)  # [G, K, S]: slot in its expert
    made = oh_k.sum(-1) > 0  # [G, K, S]: a choice was made
    keep = (pos_sel < capacity) & made
    if torchtrace.ranges_armed():
        # The capacity's drops against the choices, on the device.
        torchtrace.add_count("moe.dropped", made & ~keep)
        torchtrace.add_count("moe.choices", made)
    # One-hot of the slot; a slot past the capacity has no column.
    slot = (pos_sel[..., None] == torch.arange(
        capacity, device=probs.device, dtype=pos_sel.dtype)).float()
    disp_k = (oh_k[..., None] * slot[..., None, :]
              * keep[..., None, None])  # [G, K, S, E, C]
    dispatch = disp_k.sum(1)
    gates_k = gates.transpose(1, 2)  # [G, K, S]
    combine = (disp_k * gates_k[..., None, None]).sum(1)

    # Switch load-balance loss on the top-1 choices.
    f = F.one_hot(idx[..., 0], e).float().mean(1)  # [G, E] share routed
    p = probs.mean(1)  # [G, E] mean probability
    aux = e * (f * p).sum(-1).mean()
    return dispatch, combine, aux


def _combine(combine, expert_out):
    """``einsum('gsec,egcd->gsd', combine, expert_out)`` with f32 results:
    bf16 operands through the bf16 x bf16 -> f32 product of the heads
    (``ops/losses.py:HeadProduct``, one product a group), as the
    reference's ``preferred_element_type=f32``; other dtypes as an f32
    product."""
    g, s, e, c = combine.shape
    a = combine.reshape(g, s, e * c)
    b = expert_out.transpose(0, 1).reshape(g, e * c, -1)
    if a.dtype == b.dtype == torch.bfloat16:
        return torch.stack([HeadProduct.apply(a[i], b[i]) for i in range(g)])
    return a.float() @ b.float()


class MoEMLP(nn.Module):
    """Drop-in replacement for the dense SwiGLU MLP: returns (out, aux).

    Parameters as in the Flax tree: ``router`` [D, E] and the stacked
    ``expert_wg``/``expert_wu`` [E, D, F] and ``expert_wd`` [E, F, D],
    all f32 and in the JAX layout (no transpose)."""

    def __init__(self, dim: int, ffn_dim: int, n_experts: int, *,
                 top_k: int = 2, capacity_factor: float = 1.25,
                 dtype: Any = torch.bfloat16,
                 combine_dtype: Optional[Any] = None, device=None):
        super().__init__()
        self.n_experts, self.top_k = n_experts, top_k
        self.capacity_factor = capacity_factor
        self.dtype = dtype
        # The combine weights' dtype in the output product: the compute
        # dtype by default (both operands bf16), f32 to keep them exact.
        self.combine_dtype = combine_dtype
        kw = dict(dtype=torch.float32, device=device)
        self.router = nn.Parameter(torch.empty(dim, n_experts, **kw))
        self.expert_wg = nn.Parameter(torch.empty(n_experts, dim, ffn_dim,
                                                  **kw))
        self.expert_wu = nn.Parameter(torch.empty(n_experts, dim, ffn_dim,
                                                  **kw))
        self.expert_wd = nn.Parameter(torch.empty(n_experts, ffn_dim, dim,
                                                  **kw))

    def local_experts(self):
        """(wg, wu, wd, groups, first): this rank's block of the expert
        weights, the process groups (ep, tp) its partial outputs are
        summed over (none when the experts are whole here) and the index
        of its first expert."""
        ws = [getattr(self, name) for name in EXPERT_PARAMS]
        if not hasattr(ws[0], "to_local"):  # whole, not a DTensor
            return (*ws, [], 0)
        mesh = ws[0].device_mesh
        local = [w.to_local() for w in ws]
        first = 0
        for dim, placement in enumerate(ws[0].placements):
            if placement.is_shard(0):  # the experts, over ep
                first = mesh.get_local_rank(dim) * local[0].shape[0]
        return (*local, [mesh.get_group(d) for d in range(mesh.ndim)],
                first)

    def forward(self, x):
        from ..parallel.sharding import sum_grads, sum_partials

        g, s, d = x.shape
        dtype = self.dtype
        cap = expert_capacity(s, self.n_experts, self.top_k,
                              self.capacity_factor)
        timed = torchtrace.timed_range
        with timed("moe") as moe:
            x = moe.enter(x)
            with timed("moe.route") as r:
                xr, router = r.enter(x, self.router)
                # Router in f32: a small product, and a bf16 softmax skews
                # balance.
                probs = torch.softmax(xr.float() @ router, dim=-1)
                dispatch, combine, aux = routing(probs, self.top_k, cap)
                dispatch = dispatch.to(dtype)
                combine, aux = r.leave(
                    combine.to(self.combine_dtype or dtype), aux)

            wg, wu, wd, groups, first = self.local_experts()
            wg, wu, wd = torchtrace.cast(dtype, wg, wu, wd)
            n = wg.shape[0]
            with timed("moe.dispatch") as r:
                xin = r.enter(x).to(dtype)
                for group in groups:
                    xin = sum_grads(xin, group)
                dispatch = dispatch[:, :, first:first + n]  # 0/1: no grad
                expert_in = r.leave(
                    torch.einsum("gsec,gsd->egcd", dispatch, xin))
            with timed("moe.experts") as r:
                expert_in, wg, wu, wd = r.enter(expert_in, wg, wu, wd)
                h = (F.silu(torch.einsum("egcd,edf->egcf", expert_in, wg))
                     * torch.einsum("egcd,edf->egcf", expert_in, wu))
                expert_out = r.leave(torch.einsum("egcf,efd->egcd", h, wd))
            with timed("moe.combine") as r:
                combine, expert_out = r.enter(combine, expert_out)
                for group in groups:
                    combine = sum_grads(combine, group)
                out = _combine(combine[:, :, first:first + n], expert_out)
                for group in groups:
                    # This rank's block's share of every token: summed in
                    # f32.
                    out = sum_partials(out, group)
                out = r.leave(out.to(x.dtype))
            return moe.leave(out, aux)
