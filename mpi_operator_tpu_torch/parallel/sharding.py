"""Batches and parameters on the mesh (port of
``mpi_operator_tpu/parallel/sharding.py``).

The JAX package annotates arrays with PartitionSpecs and lets GSPMD
insert the collectives. Here each process holds its part and the
collectives are explicit:

- the batch: this process's rows of the global batch (dp x fsdp split
  the batch dim; tp ranks hold the same rows), as ``batch_spec`` /
  ``shard_batch`` place them;
- the parameters: a model's tensor-parallel plan on the ``tp`` axis
  (DTensor ``ColwiseParallel``/``RowwiseParallel``), then FSDP2
  ``fully_shard`` per block and at the root over ``fsdp`` (with ``dp`` as
  well: HSDP on the 2-D mesh); with ``dp`` alone the parameters stay
  whole and :func:`average_gradients` averages the gradients over
  ``dp``;
- :func:`all_reduce_sum`, the autograd-aware sum across the world that
  the global-batch statistics take (BatchNorm's moments, BERT's MLM
  weight count), as GSPMD takes them over the global batch;
- the MoE experts: sharded on their expert dim over ``ep``
  (:func:`shard_experts`). An ep rank sees its dp row's batch and runs
  its experts; :func:`sum_partials` adds the ranks' partial outputs and
  :func:`sum_grads` the gradients of the expert branch's inputs, so that
  every ep rank holds the whole gradient of each parameter it holds
  whole and the gradients are averaged over dp alone, as GSPMD's
  gradients of these shardings are complete on every ep device.
"""

from __future__ import annotations

import re
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from .mesh import DP, EP, FSDP, TP, Mesh, batch_shards, world_size

# The models' FSDP units: transformer layers (``layer_i``, ``enc_i``,
# ``dec_i``) and ResNet's residual blocks (``stage{i}_block{j}``).
_BLOCK_NAME = re.compile(r"^(layer|enc|dec)_\d+$|^stage\d+_block\d+$")


def batch_index(mesh: Mesh) -> int:
    """This process's batch shard: its (dp, fsdp) coordinate, dp outer."""
    return mesh.coordinate(DP) * mesh.axis_size(FSDP) + mesh.coordinate(FSDP)


def local_rows(global_batch: int, mesh: Mesh, accum_steps: int = 1
               ) -> list[tuple[int, int]]:
    """The ``[lo, hi)`` row ranges of the global batch this process holds,
    in order. With ``accum_steps`` microbatches (global rows ``[i*B/A,
    (i+1)*B/A)`` each, as the JAX step splits the sharded global batch),
    each microbatch contributes its shard, so the local rows split into
    ``accum_steps`` equal parts are this process's part of each."""
    n, index = batch_shards(mesh), batch_index(mesh)
    if global_batch % (n * accum_steps):
        raise ValueError(
            f"global batch {global_batch} not divisible by dp x fsdp = {n} "
            f"x accumulation steps {accum_steps}")
    micro = global_batch // accum_steps
    per = micro // n
    return [(i * micro + index * per, i * micro + (index + 1) * per)
            for i in range(accum_steps)]


def shard_batch(arrays: Sequence[np.ndarray], mesh: Mesh,
                accum_steps: int = 1) -> tuple:
    """This process's rows of each global-batch array (dim 0)."""
    rows = local_rows(len(arrays[0]), mesh, accum_steps)
    return tuple(np.concatenate([a[lo:hi] for lo, hi in rows]) for a in arrays)


def mesh_axis(mesh: Mesh, name: str) -> Optional[str]:
    """``name`` if the mesh has that axis, else None."""
    return name if name in mesh.axis_names else None


def active_mesh_axis(mesh: Optional[Mesh], name: str) -> Optional[str]:
    """Like :func:`mesh_axis` but also None for a size-1 axis (and a None
    mesh)."""
    if mesh is None:
        return None
    return name if mesh.axis_size(name) > 1 else None


def shard_params(model: torch.nn.Module, mesh: Mesh, *,
                 tp_plan: Optional[Callable[[], dict]] = None
                 ) -> torch.nn.Module:
    """Lay ``model``'s parameters out on ``mesh``, in place: the
    tensor-parallel plan ``tp_plan()`` (module name -> ParallelStyle) on
    the tp axis, then FSDP2 ``fully_shard`` on each block (a child named
    as the models name their layers) and at the root over fsdp (HSDP
    over dp x fsdp). Parameters the forward reads outside a block
    (embeddings, heads) stay with the root, whose forward gathers them.
    On ep the MoE experts shard (:func:`shard_experts`). A world of one,
    or dp alone, leaves the parameters whole. Build the optimizer after
    this: it must hold the sharded parameters."""
    if mesh.axis_size(EP) > 1:
        shard_experts(model, mesh.submesh(EP))
    if mesh.axis_size(TP) > 1:
        if tp_plan is None:
            raise SystemExit(
                f"--mesh tp={mesh.axis_size(TP)}: tensor parallelism for "
                f"{type(model).__name__} is not ported yet (ROADMAP.md "
                f"queue (a) item 7)")
        from torch.distributed.tensor.parallel import parallelize_module

        plan = tp_plan()
        for style in plan.values():
            # Every rank built the same full parameters from one seed:
            # each keeps its own shard, with no scatter from rank 0.
            style.src_data_rank = None
        parallelize_module(model, mesh.submesh(TP), plan)
    if mesh.axis_size(FSDP) > 1:
        from torch.distributed.fsdp import fully_shard

        shard_mesh = mesh.submesh(DP, FSDP)
        for name, block in model.named_children():
            if _BLOCK_NAME.match(name):
                fully_shard(block, mesh=shard_mesh)
        fully_shard(model, mesh=shard_mesh)
    return model


def shard_experts(model: torch.nn.Module, ep_mesh) -> None:
    """Replace every MoE expert weight (``models/moe.py:EXPERT_PARAMS``,
    [E, ...]) of ``model`` by a DTensor sharded on its expert dim over
    ``ep_mesh``: each rank keeps its block of E/ep experts, cut from the
    whole weight every rank built from one seed. DCP then writes each
    rank's experts and reshards them on load."""
    from torch.distributed.tensor import DTensor, Shard

    from ..models.moe import EXPERT_PARAMS

    n, rank = ep_mesh.size(), ep_mesh.get_local_rank()
    for module in model.modules():
        for name in EXPERT_PARAMS:
            p = module._parameters.get(name)
            if p is None:
                continue
            if p.shape[0] % n:
                raise SystemExit(f"{p.shape[0]} experts not divisible by "
                                 f"ep={n}")
            per = p.shape[0] // n
            local = p.detach()[rank * per:(rank + 1) * per].clone()
            module.register_parameter(name, torch.nn.Parameter(
                DTensor.from_local(local, ep_mesh, [Shard(0)],
                                   run_check=False)))


def average_gradients(optimizer, mesh: Mesh) -> None:
    """On a ``dp`` mesh without ``fsdp`` (FSDP2 averages its own), average
    ``optimizer``'s gradients over dp just before each of its steps: one
    flat sum per dtype over the dp group."""
    if mesh.axis_size(DP) == 1 or mesh.axis_size(FSDP) > 1:
        return
    import torch.distributed as dist
    from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors

    group = mesh.submesh(DP).get_group()
    n = mesh.axis_size(DP)
    params = [p for g in optimizer.param_groups for p in g["params"]]

    def sync(*_) -> None:
        grads: dict = {}
        for p in params:
            if p.grad is None:
                continue  # as on every rank: the same parameters get none
            g = p.grad
            g = g.to_local() if hasattr(g, "to_local") else g
            grads.setdefault(g.dtype, []).append(g)
        for same in grads.values():
            flat = _flatten_dense_tensors(same)
            dist.all_reduce(flat, group=group)
            flat.div_(n)
            for g, synced in zip(same, _unflatten_dense_tensors(flat, same)):
                g.copy_(synced)

    optimizer.register_step_pre_hook(sync)


class _AllReduceSum(torch.autograd.Function):
    """Sum across the world; the gradient of each rank's input is the sum
    of every rank's output gradient."""

    @staticmethod
    def forward(ctx, x):
        import torch.distributed as dist

        out = x.clone()
        dist.all_reduce(out)
        return out

    @staticmethod
    def backward(ctx, grad):
        import torch.distributed as dist

        grad = grad.clone()
        dist.all_reduce(grad)
        return grad


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over every process of the world, differentiably; ``x``
    itself in a world of one. Over the world, not only the batch shards:
    tp ranks hold the same rows, so a ratio of two such sums (a mean, a
    weighted mean) is the global batch's all the same."""
    return _AllReduceSum.apply(x) if world_size() > 1 else x


class _SumPartials(torch.autograd.Function):
    """Sum over ``group`` in the forward. Every rank's use of the sum is
    the same computation, so each rank's output gradient is already the
    whole one: it passes to the rank's partial unchanged."""

    @staticmethod
    def forward(ctx, x, group):
        import torch.distributed as dist

        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _SumGrads(torch.autograd.Function):
    """The identity in the forward; the backward sums the gradient over
    ``group``: each rank's branch after this point computed only its part
    of it."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        import torch.distributed as dist

        grad = grad.clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def sum_partials(x: torch.Tensor, group) -> torch.Tensor:
    """Each rank of ``group`` holds a part of a sum, which every rank then
    uses alike: the sum, with the gradient of a part that of the sum."""
    return _SumPartials.apply(x, group)


def sum_grads(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` itself, whose gradient is summed over ``group``: the ranks'
    branches from ``x`` are parts of one computation (each rank's
    experts)."""
    return _SumGrads.apply(x, group)


def any_process(local: bool, group) -> bool:
    """True on every process of ``group`` when it is True on any (a MAX
    over the group's CPU tensors): a decision the gang must take as one,
    such as stopping on a SIGTERM that reached one rank."""
    import torch.distributed as dist

    flag = torch.tensor([int(local)], dtype=torch.int32)
    dist.all_reduce(flag, op=dist.ReduceOp.MAX, group=group)
    return bool(flag.item())
