"""Batches and parameters on the mesh (port of
``mpi_operator_tpu/parallel/sharding.py``).

The JAX package annotates arrays with PartitionSpecs and lets GSPMD
insert the collectives. Here each process holds its part and the
collectives are explicit:

- the batch: this process's rows of the global batch (dp x fsdp split
  the batch dim; tp ranks hold the same rows), as ``batch_spec`` /
  ``shard_batch`` place them;
- the parameters: a model's tensor-parallel plan on the ``tp`` axis
  (DTensor ``ColwiseParallel``/``RowwiseParallel``; ResNet's plan is
  empty, its work replicated over tp), then FSDP2 ``fully_shard`` per
  block and at the root over ``fsdp`` (with ``dp`` as well: HSDP on the
  2-D mesh); with ``dp`` alone the parameters stay whole and
  :func:`average_gradients` averages the gradients over ``dp``, each
  rank's local shard over the ranks that share its tp coordinate;
- :func:`all_reduce_sum`, the autograd-aware sum across the world that
  the global-batch statistics take (BatchNorm's moments, BERT's MLM
  weight count), as GSPMD takes them over the global batch;
- the MoE experts: sharded on their expert dim over ``ep`` and on
  their hidden dim over ``tp`` (:func:`shard_experts`). An ep x tp rank
  sees its dp row's batch and runs its block of its experts;
  :func:`sum_partials` adds the ranks' partial outputs and
  :func:`sum_grads` the gradients of the expert branch's inputs, so that
  every rank holds the whole gradient of each parameter it holds whole
  and the gradients are averaged over dp alone, as GSPMD's gradients of
  these shardings are complete on every ep and tp device;
- the sequence: on ``sp`` each rank holds its positions of its batch
  rows (:func:`local_positions`, contiguous or zigzag), the parameters
  stay whole and their gradients are averaged over sp as over dp. The
  sequence-parallel attention moves k/v around the ring
  (:func:`ring_pass`; over gloo, whose point-to-point ops take CPU
  tensors only, a CUDA tensor crosses through pinned host memory) or
  re-shards heads against the sequence (:func:`all_to_all`, which NCCL
  and gloo both take on CUDA tensors);
- the pipeline: on ``pp`` each rank holds a stage of the layers
  (``models/llama_pp.py``), laid out on its stage's groups as above,
  and the activations hop between stages by :func:`ring_pass` over the
  pp group (``parallel/pipeline.py``).
"""

from __future__ import annotations

import re
from math import prod
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from .mesh import DP, EP, FSDP, SP, TP, Mesh, batch_shards, world_size

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


def local_positions(seq_len: int, mesh: Mesh, zigzag: bool = False
                    ) -> np.ndarray:
    """The global sequence positions this process holds, in its order:
    its contiguous ``seq_len / sp`` run, or with ``zigzag`` the chunks
    ``i`` and ``2 sp - 1 - i`` of ``2 sp`` (``i`` its sp coordinate), as
    the ring's ``_shard_ids`` labels them. Every position without sp."""
    n, i = mesh.axis_size(SP), mesh.coordinate(SP)
    if seq_len % (2 * n if zigzag else n):
        raise ValueError(f"sequence {seq_len} not divisible by "
                         f"{'2 x ' if zigzag else ''}sp={n}")
    if not zigzag:
        per = seq_len // n
        return np.arange(i * per, (i + 1) * per)
    half = seq_len // (2 * n)
    return np.concatenate([np.arange(i * half, (i + 1) * half),
                           np.arange((2 * n - 1 - i) * half,
                                     (2 * n - i) * half)])


def owned_slots(slots: torch.Tensor, positions: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Which of a batch's prediction slots this sp rank owns: ``slots``
    (any shape, int) index the global sequence, ``positions`` (sorted,
    as :func:`local_positions` gives them) are the columns the rank
    holds. Returns (each slot's local column, clamped into range where
    the rank does not own the slot; a bool mask of the slots it owns).
    Every slot is owned by exactly one rank of the sp group."""
    positions = positions.to(slots.device)
    col = torch.searchsorted(positions, slots.contiguous().long())
    col = col.clamp_(max=positions.numel() - 1)
    return col, positions[col] == slots


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
                 tp_plan: Optional[Callable[[], dict]] = None,
                 whole: Sequence[torch.nn.Parameter] = ()
                 ) -> torch.nn.Module:
    """Lay ``model``'s parameters out on ``mesh``, in place: the MoE
    experts on ep x tp (:func:`shard_experts`), the tensor-parallel plan
    ``tp_plan()`` (module name -> ParallelStyle) on the tp axis, then
    FSDP2 ``fully_shard`` on each block (a child named as the models name
    their layers) and at the root over fsdp (HSDP over dp x fsdp).
    Parameters the forward reads outside a block (embeddings, heads) stay
    with the root, whose forward gathers them. An empty plan is the
    replicated layout (ResNet, which JAX leaves to GSPMD with no rule):
    every tp rank computes its dp x fsdp coordinate's whole batch and no
    sum runs across tp. A world of one, or dp alone, leaves the
    parameters whole. ``whole``: parameters the root leaves unsharded on
    every fsdp rank (a pipeline stage's embedding, norm and head, which
    it reads outside its forward; :func:`average_gradients` averages
    their gradients). Build the optimizer after this: it must hold the
    sharded parameters."""
    shard_experts(model, mesh)
    if mesh.axis_size(TP) > 1:
        if tp_plan is None:
            raise ValueError(f"--mesh tp={mesh.axis_size(TP)}: no "
                             f"tensor-parallel plan for "
                             f"{type(model).__name__}")
        from torch.distributed.tensor.parallel import parallelize_module

        plan = tp_plan()
        for style in plan.values():
            # Every rank built the same full parameters from one seed:
            # each keeps its own shard, with no scatter from rank 0.
            style.src_data_rank = None
        parallelize_module(model, mesh.submesh(TP), plan)
    if mesh.axis_size(FSDP) > 1:
        from torch.distributed.fsdp import fully_shard
        from torch.distributed.tensor import DTensor

        # FSDP2 shards contiguous parameters only: a channels_last conv
        # kernel (ResNet's) takes the default layout back first; its
        # convolutions still read channels_last activations.
        for p in model.parameters():
            if not isinstance(p, DTensor) and not p.is_contiguous():
                p.data = p.data.contiguous()
        # The ep x tp meshes of the experts and the plan are children of
        # the same DeviceMesh as this one, as FSDP2 requires of a DTensor
        # parameter; where the experts' dim 0 is already split over ep,
        # FSDP2 splits it again over fsdp (a strided shard).
        shard_mesh = mesh.submesh(DP, FSDP)
        for name, block in model.named_children():
            if _BLOCK_NAME.match(name):
                fully_shard(block, mesh=shard_mesh)
        fully_shard(model, mesh=shard_mesh,
                    ignored_params=set(whole) or None)
    return model


def shard_experts(model: torch.nn.Module, mesh: Mesh) -> None:
    """Replace every MoE expert weight (``models/moe.py:EXPERT_PARAMS``)
    of ``model`` by a DTensor over the ep x tp submesh of ``mesh`` (the
    axes of size > 1; nothing to do without either), as the JAX rules
    ``P(ep, fsdp, tp)`` / ``P(ep, tp, fsdp)`` shard them: the expert dim
    E over ep and the expert hidden dim F over tp (``expert_wg`` and
    ``expert_wu`` [E, D, F] on dim 2, ``expert_wd`` [E, F, D] on dim 1).
    Each rank keeps its block, cut from the whole weight every rank built
    from one seed. DCP then writes each rank's block and reshards it on
    load."""
    from torch.distributed.tensor import DTensor, Shard

    from ..models.moe import EXPERT_HIDDEN_DIM, EXPERT_PARAMS

    axes = [a for a in (EP, TP) if mesh.axis_size(a) > 1]
    if not axes:
        return
    sub = mesh.submesh(*axes)
    for module in model.modules():
        for name in EXPERT_PARAMS:
            p = module._parameters.get(name)
            if p is None:
                continue
            dims = [0 if a == EP else EXPERT_HIDDEN_DIM[name] for a in axes]
            local = p.detach()
            for axis, dim in zip(axes, dims):
                n = mesh.axis_size(axis)
                if local.shape[dim] % n:
                    what = "experts" if axis == EP else "expert hidden dim"
                    raise SystemExit(f"{p.shape[dim]} ({what}) not divisible "
                                     f"by {axis}={n}")
                per = local.shape[dim] // n
                local = local.narrow(dim, mesh.coordinate(axis) * per, per)
            module.register_parameter(name, torch.nn.Parameter(
                DTensor.from_local(local.clone(), sub,
                                   [Shard(d) for d in dims],
                                   run_check=False)))


def average_gradients(optimizer, mesh: Mesh) -> None:
    """Average ``optimizer``'s gradients just before each of its steps
    over the axes whose ranks hold the same parameters and other data:
    dp and fsdp (for a parameter FSDP2 shards, neither: it averages over
    its own mesh, dp included) and sp, whose ranks hold other positions of
    the same rows. A parameter left whole on an fsdp mesh (a pipeline
    stage's embedding and head, as the JAX package replicates them) is
    averaged over dp x fsdp here. Sums over each such group, a bucket of
    at most ``_BUCKET_BYTES`` of one dtype at a time (a larger gradient
    alone, in place), so the flat copies stay small beside the gradients;
    the gradient of an FSDP2 shard is averaged the same way over sp. A
    group holds the ranks that share every other coordinate, tp's and
    pp's among them, so a tensor-parallel gradient's local shard meets
    only the same shard on its peers."""
    import torch.distributed as dist
    from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors

    def axes_of(p) -> tuple:
        mesh_of = getattr(p, "device_mesh", None)
        fsdp = FSDP in ((mesh_of.mesh_dim_names or ()) if mesh_of else ())
        return tuple(a for a in ((SP,) if fsdp else (DP, FSDP, SP))
                     if mesh.axis_size(a) > 1)

    params = [p for g in optimizer.param_groups for p in g["params"]]
    if not any(axes_of(p) for p in params):
        return
    groups = {a: mesh.submesh(a).get_group() for a in (DP, FSDP, SP)
              if mesh.axis_size(a) > 1}

    def sync(*_) -> None:
        grads: dict = {}
        for p in params:
            axes = axes_of(p)
            if p.grad is None or not axes:
                continue  # as on every rank: the same parameters get none
            g = p.grad
            g = g.to_local() if hasattr(g, "to_local") else g
            grads.setdefault((axes, g.dtype), []).append(g)
        for (axes, _), same in grads.items():
            n = prod(mesh.axis_size(a) for a in axes)
            for bucket in _buckets(same):
                whole = len(bucket) == 1 and bucket[0].is_contiguous()
                flat = bucket[0] if whole else _flatten_dense_tensors(bucket)
                for axis in axes:
                    dist.all_reduce(flat, group=groups[axis])
                flat.div_(n)
                if not whole:
                    for g, synced in zip(
                            bucket, _unflatten_dense_tensors(flat, bucket)):
                        g.copy_(synced)

    optimizer.register_step_pre_hook(sync)


_BUCKET_BYTES = 1 << 28


def _buckets(tensors):
    """``tensors`` in order, in runs of at most ``_BUCKET_BYTES`` (a
    larger tensor makes a run of its own)."""
    run, size = [], 0
    for t in tensors:
        nbytes = t.numel() * t.element_size()
        if run and size + nbytes > _BUCKET_BYTES:
            yield run
            run, size = [], 0
        run.append(t)
        size += nbytes
    if run:
        yield run


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


# Bytes each rank sent over the sequence-parallel transport since the
# last reset, by route: "host" (a CUDA tensor this module stages through
# pinned host memory: a ring hop over gloo) and "direct" (handed to the
# backend as it is: NCCL, a CPU tensor, or an all-to-all, which gloo
# stages itself).
SEQUENCE_BYTES = {"host": 0, "direct": 0}


def _count(host: bool, t: torch.Tensor, ledger: dict = SEQUENCE_BYTES
           ) -> None:
    ledger["host" if host else "direct"] += t.numel() * t.element_size()


def ring_pass(tensors: Sequence[torch.Tensor], group, shift: int = 1,
              ledger: dict = SEQUENCE_BYTES) -> list:
    """Send ``tensors`` to the rank ``shift`` ahead in ``group`` (``(rank
    + shift) % n``: the next rank, or with ``shift=-1`` the previous one)
    and return what the rank ``shift`` behind sent, of the same shapes and
    dtypes: one message a hop, the tensors' bytes packed together and
    counted into ``ledger``."""
    import torch.distributed as dist

    n, rank = dist.get_world_size(group), dist.get_rank(group)
    if n == 1:
        return list(tensors)
    flat = torch.cat([t.contiguous().reshape(-1).view(torch.uint8)
                      for t in tensors])
    dst = dist.get_global_rank(group, (rank + shift) % n)
    src = dist.get_global_rank(group, (rank - shift) % n)
    # gloo's send and recv read the tensor's pointer from the host: a
    # CUDA tensor fails there ("Bad address"), so it is staged.
    host = flat.is_cuda and dist.get_backend(group) == "gloo"
    _count(host, flat, ledger)
    if host:
        send = torch.empty(flat.shape, dtype=torch.uint8, pin_memory=True)
        send.copy_(flat)
        recv = torch.empty_like(send, pin_memory=True)
        for work in (dist.isend(send, dst, group=group),
                     dist.irecv(recv, src, group=group)):
            work.wait()
        recv = recv.to(flat.device, non_blocking=True)
    else:
        recv = torch.empty_like(flat)
        ops = [dist.P2POp(dist.isend, flat, dst, group),
               dist.P2POp(dist.irecv, recv, src, group)]
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    out, at = [], 0
    for t in tensors:
        size = t.numel() * t.element_size()
        out.append(recv[at:at + size].view(t.dtype).reshape(t.shape))
        at += size
    return out


def _all_to_all(x: torch.Tensor, group, split_dim: int, concat_dim: int):
    import torch.distributed as dist

    n = dist.get_world_size(group)
    shape = list(x.shape)
    if shape[split_dim] % n:
        raise ValueError(f"dim {split_dim} of {tuple(x.shape)} not divisible "
                         f"by the group's {n} ranks")
    shape[split_dim:split_dim + 1] = [n, shape[split_dim] // n]
    # [n, ...]: block j goes to rank j.
    send = x.reshape(shape).movedim(split_dim, 0).contiguous()
    _count(False, send)
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    # Block j came from rank j: it lands at offset j along concat_dim.
    out = recv.movedim(0, concat_dim)
    shape = list(out.shape)
    shape[concat_dim:concat_dim + 2] = [shape[concat_dim]
                                        * shape[concat_dim + 1]]
    return out.reshape(shape)


class _AllToAll(torch.autograd.Function):
    """The tiled all-to-all; its gradient is the reverse all-to-all."""

    @staticmethod
    def forward(ctx, x, group, split_dim, concat_dim):
        ctx.args = (group, concat_dim, split_dim)
        return _all_to_all(x, group, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, grad):
        return _all_to_all(grad, *ctx.args), None, None, None


def all_to_all(x: torch.Tensor, group, split_dim: int,
               concat_dim: int) -> torch.Tensor:
    """``lax.all_to_all(..., tiled=True)`` over ``group``: ``x`` split into
    n blocks along ``split_dim``, block j sent to rank j, the blocks
    received concatenated along ``concat_dim`` in rank order.
    Differentiable."""
    return _AllToAll.apply(x, group, split_dim, concat_dim)


def any_process(local: bool, group) -> bool:
    """True on every process of ``group`` when it is True on any (a MAX
    over the group's CPU tensors): a decision the gang must take as one,
    such as stopping on a SIGTERM that reached one rank."""
    import torch.distributed as dist

    flag = torch.tensor([int(local)], dtype=torch.int32)
    dist.all_reduce(flag, op=dist.ReduceOp.MAX, group=group)
    return bool(flag.item())
