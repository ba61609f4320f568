"""Pipeline parallelism over the ``pp`` process group: the GPipe schedule
as SPMD (port of ``mpi_operator_tpu/parallel/pipeline.py``).

Every rank of the pp group runs the same program on its own stage. M
microbatches over P stages take M + P - 1 ticks; at tick t stage i
computes microbatch t - i. Stage 0 injects microbatch t, the others take
the activation their predecessor passed over the pp ring (rank j to
(j + 1) % P, ``parallel/sharding.py:ring_pass``, which stages a CUDA
tensor through pinned host memory on gloo). A bubble tick computes
nothing and sends zeros, but never skips its hop, so every rank makes
the same hops in the same order. The last stage banks the outputs.

The backward is an explicit loop over the ticks in reverse order, not
autograd's own node order: at each tick a stage receives its output's
cotangent from stage i + 1 (the last stage reads its own), runs
``torch.autograd.backward`` on that tick's output and sends its input's
gradient to stage i - 1 over the ring the other way. The hops are thus
collective calls in one order on every rank, whatever autograd does
inside a tick (recomputation under remat, the collectives of tp, sp and
ep within the stage). Each real tick keeps its input and output, and
their graph, from the forward to the backward.

``with_aux``: the stage function returns ``(h, aux)`` and the schedule
sums aux over the real (stage, microbatch) pairs, then over the pp group
(the MoE router loss).

:class:`GPipe` is the schedule, run by hand (forward, then backward with
the last stage's cotangent) by ``models/llama_pp.py``'s train step;
:func:`pipeline` wraps it as a differentiable function, the JAX entry
point.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch

from .mesh import PP, Mesh
from .sharding import ring_pass

# Bytes each rank passed along the pp ring since the last reset, by
# route (``parallel/sharding.py:SEQUENCE_BYTES``'s): "host" (a CUDA
# tensor staged through pinned host memory, gloo) or "direct".
PIPELINE_BYTES = {"host": 0, "direct": 0}


def num_microbatches(global_batch: int, microbatch: int) -> int:
    if global_batch % microbatch:
        raise ValueError(
            f"global batch {global_batch} not divisible by microbatch "
            f"{microbatch}"
        )
    return global_batch // microbatch


def microbatch(x: torch.Tensor, microbatch_size: int) -> torch.Tensor:
    """[B, ...] -> [M, mb, ...] for the pipeline's leading microbatch dim."""
    m = num_microbatches(x.shape[0], microbatch_size)
    return x.reshape((m, microbatch_size) + tuple(x.shape[1:]))


def unmicrobatch(y: torch.Tensor) -> torch.Tensor:
    """[M, mb, ...] -> [B, ...]."""
    return y.reshape((y.shape[0] * y.shape[1],) + tuple(y.shape[2:]))


def _check_fill(n: int, m: int) -> None:
    if m < n:
        raise ValueError(
            f"need at least {n} microbatches to fill a {n}-stage pipeline, "
            f"got {m}"
        )


class GPipe:
    """One step of the schedule on this rank of the pp ``group``:
    :meth:`forward`, then :meth:`backward`. ``fn(params, h)`` is this
    rank's stage (``(h, aux)`` with ``with_aux``); it maps one microbatch
    [mb, ...] to one of the same shape and dtype."""

    def __init__(self, fn: Callable, params, group, *,
                 with_aux: bool = False):
        import torch.distributed as dist

        self.fn, self.params, self.group = fn, params, group
        self.with_aux = with_aux
        # No group: a pipeline of one stage, each microbatch in turn.
        self.n = dist.get_world_size(group) if group is not None else 1
        self.stage = dist.get_rank(group) if group is not None else 0
        self._ticks: list = []

    def _hop(self, t: torch.Tensor, shift: int) -> torch.Tensor:
        if self.group is None:
            return t
        return ring_pass([t], self.group, shift, PIPELINE_BYTES)[0]

    def forward(self, x: torch.Tensor):
        """``x`` [M, mb, ...]: the microbatches, read on stage 0 (another
        stage reads only its shape and dtype). Returns ``(outputs, aux)``:
        the [M, mb, ...] outputs on the last stage (zeros on the others)
        and this stage's aux summed over its real ticks, then over the pp
        group (0.0 without ``with_aux``)."""
        n, i, m = self.n, self.stage, x.shape[0]
        _check_fill(n, m)
        zeros = torch.zeros_like(x[0])
        outputs = torch.zeros_like(x)
        state = zeros
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        self._ticks = []
        for t in range(m + n - 1):
            mine = t - i
            send = zeros
            if 0 <= mine < m:
                h_in = (x[mine] if i == 0 else state).detach()
                h_in.requires_grad_(True)
                with torch.enable_grad():
                    out = self.fn(self.params, h_in)
                h_out, aux_t = out if self.with_aux else (out, None)
                self._ticks.append((t, mine, h_in, h_out, aux_t))
                if aux_t is not None:
                    aux = aux + aux_t.detach().float()
                if i == n - 1:
                    outputs[mine] = h_out.detach()
                send = h_out.detach()
            state = self._hop(send, 1)
        if self.with_aux and self.group is not None:
            import torch.distributed as dist

            dist.all_reduce(aux, group=self.group)
        return outputs, aux

    def backward(self, grad_outputs: Optional[torch.Tensor] = None,
                 grad_aux=None) -> torch.Tensor:
        """Backpropagate the last step: ``grad_outputs`` [M, mb, ...] is
        read on the last stage, ``grad_aux`` (the cotangent of the summed
        aux) on every stage. The parameters' gradients accumulate into
        their ``.grad``; returns the gradient of ``x`` on stage 0 (zeros on
        the others)."""
        n, i = self.n, self.stage
        ticks = {t: rec for t, *rec in self._ticks}
        self._ticks = []
        first = next(iter(ticks.values()))[1]
        zeros = torch.zeros_like(first)
        m = len(ticks)
        grad_x = zeros.new_zeros((m,) + tuple(first.shape))
        recv = zeros
        for t in reversed(range(m + n - 1)):
            send = zeros
            if t in ticks:
                mine, h_in, h_out, aux_t = ticks.pop(t)
                g_out = grad_outputs[mine] if i == n - 1 else recv
                outs, grads = [h_out], [g_out]
                if aux_t is not None and aux_t.requires_grad:
                    outs.append(aux_t)
                    grads.append(torch.as_tensor(grad_aux, dtype=aux_t.dtype,
                                                 device=aux_t.device))
                torch.autograd.backward(outs, grads)
                if h_in.grad is not None:
                    send = h_in.grad
                if i == 0:
                    grad_x[mine] = send
            recv = self._hop(send, -1)
        return grad_x


class _Pipeline(torch.autograd.Function):
    """:class:`GPipe` as one autograd node: the forward runs the schedule
    and the backward its reverse loop. ``params`` are inputs only so that
    the outputs depend on them; their gradients accumulate in the
    reverse loop's own backward calls."""

    @staticmethod
    def forward(ctx, schedule, x, *params):
        ctx.schedule = schedule
        outputs, aux = schedule.forward(x)
        return outputs, aux

    @staticmethod
    def backward(ctx, grad_outputs, grad_aux):
        grad_x = ctx.schedule.backward(grad_outputs, grad_aux)
        return (None, grad_x) + (None,) * len(ctx.needs_input_grad[2:])


def _tensors(tree) -> list:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, torch.nn.Module):
        return list(tree.parameters())
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensors(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensors(v)]
    return []


def pipeline(fn: Callable, stage_params: Sequence, x: torch.Tensor,
             mesh: Mesh, *, axis: str = PP, with_aux: bool = False):
    """Run ``fn`` as a P-stage pipeline over microbatched input.

    fn:            ``(params_of_one_stage, h) -> h`` (``(h, aux)`` with
                   ``with_aux``), the same function on every stage.
    stage_params:  one entry a stage, P of them. On a mesh with a pp axis
                   this rank runs entry ``mesh.coordinate(axis)`` (the
                   others may be None); without one, every stage in turn.
    x:             [M, mb, ...] microbatches (read on stage 0).

    Returns the [M, mb, ...] outputs (on the last stage; zeros on the
    others), and with ``with_aux`` the aux summed over the real (stage,
    microbatch) pairs, over pp. Differentiable: every rank of the pp
    group backpropagates through the outputs (a stage other than the
    last with any cotangent, which it ignores), and the gradients of the
    parameters reach their ``.grad``. Without a pp axis the stages run in
    turn, each microbatch on its own, as the JAX fallback does."""
    n_stages = len(stage_params)
    if mesh.axis_size(axis) == 1:
        outs, aux_sum = [], torch.zeros((), dtype=torch.float32,
                                        device=x.device)
        for h in x:
            for params in stage_params:
                h = fn(params, h)
                if with_aux:
                    h, aux = h
                    aux_sum = aux_sum + aux
            outs.append(h)
        outputs = torch.stack(outs)
        return (outputs, aux_sum) if with_aux else outputs
    n = mesh.axis_size(axis)
    _check_fill(n, x.shape[0])
    if n_stages != n:
        # A divisible mismatch must not run only some of the stages.
        raise ValueError(
            f"stage-stacked params have {n_stages} stages but the {axis!r} "
            f"axis has {n} devices; they must match (fold extra layers "
            f"inside fn, e.g. a loop over layers-per-stage)"
        )
    params = stage_params[mesh.coordinate(axis)]
    schedule = GPipe(fn, params, mesh.submesh(axis).get_group(),
                     with_aux=with_aux)
    outputs, aux = _Pipeline.apply(schedule, x, *_tensors(params))
    return (outputs, aux) if with_aux else outputs
