"""Pipelined Llama: the blocks run as a GPipe pipeline over the ``pp``
process group (``parallel/pipeline.py``), dense and MoE (port of
``mpi_operator_tpu/models/llama_pp.py``).

Layout: stage i of P holds the blocks of layers ``[i L/P, (i+1) L/P)``
under their global names (``layer_{k}``), stage 0 the embedding, the
last stage ``final_norm`` and ``lm_head`` (:class:`LlamaStage`). The JAX
package replicates embedding, norm and head on every stage and computes
them there; holding each where it is used gives the same loss and
gradients without an all-reduce of their gradients over pp. With tied
embeddings the first and last stage both hold the embedding and add
their gradients of it (no shipped config ties them). A stage's
parameters carry the plain model's names, so its state dict is the
plain model's restricted to the stage, and a checkpoint reads onto any
pp size (``utils/checkpoint.py``).

The train step (:func:`forward_backward`): stage 0 embeds its rows,
which split into M microbatches as the JAX step splits the sharded
global batch (microbatch m is global rows ``[m B/M, (m+1) B/M)``, each
dp x fsdp rank its share: ``parallel/sharding.py:local_rows`` with
``accum_steps=M``); the schedule runs the blocks; the last stage
computes the cross-entropy of the whole local batch, a microbatch at a
time (JAX's over the unmicrobatched outputs at once: the same mean, with
a microbatch's logits at a time instead of the batch's), and its
gradient of the outputs, which the schedule carries back to stage 0's
embedding.
The loss is summed over pp, so every rank reads the global-batch value;
the MoE router loss is the pipeline's aux sum divided by the M
microbatches here (the dp average of the gradients and of the reported
loss divides by dp, as JAX divides by M x dp x fsdp chunks).

Composition, on each stage's modules with the machinery the plain model
uses (``parallel/sharding.py``): tp by ``models/llama.py:
tensor_parallel_plan`` over the stage's tp group, fsdp by FSDP2 on each
block over the stage's fsdp group (the embedding, norm and head stay
whole, as JAX replicates them), ep by ``shard_experts``, sp by the ring
or Ulysses over the stage's sp group with global RoPE positions, and the
gradients averaged over the stage's dp and sp ranks.

The JAX package's stage-stacked layout ``{embed, blocks [P, L/P, ...],
final_norm, lm_head}`` lives here only in :func:`stack_block_params`
and its inverses, on the port's state dicts.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.losses import f32_logits, lm_xent_chunked
from ..parallel.mesh import FSDP, PP, SP, Mesh
from ..parallel.pipeline import GPipe, microbatch
from . import llama as lib


# -- the JAX stage-stacked layout, on state dicts ------------------------

def _layer_keys(state: dict) -> dict:
    """{k: {leaf: tensor}} for the ``layer_{k}.{leaf}`` entries."""
    out: dict = {}
    for name, t in state.items():
        if name.startswith("layer_"):
            layer, leaf = name.split(".", 1)
            out.setdefault(int(layer[len("layer_"):]), {})[leaf] = t
    return out


def stack_block_params(state: dict, n_layers: int, n_stages: int) -> dict:
    """The ``layer_{i}.*`` entries of a Llama state dict as the pipeline's
    stage-stacked leaves: ``{leaf: [P, L/P, ...]}``."""
    if n_layers % n_stages:
        raise ValueError(
            f"n_layers {n_layers} not divisible by pp stages {n_stages}"
        )
    layers = _layer_keys(state)
    per = n_layers // n_stages
    return {leaf: torch.stack([layers[i][leaf] for i in range(n_layers)])
            .reshape((n_stages, per) + tuple(t.shape))
            for leaf, t in layers[0].items()}


def unstack_block_params(blocks: dict) -> dict:
    """Invert :func:`stack_block_params`: stage-stacked leaves [P, L/P,
    ...] back into ``layer_{i}.{leaf}`` entries (layer order does not
    depend on pp)."""
    out = {}
    for leaf, w in blocks.items():
        flat = w.reshape((w.shape[0] * w.shape[1],) + tuple(w.shape[2:]))
        for i, t in enumerate(flat):
            out[f"layer_{i}.{leaf}"] = t
    return dict(sorted(out.items(), key=lambda kv: int(
        kv[0].split(".", 1)[0][len("layer_"):])))


def restack_block_params(blocks: dict, n_stages_new: int) -> dict:
    """Re-split stage-stacked leaves [P, L/P, ...] onto a new pp size [P',
    L/P', ...]: a pure reshape, the layer order being pp-invariant."""
    def re(w):
        n_layers = w.shape[0] * w.shape[1]
        if n_layers % n_stages_new:
            raise ValueError(
                f"{n_layers} layers not divisible by new pp size "
                f"{n_stages_new}"
            )
        return w.reshape((n_stages_new, n_layers // n_stages_new)
                         + tuple(w.shape[2:]))

    return {leaf: re(w) for leaf, w in blocks.items()}


def pp_params_from_init(state: dict, cfg: lib.LlamaConfig,
                        n_stages: int) -> dict:
    """A plain Llama state dict regrouped into the pipelined layout:
    embedding, norm and head by name, the blocks stage-stacked under
    ``"blocks"``."""
    out = {k: v for k, v in state.items() if not k.startswith("layer_")}
    out["blocks"] = stack_block_params(state, cfg.n_layers, n_stages)
    return out


def init_pp_params(cfg: lib.LlamaConfig, n_stages: int,
                   generator: torch.Generator) -> dict:
    """Fresh pipelined params for ``cfg`` from ``generator`` (the plain
    model's init, regrouped)."""
    model = lib.init_params(lib.Llama(cfg, device=generator.device),
                            generator)
    return pp_params_from_init(
        {k: v.detach() for k, v in model.state_dict().items()}, cfg,
        n_stages)


# -- one stage ------------------------------------------------------------

class LlamaStage(nn.Module):
    """Stage ``stage`` of ``n_stages``: its blocks under their global
    names, the embedding on the first stage (and on the last with tied
    embeddings), ``final_norm`` and ``lm_head`` on the last.
    ``forward(h, positions) -> (h, aux)`` runs its blocks."""

    def __init__(self, config: lib.LlamaConfig, stage: int, n_stages: int,
                 device=None, sp_group=None):
        super().__init__()
        lib.remat_policy_for(config.remat_policy)  # refuses an unknown one
        if config.n_layers % n_stages:
            raise ValueError(f"n_layers {config.n_layers} not divisible by "
                             f"pp stages {n_stages}")
        self.config, self.stage, self.n_stages = config, stage, n_stages
        self.first, self.last = stage == 0, stage == n_stages - 1
        per = config.n_layers // n_stages
        if self.first or (self.last and config.tie_embeddings):
            self.embed = nn.Embedding(config.vocab_size, config.dim,
                                      device=device)
        for k in range(stage * per, (stage + 1) * per):
            self.add_module(f"layer_{k}", lib.Block(config, device, sp_group))
        if self.last:
            self.final_norm = lib.RMSNorm(config.dim, config.norm_eps, device)
            if not config.tie_embeddings:
                self.lm_head = lib.F32LogitsDense(config.dim,
                                                  config.vocab_size, device)

    def blocks(self) -> list:
        return [m for name, m in self.named_children()
                if name.startswith("layer_")]

    def edge_params(self) -> list:
        """The parameters outside the blocks (embedding, norm, head)."""
        return [p for name, p in self.named_parameters()
                if not name.startswith("layer_")]

    def forward(self, h, positions):
        return lib.run_blocks(self.blocks(), h, positions, self.config.remat,
                              self.config.remat_policy)

    def head_kernel(self) -> torch.Tensor:
        if self.config.tie_embeddings:
            return self.embed.weight.t()
        return self.lm_head.weight.t()

    def loss(self, h, tokens, targets=None, weights=None,
             scale: float = 1.0):
        """The last stage's loss of the final hidden states ``h``: the
        mean next-token cross-entropy against ``tokens``, or with
        ``targets`` and ``weights`` (an sp rank's columns) the weighted
        sum times ``scale``, as ``models/llama.py:sequence_loss``."""
        cfg = self.config
        h = self.final_norm(h)
        if targets is None:
            h, targets = h[:, :-1], tokens[:, 1:]
        if cfg.xent_chunk > 0:
            mean = lm_xent_chunked(h, self.head_kernel(), targets, weights,
                                   chunk=cfg.xent_chunk)
        else:
            ce = F.cross_entropy(
                f32_logits(h, self.head_kernel()).reshape(-1, cfg.vocab_size),
                targets.reshape(-1).long(), reduction="none")
            w = (torch.ones_like(ce) if weights is None
                 else weights.reshape(-1).float())
            mean = torch.sum(ce * w) / torch.clamp(w.sum(), min=1.0)
        if weights is None:
            return mean
        return mean * weights.float().sum() * scale


@torch.no_grad()
def init_stage_params(stage: LlamaStage, generator: torch.Generator
                      ) -> LlamaStage:
    """Initialize ``stage`` in place to its part of the plain model that
    ``models/llama.py:init_params`` draws from ``generator``: every
    parameter of the whole model is drawn in turn, into the stage's own
    tensor or a scratch one, so every stage and a one-process run agree
    at one seed."""
    own = dict(stage.named_parameters())
    with torch.device("meta"):
        whole = lib.Llama(stage.config)
    for name, p in whole.named_parameters():
        target = own.get(name)
        if target is None:
            target = torch.empty(p.shape, dtype=p.dtype,
                                 device=generator.device)
        lib.init_param(name, target, generator)
    return stage


# -- the checks and the step -----------------------------------------------

def check_pp_config(cfg: lib.LlamaConfig, mesh: Mesh) -> None:
    """The JAX ``make_pp_loss_fn``'s refusals, with its messages."""
    fsdp, sp = mesh.axis_size(FSDP) > 1, mesh.axis_size(SP)
    if cfg.attention_impl not in ("flash", "flash-bhsd", "dense", "ring",
                                  "ulysses"):
        raise ValueError(
            f"pipelined Llama runs flash/dense attention inside stages "
            f"(or the ppermute ring / Ulysses all-to-alls when the mesh "
            f"has sp), not {cfg.attention_impl!r}"
        )
    if cfg.is_moe and fsdp:
        raise ValueError(
            "pipelined MoE composes with dp/tp/ep, not fsdp — the ZeRO-3 "
            "per-layer gather assumes dense [in, out] kernels, and the "
            "expert dim wants ep"
        )
    if cfg.is_moe and sp > 1:
        raise ValueError(
            "pipelined MoE does not compose with sp: routing capacity is "
            "per sequence, and a sequence shard would route against a "
            "fraction of it"
        )
    if cfg.attention_impl in ("ring", "ulysses"):
        if sp <= 1:
            raise ValueError(
                f"attention_impl={cfg.attention_impl!r} in the pipeline "
                f"needs an sp mesh axis of size > 1"
            )
        if (cfg.zigzag_ring and cfg.attention_impl == "ring"
                and cfg.max_seq_len % (2 * sp)):
            raise ValueError(f"zigzag needs seq divisible by 2*sp={2 * sp}")
    elif sp > 1:
        raise ValueError(
            f"the mesh has sp={sp} but attention_impl={cfg.attention_impl!r}"
            f" computes shard-local attention — each sequence shard would "
            f"silently attend only to itself; use attention_impl='ring' "
            f"or 'ulysses'"
        )


def _pp_group(mesh: Mesh):
    return mesh.submesh(PP).get_group() if mesh.axis_size(PP) > 1 else None


def forward_backward(stage: LlamaStage, mesh: Mesh, tokens, n_micro: int,
                     *, positions=None, targets=None, weights=None,
                     scale: float = 1.0) -> torch.Tensor:
    """One forward and backward of the pipelined loss on this rank's
    ``tokens`` ([B_local, S_local]: its rows of the M = ``n_micro``
    microbatches, in order, and its columns with sp); the gradients land
    in the parameters' ``.grad``. Returns the loss, the same on every
    rank of the pp group: the cross-entropy (with ``targets``, ``weights``
    and ``scale``: :meth:`LlamaStage.loss`), plus the router loss of an
    MoE config."""
    import torch.distributed as dist

    cfg = stage.config
    check_pp_config(cfg, mesh)
    group = _pp_group(mesh)
    if tokens.shape[0] % n_micro:
        raise ValueError(f"{tokens.shape[0]} local rows not divisible by "
                         f"{n_micro} pipeline microbatches")
    mb, s = tokens.shape[0] // n_micro, tokens.shape[1]
    if positions is None:
        positions = torch.arange(s, device=tokens.device)
    pos = positions.to(tokens.device).expand(mb, s)
    emb = None
    if stage.first:
        emb = stage.embed(tokens.long()).to(cfg.dtype)
        x = microbatch(emb.detach(), mb)
    else:
        x = torch.empty((n_micro, mb, s, cfg.dim), dtype=cfg.dtype,
                        device=tokens.device)

    def fn(_, h):
        out = stage(h, pos)
        return out if cfg.is_moe else out[0]

    schedule = GPipe(fn, None, group, with_aux=cfg.is_moe)
    y, aux = schedule.forward(x)
    ce = torch.zeros((), dtype=torch.float32, device=tokens.device)
    if stage.last:
        # A microbatch at a time, so that the head's logits are one
        # microbatch's: the mean of M equal means is the batch's, and a
        # weighted sum adds up.
        y.requires_grad_(True)
        for i in range(n_micro):
            rows = slice(i * mb, (i + 1) * mb)
            part = stage.loss(y[i], tokens[rows],
                              None if targets is None else targets[rows],
                              None if weights is None else weights[rows],
                              scale)
            if weights is None:
                part = part / n_micro
            part.backward()
            ce += part.detach().float()
    coef = cfg.router_aux_coef / n_micro
    grad_x = schedule.backward(y.grad, coef)
    if emb is not None:
        emb.backward(grad_x.reshape(emb.shape))
    if group is not None:
        dist.all_reduce(ce, group=group)
        if cfg.tie_embeddings:
            _sum_tied_gradient(stage, group)
    return ce + coef * aux if cfg.is_moe else ce


def _sum_tied_gradient(stage: LlamaStage, group) -> None:
    """Add the first and last stage's gradients of the tied embedding
    (a stage in between adds zeros)."""
    import torch.distributed as dist

    cfg = stage.config
    embed = getattr(stage, "embed", None)
    if embed is None:
        grad = torch.zeros((cfg.vocab_size, cfg.dim),
                           device=next(stage.parameters()).device)
    else:
        if embed.weight.grad is None:
            embed.weight.grad = torch.zeros_like(embed.weight)
        grad = embed.weight.grad
    dist.all_reduce(grad, group=group)


def make_pp_train_step(stage: LlamaStage, optimizer, mesh: Mesh,
                       n_micro: int, lr_schedule=None, positions=None,
                       scale: float = 1.0):
    """``step(tokens) -> loss`` (with ``positions``, an sp rank's: ``step(
    tokens, targets, weights)``): one optimizer update from
    :func:`forward_backward` over ``n_micro`` microbatches."""
    from ..parallel.accum import make_update_step

    def run(tokens, targets=None, weights=None):
        return forward_backward(stage, mesh, tokens, n_micro,
                                positions=positions, targets=targets,
                                weights=weights, scale=scale)

    return make_update_step(None, optimizer, lr_schedule=lr_schedule,
                            forward_backward=run)

