"""Autoregressive decoding for Llama with a static KV cache (port of
``mpi_operator_tpu/models/generate.py``).

- **static cache**: ``init_cache`` preallocates [B, H_kv, S_max, D] per
  layer in the compute dtype; each step writes its position in place and
  attention scores the query against the whole cache in f32 under a
  ``<= pos`` mask;
- **one step for prompt and output**: the prompt is teacher-forced one
  token a step through the same single-token step that then emits argmax
  tokens or samples;
- **GQA-aware**: the cache holds the n_kv_heads; query heads map onto
  them group-wise, the kv heads never expand;
- MoE configs decode through ``_moe_step``: every expert on every token,
  weighted by the normalized top-k gates (no capacity, so no drops).

The step re-implements the block forward on the model's parameters by
name; teacher-forced decode logits equal the training forward's
(``tests/test_torch_generate.py``). Decode attention is plain torch
products, as the JAX package's is plain ``jnp.einsum``: no attention
kernel runs here. :func:`decode_weights` casts the matmul weights to the
compute dtype once, before the steps (the JAX step casts them each step:
the same numbers); RMSNorm scales and the MoE router stay f32.

**On a mesh** (``cmd.generate --mesh`` over dp, fsdp, tp and ep, the
JAX command's axes) each process holds its own slices as plain tensors
(:class:`DecodeShards`, :func:`shard_decode_weights`), laid out as the
JAX rules lay them out (``models/llama.py:param_sharding_rules``,
``models/moe.py:param_sharding_rules``):

- tp: q/k/v, gate and up split their output features, wo and down their
  input features; the cache holds the rank's kv heads. The row-parallel
  products' partial outputs are summed over tp in f32
  (``parallel/sharding.py:sum_partials``), then cast. A tp that does not
  divide the heads (JAX's GSPMD replicates such heads) leaves attention
  whole on every tp rank and splits only the MLP;
- ep: a rank holds E/ep experts and weights their outputs by its columns
  of the dense top-k gates; under tp each expert's hidden dim splits
  too. The partial outputs are summed over ep and tp in f32;
- fsdp: the other dim of each matrix splits over fsdp and is gathered
  one layer at a time, each step, so that no rank holds the whole model;
- dp (and fsdp): the prompt rows split over dp x fsdp when the batch
  divides, else every rank decodes every row, as JAX refuses no batch.
  The rows come together on every process at the end.

The embedding, the final norm and the LM head stay whole on every rank
(the port's standing layout), the router and the norm scales too.
Sampling draws one uniform a row of the whole batch from the generator
each step and keeps the rank's rows, so the same seed gives the same
tokens on every mesh.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Optional

import torch
import torch.nn.functional as F

from ..ops.attention import NEG_INF
from ..ops.losses import f32_logits
from ..ops.norm import rms_norm
from ..parallel.mesh import EP, FSDP, TP
from .llama import Llama, LlamaConfig, _rope, init_param
from .moe import topk_gates

# Which dim of a layer's matrix tp, fsdp and ep split at decode, by the
# name under the layer: Linear weights are [out, in], the experts [E, in,
# out] (the Flax layout). Every other parameter stays whole.
DECODE_SPLITS = {
    "attn.wq.weight": {TP: 0, FSDP: 1},
    "attn.wk.weight": {TP: 0, FSDP: 1},
    "attn.wv.weight": {TP: 0, FSDP: 1},
    "attn.wo.weight": {TP: 1, FSDP: 0},
    "mlp.w_gate.weight": {TP: 0, FSDP: 1},
    "mlp.w_up.weight": {TP: 0, FSDP: 1},
    "mlp.w_down.weight": {TP: 1, FSDP: 0},
    "moe.expert_wg": {EP: 0, FSDP: 1, TP: 2},
    "moe.expert_wu": {EP: 0, FSDP: 1, TP: 2},
    "moe.expert_wd": {EP: 0, TP: 1, FSDP: 2},
}


def _leaf(name: str) -> str:
    """A parameter's name under its layer (``layer_3.attn.wq.weight`` ->
    ``attn.wq.weight``); a name outside the layers as it is."""
    return name.split(".", 1)[1] if name.startswith("layer_") else name


@dataclasses.dataclass(frozen=True)
class DecodeShards:
    """This process's place on a decode mesh: the size, coordinate and
    process group of tp, fsdp and ep (1, 0 and None off the mesh), its
    batch shard among dp x fsdp, the world's size, whether attention
    splits by head over tp, and ``layout``: each parameter's name -> the
    dims that split it here (``{axis: dim}``). The default is one process
    holding everything."""

    sizes: dict = dataclasses.field(default_factory=dict)
    ranks: dict = dataclasses.field(default_factory=dict)
    groups: dict = dataclasses.field(default_factory=dict)
    batch_shards: int = 1
    batch_index: int = 0
    world: int = 1
    split_heads: bool = False
    layout: dict = dataclasses.field(default_factory=dict)

    @classmethod
    def of(cls, mesh, cfg: LlamaConfig) -> "DecodeShards":
        """The shards of this process on ``mesh`` (``parallel/mesh.py``)
        for ``cfg``. tp must divide ``ffn_dim`` and ep the experts (the
        command refuses both first, in JAX's words)."""
        from ..parallel.sharding import batch_index
        from ..parallel.mesh import batch_shards

        axes = (TP, FSDP, EP)
        sizes = {a: mesh.axis_size(a) for a in axes}
        ranks = {a: mesh.coordinate(a) for a in axes}
        groups = {a: mesh.submesh(a).get_group() for a in axes
                  if sizes[a] > 1}
        tp = sizes[TP]
        split_heads = (tp > 1 and cfg.n_heads % tp == 0
                       and cfg.n_kv_heads % tp == 0)
        with torch.device("meta"):
            shapes = {n: p.shape for n, p in Llama(cfg).named_parameters()}
        layout = {}
        for name, shape in shapes.items():
            leaf, dims = _leaf(name), {}
            for axis, dim in DECODE_SPLITS.get(leaf, {}).items():
                n = sizes[axis]
                if n == 1 or (axis == TP and leaf.startswith("attn.")
                              and not split_heads):
                    continue
                if shape[dim] % n:
                    if axis == FSDP:  # an indivisible dim stays whole
                        continue
                    raise ValueError(f"{axis}={n} does not divide dim {dim} "
                                     f"of {name} {tuple(shape)}")
                dims[axis] = dim
            layout[name] = dims
        return cls(sizes, ranks, groups, batch_shards(mesh),
                   batch_index(mesh), mesh.size, split_heads, layout)

    def size(self, axis: str) -> int:
        return self.sizes.get(axis, 1)

    def rank(self, axis: str) -> int:
        return self.ranks.get(axis, 0)

    def group(self, axis: str):
        """The process group of ``axis``; None when it is 1 wide."""
        return self.groups.get(axis)

    def rows(self, batch: int) -> tuple[int, int]:
        """The ``[lo, hi)`` rows of a ``batch``-row prompt this process
        decodes: its dp x fsdp shard, or every row when the batch does
        not split evenly."""
        if batch % self.batch_shards:
            return 0, batch
        per = batch // self.batch_shards
        return self.batch_index * per, (self.batch_index + 1) * per

    def gather_rows(self, mine: torch.Tensor, batch: int) -> torch.Tensor:
        """Every process's rows of a ``batch``-row result, on every
        process: each row from the one process that owns it (tp and ep
        coordinate 0, and with unsplit rows batch shard 0), summed over
        the world."""
        if self.world == 1:
            return mine
        import torch.distributed as dist

        lo, hi = self.rows(batch)
        owner = (self.rank(TP) == 0 and self.rank(EP) == 0
                 and (hi - lo < batch or self.batch_index == 0))
        full = torch.zeros((batch, *mine.shape[1:]), dtype=mine.dtype,
                           device=mine.device)
        if owner:
            full[lo:hi] = mine
        dist.all_reduce(full)
        return full


def decode_weights(model: Llama) -> dict:
    """The model's parameters by name for decoding: matmul weights (and
    the embedding) in the compute dtype, norm scales and the router in
    f32. Detached: decoding takes no gradient."""
    return shard_decode_weights(model.config, model.named_parameters(),
                                DecodeShards(), None)


def shard_decode_weights(cfg: LlamaConfig, named: Iterable,
                         shards: DecodeShards, device) -> dict:
    """This process's decode weights from ``named``, the whole model's
    ``(name, tensor)`` pairs taken one at a time (a checkpoint's host
    tensors, or :func:`seeded_params`' draws): each cut to the slices
    ``shards.layout`` gives this process, cast to the decode dtype
    (:func:`decode_weights`' rule) and only then moved to ``device``
    (None: where it is). A whole tensor is dropped once its slice is
    kept, so a rank never holds more than one whole parameter."""
    out = {}
    for name, whole in named:
        t = whole.detach()
        for axis, dim in shards.layout.get(name, {}).items():
            per = t.shape[dim] // shards.size(axis)
            t = t.narrow(dim, shards.rank(axis) * per, per)
        if not name.endswith((".scale", ".router")):
            t = t.to(cfg.dtype)
        # A copy: the slice must not keep the whole tensor alive.
        out[name] = t.to(device or t.device, copy=True)
        del whole, t
    return out


def seeded_params(cfg: LlamaConfig, generator: torch.Generator):
    """The whole model's parameters as ``models/llama.py:init_params``
    draws them from ``generator``, one at a time and in its order:
    ``(name, f32 tensor on the generator's device)`` pairs, so that a
    rank that keeps only its slices holds what one process would (the
    pipeline stages' rule, ``llama_pp.init_stage_params``)."""
    with torch.device("meta"):
        whole = Llama(cfg)
    for name, p in whole.named_parameters():
        t = torch.empty(p.shape, dtype=p.dtype, device=generator.device)
        init_param(name, t, generator)
        yield name, t


def _layer(weights: dict, i: int) -> dict:
    prefix = f"layer_{i}."
    return {k[len(prefix):]: v for k, v in weights.items()
            if k.startswith(prefix)}


def _sum_over(x, groups):
    """``x`` summed over each process group of ``groups`` (None: none)."""
    from ..parallel.sharding import sum_partials

    for group in groups:
        if group is not None:
            x = sum_partials(x, group)
    return x


def _row_parallel(a, w, group, dtype):
    """``a @ w.T`` for a row-parallel ``w`` [out, in/tp]: this rank's
    partial product in f32, summed over the tp ``group`` in f32, then
    cast to ``dtype``."""
    return _sum_over(f32_logits(a, w.t()), [group]).to(dtype)


def _attn_step(p, cache_k, cache_v, x, pos: int, cfg: LlamaConfig,
               shards: Optional[DecodeShards] = None):
    """One position through one attention block. x: [B, D]; cache_k/v:
    [B, H_kv, S_max, Dh] (this rank's kv heads), written at ``pos`` in
    place. Returns out [B, D], summed over tp when the heads split."""
    b = x.shape[0]
    hd = cfg.head_dim
    # -1: the heads this rank holds.
    q = F.linear(x, p["attn.wq.weight"]).reshape(b, -1, hd)
    k = F.linear(x, p["attn.wk.weight"]).reshape(b, -1, hd)
    v = F.linear(x, p["attn.wv.weight"]).reshape(b, -1, hd)
    positions = torch.full((b, 1), pos, device=x.device)
    q = _rope(q[:, None], positions, cfg.rope_theta)[:, 0]
    k = _rope(k[:, None], positions, cfg.rope_theta)[:, 0]
    cache_k[:, :, pos] = k.to(cache_k.dtype)
    cache_v[:, :, pos] = v.to(cache_v.dtype)

    h, h_kv = q.shape[1], k.shape[1]
    qg = q.reshape(b, h_kv, h // h_kv, hd)
    scores = torch.einsum("bkgd,bksd->bkgs", qg.float(),
                          cache_k.float()) * (hd ** -0.5)
    visible = torch.arange(cache_k.shape[2], device=x.device) <= pos
    scores = torch.where(visible, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgs,bksd->bkgd", probs, cache_v.float()).reshape(
        b, h * hd).to(cfg.dtype)
    if shards is not None and shards.split_heads:
        return _row_parallel(out, p["attn.wo.weight"], shards.group(TP),
                             cfg.dtype)
    return F.linear(out, p["attn.wo.weight"])


def _mlp_step(p, x, shards: Optional[DecodeShards] = None):
    gate = F.linear(x, p["mlp.w_gate.weight"])
    up = F.linear(x, p["mlp.w_up.weight"])
    if shards is not None and shards.size(TP) > 1:
        return _row_parallel(F.silu(gate) * up, p["mlp.w_down.weight"],
                             shards.group(TP), x.dtype)
    return F.linear(F.silu(gate) * up, p["mlp.w_down.weight"])


def _moe_step(p, x, cfg: LlamaConfig,
              shards: Optional[DecodeShards] = None):
    """One position through a sparse-MoE FFN. Each token routes alone at
    decode, so no capacity competes and nothing drops: the training
    semantics reduce to all E experts weighted by the normalized top-k
    gates (dense weights, zero off the top k). On ep a rank runs its
    block of the experts (on tp, its part of their hidden dim) and the
    partial outputs are summed in f32."""
    probs = torch.softmax(x.float() @ p["moe.router"], dim=-1)  # [B, E]
    _, _, w = topk_gates(probs, cfg.moe_top_k)
    n = p["moe.expert_wg"].shape[0]
    if shards is not None:  # this rank's experts' columns
        w = w[:, shards.rank(EP) * n:(shards.rank(EP) + 1) * n]
    hg = torch.einsum("bd,edf->bef", x, p["moe.expert_wg"])
    hu = torch.einsum("bd,edf->bef", x, p["moe.expert_wu"])
    out_e = torch.einsum("bef,efd->bed", F.silu(hg) * hu, p["moe.expert_wd"])
    out = torch.einsum("be,bed->bd", w, out_e.float())
    if shards is not None:
        out = _sum_over(out, [shards.group(EP), shards.group(TP)])
    return out.to(x.dtype)


def _all_gather(x: torch.Tensor, dim: int, group, n: int) -> torch.Tensor:
    """The ``n`` ranks' ``x`` of ``group`` joined along ``dim``."""
    import torch.distributed as dist

    out = torch.empty((n * x.shape[0], *x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    dist.all_gather_into_tensor(out, x.contiguous(), group=group)
    return torch.cat(out.chunk(n), dim=dim)


def _decode_step(weights: dict, layers: list, cfg: LlamaConfig, caches,
                 token, pos: int, shards: Optional[DecodeShards] = None,
                 gathers: Optional[dict] = None):
    """One token through the whole model. token: [B] int; caches: one
    (k, v) a layer, written in place; ``layers``: each layer's weights
    (``_layer``); ``gathers``: the fsdp dim of each layer weight that
    fsdp splits, gathered for this layer and this step only. Returns
    logits [B, V] f32."""
    x = weights["embed.weight"][token].to(cfg.dtype)  # [B, D]
    for p, (ck, cv) in zip(layers, caches):
        if gathers:
            p = {k: (_all_gather(v, gathers[k], shards.group(FSDP),
                                 shards.size(FSDP)) if k in gathers else v)
                 for k, v in p.items()}
        h = rms_norm(x, p["attn_norm.scale"], cfg.norm_eps)
        x = x + _attn_step(p, ck, cv, h, pos, cfg, shards)
        h = rms_norm(x, p["mlp_norm.scale"], cfg.norm_eps)
        x = x + (_moe_step(p, h, cfg, shards) if cfg.is_moe
                 else _mlp_step(p, h, shards))
    x = rms_norm(x, weights["final_norm.scale"], cfg.norm_eps)
    head = (weights["embed.weight"] if cfg.tie_embeddings
            else weights["lm_head.weight"])
    # bf16 x bf16 -> f32 logits (ops/losses.py:f32_logits), head [D, V].
    return f32_logits(x, head.t())


def init_cache(cfg: LlamaConfig, batch: int, max_len: int, dtype=None,
               device=None, n_kv_heads: Optional[int] = None) -> list:
    """Each layer's (k, v) cache [batch, n_kv_heads (default: all of
    them), max_len, head_dim], zeros."""
    dtype = dtype or cfg.dtype
    shape = (batch, n_kv_heads or cfg.n_kv_heads, max_len, cfg.head_dim)
    return [(torch.zeros(shape, dtype=dtype, device=device),
             torch.zeros(shape, dtype=dtype, device=device))
            for _ in range(cfg.n_layers)]


class Decoder:
    """Decode state for one batch: the weights cast once, each layer's
    view of them and the static cache. ``step(token, pos)`` runs one
    position and returns its f32 logits.

    ``model``: a Llama, or its config when ``weights`` are given (a rank
    of a mesh never builds the whole model); ``shards``: this process's
    place on a decode mesh, whose ``weights`` are its slices
    (:func:`shard_decode_weights`) and ``batch`` its rows."""

    def __init__(self, model, batch: int, max_len: int,
                 weights: dict = None, shards: DecodeShards = None):
        cfg = self.config = (model if isinstance(model, LlamaConfig)
                             else model.config)
        self.weights = weights if weights is not None else decode_weights(
            model)
        self.shards = shards
        self.layers = [_layer(self.weights, i) for i in range(cfg.n_layers)]
        self.gathers = {}
        if shards is not None and shards.size(FSDP) > 1:
            self.gathers = {_leaf(name): dims[FSDP]
                            for name, dims in shards.layout.items()
                            if name.startswith("layer_0.") and FSDP in dims}
        device = self.weights["embed.weight"].device
        kv_heads = self.layers[0]["attn.wk.weight"].shape[0] // cfg.head_dim
        self.caches = init_cache(cfg, batch, max_len, device=device,
                                 n_kv_heads=kv_heads)

    def step(self, token, pos: int):
        return _decode_step(self.weights, self.layers, self.config,
                            self.caches, token, pos, self.shards,
                            self.gathers)


@torch.no_grad()
def decode_logits_teacher_forced(model, tokens, weights: dict = None,
                                 shards: DecodeShards = None
                                 ) -> torch.Tensor:
    """The decode path's logits [B, S, V] with ``tokens`` [B, S] teacher-
    forced: position t's equal the training forward's at t. ``model``,
    ``weights`` and ``shards`` as for :func:`generate`; on a mesh, the
    logits of this process's rows (``shards.rows``)."""
    tokens = tokens.long()
    if shards is not None:
        lo, hi = shards.rows(tokens.shape[0])
        tokens = tokens[lo:hi]
    dec = Decoder(model, tokens.shape[0], tokens.shape[1], weights, shards)
    return torch.stack([dec.step(tokens[:, t], t)
                        for t in range(tokens.shape[1])], dim=1)


def _sample(logits, temperature: float, generator: torch.Generator,
            batch: int, lo: int):
    """Softmax sampling at ``temperature`` by the inverse CDF: one uniform
    a row of the whole ``batch`` drawn from ``generator``, of which this
    process's rows ``lo:`` pick its tokens, so the draw does not depend
    on how the rows are split."""
    u = torch.rand(batch, generator=generator, device=generator.device)
    u = u[lo:lo + logits.shape[0]].to(logits.device)
    cdf = torch.cumsum(torch.softmax(logits / temperature, dim=-1), dim=-1)
    token = torch.searchsorted(cdf, (u * cdf[:, -1])[:, None], right=True)
    return token[:, 0].clamp_(max=logits.shape[-1] - 1)


@torch.no_grad()
def generate(model, prompt, *, max_new: int, temperature: float = 0.0,
             generator: torch.Generator = None, weights: dict = None,
             shards: DecodeShards = None) -> torch.Tensor:
    """Decode ``max_new`` tokens after ``prompt`` [B, S0]: for the first
    S0-1 steps the next input is the prompt's token, afterwards the
    model's own. temperature 0 = greedy (argmax, the first of equal
    maxima); > 0 = softmax sampling at that temperature, drawn from
    ``generator`` (required). ``weights``: :func:`decode_weights` made
    beforehand (else made here). ``model`` and ``shards`` as for
    :class:`Decoder`: on a mesh each process decodes its rows and every
    process returns all of them. Returns [B, S0 + max_new] tokens."""
    if temperature > 0 and generator is None:
        raise ValueError(
            "sampling (temperature > 0) needs a torch.Generator")
    prompt = prompt.long()
    b, s0 = prompt.shape
    lo, hi = shards.rows(b) if shards is not None else (0, b)
    mine = prompt[lo:hi]
    dec = Decoder(model, hi - lo, s0 + max_new, weights, shards)
    out = [mine[:, :1]]
    token = mine[:, 0]
    for t in range(s0 + max_new - 1):
        logits = dec.step(token, t)
        if t + 1 < s0:  # teacher-forced inside the prompt
            token = mine[:, t + 1]
        elif temperature > 0:
            token = _sample(logits, temperature, generator, b, lo)
        else:
            token = logits.argmax(dim=-1)
        out.append(token[:, None])
    out = torch.cat(out, dim=1)
    return shards.gather_rows(out, b) if shards is not None else out
