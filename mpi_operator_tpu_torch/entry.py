"""The port's compute entry points: the counterpart of the repo's
``__graft_entry__.py``, for the card.

``entry(device="cuda")``
    ``(forward, args)``: the flagship benchmark model's eval forward
    (ResNet-101, B=8, 224x224, ``models/resnet.py``) and the projection-
    layout flash forward kernel (``ops/attention.py:flash_attention_bshd``,
    causal, bf16 ``q [2, 512, 8, 128]``, ``k, v [2, 512, 4, 128]``).
    ``forward(model, images, q, k, v) -> (logits, att)`` takes the model
    first, as the JAX forward takes its params first; on the card one call
    launches the flat forward kernel once.

``dryrun_multichip(n, device="cuda")``
    One real train step of every mesh composition the JAX package's
    dryrun runs, in one world of ``n`` processes: Llama on dp x fsdp x tp
    x sp with ring attention and with Ulysses, the MoE Llama on dp x ep x
    tp, the GPipe pipeline on dp x fsdp x pp, at ``n % 8 == 0`` sp x tp x
    pp (ring) and MoE x pp, the cross-slice HSDP step (dp=2 outermost x
    fsdp=n/2) and ResNet-18 on dp x fsdp, with JAX's carving of ``n``
    into axes, its tiny configs, batches and seeds. Each step asserts a
    finite loss; the pipeline and cross-slice steps also that the weights
    moved. Then the sharding receipt, the counterpart of JAX's failure on
    an involuntary full rematerialization: every parameter the
    composition's plan shards (FSDP2 on dim 0, tp columns or rows, ep
    experts, the pp stage's layers) has the plan's local shape on every
    rank, or the dryrun raises naming the rank.

    The world is spawned here (a free port pair, each rank's rendezvous
    env, a timeout of its own). On ``device="cpu"`` the ranks take
    ``utils/env.py:cpu_subprocess_env()`` and gloo; on the card, ranks
    that share one card run over gloo (NCCL refuses two ranks on one GPU),
    each held to an equal share of its memory, and ranks on cards of their
    own over NCCL.

Each composition initializes its model from a ``torch.Generator`` seeded
with the JAX dryrun's ``PRNGKey`` seed (:func:`initial_state`: the numbers
differ from ``jax.random``'s, the seed does not), and draws its batch from
the same ``numpy`` seeds and shapes (:func:`global_batch`), so a JAX model
given the same parameters computes the same first loss. The port runs the
MoE pipeline's attention through the flash kernels, where the JAX dryrun
leaves ``tiny_moe`` on its default dense attention: every Llama and MoE
step here goes through the flat kernels.

Run it as ``python -m mpi_operator_tpu_torch.entry`` (the forward once on
the card), ``... --dryrun 8`` (the dryrun over 8 processes) and ``...
--device cpu`` for either on the CPU.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Optional

import numpy as np

# What a rank prints before each composition's record.
RECORD_PREFIX = '{"dryrun": '
# Each rank's own time limit (the whole world at n=8 takes well under a
# minute on the card and on the CPU).
RANK_TIMEOUT_S = 600.0
# Kept free on a shared card beside each rank's allocator share: its
# CUDA context and the kernels' modules.
RANK_CONTEXT_BYTES = 1_000_000_000


def entry(device: str = "cuda"):
    """``(forward, (model, images, q, k, v))``: ResNet-101's eval forward
    (seeded parameters, ``.eval()``, channels_last) at B=8, 224x224, and
    the causal flash forward on bf16 ``q [2, 512, 8, 128]``, ``k, v [2,
    512, 4, 128]``, every input zeros as in the JAX entry. The tensors
    live on ``device``: the card unless the caller asks for the CPU."""
    import torch

    from .models import resnet as resnet_lib

    device = _device(device)
    model = resnet_lib.resnet101(device=device)
    resnet_lib.init_params(
        model, torch.Generator(device=device).manual_seed(0))
    model.to(memory_format=torch.channels_last).eval()
    images = torch.zeros((8, 3, 224, 224), device=device).to(
        memory_format=torch.channels_last)
    q = torch.zeros((2, 512, 8, 128), dtype=torch.bfloat16, device=device)
    kv = torch.zeros((2, 512, 4, 128), dtype=torch.bfloat16, device=device)
    return forward, (model, images, q, kv, kv)


def forward(model, images, q, k, v):
    """``(logits, att)``: ``model``'s eval forward of ``images`` ([N, 3, H,
    W]) and the causal flash forward of ``q, k, v`` ([B, S, H, D]), no
    autograd."""
    from .ops.attention import flash_attention_bshd

    import torch

    with torch.no_grad():
        logits = model(images)
        att = flash_attention_bshd(q, k, v, causal=True)
    return logits, att


def _device(device: str):
    import torch

    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: pass device='cpu' to run on the CPU")
    return device


# -- the compositions ------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Composition:
    """One train step of the dryrun: its mesh, model and data, as the
    JAX dryrun builds them."""

    name: str
    mesh: tuple                  # ((axis, size), ...), outer to inner
    model: str                   # "llama", "llama_pp" or "resnet"
    config: tuple = ()           # llama.tiny / tiny_moe overrides
    moe: bool = False
    init_seed: int = 0           # the JAX dryrun's PRNGKey
    data_seed: int = 0           # its numpy RandomState (tokens)
    batch: int = 0               # global rows
    seq: int = 16
    microbatches: int = 1        # pipeline microbatches M
    optimizer: tuple = ("adamw", 1e-3)
    check_moved: bool = False

    @property
    def sizes(self) -> dict:
        return dict(self.mesh)

    def llama_config(self):
        from .models import llama as lib

        make = lib.tiny_moe if self.moe else lib.tiny
        return make(**dict(self.config))


def compositions(n: int) -> list:
    """The JAX dryrun's compositions over ``n`` devices, in its order."""
    out = []
    # Llama on all four standard axes, innermost (sp, tp) first.
    rest = n
    sp = 2 if rest % 2 == 0 else 1
    rest //= sp
    tp = 2 if rest % 2 == 0 else 1
    rest //= tp
    fsdp = 2 if rest % 2 == 0 else 1
    rest //= fsdp
    mesh = (("dp", rest), ("fsdp", fsdp), ("tp", tp), ("sp", sp))
    llama = dict(batch=2 * max(rest * fsdp, 1), seq=8 * sp)
    heads = (("n_heads", 4), ("n_kv_heads", 2), ("dim", 64))
    out.append(Composition(
        "llama dp x fsdp x tp x sp (ring)", mesh, "llama",
        (("attention_impl", "ring" if sp > 1 else "flash"), *heads),
        **llama))
    if sp > 1:
        out.append(Composition(
            "llama ulysses", mesh, "llama",
            (("attention_impl", "ulysses"), *heads), init_seed=1, **llama))
    # MoE Llama on dp x ep x tp.
    rest = n
    tp_e = 2 if rest % 2 == 0 else 1
    rest //= tp_e
    ep = 2 if rest % 2 == 0 else 1
    rest //= ep
    out.append(Composition(
        "moe dp x ep x tp", (("dp", rest), ("ep", ep), ("tp", tp_e)),
        "llama", (("attention_impl", "flash"), ("n_experts", 2 * ep)),
        moe=True, data_seed=2, batch=2 * rest))
    # GPipe on dp x fsdp x pp: 2*pp microbatches of dp*fsdp rows.
    pp = 2 if n % 2 == 0 else 1
    fsdp_pp = 2 if (n // pp) % 2 == 0 else 1
    dp_pp = n // pp // fsdp_pp
    out.append(Composition(
        "pipeline dp x fsdp x pp",
        (("dp", dp_pp), ("pp", pp), ("fsdp", fsdp_pp)), "llama_pp",
        (("n_layers", pp), ("attention_impl", "flash"), ("dim", 64)),
        init_seed=3, data_seed=4, batch=2 * pp * dp_pp * fsdp_pp,
        microbatches=2 * pp, optimizer=("sgd", 1e-2), check_moved=True))
    if n % 8 == 0:
        dp_pt = n // 8
        out.append(Composition(
            "sp x tp x pp ring",
            (("dp", dp_pt), ("pp", 2), ("tp", 2), ("sp", 2)), "llama_pp",
            (("n_layers", 2), ("attention_impl", "ring"), ("dim", 64)),
            init_seed=5, data_seed=6, batch=4 * dp_pt, microbatches=4,
            optimizer=("sgd", 1e-2), check_moved=True))
        dp_mp = n // 4
        out.append(Composition(
            "moe x pp", (("dp", dp_mp), ("pp", 2), ("ep", 2)), "llama_pp",
            (("n_layers", 2), ("attention_impl", "flash"), ("dim", 64)),
            moe=True, init_seed=7, data_seed=8, batch=4 * dp_mp,
            microbatches=4, optimizer=("sgd", 1e-2), check_moved=True))
    if n % 2 == 0:
        # Two "slices", the halves of the world, dp outermost across them.
        out.append(Composition(
            "cross-slice dp x fsdp", (("dp", 2), ("fsdp", n // 2)), "llama",
            (("attention_impl", "flash"),), init_seed=2, data_seed=3,
            batch=2 * n, check_moved=True))
    dp_r = 2 if n % 2 == 0 else 1
    out.append(Composition(
        "resnet dp x fsdp", (("dp", dp_r), ("fsdp", n // dp_r)), "resnet",
        batch=2 * n, optimizer=("sgd_momentum", 0.1)))
    return out


def initial_state(comp: Composition) -> dict:
    """The whole model's initial state dict on the CPU: what every rank
    draws before it keeps its part (a pipeline stage loads its layers)."""
    import torch

    generator = torch.Generator().manual_seed(comp.init_seed)
    if comp.model == "resnet":
        from .models import resnet as lib

        model = lib.init_params(lib.resnet(18, num_classes=64), generator)
    else:
        from .models import llama as lib

        model = lib.init_params(lib.Llama(comp.llama_config()), generator)
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def global_batch(comp: Composition) -> tuple:
    """The global batch as numpy arrays, drawn as the JAX dryrun draws
    it: ``(tokens,)`` for Llama, ``(images NHWC, labels)`` for ResNet."""
    if comp.model == "resnet":
        images = np.random.RandomState(0).standard_normal(
            (comp.batch, 32, 32, 3)).astype(np.float32)
        labels = np.random.RandomState(1).randint(0, 64, (comp.batch,))
        return images, labels
    vocab = comp.llama_config().vocab_size
    return (np.random.RandomState(comp.data_seed).randint(
        0, vocab, (comp.batch, comp.seq)),)


# -- the sharding receipt ---------------------------------------------------

def _chunk(size: int, parts: int, index: int) -> int:
    """The length of shard ``index`` of ``size`` split ``parts`` ways, as
    DTensor and FSDP2 cut a dim (``torch.chunk``)."""
    per = -(-size // parts)
    return max(0, min(per, size - index * per))


def planned_placements(model, mesh, whole=()) -> dict:
    """name -> [(dim, axis), ...]: where the composition's plan shards
    each parameter of ``model``, in the order the layouts apply (the ep x
    tp experts, the tp plan, then FSDP2 on dim 0 over fsdp)."""
    from torch.distributed.tensor.parallel import ColwiseParallel

    from .models import llama as llama_lib
    from .models.moe import EXPERT_HIDDEN_DIM

    plan = {}
    if mesh.axis_size("tp") > 1 and hasattr(model, "blocks"):
        plan = llama_lib.tensor_parallel_plan(model, mesh.axis_size("tp"))
    kept = {id(p) for p in whole}
    out = {}
    for name, p in model.named_parameters():
        module, _, leaf = name.rpartition(".")
        dims = []
        if leaf in EXPERT_HIDDEN_DIM:
            dims += [(d, a) for d, a in ((0, "ep"),
                                         (EXPERT_HIDDEN_DIM[leaf], "tp"))
                     if mesh.axis_size(a) > 1]
        elif module in plan:
            column = isinstance(plan[module], ColwiseParallel)
            if column or leaf == "weight":
                dims.append((0 if column else 1, "tp"))
        if mesh.axis_size("fsdp") > 1 and id(p) not in kept:
            dims.append((0, "fsdp"))
        out[name] = dims
    return out


def stage_names(names, n_layers: int, stage: int, n_stages: int) -> set:
    """The parameter names of ``names`` (the whole model's) that pipeline
    stage ``stage`` of ``n_stages`` holds: its layers, the embedding on
    the first stage, the final norm and the head on the last."""
    per = n_layers // n_stages
    prefixes = tuple(f"layer_{k}." for k in range(stage * per,
                                                   (stage + 1) * per))
    if stage == 0:
        prefixes += ("embed.",)
    if stage == n_stages - 1:
        prefixes += ("final_norm.", "lm_head.")
    return {n for n in names if n.startswith(prefixes)}


def sharding_receipt(model, mesh, full_shapes: dict, placements: dict,
                     names: Optional[set] = None) -> list:
    """Each way ``model``'s parameters depart from the plan on this rank:
    a parameter whose local shape is not the plan's (``placements`` from
    the whole model's ``full_shapes``), and with ``names`` (a pipeline
    stage's) a parameter the stage should not hold or one it lacks. An
    empty list is the receipt."""
    problems = []
    held = dict(model.named_parameters())
    if names is not None:
        problems += [f"{n} held outside its stage" for n in
                     sorted(set(held) - names)]
        problems += [f"{n} of its stage missing" for n in
                     sorted(names - set(held))]
    for name, p in held.items():
        full = tuple(full_shapes[name])
        want = list(full)
        for dim, axis in placements.get(name, ()):
            want[dim] = _chunk(want[dim], mesh.axis_size(axis),
                               mesh.coordinate(axis))
        local = tuple(p.to_local().shape if hasattr(p, "to_local")
                      else p.shape)
        if local != tuple(want):
            what = "whole" if local == full else "local"
            problems.append(f"{name} {what} {list(local)} where the plan "
                            f"keeps {want}")
    return problems


def check_receipts(ranks: list) -> None:
    """Raise naming the first rank whose record of a composition carries
    sharding-receipt problems (``ranks``: each rank's records)."""
    for rank, records in enumerate(ranks):
        for rec in records:
            if rec.get("receipt"):
                raise RuntimeError(
                    f"dryrun_multichip: sharding receipt failed on rank "
                    f"{rank} in {rec['name']!r}: "
                    + "; ".join(rec["receipt"][:8]))


# -- one rank ---------------------------------------------------------------

def _optimizer(comp: Composition, params):
    """``optax.adamw(lr)`` (its defaults: b1 0.9, b2 0.999, eps 1e-8, weight
    decay 1e-4), ``optax.sgd(lr)`` or ``optax.sgd(lr, momentum=0.9)``."""
    import torch
    from torch.distributed.tensor import DTensor

    params = list(params)
    kind, lr = comp.optimizer
    # DTensor and plain parameters side by side (a pipeline stage's whole
    # embedding and head beside its FSDP2 blocks), which the multi-tensor
    # (foreach) kernels refuse to mix, take the per-parameter loop.
    foreach = False if len({isinstance(p, DTensor)
                            for p in params}) > 1 else None
    if kind == "adamw":
        return torch.optim.AdamW(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                                 weight_decay=1e-4, foreach=foreach)
    momentum = 0.9 if kind == "sgd_momentum" else 0.0
    return torch.optim.SGD(params, lr=lr, momentum=momentum, foreach=foreach)


def _local(t):
    return t.to_local() if hasattr(t, "to_local") else t


def _build(comp: Composition, mesh, state: dict):
    """(module, step, local batch tensors, parameters left whole, the
    stage's parameter names or None) on this rank, its parameters laid
    out on ``mesh``."""
    import torch

    from .cmd.train import _as_tensors, _sequence_batch
    from .parallel.sharding import (
        average_gradients,
        local_positions,
        shard_batch,
        shard_params,
    )

    device = mesh.device
    arrays = global_batch(comp)
    if comp.model == "resnet":
        from .models import resnet as lib

        model = lib.resnet(18, num_classes=64, device=device)
        model.load_state_dict(state)
        model.to(memory_format=torch.channels_last).train()
        shard_params(model, mesh, tp_plan=lambda: {})
        optimizer = _optimizer(comp, model.parameters())
        average_gradients(optimizer, mesh)
        images, labels = _as_tensors(shard_batch(arrays, mesh), device)
        return (model, lib.make_train_step(model, optimizer),
                (images.permute(0, 3, 1, 2), labels), (), None)

    from .models import llama as lib

    cfg = comp.llama_config()
    sizes = comp.sizes
    sp, tp = sizes.get("sp", 1), sizes.get("tp", 1)
    group = mesh.submesh("sp").get_group() if sp > 1 else None
    tokens = arrays[0]
    kw = {}
    if sp > 1:
        positions = local_positions(comp.seq, mesh)
        arrays = _sequence_batch(tokens, positions)
        shards = sizes.get("dp", 1) * sizes.get("fsdp", 1)
        kw = dict(positions=torch.as_tensor(positions, device=device),
                  scale=shards * sp / (comp.batch * (comp.seq - 1)))
    batch = _as_tensors(shard_batch(arrays, mesh, comp.microbatches), device)
    whole, names = (), None
    if comp.model == "llama_pp":
        from .models import llama_pp as pp_lib

        stage, n_stages = mesh.coordinate("pp"), sizes.get("pp", 1)
        model = pp_lib.LlamaStage(cfg, stage, n_stages, device=device,
                                  sp_group=group)
        names = stage_names(state, cfg.n_layers, stage, n_stages)
        model.load_state_dict({k: v for k, v in state.items()
                               if k in model.state_dict()})
        whole = model.edge_params()
    else:
        model = lib.Llama(cfg, device=device, sp_group=group)
        model.load_state_dict(state)
    shard_params(model, mesh, tp_plan=lambda: lib.tensor_parallel_plan(
        model, tp), whole=whole)
    optimizer = _optimizer(comp, model.parameters())
    average_gradients(optimizer, mesh)
    if comp.model == "llama_pp":
        step = pp_lib.make_pp_train_step(model, optimizer, mesh,
                                         comp.microbatches, **kw)
    else:
        step = lib.make_train_step(model, optimizer, **kw)
    return model, step, batch, whole, names


def _run(comp: Composition, device) -> dict:
    """``comp``'s train step on this rank; its record."""
    import torch
    import torch.distributed as dist

    from .cmd.train import _global_mean
    from .ops import attention, bn
    from .parallel.mesh import MeshConfig, create_mesh

    t0 = time.perf_counter()
    mesh = create_mesh(device, MeshConfig(comp.mesh))
    rank = dist.get_rank() if dist.is_initialized() else 0
    if comp.name.startswith("cross-slice"):
        # dp is the outermost axis: rank i's dp peer is rank i + n/2, as
        # the JAX dryrun asserts of the device halves.
        half = mesh.size // 2
        peers = dist.get_process_group_ranks(mesh.submesh("dp").get_group())
        if peers != [rank % half, rank % half + half]:
            raise AssertionError(f"rank {rank}: dp peers {peers}, want "
                                 f"{[rank % half, rank % half + half]}")
    state = initial_state(comp)
    model, step, batch, whole, names = _build(comp, mesh, state)
    placements = planned_placements(model, mesh, whole)
    before = {n: _local(p).detach().clone()
              for n, p in model.named_parameters()}
    attention.reset_launch_counts()
    bn.reset_launch_counts()
    loss = step(*batch)
    launches = {**attention.LAUNCHES, **bn.LAUNCHES}
    local_loss = float(loss)
    loss = float(_global_mean(loss))
    if not np.isfinite(local_loss) or not np.isfinite(loss):
        raise AssertionError(f"rank {rank}: non-finite {comp.name} loss "
                             f"{local_loss}")
    moved = None
    if comp.check_moved:
        moved = max(float((_local(p).detach() - before[n]).abs().max())
                    for n, p in model.named_parameters()
                    if n.startswith("layer_"))
        if not moved > 0.0:
            raise AssertionError(f"rank {rank}: the {comp.name} update left "
                                 f"the block weights unchanged")
    receipt = sharding_receipt(
        model, mesh, {k: v.shape for k, v in state.items()}, placements,
        names)
    if device.type == "cuda":
        torch.cuda.synchronize()
    return {"name": comp.name, "mesh": mesh.sizes, "loss": loss,
            "launches": launches, "moved": moved, "receipt": receipt,
            "sharded": sum(1 for dims in placements.values() if dims),
            "params": len(placements),
            "seconds": round(time.perf_counter() - t0, 3)}


def dryrun_rank(n: int, device: str) -> int:
    """One rank of the dryrun's world (its rendezvous env set by the
    parent): every composition in turn, one record line each."""
    import torch

    from .launcher import bootstrap

    share = int(os.environ.get("DRYRUN_RANK_MEMORY_BYTES", "0"))
    if device == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    bootstrap.initialize(device_type=device)
    dev = bootstrap.process_device(
        int(os.environ.get("TPUJOB_PROCESS_ID", "0")), device)
    if share and dev.type == "cuda":
        torch.cuda.set_per_process_memory_fraction(
            min(1.0, share / torch.cuda.mem_get_info(dev)[1]), dev)
    for comp in compositions(n):
        record = _run(comp, dev)
        # The parent reads its ranks' records from their stdout files.
        print(RECORD_PREFIX + json.dumps(record) + "}",  # noqa: TPU201
              flush=True)
        if record["receipt"]:
            break
    bootstrap.shutdown()
    return 0


# -- the world --------------------------------------------------------------

def _world_env(n: int, device: str) -> tuple[dict, list]:
    """(the env every rank shares, each rank's extra env) for a world of
    ``n`` on ``device``."""
    from .utils.env import cpu_subprocess_env

    if device == "cpu":
        return cpu_subprocess_env(), [{} for _ in range(n)]
    import torch

    env = dict(os.environ)
    cards = torch.cuda.device_count()
    if n <= cards:
        return env, [{} for _ in range(n)]
    # Ranks share cards: gloo (NCCL refuses two ranks on one GPU), each
    # rank's allocator held to an equal share of its card's free memory,
    # and the host's cores split between them (gloo reduces on the CPU).
    env["TPUJOB_DIST_BACKEND"] = "gloo"
    env["OMP_NUM_THREADS"] = str(max(1, (os.cpu_count() or 1) // n))
    per_card = -(-n // cards)
    extra = []
    for rank in range(n):
        free, _ = torch.cuda.mem_get_info(rank % cards)
        share = max(free // per_card - RANK_CONTEXT_BYTES, 0)
        extra.append({"DRYRUN_RANK_MEMORY_BYTES": str(share)})
    return env, extra


def dryrun_multichip(n_devices: int, device: str = "cuda") -> list:
    """Run every composition of :func:`compositions` once over a world of
    ``n_devices`` processes on ``device``. Returns one dict a composition:
    its name, mesh, the global first-step loss, each rank's kernel launch
    counts (``launches``), each rank's count of parameters the plan
    shards (``sharded``, of ``params``: the receipt held each to its
    local shape) and the seconds rank 0 took. Raises when a rank
    fails or outlives RANK_TIMEOUT_S (naming it, with the end of its log),
    or when the sharding receipt fails on any rank (naming the rank)."""
    from .utils.net import free_port_pair

    if device == "cuda":
        _device(device)
        from .ops import _build

        # Once here, not once a rank: the ranks load what this built.
        _build.build()
    base, extra = _world_env(n_devices, device)
    port = free_port_pair()
    repo = str(Path(__file__).resolve().parent.parent)
    with tempfile.TemporaryDirectory(prefix="dryrun_") as tmp:
        procs, logs = [], []
        for rank in range(n_devices):
            env = {**base, **extra[rank],
                   "TPUJOB_COORDINATOR_ADDRESS": f"127.0.0.1:{port}",
                   "TPUJOB_NUM_PROCESSES": str(n_devices),
                   "TPUJOB_PROCESS_ID": str(rank),
                   "TPU_WORKER_ID": str(rank)}
            out, err = Path(tmp, f"rank{rank}.out"), Path(tmp, f"rank{rank}.err")
            logs.append((out, err))
            # Files, not pipes: a rank blocked on a full pipe would stall
            # its peers' collectives.
            with out.open("w") as o, err.open("w") as e:
                procs.append(subprocess.Popen(
                    [sys.executable, "-m", "mpi_operator_tpu_torch.entry",
                     "--dryrun-rank", str(n_devices), "--device", device],
                    env=env, cwd=repo, stdout=o, stderr=e))
        deadline = time.monotonic() + RANK_TIMEOUT_S
        try:
            while any(p.poll() is None for p in procs):
                for rank, p in enumerate(procs):
                    if p.poll() not in (None, 0):
                        _fail(rank, n_devices, p.returncode, logs[rank][1])
                if time.monotonic() > deadline:
                    late = [r for r, p in enumerate(procs) if p.poll() is None]
                    raise RuntimeError(
                        f"dryrun_multichip: ranks {late} of {n_devices} "
                        f"still running after {RANK_TIMEOUT_S:.0f} s")
                time.sleep(0.2)
            for rank, p in enumerate(procs):
                if p.returncode != 0:
                    _fail(rank, n_devices, p.returncode, logs[rank][1])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        ranks = [[json.loads(line[len(RECORD_PREFIX):-1])
                  for line in out.read_text().splitlines()
                  if line.startswith(RECORD_PREFIX)] for out, _ in logs]
    check_receipts(ranks)
    want = [c.name for c in compositions(n_devices)]
    for rank, records in enumerate(ranks):
        if [r["name"] for r in records] != want:
            raise RuntimeError(f"dryrun_multichip: rank {rank} ran "
                               f"{[r['name'] for r in records]}, want {want}")
    results = []
    for i, rec in enumerate(ranks[0]):
        losses = {r[i]["loss"] for r in ranks}
        if len(losses) != 1:
            raise RuntimeError(f"dryrun_multichip: {rec['name']}: the ranks "
                               f"disagree on the global loss {losses}")
        results.append({"name": rec["name"], "mesh": rec["mesh"],
                         "loss": rec["loss"], "seconds": rec["seconds"],
                         "launches": [r[i]["launches"] for r in ranks],
                         "sharded": [r[i]["sharded"] for r in ranks],
                         "params": [r[i]["params"] for r in ranks]})
    summary = ", ".join(f"{r['name']} {r['mesh']} loss={r['loss']:.4f}"
                        for r in results)
    # The JAX dryrun's summary line, for a caller that reads stdout.
    print(f"dryrun_multichip OK: {n_devices} processes on "  # noqa: TPU201
          f"{device}, {summary}", flush=True)
    return results


def _fail(rank: int, n: int, rc: int, err: Path) -> None:
    raise RuntimeError(f"dryrun_multichip: rank {rank} of {n} exited {rc}:\n"
                       f"{err.read_text()[-4000:]}")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m mpi_operator_tpu_torch.entry",
        description=__doc__.splitlines()[0])
    parser.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    parser.add_argument("--dryrun", type=int, default=0, metavar="N",
                        help="run dryrun_multichip over N processes instead "
                             "of the entry forward")
    parser.add_argument("--dryrun-rank", type=int, default=0,
                        help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if args.dryrun_rank:
        return dryrun_rank(args.dryrun_rank, args.device)
    if args.dryrun:
        dryrun_multichip(args.dryrun, args.device)
        return 0
    fn, inputs = entry(args.device)
    logits, att = fn(*inputs)
    # The command's result line (this module is a ``python -m`` command).
    print(json.dumps({"logits": list(logits.shape),  # noqa: TPU201
                      "att": list(att.shape),
                      "finite": bool(logits.float().isfinite().all())}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
