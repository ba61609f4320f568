"""Training entrypoint -- the port of ``mpi_operator_tpu/cmd/train.py``,
ResNet, Llama (dense and MoE), BERT, ViT and seq2seq arms, one process
per device:

    python -m mpi_operator_tpu_torch.cmd.train      # resnet101, 224x224, B=64
    python -m mpi_operator_tpu_torch.cmd.train --model resnet101 \\
        --bn-kernel pallas --steps 6 --warmup 2
    python -m mpi_operator_tpu_torch.cmd.train --model llama3-8b \\
        --n-layers 2 --seq-len 2048 --global-batch 2 --xent-chunk 1024 \\
        --steps 6 --warmup 2 --lr 3e-4
    python -m mpi_operator_tpu_torch.cmd.train --model bert-base \\
        --global-batch 64 --seq-len 512 --mlm-layout positions \\
        --steps 6 --warmup 2 --lr 1e-4
    python -m mpi_operator_tpu_torch.cmd.train --model mixtral-8x7b \\
        --n-layers 2 --seq-len 2048 --global-batch 2 --xent-chunk 1024 \\
        --steps 6 --warmup 2 --lr 3e-4
    python -m mpi_operator_tpu_torch.cmd.train --model vit-base \\
        --global-batch 64 --steps 6 --warmup 2 --lr 1e-4
    python -m mpi_operator_tpu_torch.cmd.train --model seq2seq-small \\
        --global-batch 16 --seq-len 512 --steps 6 --warmup 2 --lr 1e-4
    python -m mpi_operator_tpu_torch.cmd.train --model bert-base \\
        --global-batch 64 --seq-len 512 --mlm-layout positions \\
        --data corpus.u32 --checkpoint-dir /ckpt/bert --save-every 100 \\
        --async-checkpoint --steps 1000 --lr 1e-4

Flow: rendezvous (launcher.bootstrap: a one-process job skips it; a
larger one forms its torch.distributed world from the controller's env)
-> the mesh from ``--mesh`` over the world -> model, placed on the mesh
(``parallel/sharding.py``: a tensor-parallel plan on tp, ResNet's
replicated over it, FSDP2 on fsdp, HSDP on dp x fsdp, MoE experts
sharded on ep and their hidden dim on tp, gradient averaging on dp alone
and on sp; on sp each rank keeps its positions of its rows and the
attention runs as a ring or Ulysses over the sp group of its tp
coordinate, on its local heads; on pp a Llama rank builds its stage of
the layers and the step runs the GPipe schedule, ``models/llama_pp.py``)
+ optimizer
(ResNet:
SGD nesterov momentum 0.9; Llama, BERT, ViT and seq2seq: AdamW) ->
resume from ``--checkpoint-dir``
(``utils/checkpoint.py``; ``--steps`` is an ABSOLUTE target)
-> step loop with warmup boundary, log cadence, a checkpoint save after
every step (the manager's interval decides), SIGTERM stop (agreed by
every process each step, so the gang stops at one step), step-slowdown
chaos, telemetry (with ``--heartbeat-every``: windowed step heartbeats
and one device-memory sample a window, which the pod runner patches onto
the pod), the optional ``--profile-dir`` trace and the ``TPU_JAX_TRACE``
build/sync report -> the preempted-or-final save drained inside the
grace budget -> one JSON summary line on stdout from every process, with
the JAX trainer's keys: ``loss`` is the global batch's, ``devices`` the
world size.

    # two processes, data parallel (the controller renders this env):
    TPUJOB_COORDINATOR_ADDRESS=host0:8476 TPUJOB_NUM_PROCESSES=2 \
    TPUJOB_PROCESS_ID=0 python -m mpi_operator_tpu_torch.cmd.train \
        --model bert-base --mesh dp=2 ...

``--bn-kernel`` keeps the JAX values so that a TPUJob's args mean the
same on both packages: ``xla`` (the default) normalizes with plain
PyTorch reductions, ``pallas`` through the hand-written CUDA BN kernels
(``csrc/bn_stats.cu``, ``csrc/bn_grads.cu``; their plain versions on
the CPU).

Runs on ``cuda`` by default and raises when no GPU is present;
``--device cpu`` runs the same path with the kernels' plain versions.
Flags whose machinery is a later slice of the port refuse loudly with
the ROADMAP.md item that brings them; none is silently ignored.

Data: synthetic images and labels, tokens, BERT's masked-LM batch
(``--mlm-layout mask`` or ``positions``) or seq2seq's copy task (targets
= the source's first half), from
``np.random.RandomState(--seed)``, drawn exactly as the JAX trainer
draws them, so both trainers see one global batch; each process keeps
its rows of it. ``--data`` feeds Llama and
BERT from a uint32 token file instead (``data/loader.py``: the
Feistel-shuffled stream, one fresh batch a step, assembled ahead by a
``Prefetcher``; BERT's masking drawn from ``RandomState(seed + step)``),
again batch for batch the JAX trainer's.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import signal
import sys
import threading
import time
from typing import Callable, Optional

from ..utils import torchtrace, trace
from ..utils.logging import get_logger

log = get_logger("train")

PORTED_MODELS = ("resnet18", "resnet50", "resnet101", "llama3-8b",
                 "llama-tiny", "mixtral-8x7b", "llama-moe-tiny", "bert-base",
                 "bert-tiny", "vit-base", "vit-tiny", "seq2seq-small",
                 "seq2seq-tiny")


def parse_mesh_spec(spec: str) -> dict[str, int]:
    """'dp=2,fsdp=4,tp=2' -> {'dp': 2, 'fsdp': 4, 'tp': 2}; '' -> dp=-1."""
    if not spec:
        return {"dp": -1}
    out: dict[str, int] = {}
    for part in spec.split(","):
        name, _, size = part.partition("=")
        if not size:
            raise ValueError(f"bad mesh axis {part!r}; want name=size")
        out[name.strip()] = int(size)
    return out


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="tpujob-train-torch",
        description="PyTorch/CUDA trainer for TPUJob workloads (ResNet, "
                    "Llama, BERT, ViT, seq2seq)",
    )
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="where to train; cuda raises when no GPU is present "
                        "(the run never moves to the CPU on its own)")
    p.add_argument("--model", default="resnet101",
                   help="ported: resnet18|resnet50|resnet101|llama3-8b|"
                        "llama-tiny|mixtral-8x7b|llama-moe-tiny|bert-base|"
                        "bert-tiny|vit-base|vit-tiny|seq2seq-small|"
                        "seq2seq-tiny")
    p.add_argument("--mesh", default="",
                   help="axis spec over the world's processes, e.g. dp=-1, "
                        "dp=2,fsdp=2, tp=2, dp=2,ep=2 or ep=2,tp=2 (MoE), "
                        "dp=2,sp=2 or sp=2,tp=2 (llama, bert: the sequence "
                        "split over sp), pp=2 or dp=2,pp=2 (llama: the "
                        "blocks pipelined by GPipe; see --pp-microbatch)")
    p.add_argument("--steps", type=int, default=100,
                   help="ABSOLUTE target step")
    p.add_argument("--warmup", type=int, default=3)
    p.add_argument("--log-every", type=int, default=10)
    p.add_argument("--global-batch", type=int, default=0,
                   help="0 = pick per model (resnet, vit: 64/device; "
                        "seq2seq: 16/device; lm: 8/device)")
    p.add_argument("--image-size", type=int, default=224)
    p.add_argument("--bn-kernel", choices=["xla", "pallas"], default="xla",
                   help="resnet BN reduction path: xla = plain PyTorch "
                        "reductions; pallas = the hand-written CUDA "
                        "kernels (csrc/bn_*.cu; single-device only)")
    p.add_argument("--seq-len", type=int, default=512)
    p.add_argument("--lr", type=float, default=0.1)
    p.add_argument("--checkpoint-dir", default="")
    p.add_argument("--save-every", type=int, default=100)
    p.add_argument("--async-checkpoint", action="store_true")
    p.add_argument("--profile-dir", default="",
                   help="write a torch.profiler trace (CPU and CUDA "
                        "activity and the step's named ranges, Chrome "
                        "JSON) of the timed steps 11-13 here, one file "
                        "per process")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--data", default="")
    p.add_argument("--prefetch-depth", type=int, default=2)
    p.add_argument("--zigzag-ring", action="store_true",
                   help="balance causal ring-attention work with the zigzag "
                        "sequence layout (llama + sp meshes; --seq-len must "
                        "divide by 2*sp)")
    p.add_argument("--sequence-parallel", choices=["ring", "ulysses"],
                   default="ring",
                   help="long-context strategy on sp>1 meshes: 'ring' (k/v "
                        "shards around the sp group, the flat kernels a hop) "
                        "or 'ulysses' (two all-to-alls around one flat "
                        "kernel call on the local heads; sp must divide the "
                        "head count)")
    p.add_argument("--remat-policy", choices=["full", "dots"], default="full",
                   help="per-layer checkpoint policy (llama): 'full' "
                        "recomputes each layer in the backward, 'dots' "
                        "keeps its matmul outputs and the flash forward's "
                        "(out, lse)")
    p.add_argument("--xent-chunk", type=int, default=0,
                   help="compute the LM head + cross-entropy this many "
                        "sequence positions at a time (0 = full [B,S,V] "
                        "logits)")
    p.add_argument("--n-layers", type=int, default=0,
                   help="override the llama config's layer count (0 = "
                        "config default)")
    p.add_argument("--grad-accum", type=int, default=1,
                   help="accumulate gradients over N sequential "
                        "microbatches per optimizer step")
    p.add_argument("--pp-microbatch", type=int, default=0,
                   help="pipeline microbatch size (pp meshes; 0 = the "
                        "largest multiple of dp*fsdp dividing the global "
                        "batch into at least 2*pp microbatches, else pp)")
    p.add_argument("--mlm-layout", choices=["mask", "positions"],
                   default="mask",
                   help="bert batch: mask = [B, S] mask and targets, full "
                        "[B, S, V] logits; positions = the gathered "
                        "15%% prediction slots, head on [B, P] only")
    p.add_argument("--lr-schedule", choices=["constant", "cosine"],
                   default="constant",
                   help="cosine: linear warmup over --warmup-steps then "
                        "cosine decay to 0 at --steps")
    p.add_argument("--warmup-steps", type=int, default=0,
                   help="linear LR warmup steps (cosine schedule)")
    p.add_argument("--telemetry-every", type=int, default=50,
                   help="emit a train_telemetry JSONL record every N steps; "
                        "0 disables the periodic records")
    p.add_argument("--telemetry-path", default="",
                   help="append the telemetry JSONL here instead of stderr")
    p.add_argument("--heartbeat-every", type=int, default=0,
                   help="emit a step_heartbeat JSONL record (per-window "
                        "step-wall p50/max, wait share) plus a "
                        "device_memory watermark sample every N "
                        "post-warmup steps (0 disables); the pod runner "
                        "patches both onto the pod for the operator's "
                        "step-skew and memory matrices")
    return p


def check_moe_mesh(args) -> None:
    """The mesh against the model, the JAX trainer's checks: ``ep > 1``
    needs an MoE model whose expert count it divides. (tp and fsdp take
    any model: an MoE model's experts split their hidden dim over tp and
    FSDP2 shards them over fsdp.) Raises ValueError for a malformed
    ``--mesh``."""
    from ..models import llama as lib

    sizes = parse_mesh_spec(args.mesh)
    cfg = lib.CONFIGS[args.model]() if args.model in lib.CONFIGS else None
    moe = cfg is not None and cfg.is_moe
    ep = sizes.get("ep", 1)
    if ep > 1 and not moe:
        raise SystemExit(
            f"--mesh ep={ep} needs an MoE model; {args.model} is dense")
    if ep > 1 and cfg.n_experts % ep:
        raise SystemExit(f"{cfg.n_experts} experts not divisible by ep={ep}")


def check_sp_mesh(args) -> None:
    """The sp axis against the rest of the call, as the JAX trainer
    checks it: a token model (llama, bert), --seq-len divisible by sp
    (by 2*sp for the zigzag ring), no MoE; with tp, Ulysses splits the
    local heads (n_heads / tp) over sp."""
    from ..models import bert
    from ..models import llama as lib

    sizes = parse_mesh_spec(args.mesh)
    sp = sizes.get("sp", 1)
    if sp <= 1:
        return
    if not args.model.startswith(_TOKEN_MODELS):
        raise SystemExit(
            f"--mesh sp={sp} shards the sequence of the token models "
            f"(llama, bert); --model {args.model} has none")
    cfg = lib.CONFIGS[args.model]() if args.model in lib.CONFIGS else None
    # A pipelined MoE model is refused by the pp workload, in its words.
    if cfg is not None and cfg.is_moe and sizes.get("pp", 1) == 1:
        raise SystemExit(
            f"--mesh sp={sp} with an MoE model (--model {args.model}): MoE "
            f"composes with dp/tp/ep; sp (routing capacity is per sequence) "
            f"does not apply")
    if args.seq_len % sp:
        raise SystemExit(f"--seq-len {args.seq_len} not divisible by sp={sp}")
    if (args.zigzag_ring and args.sequence_parallel == "ring"
            and cfg is not None and args.seq_len % (2 * sp)):
        # ulysses (and BERT) ignore --zigzag-ring (llama_config_from_args
        # forces it off), so the constraint only binds the Llama ring.
        raise SystemExit(f"--zigzag-ring needs --seq-len divisible by "
                         f"2*sp={2 * sp}")
    tp = sizes.get("tp", 1)
    if cfg is None and args.model in bert.CONFIGS:
        cfg = bert.CONFIGS[args.model]()
    if (args.sequence_parallel == "ulysses" and cfg is not None
            and not cfg.n_heads % tp and (cfg.n_heads // tp) % sp):
        raise SystemExit(
            f"--sequence-parallel ulysses needs sp={sp} to divide the "
            f"{cfg.n_heads // tp} heads a tp={tp} rank holds; use the ring")


def _make_learning_rate(args):
    """Scalar LR, or ``schedule(count) -> lr`` from --lr-schedule (optax's
    warmup_cosine_decay_schedule with init 0, end 0)."""
    if args.lr_schedule == "constant":
        return args.lr
    import math

    peak, warm = args.lr, args.warmup_steps
    decay = max(args.steps, warm + 1) - warm

    def schedule(count: int) -> float:
        if count < warm:
            return peak * count / warm
        t = min(count - warm, decay)
        return peak * 0.5 * (1.0 + math.cos(math.pi * t / decay))

    return schedule


def _local_tensors(arrays, mesh, accum_steps: int = 1) -> tuple:
    """This process's rows of global-batch arrays, as tensors on the
    mesh's device."""
    from ..parallel.sharding import shard_batch

    return _as_tensors(shard_batch(arrays, mesh, accum_steps), mesh.device)


class Workload:
    """A model adapted to the trainer loop: ``step_fn(*batch) -> loss``
    updates the model in place. ``batch_fn(step)``, when set (``--data``),
    returns step's batch as host tensors (pinned on the card); otherwise
    the fixed synthetic ``batch`` is reused every step."""

    def __init__(self, *, model, optimizer, step_fn: Callable, batch: tuple,
                 examples_per_step: int, tokens_per_step: int = 0):
        self.model = model
        self.optimizer = optimizer
        self.step_fn = step_fn
        self.batch = batch
        self.examples_per_step = examples_per_step
        self.tokens_per_step = tokens_per_step
        self.batch_fn: Optional[Callable[[int], tuple]] = None


def _resnet_workload(args, mesh, n_devices: int) -> Workload:
    import numpy as np
    import torch

    from ..models import resnet as lib
    from ..ops.bn import require_single_device
    from ..parallel.sharding import average_gradients, shard_params

    if args.grad_accum > 1:
        raise SystemExit(
            "--grad-accum applies to LM models only (BatchNorm statistics "
            "make microbatched ResNet steps non-equivalent)"
        )
    depth = int(args.model.removeprefix("resnet"))
    global_batch = args.global_batch or 64 * n_devices
    if args.bn_kernel == "pallas":
        require_single_device(n_devices)
    model = lib.resnet(depth, bn_impl=args.bn_kernel, device=mesh.device)
    model.to(memory_format=torch.channels_last).train()
    lib.init_params(
        model, torch.Generator(device=mesh.device).manual_seed(args.seed)
    )
    shard_params(model, mesh, tp_plan=lambda: lib.tensor_parallel_plan(
        model, mesh.axis_size("tp")))
    lr = _make_learning_rate(args)
    schedule = lr if callable(lr) else None
    # optax.sgd(lr, momentum=0.9, nesterov=True): no dampening, no decay.
    optimizer = torch.optim.SGD(
        model.parameters(), lr=schedule(0) if schedule else lr,
        momentum=0.9, nesterov=True, dampening=0, weight_decay=0,
    )
    average_gradients(optimizer, mesh)
    rng = np.random.RandomState(args.seed)
    images = rng.standard_normal(
        (global_batch, args.image_size, args.image_size, 3)
    ).astype(np.float32)
    labels = rng.randint(0, 1000, (global_batch,))
    images, labels = _local_tensors((images, labels), mesh)
    # NHWC as drawn -> [N, 3, H, W] in channels_last memory (a view).
    images = images.permute(0, 3, 1, 2)
    return Workload(
        model=model,
        optimizer=optimizer,
        step_fn=lib.make_train_step(model, optimizer, lr_schedule=schedule),
        batch=(images, labels),
        examples_per_step=global_batch,
    )


def llama_config_from_args(args, sp: int):
    """Build the LlamaConfig a CLI invocation asks for."""
    from ..models import llama as lib

    attention = args.sequence_parallel if sp > 1 else "flash"
    kw = dict(
        attention_impl=attention,
        zigzag_ring=bool(args.zigzag_ring and sp > 1 and attention == "ring"),
        remat_policy=args.remat_policy,
        xent_chunk=args.xent_chunk,
    )
    if args.n_layers:
        kw["n_layers"] = args.n_layers
    if args.model not in lib.CONFIGS:
        raise SystemExit(
            f"unknown --model {args.model!r}; choose from {sorted(lib.CONFIGS)}"
        )
    return lib.config_for(args.model, **kw)


def _mlm_positions_batch(rows, rand):
    """Gathered-positions MLM batch from a token matrix and a uniform
    [B, S] draw: the n_pred = max(1, 0.15*S) smallest-rand positions of
    each row become its prediction slots (sorted), zeroed in the inputs.
    Returns (positions, targets, inputs, weights), numpy, as the JAX
    trainer's ``_mlm_positions_batch``."""
    import numpy as np

    b, s = rows.shape
    n_pred = max(int(s * 0.15), 1)
    pos = np.sort(np.argsort(rand, axis=1)[:, :n_pred], axis=1)
    tg = np.take_along_axis(rows, pos, axis=1)
    inputs = rows.copy()
    np.put_along_axis(inputs, pos, 0, axis=1)
    return (
        pos.astype(np.int32), tg, inputs, np.ones((b, n_pred), np.float32)
    )


def _mlm_batch(rows, rand, layout: str) -> tuple:
    """BERT's masked-LM batch from a token matrix and a uniform [B, S]
    draw, in the order the train step takes it: ``positions`` ->
    (inputs, positions, targets, weights); ``mask`` -> (inputs with the
    15%% masked slots zeroed, mask, targets)."""
    import numpy as np

    if layout == "positions":
        pos, tg, inputs, w = _mlm_positions_batch(rows, rand)
        return inputs, pos, tg, w
    mask = rand < 0.15
    return np.where(mask, 0, rows), mask.astype(np.float32), rows


def _as_tensors(arrays, device=None, pin: bool = False) -> tuple:
    """numpy arrays -> tensors: ids as int64, floats as float32; on
    ``device``, or on the host (pinned when ``pin``)."""
    import torch

    out = []
    for a in arrays:
        dtype = torch.float32 if a.dtype.kind == "f" else torch.long
        t = torch.as_tensor(a, dtype=dtype, device=device)
        out.append(t.pin_memory() if pin else t)
    return tuple(out)


def _sequence_batch(tokens, positions) -> tuple:
    """An sp rank's Llama batch from global [B, S] tokens: (tokens,
    next-token targets, weights), the targets built on the whole sequence
    (the last position's weighted 0), then this rank's columns."""
    import numpy as np

    targets = np.zeros_like(tokens)
    targets[:, :-1] = tokens[:, 1:]
    weights = np.ones(tokens.shape, np.float32)
    weights[:, -1] = 0.0
    return tuple(a[:, positions] for a in (tokens, targets, weights))


def _bert_columns(batch: tuple, positions, layout: str) -> tuple:
    """An sp rank's BERT batch: the columns ``positions`` of its [B, S]
    arrays. The ``positions`` layout's [B, P] slot arrays stay whole:
    their slots index the whole sequence, and the loss keeps the ones
    that fall in the rank's columns (``models/bert.py:
    mlm_loss_positions``)."""
    if layout == "positions":
        return (batch[0][:, positions], *batch[1:])
    return tuple(a[:, positions] for a in batch)


def _token_batch_fn(args, vocab: int, global_batch: int, mesh,
                    positions=None, accum_steps: int = 0):
    """``batch_fn(step)`` for ``--data`` (the JAX trainer's
    ``_token_stream`` and BERT ``batch_fn``): this process's Feistel-
    shuffled rows of the global batch, ``ds.rows(step, B, lo, hi) %
    vocab`` (the stream is stateless, so each process assembles only its
    rows); BERT layers its masking on top, drawn from ``RandomState(seed
    + step)`` for the global batch and sliced to the same rows. Returns
    host tensors, pinned on the card: the consuming thread copies them to
    the device on its own stream. With ``positions`` (an sp rank's) the
    columns are sliced as the synthetic batch's are; ``accum_steps``
    (default --grad-accum) is the microbatch count the rows follow."""
    import numpy as np

    from ..data import TokenDataset
    from ..parallel.sharding import local_rows

    ds = TokenDataset(args.data, args.seq_len, seed=args.seed)
    is_bert = args.model.startswith("bert")
    pin = mesh.device.type == "cuda"
    ranges = local_rows(global_batch, mesh, accum_steps or args.grad_accum)

    def batch_fn(step: int) -> tuple:
        rows = np.concatenate([ds.rows(step, global_batch, lo, hi)
                               for lo, hi in ranges]).astype(np.int64) % vocab
        if not is_bert:
            batch = ((rows,) if positions is None
                     else _sequence_batch(rows, positions))
            return _as_tensors(batch, pin=pin)
        rand = np.random.RandomState(args.seed + step).rand(
            global_batch, args.seq_len)
        rand = np.concatenate([rand[lo:hi] for lo, hi in ranges])
        batch = _mlm_batch(rows, rand, args.mlm_layout)
        if positions is not None:
            batch = _bert_columns(batch, positions, args.mlm_layout)
        return _as_tensors(batch, pin=pin)

    return batch_fn


def _bert_model(args, device, rng, global_batch: int, sp_group=None):
    """(model, make_step, batch) for a bert-* --model: the config the JAX
    trainer builds (its attention_impl default, --sequence-parallel over
    ``sp_group``; max_seq_len grown to --seq-len) and its global batch as
    numpy arrays, drawn from ``rng`` in the JAX order."""
    import dataclasses

    import numpy as np
    import torch

    from ..models import bert as lib

    if args.model not in lib.CONFIGS:
        # Same rule as the llama arm: a typo ("bert-large", "bert-tinny")
        # must not silently train the toy config.
        raise SystemExit(
            f"unknown --model {args.model!r}; bert models are bert-base or "
            f"bert-tiny"
        )
    cfg = lib.CONFIGS[args.model]()
    if sp_group is not None:
        cfg = dataclasses.replace(cfg, attention_impl=args.sequence_parallel)
    if args.seq_len > cfg.max_seq_len:
        cfg = dataclasses.replace(cfg, max_seq_len=args.seq_len)
    model = lib.Bert(cfg, device=device, sp_group=sp_group)
    lib.init_params(model, torch.Generator(device=device).manual_seed(args.seed))
    rows = rng.randint(0, cfg.vocab_size, (global_batch, args.seq_len))
    batch = _mlm_batch(rows, rng.rand(global_batch, args.seq_len),
                       args.mlm_layout)
    make_step = (lib.make_train_step_positions
                 if args.mlm_layout == "positions" else lib.make_train_step)
    return model, make_step, batch


def _lm_workload(args, mesh, n_devices: int) -> Workload:
    import numpy as np
    import torch

    from ..models import llama as lib
    from ..parallel.mesh import SP
    from ..parallel.sharding import local_positions, shard_params

    sizes = mesh.sizes
    sp = sizes.get(SP, 1)
    group = mesh.submesh(SP).get_group() if sp > 1 else None
    global_batch = args.global_batch or 8 * max(n_devices // sp, 1)
    batch_shards = sizes.get("dp", 1) * sizes.get("fsdp", 1)
    if args.grad_accum > 1:
        if global_batch % args.grad_accum:
            raise SystemExit(
                f"--global-batch {global_batch} not divisible by "
                f"--grad-accum {args.grad_accum}"
            )
        micro = global_batch // args.grad_accum
        if micro % batch_shards:
            raise SystemExit(
                f"microbatch {micro} (= {global_batch}/{args.grad_accum}) "
                f"not divisible by the dp*fsdp shard count {batch_shards}"
            )
    rng = np.random.RandomState(args.seed)

    if args.model.startswith("bert"):
        from ..models import bert as plan_lib

        model, make_step, batch = _bert_model(args, mesh.device, rng,
                                              global_batch, group)
    elif sizes.get("pp", 1) > 1:
        return _llama_pp_workload(args, mesh, global_batch, rng)
    else:
        plan_lib = lib
        cfg = llama_config_from_args(args, sp)
        model = lib.Llama(cfg, device=mesh.device, sp_group=group)
        lib.init_params(
            model, torch.Generator(device=mesh.device).manual_seed(args.seed)
        )
        make_step = lib.make_train_step
        batch = (rng.randint(0, cfg.vocab_size, (global_batch, args.seq_len)),)
    positions = None
    if sp > 1:
        # This rank's columns of the global batch (its rows follow in
        # _adamw_workload); the model reads their global positions.
        llama = plan_lib is lib
        positions = local_positions(args.seq_len, mesh,
                                    llama and model.config.zigzag_ring)
        at = torch.as_tensor(positions, device=mesh.device)
        if llama:
            batch = _sequence_batch(batch[0], positions)
            # The gradients are averaged over dp x fsdp x sp: scaled so,
            # each rank's summed loss over one microbatch's global target
            # count averages to the global next-token mean.
            micro = global_batch // args.grad_accum
            make_step = functools.partial(
                make_step, positions=at,
                scale=batch_shards * sp / (micro * (args.seq_len - 1)))
        else:
            batch = _bert_columns(batch, positions, args.mlm_layout)
            make_step = functools.partial(make_step, positions=at)
    tp = sizes.get("tp", 1)
    shard_params(model, mesh,
                 tp_plan=lambda: plan_lib.tensor_parallel_plan(model, tp))
    work = _adamw_workload(args, mesh, model, make_step, batch, global_batch,
                           tokens_per_step=global_batch * args.seq_len)
    if args.data:
        work.batch_fn = _token_batch_fn(args, model.config.vocab_size,
                                        global_batch, mesh, positions)
    return work


def _pp_microbatches(args, sizes: dict, global_batch: int) -> int:
    """The pipeline's microbatch count: --pp-microbatch rows each, or by
    default the largest multiple of dp*fsdp that divides the global batch
    into at least 2*pp microbatches (pp as a fallback), as the JAX
    trainer derives it; SystemExit with its messages otherwise."""
    pp = sizes["pp"]
    shards = sizes.get("dp", 1) * sizes.get("fsdp", 1)
    mb = args.pp_microbatch
    if not mb:
        divisors = [d for d in range(1, global_batch + 1)
                    if global_batch % d == 0 and d % shards == 0]
        for want in (2 * pp, pp):
            fitting = [d for d in divisors if global_batch // d >= want]
            if fitting:
                mb = max(fitting)
                break
        if not mb:
            raise SystemExit(
                f"--global-batch {global_batch} cannot form {pp} pipeline "
                f"microbatches of a multiple of dp*fsdp={shards}; raise it")
    if global_batch % mb:
        raise SystemExit(f"--global-batch {global_batch} not divisible by "
                         f"pipeline microbatch {mb}")
    m = global_batch // mb
    if m < pp:
        raise SystemExit(
            f"{m} pipeline microbatches cannot fill {pp} stages; lower "
            f"--pp-microbatch or raise --global-batch")
    if mb % shards:
        raise SystemExit(
            f"pipeline microbatch {mb} not divisible by dp*fsdp={shards} "
            f"(microbatch rows shard over both)")
    return m


def check_pp_mesh(args, sizes: dict, global_batch: int) -> tuple:
    """The pp mesh against the rest of the call, the JAX trainer's
    ``_llama_pp_workload`` refusals in its words: the axes pp composes
    with, a pipelined MoE model off fsdp and sp, no --grad-accum, the
    layers over pp and the dims over fsdp and tp, then the microbatch
    count. Returns (the LlamaConfig, the microbatch count)."""
    pp, fsdp = sizes["pp"], sizes.get("fsdp", 1)
    tp, sp = sizes.get("tp", 1), sizes.get("sp", 1)
    unsupported = [a for a, n in sizes.items()
                   if a not in ("dp", "fsdp", "pp", "tp", "sp", "ep")
                   and n > 1]
    if unsupported:
        raise SystemExit(
            f"pp meshes compose with dp, fsdp, tp, sp (ring or ulysses), "
            f"and ep (MoE); {unsupported} would silently replicate "
            f"work/params")
    # main's check_moe_mesh and check_sp_mesh refused the rest of the JAX
    # workload's reasons (ep against the model, the sequence against sp).
    cfg = llama_config_from_args(args, sp)
    if cfg.is_moe and (fsdp > 1 or sp > 1):
        raise SystemExit(
            "pipelined MoE composes with dp/tp/ep; fsdp (ZeRO-3 gathers "
            "assume dense kernels) and sp (routing capacity is per "
            "sequence) do not apply")
    if args.grad_accum > 1:
        raise SystemExit(
            "--grad-accum with a pp mesh is redundant: raise the "
            "microbatch count instead (lower --pp-microbatch)")
    if cfg.n_layers % pp:
        raise SystemExit(
            f"model has {cfg.n_layers} layers, not divisible by pp={pp}")
    if fsdp > 1 and (cfg.dim % fsdp or cfg.ffn_dim % fsdp):
        raise SystemExit(
            f"model dims (dim={cfg.dim}, ffn_dim={cfg.ffn_dim}) must both "
            f"divide by fsdp={fsdp}")
    if tp > 1 and (cfg.n_heads % tp or cfg.n_kv_heads % tp
                   or cfg.ffn_dim % tp or cfg.dim % tp):
        raise SystemExit(
            f"heads ({cfg.n_heads} q / {cfg.n_kv_heads} kv), ffn_dim "
            f"({cfg.ffn_dim}), and dim ({cfg.dim}) must all divide by "
            f"tp={tp}")
    return cfg, _pp_microbatches(args, sizes, global_batch)


def _llama_pp_workload(args, mesh, global_batch: int, rng) -> Workload:
    """Llama, dense or MoE, with its blocks pipelined over pp
    (``models/llama_pp.py``): the JAX trainer's ``_llama_pp_workload``,
    its refusals in its words. This rank builds its stage (drawn as its
    part of the one-process init), lays it out on the stage's groups as
    the plain model is laid out (the embedding, norm and head left whole
    on fsdp ranks) and keeps its rows of each of the M microbatches."""
    import torch

    from ..models import llama as lib
    from ..models import llama_pp as pp_lib
    from ..parallel.sharding import local_positions, shard_params

    sizes = mesh.sizes
    pp, fsdp = sizes["pp"], sizes.get("fsdp", 1)
    tp, sp = sizes.get("tp", 1), sizes.get("sp", 1)
    cfg, m = check_pp_mesh(args, sizes, global_batch)

    group = mesh.submesh("sp").get_group() if sp > 1 else None
    stage = pp_lib.LlamaStage(cfg, mesh.coordinate("pp"), pp,
                              device=mesh.device, sp_group=group)
    pp_lib.init_stage_params(
        stage, torch.Generator(device=mesh.device).manual_seed(args.seed))
    shard_params(stage, mesh,
                 tp_plan=lambda: lib.tensor_parallel_plan(stage, tp),
                 whole=stage.edge_params())
    batch = (rng.randint(0, cfg.vocab_size, (global_batch, args.seq_len)),)
    kw, positions = {}, None
    if sp > 1:
        positions = local_positions(args.seq_len, mesh, cfg.zigzag_ring)
        batch = _sequence_batch(batch[0], positions)
        shards = sizes.get("dp", 1) * fsdp
        kw = dict(positions=torch.as_tensor(positions, device=mesh.device),
                  scale=shards * sp / (global_batch * (args.seq_len - 1)))

    def make_step(model, optimizer, accum_steps, lr_schedule):
        return pp_lib.make_pp_train_step(model, optimizer, mesh, m,
                                         lr_schedule=lr_schedule, **kw)

    work = _adamw_workload(args, mesh, stage, make_step, batch, global_batch,
                           tokens_per_step=global_batch * args.seq_len,
                           microbatches=m)
    if args.data:
        work.batch_fn = _token_batch_fn(args, cfg.vocab_size, global_batch,
                                        mesh, positions, accum_steps=m)
    return work


def _adamw_workload(args, mesh, model, make_step, batch: tuple,
                    global_batch: int, tokens_per_step: int = 0,
                    microbatches: int = 0) -> Workload:
    """The Workload of a model (already placed on ``mesh``) trained with
    ``optax.adamw`` in the JAX trainer: its defaults b1 0.9, b2 0.999,
    eps 1e-8, weight decay 1e-4 (torch's own default decay is 0.01), --lr
    or --lr-schedule, and ``make_step(model, optimizer, accum_steps,
    lr_schedule)``'s step with --grad-accum microbatches, on this
    process's rows of the global ``batch`` (numpy arrays): its share of
    each of ``microbatches`` (default --grad-accum)."""
    import torch
    from torch.distributed.tensor import DTensor

    from ..parallel.sharding import average_gradients

    lr = _make_learning_rate(args)
    schedule = lr if callable(lr) else None
    # A tensor-parallel plan without FSDP leaves DTensor and plain
    # parameters side by side, which the multi-tensor (foreach) kernels
    # refuse to mix: such a model takes the per-parameter loop.
    mixed = len({isinstance(p, DTensor) for p in model.parameters()}) > 1
    optimizer = torch.optim.AdamW(
        model.parameters(), lr=schedule(0) if schedule else lr,
        betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-4,
        foreach=False if mixed else None,
    )
    average_gradients(optimizer, mesh)
    step_fn = make_step(
        model, optimizer, accum_steps=args.grad_accum, lr_schedule=schedule
    )
    return Workload(
        model=model,
        optimizer=optimizer,
        step_fn=step_fn,
        batch=_local_tensors(batch, mesh, microbatches or args.grad_accum),
        examples_per_step=global_batch,
        tokens_per_step=tokens_per_step,
    )


def _config(lib, args):
    """``lib.CONFIGS[--model]()``; an unknown name exits, so a typo never
    trains another config."""
    if args.model not in lib.CONFIGS:
        raise SystemExit(f"unknown --model {args.model!r}; choose from "
                         f"{sorted(lib.CONFIGS)}")
    return lib.CONFIGS[args.model]()


def _vit_workload(args, mesh, n_devices: int) -> Workload:
    """ViT on synthetic NHWC images and labels (the JAX trainer's
    ``_vit_workload``): B = 64 a device by default; images drawn first,
    then labels, from RandomState(--seed)."""
    import numpy as np
    import torch

    from ..models import vit as lib
    from ..parallel.sharding import shard_params

    cfg = _config(lib, args)
    global_batch = args.global_batch or 64 * n_devices
    model = lib.ViT(cfg, device=mesh.device)
    lib.init_params(
        model, torch.Generator(device=mesh.device).manual_seed(args.seed))
    shard_params(model, mesh, tp_plan=lambda: lib.tensor_parallel_plan(
        model, mesh.axis_size("tp")))
    rng = np.random.RandomState(args.seed)
    images = rng.standard_normal(
        (global_batch, cfg.image_size, cfg.image_size, 3)).astype(np.float32)
    labels = rng.randint(0, cfg.num_classes, (global_batch,))
    return _adamw_workload(args, mesh, model, lib.make_train_step,
                           (images, labels), global_batch)


def _seq2seq_workload(args, mesh, n_devices: int) -> Workload:
    """Encoder-decoder on the synthetic copy task of the JAX trainer's
    ``_seq2seq_workload`` (targets = the source's first half): B = 16 a
    device by default, src_len = min(--seq-len, max_seq_len), dec_len =
    src_len // 2; tokens per step count both sides."""
    import numpy as np
    import torch

    from ..models import seq2seq as lib
    from ..parallel.sharding import shard_params

    cfg = _config(lib, args)
    global_batch = args.global_batch or 16 * n_devices
    src_len = min(args.seq_len or 64, cfg.max_seq_len)
    dec_len = max(src_len // 2, 1)
    model = lib.Seq2Seq(cfg, device=mesh.device)
    lib.init_params(
        model, torch.Generator(device=mesh.device).manual_seed(args.seed))
    shard_params(model, mesh, tp_plan=lambda: lib.tensor_parallel_plan(
        model, mesh.axis_size("tp")))
    rng = np.random.RandomState(args.seed)
    src = rng.randint(1, cfg.vocab_size, (global_batch, src_len))
    return _adamw_workload(args, mesh, model, lib.make_train_step,
                           (src, src[:, :dec_len]), global_batch,
                           tokens_per_step=global_batch * (src_len + dec_len))


_TOKEN_MODELS = ("bert", "llama", "mixtral")


def build_workload(args, mesh, n_devices: int) -> Workload:
    if args.data and not args.model.startswith(_TOKEN_MODELS):
        # The JAX trainer reads --data only in its Llama and BERT arms;
        # the port ignores no flag silently.
        raise SystemExit(
            f"--data is a token file, which only the token models (llama, "
            f"mixtral, bert) read; --model {args.model} trains on its synthetic "
            f"batch, as in the JAX trainer"
        )
    if args.model.startswith("resnet"):
        return _resnet_workload(args, mesh, n_devices)
    if args.model.startswith("vit"):
        return _vit_workload(args, mesh, n_devices)
    if args.model.startswith("seq2seq"):
        return _seq2seq_workload(args, mesh, n_devices)
    if args.model.startswith(_TOKEN_MODELS):
        return _lm_workload(args, mesh, n_devices)
    raise SystemExit(f"unknown --model {args.model!r}")


def _sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def train_state(work: Workload) -> dict:
    """The live model and optimizer as the checkpointed state: the JAX
    trainer's top-level keys (``params``, ``opt_state``) over the port's
    module names (``get_state_dict``)."""
    from torch.distributed.checkpoint.state_dict import get_state_dict

    params, opt_state = get_state_dict(work.model, work.optimizer)
    return {"params": params, "opt_state": opt_state}


def restore_train_state(ckpt, work: Workload) -> int:
    """Load the newest committed, readable checkpoint into the model and
    optimizer; returns its step, or 0 for a cold start."""
    from torch.distributed.checkpoint.state_dict import (
        StateDictOptions,
        set_state_dict,
    )

    # AdamW and SGD keep per-parameter state only for parameters that got
    # a gradient (BERT's type_embed gets none).
    like = train_state(work)
    step, state = ckpt.restore_latest(like, optional=("opt_state", "state"))
    if step is None:
        # get_state_dict made the optimizer's state with one zero-lr step
        # (AdamW's step count 1); a cold start begins with none, as a
        # fresh optimizer does.
        work.optimizer.state.clear()
        return 0
    # The param groups name their parameters, which on a pipeline stage
    # are the stage's own and in the checkpoint one writer's.
    for got, own in zip(state["opt_state"]["param_groups"],
                        like["opt_state"]["param_groups"]):
        got["params"] = own["params"]
    # Not strict: the read above already required every parameter; only
    # the optimizer state of a parameter that never got a gradient may be
    # absent, as it is from the optimizer that saved it.
    set_state_dict(work.model, work.optimizer,
                   model_state_dict=state["params"],
                   optim_state_dict=state["opt_state"],
                   options=StateDictOptions(strict=False))
    return step


def _global_mean(x):
    """``x`` averaged over every process (the global batch's loss: each
    batch shard's loss is a mean over equal parts, and a tp rank's equals
    its peers'); ``x`` itself in a world of one."""
    import torch.distributed as dist

    from ..parallel.mesh import world_size

    if world_size() == 1:
        return x
    x = x.detach().clone()
    dist.all_reduce(x)
    return x / dist.get_world_size()


def held_tensors(work: Workload) -> list:
    """The tensors the trainer holds: parameters, their gradients, the
    model's buffers and the optimizer's state (the CPU device-memory
    sample sums their bytes)."""
    import torch

    out = []
    for p in work.model.parameters():
        out.append(p)
        if p.grad is not None:
            out.append(p.grad)
    out.extend(work.model.buffers())
    for state in work.optimizer.state.values():
        out.extend(v for v in state.values() if torch.is_tensor(v))
    return out


def _start_profiler(device):
    """A running ``torch.profiler`` over the CPU and, on the card, CUDA
    activity (the JAX trainer's ``jax.profiler.start_trace``). The step's
    named ranges (``utils/torchtrace.py``) are armed while it runs, so
    the trace shows the step's phases, casts, norms, head and MoE
    parts."""
    from torch import profiler

    activities = [profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(profiler.ProfilerActivity.CUDA)
    prof = profiler.profile(activities=activities)
    prof.start()
    return prof


def _stop_profiler(prof, device, directory: str, process_id: int) -> str:
    """Stop ``prof`` after the traced steps landed and write its trace as
    Chrome JSON into ``directory``; returns the file."""
    _sync(device)
    prof.stop()
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, f"trace_process{process_id}.json")
    prof.export_chrome_trace(path)
    log.info("profiler trace written to %s", path)
    return path


def _grace_seconds() -> float:
    """The final save's budget: ``TPUJOB_CHECKPOINT_GRACE_S``, else the
    default under kube's 30 s termination grace."""
    from ..api.v2beta1 import constants
    from ..utils.checkpoint import DEFAULT_FINAL_GRACE_S

    raw = os.environ.get(constants.ENV_CHECKPOINT_GRACE, "")
    try:
        return float(raw) if raw else DEFAULT_FINAL_GRACE_S
    except ValueError:
        return DEFAULT_FINAL_GRACE_S


def main(argv=None) -> int:
    # Join the operator's trace before anything logs.
    trace.adopt_from_environ()
    args = build_parser().parse_args(argv)
    if args.steps < 1:
        raise SystemExit("--steps must be >= 1")
    try:
        check_moe_mesh(args)
        check_sp_mesh(args)
        pp = parse_mesh_spec(args.mesh).get("pp", 1)
    except ValueError as e:
        raise SystemExit(f"--mesh {args.mesh!r}: {e}") from None
    if pp != 1 and not args.model.startswith(("llama", "mixtral")):
        # Only the Llama-family workload consumes pp (models/llama_pp.py).
        raise SystemExit(
            "--mesh pp is wired for dense llama and MoE models only; use "
            "the parallel.pipeline API for custom stages, or drop pp")

    import torch

    from ..api.v2beta1 import constants as api_constants
    from ..launcher import bootstrap
    from ..ops._common import require_device
    from ..parallel.mesh import create_mesh
    from ..utils import metrics as metrics_lib
    from ..utils import telemetry as telemetry_lib

    device = require_device(args.device)
    cfg = bootstrap.initialize(device_type=device.type)
    if cfg.is_distributed:
        device = bootstrap.process_device(cfg.process_id, device.type)
    try:
        mesh = create_mesh(device=device, **parse_mesh_spec(args.mesh))
    except ValueError as e:
        raise SystemExit(f"--mesh {args.mesh!r}: {e}") from None
    n_devices = mesh.size  # one device per process
    log.info(
        "process %d/%d, %d device(s) (%s), mesh %s",
        cfg.process_id, cfg.num_processes, n_devices, device, mesh.sizes,
    )

    work = build_workload(args, mesh, n_devices)

    ckpt = None
    start_step = 0
    if args.checkpoint_dir:
        from ..utils.checkpoint import AsyncCheckpointManager, CheckpointManager

        manager_cls = (AsyncCheckpointManager if args.async_checkpoint
                       else CheckpointManager)
        ckpt = manager_cls(args.checkpoint_dir,
                           save_interval_steps=args.save_every,
                           process_group=bootstrap.checkpoint_group(),
                           control_group=bootstrap.control_group())
        start_step = restore_train_state(ckpt, work)
        if start_step:
            log.info("resumed at step %d", start_step)

    # --steps is an ABSOLUTE target: a restarted gang resumes at the
    # checkpoint step and runs only the remainder.
    end = args.steps
    if start_step >= end:
        log.info("checkpoint already at step %d >= --steps %d; nothing to do",
                 start_step, end)
        ckpt.close()
        print(json.dumps({
            "model": args.model, "steps": 0, "final_step": start_step,
            "loss": None, "examples_per_sec": 0.0, "step_ms": 0.0,
            "goodput": 0.0, "devices": n_devices, "device": str(device),
            "preempted": False,
        }))
        return 0
    # Warmup steps are real optimizer steps and count toward the step
    # number; only the timing excludes them, so kernel builds and
    # allocator warmup stay out of the throughput number.
    warmup = max(args.warmup, 1)
    timed_from = min(start_step + warmup, end - 1)
    # Preemption-aware shutdown: finish the current step and stop.
    preempted = threading.Event()

    def _on_sigterm(signum, frame):
        log.warning("SIGTERM: checkpointing at the next step boundary")
        preempted.set()

    prev_handler = signal.signal(signal.SIGTERM, _on_sigterm)
    # The gang must AGREE on the stop step: checkpoint saves are
    # collective, so one process breaking at step k while another goes on
    # to k+1 wedges the gang inside the save. A MAX of the local flag over
    # the control group each step keeps the decision global (SIGTERM
    # reaches every pod within one grace window).
    from ..parallel.sharding import any_process

    control = bootstrap.control_group()
    agree = (lambda flag: any_process(flag, control)) if control else bool

    # Device-memory observatory input: with heartbeats on, each closed
    # window also emits one watermark sample of this process's device
    # (device_memory JSONL -> pod annotation -> the operator's memory
    # matrix). The sampler reads the chaos leak increment
    # (TPU_MEM_LEAK_BYTES) from its env on its own.
    devstats_sampler = None
    if args.heartbeat_every > 0:
        from ..utils import devstats as devstats_lib

        devstats_sampler = devstats_lib.DeviceMemorySampler(
            device=device, live_tensors=functools.partial(held_tensors, work),
        ).sample

    telem = telemetry_lib.TrainingTelemetry(
        tokens_per_step=work.tokens_per_step,
        examples_per_step=work.examples_per_step,
        registry=metrics_lib.Registry(),
        interval=max(args.telemetry_every, 0),
        jsonl_path=args.telemetry_path,
        heartbeat_interval=max(args.heartbeat_every, 0),
        devstats_sampler=devstats_sampler,
    )

    # Chaos SlowWorker fault: stretch every step's wall clock by the
    # injected factor so this host reads as a straggler end to end.
    _slow_raw = os.environ.get(api_constants.ENV_STEP_SLOWDOWN, "")
    try:
        step_slowdown = max(float(_slow_raw), 1.0) if _slow_raw else 1.0
    except ValueError:
        step_slowdown = 1.0
    if step_slowdown > 1.0:
        log.warning("chaos: step clock slowed by factor %.2f", step_slowdown)

    # Built only for a step that is saved.
    state_fn = functools.partial(train_state, work)

    prefetcher = batches = None
    if work.batch_fn is not None:
        from ..data import Prefetcher

        # The stateless data order restarts cleanly at start_step.
        prefetcher = Prefetcher(work.batch_fn, start_step, end,
                                depth=max(args.prefetch_depth, 1))
        batches = iter(prefetcher)

    t0 = t_log = None
    profiler = None
    first_loss: Optional[object] = None
    step = last_log_step = start_step
    telem.start()
    t_prev = time.perf_counter()
    while step < end:
        if step == timed_from:
            _sync(device)
            torchtrace.note_warmup_complete()
            t0 = t_log = time.perf_counter()
            last_log_step = step
        if args.profile_dir and step == timed_from + 10:
            profiler = _start_profiler(device)
        if batches is not None:
            # Host batch -> device on this thread's stream, ordered before
            # the step's kernels (pinned: the copy is asynchronous).
            batch = tuple(t.to(device, non_blocking=True)
                          for t in next(batches)[1])
        else:
            batch = work.batch
        loss = work.step_fn(*batch)
        if first_loss is None:
            first_loss = loss.detach().clone()
        step += 1
        torchtrace.note_step()
        if step_slowdown > 1.0:
            # Pad BEFORE timing so the stretched wall time lands in this
            # step's telemetry (and its heartbeat window).
            time.sleep((step_slowdown - 1.0) * (time.perf_counter() - t_prev))
        now = time.perf_counter()
        telem.record_step(step, now - t_prev, warmup=step <= timed_from)
        t_prev = now
        if profiler is not None and step == timed_from + 13:
            _stop_profiler(profiler, device, args.profile_dir, cfg.process_id)
            profiler = None
        if args.log_every and step % args.log_every == 0:
            # The log cadence is the explicit sync point: the read waits
            # for the step, so the ms/step below measures completed work.
            loss_val = torchtrace.host_read(_global_mean(loss))
            if t_log is not None and step > last_log_step:
                now = time.perf_counter()
                ms = (now - t_log) / (step - last_log_step) * 1000
                log.info("step %d: loss=%.4f %.1f ms/step", step, loss_val, ms)
                t_log, last_log_step = now, step
            else:  # still inside warmup: loss only, no bogus timing
                log.info("step %d: loss=%.4f (warmup)", step, loss_val)
        if ckpt is not None:
            t_ckpt = time.perf_counter()
            ckpt.save(step, state_fn)
            telem.record_checkpoint(time.perf_counter() - t_ckpt)
        if agree(preempted.is_set()):
            preempted.set()  # reflect the gang decision locally
            # The post-loop force-save commits this exact step.
            log.warning("preemption: stopping at step %d", step)
            break
    if prefetcher is not None:
        prefetcher.close()
    _sync(device)
    if profiler is not None:  # the run ended inside the trace window
        _stop_profiler(profiler, device, args.profile_dir, cfg.process_id)
    timed_steps = max(step - timed_from, 0)
    elapsed = (time.perf_counter() - t0) if t0 is not None else 0.0
    # The global batch's losses, one collective for both.
    first_loss, final_loss = _global_mean(
        torch.stack([first_loss.float(), loss.detach().float()])).tolist()

    if ckpt is not None:
        from ..utils.checkpoint import drain_final_save

        # FinalOnce-latched: exactly one final save lands however the
        # loop exited, and an in-flight async write is drained inside
        # the grace budget instead of being abandoned to a torn commit.
        drain_final_save(ckpt, step, state_fn, telem,
                         grace_s=_grace_seconds())
        ckpt.close()
    # Only after the checkpoint is durable: a second SIGTERM during the
    # commit must not kill the process mid-write.
    signal.signal(signal.SIGTERM, prev_handler)

    telem.close(step, final=preempted.is_set())
    examples_per_sec = (
        work.examples_per_step * timed_steps / elapsed if elapsed > 0 else 0.0
    )
    summary = {
        "model": args.model,
        "steps": step - start_step,
        "final_step": step,
        "loss": final_loss,
        "first_loss": first_loss,
        "examples_per_sec": round(examples_per_sec, 2),
        "step_ms": (
            round(elapsed / timed_steps * 1000, 2) if timed_steps else 0.0
        ),
        "goodput": round(telem.goodput_ratio(), 4),
        "devices": n_devices,
        "device": str(device),
        "preempted": preempted.is_set(),
    }
    if work.tokens_per_step and elapsed > 0:
        summary["tokens_per_sec"] = round(
            work.tokens_per_step * timed_steps / elapsed, 1
        )
    if torchtrace.enabled():
        summary["jax_trace"] = torchtrace.tracer().report()
    print(json.dumps(summary))
    return 0


def run_as_process(entry, argv=None) -> int:
    """``entry(argv)`` as a worker process runs it: a failure (a gang
    barrier or collective that timed out, a rank that died) is logged
    with this process's id before it propagates, so the job's logs name
    the rank."""
    from ..api.v2beta1 import constants

    try:
        return entry(argv)
    except Exception as e:
        log.error("process %s failed: %s: %s",
                  os.environ.get(constants.ENV_PROCESS_ID, "0"),
                  type(e).__name__, e)
        raise


if __name__ == "__main__":
    sys.exit(run_as_process(main))
