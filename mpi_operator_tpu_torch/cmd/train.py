"""Training entrypoint -- the port of ``mpi_operator_tpu/cmd/train.py``,
ResNet and Llama arms, one process on one device:

    python -m mpi_operator_tpu_torch.cmd.train      # resnet101, 224x224, B=64
    python -m mpi_operator_tpu_torch.cmd.train --model resnet101 \\
        --bn-kernel pallas --steps 6 --warmup 2
    python -m mpi_operator_tpu_torch.cmd.train --model llama3-8b \\
        --n-layers 2 --seq-len 2048 --global-batch 2 --xent-chunk 1024 \\
        --steps 6 --warmup 2 --lr 3e-4

Flow: rendezvous (launcher.bootstrap, single process) -> one-device mesh
-> model + optimizer (ResNet: SGD nesterov momentum 0.9; Llama: AdamW)
-> step loop with warmup boundary, log cadence, SIGTERM stop,
step-slowdown chaos and telemetry -> one JSON summary line on stdout
with the JAX trainer's keys.

``--bn-kernel`` keeps the JAX values so that a TPUJob's args mean the
same on both packages: ``xla`` (the default) normalizes with plain
PyTorch reductions, ``pallas`` through the hand-written CUDA BN kernels
(``csrc/bn_stats.cu``, ``csrc/bn_grads.cu``; their plain versions on
the CPU).

Runs on ``cuda`` by default and raises when no GPU is present;
``--device cpu`` runs the same path with the kernels' plain versions.
Flags whose machinery is a later slice of the port refuse loudly with
the ROADMAP.md item that brings them; none is silently ignored.

Data: synthetic images and labels, or tokens, from
``np.random.RandomState(--seed)``, drawn exactly as the JAX trainer
draws them, so both trainers see one batch.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import sys
import threading
import time
from typing import Callable, Optional

from ..utils import trace
from ..utils.logging import get_logger

log = get_logger("train")

PORTED_MODELS = ("resnet18", "resnet50", "resnet101", "llama3-8b",
                 "llama-tiny")


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
                    "Llama)",
    )
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="where to train; cuda raises when no GPU is present "
                        "(the run never moves to the CPU on its own)")
    p.add_argument("--model", default="resnet101",
                   help="ported: resnet18|resnet50|resnet101|llama3-8b|"
                        "llama-tiny (the JAX trainer's other names are "
                        "refused until ported)")
    p.add_argument("--mesh", default="",
                   help="axis spec, e.g. dp=-1; every axis must be 1 "
                        "(multi-device meshes are not ported yet)")
    p.add_argument("--steps", type=int, default=100,
                   help="ABSOLUTE target step")
    p.add_argument("--warmup", type=int, default=3)
    p.add_argument("--log-every", type=int, default=10)
    p.add_argument("--global-batch", type=int, default=0,
                   help="0 = pick per model (resnet: 64/device; lm: "
                        "8/device)")
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
    p.add_argument("--profile-dir", default="")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--data", default="")
    p.add_argument("--prefetch-depth", type=int, default=2)
    p.add_argument("--zigzag-ring", action="store_true")
    p.add_argument("--sequence-parallel", choices=["ring", "ulysses"],
                   default="ring")
    p.add_argument("--remat-policy", choices=["full", "dots"], default="full",
                   help="per-layer checkpoint policy (llama); only 'full' "
                        "is ported")
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
    p.add_argument("--pp-microbatch", type=int, default=0)
    p.add_argument("--mlm-layout", choices=["mask", "positions"],
                   default="mask")
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
    p.add_argument("--heartbeat-every", type=int, default=0)
    return p


def refuse_unported(args) -> None:
    """SystemExit for every flag whose machinery is a later slice of the
    port, naming the ROADMAP.md item that brings it."""
    def refuse(what: str, item: str):
        raise SystemExit(f"{what} is not ported yet (ROADMAP.md {item})")

    if args.model not in PORTED_MODELS:
        item = ("item 13" if args.model.startswith(("mixtral", "llama-moe"))
                else "item 11")
        refuse(f"--model {args.model!r} (the port trains "
               f"{', '.join(PORTED_MODELS)})", f"queue (a) {item}")
    if args.checkpoint_dir:
        refuse("--checkpoint-dir", "queue (a) item 9")
    if args.data:
        refuse("--data (the token-file stream)", "queue (a) item 5")
    if args.heartbeat_every > 0:
        refuse("--heartbeat-every (step heartbeats, device-memory samples)",
               "queue (a) item 10")
    if args.profile_dir:
        refuse("--profile-dir (device profiler traces)", "queue (a) item 10")
    if args.remat_policy == "dots":
        refuse("--remat-policy dots", "queue (a) item 4")
    wide = {a: n for a, n in parse_mesh_spec(args.mesh).items() if n > 1}
    if wide:
        refuse(f"--mesh {wide} (multi-device meshes)", "queue (a) items 6-7")


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


class Workload:
    """A model adapted to the trainer loop: ``step_fn(*batch) -> loss``
    updates the model in place; the fixed synthetic ``batch`` is reused
    every step."""

    def __init__(self, *, model, optimizer, step_fn: Callable, batch: tuple,
                 examples_per_step: int, tokens_per_step: int = 0):
        self.model = model
        self.optimizer = optimizer
        self.step_fn = step_fn
        self.batch = batch
        self.examples_per_step = examples_per_step
        self.tokens_per_step = tokens_per_step


def _resnet_workload(args, mesh, n_devices: int) -> Workload:
    import numpy as np
    import torch

    from ..models import resnet as lib
    from ..ops.bn import require_single_device

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
    lr = _make_learning_rate(args)
    schedule = lr if callable(lr) else None
    # optax.sgd(lr, momentum=0.9, nesterov=True): no dampening, no decay.
    optimizer = torch.optim.SGD(
        model.parameters(), lr=schedule(0) if schedule else lr,
        momentum=0.9, nesterov=True, dampening=0, weight_decay=0,
    )
    rng = np.random.RandomState(args.seed)
    images = rng.standard_normal(
        (global_batch, args.image_size, args.image_size, 3)
    ).astype(np.float32)
    labels = rng.randint(0, 1000, (global_batch,))
    # NHWC as drawn -> [N, 3, H, W] in channels_last memory (a view).
    images = torch.as_tensor(images, device=mesh.device).permute(0, 3, 1, 2)
    labels = torch.as_tensor(labels, dtype=torch.long, device=mesh.device)
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

    kw = dict(
        attention_impl=args.sequence_parallel if sp > 1 else "flash",
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


def _lm_workload(args, mesh, n_devices: int) -> Workload:
    import numpy as np
    import torch

    from ..models import llama as lib
    from ..parallel.mesh import SP

    sizes = mesh.sizes
    sp = sizes.get(SP, 1)
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

    cfg = llama_config_from_args(args, sp)
    model = lib.Llama(cfg, device=mesh.device)
    lib.init_params(
        model, torch.Generator(device=mesh.device).manual_seed(args.seed)
    )
    lr = _make_learning_rate(args)
    schedule = lr if callable(lr) else None
    # optax.adamw's defaults: b1 0.9, b2 0.999, eps 1e-8, weight decay
    # 1e-4 (torch's own default decay is 0.01).
    optimizer = torch.optim.AdamW(
        model.parameters(), lr=schedule(0) if schedule else lr,
        betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-4,
    )
    tokens = torch.as_tensor(
        rng.randint(0, cfg.vocab_size, (global_batch, args.seq_len)),
        dtype=torch.long, device=mesh.device,
    )
    step_fn = lib.make_train_step(
        model, optimizer, accum_steps=args.grad_accum, lr_schedule=schedule
    )
    return Workload(
        model=model,
        optimizer=optimizer,
        step_fn=step_fn,
        batch=(tokens,),
        examples_per_step=global_batch,
        tokens_per_step=global_batch * args.seq_len,
    )


def build_workload(args, mesh, n_devices: int) -> Workload:
    if args.model.startswith("resnet"):
        return _resnet_workload(args, mesh, n_devices)
    if args.model.startswith("llama"):
        return _lm_workload(args, mesh, n_devices)
    raise SystemExit(f"unknown --model {args.model!r}")


def _sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None) -> int:
    # Join the operator's trace before anything logs.
    trace.adopt_from_environ()
    args = build_parser().parse_args(argv)
    if args.steps < 1:
        raise SystemExit("--steps must be >= 1")
    refuse_unported(args)

    from ..api.v2beta1 import constants as api_constants
    from ..launcher import bootstrap
    from ..ops._common import require_device
    from ..parallel.mesh import create_mesh
    from ..utils import metrics as metrics_lib
    from ..utils import telemetry as telemetry_lib

    device = require_device(args.device)
    cfg = bootstrap.initialize()
    mesh = create_mesh(device=device, **parse_mesh_spec(args.mesh))
    n_devices = 1
    log.info(
        "process %d/%d, %d device (%s), mesh %s",
        cfg.process_id, cfg.num_processes, n_devices, device, mesh.sizes,
    )

    work = build_workload(args, mesh, n_devices)

    start_step = 0
    end = args.steps
    # Warmup steps are real optimizer steps and count toward the step
    # number; only the timing excludes them, so kernel builds and
    # allocator warmup stay out of the throughput number.
    warmup = max(args.warmup, 1)
    timed_from = min(start_step + warmup, end - 1)
    # Preemption-aware shutdown: finish the current step and stop.
    preempted = threading.Event()

    def _on_sigterm(signum, frame):
        log.warning("SIGTERM: stopping at the next step boundary")
        preempted.set()

    prev_handler = signal.signal(signal.SIGTERM, _on_sigterm)

    telem = telemetry_lib.TrainingTelemetry(
        tokens_per_step=work.tokens_per_step,
        examples_per_step=work.examples_per_step,
        registry=metrics_lib.Registry(),
        interval=max(args.telemetry_every, 0),
        jsonl_path=args.telemetry_path,
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

    t0 = t_log = None
    first_loss: Optional[object] = None
    step = last_log_step = start_step
    telem.start()
    t_prev = time.perf_counter()
    while step < end:
        if step == timed_from:
            _sync(device)
            t0 = t_log = time.perf_counter()
            last_log_step = step
        loss = work.step_fn(*work.batch)
        if first_loss is None:
            first_loss = loss
        step += 1
        if step_slowdown > 1.0:
            # Pad BEFORE timing so the stretched wall time lands in this
            # step's telemetry.
            time.sleep((step_slowdown - 1.0) * (time.perf_counter() - t_prev))
        now = time.perf_counter()
        telem.record_step(step, now - t_prev, warmup=step <= timed_from)
        t_prev = now
        if args.log_every and step % args.log_every == 0:
            # The log cadence is the explicit sync point: .item() waits
            # for the step, so the ms/step below measures completed work.
            loss_val = float(loss)
            if t_log is not None and step > last_log_step:
                now = time.perf_counter()
                ms = (now - t_log) / (step - last_log_step) * 1000
                log.info("step %d: loss=%.4f %.1f ms/step", step, loss_val, ms)
                t_log, last_log_step = now, step
            else:  # still inside warmup: loss only, no bogus timing
                log.info("step %d: loss=%.4f (warmup)", step, loss_val)
        if preempted.is_set():
            log.warning("preemption: stopping at step %d", step)
            break
    _sync(device)
    timed_steps = max(step - timed_from, 0)
    elapsed = (time.perf_counter() - t0) if t0 is not None else 0.0
    final_loss = float(loss)
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
        "first_loss": float(first_loss),
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
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
