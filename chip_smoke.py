#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main paths on one GPU and hold every
kernel against its plain PyTorch version.

    python3 chip_smoke.py                      # every phase
    python3 chip_smoke.py --phases kernels     # build + kernel checks only

Phases, in order:

1. the card (``nvidia-smi`` name and power limit) and the kernel build:
   every CUDA source under ``mpi_operator_tpu_torch/csrc/``, one ``nvcc``
   each, all started together; each kernel's registers and spills from
   ptxas (a flash kernel that spills fails the run) and, from
   ``cuobjdump -sass``, its tensor-core instructions (the bf16 forward,
   dq and dk/dv bodies must be there at both head dims and issue wgmma,
   HGMMA in SASS);
2. ``kernels``: each kernel against its plain version on the card, with
   times by CUDA events beside the bound and one PyTorch library call:
   - the six flash kernels, flat ([B, S, H*D]) and [B*H, S, D], at the
     Llama training shape (B=2, S=2048, H=32, Hkv=8, D=128, bf16,
     causal) and the BERT-base shape (B=64, S=512, H=12, D=64, bf16,
     non-causal; timed at both), and in f32 and bf16 a padded GQA shape
     (S=200), a masked-row shape (Sq > Sk, causal) and, for the
     [B*H, S, D] kernels, an id-masked shape with rows that see nothing
     (their out, lse and dq must be exactly 0, -1e30 and 0); bf16 also at
     head dims 80 and 32, which run on the tensor-core bodies' next
     instantiated width (128, 64); the flat kernels also at ViT-B/16's
     shape (B=64, S=197, H=12, D=64, ragged tiles), seq2seq's cross
     attention (B=16, Sq=256, Sk=512, H=8, D=64) and its causal decoder
     (B=16, S=256); at the Llama, BERT, ViT and cross shapes each kernel
     and the backward pair (dq then dk/dv) are timed, beside SDPA;
   - the BN kernels at the ResNet-101 stem ([802816, 64] bf16 at B=64),
     stage 3's widest layer ([3136, 2048] bf16) and a ragged f32 shape
     ([1000, 130]);
   - the bf16 head product (cuBLAS bf16 GEMMs with f32 logits) at one
     Llama head chunk against its plain version;
3. ``model``: llama3-8b at full width, 2 layers: loss and every gradient
   through the flat kernels and through the [B*H, S, D] kernels
   (``flash-bhsd``) against the dense oracle; ResNet-101 at full width
   and depth, B=8: loss, every gradient and the running statistics
   through the BN kernels against the plain-op BN route; BERT-base at
   full depth and width, B=8, S=512: loss and every gradient through
   both flash routes against the dense oracle, in f32 and bf16; ViT-B/16
   (B=8) and t5-small seq2seq (B=4, src 512, dec 256) through the flat
   kernels against the dense oracle in f32, and in bf16 against the flat
   route through the kernels' plain versions;
4. ``train``: the trainer's own entry point
   (``mpi_operator_tpu_torch.cmd.train.main``) on each main path: Llama
   (full width, 2 layers, S=2048, 6 AdamW steps), ResNet-101 with
   ``--bn-kernel pallas`` (B=64, 224x224, 6 SGD steps) and BERT-base
   (B=64, S=512, ``--mlm-layout positions``, 6 AdamW steps), then 3 steps
   of the BERT train step on the ``flash-bhsd`` route, then ViT-B/16
   (B=64) and t5-small seq2seq (B=16, src 512, dec 256), 6 AdamW steps
   each. Then the data, checkpoint and eval layers: the Llama run again
   on a token file (``--data``, 5 sequences of 2048 written from a seed,
   so step 2 straddles an epoch); BERT-base with ``--data`` (100 x 512
   tokens) and ``--save-every 2``, straight to step 4 and, in a fresh
   directory, to step 2 then resumed to step 4, once with the synchronous
   manager and once with ``--async-checkpoint``: the resumed loss and
   every parameter held against the straight run at
   ``tests/test_train.py``'s tolerance (rtol 1e-5, atol 1e-6) plus twice
   the sync-to-async straight runs' own difference (the gathered
   positions' backward adds with atomics); ``cmd.eval`` on a llama-tiny
   checkpoint the trainer wrote on the card (flash forward only, held
   against the same command on the CPU), and ``cmd.eval.evaluate`` at
   llama3-8b width (2 layers, S=2048, B=2, 4 batches) through the flat
   kernel against the dense route. Each loss must be
   finite (and, for the trainer runs, fall), and each run's launch
   counters (set to 0 just before it, read just after) must show exactly
   its own kernels;
5. ``moe``: the trainer on mixtral-8x7b at full width (dim 4096, 32 q / 8
   kv heads of 128, ffn 14336, 8 experts top-2, vocab 32000), depth cut
   to 2, B=2, S=2048, 6 AdamW steps: the flat flash launches (24/12/12),
   tokens/s and MFU over the routed FLOPs, each layer's router aux loss
   and dropped share on the run's batch, AdamW alone and a profile of two
   more steps;
6. ``decode``: KV-cache decoding (``models/generate.py``, which launches
   no kernel, as the JAX version's plain einsums): llama3-8b at full width
   and depth from seeded parameters (B=4, a 128-token prompt, 128 new,
   greedy), the weights-read bound printed first, ms a step, new tokens/s
   and the idle share (one step eager against its CUDA-graph replay); its
   teacher-forced logits against the training forward of the prompt
   (flash forward, 32 launches) at DECODE_LOGITS_TOL, argmax agreement
   printed; the same for the moe phase's Mixtral (its forward with the
   capacity raised so nothing drops) and seq2seq-small (B=16, src 512, 64
   new); then ``python -m mpi_operator_tpu_torch.cmd.generate`` on
   llama-tiny and llama-moe-tiny checkpoints the trainer writes here, its
   tokens against the same command on the CPU;
7. ``world``: the port across processes. A one-process NCCL world formed
   by the launcher's own ``form_world``, with the healthcheck's collective
   probe and its JSON line. Then one gang of two processes on the one
   card (``python3 chip_smoke.py --world-child``, the rendezvous env, the
   gang barrier, ``cmd.train.main``; gloo, since NCCL refuses two ranks
   on one GPU) runs in turn: BERT-base at full size (B=64 global, S=512,
   ``--mlm-layout positions``) with ``--mesh dp=2``, six steps, its loss
   curve held against the one-process run of the same call (rtol 2e-3)
   and each rank's flash launches against that run's; three steps each
   with ``fsdp=2`` (FSDP2) and ``tp=2`` (the tensor-parallel plan); a
   checkpoint saved sharded by ``fsdp=2`` at step 2 and resumed on
   ``dp=2`` to step 3; the resume check on a token file (straight to
   step 4 against step 2 then resumed to 4, a save every 2 steps);
   SIGTERM to rank 1 alone (both
   ranks stop at step 2 and commit it, then resume to ``--steps``); and
   ``cmd.eval --mesh dp=2`` on a llama-tiny checkpoint the pair wrote,
   against the one-process eval; and mixtral-8x7b at depth 1 on
   ``--mesh ep=2`` (3 steps, each rank holding 4 of the 8 experts) against
   the one-process run. Its step times measure gloo staging every
   collective through the host, not the port on a multi-GPU node;
8. ``profile`` (opt-in, ``--phases profile``): where one training step's
   time goes, for each arm (device kernel time by kind, idle share);
9. ``data`` (opt-in, ``--phases data``): the cost of ``--data`` on the
   step, as a same-call A/B: the Llama and the BERT-base train runs
   synthetic and on a token file in turns (S D D S, four times), 10 steps
   each, with every run's step_ms and each side's median.

Any failure raises and exits non-zero. The second-to-last line is the
``{"kernels": [...]}`` record; the last is
``{"ok": true, "device": {...}}``. Exits 1 with no result when no CUDA
device is present.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import math
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

# H100 SXM published dense peaks (NVIDIA data sheet), at the 700 W limit.
PEAK_FLOPS = {"bf16": 989e12, "f32": 67e12}  # f32: FMA pipes, no TF32
PEAK_BYTES_PER_S = 3.35e12

# Kernel checks. bf16 operands: the kernel accumulates in f32 and rounds
# each output to bf16 once (2^-9 relative); the tensor-core bodies also
# round P (forward, dv) and dS (dk and dq) to bf16 before their products,
# 2^-9 relative per term, which averages down over the sum. The plain version
# runs in f32 on the same bf16 inputs, so the norm-relative error is
# ~1e-3-2e-3; 1e-2 leaves room for summation order. f32: only summation
# order and expf differ (~1e-6 relative over a few hundred terms).
NORM_REL_TOL = {"bf16": 1e-2, "f32": 2e-5}
LSE_ABS_TOL = {"bf16": 1e-4, "f32": 1e-4}
# Model check (bf16 compute): the kernel and oracle paths round their
# attention outputs and gradients to bf16 at different points; through
# two layers and the head that stays within these bounds.
MODEL_LOSS_REL_TOL = 2e-3
MODEL_GRAD_NORM_REL_TOL = 3e-2
# BN kernel checks. Both sides read the same values and sum in f32, in
# another order: the kernel's longest serial run is ~1e2 terms (a
# thread's rows, then a finalize group's chunks), so rounding stays
# below ~1e-5 of the sum of the terms' magnitudes. The error of every
# sum is measured against that scale (Σ|x|, Σx², Σ|dy|, Σ|dy·x̂|): Σx
# and Σdy·x̂ of zero-mean data cancel, so their own norm is no scale.
BN_SUM_TOL = 2e-5
# ResNet-101 model check. The reference is the plain BN route in f64.
# The loss and the running statistics are well conditioned: in f32 the
# two routes, which differ only in the order of f32 sums, must agree
# directly. The gradients are not: at B=8 with every BN scale drawn
# from U(0.5, 1.5), a ~1e-7 perturbation grows to ~5e-2 norm-relative
# through 104 BN backward passes (measured on an H100). So each route's
# gradients (and, in bf16, everything) are held against the f64 run: the
# kernel route's error may be at most twice the plain route's, plus a
# floor for the type.
RESNET_F32_DIRECT_TOL = {"loss": 1e-4, "stats": 1e-3}
RESNET_ERROR_RATIO = 2.0
RESNET_FLOOR = {"float32": 1e-4, "bfloat16": 1e-2}
# BERT-base model check (12 post-LN layers). f32: the kernel routes and
# the dense oracle differ only in the order of f32 sums. bf16: each route
# is held against the f32 oracle, the kernel routes at most this ratio of
# the dense bf16 route's own error plus a floor, on the leaves whose
# gradient is at least BERT_TINY_LEAF of their layer's largest
# (check_bert_model says why).
BERT_F32_TOL = {"loss": 1e-5, "grads": 1e-3}
BERT_ERROR_RATIO = 2.0
BERT_BF16_FLOOR = 1e-2
BERT_TINY_LEAF = 2e-2
BERT_LAYERS = 12

TRAIN_ARGS = [
    "--model", "llama3-8b", "--n-layers", "2", "--seq-len", "2048",
    "--global-batch", "2", "--xent-chunk", "1024", "--steps", "6",
    "--warmup", "2", "--lr", "3e-4", "--log-every", "1",
]

RESNET_TRAIN_ARGS = [
    "--model", "resnet101", "--bn-kernel", "pallas", "--global-batch", "64",
    "--image-size", "224", "--steps", "6", "--warmup", "2", "--lr", "0.1",
    "--log-every", "1",
]
RESNET_BN_LAYERS = 104  # stem 1 + 33 blocks x 3 + 4 projections

# 1e-4: BERT's published pretraining rate (the trainer's default 0.1 is
# ResNet's).
BERT_TRAIN_ARGS = [
    "--model", "bert-base", "--global-batch", "64", "--seq-len", "512",
    "--mlm-layout", "positions", "--steps", "6", "--warmup", "2", "--lr",
    "1e-4", "--log-every", "1",
]

# ViT-B/16 and t5-small seq2seq: the JAX trainer's default batches (64
# images, 16 pairs a device), seq2seq with src 512 and dec 256; AdamW at
# 3e-4, Llama's rate here.
VIT_TRAIN_ARGS = [
    "--model", "vit-base", "--global-batch", "64", "--steps", "6",
    "--warmup", "2", "--lr", "3e-4", "--log-every", "1",
]
VIT_LAYERS = 12
S2S_TRAIN_ARGS = [
    "--model", "seq2seq-small", "--global-batch", "16", "--seq-len", "512",
    "--steps", "6", "--warmup", "2", "--lr", "3e-4", "--log-every", "1",
]
S2S_ATTENTION_CALLS = 18  # 6 encoder self, 6 decoder self, 6 cross

# The data, checkpoint and eval checks of the train phase.
# llama3-8b on 5 x 2048 tokens: at B=2, step 2 takes positions 4 and 5,
# the last of epoch 0 and the first of epoch 1.
DATA_SEQUENCES = 5
# BERT-base resume: --data on 100 x 512 tokens, a save every 2 steps,
# straight to 4 against 2 then resume to 4. The JAX resume test's
# tolerance (tests/test_train.py test_resume_restores_parameters).
RESUME_SEQUENCES = 100
RESUME_ARGS = BERT_TRAIN_ARGS + ["--save-every", "2"]
RESUME_RTOL, RESUME_ATOL = 1e-5, 1e-6
# cmd.eval at llama3-8b width: 4 batches of 2 x 2048.
EVAL_BATCH, EVAL_BATCHES, EVAL_SEQ = 2, 4, 2048
# The card's f32 flash kernel against its CPU plain version on the same
# llama-tiny checkpoint: only the order of f32 sums differs.
TINY_EVAL_RTOL = 1e-5

# Phase moe: Mixtral-8x7B at full width (dim 4096, 32 q / 8 kv heads of
# 128, ffn 14336, 8 experts routed top-2, vocab 32000, bf16, remat full),
# depth cut to 2: 3.165 G parameters, 50.6 GB of f32 parameters,
# gradients and AdamW moments before activations. Llama's cell settings.
MOE_LAYERS = 2
MOE_TRAIN_ARGS = [
    "--model", "mixtral-8x7b", "--n-layers", str(MOE_LAYERS), "--seq-len",
    "2048", "--global-batch", "2", "--xent-chunk", "1024", "--steps", "6",
    "--warmup", "2", "--lr", "3e-4", "--log-every", "1",
]
# Phase decode: llama3-8b at full width and depth from seeded parameters
# (and the moe phase's Mixtral), B=4, a 128-token prompt, 128 new tokens,
# greedy; seq2seq-small B=16, src 512, 64 new.
DECODE_BATCH, DECODE_PROMPT, DECODE_NEW = 4, 128, 128
S2S_DECODE_BATCH, S2S_DECODE_SRC, S2S_DECODE_NEW = 16, 512, 64
# Teacher-forced decode logits against the training forward of the same
# tokens, norm-relative. Both run bf16 products with f32 accumulation but
# round at other points (the forward's flash kernel rounds P to bf16, the
# decode step's attention is f32 over the bf16 cache; the forward's norms
# and residuals see other bf16 inputs): about five bf16 roundings (2^-9
# relative each) a layer apart, which grow as a random walk through 32
# layers to ~sqrt(160) x 2^-9 = 2.5e-2 of the hidden state at worst.
DECODE_LOGITS_TOL = 5e-2

# Kernel -> the TPU kernel it replaces.
REPLACES = {
    "flash_fwd": "mpi_operator_tpu/ops/attention.py:707",
    "flash_bwd_dq": "mpi_operator_tpu/ops/attention.py:835",
    "flash_bwd_dkv": "mpi_operator_tpu/ops/attention.py:930",
    "flash_bhsd_fwd": "mpi_operator_tpu/ops/attention.py:120",
    "flash_bhsd_bwd_dq": "mpi_operator_tpu/ops/attention.py:198",
    "flash_bhsd_bwd_dkv": "mpi_operator_tpu/ops/attention.py:243",
    # #1's function at d=64, with the TPU's 128-lane head packing.
    "flash_fwd_d64": "hack/headdim_probe.py:63",
    "bn_stats": "mpi_operator_tpu/ops/bn.py:54",
    "bn_grads": "mpi_operator_tpu/ops/bn.py:96",
}


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def time_ms(fn, warmup: int, iters: int) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def norm_rel(got, want) -> float:
    got, want = got.double(), want.double()
    return float((got - want).norm() / want.norm().clamp_min(1e-30))


def max_abs(got, want) -> float:
    return float((got.double() - want.double()).abs().max())


def bound(kind: str, shape: dict, dtype_name: str, pairs: int):
    """(bound_ms, bound_by): the larger of the operations at the card's
    peak for the type and the bytes (each input read once, each output
    written once) at its memory rate. ``pairs`` counts the visible
    (query, key) pairs of one head of these inputs."""
    b, sq, sk = shape["b"], shape["sq"], shape["sk"]
    h, hkv, d = shape["h"], shape["hkv"], shape["d"]
    es = 2 if dtype_name == "bf16" else 4
    q_bytes, kv_bytes = b * sq * h * d * es, b * sk * hkv * d * es
    stat_bytes = b * sq * h * 4
    macs_per_pair = {"fwd": 2, "dq": 3, "dkv": 4}[kind]
    flops = 2 * macs_per_pair * d * pairs * b * h
    if kind == "fwd":   # q, k, v in; out, lse out
        nbytes = 2 * q_bytes + 2 * kv_bytes + stat_bytes
    elif kind == "dq":  # q, k, v, do, lse, delta in; dq out
        nbytes = 3 * q_bytes + 2 * kv_bytes + 2 * stat_bytes
    else:               # q, k, v, do, lse, delta in; dk, dv out
        nbytes = 2 * q_bytes + 4 * kv_bytes + 2 * stat_bytes
    t_ops = flops / PEAK_FLOPS[dtype_name]
    t_bytes = nbytes / PEAK_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


# Flash kernel check shapes: (label, shape, layouts). "flat" is the
# projection layout [B, S, H*D] (flash_fwd, ...); "bhsd" is [B*H, S, D]
# (flash_bhsd_fwd, ...). The Llama and BERT shapes are timed.
FLASH_SHAPES = [
    ("llama", dict(b=2, sq=2048, sk=2048, h=32, hkv=8, d=128, dtype="bf16",
                   causal=True), ("flat", "bhsd")),
    # BERT-base (and hack/headdim_probe.py's own shape): d=64, non-causal.
    ("bert", dict(b=64, sq=512, sk=512, h=12, hkv=12, d=64, dtype="bf16",
                  causal=False), ("flat", "bhsd")),
    ("padded-gqa", dict(b=2, sq=200, sk=200, h=8, hkv=2, d=64, dtype="f32",
                        causal=False), ("flat", "bhsd")),
    ("masked-rows", dict(b=1, sq=130, sk=70, h=4, hkv=2, d=128, dtype="f32",
                         causal=True), ("flat", "bhsd")),
    # Ids from two chunks each (as a zigzag ring hop holds them); q rows
    # 16..39 see no column.
    ("id-masked", dict(b=2, sq=96, sk=80, h=4, hkv=2, d=64, dtype="f32",
                       causal=False, ids=True), ("bhsd",)),
    # The same edges on the bf16 tensor-core bodies: ragged tiles, rows
    # that see nothing (out = 0, lse = -1e30 exactly), ids.
    ("padded-gqa-bf16", dict(b=2, sq=200, sk=200, h=8, hkv=2, d=64,
                             dtype="bf16", causal=False), ("flat", "bhsd")),
    ("masked-rows-bf16", dict(b=1, sq=130, sk=70, h=4, hkv=2, d=128,
                              dtype="bf16", causal=True), ("flat", "bhsd")),
    ("id-masked-bf16", dict(b=2, sq=96, sk=80, h=4, hkv=2, d=64,
                            dtype="bf16", causal=False, ids=True),
     ("bhsd",)),
    # Head dims the bf16 bodies are not instantiated at: they run on the
    # next width up (128, 64) with the columns past D zero-filled.
    ("d80-bf16", dict(b=2, sq=150, sk=150, h=4, hkv=2, d=80, dtype="bf16",
                      causal=True), ("flat", "bhsd")),
    ("d32-bf16", dict(b=2, sq=100, sk=130, h=4, hkv=4, d=32, dtype="bf16",
                      causal=True), ("flat", "bhsd")),
    # ViT-B/16 at B=64: 197 = 128 + 69 q rows and 3 x 64 + 5 k rows, so
    # the last q and k tiles are ragged.
    ("vit", dict(b=64, sq=197, sk=197, h=12, hkv=12, d=64, dtype="bf16",
                 causal=False), ("flat",)),
    # t5-small seq2seq at B=16, src 512, dec 256: cross attention has
    # twice as many k tiles as q tiles; the decoder's self attention is
    # causal.
    ("s2s-cross", dict(b=16, sq=256, sk=512, h=8, hkv=8, d=64, dtype="bf16",
                       causal=False), ("flat",)),
    ("s2s-dec", dict(b=16, sq=256, sk=256, h=8, hkv=8, d=64, dtype="bf16",
                     causal=True), ("flat",)),
]
# The shapes timed (kernel, plain version, SDPA) besides being checked.
TIMED_SHAPES = ("llama", "bert", "vit", "s2s-cross")
FLASH_NAMES = {
    "flat": ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"),
    "bhsd": ("flash_bhsd_fwd", "flash_bhsd_bwd_dq", "flash_bhsd_bwd_dkv"),
}
# The record each kernel's line in {"kernels": [...]} carries: the shape
# of its main path (flat: the Llama trainer; bhsd: the BERT flash-bhsd
# steps); the other timed shape rides along under "at_<label>".
FLASH_RECORD_SHAPE = {"flat": "llama", "bhsd": "bert"}


def _id_chunks():
    import torch

    row = torch.cat([torch.arange(16, 64), torch.arange(160, 208)])
    col = torch.cat([torch.arange(40, 80), torch.arange(120, 160)])
    return row.to("cuda", torch.int32), col.to("cuda", torch.int32)


def _flash_calls(attn, layout: str, h: int, scale: float, causal: bool,
                 ids):
    """((fwd, dq, dkv) kernel wrappers, their plain versions), each taking
    (q, k, v) or (q, k, v, do, lse, delta) in ``layout``."""
    if layout == "flat":
        tail = (h, scale, causal)
        return ((lambda *a: attn.flash_fwd(*a, *tail),
                 lambda *a: attn.flash_bwd_dq(*a, *tail),
                 lambda *a: attn.flash_bwd_dkv(*a, *tail)),
                (lambda *a: attn.flash_fwd_plain(*a, *tail),
                 lambda *a: attn.flash_bwd_dq_plain(*a, *tail),
                 lambda *a: attn.flash_bwd_dkv_plain(*a, *tail)))
    tail = (scale, causal, *ids)
    return ((lambda *a: attn.flash_bhsd_fwd(*a, *tail),
             lambda *a: attn.flash_bhsd_bwd_dq(*a, *tail),
             lambda *a: attn.flash_bhsd_bwd_dkv(*a, *tail)),
            (lambda *a: attn.flash_bhsd_fwd_plain(*a, *tail),
             lambda *a: attn.flash_bhsd_bwd_dq_plain(*a, *tail),
             lambda *a: attn.flash_bhsd_bwd_dkv_plain(*a, *tail)))


def _kernel_name(mangled: str) -> str:
    """``flash::fwd_kernel_tc<64>`` from its mangled name (as far as the
    names here need), else the mangled name."""
    m = re.match(r"_ZN(\d+)(\w+)", mangled)
    if not m:
        return mangled
    n = int(m.group(1))
    ns, rest = m.group(2)[:n], m.group(2)[n:]
    m = re.match(r"(\d+)(\w+)", rest)
    if not m:
        return mangled
    n = int(m.group(1))
    name, rest = m.group(2)[:n], m.group(2)[n:]
    arg = re.match(r"ILi(\d+)E", rest)
    if arg:
        name += f"<{arg.group(1)}>"
    elif rest.startswith("IfE"):
        name += "<float>"
    elif rest.startswith("I13__nv_bfloat16E"):
        name += "<bf16>"
    return f"{ns}::{name}"


def ptxas_report(name: str) -> list:
    """(kernel, registers, spill store + load bytes) for each kernel of
    the library ``name``, from ptxas's -v output in its build log."""
    from mpi_operator_tpu_torch.ops import _build

    rows = []
    for block in _build.build_log(name).split("Compiling entry function")[1:]:
        regs = re.findall(r"Used (\d+) registers", block)
        spills = re.findall(r"(\d+) bytes spill stores, (\d+) bytes spill "
                            r"loads", block)
        rows.append((_kernel_name(block.split("'")[1]),
                     int(regs[0]) if regs else -1,
                     sum(int(a) + int(b) for a, b in spills)))
    return rows


def sass_tensor_ops(name: str) -> dict:
    """Kernel -> its tensor-core instructions in the built library
    ``name`` (``cuobjdump -sass``): HGMMA is wgmma, HMMA mma.sync."""
    from mpi_operator_tpu_torch.ops import _build

    tool = Path(_build.nvcc_path()).with_name("cuobjdump")
    text = subprocess.run([str(tool), "-sass", str(_build.library_path(name))],
                          check=True, capture_output=True, text=True,
                          timeout=300).stdout
    counts: dict = {}
    kernel = None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            kernel = _kernel_name(m.group(1))
            counts[kernel] = {"HGMMA": 0, "HMMA": 0}
        elif kernel is not None:
            for op in ("HGMMA", "HMMA"):
                if re.search(rf"\b{op}\.", line):
                    counts[kernel][op] += 1
    return counts


# The tensor-core body of each flash kernel's library (bf16), each
# instantiated at the head dims 64 and 128.
TC_BODIES = ("flash::fwd_kernel_tc", "flash::bwd_dq_kernel_tc",
             "flash::bwd_dkv_kernel_tc")
TC_HEAD_DIMS = (64, 128)


def check_build() -> None:
    """Per kernel: registers and spills (ptxas) and tensor-core
    instructions (SASS). Fails if a flash kernel spills, a flash library
    lacks a tensor-core body at one of TC_HEAD_DIMS, or a tensor-core body
    issues no wgmma."""
    from mpi_operator_tpu_torch.ops import _build

    failed = []
    for name in _build.KERNELS:
        sass = sass_tensor_ops(name)
        report = ptxas_report(name)
        for kernel, regs, spill in report:
            ops = sass.get(kernel, {})
            log(f"ptxas {name}: {kernel} registers {regs} spill bytes {spill}"
                f"; SASS HGMMA {ops.get('HGMMA')} HMMA {ops.get('HMMA')}")
            if name.startswith("flash") and spill:
                failed.append(f"{kernel} spills {spill} bytes")
            if kernel.startswith(TC_BODIES) and not ops.get("HGMMA"):
                failed.append(f"{kernel} issues no wgmma")
        bodies = sorted(kernel for kernel, _, _ in report
                        if kernel.startswith(TC_BODIES))
        dims = sorted(int(k[k.index("<") + 1:-1]) for k in bodies)
        if name.startswith("flash") and dims != list(TC_HEAD_DIMS):
            failed.append(f"{name} holds tensor-core bodies {bodies}, "
                          f"want one at each head dim of {TC_HEAD_DIMS}")
    if failed:
        raise AssertionError("kernel build checks failed: " + "; ".join(failed))


def check_kernels() -> dict:
    """Each flash kernel against its plain version at every shape of
    FLASH_SHAPES in each of its layouts, timed at TIMED_SHAPES. Returns a record per kernel (errors, times, bounds), plus
    ``flash_fwd_d64``: the flat forward at the BERT shape, the record for
    hack/headdim_probe.py's packed d=64 kernel."""
    import torch

    from mpi_operator_tpu_torch.ops import _build
    from mpi_operator_tpu_torch.ops import attention as attn

    timed = {}  # (kernel name, shape label) -> record
    gen = torch.Generator(device="cuda").manual_seed(0)
    for label, s, layouts in FLASH_SHAPES:
        dtype = torch.bfloat16 if s["dtype"] == "bf16" else torch.float32
        b, sq, sk, h, hkv, d = (s[k] for k in ("b", "sq", "sk", "h", "hkv", "d"))
        causal, scale = s["causal"], d ** -0.5
        ids = _id_chunks() if s.get("ids") else (None, None)

        def rand(*shape):
            return torch.randn(*shape, generator=gen, device="cuda").to(dtype)

        # One draw in [B, H, S, D]; each layout views or copies it.
        q4, k4, v4, do4 = (rand(b, n, ln, d) for n, ln in
                           ((h, sq), (hkv, sk), (hkv, sk), (h, sq)))
        lib_ms = None
        if label in TIMED_SHAPES:
            lib_ms = _sdpa_ms(q4, k4, v4, do4, causal)
        for layout in layouts:
            if layout == "flat":
                ops = [t.transpose(1, 2).reshape(b, t.shape[2], -1).contiguous()
                       for t in (q4, k4, v4, do4)]
            else:
                ops = [t.reshape(-1, t.shape[2], d) for t in (q4, k4, v4, do4)]
            qx, kx, vx, dox = ops
            kernels, plains = _flash_calls(attn, layout, h, scale, causal, ids)
            out, lse = kernels[0](qx, kx, vx)
            delta = (dox.float() * out.float()).reshape(*lse.shape, d).sum(-1)
            bwd_args = (qx, kx, vx, dox, lse, delta)
            dq = kernels[1](*bwd_args)
            dk, dv = kernels[2](*bwd_args)
            torch.cuda.synchronize()
            f32 = [t.float() for t in ops]
            out_p, lse_p = plains[0](*f32[:3])
            dq_p = plains[1](*f32, lse, delta)
            dk_p, dv_p = plains[2](*f32, lse, delta)
            live = lse_p > attn.NEG_INF / 2
            # Rows that see nothing: out = 0, lse = NEG_INF and dq = 0
            # exactly (dk and dv get nothing from them).
            dead_rows_ok = bool(
                torch.all(lse[~live] == attn.NEG_INF)
                and torch.all(out.reshape(*lse.shape, d)[~live] == 0)
                and torch.all(dq.reshape(*lse.shape, d)[~live] == 0))
            if s.get("ids") and bool(live.all()):
                raise AssertionError("the id-masked shape has no masked row")
            errs = [
                (max(max_abs(out, out_p), max_abs(lse[live], lse_p[live])),
                 norm_rel(out, out_p), max_abs(lse[live], lse_p[live])),
                (max_abs(dq, dq_p), norm_rel(dq, dq_p), 0.0),
                (max(max_abs(dk, dk_p), max_abs(dv, dv_p)),
                 max(norm_rel(dk, dk_p), norm_rel(dv, dv_p)), 0.0),
            ]
            del out_p, dq_p, dk_p, dv_p, f32
            tol = NORM_REL_TOL[s["dtype"]]
            for name, (mabs, nrel, lse_err) in zip(FLASH_NAMES[layout], errs):
                ok = (nrel <= tol and lse_err <= LSE_ABS_TOL[s["dtype"]]
                      and math.isfinite(mabs) and dead_rows_ok)
                log(f"kernel {name} [{label} {s}]: max_abs_err={mabs:.3e} "
                    f"norm_rel_err={nrel:.3e} (tol {tol:.0e}) lse_abs_err="
                    f"{lse_err:.3e} masked_rows_ok={dead_rows_ok} -> "
                    f"{'ok' if ok else 'FAIL'}")
                if not ok:
                    raise AssertionError(f"{name} disagrees with its plain "
                                         f"version at {label}")
            if lib_ms is None:
                continue
            pairs = int(attn._visible(sq, sk, causal, "cuda").sum())
            for i, (name, kind) in enumerate(zip(FLASH_NAMES[layout],
                                                 ("fwd", "dq", "dkv"))):
                args = (qx, kx, vx) if i == 0 else bwd_args
                bound_ms, bound_by = bound(kind, s, s["dtype"], pairs)
                rec = {
                    "ms": time_ms(lambda: kernels[i](*args), 2, 10),
                    "plain_ms": time_ms(lambda: plains[i](*args), 1, 3),
                    "bound_ms": bound_ms, "bound_by": bound_by,
                    "library_ms": lib_ms["fwd" if kind == "fwd" else "bwd"],
                    "max_abs_err": errs[i][0], "norm_rel_err": errs[i][1],
                }
                timed[name, label] = rec
                log(f"kernel {name} [{label}] timing: " + json.dumps(
                    {k: rec[k] for k in ("ms", "plain_ms", "bound_ms",
                                         "bound_by", "library_ms")}))
            # The backward pair as the autograd backward runs it, against
            # SDPA's whole backward (dq, dk and dv in one call).
            pair_ms = time_ms(lambda: (kernels[1](*bwd_args),
                                       kernels[2](*bwd_args)), 2, 10)
            for name in FLASH_NAMES[layout][1:]:
                timed[name, label]["bwd_pair_ms"] = pair_ms
            log(f"kernel backward pair {layout} [{label}] timing: "
                + json.dumps({"dq_plus_dkv_ms": pair_ms,
                              "library_ms": lib_ms["bwd"],
                              "ratio": pair_ms / lib_ms["bwd"]}))
            del out, lse, delta, dq, dk, dv, bwd_args, ops, qx, kx, vx, dox
        del q4, k4, v4, do4
        torch.cuda.empty_cache()
    # A CUDA tensor the kernels do not take raises; it never falls back
    # to the plain version.
    x16 = torch.zeros(1, 64, 2 * 128, device="cuda", dtype=torch.float16)
    x256 = torch.zeros(1, 64, 2 * 256, device="cuda")
    # bf16 rows are read in 16-byte chunks: a head dim of 20 is refused.
    x20 = torch.zeros(1, 64, 2 * 20, device="cuda", dtype=torch.bfloat16)
    for bad, err in ((x16, TypeError), (x256, ValueError), (x20, ValueError)):
        for fn in (lambda x: attn.flash_fwd(x, x, x, 2, 0.1, True),
                   lambda x: attn.flash_bhsd_fwd(
                       x.reshape(2, 64, -1), x.reshape(2, 64, -1),
                       x.reshape(2, 64, -1), 0.1, True)):
            try:
                fn(bad)
            except err as e:
                log(f"kernel flash refuses {bad.dtype} d={bad.shape[2] // 2}: "
                    f"{type(e).__name__}: {e}")
            else:
                raise AssertionError("a flash kernel accepted operands it "
                                     "cannot take")

    records = {}
    for layout, names in FLASH_NAMES.items():
        main = FLASH_RECORD_SHAPE[layout]
        for name in names:
            records[name] = _kernel_record(name, REPLACES[name],
                                           timed[name, main], main)
            for (other, label), rec in timed.items():
                if other == name and label != main:
                    records[name][f"at_{label}"] = rec
    records["flash_fwd_d64"] = _kernel_record(
        "flash_fwd", REPLACES["flash_fwd_d64"], timed["flash_fwd", "bert"],
        "bert", name="flash_fwd_d64")
    torch.cuda.empty_cache()
    return records


def _kernel_record(kernel: str, replaces: str, rec: dict, shape: str,
                   name: str = "") -> dict:
    from mpi_operator_tpu_torch.ops import _build

    source = "mpi_operator_tpu_torch/csrc/" + _build.KERNELS[kernel][0]
    return {"name": name or kernel, "route": "cuda", "source": source,
            "replaces": replaces, "launches": 0, "shape": shape, **rec}


def _sdpa_ms(q, k, v, do, causal: bool) -> dict:
    """Library yardstick, timed here only: SDPA's forward, and its whole
    backward (dq, dk and dv in one call, the yardstick for both backward
    kernels), on the same values in [B, H, S, D]."""
    import torch
    import torch.nn.functional as F

    gqa = q.shape[1] != k.shape[1]
    qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))
    out = F.scaled_dot_product_attention(qg, kg, vg, is_causal=causal,
                                         enable_gqa=gqa)
    ms = {
        "fwd": time_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=causal, enable_gqa=gqa), 2, 10),
        "bwd": time_ms(lambda: torch.autograd.grad(
            out, (qg, kg, vg), do, retain_graph=True), 2, 10),
    }
    del out
    return ms


def check_bn_kernels() -> dict:
    """bn_stats and bn_grads against their plain versions at three shapes;
    returns the main-shape record per kernel."""
    import torch

    from mpi_operator_tpu_torch.ops import _build
    from mpi_operator_tpu_torch.ops import bn

    # (label, rows, channels, dtype, [N, H, W] the rows come from)
    shapes = [
        ("main", 802816, 64, "bf16", (64, 112, 112)),   # the stem at B=64
        ("stage3", 3136, 2048, "bf16", (64, 7, 7)),
        ("ragged", 1000, 130, "f32", None),
    ]
    gen = torch.Generator(device="cuda").manual_seed(2)
    records = {}
    for label, m, c, dtype_name, nhw in shapes:
        dtype = torch.bfloat16 if dtype_name == "bf16" else torch.float32
        x = torch.randn(m, c, generator=gen, device="cuda").to(dtype)
        dy = torch.randn(m, c, generator=gen, device="cuda").to(dtype)
        xf, dyf = x.float(), dy.float()
        mean = xf.mean(0)
        inv = torch.rsqrt(xf.var(0, unbiased=False) + 1e-5)

        s, q = bn.bn_stats(x)
        db, dg = bn.bn_grads(dy, x, mean, inv)
        torch.cuda.synchronize()
        s_p, q_p = bn.bn_stats_plain(x)
        db_p, dg_p = bn.bn_grads_plain(dy, x, mean, inv)
        xhat = (xf - mean) * inv
        scales = {  # the magnitude each sum's rounding scales with
            "s": xf.abs().sum(0), "q": q_p, "db": dyf.abs().sum(0),
            "dg": (dyf * xhat).abs().sum(0),
        }
        del xf, dyf, xhat

        def err(got, want, key):
            return float(((got.double() - want.double()).abs()
                          / scales[key].double().clamp_min(1e-30)).max())

        errs = {
            "bn_stats": (max(max_abs(s, s_p), max_abs(q, q_p)),
                         max(err(s, s_p, "s"), err(q, q_p, "q")),
                         max(norm_rel(s, s_p), norm_rel(q, q_p))),
            "bn_grads": (max(max_abs(db, db_p), max_abs(dg, dg_p)),
                         max(err(db, db_p, "db"), err(dg, dg_p, "dg")),
                         max(norm_rel(db, db_p), norm_rel(dg, dg_p))),
        }
        for name, (mabs, scaled, nrel) in errs.items():
            ok = scaled <= BN_SUM_TOL and math.isfinite(mabs)
            log(f"kernel {name} [{label} [{m}, {c}] {dtype_name}]: "
                f"max_abs_err={mabs:.3e} err/sum|terms|={scaled:.3e} "
                f"(tol {BN_SUM_TOL:.0e}) norm_rel_err={nrel:.3e} -> "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"{name} disagrees with its plain "
                                     f"version at {label}")
        if label != "main":
            continue

        # Library yardsticks, timed here only: the same data viewed as
        # [N, C, H, W] channels_last.
        n, h, w = nhw
        x4 = x.view(n, h, w, c).permute(0, 3, 1, 2)
        dy4 = dy.view(n, h, w, c).permute(0, 3, 1, 2)
        ones = torch.ones(c, device="cuda")
        es = x.element_size()
        vec_bytes = 2 * c * 4
        calls = {
            # x in; two f32 [C] out. One add and one FMA per element.
            "bn_stats": (lambda: bn.bn_stats(x),
                         lambda: bn.bn_stats_plain(x),
                         lambda: torch.batch_norm_stats(x4, 1e-5),
                         m * c * es + vec_bytes, 2 * m * c),
            # dy, x, mean, inv in; two f32 [C] out. A subtract, a
            # multiply, an FMA and an add per element.
            "bn_grads": (lambda: bn.bn_grads(dy, x, mean, inv),
                         lambda: bn.bn_grads_plain(dy, x, mean, inv),
                         lambda: torch.batch_norm_backward_reduce(
                             dy4, x4, mean, inv, ones, False, True, True),
                         2 * m * c * es + 2 * vec_bytes, 5 * m * c),
        }
        for name, (kernel_fn, plain_fn, lib_fn, nbytes, flops) in calls.items():
            t_ops = flops / PEAK_FLOPS["f32"]
            t_bytes = nbytes / PEAK_BYTES_PER_S
            mabs, scaled, nrel = errs[name]
            records[name] = {
                "name": name,
                "route": "cuda",
                "source": "mpi_operator_tpu_torch/csrc/"
                          + _build.KERNELS[name][0],
                "replaces": REPLACES[name],
                "launches": 0,
                "max_abs_err": mabs,
                "norm_rel_err": nrel,
                "ms": time_ms(kernel_fn, 3, 20),
                "plain_ms": time_ms(plain_fn, 2, 5),
                "bound_ms": max(t_ops, t_bytes) * 1e3,
                "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                "library_ms": time_ms(lib_fn, 3, 20),
            }
            log(f"kernel {name} [main] timing: " + json.dumps(
                {k: records[name][k] for k in
                 ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}))
        del x4, dy4
    # A CUDA operand the kernels do not take raises; it never falls back
    # to the plain version.
    x16 = torch.zeros(64, 8, device="cuda", dtype=torch.float16)
    strided = torch.zeros(8, 64, device="cuda").t()
    for bad, err_type in ((x16, TypeError), (strided, ValueError)):
        try:
            bn.bn_stats(bad)
        except err_type as e:
            log(f"kernel bn_stats refuses {bad.dtype} strides {bad.stride()}: "
                f"{type(e).__name__}: {e}")
        else:
            raise AssertionError("bn_stats accepted an operand it cannot take")
    torch.cuda.empty_cache()
    return records


# The head product (ops/losses.py HeadProduct) against its plain version.
# Logits: both sides multiply the same bf16 values with f32 accumulation,
# in another order (cuBLAS against an f32 GEMM of the upcast operands),
# ~1e-6 norm-relative over D=4096. dh and dw: the card rounds the f32
# cotangent to bf16 first (2^-9 relative an element, ~1.7e-3 of the
# product's norm, measured on the H100) where the plain version keeps it
# in f32, and both round their result to bf16 once.
HEAD_TOL = {"logits": 5e-5, "dh": 1e-2, "dw": 1e-2}


def check_head() -> dict:
    """The bf16 head product (``HeadProduct``: cuBLAS bf16 x bf16 GEMMs
    with f32 output) at the Llama head's shape, one ``--xent-chunk 1024``
    chunk of the B=2 batch (h [2048, 4096], w [4096, 128256]): the logits
    must be f32, and logits, dh and dw agree with the plain version
    (upcast operands, f32 products, the f32 cotangent) within HEAD_TOL.
    Returns the errors and times (the three GEMMs of a forward and
    backward against the plain version's three f32 GEMMs, and the bound:
    their operations at the bf16 peak)."""
    import torch

    from mpi_operator_tpu_torch.ops import losses

    gen = torch.Generator(device="cuda").manual_seed(4)
    n, d, v = 2 * 1024, 4096, 128256
    h = torch.randn(n, d, generator=gen, device="cuda").to(torch.bfloat16)
    w = (torch.randn(d, v, generator=gen, device="cuda") * d ** -0.5).to(
        torch.bfloat16)
    g = torch.randn(n, v, generator=gen, device="cuda") / n
    hg, wg = h.clone().requires_grad_(), w.clone().requires_grad_()
    logits = losses.HeadProduct.apply(hg, wg)
    dh, dw = torch.autograd.grad(logits, (hg, wg), g)
    torch.cuda.synchronize()
    errs = {"logits": norm_rel(logits, losses.head_logits_plain(h, w))}
    dh_p, dw_p = losses.head_grads_plain(h, w, g)
    errs["dh"], errs["dw"] = norm_rel(dh, dh_p), norm_rel(dw, dw_p)
    del dh_p, dw_p
    dtypes = (logits.dtype, dh.dtype, dw.dtype)
    ok = (dtypes == (torch.float32, torch.bfloat16, torch.bfloat16)
          and all(errs[k] <= HEAD_TOL[k] for k in errs)
          and math.isfinite(float(logits.float().abs().max())))
    del logits, dh, dw

    def fwd_bwd():
        out = losses.HeadProduct.apply(hg, wg)
        torch.autograd.grad(out, (hg, wg), g)

    def plain():
        losses.head_logits_plain(h, w)
        losses.head_grads_plain(h, w, g)

    rec = {"shape": [n, d, v], "norm_rel_err": errs, "tol": HEAD_TOL,
           "dtypes": [str(t).removeprefix("torch.") for t in dtypes],
           "fwd_bwd_ms": time_ms(fwd_bwd, 2, 5),
           "plain_ms": time_ms(plain, 1, 2),
           "bound_ms": 3 * 2 * n * d * v / PEAK_FLOPS["bf16"] * 1e3,
           "bound_by": "operations"}
    log(f"head bf16 product {json.dumps(rec)} -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the bf16 head product disagrees with its plain "
                             "version")
    try:
        losses.HeadProduct.apply(h.float(), w)
    except TypeError as e:
        log(f"head product refuses f32 operands: {e}")
    else:
        raise AssertionError("the head product accepted f32 operands")
    del h, w, g, hg, wg
    torch.cuda.empty_cache()
    return rec


def check_model() -> None:
    """llama3-8b, full width, 2 layers, B=1, S=256: loss and gradients
    through the flat kernels (``flash``) and the [B*H, S, D] kernels
    behind transposes (``flash-bhsd``) against the dense oracle on the
    same weights; each route's launch counters show its own kernels and
    no others."""
    import torch

    from mpi_operator_tpu_torch.models import llama as lib
    from mpi_operator_tpu_torch.ops import attention as attn

    cfg = lib.llama3_8b(n_layers=2, xent_chunk=128)
    tokens = torch.randint(
        0, cfg.vocab_size, (1, 256), device="cuda",
        generator=torch.Generator(device="cuda").manual_seed(1),
    )
    results = {}
    state = None
    for impl in ("flash", "flash-bhsd", "dense"):
        model = lib.Llama(lib.llama3_8b(n_layers=2, xent_chunk=128,
                                        attention_impl=impl), device="cuda")
        if state is None:
            lib.init_params(model, torch.Generator(device="cuda").manual_seed(0))
            state = {k: v.detach().clone() for k, v in model.state_dict().items()}
        else:
            model.load_state_dict(state)
        attn.reset_launch_counts()
        loss = lib.loss_fn(model, tokens)
        loss.backward()
        torch.cuda.synchronize()
        results[impl] = (float(loss.detach()), {n: p.grad.float() for n, p in
                                       model.named_parameters()},
                         dict(attn.LAUNCHES))
        del model, loss
    ld, gd, _ = results["dense"]
    failed = []
    for impl, layout in (("flash", "flat"), ("flash-bhsd", "bhsd")):
        lf, gf, launches = results[impl]
        loss_rel = abs(lf - ld) / abs(ld)
        worst = max((norm_rel(gf[n], gd[n]), n) for n in gd)
        own = FLASH_NAMES[layout]
        launches_ok = all((n > 0) == (k in own) for k, n in launches.items())
        ok = (math.isfinite(lf) and loss_rel <= MODEL_LOSS_REL_TOL
              and worst[0] <= MODEL_GRAD_NORM_REL_TOL and launches_ok)
        log(f"model llama3-8b/2 layers B=1 S=256 {impl}: loss kernel={lf:.6f} "
            f"oracle={ld:.6f} rel={loss_rel:.3e} (tol "
            f"{MODEL_LOSS_REL_TOL:.0e}); worst grad norm_rel={worst[0]:.3e} "
            f"at {worst[1]} (tol {MODEL_GRAD_NORM_REL_TOL:.0e}); kernel "
            f"launches {launches} -> {'ok' if ok else 'FAIL'}")
        if not ok:
            failed.append(impl)
    if failed:
        raise AssertionError(f"kernel routes {failed} disagree with the "
                             f"dense oracle")
    del results, gd, state
    torch.cuda.empty_cache()


def _grad_errors(got: dict, want: dict, tiny: float = 0.0) -> dict:
    """Gradient norm-relative error over all parameters at once and at
    the worst leaf. Left out of the worst leaf: the key biases (a softmax
    row is shift-invariant, so their exact gradient is 0 and each route's
    is rounding noise) and, with ``tiny`` > 0, every leaf whose reference
    norm is below ``tiny`` x the largest of its layer (or top-level
    module); those are listed under "tiny"."""
    diff = sum(float((got[n] - want[n]).double().norm() ** 2) for n in want)
    norm = sum(float(want[n].double().norm() ** 2) for n in want)
    leaf_norm = {n: float(want[n].double().norm()) for n in want}
    group_max: dict = {}
    for n, v in leaf_norm.items():
        group = n.split(".")[0]
        group_max[group] = max(group_max.get(group, 0.0), v)
    small = {n for n, v in leaf_norm.items()
             if v < tiny * group_max[n.split(".")[0]]}
    worst = max((norm_rel(got[n], want[n]), n) for n in want
                if not n.endswith(".wk.bias") and n not in small)
    return {"grads": math.sqrt(diff / norm), "worst_leaf": worst[0],
            "worst_leaf_name": worst[1],
            "tiny": {n: f"{norm_rel(got[n], want[n]):.2e}"
                     for n in sorted(small)}}


def check_bert_model() -> None:
    """BERT-base, full depth and width, B=8, S=512, mask layout: loss and
    every gradient through the flat kernels (``flash``) and the
    [B*H, S, D] kernels (``flash-bhsd``) against the dense oracle on the
    same weights and batch, in f32 and in bf16; each route's launch
    counters show its own kernels, 12 launches each, and no others.

    In f32 a kernel route and the oracle differ only in the order of f32
    sums: they must agree directly (BERT_F32_TOL), leaf by leaf. In bf16
    (the main path's type) each route rounds at other points, so every
    bf16 route is held against the f32 oracle: a kernel route may be at
    most BERT_ERROR_RATIO x as far from it as the dense bf16 route, plus
    a floor. The worst leaf there leaves out the leaves whose gradient is
    below BERT_TINY_LEAF of their layer's largest (at init, the last
    layers' q and k projections): the flash backward takes delta =
    rowsum(do * o) from the bf16-rounded output, as the JAX kernels do,
    and that rounding error, which the dense route's f32 softmax
    backward does not make, dominates so small a gradient. They still
    count in the all-leaf error."""
    import numpy as np
    import torch

    from mpi_operator_tpu_torch.models import bert as lib

    rng = np.random.RandomState(1)
    rows = rng.randint(0, 30522, (8, 512))
    mask = rng.rand(8, 512) < 0.15
    batch = (torch.as_tensor(np.where(mask, 0, rows), device="cuda"),
             torch.as_tensor(mask, dtype=torch.float32, device="cuda"),
             torch.as_tensor(rows, device="cuda"))
    model = lib.Bert(lib.bert_base(), device="cuda")
    lib.init_params(model, torch.Generator(device="cuda").manual_seed(0))
    state = {k: v.detach().clone() for k, v in model.state_dict().items()}
    del model
    runs = {(impl, dt): _route_pass(
                lambda: lib.Bert(lib.bert_base(attention_impl=impl,
                                               dtype=getattr(torch, dt)),
                                 device="cuda"),
                state, lib.mlm_loss, batch)
            for dt in ("float32", "bfloat16")
            for impl in ("dense", "flash", "flash-bhsd")}
    _hold_routes("bert-base B=8 S=512", runs, BERT_LAYERS)
    del runs, state
    torch.cuda.empty_cache()


def _hold_routes(label: str, runs: dict, n_calls: int) -> None:
    """Hold each attention route of one model against the f32 dense
    oracle: ``runs[impl, dtype]`` = (loss, f32 gradients by name, launch
    counts) for impl among dense, flash and flash-bhsd and dtype float32
    and bfloat16. Each kernel route must have launched its own three
    kernels ``n_calls`` times each (one forward + backward) and no other.

    f32: a kernel route and the oracle differ only in the order of f32
    sums and must agree directly (BERT_F32_TOL), leaf by leaf. bf16: each
    route rounds at other points, so every bf16 route is held against the
    f32 oracle: a kernel route may be at most BERT_ERROR_RATIO x as far
    from it as the dense bf16 route, plus a floor. The worst leaf there
    leaves out the leaves whose gradient is below BERT_TINY_LEAF of their
    layer's largest (``check_bert_model`` says why); they still count in
    the all-leaf error."""
    ref_loss, ref_grads, _ = runs["dense", "float32"]
    # The bf16 yardstick: the flat route through the kernels' plain
    # versions where the runs have it, else the dense route.
    yard = "flash-plain" if ("flash-plain", "bfloat16") in runs else "dense"
    ok_all = True
    for (impl, dt), (loss, grads, launches) in runs.items():
        own = {"flash": FLASH_NAMES["flat"], "flash-bhsd": FLASH_NAMES["bhsd"],
               "dense": (), "flash-plain": ()}[impl]
        launches_ok = all(n == (n_calls if k in own else 0)
                          for k, n in launches.items())
        err = {"loss": abs(loss - ref_loss) / abs(ref_loss),
               **_grad_errors(grads, ref_grads,
                              BERT_TINY_LEAF if dt == "bfloat16" else 0.0)}
        if impl in ("dense", "flash-plain"):
            ok = launches_ok and math.isfinite(loss)
            want = "a yardstick"
        elif dt == "float32":
            ok = (launches_ok and err["loss"] <= BERT_F32_TOL["loss"]
                  and err["worst_leaf"] <= BERT_F32_TOL["grads"])
            want = f"tol {BERT_F32_TOL}"
        else:
            plain = _grad_errors(runs[yard, dt][1], ref_grads,
                                 BERT_TINY_LEAF)
            plain["loss"] = abs(runs[yard, dt][0] - ref_loss) / abs(ref_loss)
            ok = launches_ok and all(
                err[k] <= BERT_ERROR_RATIO * plain[k] + BERT_BF16_FLOOR
                for k in ("loss", "grads", "worst_leaf"))
            want = (f"<= {BERT_ERROR_RATIO}x the {yard} {dt} route's "
                    f"{ {k: f'{plain[k]:.3e}' for k in ('loss', 'grads', 'worst_leaf')} }"
                    f" + {BERT_BF16_FLOOR:.0e}")
        ok_all = ok_all and ok
        log(f"model {label} {impl} {dt} vs the f32 dense oracle "
            f"(loss {ref_loss:.6f}): loss {loss:.6f}, "
            + json.dumps({k: (f"{v:.3e}" if isinstance(v, float) else v)
                          for k, v in err.items()})
            + f" ({want}); launches {launches} -> {'ok' if ok else 'FAIL'}")
    if not ok_all:
        raise AssertionError(f"a {label} kernel route disagrees with the "
                             f"dense oracle")


@contextlib.contextmanager
def _plain_flat_flash():
    """The flat flash route with the kernels' plain versions standing in
    for the kernel wrappers (on CUDA tensors too), for as long as the
    context lasts: the same algorithm, delta from the bf16 output
    included, in f32 arithmetic."""
    from mpi_operator_tpu_torch.ops import attention as attn

    names = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
    kernels = {n: getattr(attn, n) for n in names}
    try:
        for n in names:
            setattr(attn, n, getattr(attn, n + "_plain"))
        yield
    finally:
        for n, fn in kernels.items():
            setattr(attn, n, fn)


def _route_pass(make_model, state, loss_fn, batch):
    """One forward + backward of ``make_model()`` loaded from ``state``:
    (loss, f32 gradients by name, attention launches)."""
    import torch

    from mpi_operator_tpu_torch.ops import attention as attn

    model = make_model()
    model.load_state_dict(state)
    attn.reset_launch_counts()
    loss = loss_fn(model, *batch)
    loss.backward()
    torch.cuda.synchronize()
    out = (float(loss.detach()),
           {n: p.grad.float() for n, p in model.named_parameters()
            if p.grad is not None},
           dict(attn.LAUNCHES))
    del model, loss
    return out


def check_vit_seq2seq_models() -> None:
    """ViT-B/16 (B=8, 224x224) and t5-small seq2seq (B=4, src 512, dec
    256), full depth and width: loss and every gradient through the flat
    flash kernels against the dense oracle on the same weights and batch,
    in f32 and bf16, held as BERT's routes are (``_hold_routes``), except
    that the bf16 kernel route's yardstick is the same route through the
    kernels' plain versions. The dense bf16 route is no fair yardstick
    here: the flash backward takes delta = rowsum(do * o) from the
    bf16-rounded output, as the JAX kernels do, and in the deeper decoder
    layers of seq2seq (measured on the CPU at t5-small's widths) that
    puts a few q and k projections' gradients 3x as far from the f32
    oracle as the dense route's, above BERT_TINY_LEAF of their layer's
    largest. The plain versions share that delta, so the kernels are
    held to what their own algorithm gives. One forward + backward
    launches each flat kernel 12 times in ViT and 18 times in seq2seq (6
    encoder, 6 decoder self and 6 cross attention calls)."""
    import numpy as np
    import torch

    from mpi_operator_tpu_torch.models import seq2seq as s2s
    from mpi_operator_tpu_torch.models import vit

    rng = np.random.RandomState(2)
    images = torch.as_tensor(
        rng.standard_normal((8, 224, 224, 3)).astype(np.float32), device="cuda")
    labels = torch.as_tensor(rng.randint(0, 1000, (8,)), device="cuda")
    src = torch.as_tensor(rng.randint(1, 32128, (4, 512)), device="cuda")
    cases = [
        ("vit-base B=8", vit, vit.vit_base, vit.ViT, (images, labels), 12),
        ("seq2seq-small B=4 src 512 dec 256", s2s, s2s.t5_small_shape,
         s2s.Seq2Seq, (src, src[:, :256]), 18),
    ]
    for label, lib, config, cls, batch, n_calls in cases:
        model = cls(config(), device="cuda")
        lib.init_params(model, torch.Generator(device="cuda").manual_seed(0))
        state = {k: v.detach().clone() for k, v in model.state_dict().items()}
        del model
        def run(impl, dt):
            return _route_pass(
                lambda: cls(config(attention_impl=impl,
                                   dtype=getattr(torch, dt)), device="cuda"),
                state, lib.loss_fn, batch)

        runs = {(impl, dt): run(impl, dt) for dt in ("float32", "bfloat16")
                for impl in ("dense", "flash")}
        with _plain_flat_flash():
            runs["flash-plain", "bfloat16"] = run("flash", "bfloat16")
        _hold_routes(label, runs, n_calls)
        del runs, state
        torch.cuda.empty_cache()


def _resnet_pass(impl: str, dtype, state, images, labels):
    """One forward + backward of ResNet-101 on the BN route ``impl`` in
    ``dtype`` compute from ``state``: (loss, f32 gradients by name,
    running statistics by name, BN launches)."""
    import torch

    from mpi_operator_tpu_torch.models import resnet as lib
    from mpi_operator_tpu_torch.ops import bn

    model = lib.resnet(101, dtype=dtype, bn_impl=impl, device="cuda")
    model.to(memory_format=torch.channels_last).train()
    model.load_state_dict(state)
    bn.reset_launch_counts()
    loss = lib.loss_fn(model, images, labels)
    loss.backward()
    torch.cuda.synchronize()
    out = (float(loss.detach()),
           {n: p.grad.float() for n, p in model.named_parameters()},
           {n: b.clone() for n, b in model.named_buffers()},
           dict(bn.LAUNCHES))
    del model, loss
    return out


def _resnet_errors(got, ref) -> dict:
    """How far one pass lies from a reference pass: loss relative error,
    gradient norm-relative error over all parameters at once and at the
    worst leaf, and running-statistics error (each mean against its
    channel's running standard deviation, each variance relative)."""
    (lg, gg, sg, _), (lr, gr, sr, _) = got, ref
    diff = sum(float((gg[n] - gr[n]).double().norm() ** 2) for n in gr)
    norm = sum(float(gr[n].double().norm() ** 2) for n in gr)
    stats = 0.0
    for name, var in sr.items():
        if name.endswith(".var"):
            mean = name[:-len("var")] + "mean"
            scale = var.double().sqrt()
            stats = max(stats, float(
                ((sg[mean] - sr[mean]).double().abs() / scale).max()),
                float(((sg[name] - var).double().abs() / var.double()).max()))
    worst = max((norm_rel(gg[n], gr[n]), n) for n in gr)
    return {"loss": abs(lg - lr) / abs(lr), "grads": math.sqrt(diff / norm),
            "worst_leaf": worst[0], "worst_leaf_name": worst[1],
            "stats": stats}


def check_resnet_model() -> None:
    """ResNet-101, full width and depth, B=8, 224x224: loss, gradients and
    the updated running statistics through the BN kernels against the
    plain-op BN route on the same weights and batch.

    In f32 the two routes do the same math up to the order of f32 sums:
    their losses and running statistics must agree directly. Gradients
    (in f32) and everything in bf16 (the main path's type) spread a
    rounding difference through 104 layers, so there each route is held
    against the plain route run in f64: the kernel route may be at most
    about as far from it as the plain route is. Every BN scale is redrawn
    from U(0.5, 1.5) first (Flax zeroes each block's last one, which would
    leave most gradients at 0)."""
    import numpy as np
    import torch

    from mpi_operator_tpu_torch.models import resnet as lib

    rng = np.random.RandomState(1)
    images = torch.as_tensor(
        rng.standard_normal((8, 224, 224, 3)).astype(np.float32),
        device="cuda").permute(0, 3, 1, 2)
    labels = torch.as_tensor(rng.randint(0, 1000, (8,)), device="cuda")
    model = lib.resnet(101, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    lib.init_params(model, gen)
    with torch.no_grad():
        for mod in lib.bn_layers(model):
            mod.scale.uniform_(0.5, 1.5, generator=gen)
    state = {k: v.detach().clone() for k, v in model.state_dict().items()}
    del model

    cases = [("xla", "float64")] + [(impl, dt) for dt in ("float32", "bfloat16")
                                     for impl in ("pallas", "xla")]
    runs = {(impl, dt): _resnet_pass(impl, getattr(torch, dt), state,
                                     images, labels)
            for impl, dt in cases}
    want = {"bn_stats": RESNET_BN_LAYERS, "bn_grads": RESNET_BN_LAYERS}
    launches_ok = all(
        runs[impl, dt][3] == (want if impl == "pallas" else
                              {"bn_stats": 0, "bn_grads": 0})
        for impl, dt in runs)
    direct = _resnet_errors(runs["pallas", "float32"], runs["xla", "float32"])
    direct_ok = all(direct[k] <= tol for k, tol in RESNET_F32_DIRECT_TOL.items())
    fmt = lambda e: json.dumps({k: (f"{v:.3e}" if isinstance(v, float)
                                    else v) for k, v in e.items()})
    log(f"model resnet101 B=8 224x224 f32, kernel route vs plain route: "
        f"{fmt(direct)} (tol {RESNET_F32_DIRECT_TOL}) -> "
        f"{'ok' if direct_ok else 'FAIL'}")
    ref = runs["xla", "float64"]
    ratio_ok = True
    for dt in ("float32", "bfloat16"):
        err = {impl: _resnet_errors(runs[impl, dt], ref)
               for impl in ("pallas", "xla")}
        ok = all(err["pallas"][k] <= RESNET_ERROR_RATIO * err["xla"][k]
                 + RESNET_FLOOR[dt] for k in ("loss", "grads", "stats"))
        ratio_ok = ratio_ok and ok
        log(f"model resnet101 B=8 224x224 {dt} vs the f64 plain run "
            f"(loss {ref[0]:.6f}): kernel route {fmt(err['pallas'])}; plain "
            f"route {fmt(err['xla'])} (kernel loss, grads and stats <= "
            f"{RESNET_ERROR_RATIO}x plain + {RESNET_FLOOR[dt]:.0e}) -> "
            f"{'ok' if ok else 'FAIL'}")
    log(f"model resnet101 launches per pass: "
        f"{ {f'{i}/{d}': r[3] for (i, d), r in runs.items()} } (kernel "
        f"route want {want}) -> {'ok' if launches_ok else 'FAIL'}")
    if not (direct_ok and ratio_ok and launches_ok):
        raise AssertionError("BN kernel route disagrees with the plain route")
    del runs, state, images
    torch.cuda.empty_cache()


def _reset_all_launch_counts() -> None:
    from mpi_operator_tpu_torch.ops import attention as attn
    from mpi_operator_tpu_torch.ops import bn

    attn.reset_launch_counts()
    bn.reset_launch_counts()


def _all_launch_counts() -> dict:
    from mpi_operator_tpu_torch.ops import attention as attn
    from mpi_operator_tpu_torch.ops import bn

    return {**attn.LAUNCHES, **bn.LAUNCHES}


def _want_launches(counts: dict) -> dict:
    """Every launch counter: 0, except ``counts``."""
    return {**{k: 0 for k in _all_launch_counts()}, **counts}


def _drive_trainer(argv) -> tuple[dict, dict]:
    """``cmd.train.main(argv)`` with every launch counter set to 0 just
    before it and read just after; returns (summary line with the peak
    device memory added, launch counts)."""
    import torch

    from mpi_operator_tpu_torch.cmd import train

    torch.cuda.reset_peak_memory_stats()
    buf = io.StringIO()
    _reset_all_launch_counts()
    with contextlib.redirect_stdout(buf):
        rc = train.main(argv)
    launches = _all_launch_counts()
    if rc != 0:
        raise AssertionError(f"train.main returned {rc}")
    summary = json.loads(buf.getvalue().strip().splitlines()[-1])
    summary["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    return summary, launches


def run_resnet_train() -> tuple[dict, dict]:
    """The trainer's own entry point on the ResNet-101 path; returns
    (summary, launch counts)."""
    import torch

    from mpi_operator_tpu_torch.models import resnet as lib

    summary, launches = _drive_trainer(RESNET_TRAIN_ARGS)
    # MFU with 2 x MAC FLOPs: forward + backward = 3 x the forward FLOPs
    # per image (models/resnet.py flops_per_image), against the bf16
    # dense peak.
    summary["mfu_bf16_peak"] = (summary["examples_per_sec"] * 3
                                * lib.flops_per_image(101, 224)
                                / PEAK_FLOPS["bf16"])
    log("train resnet101 summary: " + json.dumps(summary))
    steps = summary["steps"]
    want = _want_launches({"bn_stats": RESNET_BN_LAYERS * steps,
                           "bn_grads": RESNET_BN_LAYERS * steps})
    ok = (steps == 6 and math.isfinite(summary["loss"])
          and summary["loss"] < summary["first_loss"] and launches == want)
    log(f"train resnet101 launches {launches} (want {want}); loss "
        f"{summary['first_loss']:.4f} -> {summary['loss']:.4f}; "
        f"images/s {summary['examples_per_sec']} step_ms "
        f"{summary['step_ms']} MFU {summary['mfu_bf16_peak']:.4f} peak "
        f"{summary['peak_mem_gb']:.2f} GB -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("ResNet training run failed its checks")
    torch.cuda.empty_cache()
    return summary, launches


def run_train() -> tuple[dict, dict]:
    """The trainer's own entry point; returns (summary, launch counts)."""
    summary, launches = _drive_trainer(TRAIN_ARGS)
    # MFU, PaLM-appendix accounting with 2 x MAC FLOPs: 6 x the matmul
    # parameters (2 layers + the LM head) + 6 L d S for causal attention,
    # per token, against the bf16 dense peak.
    from mpi_operator_tpu_torch.models import llama as lib

    cfg = lib.llama3_8b(n_layers=2)
    hd, seq = cfg.head_dim, 2048
    per_layer = (cfg.dim * (cfg.n_heads + 2 * cfg.n_kv_heads) * hd
                 + cfg.n_heads * hd * cfg.dim + 3 * cfg.dim * cfg.ffn_dim)
    n_matmul = cfg.n_layers * per_layer + cfg.dim * cfg.vocab_size
    flops_per_token = 6 * n_matmul + 6 * cfg.n_layers * cfg.dim * seq
    summary["mfu_bf16_peak"] = (
        summary["tokens_per_sec"] * flops_per_token / PEAK_FLOPS["bf16"])
    log("train summary: " + json.dumps(summary))
    layers, steps = 2, summary["steps"]
    want = _want_launches({"flash_fwd": 2 * layers * steps,
                           "flash_bwd_dq": layers * steps,
                           "flash_bwd_dkv": layers * steps})
    ok = (steps == 6 and math.isfinite(summary["loss"])
          and summary["loss"] < summary["first_loss"] and launches == want)
    log(f"train launches {launches} (want {want}); loss "
        f"{summary['first_loss']:.4f} -> {summary['loss']:.4f} -> "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("training run failed its checks")
    return summary, launches


def _bert_mfu(sequences_per_s: float, seq_len: int = 512) -> float:
    """bench.py's BERT accounting (PaLM appendix, fwd + bwd = 3 x fwd,
    head-aware): the encoder's parameters on all S tokens, the MLM head
    (d*d transform + d*V tied decode) on the n_pred gathered positions,
    12*L*d*S per token for bidirectional attention; against the bf16
    dense peak. The parameter count is the JAX tree's (no type_embed)."""
    from mpi_operator_tpu_torch.models import bert as lib

    cfg = lib.bert_base()
    meta = lib.Bert(cfg, device="meta")
    n_params = sum(p.numel() for n, p in meta.named_parameters()
                   if not n.startswith("type_embed."))
    n_head = cfg.dim * cfg.vocab_size + cfg.dim * cfg.dim
    n_pred = max(int(seq_len * 0.15), 1)
    flops_seq = ((6 * (n_params - n_head)
                  + 12 * cfg.n_layers * cfg.dim * seq_len) * seq_len
                 + 6 * n_head * n_pred)
    return sequences_per_s * flops_seq / PEAK_FLOPS["bf16"]


def run_bert_train() -> tuple[dict, dict]:
    """The trainer's own entry point on the BERT-base path (flat flash
    kernels); returns (summary, launch counts)."""
    import torch

    summary, launches = _drive_trainer(BERT_TRAIN_ARGS)
    summary["mfu_bf16_peak"] = _bert_mfu(summary["examples_per_sec"])
    steps = summary["steps"]
    want = _want_launches({k: BERT_LAYERS * steps
                           for k in FLASH_NAMES["flat"]})
    ok = (steps == 6 and math.isfinite(summary["loss"])
          and summary["loss"] < summary["first_loss"] and launches == want)
    log("train bert-base summary: " + json.dumps(summary))
    log(f"train bert-base launches {launches} (want {want}); loss "
        f"{summary['first_loss']:.4f} -> {summary['loss']:.4f}; sequences/s "
        f"{summary['examples_per_sec']} step_ms {summary['step_ms']} MFU "
        f"{summary['mfu_bf16_peak']:.4f} peak {summary['peak_mem_gb']:.2f} GB "
        f"-> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("BERT training run failed its checks")
    torch.cuda.empty_cache()
    return summary, launches


def _s2s_flops_per_pair(src_len: int = 512, dec_len: int = 256) -> float:
    """bench.py's seq2seq accounting (2 x MAC, fwd + bwd = 3 x fwd) with
    the source and decoder lengths apart: 6 x the encoder's matmul
    parameters on the source tokens, 6 x every other parameter (the tied
    table counted once, as the head) on the decoder tokens, 12*L*S^2*d
    for the encoder's self attention, 6*L*S_dec^2*d for the decoder's
    causal self attention and 12*L*S_dec*S_src*d for cross attention."""
    from mpi_operator_tpu_torch.models import seq2seq as lib

    cfg = lib.t5_small_shape()
    n_params = sum(p.numel() for p in
                   lib.Seq2Seq(cfg, device="meta").parameters())
    d, le, ld = cfg.dim, cfg.n_enc_layers, cfg.n_dec_layers
    enc_params = le * (4 * d * d + 2 * d * cfg.ffn_dim)
    return (6 * enc_params * src_len + 6 * (n_params - enc_params) * dec_len
            + 12 * le * src_len * src_len * d
            + 6 * ld * dec_len * dec_len * d
            + 12 * ld * dec_len * src_len * d)


def run_flat_train(label: str, argv, n_calls: int, flops_per_example: float
                   ) -> tuple[dict, dict]:
    """The trainer's own entry point on a model whose every attention call
    takes the flat flash kernels (``n_calls`` a step): a finite, falling
    loss over 6 steps and exactly ``n_calls`` x 6 launches of each flat
    kernel and none of any other; returns (the summary line with MFU,
    ``flops_per_example`` per example fwd + bwd at the bf16 peak; the
    launch counts)."""
    import torch

    summary, launches = _drive_trainer(argv)
    summary["mfu_bf16_peak"] = (summary["examples_per_sec"]
                                * flops_per_example / PEAK_FLOPS["bf16"])
    steps = summary["steps"]
    want = _want_launches({k: n_calls * steps for k in FLASH_NAMES["flat"]})
    ok = (steps == 6 and math.isfinite(summary["loss"])
          and summary["loss"] < summary["first_loss"] and launches == want)
    log(f"train {label} summary: " + json.dumps(summary))
    log(f"train {label} launches {launches} (want {want}); loss "
        f"{summary['first_loss']:.4f} -> {summary['loss']:.4f}; examples/s "
        f"{summary['examples_per_sec']} step_ms {summary['step_ms']} MFU "
        f"{summary['mfu_bf16_peak']:.4f} peak {summary['peak_mem_gb']:.2f} GB "
        f"-> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{label} training run failed its checks")
    torch.cuda.empty_cache()
    return summary, launches


def run_vit_seq2seq_train() -> dict:
    """ViT-B/16 (B=64) and t5-small seq2seq (B=16, src 512, dec 256)
    through the trainer, 6 steps each (``run_flat_train``); returns
    label -> (summary, launch counts)."""
    from mpi_operator_tpu_torch.models import vit

    return {
        "vit-base": run_flat_train("vit-base", VIT_TRAIN_ARGS, VIT_LAYERS,
                                   3 * vit.flops_per_image(vit.vit_base())),
        "seq2seq-small": run_flat_train(
            "seq2seq-small", S2S_TRAIN_ARGS, S2S_ATTENTION_CALLS,
            _s2s_flops_per_pair()),
    }


def _bert_bhsd_workload():
    """(model, step, batch) as the trainer builds them for BERT_TRAIN_ARGS
    -- the same init, batch draw and AdamW -- with attention_impl
    'flash-bhsd'."""
    import numpy as np
    import torch

    from mpi_operator_tpu_torch.cmd import train
    from mpi_operator_tpu_torch.models import bert as lib

    args = train.build_parser().parse_args(BERT_TRAIN_ARGS)
    model = lib.Bert(lib.bert_base(attention_impl="flash-bhsd"), device="cuda")
    lib.init_params(model,
                    torch.Generator(device="cuda").manual_seed(args.seed))
    rng = np.random.RandomState(args.seed)
    rows = rng.randint(0, model.config.vocab_size,
                       (args.global_batch, args.seq_len))
    pos, tg, inputs, w = train._mlm_positions_batch(
        rows, rng.rand(args.global_batch, args.seq_len))
    batch = tuple(torch.as_tensor(x, device="cuda") for x in (inputs, pos, tg))
    batch += (torch.as_tensor(w, device="cuda"),)
    optimizer = torch.optim.AdamW(model.parameters(), lr=args.lr,
                                  betas=(0.9, 0.999), eps=1e-8,
                                  weight_decay=1e-4)
    return model, lib.make_train_step_positions(model, optimizer), batch


def run_bert_bhsd_steps() -> dict:
    """3 steps of ``models/bert.py``'s ``make_train_step_positions`` with
    attention_impl 'flash-bhsd' (the step the trainer builds, at its batch
    and learning rate), with every launch counter set to 0 just before
    and read just after: 12 x 3 launches of each [B*H, S, D] kernel, 0 of
    any other. Steps 2-3 are timed."""
    import torch

    model, step, batch = _bert_bhsd_workload()
    torch.cuda.reset_peak_memory_stats()
    _reset_all_launch_counts()
    losses = [float(step(*batch))]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(2):
        loss = step(*batch)
    losses.append(float(loss))
    elapsed = time.perf_counter() - t0
    launches = _all_launch_counts()
    step_ms = elapsed / 2 * 1e3
    summary = {"steps": 3, "first_loss": losses[0], "loss": losses[-1],
               "step_ms": step_ms,
               "examples_per_sec": 64 / (step_ms / 1e3),
               "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    summary["mfu_bf16_peak"] = _bert_mfu(summary["examples_per_sec"])
    want = _want_launches({k: BERT_LAYERS * 3 for k in FLASH_NAMES["bhsd"]})
    ok = all(math.isfinite(x) for x in losses) and launches == want
    log("train bert-base flash-bhsd summary: " + json.dumps(summary))
    log(f"train bert-base flash-bhsd launches {launches} (want {want}) -> "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("BERT flash-bhsd steps failed their checks")
    del model, step, batch
    torch.cuda.empty_cache()
    return launches


def _token_file(path: Path, n_seq: int, seq_len: int, vocab: int,
                seed: int) -> str:
    """A uint32 token file of ``n_seq`` sequences, ids below ``vocab``,
    from RandomState(seed)."""
    import numpy as np

    from mpi_operator_tpu_torch.data import write_token_file

    write_token_file(path, np.random.RandomState(seed).randint(
        0, vocab, n_seq * seq_len))
    return str(path)


def run_llama_data_train(tmp: Path, synthetic: dict) -> tuple[dict, dict]:
    """The Llama path of ``run_train`` fed from a token file (``--data``):
    a finite, falling loss and the synthetic run's launch counts; its
    step_ms printed beside the synthetic run's. No checkpoint is taken
    (the state is 1.49 G f32 parameters plus AdamW's two moments)."""
    import torch

    from mpi_operator_tpu_torch.models import llama as lib

    data = _token_file(tmp / "llama.u32", DATA_SEQUENCES, 2048,
                       lib.llama3_8b().vocab_size, seed=1)
    summary, launches = _drive_trainer([*TRAIN_ARGS, "--data", data])
    layers, steps = 2, summary["steps"]
    want = _want_launches({"flash_fwd": 2 * layers * steps,
                           "flash_bwd_dq": layers * steps,
                           "flash_bwd_dkv": layers * steps})
    ok = (steps == 6 and math.isfinite(summary["loss"])
          and summary["loss"] < summary["first_loss"] and launches == want)
    log("train llama3-8b --data summary: " + json.dumps(summary))
    log(f"train llama3-8b --data launches {launches} (want {want}); loss "
        f"{summary['first_loss']:.4f} -> {summary['loss']:.4f}; step_ms "
        f"{summary['step_ms']} (synthetic {synthetic['step_ms']}), "
        f"tokens/s {summary.get('tokens_per_sec')} (synthetic "
        f"{synthetic.get('tokens_per_sec')}) -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("llama3-8b --data run failed its checks")
    torch.cuda.empty_cache()
    return summary, launches


def _checkpoint_seconds() -> dict:
    """(count, sum) of the snapshot and write histograms so far."""
    from mpi_operator_tpu_torch.utils import checkpoint as ck

    out = {}
    for name, hist in (("snapshot", ck.checkpoint_snapshot_seconds),
                       ("write", ck.checkpoint_write_seconds)):
        _, total, count = hist._series.get((), (None, 0.0, 0))
        out[name] = (count, total)
    return out


def _seconds_since(before: dict) -> dict:
    after = _checkpoint_seconds()
    return {k: {"saves": after[k][0] - before[k][0],
                "s": round(after[k][1] - before[k][1], 4)} for k in after}


def _final_params(directory: Path, step: int) -> dict:
    from mpi_operator_tpu_torch.utils.checkpoint import (
        CheckpointManager,
        committed_steps,
    )

    got, state = CheckpointManager(str(directory)).read_latest()
    if got != step or step not in (committed_steps(str(directory)) or ()):
        raise AssertionError(f"{directory}: newest step {got}, want a "
                             f"committed step {step}")
    return state["params"]


def run_bert_resume(tmp: Path) -> dict:
    """BERT-base on a token file with checkpoints every 2 steps: straight
    to step 4, and in a fresh directory to step 2 then resumed to 4, with
    the synchronous and then the async manager. The resumed summary must
    read final_step 4 after 2 steps; its loss and every parameter must
    match its manager's straight run at the JAX resume test's tolerance
    plus twice the difference between the two straight runs (which differ
    only by the card's atomics). A failed read or a torn fallback starts
    the resume cold, and its step count fails the check. Returns each
    manager's mean snapshot and write seconds a save and the GB a step."""
    import torch

    from mpi_operator_tpu_torch.models import bert

    data = _token_file(tmp / "bert.u32", RESUME_SEQUENCES, 512,
                       bert.bert_base().vocab_size, seed=2)
    base = [*RESUME_ARGS, "--data", data]
    runs, costs = {}, {}
    for manager in ("sync", "async"):
        extra = ["--async-checkpoint"] if manager == "async" else []
        straight_dir = tmp / f"bert-{manager}-straight"
        resumed_dir = tmp / f"bert-{manager}-resumed"
        before = _checkpoint_seconds()
        straight, s_launches = _drive_trainer(
            [*base, *extra, "--steps", "4", "--checkpoint-dir",
             str(straight_dir)])
        first, _ = _drive_trainer([*base, *extra, "--steps", "2",
                                   "--checkpoint-dir", str(resumed_dir)])
        resumed, r_launches = _drive_trainer(
            [*base, *extra, "--steps", "4", "--checkpoint-dir",
             str(resumed_dir)])
        seconds = _seconds_since(before)
        size = sum(f.stat().st_size for f in (resumed_dir / "4").iterdir())
        counts_ok = (
            s_launches == _want_launches(
                {k: BERT_LAYERS * 4 for k in FLASH_NAMES["flat"]})
            and r_launches == _want_launches(
                {k: BERT_LAYERS * 2 for k in FLASH_NAMES["flat"]}))
        steps_ok = ((straight["final_step"], straight["steps"]) == (4, 4)
                    and first["final_step"] == 2
                    and (resumed["final_step"], resumed["steps"]) == (4, 2))
        log(f"resume bert-base {manager}: straight loss "
            f"{straight['loss']:.6f} step_ms {straight['step_ms']}; resumed "
            f"final_step {resumed['final_step']} steps {resumed['steps']} "
            f"loss {resumed['loss']:.6f}; checkpoint "
            f"{size / 1e9:.3f} GB a step; snapshot and write seconds "
            f"(saves, total) {json.dumps(seconds)}; launches ok {counts_ok}")
        if not (counts_ok and steps_ok):
            raise AssertionError(f"BERT {manager} resume: wrong steps or "
                                 f"launch counts")
        runs[manager] = (straight, resumed,
                         _final_params(straight_dir, 4),
                         _final_params(resumed_dir, 4))
        costs[manager] = {k: v["s"] / max(v["saves"], 1)
                          for k, v in seconds.items()}
        costs[manager]["gb"] = size / 1e9
        torch.cuda.empty_cache()

    sync_params, async_params = runs["sync"][2], runs["async"][2]
    if sync_params.keys() != async_params.keys():
        raise AssertionError("the straight runs saved different parameters")
    spread = {k: max_abs(sync_params[k], async_params[k])
              for k in sync_params}
    loss_spread = abs(runs["sync"][0]["loss"] - runs["async"][0]["loss"])
    failed = []
    for manager, (straight, resumed, s_params, r_params) in runs.items():
        worst, worst_name, worst_err = -math.inf, "", 0.0
        for name, want in s_params.items():
            got = r_params[name]
            allowed = (RESUME_ATOL + RESUME_RTOL * want.double().abs()
                       + 2 * spread[name])
            excess = float(((got.double() - want.double()).abs()
                            - allowed).max())
            if excess > worst:
                worst, worst_name = excess, name
                worst_err = max_abs(got, want)
        loss_err = abs(resumed["loss"] - straight["loss"])
        loss_ok = loss_err <= (RESUME_RTOL * abs(straight["loss"])
                               + 2 * loss_spread)
        ok = worst <= 0 and loss_ok
        log(f"resume bert-base {manager} vs straight: loss |diff| "
            f"{loss_err:.3e} (straight-to-straight {loss_spread:.3e}); "
            f"params: worst leaf {worst_name} max |diff| {worst_err:.3e} "
            f"(its straight-to-straight {spread[worst_name]:.3e}; "
            f"largest straight-to-straight of any leaf "
            f"{max(spread.values()):.3e}); tolerance rtol {RESUME_RTOL} atol "
            f"{RESUME_ATOL} + 2 x straight-to-straight -> "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            failed.append(manager)
    if failed:
        raise AssertionError(f"resumed BERT runs {failed} diverge from the "
                             f"straight runs")
    return costs


def _eval_line(argv) -> dict:
    from mpi_operator_tpu_torch.cmd import eval as eval_cmd

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = eval_cmd.main(argv)
    if rc != 0:
        raise AssertionError(f"cmd.eval returned {rc}")
    return json.loads(buf.getvalue().strip().splitlines()[-1])


def run_eval_checks(tmp: Path) -> tuple[dict, dict]:
    """``cmd.eval`` on the card. (1) The command on a llama-tiny checkpoint
    the trainer wrote on the card: n_layers x batches launches of the
    flash forward and none of the backward kernels, its loss against the
    same command on the CPU. (2) ``evaluate()`` at llama3-8b width, 2
    layers, through the flat kernel against the dense route on the same
    weights, at the Llama model check's loss tolerance, after one untimed
    batch on each route. Returns (the llama3-8b flat run's launch counts,
    its line)."""
    import torch

    from mpi_operator_tpu_torch.cmd import eval as eval_cmd
    from mpi_operator_tpu_torch.data import TokenDataset
    from mpi_operator_tpu_torch.models import llama as lib

    ckpt = tmp / "tiny-ckpt"
    _drive_trainer(["--model", "llama-tiny", "--steps", "2", "--warmup", "1",
                    "--global-batch", "8", "--seq-len", "16", "--lr", "1e-3",
                    "--checkpoint-dir", str(ckpt), "--save-every", "1",
                    "--log-every", "1"])
    argv = ["--checkpoint-dir", str(ckpt), "--model", "llama-tiny", "--data",
            _token_file(tmp / "tiny.u32", 256, 16, 256, seed=3), "--batch",
            "4", "--batches", "3", "--seq-len", "16"]
    _reset_all_launch_counts()
    line = _eval_line(argv)
    launches = _all_launch_counts()
    cpu = _eval_line([*argv, "--device", "cpu"])
    want = _want_launches({"flash_fwd": 2 * 3})
    rel = abs(line["loss"] - cpu["loss"]) / abs(cpu["loss"])
    ok = (launches == want and line["step"] == 2 and line["batches"] == 3
          and line["tokens"] == 3 * 4 * 15 and math.isfinite(line["loss"])
          and rel <= TINY_EVAL_RTOL)
    log(f"eval llama-tiny (cmd.eval, card): {json.dumps(line)}; CPU "
        f"{json.dumps(cpu)}; loss rel {rel:.3e} (tol {TINY_EVAL_RTOL:.0e}); "
        f"launches {launches} (want {want}) -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("cmd.eval on the llama-tiny checkpoint failed")

    ds = TokenDataset(
        _token_file(tmp / "eval.u32", EVAL_BATCH * EVAL_BATCHES, EVAL_SEQ,
                    lib.llama3_8b().vocab_size, seed=4), EVAL_SEQ)
    results, state = {}, None
    for impl in ("flash", "dense"):
        model = lib.Llama(lib.llama3_8b(n_layers=2, attention_impl=impl),
                          device="cuda")
        if state is None:
            lib.init_params(model,
                            torch.Generator(device="cuda").manual_seed(0))
            state = {k: v.detach().clone()
                     for k, v in model.state_dict().items()}
        else:
            model.load_state_dict(state)
        # One untimed batch first: the logits' first allocation and the
        # GEMMs' first calls at these shapes stay out of tokens/s.
        eval_cmd.evaluate(model, ds, EVAL_BATCH, 1, torch.device("cuda"))
        torch.cuda.synchronize()
        _reset_all_launch_counts()
        t0 = time.perf_counter()
        mean, tokens = eval_cmd.evaluate(model, ds, EVAL_BATCH, EVAL_BATCHES,
                                         torch.device("cuda"))
        elapsed = time.perf_counter() - t0
        results[impl] = (mean, tokens, elapsed, _all_launch_counts())
        del model
    ds.close()
    del state
    torch.cuda.empty_cache()
    (lf, tokens, elapsed, launches), (ld, _, dense_s, dense_launches) = (
        results["flash"], results["dense"])
    rel = abs(lf - ld) / abs(ld)
    want = _want_launches({"flash_fwd": 2 * EVAL_BATCHES})
    ok = (math.isfinite(lf) and rel <= MODEL_LOSS_REL_TOL
          and launches == want and dense_launches == _want_launches({})
          and tokens == EVAL_BATCH * EVAL_BATCHES * (EVAL_SEQ - 1))
    line = {"loss": lf, "dense_loss": ld, "tokens": tokens,
            "tokens_per_sec": tokens / elapsed,
            "dense_tokens_per_sec": tokens / dense_s}
    log(f"eval llama3-8b/2 layers B={EVAL_BATCH} S={EVAL_SEQ} x "
        f"{EVAL_BATCHES} batches: flash loss {lf:.6f} dense {ld:.6f} rel "
        f"{rel:.3e} (tol {MODEL_LOSS_REL_TOL:.0e}); eval tokens/s "
        f"{line['tokens_per_sec']:.1f} (dense route "
        f"{line['dense_tokens_per_sec']:.1f}); launches {launches} (want "
        f"{want}) -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("llama3-8b eval failed its checks")
    return launches, line


# -- phase moe: Mixtral through the trainer -------------------------------

@contextlib.contextmanager
def _kept(train, box: list):
    """Each Workload that ``train.build_workload`` builds meanwhile is
    appended to ``box``, so that its model outlives ``train.main``."""
    real = train.build_workload

    def build(*a, **kw):
        work = real(*a, **kw)
        box.append(work)
        return work

    train.build_workload = build
    try:
        yield
    finally:
        train.build_workload = real


def _moe_flops_per_token(cfg, seq: int) -> float:
    """Routed training FLOPs a token (2 x MAC; forward + backward = 3 x
    the forward, PaLM's appendix): 6 x the matmul parameters one token
    passes through (attention, the router, top_k of the E experts' SwiGLU,
    the head) + 6 L d S for causal attention. GShard's dispatch and
    combine products, the remat recompute and the slots left empty by
    dropped choices are not counted."""
    hd = cfg.head_dim
    attn = (cfg.dim * (cfg.n_heads + 2 * cfg.n_kv_heads) * hd
            + cfg.n_heads * hd * cfg.dim)
    routed = (cfg.moe_top_k * 3 * cfg.dim * cfg.ffn_dim
              + cfg.dim * cfg.n_experts)
    n = cfg.n_layers * (attn + routed) + cfg.dim * cfg.vocab_size
    return 6 * n + 6 * cfg.n_layers * cfg.dim * seq


def _routing_stats(model, tokens) -> list:
    """Per MoE layer, with ``tokens`` through ``model`` (no autograd): the
    Switch aux loss (1.0 at perfect balance) and the share of (token,
    choice) pairs dropped at the expert capacity."""
    import torch

    from mpi_operator_tpu_torch.models import moe

    stats = []

    def probe(module, inputs, _out):
        (h,) = inputs
        g, s, _ = h.shape
        cap = moe.expert_capacity(s, module.n_experts, module.top_k,
                                  module.capacity_factor)
        probs = torch.softmax(h.float() @ module.router, dim=-1)
        dispatch, _, aux = moe.routing(probs, module.top_k, cap)
        stats.append({"aux": float(aux), "dropped_share": 1 - float(
            dispatch.sum()) / (module.top_k * g * s), "capacity": cap})

    hooks = [m.register_forward_hook(probe) for m in model.modules()
             if isinstance(m, moe.MoEMLP)]
    try:
        with torch.no_grad():
            model(tokens)
    finally:
        for hook in hooks:
            hook.remove()
    return stats


def run_moe_train():
    """Phase ``moe``: first the router's aux loss and dropped share a
    layer at the trainer's init (the same seed and batch, its own
    forward); then ``cmd.train.main`` on mixtral-8x7b at full width,
    depth 2 (MOE_TRAIN_ARGS), with every launch counter set to 0 just
    before it and read just after. Then, outside that count, on the run's
    own workload: the aux loss and dropped share after its steps, the
    AdamW update alone (CUDA events) and a torch.profiler pass over two
    more steps. Returns (summary, launch counts, the trained model
    without gradients or optimizer state)."""
    import gc

    import numpy as np
    import torch

    from mpi_operator_tpu_torch.cmd import train
    from mpi_operator_tpu_torch.models import llama as lib

    cfg = lib.mixtral_8x7b(n_layers=MOE_LAYERS, xent_chunk=1024)
    args = train.build_parser().parse_args(MOE_TRAIN_ARGS)
    model = lib.Llama(cfg, device="cuda")
    lib.init_params(model, torch.Generator(device="cuda").manual_seed(
        args.seed))
    tokens = torch.as_tensor(np.random.RandomState(args.seed).randint(
        0, cfg.vocab_size, (args.global_batch, args.seq_len)), device="cuda")
    at_init = _routing_stats(model, tokens)
    del model
    torch.cuda.empty_cache()
    box = []
    with _kept(train, box):
        summary, launches = _drive_trainer(MOE_TRAIN_ARGS)
    work = box.pop()
    summary["parameters"] = sum(p.numel() for p in work.model.parameters())
    summary["mfu_bf16_peak_routed"] = (
        summary["tokens_per_sec"] * _moe_flops_per_token(cfg, args.seq_len)
        / PEAK_FLOPS["bf16"])
    same_batch = torch.equal(work.batch[0], tokens)
    stats = _routing_stats(work.model, work.batch[0])
    work.optimizer.zero_grad(set_to_none=False)
    adamw_ms = time_ms(work.optimizer.step, 1, 3)
    busy, wall, kinds, kernels = _profile_steps(
        lambda: work.step_fn(*work.batch), _llama_kind)
    summary["routing_at_init"] = at_init
    summary["routing_after_steps"] = stats
    log("moe mixtral-8x7b/2 layers summary: " + json.dumps(summary))
    log("moe profile: " + json.dumps({
        "adamw_step_ms": adamw_ms, "profiled_wall_ms_per_step": wall,
        "device_busy_ms_per_step": busy,
        "device_idle_share": 1 - busy / wall,
        "device_ms_per_step_by_kind": kinds}))
    for ms, name in kernels[:10]:
        log(f"moe profile kernel {ms:9.3f} ms/step  {name}")
    steps = summary["steps"]
    want = _want_launches({"flash_fwd": 2 * MOE_LAYERS * steps,
                           "flash_bwd_dq": MOE_LAYERS * steps,
                           "flash_bwd_dkv": MOE_LAYERS * steps})
    ok = (steps == 6 and math.isfinite(summary["loss"])
          and summary["loss"] < summary["first_loss"] and launches == want
          and work.model.config == cfg and same_batch
          and len(stats) == len(at_init) == MOE_LAYERS
          and all(math.isfinite(st["aux"]) for st in stats + at_init))
    log(f"moe launches {launches} (want {want}); loss "
        f"{summary['first_loss']:.4f} -> {summary['loss']:.4f}; tokens/s "
        f"{summary['tokens_per_sec']} step_ms {summary['step_ms']} routed "
        f"MFU {summary['mfu_bf16_peak_routed']:.4f}; aux a layer at init "
        f"{[round(st['aux'], 4) for st in at_init]}, after the steps "
        f"{[round(st['aux'], 4) for st in stats]} (1.0 at balance); "
        f"dropped at init {[round(st['dropped_share'], 4) for st in at_init]}"
        f", after {[round(st['dropped_share'], 4) for st in stats]}; peak "
        f"{summary['peak_mem_gb']:.2f} GB -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("MoE training run failed its checks")
    model = work.model
    for p in model.parameters():
        p.grad = None
    del work, box
    gc.collect()
    torch.cuda.empty_cache()
    return summary, launches, model


# -- phase decode: KV-cache decoding --------------------------------------

def _decode_llama(label: str, model, prompt, max_new: int) -> dict:
    """``generate()`` on ``model`` (greedy, the weights cast once), with
    the launch counters read around it; its ms a step (every step is one
    token through the model against the cache), new tokens/s and the
    device's idle share (one step eagerly against its CUDA-graph replay,
    at the last position); then the teacher-forced decode logits of the
    prompt against the training forward of the same tokens (its flash
    forward launches counted apart). An MoE model's forward runs with
    every expert's capacity raised to the whole group, so that it drops
    nothing: decode routes every token alone, with no capacity. Returns
    the record, with both launch counts."""
    import torch

    from mpi_operator_tpu_torch.models import generate as gen
    from mpi_operator_tpu_torch.models import moe

    cfg = model.config
    b, s0 = prompt.shape
    n_params = sum(p.numel() for p in model.parameters())
    bound_ms = 2 * n_params / PEAK_BYTES_PER_S * 1e3
    log(f"decode {label}: B={b}, prompt {s0}, {max_new} new, greedy; "
        f"weights-read bound {2 * n_params / 1e9:.2f} GB of bf16 at "
        f"{PEAK_BYTES_PER_S / 1e12:.2f} TB/s = {bound_ms:.3f} ms a step")
    weights = gen.decode_weights(model)
    gen.generate(model, prompt[:, :2], max_new=2, weights=weights)  # warm
    torch.cuda.synchronize()
    _reset_all_launch_counts()
    t0 = time.perf_counter()
    out = gen.generate(model, prompt, max_new=max_new, weights=weights)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    gen_launches = _all_launch_counts()
    step_ms = wall * 1e3 / (s0 + max_new - 1)

    dec = gen.Decoder(model, b, s0 + max_new, weights)
    token = prompt[:, 0].clone()
    pos = s0 + max_new - 1
    with torch.no_grad():
        eager_ms = time_ms(lambda: dec.step(token, pos), 2, 10)
        graph = _captured(lambda: dec.step(token, pos))
    replay_ms = time_ms(graph.replay, 2, 10)
    del graph, dec

    tf = gen.decode_logits_teacher_forced(model, prompt, weights)
    del weights
    moes = [m for m in model.modules() if isinstance(m, moe.MoEMLP)]
    factors = [m.capacity_factor for m in moes]
    for m in moes:
        m.capacity_factor = float(m.n_experts)  # C = top_k x S: no drops
    _reset_all_launch_counts()
    with torch.no_grad():
        fwd = model(prompt)
    fwd_launches = _all_launch_counts()
    for m, f in zip(moes, factors):
        m.capacity_factor = f
    fwd = fwd[0] if cfg.is_moe else fwd
    rel = norm_rel(tf, fwd)
    agree = float((tf.argmax(-1) == fwd.argmax(-1)).float().mean())
    del tf, fwd
    torch.cuda.empty_cache()
    rec = {"ms_per_step": step_ms, "new_tokens_per_s": b * 1e3 / step_ms,
           "generate_s": wall, "bound_ms_per_step": bound_ms,
           "eager_step_ms": eager_ms, "graph_replay_step_ms": replay_ms,
           "device_idle_share": 1 - replay_ms / eager_ms,
           "teacher_forced_norm_rel": rel, "argmax_agreement": agree,
           "launches": {"generate": gen_launches, "forward": fwd_launches}}
    want_fwd = _want_launches({"flash_fwd": cfg.n_layers})
    ok = (out.shape == (b, s0 + max_new) and torch.equal(out[:, :s0], prompt)
          and int(out.min()) >= 0 and int(out.max()) < cfg.vocab_size
          and rel <= DECODE_LOGITS_TOL and gen_launches == _want_launches({})
          and fwd_launches == want_fwd)
    log(f"decode {label}: " + json.dumps(rec))
    log(f"decode {label}: {step_ms:.3f} ms a step ({rec['new_tokens_per_s']:.1f}"
        f" new tokens/s; bound {bound_ms:.3f} ms), idle "
        f"{rec['device_idle_share']:.3f}; teacher-forced logits vs the "
        f"forward norm-rel {rel:.3e} (tol {DECODE_LOGITS_TOL:.0e}), argmax "
        f"agreement {agree:.4f}; launches generate {gen_launches}, forward "
        f"{fwd_launches} (want {want_fwd}) -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"decode {label} failed its checks")
    return rec


def _decode_s2s() -> dict:
    """seq2seq-small (t5-small's shape) from seeded parameters: greedy
    ``generate()`` (the encoder once, then one step a token), and the
    teacher-forced decode logits of the generated tokens against the
    training forward of the same pair (flat flash forward, counted)."""
    import numpy as np
    import torch

    from mpi_operator_tpu_torch.models import seq2seq as s2s
    from mpi_operator_tpu_torch.models import seq2seq_generate as gen

    cfg = s2s.t5_small_shape()
    model = s2s.Seq2Seq(cfg, device="cuda")
    s2s.init_params(model, torch.Generator(device="cuda").manual_seed(0))
    model.eval()
    src = torch.as_tensor(np.random.RandomState(6).randint(
        1, cfg.vocab_size, (S2S_DECODE_BATCH, S2S_DECODE_SRC)),
        device="cuda")
    gen.generate(model, src[:, :8], 2)  # warm
    encode_ms = time_ms(lambda: gen.encode(model, src), 1, 3)
    torch.cuda.synchronize()
    _reset_all_launch_counts()
    t0 = time.perf_counter()
    out = gen.generate(model, src, S2S_DECODE_NEW)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    gen_launches = _all_launch_counts()
    step_ms = (wall * 1e3 - encode_ms) / S2S_DECODE_NEW
    dec_in = torch.cat([torch.zeros_like(out[:, :1]), out[:, :-1]], dim=1)
    tf = gen.decode_logits_teacher_forced(model, src, dec_in)
    _reset_all_launch_counts()
    with torch.no_grad():
        fwd = model(src, dec_in)
    fwd_launches = _all_launch_counts()
    rel = norm_rel(tf, fwd)
    agree = float((fwd.argmax(-1) == out).float().mean())
    calls = cfg.n_enc_layers + 2 * cfg.n_dec_layers
    want_fwd = _want_launches({"flash_fwd": calls})
    rec = {"generate_s": wall, "encode_ms": encode_ms,
           "ms_per_step": step_ms,
           "new_tokens_per_s": S2S_DECODE_BATCH * 1e3 / step_ms,
           "teacher_forced_norm_rel": rel,
           "forward_argmax_equals_generated": agree,
           "launches": {"generate": gen_launches, "forward": fwd_launches}}
    ok = (out.shape == (S2S_DECODE_BATCH, S2S_DECODE_NEW)
          and rel <= DECODE_LOGITS_TOL and gen_launches == _want_launches({})
          and fwd_launches == want_fwd)
    log("decode seq2seq-small: " + json.dumps(rec))
    log(f"decode seq2seq-small B={S2S_DECODE_BATCH} src {S2S_DECODE_SRC}, "
        f"{S2S_DECODE_NEW} new: encode {encode_ms:.3f} ms, {step_ms:.3f} ms "
        f"a step; teacher-forced logits vs the forward norm-rel {rel:.3e} "
        f"(tol {DECODE_LOGITS_TOL:.0e}), the forward's argmax = the "
        f"generated token at {agree:.4f}; launches generate {gen_launches}, "
        f"forward {fwd_launches} (want {want_fwd}) -> "
        f"{'ok' if ok else 'FAIL'}")
    del model, tf, fwd
    torch.cuda.empty_cache()
    if not ok:
        raise AssertionError("seq2seq decode failed its checks")
    return rec


def _generate_lines(argv) -> list:
    from mpi_operator_tpu_torch.cmd import generate as gen_cmd

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = gen_cmd.main(argv)
    if rc != 0:
        raise AssertionError(f"cmd.generate returned {rc}")
    return [json.loads(line) for line in buf.getvalue().splitlines()
            if line.startswith("{")]


def _decode_cli(tmp: Path) -> dict:
    """``python -m mpi_operator_tpu_torch.cmd.generate`` end to end on the
    card: llama-tiny and llama-moe-tiny checkpoints the trainer writes
    here (2 steps), two prompts of 3 tokens, 8 new; the tokens equal the
    same command's on the CPU (f32 both; only the order of sums differs)
    and the command launches no kernel."""
    out = {}
    for name in ("llama-tiny", "llama-moe-tiny"):
        ck = tmp / f"gen-{name}"
        _drive_trainer(["--model", name, "--steps", "2", "--warmup", "1",
                        "--global-batch", "8", "--seq-len", "16", "--lr",
                        "1e-3", "--checkpoint-dir", str(ck), "--save-every",
                        "1", "--log-every", "1"])
        argv = ["--checkpoint-dir", str(ck), "--model", name, "--prompt",
                "12,7,42", "--prompt", "3,9,27", "--max-new", "8"]
        cmd = [sys.executable, "-m", "mpi_operator_tpu_torch.cmd.generate",
               *argv]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=300, cwd=str(Path(__file__).parent))
        wall = time.perf_counter() - t0
        if proc.returncode != 0:
            raise AssertionError(f"{cmd} exited {proc.returncode}:\n"
                                 f"{proc.stderr[-4000:]}")
        card = [json.loads(line) for line in proc.stdout.splitlines()
                if line.startswith("{")]
        _reset_all_launch_counts()
        inproc = _generate_lines(argv)
        launches = _all_launch_counts()
        cpu = _generate_lines([*argv, "--device", "cpu"])
        ok = (len(card) == 2 and card == inproc
              and [line["tokens"] for line in card]
              == [line["tokens"] for line in cpu]
              and all(line["step"] == 2 and len(line["new"]) == 8
                      and line["tokens"][:3] == line["prompt"]
                      for line in card)
              and launches == _want_launches({}))
        log(f"decode cmd.generate {name} ({wall:.1f} s as a process): "
            f"{json.dumps(card)}; CPU tokens "
            f"{[line['tokens'] for line in cpu]}; launches {launches} -> "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"cmd.generate on {name} failed its checks")
        out[f"cmd.generate {name}"] = launches
    return out


def run_decode(tmp: Path, moe_model=None) -> dict:
    """Phase ``decode``: (a) llama3-8b at full width and depth from seeded
    parameters; (b) Mixtral (the moe phase's trained 2-layer model, or a
    seeded one without that phase); (c) seq2seq-small; (d) cmd.generate
    end to end. Returns each path's launch counts."""
    import gc

    import numpy as np
    import torch

    from mpi_operator_tpu_torch.models import llama as lib

    def prompt(vocab: int, seed: int):
        return torch.as_tensor(np.random.RandomState(seed).randint(
            0, vocab, (DECODE_BATCH, DECODE_PROMPT)), device="cuda")

    paths = {}
    model = lib.Llama(lib.llama3_8b(), device="cuda")
    lib.init_params(model, torch.Generator(device="cuda").manual_seed(0))
    model.eval()
    rec = _decode_llama("llama3-8b", model, prompt(model.config.vocab_size, 5),
                        DECODE_NEW)
    paths.update({f"{k} llama3-8b": c for k, c in rec["launches"].items()})
    del model
    gc.collect()
    torch.cuda.empty_cache()

    if moe_model is None:
        moe_model = lib.Llama(lib.mixtral_8x7b(n_layers=MOE_LAYERS),
                              device="cuda")
        lib.init_params(moe_model,
                        torch.Generator(device="cuda").manual_seed(0))
    moe_model.eval()
    rec = _decode_llama(f"mixtral-8x7b/{MOE_LAYERS} layers", moe_model,
                        prompt(moe_model.config.vocab_size, 7), DECODE_NEW)
    paths.update({f"{k} mixtral-8x7b": c for k, c in rec["launches"].items()})
    del moe_model
    gc.collect()
    torch.cuda.empty_cache()

    rec = _decode_s2s()
    paths.update({f"{k} seq2seq-small": c
                  for k, c in rec["launches"].items()})
    paths.update(_decode_cli(tmp))
    return paths


def ab_data_step(blocks: int = 4, steps: int = 10) -> None:
    """Opt-in phase ``data``: each of the Llama and BERT-base trainer runs
    without and with ``--data``, in the order S D D S repeated ``blocks``
    times in this one call, ``steps`` steps each (the first two untimed).
    Prints every run's step_ms, each side's median and the synthetic
    side's quartile spread; checks nothing beyond the trainer's own
    launch counts."""
    import statistics

    from mpi_operator_tpu_torch.models import bert
    from mpi_operator_tpu_torch.models import llama as lib

    arms = {
        "llama3-8b": (TRAIN_ARGS, 2048, lib.llama3_8b().vocab_size, 2),
        "bert-base": (BERT_TRAIN_ARGS, 512, bert.bert_base().vocab_size, 64),
    }
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        for label, (argv, seq, vocab, batch) in arms.items():
            data = _token_file(Path(tmp) / f"{label}.u32", 4 * batch + 1,
                               seq, vocab, seed=5)
            times = {"synthetic": [], "data": []}
            for side in ["synthetic", "data", "data", "synthetic"] * blocks:
                extra = ["--data", data] if side == "data" else []
                summary, _ = _drive_trainer([*argv, *extra, "--steps",
                                             str(steps)])
                times[side].append(summary["step_ms"])
            quart = statistics.quantiles(times["synthetic"], n=4)
            med = {k: statistics.median(v) for k, v in times.items()}
            log(f"data A/B {label} ({blocks} x S D D S, {steps} steps, "
                f"{steps - 2} timed): step_ms synthetic {times['synthetic']} "
                f"data {times['data']}; medians {med['synthetic']:.2f} / "
                f"{med['data']:.2f} ({(med['data'] / med['synthetic'] - 1):+.2%})"
                f"; synthetic quartiles {quart[0]:.2f}-{quart[2]:.2f}")


def profile_bert_step() -> None:
    """Where one BERT-base training step's time goes (opt-in phase
    ``profile``), at the ``train`` shape on the trainer's own workload
    (flat route) and on the flash-bhsd route: the eager step by CUDA
    events; its device time as a CUDA-graph replay of the forward and
    backward plus the AdamW update timed alone; a profiler pass over
    graph replays for device time by kind; and the attention kernels'
    share. Before that, the MLM head's forward and backward alone."""
    import torch
    import torch.nn.functional as F

    from mpi_operator_tpu_torch.cmd import train
    from mpi_operator_tpu_torch.models import bert as lib
    from mpi_operator_tpu_torch.ops.losses import f32_logits
    from mpi_operator_tpu_torch.parallel.mesh import create_mesh

    work = train._lm_workload(train.build_parser().parse_args(BERT_TRAIN_ARGS),
                              create_mesh(device="cuda", dp=-1), 1)
    routes = {"flash": (work.model, work.step_fn, work.batch,
                        work.optimizer)}
    model, step, batch = _bert_bhsd_workload()
    routes["flash-bhsd"] = (model, step, batch, None)
    # The MLM head alone at the train shape (64 x 76 gathered positions
    # against the tied [30522, 768] table): the table's bf16 cast, the head
    # product, the cross-entropy and their backward.
    table = work.model.tok_embed.weight
    h = torch.randn(64, 76, 768, device="cuda", dtype=torch.bfloat16,
                    requires_grad=True)
    targets = work.batch[2].reshape(-1)

    def head():
        logits = f32_logits(h, table.to(torch.bfloat16).t())
        F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                        targets).backward()

    log("profile bert-base mlm head: " + json.dumps(
        {"mlm_head_fwd_bwd_ms": time_ms(head, 2, 5)}))
    del h
    for route, (model, step, batch, optimizer) in routes.items():
        step_ms = time_ms(lambda: step(*batch), 2, 5)

        def fwd_bwd():
            model.zero_grad(set_to_none=True)
            lib.mlm_loss_positions(model, *batch).backward()

        graph = _captured(fwd_bwd)
        device_ms = {"fwd_bwd": time_ms(graph.replay, 2, 5)}
        if optimizer is not None:
            device_ms["adamw_eager"] = time_ms(optimizer.step, 1, 3)
        busy, _, kinds, kernels = _profile_steps(graph.replay, _llama_kind, 2)
        log(f"profile bert-base {route}: " + json.dumps({
            "step_ms": step_ms, "device_ms_per_step": device_ms,
            "device_idle_share_fwd_bwd": 1 - device_ms["fwd_bwd"] / step_ms,
            "profiler_ms_per_fwd_bwd_by_kind": kinds,
            "profiler_coverage": busy / device_ms["fwd_bwd"],
        }))
        for ms, name in kernels[:10]:
            log(f"profile bert-base {route} kernel {ms:9.3f} ms/step  {name}")
        del graph
    del work, routes, model, step, batch
    torch.cuda.empty_cache()


def profile_step() -> None:
    """Where one training step's time goes (opt-in phase ``profile``):
    the trainer's own workload at the ``train`` shape; CUDA-event times of
    the chunked LM head (forward + backward) and of the AdamW update
    alone, and a torch.profiler pass over two steps for device kernel
    time by kind and the device's busy share of the wall time."""
    import torch

    from mpi_operator_tpu_torch.cmd import train
    from mpi_operator_tpu_torch.ops.losses import lm_xent_chunked
    from mpi_operator_tpu_torch.parallel.mesh import create_mesh

    args = train.build_parser().parse_args(TRAIN_ARGS)
    work = train._lm_workload(args, create_mesh(device="cuda", dp=-1), 1)
    tokens = work.batch[0]
    step_ms = time_ms(lambda: work.step_fn(tokens), 2, 5)

    model = work.model
    h = torch.randn(2, 2047, 4096, device="cuda", dtype=torch.bfloat16,
                    requires_grad=True)

    def head():
        loss = lm_xent_chunked(h, model.head_kernel(), tokens[:, 1:],
                               chunk=args.xent_chunk)
        loss.backward()

    head_ms = time_ms(head, 1, 3)
    work.optimizer.zero_grad(set_to_none=False)
    adamw_ms = time_ms(work.optimizer.step, 1, 3)

    busy, wall, kinds, kernels = _profile_steps(
        lambda: work.step_fn(tokens), _llama_kind)
    log("profile: " + json.dumps({
        "step_ms": step_ms, "lm_head_fwd_bwd_ms": head_ms,
        "adamw_step_ms": adamw_ms,
        "profiled_wall_ms_per_step": wall,
        "device_busy_ms_per_step": busy,
        "device_idle_share": 1 - busy / wall,
        "device_ms_per_step_by_kind": kinds,
    }))
    for ms, name in kernels[:12]:
        log(f"profile kernel {ms:9.3f} ms/step  {name}")
    del work, model, h
    torch.cuda.empty_cache()


def _llama_kind(name: str) -> str:
    """A kernel's kind by name: the flash kernels, GEMMs (bf16 operands;
    f32 x f32 ones apart), AdamW, the rest."""
    low = name.lower()
    gemm = any(s in low for s in ("gemm", "nvjet", "xmma", "cutlass"))
    return ("flash" if "flash::" in name else
            "gemm" if gemm and "bf16" in low else
            "gemm_f32" if "f32f32" in name or "sgemm" in name else
            "gemm" if gemm else
            "adamw" if "multi_tensor_apply" in name else "other")


def profile_flat_train_step(label: str, argv, loss_fn) -> None:
    """Where one training step's time goes for a model on the flat flash
    kernels (ViT, seq2seq; opt-in phase ``profile``), on the trainer's own
    workload at the ``train`` shape: the eager step by CUDA events; its
    device time as a CUDA-graph replay of the forward and backward
    (``loss_fn(model, *batch)``) plus the AdamW update timed alone, which
    gives the idle share; and a torch.profiler pass over two eager steps
    for device time by kind (with its coverage of the replay's time)."""
    import torch

    from mpi_operator_tpu_torch.cmd import train
    from mpi_operator_tpu_torch.parallel.mesh import create_mesh

    work = train.build_workload(train.build_parser().parse_args(argv),
                                create_mesh(device="cuda", dp=-1), 1)
    step_ms = time_ms(lambda: work.step_fn(*work.batch), 2, 5)

    def fwd_bwd():
        work.model.zero_grad(set_to_none=True)
        loss_fn(work.model, *work.batch).backward()

    graph = _captured(fwd_bwd)
    device_ms = {"fwd_bwd": time_ms(graph.replay, 2, 5),
                 "adamw_eager": time_ms(work.optimizer.step, 1, 3)}
    del graph
    busy, wall, kinds, kernels = _profile_steps(
        lambda: work.step_fn(*work.batch), _llama_kind)
    log(f"profile {label}: " + json.dumps({
        "step_ms": step_ms, "device_ms_per_step": device_ms,
        "device_idle_share": 1 - sum(device_ms.values()) / step_ms,
        "profiled_wall_ms_per_step": wall,
        "profiler_device_ms_per_step": busy,
        "profiler_coverage": busy / sum(device_ms.values()),
        "profiler_device_ms_per_step_by_kind": kinds,
    }))
    for ms, name in kernels[:10]:
        log(f"profile {label} kernel {ms:9.3f} ms/step  {name}")
    del work
    torch.cuda.empty_cache()


def _resnet_kind(name: str) -> str:
    low = name.lower()
    return ("bn_kernels" if "bn::" in name else
            "conv_gemm" if any(s in low for s in (
                "conv", "gemm", "nvjet", "xmma", "cutlass", "cudnn", "sm90_",
                "sm80_", "dgrad", "wgrad", "fprop", "implicit")) else
            "optimizer" if "multi_tensor_apply" in name else
            "reduce" if "reduce" in low else
            "elementwise" if any(s in low for s in (
                "elementwise", "vectorized", "unrolled", "copy", "pool",
                "fill")) else "other")


def _profile_steps(step, classify, steps: int = 2):
    """torch.profiler over ``steps`` calls of ``step``: (device busy ms
    per step, wall ms per step, device ms per step by kind, the kernels
    as (ms per step, name), largest first)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kinds: dict = {}
    kernels = []
    for evt in prof.key_averages():
        # Device kernels only: user annotations (Optimizer.step#...) are
        # mirrored onto the device timeline as ranges over kernels.
        if (evt.device_type != torch.autograd.DeviceType.CUDA
                or getattr(evt, "is_user_annotation", False)
                or "#" in evt.key):
            continue
        ms = evt.self_device_time_total / 1e3 / steps
        kind = classify(evt.key)
        kinds[kind] = kinds.get(kind, 0.0) + ms
        kernels.append((ms, evt.key[:90]))
    return (sum(kinds.values()), wall_ms / steps, kinds,
            sorted(kernels, reverse=True))


def _captured(fn, warmup: int = 3):
    """``fn`` captured into a CUDA graph, after ``warmup`` calls on a side
    stream as capture requires. A replay runs the same kernels with no
    host work between them, so its CUDA-event time is device time."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(warmup):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return graph


def profile_resnet_step() -> None:
    """Where one ResNet-101 training step's time goes (opt-in phase
    ``profile``), at the ``train`` shape (B=64, 224x224, --bn-kernel
    pallas) on the trainer's own workload.

    The eager step is timed with CUDA events, beside the plain BN route's.
    Device time comes from CUDA-graph replays, which leave out the host's
    launch gaps: the whole step, then its parts (the forward alone, the
    optimizer update alone, the 104 BN layers' forward and backward at
    the step's shapes, and the BN kernels alone at those shapes). The
    idle share is 1 - step device time / eager step time. A profiler
    pass over step replays gives kernel time by kind, with its coverage
    (the profiler's device total over the replay's CUDA-event time)."""
    import torch

    from mpi_operator_tpu_torch.cmd import train
    from mpi_operator_tpu_torch.models import resnet as lib
    from mpi_operator_tpu_torch.ops import bn
    from mpi_operator_tpu_torch.parallel.mesh import create_mesh

    mesh = create_mesh(device="cuda", dp=-1)
    args = train.build_parser().parse_args(
        [*RESNET_TRAIN_ARGS, "--bn-kernel", "xla"])
    work = train._resnet_workload(args, mesh, 1)
    plain_step_ms = time_ms(lambda: work.step_fn(*work.batch), 2, 5)
    del work
    # One bn_stats call on a small layer's operand (stage 3 at B=8: a few
    # microseconds of device work), so this is the host's cost of a call.
    x = torch.randn(392, 512, device="cuda", dtype=torch.bfloat16)
    call_us = time_ms(lambda: bn.bn_stats(x), 10, 200) * 1e3

    work = train._resnet_workload(
        train.build_parser().parse_args(RESNET_TRAIN_ARGS), mesh, 1)
    model, (images, labels) = work.model, work.batch
    step_ms = time_ms(lambda: work.step_fn(images, labels), 2, 5)
    shapes = []
    hooks = [m.register_forward_pre_hook(
        lambda _m, a: shapes.append(tuple(a[0].shape)))
        for m in lib.bn_layers(model)]
    work.step_fn(images, labels)
    for h in hooks:
        h.remove()

    step_graph = _captured(lambda: work.step_fn(images, labels))
    device_ms = {"step": time_ms(step_graph.replay, 2, 10)}
    busy, _, kinds, kernels = _profile_steps(step_graph.replay,
                                             _resnet_kind, 3)
    with torch.no_grad():
        graph = _captured(lambda: lib.loss_fn(model, images, labels))
    device_ms["forward"] = time_ms(graph.replay, 2, 10)
    graph = _captured(work.optimizer.step)
    device_ms["optimizer"] = time_ms(graph.replay, 2, 10)
    del graph, step_graph, work, model
    torch.cuda.empty_cache()

    # The BN layers at the step's shapes, on random bf16 activations.
    gen = torch.Generator(device="cuda").manual_seed(3)
    layers = []
    for n, c, h, w in shapes:
        xs = torch.randn(n, c, h, w, generator=gen, device="cuda").to(
            torch.bfloat16).to(memory_format=torch.channels_last)
        layers.append((bn.TpuBatchNorm(c, device="cuda"),
                       xs.requires_grad_(), torch.randn_like(xs)))

    def bn_layers_fwd_bwd():
        for layer, xs, dys in layers:
            torch.autograd.grad(layer(xs), (xs,), dys)

    operands = []
    for _, xs, dys in layers:
        x2d = xs.detach().movedim(1, -1).reshape(-1, xs.shape[1])
        mean = x2d.float().mean(0)
        inv = torch.rsqrt(x2d.float().var(0, unbiased=False) + 1e-5)
        operands.append((x2d, dys.movedim(1, -1).reshape(x2d.shape),
                         mean, inv))

    def bn_kernels():
        for x2d, dy2d, mean, inv in operands:
            bn.bn_stats(x2d)
            bn.bn_grads(dy2d, x2d, mean, inv)

    for name, fn in (("bn_layers_fwd_bwd", bn_layers_fwd_bwd),
                     ("bn_kernels", bn_kernels)):
        graph = _captured(fn)
        device_ms[name] = time_ms(graph.replay, 2, 10)
        del graph
    del layers, operands
    device_ms["bn_elementwise"] = (device_ms["bn_layers_fwd_bwd"]
                                   - device_ms["bn_kernels"])
    # The two kernels' bound over the step: x read by stats, dy and x by
    # grads (bf16), and six f32 [C] vectors (two out of stats; mean and
    # inv in, two out of grads).
    elems = sum(n * c * h * w for n, c, h, w in shapes)
    channels = sum(c for _, c, _, _ in shapes)
    bn_bound_ms = (3 * elems * 2 + 6 * channels * 4) / PEAK_BYTES_PER_S * 1e3
    device_ms["rest_convs_head_relu_add_pool"] = (
        device_ms["step"] - device_ms["bn_layers_fwd_bwd"]
        - device_ms["optimizer"])
    log("profile resnet101: " + json.dumps({
        "step_ms": step_ms, "plain_bn_route_step_ms": plain_step_ms,
        "bn_stats_call_us_small_layer": call_us,
        "bn_layers": len(shapes), "bn_activation_elements": elems,
        "bn_kernels_bound_ms": bn_bound_ms,
        "device_ms_per_step": device_ms,
        "device_idle_share": 1 - device_ms["step"] / step_ms,
        "profiler_ms_per_step_by_kind": kinds,
        "profiler_coverage": busy / device_ms["step"],
    }))
    for ms, name in kernels[:15]:
        log(f"profile resnet101 kernel {ms:9.3f} ms/step  {name}")
    torch.cuda.empty_cache()



# -- world: the port across processes on the one card --------------------

# Two processes share the card (NCCL refuses two ranks on one GPU), so
# the gang's default process group is gloo, which stages each collective
# through the host: its step times measure gloo on one card, not the
# port on a multi-GPU node.
WORLD_PROCESSES = 2
WORLD_ARGS = BERT_TRAIN_ARGS + ["--mesh", "dp=2"]
# The mesh runs that gloo carries on CUDA tensors (FSDP2 and the DTensor
# tensor-parallel plan), three steps each.
WORLD_MESH_STEPS = 3
# A loss of the dp=2 curve against the one-process curve of the same
# call: bf16 keeps 8 significant bits (3.9e-3 a rounding); the loss
# averages 64 x 76 predictions, and the runs differ only in the GEMMs'
# row counts and the order of the gradient sums. 2e-3 is half a bf16
# rounding at the loss.
WORLD_LOSS_RTOL = 2e-3
WORLD_TIMEOUT_S = 600
# Mixtral-8x7B with --mesh ep=2 on the two processes, depth 1 (16.1 GB of
# f32 state a rank: the 262 M embedding and head and 42 M of attention
# whole, 4 of the 8 experts' 1.41 G), B=2, S=2048, 3 steps, against one
# process; held at WORLD_LOSS_RTOL. The ranks differ from one process in
# two sums only: the experts' partial outputs, added in f32 across the
# ranks, and the tokens' gradient from the experts, whose two bf16 parts
# are added across the ranks where one process rounds the whole once.
MOE_WORLD_ARGS = [
    "--model", "mixtral-8x7b", "--n-layers", "1", "--seq-len", "2048",
    "--global-batch", "2", "--xent-chunk", "1024", "--steps", "3",
    "--warmup", "1", "--lr", "3e-4", "--log-every", "1",
]


@contextlib.contextmanager
def _recorded(train, curve: list, sigterm_after: int = 0):
    """Each step's (local) loss appended to ``curve``; with
    ``sigterm_after``, SIGTERM this process after that many steps, as a
    kubelet preempting its pod."""
    import signal

    real = train.build_workload

    def build(*a, **kw):
        work = real(*a, **kw)
        step_fn = work.step_fn

        def step(*batch):
            loss = step_fn(*batch)
            curve.append(loss.detach().clone())
            if len(curve) == sigterm_after:
                signal.raise_signal(signal.SIGTERM)
            return loss

        work.step_fn = step
        return work

    train.build_workload = build
    try:
        yield
    finally:
        train.build_workload = real


def _expert_shapes(model) -> list:
    """The shape of each MoE layer's ``expert_wg`` on this process (its
    local shard when the experts are sharded over ep)."""
    return [list((p.to_local() if hasattr(p, "to_local") else p).shape)
            for name, p in model.named_parameters()
            if name.endswith("moe.expert_wg")]


def _world_job(job: dict) -> dict:
    """One ``cmd.train`` or ``cmd.eval`` call in this process, with every
    launch counter set to 0 just before it and read just after; returns
    its last JSON line (None when it printed none), the counts, the curve
    of its local losses and the trained model's local expert shapes."""
    import gc

    import torch

    from mpi_operator_tpu_torch.cmd import eval as eval_cmd
    from mpi_operator_tpu_torch.cmd import train

    entry = eval_cmd.main if job.get("cmd") == "eval" else train.main
    curve, buf, works = [], io.StringIO(), []
    _reset_all_launch_counts()
    with _recorded(train, curve, job.get("sigterm_after", 0)), \
            _kept(train, works), contextlib.redirect_stdout(buf):
        rc = entry(job["argv"])
    launches = _all_launch_counts()
    if rc != 0:
        raise AssertionError(f"{job['argv']} returned {rc}")
    experts = [_expert_shapes(w.model) for w in works]
    del works
    gc.collect()
    torch.cuda.empty_cache()
    lines = [json.loads(line) for line in buf.getvalue().splitlines()
             if line.startswith("{")]
    return {"line": lines[-1] if lines else None, "launches": launches,
            "curve": [float(x) for x in curve],
            "experts": experts[0] if experts else []}


def world_child(spec: str) -> int:
    """A rank of the world phase's gang (the rendezvous env set by the
    parent): each job of ``spec`` in turn, one JSON result line each."""
    import os

    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rank = int(os.environ["TPUJOB_PROCESS_ID"])
    for job in json.loads(Path(spec).read_text()):
        if job.get("sigterm_rank", rank) != rank:
            job = {**job, "sigterm_after": 0}
        print(json.dumps({"result": _world_job(job)}), flush=True)
    return 0


def _run_gang(jobs: list, tmp: Path) -> list:
    """``jobs`` in each of WORLD_PROCESSES processes of one world on the
    card (``python3 chip_smoke.py --world-child``, gloo). A rank that
    fails stops every rank and fails the phase, naming the rank and
    showing the end of its log. Returns each rank's job results."""
    import os

    from mpi_operator_tpu_torch.utils.net import free_port_pair

    spec = tmp / "world_jobs.json"
    spec.write_text(json.dumps(jobs))
    port = free_port_pair()
    procs, logs = [], []
    for rank in range(WORLD_PROCESSES):
        env = {**os.environ,
               "TPUJOB_COORDINATOR_ADDRESS": f"127.0.0.1:{port}",
               "TPUJOB_NUM_PROCESSES": str(WORLD_PROCESSES),
               "TPUJOB_PROCESS_ID": str(rank), "TPU_WORKER_ID": str(rank),
               "TPUJOB_DIST_BACKEND": "gloo"}
        out, err = tmp / f"rank{rank}.out", tmp / f"rank{rank}.err"
        logs.append((out, err))
        procs.append(subprocess.Popen(
            [sys.executable, __file__, "--world-child", str(spec)], env=env,
            stdout=out.open("w"), stderr=err.open("w")))
    deadline = time.monotonic() + WORLD_TIMEOUT_S
    try:
        while any(p.poll() is None for p in procs):
            for rank, p in enumerate(procs):
                if p.poll() not in (None, 0):
                    raise AssertionError(
                        f"world rank {rank} exited {p.returncode}:\n"
                        f"{logs[rank][1].read_text()[-6000:]}")
            if time.monotonic() > deadline:
                raise AssertionError(
                    f"world ranks still running after {WORLD_TIMEOUT_S} s")
            time.sleep(0.5)
        for rank, p in enumerate(procs):
            if p.returncode != 0:
                raise AssertionError(
                    f"world rank {rank} exited {p.returncode}:\n"
                    f"{logs[rank][1].read_text()[-6000:]}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return [[json.loads(line)["result"]
             for line in out.read_text().splitlines()
             if line.startswith('{"result"')] for out, _ in logs]


def _nccl_probe() -> dict:
    """A one-process NCCL world formed through the launcher's own
    function, the healthcheck's collective probe on it, its JSON line."""
    from mpi_operator_tpu_torch.launcher import bootstrap, healthcheck
    from mpi_operator_tpu_torch.utils.net import free_port_pair

    cfg = bootstrap.RendezvousConfig(
        coordinator_address=f"127.0.0.1:{free_port_pair()}",
        num_processes=1)
    bootstrap.form_world(cfg, device_type="cuda", backend="nccl")
    try:
        import torch.distributed as dist

        backend = dist.get_backend()
        line = healthcheck.run_healthcheck(cfg, device_type="cuda")
    finally:
        bootstrap.shutdown()
    log(json.dumps(line, sort_keys=True))
    log(f"world NCCL probe: backend {backend} -> "
        f"{'ok' if line['ok'] and backend == 'nccl' else 'FAIL'}")
    if not (line["ok"] and backend == "nccl"):
        raise AssertionError("the one-process NCCL world failed its probe")
    return line


def _close(got: list, want: list, rtol: float) -> bool:
    return len(got) == len(want) and all(
        math.isfinite(g) and abs(g - w) <= rtol * abs(w)
        for g, w in zip(got, want))


def run_world(tmp: Path) -> dict:
    """Phase ``world``: the NCCL probe; then BERT-base at full size on two
    processes over gloo (one gang, the jobs in turn): ``--mesh dp=2`` six
    steps against the one-process run of the same call; ``fsdp=2`` and
    ``tp=2`` steps; an ``fsdp=2`` checkpoint resumed on ``dp=2``; the
    resume check (straight to step 4 against step 2
    then resumed to 4, on a token file, a save every 2 steps); SIGTERM to
    rank 1 alone, then the resume to ``--steps``; ``cmd.eval --mesh dp=2``
    on a llama-tiny checkpoint the pair wrote, against the one-process
    eval. Returns each path's launch counts (rank 0's) for the kernel
    record."""
    import torch

    from mpi_operator_tpu_torch.models import bert
    from mpi_operator_tpu_torch.utils.checkpoint import committed_steps

    _nccl_probe()
    # The one-process references: the same calls, their curves recorded.
    one = _world_job({"argv": BERT_TRAIN_ARGS})
    one_moe = _world_job({"argv": MOE_WORLD_ARGS})
    torch.cuda.empty_cache()

    data = _token_file(tmp / "world.u32", RESUME_SEQUENCES, 512,
                       bert.bert_base().vocab_size, seed=2)
    resume = [*RESUME_ARGS, "--mesh", "dp=2", "--data", data]
    straight, resumed = tmp / "world-straight", tmp / "world-resumed"
    preempted, tiny = tmp / "world-preempted", tmp / "world-tiny"
    moved = tmp / "world-moved"
    mesh_argv = [*BERT_TRAIN_ARGS, "--steps", str(WORLD_MESH_STEPS)]
    tiny_eval = ["--checkpoint-dir", str(tiny), "--model", "llama-tiny",
                 "--data", _token_file(tmp / "tiny-world.u32", 256, 16, 256,
                                       seed=3),
                 "--batch", "4", "--batches", "3", "--seq-len", "16"]
    jobs = {
        "dp=2": {"argv": WORLD_ARGS},
        "fsdp=2": {"argv": [*mesh_argv, "--mesh", "fsdp=2"]},
        "tp=2": {"argv": [*mesh_argv, "--mesh", "tp=2"]},
        # Saved sharded by FSDP2 at step 2, resumed on dp=2 to step 3.
        "fsdp save": {"argv": [*BERT_TRAIN_ARGS, "--steps", "2", "--mesh",
                               "fsdp=2", "--save-every", "2",
                               "--checkpoint-dir", str(moved)]},
        "dp resume": {"argv": [*BERT_TRAIN_ARGS, "--steps", "3", "--mesh",
                               "dp=2", "--save-every", "2",
                               "--checkpoint-dir", str(moved)]},
        "straight": {"argv": [*resume, "--steps", "4", "--checkpoint-dir",
                              str(straight)]},
        "first": {"argv": [*resume, "--steps", "2", "--checkpoint-dir",
                           str(resumed)]},
        "resumed": {"argv": [*resume, "--steps", "4", "--checkpoint-dir",
                             str(resumed)]},
        "preempted": {"argv": [*resume, "--steps", "4", "--save-every", "100",
                               "--checkpoint-dir", str(preempted)],
                      "sigterm_rank": 1, "sigterm_after": 2},
        "after": {"argv": [*resume, "--steps", "4", "--save-every", "100",
                           "--checkpoint-dir", str(preempted)]},
        "tiny": {"argv": ["--model", "llama-tiny", "--mesh", "dp=2",
                          "--steps", "2", "--warmup", "1", "--global-batch",
                          "8", "--seq-len", "16", "--lr", "1e-3",
                          "--checkpoint-dir", str(tiny), "--save-every", "1",
                          "--log-every", "1"]},
        "eval": {"cmd": "eval", "argv": [*tiny_eval, "--mesh", "dp=2"]},
        "ep=2": {"argv": [*MOE_WORLD_ARGS, "--mesh", "ep=2"]},
    }
    t0 = time.perf_counter()
    ranks = _run_gang(list(jobs.values()), tmp)
    gang_s = time.perf_counter() - t0
    got = {name: [r[i] for r in ranks] for i, name in enumerate(jobs)}
    failed = []

    def check(name: str, ok: bool, msg: str) -> None:
        log(f"world {name}: {msg} -> {'ok' if ok else 'FAIL'}")
        if not ok:
            failed.append(name)

    flat = FLASH_NAMES["flat"]
    # dp=2 against one process: the global curve is the mean of the
    # ranks' local curves (equal-sized halves, equal MLM weight counts).
    curve = [sum(c) / WORLD_PROCESSES
             for c in zip(*(r["curve"] for r in got["dp=2"]))]
    want = _want_launches({k: BERT_LAYERS * 6 for k in flat})
    lines = [r["line"] for r in got["dp=2"]]
    check("bert-base dp=2",
          _close(curve, one["curve"], WORLD_LOSS_RTOL)
          and all(r["launches"] == want == one["launches"]
                  for r in got["dp=2"])
          and all(line["devices"] == 2 and line["steps"] == 6
                  for line in lines)
          and curve[-1] < curve[0],
          f"curve {[round(x, 6) for x in curve]} vs one process "
          f"{[round(x, 6) for x in one['curve']]} (rtol {WORLD_LOSS_RTOL}); "
          f"step_ms {[line['step_ms'] for line in lines]} (one process "
          f"{one['line']['step_ms']}); sequences/s "
          f"{[line['examples_per_sec'] for line in lines]}; launches a rank "
          f"{[r['launches'] for r in got['dp=2']]} (one process "
          f"{one['launches']})")
    for mesh in ("fsdp=2", "tp=2"):
        curve = [sum(c) / WORLD_PROCESSES
                 for c in zip(*(r["curve"] for r in got[mesh]))]
        want = _want_launches({k: BERT_LAYERS * WORLD_MESH_STEPS
                               for k in flat})
        lines = [r["line"] for r in got[mesh]]
        check(f"bert-base {mesh}",
              _close(curve, one["curve"][:WORLD_MESH_STEPS], WORLD_LOSS_RTOL)
              and all(r["launches"] == want for r in got[mesh])
              and all(line["devices"] == 2 for line in lines),
              f"curve {[round(x, 6) for x in curve]} (one process "
              f"{[round(x, 6) for x in one['curve'][:WORLD_MESH_STEPS]]}); "
              f"step_ms {[line['step_ms'] for line in lines]}; launches a "
              f"rank {[r['launches'] for r in got[mesh]]}")

    # Onto another mesh: the dp=2 run's one step from the fsdp=2 sharded
    # checkpoint is the one-process curve's third.
    lines = [r["line"] for r in got["dp resume"]]
    check("bert-base fsdp=2 -> dp=2 resume",
          all((line["final_step"], line["steps"]) == (3, 1)
              for line in lines)
          and _close([lines[0]["loss"]], one["curve"][2:3], WORLD_LOSS_RTOL),
          f"resumed at step {lines[0]['final_step'] - lines[0]['steps']} to "
          f"{lines[0]['final_step']}, loss {lines[0]['loss']:.6f} (one "
          f"process at step 3: {one['curve'][2]:.6f}; rtol "
          f"{WORLD_LOSS_RTOL})")

    # Resume, as the train phase's check holds it: the resumed loss and
    # every parameter against the straight run.
    s_line, r_line = got["straight"][0]["line"], got["resumed"][0]["line"]
    s_params = _final_params(straight, 4)
    r_params = _final_params(resumed, 4)
    worst = max(
        float(((r_params[k].double() - v.double()).abs()
               - (RESUME_ATOL + RESUME_RTOL * v.double().abs())).max())
        for k, v in s_params.items())
    steps_ok = all((r["line"]["final_step"], r["line"]["steps"]) == (4, 2)
                   for r in got["resumed"])
    check("bert-base dp=2 resume",
          steps_ok and worst <= 0 and s_params.keys() == r_params.keys()
          and abs(r_line["loss"] - s_line["loss"])
          <= RESUME_RTOL * abs(s_line["loss"]),
          f"straight loss {s_line['loss']:.6f} step_ms {s_line['step_ms']}; "
          f"resumed loss {r_line['loss']:.6f} (steps {r_line['steps']}); "
          f"worst parameter excess over rtol {RESUME_RTOL} atol "
          f"{RESUME_ATOL}: {worst:.3e}")

    # SIGTERM to rank 1 alone.
    stop = [r["line"] for r in got["preempted"]]
    after = [r["line"] for r in got["after"]]
    commits = committed_steps(str(preempted))
    check("bert-base dp=2 SIGTERM on rank 1",
          all(line["preempted"] and line["final_step"] == 2 for line in stop)
          and [len(r["curve"]) for r in got["preempted"]] == [2, 2]
          and 2 in commits and max(commits) == 4
          and all((line["final_step"], line["steps"], line["preempted"])
                  == (4, 2, False) for line in after),
          f"stopped at {[line['final_step'] for line in stop]} "
          f"(preempted {[line['preempted'] for line in stop]}); committed "
          f"steps {sorted(commits)}; resumed to "
          f"{[line['final_step'] for line in after]}")

    # Eval on the pair's llama-tiny checkpoint, against one process.
    e0, e1 = got["eval"]
    single = _world_job({"cmd": "eval", "argv": tiny_eval})
    want = _want_launches({"flash_fwd": 2 * 3})
    rel = abs(e0["line"]["loss"] - single["line"]["loss"]) / abs(
        single["line"]["loss"])
    check("eval dp=2",
          e1["line"] is None
          and e0["line"]["tokens"] == single["line"]["tokens"]
          and rel <= TINY_EVAL_RTOL and e0["launches"] == want
          and e1["launches"] == want,
          f"{json.dumps(e0['line'])} (rank 1 printed "
          f"{e1['line']}); one process {json.dumps(single['line'])}; loss rel "
          f"{rel:.3e} (tol {TINY_EVAL_RTOL:.0e}); launches a rank "
          f"{e0['launches']}, {e1['launches']} (want {want})")
    # Mixtral on ep=2: every rank sees the whole batch, holds 4 of the 8
    # experts and sums its partial outputs with its peer's.
    curve = [sum(c) / WORLD_PROCESSES
             for c in zip(*(r["curve"] for r in got["ep=2"]))]
    want = _want_launches({"flash_fwd": 2 * 3, "flash_bwd_dq": 3,
                           "flash_bwd_dkv": 3})
    lines = [r["line"] for r in got["ep=2"]]
    check("mixtral-8x7b/1 layer ep=2",
          _close(curve, one_moe["curve"], WORLD_LOSS_RTOL)
          and all(r["curve"] == got["ep=2"][0]["curve"] for r in got["ep=2"])
          and all(r["launches"] == want == one_moe["launches"]
                  for r in got["ep=2"])
          and all(r["experts"] == [[4, 4096, 14336]] for r in got["ep=2"])
          and one_moe["experts"] == [[8, 4096, 14336]]
          and all(line["devices"] == 2 and line["steps"] == 3
                  for line in lines)
          and curve[-1] < curve[0],
          f"curve {[round(x, 6) for x in curve]} vs one process "
          f"{[round(x, 6) for x in one_moe['curve']]} (rtol "
          f"{WORLD_LOSS_RTOL}); step_ms {[line['step_ms'] for line in lines]}"
          f" (one process {one_moe['line']['step_ms']}); experts a rank "
          f"{[r['experts'] for r in got['ep=2']]} (one process "
          f"{one_moe['experts']}); launches a rank "
          f"{[r['launches'] for r in got['ep=2']]}")
    log(f"world gang: {WORLD_PROCESSES} processes on one card over gloo, "
        f"{len(jobs)} jobs in {gang_s:.1f} s")
    if failed:
        raise AssertionError(f"world checks failed: {failed}")
    return {"bert-base dp=2": got["dp=2"][0]["launches"],
            "bert-base fsdp=2": got["fsdp=2"][0]["launches"],
            "bert-base tp=2": got["tp=2"][0]["launches"],
            "eval dp=2": e0["launches"],
            "mixtral-8x7b ep=2": got["ep=2"][0]["launches"]}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--phases",
                        default="kernels,model,train,moe,decode,world",
                        help="comma-separated subset of kernels,model,train,"
                             "moe,decode,world and the opt-in profile and "
                             "data")
    parser.add_argument("--world-child", default="", help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    phases = set(args.phases.split(","))

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing run", file=sys.stderr)
        return 1
    if args.world_child:  # a rank of the world phase's gang
        return world_child(args.world_child)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from mpi_operator_tpu_torch.ops import _build

    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    t0 = time.perf_counter()
    seconds = _build.build()
    log(f"kernel build: {time.perf_counter() - t0:.1f} s wall "
        f"(per source: {json.dumps({k: round(v, 1) for k, v in seconds.items()})})")
    check_build()

    records = {}
    if "kernels" in phases:
        records = {**check_kernels(), **check_bn_kernels()}
        check_head()
    if "model" in phases:
        check_model()
        check_resnet_model()
        check_bert_model()
        check_vit_seq2seq_models()
    if "profile" in phases:
        profile_step()
        profile_resnet_step()
        profile_bert_step()
        from mpi_operator_tpu_torch.models import seq2seq, vit

        profile_flat_train_step("vit-base", VIT_TRAIN_ARGS, vit.loss_fn)
        profile_flat_train_step("seq2seq-small", S2S_TRAIN_ARGS,
                                seq2seq.loss_fn)
    if "data" in phases:
        ab_data_step()
    if "train" in phases:
        # Each main path's own run gives its kernels' launch counts.
        summary, launches = run_train()
        r_summary, r_launches = run_resnet_train()
        b_summary, b_launches = run_bert_train()
        bhsd_launches = run_bert_bhsd_steps()
        flat_runs = run_vit_seq2seq_train()
        v_summary, s_summary = (flat_runs[k][0]
                                for k in ("vit-base", "seq2seq-small"))
        with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
            d_summary, d_launches = run_llama_data_train(Path(tmp), summary)
            costs = run_bert_resume(Path(tmp))
            e_launches, e_line = run_eval_checks(Path(tmp))
        runs = {"flash_fwd_d64": (b_launches, "flash_fwd")}
        for name, rec in records.items():
            counts, key = runs.get(name, (
                r_launches if name.startswith("bn_") else
                bhsd_launches if name.startswith("flash_bhsd_") else
                launches, name))
            rec["launches"] = counts[key]
            if name in FLASH_NAMES["flat"]:
                # The other paths through the flat kernels, each counted
                # in its own run.
                rec["launches_by_path"] = {
                    "llama3-8b": launches[name], "bert-base": b_launches[name],
                    **{k: c[name] for k, (_, c) in flat_runs.items()},
                    "llama3-8b --data": d_launches[name],
                    "eval": e_launches[name]}
        log(f"card: {card}; train llama tokens/s "
            f"{summary.get('tokens_per_sec')} step_ms {summary['step_ms']}; "
            f"train resnet101 images/s {r_summary['examples_per_sec']} "
            f"step_ms {r_summary['step_ms']}; train bert-base sequences/s "
            f"{b_summary['examples_per_sec']} step_ms {b_summary['step_ms']}; "
            f"train vit-base images/s {v_summary['examples_per_sec']} step_ms "
            f"{v_summary['step_ms']}; train seq2seq-small pairs/s "
            f"{s_summary['examples_per_sec']} step_ms {s_summary['step_ms']}; "
            f"train llama --data step_ms {d_summary['step_ms']}; eval "
            f"llama3-8b/2 tokens/s {e_line['tokens_per_sec']:.1f}; "
            f"bert-base checkpoint {costs['sync']['gb']:.3f} GB: sync "
            f"snapshot {costs['sync']['snapshot']:.4f} s + write "
            f"{costs['sync']['write']:.4f} s a save, async snapshot "
            f"{costs['async']['snapshot']:.4f} s (write "
            f"{costs['async']['write']:.4f} s behind the steps)")
    moe_model = None
    if "moe" in phases:
        m_summary, m_launches, moe_model = run_moe_train()
        for name in FLASH_NAMES["flat"]:
            if name in records:
                records[name].setdefault("launches_by_path", {})[
                    "mixtral-8x7b"] = m_launches[name]
        log(f"card: {card}; moe mixtral-8x7b/{MOE_LAYERS} layers tokens/s "
            f"{m_summary['tokens_per_sec']} step_ms {m_summary['step_ms']} "
            f"routed MFU {m_summary['mfu_bf16_peak_routed']:.4f}")
    if "decode" in phases:
        with tempfile.TemporaryDirectory(prefix="chip_smoke_decode_") as tmp:
            d_paths = run_decode(Path(tmp), moe_model)
        moe_model = None
        for name in FLASH_NAMES["flat"]:
            if name in records:
                records[name].setdefault("launches_by_path", {}).update(
                    {f"decode {k}": c[name] for k, c in d_paths.items()})
        log(f"card: {card}; decode phase done")
    del moe_model
    torch.cuda.empty_cache()
    if "world" in phases:
        with tempfile.TemporaryDirectory(prefix="chip_smoke_world_") as tmp:
            by_path = run_world(Path(tmp))
        for name in FLASH_NAMES["flat"]:
            if name in records:
                records[name].setdefault("launches_by_path", {}).update(
                    {f"world {k}": c[name] for k, c in by_path.items()})
        log(f"card: {card}; world phase done")
    if records:
        log(json.dumps({"kernels": list(records.values())}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
