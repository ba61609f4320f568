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
   dq and dk/dv bodies must be there at all three head dims, 64, 128 and
   256, without and with ids, and issue wgmma, HGMMA in SASS);
2. ``kernels``: each kernel against its plain version on the card, with
   times by CUDA events beside the bound and one PyTorch library call:
   - the six flash kernels, flat ([B, S, H*D]) and [B*H, S, D], at the
     Llama training shape (B=2, S=2048, H=32, Hkv=8, D=128, bf16,
     causal) and the BERT-base shape (B=64, S=512, H=12, D=64, bf16,
     non-causal; timed at both), and in f32 and bf16 a padded GQA shape
     (S=200), a masked-row shape (Sq > Sk, causal) and, for the
     [B*H, S, D] kernels, an id-masked shape with rows that see nothing
     (their out, lse and dq must be exactly 0, -1e30 and 0) and an
     unsorted-id shape (shuffled blocks, +-2^30 padding ids, ragged
     tiles, every tile class at every tiling), in both layouts, each id
     shape's dead/mixed/full tile pairs logged (``tile_classes``); at
     head dim 256 (Qwen3-Next's full-attention heads, 16 q / 2 kv): the
     ``qwen3next`` shape (B=2, S=2048, causal, bf16; timed in both
     layouts, beside SDPA with each fused backend pinned in turn), the
     padded-GQA, masked-row and unsorted-id shapes above in
     f32 and bf16, and the flat kernels at a zigzag ring hop (q [1, 4096,
     16*256], kv [1, 4096, 2*256]); bf16 at head dim 192 (run on the 256
     bodies) and at 100 and 12, which the wrappers pad with zero columns
     to a multiple of 8, and at a training size (d=100, Qwen3-Next's
     heads) each wrapper's time with the pad beside its time on inputs
     already padded; past head dim 256, where each head's columns split
     across a cluster of ceil(D / 256) blocks: DeepSeek-V4-Flash's
     attention, ``deepseek-v4`` (B=2, S=2048, 8 q / 1 kv heads of 512,
     causal, bf16; timed in both layouts, beside SDPA's fastest backend
     that takes the inputs), the padded-GQA, masked-row and unsorted-id
     shapes at head dims 384, 576 and 1024 in f32 and bf16, bf16 at 300
     (padded to 304) and a zigzag hop at 512 (q [1, 4096, 8*512]); a head
     dim of 1025 must be refused, the error naming the limit; the flat
     kernels with the ids of the sp phase's ring hops
     (q [1, 4096,
     32*128], kv [1, 4096, 8*128], bf16: the zigzag ring's four (rank,
     hop) pairs on sp=2 over S=8192, and the contiguous ring's hops in
     which no row sees any column, the causal diagonal and every pair
     visible), each timed beside the same kernel without ids, from a
     CUDA graph (device time alone) and beside SDPA under the ids'
     mask; the lse cotangent's backward
     (``flash_attention_bshd_lse`` at a zigzag hop) against the plain
     versions with delta less the cotangent; bf16 also at
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
   - the norm kernels (``check_norm_kernels``; alone with ``--phases
     norm``): LayerNorm at BERT-base's rows ([32768, 768] bf16), RMSNorm
     at Mixtral's ([4096, 4096] bf16) and both at a ragged width ([3000,
     1003]), forward and backward against the plain versions (two
     backward runs bit-identical), timed at the first two beside the
     bound, the plain version and torch's layer_norm / rms_norm; then
     each kernel's launches over one optimizer step of BERT-base and of
     Mixtral / 2 layers at the benchmark cell's 8 microbatches of 4096
     (26/26 and 72/40), printed as the ``{"norm_kernels": [...]}`` line,
     and the wrappers' host time a call (``norm_host_us``);
   every path's launch check below holds the norm kernels' counts too
   (one a norm a forward and a backward, the blocks' again under remat,
   one a norm a decoded token); each record's ``launches`` is its main
   path's count in the train phase; the flat kernels' ``launches_by_path`` add every other path's,
   and the BN kernels' the model phase's ResNet options (a pass and a
   run of steps each);
3. ``model``: llama3-8b at full width, 2 layers: loss and every gradient
   through the flat kernels and through the [B*H, S, D] kernels
   (``flash-bhsd``) against the dense oracle; the same with Qwen3-Next's
   attention heads (``config_for("llama3-8b", n_heads=16, n_kv_heads=2)``:
   16 q / 2 kv heads of 256) and with DeepSeek-V4-Flash's (``n_heads=8,
   n_kv_heads=1``: 8 q / 1 kv heads of 512, split across clusters), and 3
   AdamW steps of each through the trainer (B=2, S=2048: loss finite and
   falling, launches 12/6/6);
   ResNet-101 at full width
   and depth, B=8: loss, every gradient and the running statistics
   through the BN kernels against the plain-op BN route; ResNet-101's
   two TPU-shaped options through the BN kernels against the plain
   model: with ``space_to_depth`` (its stem mapped from the plain 7x7
   kernel by ``s2d_stem_weight``) and with ``scan_stages`` (the plain
   weights stacked by ``stack_stages``), B=8, f32, one train-mode pass
   each: logits, loss and running statistics (stacked, for the scanned
   model) within twice the plain model's own kernel-vs-plain BN route
   difference (plus 1e-4) and within SCANNED_TOL, 104/104 BN launches a
   pass; then B=64 bf16, 6 SGD steps (the trainer's nesterov SGD at 0.1)
   each of the plain, s2d and scanned models in turn, three rounds: loss
   finite and falling, 104/104 launches a step, each model's median
   step_ms beside the plain model's; and the stem alone (the 7x7
   stride-2 conv against the regroup and the 4x4 stride-1 conv, forward
   and weight backward, CUDA events); BERT-base at full depth and width,
   B=8, S=512: loss and every gradient through both flash routes
   against the dense oracle, in f32 and bf16; ViT-B/16 (B=8) and
   t5-small seq2seq (B=4, src 512, dec 256) through the flat
   kernels against the dense oracle in f32, and in bf16 against the flat
   route through the kernels' plain versions;
4. ``train``: the trainer's own entry point
   (``mpi_operator_tpu_torch.cmd.train.main``) on each main path: Llama
   (full width, 2 layers, S=2048, 6 AdamW steps; then with
   ``--remat-policy dots``, whose flash forward runs once a layer a step,
   12/12/12 launches against full's 24/12/12, its curve within the
   spread of that run and one more ``full`` run), ResNet-101 with
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
   the norm kernels and no other, its attention and MLP the JAX
   version's plain einsums): llama3-8b at full width
   and depth from seeded parameters (B=4, a 128-token prompt, 64 new,
   greedy), the weights-read bound printed first, ms a step, new tokens/s
   and the idle share (one step eager against its CUDA-graph replay); its
   teacher-forced logits against the training forward of the prompt
   (flash forward, 32 launches) at DECODE_LOGITS_TOL, argmax agreement
   printed; the same for the moe phase's Mixtral (its forward with the
   capacity raised so nothing drops) and seq2seq-small (B=16, src 512, 64
   new); then ``python -m mpi_operator_tpu_torch.cmd.generate`` on
   llama-tiny and llama-moe-tiny checkpoints the trainer writes here, its
   tokens against the same command on the CPU;
7. ``decode_world``: sharded decoding on two processes over gloo (the
   world phase's gang), each rank drawing the seeded parameters one
   tensor at a time and keeping only its slices: llama3-8b at full width
   and depth on ``tp=2`` and mixtral-8x7b at full width, 2 layers, on
   ``ep=2`` and ``tp=2`` (B=4, a 16-token prompt, 16 new, greedy),
   against one process decoding the same parameters: teacher-forced
   logits at DECODE_LOGITS_TOL, greedy tokens equal up to the first
   position whose one-process top-2 logit gap is under DECODE_NEAR_TIE,
   ms a step, new tokens/s, peak memory a rank beside one process's and
   the bytes one step all-reduces (exactly an f32 [B, dim] partial per
   row-parallel product); then ``cmd.generate`` as a two-process gang on
   llama-tiny (``--mesh dp=2``, ``tp=2``, ``fsdp=2``) and llama-moe-tiny
   (those and ``ep=2``) checkpoints of seeded parameters, its lines
   equal to the one-process command's (f32) and printed by process 0
   alone. No arm launches a kernel but the norms';
8. ``world``: the port across processes. A one-process NCCL world formed
   by the launcher's own ``form_world``, with the healthcheck's collective
   probe and its JSON line. Then one gang of two processes on the one
   card (``python3 chip_smoke.py --world-child``, the rendezvous env, the
   gang barrier, ``cmd.train.main``; gloo, since NCCL refuses two ranks
   on one GPU) runs in turn: BERT-base at full size (B=64 global, S=512,
   ``--mlm-layout positions``) with ``--mesh dp=2``, six steps, its loss
   curve held against the one-process run of the same call (rtol 2e-3)
   and each rank's flash launches against that run's; two steps each
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
9. ``sp``: sequence parallelism on the one card. First which gloo ops
   take CUDA tensors (send/recv, all_to_all_single, all_reduce,
   all_gather, broadcast, each in a pair of processes of its own); then
   llama3-8b at full width, 1 layer, B=1, S=8192, 2 AdamW steps,
   through ``cmd.train.main`` on two processes over gloo (the world
   phase's gang: ``--world-child``) with ``--mesh sp=2`` as the zigzag
   ring, the contiguous ring and Ulysses, each loss curve held against
   the one-process run of the same call (rtol 2e-3) and each rank's
   flash launches against the hop count (ring: forward 8, dq and dk/dv
   4; Ulysses: the one-process 4/2/2), with each rank's step_ms, peak
   memory and transport bytes beside the one-process run's; gloo
   through the host on one card, not a multi-GPU node;
10. ``tp``: tensor parallelism and FSDP on the one card, each run
   through ``cmd.train.main`` on a gang over gloo (the world phase's
   ``--world-child``), 2 steps, against the one-process run of the same
   call (curve at rtol 2e-3): mixtral-8x7b at full width, 1 layer, B=2,
   S=2048, lr 3e-5 on ``--mesh fsdp=2`` and on ``--mesh tp=2`` (16 q / 4
   kv heads and half of every expert's hidden dim a rank); vit-base, seq2seq-small
   and resnet101 (``--bn-kernel xla``, the replicated layout) on
   ``tp=2``; bert-base with the train phase's arguments at B=32 (S=512,
   ``--mlm-layout positions``: each rank gathers the prediction slots
   in its columns) on ``--mesh sp=2`` as the ring (12/12 heads, 2 hops
   a layer) and as Ulysses (6/6); bert-base B=32 S=512 (the mask layout)
   on ``--mesh sp=2,tp=2``, four processes, as the ring and as Ulysses.
   Each rank's flat kernel launches are held to the run's count at the
   local head counts (the wrappers count them by q/kv heads,
   ``ops/attention.py:LAUNCH_HEADS``); step_ms, peak GB a rank
   (allocated and reserved) and the bytes the first step hands gloo a
   rank (by c10d op, from a dispatch mode) are printed beside the
   one-process run's;
11. ``pp``: pipeline parallelism on the one card (GPipe over ``--mesh
   pp``), each arm through ``cmd.train.main`` on a gang over gloo, 2
   steps, against the one-process run of the same call (curve at rtol
   2e-3): llama3-8b at full width, 2 layers, B=4, S=2048 on ``pp=2``
   (4 microbatches of 1, a layer a stage); mixtral-8x7b at full width,
   2 layers, B=2, lr 3e-5 on ``pp=2`` (2 microbatches; the router loss
   through the pipeline); llama3-8b on ``pp=2,tp=2`` over four processes
   when its state a rank fits the four-rank share. Each rank's flat
   launches are held to steps x microbatches x layers a stage (2
   forward under remat, 1 dq, 1 dk/dv) at its q/kv heads and its hop
   bytes to 2 (M + P - 1) mb S D 2 B a step; step_ms and peak GB a rank
   (allocated and reserved) beside the one-process run's. Then a
   llama-tiny ``pp=2`` checkpoint (the card's f32 kernels) read by
   ``cmd.eval`` (its loss against a one-process checkpoint of the same
   training) and resumed on one process to step 6 (the continued
   losses against the one-process run's);
12. ``operator``: the port's job path, from create to a terminal
   condition, through its own control plane in this process
   (``InMemoryAPIServer``, ``TPUJobController``, ``LocalPodRunner``
   auto-binding, told the card count), every worker pod a process on the
   card: the shipped pi job on ``h100-2`` (two pods on the one card, so
   the runner puts them on gloo), its seconds from create to both pods
   Running and to Succeeded beside the 200 s startup bound; a job with
   no command, so its two pods run the builders' default, the port's
   healthcheck (its collective probe over gloo on the card); llama3-8b /
   2 layers on ``h100-1``, the pod running ``cmd.train.main`` with the
   train phase's arguments (``--world-child``): Succeeded, flash
   launches 24/12/12, loss finite and falling, the first loss within
   rtol 1e-3 of the train phase's direct call, step_ms and tokens/s
   beside it; a malformed command (Failed, naming the pod); and
   ``python -m mpi_operator_tpu_torch.cmd.operator --backend memory
   --apply mpi_operator_tpu_torch/examples/pi.yaml --exit-on-completion``
   as a process (exit 0, its wall time);
13. ``observe``: the operator under faults, in this process's control
   plane with the step-skew and memory matrices and a monitoring
   server: llama3-8b / 2 layers on ``h100-1`` as a pod with
   ``--heartbeat-every 2`` and ``TPU_JAX_TRACE=1`` (its heartbeat and
   device-memory annotations, ``/debug/jobs/default/llama-hb/steps`` and
   ``/memory``, the limit against the card's memory, the bytes in use
   against the parameters and AdamW state, step_ms beside the train
   phase's direct call, 24/12/12 launches per 6 steps, no kernel load
   after warmup, the host syncs a step); a seeded ``ChaosEngine`` on a
   job of 3 replicas (each pod its own llama-tiny): all three killed at
   their start and replaced under an ``Ignore`` rule, worker 0 slowed 2x
   and leaking 16 GiB a window, ``Straggling`` and ``MemoryPressure``
   flipping; then the worker healed (``heal_worker``) and killed, both
   conditions recovering and the job succeeding, with the fault timeline
   and the window of each transition; ``python -m
   mpi_operator_tpu_torch.cmd.operator --enable-queue --cluster-queue
   gpus:h100=2 --enable-scheduler`` as a process with two ``h100-2`` pi
   jobs (the second admitted after the first finishes, both gangs bound
   by the scheduler, the admission latency); llama3-8b / 2 layers in
   this process with ``--profile-dir`` (the trace must name the three
   flash kernels) and ``torch.cuda``'s sync debug mode, whose syncs the
   tracer must count;
14. ``kube``: the port's operator on a cluster's terms: ``python -m
   mpi_operator_tpu_torch.cmd.operator --backend kube --kubeconfig
   <file>`` as a process against ``APIServerFrontend`` (the envtest
   analog: real HTTP, a random bearer token, watch streams) over a fresh
   ``InMemoryAPIServer``, with a ``LocalPodRunner`` over its own REST
   client playing the node's kubelet (in this script only; a cluster
   brings its own). pi on ``h100-2`` (create to both pods Running and to
   Succeeded over REST, beside the operator phase's in-memory numbers);
   llama3-8b / 2 layers on ``h100-1`` with the train phase's arguments
   (24/12/12, first loss within rtol 1e-3 of the direct call) through a
   429 burst the operator absorbs (its ``/metrics`` counts the retries)
   and a compaction of the watch history while the node's pod watch is
   down (it resumes with a 410 and relists); a malformed command
   (Failed, naming the pod); ``--apply`` of the shipped pi.yaml over REST
   as a process (exit 0); ``--backend kube --enable-scheduler`` refused;
15. ``fleet``: the operator's control plane at fleet scale, on the card
   machine's host (no kernel runs): the port's four seeded benches
   through their ``main()`` (``cmd/bench_{straggler,memory,goodput,
   controlplane}.py``). The straggler and memory documents at ``--jobs 8
   --seed 42`` must equal the committed ``BENCH_STRAGGLER.json`` and
   ``BENCH_MEMORY.json`` (the JAX benches' output) byte for byte; the
   goodput curve at ``--jobs 8 --rates 0,0.3`` must pass its gates; a
   100-job storm under ``--lock-trace`` must converge with no lock-order
   inversion, its jobs/s and reconcile p50/p99 printed beside the card;
16. ``examples``: the port's deployable jobs. The worker image's kernel
   build: the kernel-build line of ``mpi_operator_tpu_torch/build/worker/
   Dockerfile``, read out of the file, run on a copy of the port as the
   image's build runs it (every library must appear in the copy's
   ``_build/``), then the copy's flat flash forward, loaded without a
   build, against its plain version (bf16). Then the shipped
   ``examples/seq2seq/seq2seq.yaml`` (``h100-8``: eight pods on
   ``dp=8``, seq2seq-small at full width) through the port's operator in
   this process, its pods on the one card over gloo, running the shipped
   argv but for two rewrites (``--steps`` to 3 and ``--checkpoint-dir``
   to a temporary directory, both printed): Succeeded within the 200 s
   startup bound, each rank's loss finite and falling, each rank's flat
   launches 18 a step, step_ms and peak GB a rank (from a
   ``sitecustomize`` on the pods' ``PYTHONPATH`` that reports at exit)
   beside the one-process step, and step 3 committed;
17. ``entry``: the port's compute entry points
   (``mpi_operator_tpu_torch/entry.py``, the counterpart of the repo's
   ``__graft_entry__.py``). ``entry()`` on the card: ResNet-101's eval
   forward at B=8, 224x224 and the causal flash forward on bf16 ``q [2,
   512, 8, 128]``, ``k, v [2, 512, 4, 128]``, one call on seeded inputs of
   those shapes (the entry's own are zeros, as JAX's): finite [8, 1000]
   logits, exactly one launch of the flat forward kernel and none of any
   other, the attention against its plain version at the kernels phase's
   bf16 tolerance. Then ``dryrun_multichip(8)`` on the card: eight ranks
   of one world over gloo on the one card, each held to an equal share
   of its memory, one train step of every composition of JAX's dryrun
   (Llama on dp x fsdp x tp x sp with the ring and with Ulysses, MoE on
   dp x ep x tp, GPipe on dp x fsdp x pp, sp x tp x pp, MoE x pp, the
   cross-slice HSDP step, ResNet-18 on dp x fsdp) with its sharding
   receipt: each composition's loss and rank 0's flat launches printed,
   every Llama and MoE composition launching the flat forward, dq and
   dk/dv kernels on every rank (the ring ones their id instantiations),
   the phase's seconds beside the card;
18. ``profile`` (opt-in, ``--phases profile``): where one training step's
   time goes, for each arm (device kernel time by kind, idle share);
19. ``data`` (opt-in, ``--phases data``): the cost of ``--data`` on the
   step, as a same-call A/B: the Llama and the BERT-base train runs
   synthetic and on a token file in turns (S D D S, four times), 10 steps
   each, with every run's step_ms and each side's median;
20. ``kernels_ab`` (opt-in, ``--phases kernels_ab --ab-parent DIR``): the
   flash kernels of this checkout against those built from the checkout
   at DIR (its own ``_build/``), in this process on the same inputs at
   AB_SHAPES: shapes without ids must give bit-identical outputs, and
   each kernel is timed DIR's, this, this, DIR's.

Any failure raises and exits non-zero. The second-to-last line is the
``{"kernels": [...]}`` record; the last is
``{"ok": true, "device": {...}}``. Exits 1 with no result when no CUDA
device is present.
"""

from __future__ import annotations

import argparse
import atexit
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

# The norm kernels' launches (ops/norm.py) on each path: a norm launches
# norm_fwd once a forward and norm_bwd once a backward; under remat the
# blocks' norms launch norm_fwd again in the backward's recompute (under
# either policy: 'dots' keeps matmuls and the flash forward, and the norm
# kernel is neither). Norms a forward of each family but Llama's (two a
# block and the final norm): BERT's embedding norm, two a layer and the
# MLM head's; ViT's two a block and the final norm; seq2seq's two an
# encoder block, three a decoder block and the two stacks' final norms.
BERT_NORMS = 2 * BERT_LAYERS + 2
VIT_NORMS = 2 * VIT_LAYERS + 1
S2S_LAYERS = 6  # t5-small's encoder and decoder blocks each
S2S_NORMS = 2 * S2S_LAYERS + 1 + 3 * S2S_LAYERS + 1


def _norms(per_pass: int, passes: int, backward: bool = True,
           again: int = 0) -> dict:
    """The norm kernels' launches over ``passes`` forwards of
    ``per_pass`` norms each, with their backward when ``backward``;
    ``again`` of each forward's norms recomputed in its backward."""
    return {"norm_fwd": passes * (per_pass + (again if backward else 0)),
            "norm_bwd": passes * per_pass if backward else 0}


NORM_KEYS = ("norm_fwd", "norm_bwd")


def _pick(counts: dict, keys) -> dict:
    return {k: counts[k] for k in keys}


def _llama_norms(layers: int, passes: int, backward: bool = True,
                 remat: bool = True, final: bool = True) -> dict:
    """:func:`_norms` of a Llama-family model of ``layers`` blocks (the
    blocks a pipeline stage holds; ``final``: it holds the final norm);
    ``remat``: its config checkpoints the blocks (llama3-8b and
    mixtral-8x7b do, the tiny configs do not)."""
    return _norms(2 * layers + int(final), passes, backward,
                  2 * layers if remat else 0)


def _with_flag(argv: list, flag: str, value) -> list:
    i = argv.index(flag)
    return argv[:i + 1] + [str(value)] + argv[i + 2:]


def _with_steps(argv: list, steps: int) -> list:
    return _with_flag(argv, "--steps", steps)

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
# (and the moe phase's Mixtral), B=4, a 128-token prompt, 64 new tokens
# (128 until the entry phase joined the run), greedy; seq2seq-small
# B=16, src 512, 64 new.
DECODE_BATCH, DECODE_PROMPT, DECODE_NEW = 4, 128, 64
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
    # No TPU kernel: the JAX package leaves its norms to XLA's fusion.
    "norm_fwd": "none (XLA fuses mpi_operator_tpu's norms)",
    "norm_bwd": "none (XLA fuses mpi_operator_tpu's norms)",
}


def log(msg: str) -> None:
    print(msg, flush=True)


def free_card(label: str) -> None:
    """Hand this process's cached device memory back to the card before
    other processes take it (the gangs and pods put two to four more
    processes on the one card), and log what this process still holds
    beside what the card has in use."""
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info()
    log(f"card memory before {label}: this process allocated "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB, reserved "
        f"{torch.cuda.memory_reserved() / 1e9:.2f} GB; the card "
        f"{(total - free) / 1e9:.2f} GB in use of {total / 1e9:.2f} GB")


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
    """0 for empty operands (a hop whose every row sees nothing has no
    live lse to compare)."""
    diff = (got.double() - want.double()).abs()
    return float(diff.max()) if diff.numel() else 0.0


def bound(kind: str, shape: dict, dtype_name: str, pairs: int,
          rows: int = -1, cols: int = -1):
    """(bound_ms, bound_by): the larger of the operations at the card's
    peak for the type and the bytes (each input read once, each output
    written once) at its memory rate. ``pairs`` counts the visible
    (query, key) pairs of one head of these inputs; ``rows`` and ``cols``
    the q rows that see some column and the columns some row sees (all
    by default): only their inputs need reading."""
    b, sq, sk = shape["b"], shape["sq"], shape["sk"]
    h, hkv, d = shape["h"], shape["hkv"], shape["d"]
    rows, cols = (sq if rows < 0 else rows), (sk if cols < 0 else cols)
    es = 2 if dtype_name == "bf16" else 4
    q_bytes, kv_bytes = b * sq * h * d * es, b * sk * hkv * d * es
    stat_bytes = b * sq * h * 4
    q_in, kv_in = q_bytes * rows / sq, kv_bytes * cols / sk
    stat_in = stat_bytes * rows / sq
    macs_per_pair = {"fwd": 2, "dq": 3, "dkv": 4}[kind]
    flops = 2 * macs_per_pair * d * pairs * b * h
    if kind == "fwd":   # q, k, v in; out, lse out
        nbytes = q_in + 2 * kv_in + q_bytes + stat_bytes
    elif kind == "dq":  # q, k, v, do, lse, delta in; dq out
        nbytes = 2 * q_in + 2 * kv_in + 2 * stat_in + q_bytes
    else:               # q, k, v, do, lse, delta in; dk, dv out
        nbytes = 2 * q_in + 2 * kv_in + 2 * stat_in + 2 * kv_bytes
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
    # 16..39 see no column. Ragged tiles (96 and 80 rows): the f32
    # padded shape with ids.
    ("id-masked", dict(b=2, sq=96, sk=80, h=4, hkv=2, d=64, dtype="f32",
                       causal=False, ids="chunks", dead="some"),
     ("flat", "bhsd")),
    # The same edges on the bf16 tensor-core bodies: ragged tiles, rows
    # that see nothing (out = 0, lse = -1e30 exactly), ids.
    ("padded-gqa-bf16", dict(b=2, sq=200, sk=200, h=8, hkv=2, d=64,
                             dtype="bf16", causal=False), ("flat", "bhsd")),
    ("masked-rows-bf16", dict(b=1, sq=130, sk=70, h=4, hkv=2, d=128,
                              dtype="bf16", causal=True), ("flat", "bhsd")),
    ("id-masked-bf16", dict(b=2, sq=96, sk=80, h=4, hkv=2, d=64,
                            dtype="bf16", causal=False, ids="chunks",
                            dead="some"),
     ("flat", "bhsd")),
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
    # Unsorted ids (_shape_ids "random"): each 64 rows or columns a
    # shuffled block, the last three +-2^30 padding ids, rows that see
    # nothing, ragged tiles (330 and 190 rows), so every tile class
    # appears at every tiling the bodies use.
    ("id-random", dict(b=2, sq=330, sk=190, h=4, hkv=2, d=64, dtype="f32",
                       causal=False, ids="random", dead="some"),
     ("flat", "bhsd")),
    ("id-random-bf16", dict(b=2, sq=330, sk=190, h=4, hkv=2, d=64,
                            dtype="bf16", causal=False, ids="random",
                            dead="some"), ("flat", "bhsd")),
    # Head dim 256 (Qwen3-Next's full-attention layers: 16 q / 2 kv heads
    # of 256) at the Llama training shape's batch and length: the bf16
    # bodies' 256 instantiations (dq on 64 q rows a block, dk/dv split
    # across its warpgroups) and, timed, beside SDPA.
    ("qwen3next", dict(b=2, sq=2048, sk=2048, h=16, hkv=2, d=256,
                       dtype="bf16", causal=True), ("flat", "bhsd")),
]
# The edge shapes above at head dim 256, in f32 (the SIMT bodies at width
# 256) and bf16; head dims that run on a wider body (192 on 256) or that
# the wrapper pads to a multiple of 8 (100 to 104 on 128, 12 to 16 on 64).
FLASH_SHAPES += [
    (f"{label}-d256{suffix}", dict(s, d=256, dtype=dtype), layouts)
    for label, s, layouts in FLASH_SHAPES
    if label in ("padded-gqa", "masked-rows", "id-random")
    for dtype, suffix in (("f32", ""), ("bf16", "-bf16"))
] + [
    ("d192-bf16", dict(b=2, sq=150, sk=150, h=4, hkv=2, d=192, dtype="bf16",
                       causal=True), ("flat", "bhsd")),
    ("d100-bf16", dict(b=2, sq=150, sk=150, h=4, hkv=2, d=100, dtype="bf16",
                       causal=True), ("flat", "bhsd")),
    ("d12-bf16", dict(b=2, sq=100, sk=130, h=4, hkv=4, d=12, dtype="bf16",
                      causal=True), ("flat", "bhsd")),
]
# The ring's hops in the sp phase's llama3-8b run (S=8192 on sp=2: q
# [1, 4096, 32*128], kv [1, 4096, 8*128], bf16), each with its (layout,
# rank, the k/v shard's rank) ids: the zigzag ring's four (rank, hop)
# pairs (rank 0 holds chunks 0 and 3 of 4, rank 1 chunks 1 and 2: only
# rank 0's chunk 0 on rank 1's shard sees nothing), and the contiguous
# ring's three kinds of hop: rank 0 on rank 1's shard, where no row sees
# any column (out 0, lse -1e30 and dq 0 exactly), rank 1 on its own shard
# (the causal diagonal) and rank 1 on rank 0's (every pair visible).
SP_HOP = dict(b=1, sq=4096, sk=4096, h=32, hkv=8, d=128, dtype="bf16",
              causal=False)
SP_HOP_SEQ, SP_HOP_RANKS = 8192, 2
FLASH_SHAPES += [
    (f"sp-zigzag-r{rank}-s{src}",
     dict(SP_HOP, ids=("zigzag", rank, src),
          dead="some" if (rank, src) == (0, 1) else None), ("flat",))
    for rank in range(SP_HOP_RANKS) for src in range(SP_HOP_RANKS)
] + [("sp-contig-dead", dict(SP_HOP, ids=("contiguous", 0, 1), dead="all"),
      ("flat",)),
      ("sp-contig-diag", dict(SP_HOP, ids=("contiguous", 1, 1)), ("flat",)),
      ("sp-contig-full", dict(SP_HOP, ids=("contiguous", 1, 0)), ("flat",))]
# Head dims past 256, each head's columns split across a cluster of
# ceil(D / 256) blocks (ops/_common.py:flash_split_plan): DeepSeek-V4-Flash's
# attention (8 q heads of 512 over its one kv head, here at the Llama
# shape's batch and length, H * D = 4096 as at L and Q; timed), and the
# edge shapes above at 384 (two blocks, the second half empty), 576
# (sarvam-105b's absorbed MLA: three) and 1024 (four, the widest) in f32 and
# bf16, and a bf16 width past 256 that is not a multiple of 8 (300, padded
# to 304).
FLASH_SHAPES += [
    ("deepseek-v4", dict(b=2, sq=2048, sk=2048, h=8, hkv=1, d=512,
                         dtype="bf16", causal=True), ("flat", "bhsd")),
] + [
    (f"{label}-d{d}{suffix}", dict(s, d=d, dtype=dtype), layouts)
    for d in (384, 576, 1024)
    for label, s, layouts in FLASH_SHAPES
    if label in ("padded-gqa", "masked-rows", "id-random")
    for dtype, suffix in (("f32", ""), ("bf16", "-bf16"))
] + [
    ("d300-bf16", dict(b=2, sq=150, sk=150, h=4, hkv=2, d=300, dtype="bf16",
                       causal=True), ("flat", "bhsd")),
]
# The shapes timed (kernel, plain version, SDPA) besides being checked;
# a shape with ids is also timed without them (noid_ms: no mask, every
# tile visited).
TIMED_SHAPES = ("llama", "bert", "vit", "s2s-cross", "qwen3next",
                "deepseek-v4") + tuple(
    label for label, _, _ in FLASH_SHAPES if label.startswith("sp-"))
# Timed shapes whose SDPA yardstick is each of its backends pinned in turn
# (the fastest that takes the inputs, by direction): SDPA's own choice has
# moved its backward by 3x from call to call at L. Where no fused backend
# takes the inputs (D past 256 with GQA), the math backend is timed.
PINNED_SDPA = ("qwen3next", "deepseek-v4")
# The zigzag hop of a Qwen3-Next-headed model on the same ring (q [1, 4096,
# 16*256], kv [1, 4096, 2*256]): the 256-wide bodies with ids. Checked, not
# timed.
FLASH_SHAPES.append(("sp-zigzag-r0-s0-d256",
                     dict(SP_HOP, h=16, hkv=2, d=256, ids=("zigzag", 0, 0)),
                     ("flat",)))
# The same hop with DeepSeek-V4-Flash's heads (q [1, 4096, 8*512], kv
# [1, 4096, 512]): the column split with ids. Checked, not timed.
FLASH_SHAPES.append(("sp-zigzag-r0-s0-d512",
                     dict(SP_HOP, h=8, hkv=1, d=512, ids=("zigzag", 0, 0)),
                     ("flat",)))
# The tilings the bodies classify ids on: (q rows, k rows) of the bf16
# forward and dq, the bf16 dk/dv, and the f32 bodies.
ID_TILINGS = {"fwd/dq bf16": (128, 64), "dkv bf16": (64, 128),
              "f32, dq and dk/dv bf16 at 256": (64, 64)}
FLASH_NAMES = {
    "flat": ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"),
    "bhsd": ("flash_bhsd_fwd", "flash_bhsd_bwd_dq", "flash_bhsd_bwd_dkv"),
}
# The record each kernel's line in {"kernels": [...]} carries: the shape
# of its main path (flat: the Llama trainer; bhsd: the BERT flash-bhsd
# steps); the other timed shape rides along under "at_<label>".
FLASH_RECORD_SHAPE = {"flat": "llama", "bhsd": "bert"}


def _random_ids(n: int, offset: int, pad: int, seed: int):
    """n int32 ids: block i of 64 positions holds i * 1000 + offset + 10
    * (a shuffle of 0..63), unsorted within a block and ordered across
    blocks; the last three are ``pad``."""
    import torch

    gen = torch.Generator().manual_seed(seed)
    ids = torch.cat([i * 1000 + offset + 10 * torch.randperm(64, generator=gen)
                     for i in range((n + 63) // 64)])[:n]
    ids[-3:] = pad
    return ids.to(torch.int32)


def _shape_ids(spec, sq: int = 0, sk: int = 0):
    """(row_ids, col_ids) on the card for a FLASH_SHAPES ``ids`` entry:
    "chunks" (two chunks each, q rows 16..39 seeing no column); "random"
    (_random_ids over sq rows from 0 padded with -2^30 and sk columns
    from 5 padded with +2^30: a row block sees the earlier column blocks
    whole and its own in part; the rows of id 0 or -2^30 see nothing);
    or a ring hop (layout, rank, the k/v shard's rank) of SP_HOP_RANKS
    ranks over SP_HOP_SEQ positions; (None, None) without."""
    import torch

    from mpi_operator_tpu_torch.ops import ring_attention as ring

    if spec is None:
        return None, None
    if spec == "chunks":
        row = torch.cat([torch.arange(16, 64), torch.arange(160, 208)])
        col = torch.cat([torch.arange(40, 80), torch.arange(120, 160)])
        return row.to("cuda", torch.int32), col.to("cuda", torch.int32)
    if spec == "random":
        pad = 2 ** 30
        return (_random_ids(sq, 0, -pad, 11).to("cuda"),
                _random_ids(sk, 5, pad, 12).to("cuda"))
    layout, rank, src = spec
    s_loc, zigzag = SP_HOP_SEQ // SP_HOP_RANKS, layout == "zigzag"
    return tuple(ring._shard_ids(i, SP_HOP_RANKS, s_loc, zigzag, "cuda")
                 for i in (rank, src))


def _flash_draw(s: dict, gen) -> tuple:
    """(q, k, v, do) of a FLASH_SHAPES shape in [B, H, S, D], drawn on
    the card from ``gen`` in the shape's type."""
    import torch

    dtype = torch.bfloat16 if s["dtype"] == "bf16" else torch.float32
    b, sq, sk, h, hkv, d = (s[k] for k in ("b", "sq", "sk", "h", "hkv", "d"))
    return tuple(torch.randn(b, n, ln, d, generator=gen, device="cuda")
                 .to(dtype) for n, ln in
                 ((h, sq), (hkv, sk), (hkv, sk), (h, sq)))


def _in_layout(ts, layout: str) -> list:
    """[B, H, S, D] operands in ``layout``: flat [B, S, H*D] (copied) or
    [B*H, S, D] (viewed)."""
    if layout == "flat":
        return [t.transpose(1, 2).reshape(t.shape[0], t.shape[2], -1)
                .contiguous() for t in ts]
    return [t.reshape(-1, *t.shape[2:]) for t in ts]


def _flash_calls(attn, layout: str, h: int, scale: float, causal: bool,
                 ids):
    """((fwd, dq, dkv) kernel wrappers, their plain versions), each taking
    (q, k, v) or (q, k, v, do, lse, delta) in ``layout``."""
    if layout == "flat":
        tail = (h, scale, causal, *ids)
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
    """``flash::fwd_kernel_tc<64, true>`` from its mangled name (as far as
    the names here need), else the mangled name."""
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
    # Template arguments: a head dim or an element type (then the SIMT
    # bodies' width), then the kernel's flags (IDS, and SPLIT or COLS where
    # it has one).
    arg = re.match(r"I(?:Li(\d+)E|(f)|(13__nv_bfloat16))?(?:Li(\d+)E)?"
                   r"((?:Lb[01]E)*)E", rest)
    if arg:
        args = [arg.group(1) or ("float" if arg.group(2) else "bf16")
                if any(arg.group(i) for i in (1, 2, 3)) else None,
                arg.group(4)]
        args += ["true" if flag == "1" else "false"
                 for flag in re.findall(r"Lb([01])E", arg.group(5))]
        name += "<" + ", ".join(a for a in args if a is not None) + ">"
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
# instantiated at the head dims 64, 128 and 256 and, for head dims past
# 256, at 256 split across a cluster, without and with ids: the forward's
# <DP, IDS, SPLIT>; dq's <DP, IDS> and bwd_dq_kernel_tc_split<IDS>; dk/dv's
# <DP, IDS> at 64 and 128 and bwd_dkv_kernel_tc_split<256, IDS, COLS>.
TC_BODIES = ("flash::fwd_kernel_tc", "flash::bwd_dq_kernel_tc",
             "flash::bwd_dkv_kernel_tc")
TC_HEAD_DIMS = (64, 128, 256)


def tc_instances(library: str) -> list:
    """The tensor-core bodies the flash library ``library`` must hold."""
    kind = library.split("_")[-1]  # fwd, dq or dkv
    ids = ("false", "true")
    if kind == "dkv":
        return sorted([f"flash::bwd_dkv_kernel_tc<{d}, {i}>"
                       for d in TC_HEAD_DIMS[:2] for i in ids]
                      + [f"flash::bwd_dkv_kernel_tc_split<256, {i}, {c}>"
                         for i in ids for c in ("false", "true")])
    if kind == "dq":
        return sorted([f"flash::bwd_dq_kernel_tc<{d}, {i}>"
                       for d in TC_HEAD_DIMS for i in ids]
                      + [f"flash::bwd_dq_kernel_tc_split<{i}>" for i in ids])
    return sorted(f"flash::fwd_kernel_tc<{d}, {i}, {split}>"
                  for d, split in ((64, "false"), (128, "false"),
                                   (256, "false"), (256, "true"))
                  for i in ids)


def check_build() -> None:
    """Per kernel: registers and spills (ptxas) and tensor-core
    instructions (SASS). Fails if a flash kernel spills, a flash library
    lacks one of its tensor-core bodies (tc_instances: each head dim of
    TC_HEAD_DIMS and the 256 body split across a cluster, without and with
    ids), or a tensor-core body issues no wgmma."""
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
        if name.startswith("flash") and bodies != tc_instances(name):
            failed.append(f"{name} holds tensor-core bodies {bodies}, "
                          f"want {tc_instances(name)}")
    if failed:
        raise AssertionError("kernel build checks failed: " + "; ".join(failed))


def check_kernels() -> dict:
    """Each flash kernel against its plain version at every shape of
    FLASH_SHAPES in each of its layouts, timed at TIMED_SHAPES. Returns a record per kernel (errors, times, bounds), plus
    ``flash_fwd_d64``: the flat forward at the BERT shape, the record for
    hack/headdim_probe.py's packed d=64 kernel."""
    import torch

    from mpi_operator_tpu_torch.ops import _common
    from mpi_operator_tpu_torch.ops import attention as attn

    timed = {}  # (kernel name, shape label) -> record
    gen = torch.Generator(device="cuda").manual_seed(0)
    for label, s, layouts in FLASH_SHAPES:
        sq, sk, h, d = (s[k] for k in ("sq", "sk", "h", "d"))
        causal, scale = s["causal"], d ** -0.5
        ids = _shape_ids(s.get("ids"), sq, sk)
        # The launch's cluster: blocks that share each head's columns and
        # the width each runs at (of the padded width, in bf16).
        plan = list(_common.flash_split_plan(
            _common.flash_padded_head_dim(d) if s["dtype"] == "bf16" else d))
        if ids[0] is not None:
            # The plain classifier's dead / mixed / full tile pairs at
            # each tiling the bodies walk these ids on.
            counts = {}
            for tiling, (tq, tk) in ID_TILINGS.items():
                cls = attn.tile_classes(*ids, sq, sk, tq, tk)
                counts[tiling] = [int((cls == c).sum()) for c in (
                    attn.TILE_DEAD, attn.TILE_MIXED, attn.TILE_FULL)]
            log(f"kernel tiles [{label}] dead/mixed/full: "
                + json.dumps(counts))

        q4, k4, v4, do4 = _flash_draw(s, gen)
        lib_ms = None
        if label in TIMED_SHAPES:
            # SDPA on the same function: the ids' mask when there are ids.
            mask = (None if ids[0] is None else
                    ids[1][None, :] <= ids[0][:, None])
            lib_ms = (_pinned_sdpa_ms(label, q4, k4, v4, do4, causal)
                      if label in PINNED_SDPA else
                      _sdpa_ms(q4, k4, v4, do4, causal, mask))
        for layout in layouts:
            ops = _in_layout((q4, k4, v4, do4), layout)
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
            if (s.get("dead") == "some" and bool(live.all())) or (
                    s.get("dead") == "all" and bool(live.any())):
                raise AssertionError(f"{label}: want {s['dead']} rows to "
                                     f"see nothing")
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
                log(f"kernel {name} [{label} {s}] plan {plan}: max_abs_err="
                    f"{mabs:.3e} norm_rel_err={nrel:.3e} (tol {tol:.0e}) "
                    f"lse_abs_err={lse_err:.3e} masked_rows_ok="
                    f"{dead_rows_ok} -> {'ok' if ok else 'FAIL'}")
                if not ok:
                    raise AssertionError(f"{name} disagrees with its plain "
                                         f"version at {label}")
                if lib_ms is None and plan[0] > 1:
                    # A split shape checked, not timed: its record rides
                    # along with its errors.
                    timed[name, label] = {"max_abs_err": mabs,
                                          "norm_rel_err": nrel, "plan": plan}
            if lib_ms is None:
                continue
            # The work these inputs need: their visible pairs.
            mask = attn._mask(qx, kx, causal, *ids)
            pairs, rows, cols = (int(mask.sum()), int(mask.any(1).sum()),
                                 int(mask.any(0).sum()))
            del mask
            noid = (_flash_calls(attn, layout, h, scale, causal,
                                 (None, None))[0]
                    if ids[0] is not None else None)
            for i, (name, kind) in enumerate(zip(FLASH_NAMES[layout],
                                                 ("fwd", "dq", "dkv"))):
                args = (qx, kx, vx) if i == 0 else bwd_args
                bound_ms, bound_by = bound(kind, s, s["dtype"], pairs, rows,
                                           cols)
                rec = {
                    "ms": time_ms(lambda: kernels[i](*args), 2, 10),
                    "plain_ms": time_ms(lambda: plains[i](*args), 1, 3),
                    "bound_ms": bound_ms, "bound_by": bound_by,
                    "library_ms": lib_ms["fwd" if kind == "fwd" else "bwd"],
                    "max_abs_err": errs[i][0], "norm_rel_err": errs[i][1],
                    "plan": plan,
                }
                if "backend" in lib_ms:  # PINNED_SDPA: the backend timed
                    rec["library_backend"] = lib_ms["backend"][
                        "fwd" if kind == "fwd" else "bwd"]
                if noid is not None:
                    # The same kernel without ids (no mask) at this shape,
                    # and the id kernel's device time alone (ten launches
                    # replayed from a CUDA graph: no host dispatch).
                    rec["noid_ms"] = time_ms(lambda: noid[i](*args), 2, 10)
                    rec["graph_ms"] = _graph_ms(lambda: kernels[i](*args))
                timed[name, label] = rec
                log(f"kernel {name} [{label}] timing: " + json.dumps(
                    {k: rec[k] for k in ("ms", "plain_ms", "bound_ms",
                                         "bound_by", "library_ms",
                                         "library_backend", "noid_ms",
                                         "graph_ms")
                     if k in rec}))
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
    # to the plain version: fp16, and a head dim past the widest cluster
    # (1025) in either type, whose error names the limit.
    x16 = torch.zeros(1, 64, 2 * 128, device="cuda", dtype=torch.float16)
    x1025 = torch.zeros(1, 64, 2 * 1025, device="cuda")
    limit = f"<= {attn._KERNEL_MAX_D}"
    for bad, err, says in ((x16, TypeError, ""), (x1025, ValueError, limit),
                           (x1025.bfloat16(), ValueError, limit)):
        for fn in (lambda x: attn.flash_fwd(x, x, x, 2, 0.1, True),
                   lambda x: attn.flash_bhsd_fwd(
                       x.reshape(2, 64, -1), x.reshape(2, 64, -1),
                       x.reshape(2, 64, -1), 0.1, True)):
            try:
                fn(bad)
            except err as e:
                if says not in str(e):
                    raise AssertionError(f"the refusal {e!r} does not name "
                                         f"the limit {says!r}") from e
                log(f"kernel flash refuses {bad.dtype} d={bad.shape[2] // 2}: "
                    f"{type(e).__name__}: {e}")
            else:
                raise AssertionError("a flash kernel accepted operands it "
                                     "cannot take")
    timed.update(time_head_pad())

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


# A ragged bf16 head dim at a training size: Qwen3-Next's heads at d=100,
# which the wrappers pad to 104 (and run on the 128 bodies).
PAD_SHAPE = dict(b=2, sq=2048, sk=2048, h=16, hkv=2, d=100, dtype="bf16",
                 causal=True)


def time_head_pad() -> dict:
    """The cost of the wrappers' zero padding of a ragged bf16 head dim:
    each flat kernel's wrapper at PAD_SHAPE (q, k, v and do padded from
    100 to 104 columns a head, out, dq, dk and dv cut back) against the
    same wrapper on inputs already 104 wide (no copy), with the same
    scale. The two forwards' outputs must agree bit for bit on the first
    100 columns. Returns {(kernel, "pad-d100"): {"ms", "unpadded_ms",
    "pad_ms"}}."""
    import torch
    import torch.nn.functional as F

    from mpi_operator_tpu_torch.ops import attention as attn

    s = PAD_SHAPE
    d, h, scale = s["d"], s["h"], s["d"] ** -0.5
    drawn = _flash_draw(s, torch.Generator(device="cuda").manual_seed(5))
    times, outs = {}, {}
    for tag, ts in (("ms", drawn),
                    ("unpadded_ms", [F.pad(t, (0, 104 - d)) for t in drawn])):
        qx, kx, vx, dox = _in_layout(ts, "flat")
        kernels = _flash_calls(attn, "flat", h, scale, True, (None, None))[0]
        out, lse = kernels[0](qx, kx, vx)
        outs[tag] = out.reshape(*lse.shape, -1)[..., :d]
        delta = attn.flat_delta(dox, out, h)
        args = ((qx, kx, vx), (qx, kx, vx, dox, lse, delta))
        for i, name in enumerate(FLASH_NAMES["flat"]):
            times.setdefault(name, {})[tag] = time_ms(
                lambda: kernels[i](*args[min(i, 1)]), 2, 10)
    same = torch.equal(outs["ms"], outs["unpadded_ms"])
    for name, t in times.items():
        t["pad_ms"] = t["ms"] - t["unpadded_ms"]
        log(f"kernel {name} [pad-d100 {s}] timing: " + json.dumps(t))
    log(f"kernel flash_fwd [pad-d100]: padded and 104-wide outputs "
        f"{'bit-identical' if same else 'DIFFER'}")
    if not same:
        raise AssertionError("the padded forward differs from the kernel on "
                             "104-wide inputs")
    return {(name, "pad-d100"): t for name, t in times.items()}


def _graph_ms(fn, launches: int = 10) -> float:
    """Device ms a call of ``fn``: ``launches`` calls captured in one CUDA
    graph (_captured), the replay timed by CUDA events."""
    graph = _captured(lambda: [fn() for _ in range(launches)])
    return time_ms(graph.replay, 1, 5) / launches


def _kernel_record(kernel: str, replaces: str, rec: dict, shape: str,
                   name: str = "") -> dict:
    from mpi_operator_tpu_torch.ops import _build

    source = "mpi_operator_tpu_torch/csrc/" + _build.KERNELS[kernel][0]
    return {"name": name or kernel, "route": "cuda", "source": source,
            "replaces": replaces, "launches": 0, "shape": shape, **rec}


def _pinned_sdpa_ms(label: str, q, k, v, do, causal: bool) -> dict:
    """_sdpa_ms under each fused SDPA backend pinned in turn; the fastest
    forward and the fastest backward among those that take the inputs,
    with the backend each came from under ``backend``."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    best: dict = {"backend": {}}
    for backend in (SDPBackend.CUDNN_ATTENTION, SDPBackend.FLASH_ATTENTION,
                    SDPBackend.EFFICIENT_ATTENTION, SDPBackend.MATH):
        if backend == SDPBackend.MATH and "fwd" in best:
            break  # the unfused backend only where no fused one takes them
        try:
            with sdpa_kernel([backend]):
                ms = _sdpa_ms(q, k, v, do, causal)
        except RuntimeError as e:
            log(f"kernel sdpa [{label}] {backend.name} refuses the inputs: "
                f"{str(e).splitlines()[0][:160]}")
            continue
        log(f"kernel sdpa [{label}] {backend.name} pinned: " + json.dumps(ms))
        for way in ("fwd", "bwd"):
            if way not in best or ms[way] < best[way]:
                best[way], best["backend"][way] = ms[way], backend.name
    if "fwd" not in best:
        raise AssertionError(f"no SDPA backend takes the {label} inputs")
    return best


def _sdpa_ms(q, k, v, do, causal: bool, mask=None) -> dict:
    """Library yardstick, timed here only: SDPA's forward, and its whole
    backward (dq, dk and dv in one call, the yardstick for both backward
    kernels), on the same values in [B, H, S, D]; with ``mask`` (bool
    [Sq, Sk], a ring hop's ids) under that mask."""
    import torch
    import torch.nn.functional as F

    gqa = q.shape[1] != k.shape[1]
    kw = dict(is_causal=causal, enable_gqa=gqa, attn_mask=mask)
    qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))
    out = F.scaled_dot_product_attention(qg, kg, vg, **kw)
    ms = {
        "fwd": time_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, **kw), 2, 10),
        "bwd": time_ms(lambda: torch.autograd.grad(
            out, (qg, kg, vg), do, retain_graph=True), 2, 10),
    }
    del out
    return ms


def check_lse_cotangent() -> None:
    """``flash_attention_bshd_lse`` at a zigzag hop of the sp phase (rank
    1 on rank 0's shard, SP_HOP, bf16) with a nonzero lse cotangent: its
    gradients through the kernels against the plain versions given
    ``delta = rowsum(do * o) - dlse``, and farther from the gradients
    without the cotangent than the tolerance (the path is exercised)."""
    import torch

    from mpi_operator_tpu_torch.ops import attention as attn

    s = SP_HOP
    b, n, h, hkv, d = s["b"], s["sq"], s["h"], s["hkv"], s["d"]
    gen = torch.Generator(device="cuda").manual_seed(3)

    def rand(*shape, dtype=torch.bfloat16):
        return torch.randn(*shape, generator=gen, device="cuda").to(dtype)

    q, do = rand(b, n, h, d), rand(b, n, h, d)
    k, v = rand(b, n, hkv, d), rand(b, n, hkv, d)
    dlse = rand(b, n, h, dtype=torch.float32)
    row, col = _shape_ids(("zigzag", 1, 0))
    grads = []
    for cotangent in (dlse, torch.zeros_like(dlse)):
        qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))
        out, lse = attn.flash_attention_bshd_lse(qg, kg, vg, row_ids=row,
                                                 col_ids=col)
        torch.autograd.backward((out, lse), (do, cotangent))
        grads.append((qg.grad, kg.grad, vg.grad))
    flat = [t.reshape(b, n, -1) for t in (q, k, v, do)]
    delta = attn.flat_delta(flat[3], out.detach().reshape(b, n, -1), h, dlse)
    f32 = [t.float() for t in flat]
    tail = (h, d ** -0.5, False, row, col)
    lse = lse.detach()
    want = (attn.flash_bwd_dq_plain(*f32, lse, delta, *tail),
            *attn.flash_bwd_dkv_plain(*f32, lse, delta, *tail))
    tol = NORM_REL_TOL["bf16"]
    errs = [norm_rel(g.reshape(w.shape), w) for g, w in zip(grads[0], want)]
    moved = norm_rel(grads[1][0], grads[0][0])
    ok = max(errs) <= tol and moved > 10 * tol
    log(f"kernel flat lse cotangent [sp-zigzag-r1-s0]: dq/dk/dv norm_rel_err "
        f"{[f'{e:.3e}' for e in errs]} (tol {tol:.0e}); dq moved by the "
        f"cotangent {moved:.3e} -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the lse cotangent's backward disagrees with "
                             "its plain version")


# Phase kernels_ab (opt-in): the flash kernels of this checkout against
# those of another (its parent, unpacked by the caller), on the same
# inputs in one process. No-id shapes must give bit-identical outputs; the
# id shapes' differences are printed. Each kernel is timed parent, this,
# this, parent.
AB_SHAPES = ("llama", "bert", "padded-gqa", "masked-rows-bf16", "vit",
             "s2s-cross", "id-masked-bf16", "id-random", "id-random-bf16",
             "sp-zigzag-r0-s0", "sp-zigzag-r0-s1", "sp-zigzag-r1-s0",
             "sp-zigzag-r1-s1", "sp-contig-dead", "sp-contig-diag",
             "sp-contig-full", "qwen3next", "padded-gqa-d256",
             "masked-rows-d256-bf16", "id-random-d256-bf16", "d192-bf16",
             "d100-bf16", "sp-zigzag-r0-s0-d256")


def _checkout_kernels(root: Path) -> dict:
    """The flash entry points of the libraries built (by its own
    ``_build.build``, into its own ``_build/``) from the checkout at
    ``root``, loaded with this checkout's argument types."""
    import ctypes

    from mpi_operator_tpu_torch.ops import _build

    names = [n for n in _build.KERNELS if n.startswith("flash")]
    code = ("import json\nfrom mpi_operator_tpu_torch.ops import _build\n"
            f"_build.build({names!r})\n"
            f"print(json.dumps({{n: str(_build.library_path(n)) "
            f"for n in {names!r}}}))")
    import os

    out = subprocess.run([sys.executable, "-c", code], cwd=root, check=True,
                         env={**os.environ, "PYTHONPATH": str(root)},
                         capture_output=True, text=True, timeout=600).stdout
    fns = {}
    for name, path in json.loads(out.strip().splitlines()[-1]).items():
        fn = getattr(ctypes.CDLL(path), name)
        fn.argtypes = _build.KERNELS[name][1]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def ab_flash_kernels(parent: Path) -> None:
    """Phase kernels_ab: see AB_SHAPES."""
    import torch

    from mpi_operator_tpu_torch.ops import _build
    from mpi_operator_tpu_torch.ops import attention as attn

    names = [n for n in _build.KERNELS if n.startswith("flash")]
    mine = {n: _build.kernel(n) for n in names}
    theirs = _checkout_kernels(parent)
    shapes = {label: (s, layouts) for label, s, layouts in FLASH_SHAPES}
    gen = torch.Generator(device="cuda").manual_seed(0)
    failed = []
    try:
        for label in AB_SHAPES:
            s, layouts = shapes[label]
            d, h = s["d"], s["h"]
            ids = _shape_ids(s.get("ids"), s["sq"], s["sk"])
            drawn = _flash_draw(s, gen)
            for layout in layouts:
                qx, kx, vx, dox = _in_layout(drawn, layout)
                kernels = _flash_calls(attn, layout, h, d ** -0.5,
                                       s["causal"], ids)[0]
                _build._entry_points.update(mine)
                out, lse = kernels[0](qx, kx, vx)
                delta = (dox.float() * out.float()).reshape(
                    *lse.shape, d).sum(-1)
                args = [(qx, kx, vx), (qx, kx, vx, dox, lse, delta)]
                args.append(args[1])
                outs, ms = {}, {"parent": [], "this": []}
                for side, fns in (("parent", theirs), ("this", mine),
                                  ("this", mine), ("parent", theirs)):
                    _build._entry_points.update(fns)
                    got = [kernels[i](*args[i]) for i in range(3)]
                    torch.cuda.synchronize()
                    outs.setdefault(side, [t for r in got for t in
                                           (r if isinstance(r, tuple)
                                            else (r,))])
                    ms[side].append([time_ms(lambda: kernels[i](*args[i]),
                                             2, 10) for i in range(3)])
                diffs = [int((a != b).sum()) for a, b in
                         zip(outs["parent"], outs["this"])]
                same = not any(diffs)
                log(f"kernels_ab {layout} [{label}]: outputs (out, lse, dq, "
                    f"dk, dv) differing elements {diffs} -> "
                    f"{'bit-identical' if same else 'DIFFER'}; ms "
                    + json.dumps({side: {n: [round(t[i], 4) for t in ts]
                                         for i, n in enumerate(
                                             FLASH_NAMES[layout])}
                                  for side, ts in ms.items()}))
                if ids[0] is None and not same:
                    failed.append(f"{layout} {label}")
                del outs, args, out, lse, delta, qx, kx, vx, dox
            del drawn
            torch.cuda.empty_cache()
    finally:
        _build._entry_points.update(mine)
    if failed:
        raise AssertionError("kernels without ids differ from the parent's: "
                             + ", ".join(failed))


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


# The norm kernels against their plain versions (tests/test_torch_norm.py's
# tolerances): y (terms |x rstd scale|, |mean rstd scale|, |bias|), dx and
# the statistics within NORM_TOL of their terms' magnitudes (f32 sums in
# another order), y and dx besides within one bf16 ulp where they are
# bf16; dscale and dbias within NORM_TOL of the sum of their terms'
# magnitudes.
NORM_TOL = 1e-5
# (label, rows, width, x dtype, norm): BERT-base's LayerNorm rows (B=64 x
# S=512 tokens of 768), Mixtral's RMSNorm rows (4096 tokens of 4096), and
# a ragged width that no vector divides, both norms.
NORM_SHAPES = [
    ("bert", 32768, 768, "bf16", "layer"),
    ("mixtral", 4096, 4096, "bf16", "rms"),
    ("ragged", 3000, 1003, "bf16", "layer"),
    ("ragged", 3000, 1003, "bf16", "rms"),
]
# One optimizer step of each cell's path, through the trainer, and its
# norm launches (BERT-base's one forward and backward; Mixtral / 2
# layers at the cell's 8 microbatches, the blocks' norms again in the
# remat recompute).
NORM_STEP_ARGS = {
    "bert-base": (_with_steps(BERT_TRAIN_ARGS, 1), _norms(BERT_NORMS, 1)),
    "mixtral-8x7b/2": ([
        "--model", "mixtral-8x7b", "--n-layers", str(MOE_LAYERS),
        "--seq-len", "4096", "--global-batch", "8", "--grad-accum", "8",
        "--xent-chunk", "1024", "--lr", "3e-4", "--steps", "1",
        "--warmup", "1", "--log-every", "1"], _llama_norms(MOE_LAYERS, 8)),
}


def _ulp_bf16(v):
    import torch

    mag = v.abs().float().clamp_min(2.0 ** -126)
    return torch.exp2(torch.floor(torch.log2(mag)) - 7)


def _excess(got, want, tol) -> float:
    """The largest amount by which |got - want| passes tol (<= 0: within)."""
    return float(((got.double() - want.double()).abs() - tol.double()).max())


# The wrappers' host cost: calls timed back to back at 8 rows (the
# device's part a few microseconds, so the host sets the pace), after a
# warm-up, at BERT's and Mixtral's widths.
NORM_HOST_CALLS, NORM_HOST_ROWS = 2000, 8


def norm_host_us(norm, kind: str, d: int) -> dict:
    """Microseconds of host time a call of ``norm.layer_norm`` (``kind``
    'layer') or ``norm.rms_norm`` on bf16 rows of ``d``: the forward
    alone (no grad) and the forward with its backward through autograd,
    as a model's training step calls them."""
    import torch

    x = torch.randn(NORM_HOST_ROWS, d, device="cuda").to(torch.bfloat16)
    scale = torch.ones(d, device="cuda", requires_grad=True)
    bias = torch.zeros(d, device="cuda", requires_grad=True)
    dy = torch.ones_like(x)

    def call(t):
        if kind == "layer":
            return norm.layer_norm(t, scale, bias, 1e-12, torch.bfloat16)
        return norm.rms_norm(t, scale, 1e-5)

    def fwd():
        with torch.no_grad():
            call(x)

    def fwd_bwd():
        call(x.requires_grad_(True)).backward(dy)

    out = {}
    for label, fn in (("fwd_us", fwd), ("fwd_bwd_us", fwd_bwd)):
        for _ in range(100):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(NORM_HOST_CALLS):
            fn()
        out[label] = (time.perf_counter() - t0) / NORM_HOST_CALLS * 1e6
        torch.cuda.synchronize()
    return out


def check_norm_kernels() -> list:
    """norm_fwd and norm_bwd against their plain versions at NORM_SHAPES,
    timed at BERT's and Mixtral's shapes beside the bound, the plain
    version and torch's own layer_norm / rms_norm (a yardstick the port
    never calls); then each kernel's launches over one optimizer step of
    each cell's path. Returns the records."""
    import torch
    import torch.nn.functional as F

    from mpi_operator_tpu_torch.ops import _build, norm

    gen = torch.Generator(device="cuda").manual_seed(3)
    records = []
    for label, m, d, dtype_name, kind in NORM_SHAPES:
        dtype = torch.bfloat16 if dtype_name == "bf16" else torch.float32
        layer = kind == "layer"
        eps = 1e-12 if layer else 1e-5
        x = (torch.randn(m, d, generator=gen, device="cuda") * 2 + 0.5
             ).to(dtype)
        dy = torch.randn(m, d, generator=gen, device="cuda").to(dtype)
        scale = 1 + 0.1 * torch.randn(d, generator=gen, device="cuda")
        bias = 0.1 * torch.randn(d, generator=gen, device="cuda")
        b = bias if layer else None

        y, mean, rstd = norm.norm_fwd(x, scale, b, eps, dtype)
        dx, dscale, dbias = norm.norm_bwd(x, dy, mean, rstd, scale)
        dx2, dscale2, dbias2 = norm.norm_bwd(x, dy, mean, rstd, scale)
        torch.cuda.synchronize()
        same = (torch.equal(dx, dx2) and torch.equal(dscale, dscale2)
                and (dbias is None or torch.equal(dbias, dbias2)))
        if layer:
            y_p = norm.layer_norm_plain(x, scale, bias, eps, dtype)
            mean_p, rstd_p = norm.layer_norm_stats_plain(x, eps)
            xhat = (x.float() - mean_p[:, None]) * rstd_p.abs()[:, None]
            dx_p, dscale_p, dbias_p = norm.layer_norm_bwd_plain(
                x, dy, mean, rstd, scale)
        else:
            y_p = norm.rms_norm_plain(x, scale, eps)
            rstd_p = norm.rms_norm_stats_plain(x, eps)
            xhat = x.float() * rstd_p[:, None]
            dx_p, dscale_p = norm.rms_norm_bwd_plain(x, dy, rstd, scale)
        y_terms = x.float().abs() * rstd_p.abs()[:, None] * scale.abs()
        if layer:
            y_terms += ((mean_p * rstd_p).abs()[:, None] * scale.abs()
                        + bias.abs())
        y_tol = NORM_TOL * y_terms
        y_tol = y_tol + _ulp_bf16(torch.maximum(y.float().abs(),
                                                y_p.float().abs()))
        g = dy.float() * scale
        dx_tol = NORM_TOL * rstd_p.abs()[:, None] * (
            g.abs() + g.abs().mean(dim=-1, keepdim=True) + xhat.abs()
            * (g * xhat).abs().mean(dim=-1, keepdim=True))
        excess = {
            "y": _excess(y, y_p, y_tol),
            "rstd": _excess(rstd, rstd_p, NORM_TOL * rstd_p.abs()),
            "dx": _excess(dx, dx_p, dx_tol + _ulp_bf16(dx_p)),
            "dscale": _excess(dscale, dscale_p, NORM_TOL * (
                dy.float() * xhat).abs().sum(0)),
        }
        if layer:
            excess["mean"] = _excess(mean, mean_p, NORM_TOL * x.float()
                                     .abs().mean(dim=-1))
            excess["dbias"] = _excess(dbias, dbias_p, NORM_TOL * dy.float()
                                      .abs().sum(0))
        del xhat, g, dx_tol, y_tol, y_terms
        ok = same and max(excess.values()) <= 0
        log(f"kernel norm [{label} {kind} [{m}, {d}] {dtype_name}]: largest "
            f"excess over tolerance {json.dumps(excess)}; two backward runs "
            f"bit-identical {same} -> {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"the {kind} norm kernels disagree with "
                                 f"their plain versions at {label}")
        if label == "ragged":
            continue

        # Timed: the kernels, the plain versions, and torch's own norm as a
        # yardstick (weights in x's type; its backward through autograd).
        w, wb = scale.to(dtype), bias.to(dtype)
        xr = x.detach().requires_grad_(True)
        wr = w.detach().requires_grad_(True)
        if layer:
            lib_y = F.layer_norm(xr, (d,), wr, wb, eps)
            lib_fwd = lambda: F.layer_norm(x, (d,), w, wb, eps)
            plain_fwd = lambda: norm.layer_norm_plain(x, scale, bias, eps,
                                                      dtype)
            plain_bwd = lambda: norm.layer_norm_bwd_plain(x, dy, mean, rstd,
                                                          scale)
        else:
            lib_y = F.rms_norm(xr, (d,), wr, eps)
            lib_fwd = lambda: F.rms_norm(x, (d,), w, eps)
            plain_fwd = lambda: norm.rms_norm_plain(x, scale, eps)
            plain_bwd = lambda: norm.rms_norm_bwd_plain(x, dy, rstd, scale)
        es = x.element_size()
        stats_bytes = (2 if layer else 1) * m * 4
        vec_bytes = (2 if layer else 1) * d * 4
        calls = {
            # x in, y and the row statistics out; ~5 FLOPs an element.
            "norm_fwd": (lambda: norm.norm_fwd(x, scale, b, eps, dtype),
                         plain_fwd, lib_fwd,
                         2 * m * d * es + stats_bytes + vec_bytes, 5 * m * d),
            # x, dy and the statistics in, dx and the column sums out;
            # ~12 FLOPs an element.
            "norm_bwd": (lambda: norm.norm_bwd(x, dy, mean, rstd, scale),
                         plain_bwd,
                         lambda: torch.autograd.grad(lib_y, (xr, wr), dy,
                                                     retain_graph=True),
                         3 * m * d * es + stats_bytes + 2 * vec_bytes,
                         12 * m * d),
        }
        for name, (kernel_fn, plain_fn, lib_fn, nbytes, flops) in calls.items():
            t_ops = flops / PEAK_FLOPS["f32"]
            t_bytes = nbytes / PEAK_BYTES_PER_S
            rec = {
                "name": name, "shape": label, "norm": kind,
                "rows": m, "width": d, "dtype": dtype_name,
                "source": "mpi_operator_tpu_torch/csrc/"
                          + _build.KERNELS[name][0],
                "replaces": REPLACES[name],
                "excess": excess,
                "ms": time_ms(kernel_fn, 3, 50),
                "plain_ms": time_ms(plain_fn, 2, 10),
                "bound_ms": max(t_ops, t_bytes) * 1e3,
                "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                "library_ms": time_ms(lib_fn, 3, 50),
            }
            rec["roofline_pct"] = 100 * rec["bound_ms"] / rec["ms"]
            records.append(rec)
            log(f"kernel {name} [{label} {kind}] timing: " + json.dumps(
                {k: rec[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                     "roofline_pct", "library_ms")}))
        del lib_y, xr, wr
    del x, dy, y, dx, dx2, y_p, dx_p
    torch.cuda.empty_cache()
    for kind, d in (("layer", 768), ("rms", 4096)):
        log(f"kernel norm [{kind} {d}] host cost a call: " + json.dumps(
            norm_host_us(norm, kind, d)))

    # A CUDA operand the kernels do not take raises; it never falls back.
    for bad in (torch.zeros(4, 8, device="cuda", dtype=torch.float16),
                torch.zeros(4, 8, device="cuda", dtype=torch.float64)):
        try:
            norm.rms_norm(bad, torch.ones(8, device="cuda"), 1e-5)
        except TypeError as e:
            log(f"kernel norm refuses {bad.dtype}: {e}")
        else:
            raise AssertionError("the norm kernels took a type they cannot")

    # Launches over one optimizer step of each cell's path.
    by_path = {}
    for label, (argv, want) in NORM_STEP_ARGS.items():
        free_card(f"the norm launch count of {label}")
        _, launches = _drive_trainer(argv)
        got = {k: launches[k] for k in want}
        by_path[label] = got
        log(f"kernel norm launches over one {label} step: {got} (want "
            f"{want}) -> {'ok' if got == want else 'FAIL'}")
        if got != want:
            raise AssertionError(f"{label}: the norm kernels launched "
                                 f"{got}, want {want}")
    for rec in records:
        rec["launches_by_path"] = {k: v[rec["name"]]
                                   for k, v in by_path.items()}
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


# Qwen3-Next's attention heads (its full-attention layers: 16 q and 2 kv
# heads of 256) on llama3-8b's width, through config_for's overrides as in
# the JAX package: dim 4096 = 16 x 256, so the attention's cost per token
# is llama3-8b's.
WIDE_HEADS = dict(n_heads=16, n_kv_heads=2)
# DeepSeek-V4-Flash's attention heads (8 q heads of 512 over one kv head,
# its config's num_key_value_heads: 1) on llama3-8b's width: dim 4096 = 8 x
# 512, each head's columns split across a cluster of two blocks.
DEEP_HEADS = dict(n_heads=8, n_kv_heads=1)
# Trainer steps of each of the two runs above (6 until the D=512 run
# joined the model phase).
HEADS_TRAIN_STEPS = 3


def check_model(label: str = "llama3-8b/2 layers", **overrides) -> dict:
    """llama3-8b (with ``overrides``), full width, 2 layers, B=1, S=256:
    loss and gradients through the flat kernels (``flash``) and the
    [B*H, S, D] kernels behind transposes (``flash-bhsd``) against the
    dense oracle on the same weights; each route's launch counters show
    its own kernels and no others. Returns each kernel route's launch
    counts."""
    import torch

    from mpi_operator_tpu_torch.models import llama as lib
    from mpi_operator_tpu_torch.ops import attention as attn

    def config(**kw):
        return lib.config_for("llama3-8b", n_layers=2, xent_chunk=128,
                              **overrides, **kw)

    cfg = config()
    tokens = torch.randint(
        0, cfg.vocab_size, (1, 256), device="cuda",
        generator=torch.Generator(device="cuda").manual_seed(1),
    )
    results = {}
    state = None
    for impl in ("flash", "flash-bhsd", "dense"):
        model = lib.Llama(config(attention_impl=impl), device="cuda")
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
        log(f"model {label} (head dim {cfg.head_dim}) B=1 S=256 {impl}: "
            f"loss kernel={lf:.6f} "
            f"oracle={ld:.6f} rel={loss_rel:.3e} (tol "
            f"{MODEL_LOSS_REL_TOL:.0e}); worst grad norm_rel={worst[0]:.3e} "
            f"at {worst[1]} (tol {MODEL_GRAD_NORM_REL_TOL:.0e}); kernel "
            f"launches {launches} -> {'ok' if ok else 'FAIL'}")
        if not ok:
            failed.append(impl)
    if failed:
        raise AssertionError(f"kernel routes {failed} disagree with the "
                             f"dense oracle")
    launches = {impl: results[impl][2] for impl in ("flash", "flash-bhsd")}
    del results, gd, state
    torch.cuda.empty_cache()
    return launches


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


# ResNet-101's TPU-shaped options against the plain model (model phase).
# space_to_depth: the s2d stem mapped from the plain 7x7 kernel
# (models/resnet.py:s2d_stem_weight) sums the same 147 nonzero products
# a stem output as the 7x7 conv (and 45 exact zeros), in another order:
# each stem output moves by a few f32 ulps (~1e-7 relative). Every BN
# layer's sums move as much between the kernel and the plain BN route,
# so the plain model on those two routes, on the same weights and
# images, measures how far such f32 reorderings carry to the logits, the
# loss and the running statistics of this network; the s2d model may lie
# at most RESNET_ERROR_RATIO times that from the plain model, plus
# RESNET_FLOOR["float32"]. scan_stages: the same operations on the same
# operands in the same order (each stacked kernel's slice keeps the
# plain kernel's channels_last layout), so the logits, loss and stacked
# running statistics are held at SCANNED_TOL, room only for a kernel
# whose order of sums varies run to run.
SCANNED_TOL = 1e-6
# The bf16 step A/B: RESNET_TRAIN_ARGS' model, batch and SGD (B=64,
# 224x224, nesterov momentum 0.9 at 0.1), OPTION_STEPS steps a run, the
# plain, s2d and scanned models in turn OPTION_ROUNDS times; a run's
# step_ms is the mean of its steps after the first, each model's the
# median of its runs.
OPTION_STEPS, OPTION_ROUNDS, OPTION_BATCH = 6, 3, 64


def _option_pass(model, state, images, labels) -> tuple:
    """One train-mode forward and backward of ``model`` from ``state``,
    with the launch counters set to 0 just before and read just after:
    (logits, loss, running statistics by name, BN launches)."""
    import torch

    from mpi_operator_tpu_torch.ops import bn

    model.load_state_dict(state)
    model.train()
    _reset_all_launch_counts()
    logits = model(images)
    loss = torch.nn.functional.cross_entropy(logits, labels)
    loss.backward()
    torch.cuda.synchronize()
    launches = dict(bn.LAUNCHES)
    return (logits.detach(), float(loss.detach()),
            {n: b.clone() for n, b in model.named_buffers()}, launches)


def _stats_error(got: dict, want: dict) -> float:
    """The running statistics' error: each mean against its channel's
    running standard deviation, each variance relative (as
    ``_resnet_errors``)."""
    worst = 0.0
    for name, var in want.items():
        if name.endswith(".var"):
            mean = name[:-len("var")] + "mean"
            scale = var.double().sqrt()
            worst = max(worst, float(
                ((got[mean] - want[mean]).double().abs() / scale).max()),
                float(((got[name] - var).double().abs()
                       / var.double()).max()))
    return worst


def _option_steps(model, images, labels, steps: int) -> dict:
    """``steps`` SGD steps of ``model`` as the trainer builds them, with
    the launch counters set to 0 just before and read just after:
    losses, the mean step_ms after the first step, launches."""
    import torch

    from mpi_operator_tpu_torch.models import resnet as lib
    from mpi_operator_tpu_torch.utils.torchtrace import host_read

    optimizer = torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9,
                                nesterov=True, dampening=0, weight_decay=0)
    step = lib.make_train_step(model, optimizer)
    losses, times = [], []
    _reset_all_launch_counts()
    for _ in range(steps):
        t0 = time.perf_counter()
        loss = step(images, labels)
        losses.append(host_read(loss))  # a host sync a step
        times.append((time.perf_counter() - t0) * 1e3)
    return {"losses": losses, "step_ms": sum(times[1:]) / (steps - 1),
            "launches": _all_launch_counts()}


def _stem_ms(images) -> dict:
    """The stem alone, forward and the kernel's backward (the images take
    no gradient), bf16, by CUDA events: the plain 7x7 stride-2 conv on 3
    channels, and the regroup, its (2, 1) pad and the 4x4 stride-1 conv
    on 12."""
    import torch
    import torch.nn.functional as F

    from mpi_operator_tpu_torch.models import resnet as lib

    out = {}
    x = images.to(torch.bfloat16)
    for name, k, cin, stride, pad in (("plain 7x7/2", 7, 3, 2, 3),
                                      ("s2d 4x4/1", 4, 12, 1, 0)):
        conv = lib.Conv(cin, 64, k, stride, padding=pad, device="cuda")
        torch.nn.init.normal_(conv.weight, std=0.05)
        s2d = name.startswith("s2d")

        def fwd_bwd(conv=conv, s2d=s2d):
            y = F.pad(lib.space_to_depth(x), (2, 1, 2, 1)) if s2d else x
            conv(y).float().sum().backward()
            conv.weight.grad = None

        out[name] = time_ms(fwd_bwd, 3, 20)
    return out


def check_resnet_options() -> dict:
    """ResNet-101 with ``space_to_depth`` and with ``scan_stages`` against
    the plain model, through the BN kernels: (1, 2) B=8, 224x224, f32,
    one train-mode pass each from the plain model's weights (the s2d stem
    mapped by ``s2d_stem_weight``, the scanned stages stacked by
    ``stack_stages``): logits, loss and running statistics (stacked, for
    the scanned model) held to the plain pass, 104/104 BN launches a
    pass; (3) B=64 bf16, OPTION_STEPS SGD steps each of plain, s2d and
    scanned in turn, OPTION_ROUNDS rounds: loss finite and falling,
    104/104 launches a step, step_ms beside the plain model's; (4) the
    stem alone. Returns the BN launch counts by path."""
    import statistics

    import numpy as np
    import torch

    from mpi_operator_tpu_torch.models import resnet as lib

    t_phase = time.perf_counter()
    card = card_line()
    rng = np.random.RandomState(1)
    images = torch.as_tensor(
        rng.standard_normal((8, 224, 224, 3)).astype(np.float32),
        device="cuda").permute(0, 3, 1, 2)
    labels = torch.as_tensor(rng.randint(0, 1000, (8,)), device="cuda")
    make = lambda **kw: lib.resnet(101, dtype=torch.float32,
                                   bn_impl="pallas", device="cuda", **kw)
    plain = make()
    gen = torch.Generator(device="cuda").manual_seed(0)
    lib.init_params(plain, gen)
    with torch.no_grad():
        for mod in lib.bn_layers(plain):
            mod.scale.uniform_(0.5, 1.5, generator=gen)
    state = {k: v.detach().clone() for k, v in plain.state_dict().items()}
    want = _option_pass(plain, state, images, labels)
    del plain

    def errors(got, stats_want) -> dict:
        return {"logits": norm_rel(got[0], want[0]),
                "loss": abs(got[1] - want[1]) / abs(want[1]),
                "stats": _stats_error(got[2], stats_want)}

    route = errors(_option_pass(lib.resnet(101, dtype=torch.float32,
                                           device="cuda"),
                                state, images, labels), want[2])
    s2d_state = dict(state)
    s2d_state["conv_init.weight"] = lib.s2d_stem_weight(
        state["conv_init.weight"])
    per_pass = {"bn_stats": RESNET_BN_LAYERS, "bn_grads": RESNET_BN_LAYERS}
    arms = {"s2d": (dict(space_to_depth=True), s2d_state,
                    {k: RESNET_ERROR_RATIO * v + RESNET_FLOOR["float32"]
                     for k, v in route.items()}),
            "scanned": (dict(scan_stages=True), lib.stack_stages(state),
                        dict.fromkeys(route, SCANNED_TOL))}
    log(f"model resnet101 B=8 224x224 f32, the plain model's kernel BN route "
        f"vs its plain BN route (the scale of an f32 reordering): "
        f"{json.dumps({k: f'{v:.3e}' for k, v in route.items()})}")
    launches, failed = {}, []
    for arm, (kw, arm_state, tol) in arms.items():
        got = _option_pass(make(**kw), arm_state, images, labels)
        stats_want = (lib.stack_stages(want[2]) if arm == "scanned"
                      else want[2])
        err = errors(got, stats_want)
        ok = (all(err[k] <= tol[k] for k in err)
              and sorted(got[2]) == sorted(stats_want)
              and got[3] == per_pass == want[3])
        launches[f"resnet101 {arm} pass"] = got[3]
        log(f"model resnet101 {arm} B=8 224x224 f32 vs the plain model on "
            f"the same weights: logits {err['logits']:.3e} (norm-rel), loss "
            f"{err['loss']:.3e}, running stats {err['stats']:.3e} (tol "
            f"{json.dumps({k: f'{v:.3e}' for k, v in tol.items()})}); BN "
            f"launches a pass {got[3]} (plain {want[3]}, want {per_pass}) "
            f"-> {'ok' if ok else 'FAIL'}")
        if not ok:
            failed.append(arm)
        torch.cuda.empty_cache()
    del want

    rng = np.random.RandomState(0)
    images = torch.as_tensor(rng.standard_normal(
        (OPTION_BATCH, 224, 224, 3)).astype(np.float32),
        device="cuda").permute(0, 3, 1, 2)
    labels = torch.as_tensor(rng.randint(0, 1000, (OPTION_BATCH,)),
                             device="cuda")
    models = {}
    for arm, kw in (("plain", {}), ("s2d", dict(space_to_depth=True)),
                    ("scanned", dict(scan_stages=True))):
        model = lib.resnet(101, bn_impl="pallas", device="cuda", **kw)
        lib.init_params(model, torch.Generator(device="cuda").manual_seed(0))
        models[arm] = model
    runs = {arm: [] for arm in models}
    for _ in range(OPTION_ROUNDS):
        for arm, model in models.items():
            runs[arm].append(_option_steps(model, images, labels,
                                           OPTION_STEPS))
    step_want = _want_launches({k: RESNET_BN_LAYERS * OPTION_STEPS
                                for k in ("bn_stats", "bn_grads")})
    step_ms = {arm: statistics.median(r["step_ms"] for r in rs)
               for arm, rs in runs.items()}
    for arm, rs in runs.items():
        first = rs[0]["losses"]
        ok = (all(math.isfinite(x) for r in rs for x in r["losses"])
              and first[-1] < first[0]
              and all(r["launches"] == step_want for r in rs))
        launches[f"resnet101 {arm} {OPTION_STEPS} steps"] = rs[0]["launches"]
        log(f"model resnet101 {arm} bf16 B={OPTION_BATCH} SGD: losses "
            f"{[round(x, 4) for x in first]} (first run); launches a run "
            f"{[r['launches'] for r in rs]} (want {step_want}); step_ms by "
            f"run {[round(r['step_ms'], 2) for r in rs]}, median "
            f"{step_ms[arm]:.2f} against the plain model's "
            f"{step_ms['plain']:.2f} ({step_ms[arm] / step_ms['plain']:.3f}x)"
            f"; card {card} -> {'ok' if ok else 'FAIL'}")
        if not ok:
            failed.append(f"{arm} steps")
    del models
    torch.cuda.empty_cache()
    stem = _stem_ms(images)
    log(f"model resnet101 stem alone, B={OPTION_BATCH} 224x224 bf16, forward "
        f"+ weight backward by CUDA events: "
        f"{json.dumps({k: round(v, 4) for k, v in stem.items()})} ms; card "
        f"{card}")
    log(f"model resnet101 options done in "
        f"{time.perf_counter() - t_phase:.1f} s")
    if failed:
        raise AssertionError(f"ResNet option checks failed: {failed}")
    del images
    torch.cuda.empty_cache()
    return launches


def _reset_all_launch_counts() -> None:
    from mpi_operator_tpu_torch.ops import attention as attn
    from mpi_operator_tpu_torch.ops import bn, norm

    attn.reset_launch_counts()
    bn.reset_launch_counts()
    norm.reset_launch_counts()


def _all_launch_counts() -> dict:
    from mpi_operator_tpu_torch.ops import attention as attn
    from mpi_operator_tpu_torch.ops import bn, norm

    return {**attn.LAUNCHES, **bn.LAUNCHES, **norm.LAUNCHES}


def _want_launches(counts: dict) -> dict:
    """Every launch counter: 0, except ``counts``."""
    return {**{k: 0 for k in _all_launch_counts()}, **counts}


def _drive_trainer(argv) -> tuple[dict, dict]:
    """``cmd.train.main(argv)`` with every launch counter (the flash, BN
    and norm kernels') set to 0 just before it and read just after; returns (summary line with the peak
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


@contextlib.contextmanager
def _llama3_8b_with(**overrides):
    """``--model llama3-8b`` of the trainer built with ``overrides`` to
    its config (cmd.train has no flag for them, as the JAX CLI has none)."""
    from mpi_operator_tpu_torch.models import llama as lib

    saved = lib.CONFIGS["llama3-8b"]
    lib.CONFIGS["llama3-8b"] = lambda **kw: saved(**overrides, **kw)
    try:
        yield
    finally:
        lib.CONFIGS["llama3-8b"] = saved


def run_heads_llama_train(label: str, heads: dict) -> dict:
    """The trainer's Llama run (TRAIN_ARGS: 2 layers, B=2, S=2048) with
    ``heads`` (WIDE_HEADS: the 256-wide flash bodies; DEEP_HEADS: the
    column split), HEADS_TRAIN_STEPS AdamW steps: loss finite and falling,
    launches 4/2/2 a step. Returns the launch counts."""
    with _llama3_8b_with(**heads):
        return run_train(_with_steps(TRAIN_ARGS, HEADS_TRAIN_STEPS),
                         label=label)[1]


def run_train(argv=TRAIN_ARGS, label: str = "llama3-8b") -> tuple[dict, dict]:
    """The trainer's own entry point; returns (summary with each step's
    loss under ``curve``, launch counts)."""
    from mpi_operator_tpu_torch.cmd import train

    curve = []
    with _recorded(train, curve):
        summary, launches = _drive_trainer(argv)
    summary["curve"] = [float(x) for x in curve]
    # MFU, PaLM-appendix accounting with 2 x MAC FLOPs: 6 x the matmul
    # parameters (2 layers + the LM head) + 6 L d S for causal attention,
    # per token, against the bf16 dense peak.
    from mpi_operator_tpu_torch.models import llama as lib

    cfg = lib.config_for("llama3-8b", n_layers=2)
    hd, seq = cfg.head_dim, 2048
    per_layer = (cfg.dim * (cfg.n_heads + 2 * cfg.n_kv_heads) * hd
                 + cfg.n_heads * hd * cfg.dim + 3 * cfg.dim * cfg.ffn_dim)
    n_matmul = cfg.n_layers * per_layer + cfg.dim * cfg.vocab_size
    flops_per_token = 6 * n_matmul + 6 * cfg.n_layers * cfg.dim * seq
    summary["mfu_bf16_peak"] = (
        summary["tokens_per_sec"] * flops_per_token / PEAK_FLOPS["bf16"])
    log(f"train {label} summary: " + json.dumps(summary))
    layers, steps = 2, summary["steps"]
    # Under remat 'full' each layer's forward runs again in the backward;
    # 'dots' keeps the flash forward's (out, lse).
    forwards = 1 if "dots" in argv else 2
    want = _want_launches({"flash_fwd": forwards * layers * steps,
                           "flash_bwd_dq": layers * steps,
                           "flash_bwd_dkv": layers * steps,
                           **_llama_norms(layers, steps)})
    ok = (steps == int(argv[argv.index("--steps") + 1])
          and math.isfinite(summary["loss"])
          and summary["loss"] < summary["first_loss"] and launches == want)
    log(f"train {label} launches {launches} (want {want}); loss "
        f"{summary['first_loss']:.4f} -> {summary['loss']:.4f} -> "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("training run failed its checks")
    return summary, launches


DOTS_TRAIN_ARGS = TRAIN_ARGS + ["--remat-policy", "dots"]


def run_train_dots(full: dict) -> dict:
    """The Llama arm with ``--remat-policy dots`` (launches 12/12/12: the
    flash forward once a layer a step), then ``full`` again: the dots
    curve must lie within the two full runs' spread (their largest
    difference over the steps, floored at 1e-6 of the loss: the
    policies compute the same numbers, so only the backward's atomics
    move them). Prints step_ms and peak memory beside full's. Returns
    the dots run's launch counts."""
    import torch

    dots, launches = run_train(DOTS_TRAIN_ARGS)
    torch.cuda.empty_cache()
    again, _ = run_train()
    torch.cuda.empty_cache()
    pairs = list(zip(full["curve"], again["curve"]))
    spread = max(abs(a - b) for a, b in pairs)
    gaps = [min(abs(d - a), abs(d - b))
            for d, (a, b) in zip(dots["curve"], pairs)]
    ok = (len(dots["curve"]) == len(pairs) == 6
          and all(g <= spread + 1e-6 * abs(a)
                  for g, (a, _) in zip(gaps, pairs)))
    log(f"train llama3-8b --remat-policy dots: curve {dots['curve']} "
        f"against full {full['curve']} and {again['curve']} (spread "
        f"{spread:.3e}, dots off the nearer by at most {max(gaps):.3e}); "
        f"step_ms {dots['step_ms']} against full {full['step_ms']} and "
        f"{again['step_ms']}; peak {dots['peak_mem_gb']:.2f} GB against "
        f"{full['peak_mem_gb']:.2f} and {again['peak_mem_gb']:.2f}; "
        f"launches {launches} -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the dots arm left the full runs' spread")
    return launches


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
    want = _want_launches({**{k: BERT_LAYERS * steps
                              for k in FLASH_NAMES["flat"]},
                           **_norms(BERT_NORMS, steps)})
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


def run_flat_train(label: str, argv, n_calls: int, n_norms: int,
                   flops_per_example: float) -> tuple[dict, dict]:
    """The trainer's own entry point on a model whose every attention call
    takes the flat flash kernels (``n_calls`` a step): a finite, falling
    loss over 6 steps and exactly ``n_calls`` x 6 launches of each flat
    kernel, ``n_norms`` x 6 of each norm kernel and none of any other;
    returns (the summary line with MFU,
    ``flops_per_example`` per example fwd + bwd at the bf16 peak; the
    launch counts)."""
    import torch

    summary, launches = _drive_trainer(argv)
    summary["mfu_bf16_peak"] = (summary["examples_per_sec"]
                                * flops_per_example / PEAK_FLOPS["bf16"])
    steps = summary["steps"]
    want = _want_launches({**{k: n_calls * steps
                              for k in FLASH_NAMES["flat"]},
                           **_norms(n_norms, steps)})
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
                                   VIT_NORMS,
                                   3 * vit.flops_per_image(vit.vit_base())),
        "seq2seq-small": run_flat_train(
            "seq2seq-small", S2S_TRAIN_ARGS, S2S_ATTENTION_CALLS, S2S_NORMS,
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
    and read just after: 12 x 3 launches of each [B*H, S, D] kernel, 26 x
    3 of each norm kernel, 0 of any other. Steps 2-3 are timed."""
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
    want = _want_launches({**{k: BERT_LAYERS * 3 for k in FLASH_NAMES["bhsd"]},
                           **_norms(BERT_NORMS, 3)})
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
                           "flash_bwd_dkv": layers * steps,
                           **_llama_norms(layers, steps)})
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
        out[name] = hist.sample_stats()
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
                {**{k: BERT_LAYERS * 4 for k in FLASH_NAMES["flat"]},
                 **_norms(BERT_NORMS, 4)})
            and r_launches == _want_launches(
                {**{k: BERT_LAYERS * 2 for k in FLASH_NAMES["flat"]},
                 **_norms(BERT_NORMS, 2)}))
        steps_ok = ((straight["final_step"], straight["steps"]) == (4, 4)
                    and first["final_step"] == 2
                    and (resumed["final_step"], resumed["steps"]) == (4, 2))
        log(f"resume bert-base {manager}: straight loss "
            f"{straight['loss']:.6f} step_ms {straight['step_ms']}; resumed "
            f"final_step {resumed['final_step']} steps {resumed['steps']} "
            f"loss {resumed['loss']:.6f}; checkpoint "
            f"{size / 1e9:.3f} GB a step; snapshot and write seconds "
            f"(saves, total) {json.dumps(seconds)}; launches straight "
            f"{s_launches}, resumed {r_launches}: ok {counts_ok}")
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
    want = _want_launches({"flash_fwd": 2 * 3,
                           **_llama_norms(2, 3, backward=False)})
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
    norms = _llama_norms(2, EVAL_BATCHES, backward=False)
    want = _want_launches({"flash_fwd": 2 * EVAL_BATCHES, **norms})
    ok = (math.isfinite(lf) and rel <= MODEL_LOSS_REL_TOL
          and launches == want and dense_launches == _want_launches(norms)
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
                           "flash_bwd_dkv": MOE_LAYERS * steps,
                           **_llama_norms(MOE_LAYERS, steps)})
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
    # Every step runs the whole model on one position: its norms and no
    # flash kernel.
    want_gen = _want_launches(_llama_norms(cfg.n_layers, s0 + max_new - 1,
                                           backward=False))
    want_fwd = _want_launches({"flash_fwd": cfg.n_layers, **_llama_norms(
        cfg.n_layers, 1, backward=False)})
    ok = (out.shape == (b, s0 + max_new) and torch.equal(out[:, :s0], prompt)
          and int(out.min()) >= 0 and int(out.max()) < cfg.vocab_size
          and rel <= DECODE_LOGITS_TOL and gen_launches == want_gen
          and fwd_launches == want_fwd)
    log(f"decode {label}: " + json.dumps(rec))
    log(f"decode {label}: {step_ms:.3f} ms a step ({rec['new_tokens_per_s']:.1f}"
        f" new tokens/s; bound {bound_ms:.3f} ms), idle "
        f"{rec['device_idle_share']:.3f}; teacher-forced logits vs the "
        f"forward norm-rel {rel:.3e} (tol {DECODE_LOGITS_TOL:.0e}), argmax "
        f"agreement {agree:.4f}; launches generate {gen_launches} (want "
        f"{want_gen}), forward {fwd_launches} (want {want_fwd}) -> "
        f"{'ok' if ok else 'FAIL'}")
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
    # The forward's norms launch the kernels; generate's steps
    # (models/seq2seq_generate.py) normalise in plain ops.
    want_fwd = _want_launches({"flash_fwd": calls, **_norms(
        2 * cfg.n_enc_layers + 3 * cfg.n_dec_layers + 2, 1, backward=False)})
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


# cmd.generate's runs on the llama-tiny and llama-moe-tiny checkpoints:
# prompts of 3 tokens, 8 new, so 10 steps through the 2 layers, each
# launching the norm kernels and no other.
CLI_DECODE_NORMS = _llama_norms(2, 3 + 8 - 1, backward=False)


def _decode_cli(tmp: Path) -> dict:
    """``python -m mpi_operator_tpu_torch.cmd.generate`` end to end on the
    card: llama-tiny and llama-moe-tiny checkpoints the trainer writes
    here (2 steps), two prompts of 3 tokens, 8 new; the tokens equal the
    same command's on the CPU (f32 both; only the order of sums differs)
    and the command launches the norm kernels (CLI_DECODE_NORMS) alone. The two commands run side by
    side, beside this process's own runs of the same argv."""
    out, runs = {}, {}
    for name in ("llama-tiny", "llama-moe-tiny"):
        ck = tmp / f"gen-{name}"
        _drive_trainer(["--model", name, "--steps", "2", "--warmup", "1",
                        "--global-batch", "8", "--seq-len", "16", "--lr",
                        "1e-3", "--checkpoint-dir", str(ck), "--save-every",
                        "1", "--log-every", "1"])
        runs[name] = ["--checkpoint-dir", str(ck), "--model", name,
                      "--prompt", "12,7,42", "--prompt", "3,9,27",
                      "--max-new", "8"]
    procs = {}
    try:
        for name, argv in runs.items():
            cmd = [sys.executable, "-m",
                   "mpi_operator_tpu_torch.cmd.generate", *argv]
            procs[name] = (cmd, time.perf_counter(), subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True, cwd=str(Path(__file__).parent)))
        for name, argv in runs.items():
            _reset_all_launch_counts()
            inproc = _generate_lines(argv)
            launches = _all_launch_counts()
            cpu = _generate_lines([*argv, "--device", "cpu"])
            cmd, t0, proc = procs[name]
            stdout, stderr = proc.communicate(timeout=300)
            wall = time.perf_counter() - t0
            if proc.returncode != 0:
                raise AssertionError(f"{cmd} exited {proc.returncode}:\n"
                                     f"{stderr[-4000:]}")
            card = [json.loads(line) for line in stdout.splitlines()
                    if line.startswith("{")]
            ok = (len(card) == 2 and card == inproc
                  and [line["tokens"] for line in card]
                  == [line["tokens"] for line in cpu]
                  and all(line["step"] == 2 and len(line["new"]) == 8
                          and line["tokens"][:3] == line["prompt"]
                          for line in card)
                  and launches == _want_launches(CLI_DECODE_NORMS))
            log(f"decode cmd.generate {name} ({wall:.1f} s as a process, "
                f"beside the other): {json.dumps(card)}; CPU tokens "
                f"{[line['tokens'] for line in cpu]}; launches {launches} "
                f"-> {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(
                    f"cmd.generate on {name} failed its checks")
            out[f"cmd.generate {name}"] = launches
    finally:
        for _, _, proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
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


# Phase decode_world: sharded decoding on two processes over gloo (the
# world phase's gang), each rank holding only its slices of seeded
# parameters drawn one tensor at a time (models/generate.py), against
# one process decoding the same parameters. B=4, a 16-token prompt, 16
# new tokens, greedy.
DECODE_WORLD_BATCH, DECODE_WORLD_PROMPT, DECODE_WORLD_NEW = 4, 16, 16
# A greedy token may flip between the ranks and one process only where
# the one-process top-2 logits lie closer than this: the f32 tp and ep
# sums add the partial products in another order than one process's
# GEMM (bf16 operands, f32 sums, one bf16 rounding of the output either
# way), a few units of 2^-9 of a logit of order 10 apart at worst.
DECODE_NEAR_TIE = 0.05
# arm -> (model, config overrides, mesh); each arm's bytes all-reduced a
# token a rank, exactly: an f32 [B, dim] partial a row-parallel product
# (attention's wo when tp splits the heads, the MLP's down or the
# experts' combine).
DECODE_WORLD_ARMS = {
    "llama3-8b tp=2": ("llama3-8b", {}, "tp=2"),
    "mixtral-8x7b ep=2": ("mixtral-8x7b", {"n_layers": MOE_LAYERS}, "ep=2"),
    "mixtral-8x7b tp=2": ("mixtral-8x7b", {"n_layers": MOE_LAYERS}, "tp=2"),
}
DECODE_WORLD_SUMS = {"llama3-8b tp=2": 2, "mixtral-8x7b ep=2": 1,
                     "mixtral-8x7b tp=2": 2}  # all-reduces a layer
# cmd.generate's gangs: model -> meshes.
DECODE_CLI_MESHES = {"llama-tiny": ("dp=2", "tp=2", "fsdp=2"),
                     "llama-moe-tiny": ("dp=2", "tp=2", "fsdp=2", "ep=2")}


def _world_prompt(vocab: int):
    import numpy as np
    import torch

    return torch.as_tensor(np.random.RandomState(9).randint(
        0, vocab, (DECODE_WORLD_BATCH, DECODE_WORLD_PROMPT)))


def _decode_reference(model: str, overrides: dict, path: Path) -> dict:
    """One process decoding ``model`` from the seeded parameters, drawn
    and cast a tensor at a time as a rank draws them: greedy tokens, ms a
    step, the teacher-forced logits of those tokens (the logits the
    greedy run picked from) and their top-2 gaps, saved at ``path`` for
    the ranks; returns the record."""
    import gc

    import torch

    from mpi_operator_tpu_torch.models import generate as gen
    from mpi_operator_tpu_torch.models import llama as lib

    cfg = lib.config_for(model, **overrides)
    torch.cuda.reset_peak_memory_stats()
    weights = gen.shard_decode_weights(
        cfg, gen.seeded_params(cfg, torch.Generator(
            device="cuda").manual_seed(0)), gen.DecodeShards(), "cuda")
    prompt = _world_prompt(cfg.vocab_size).cuda()
    gen.generate(cfg, prompt[:, :2], max_new=2, weights=weights)  # warm
    torch.cuda.synchronize()
    _reset_all_launch_counts()
    t0 = time.perf_counter()
    out = gen.generate(cfg, prompt, max_new=DECODE_WORLD_NEW,
                       weights=weights)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _all_launch_counts()
    logits = gen.decode_logits_teacher_forced(cfg, out, weights)
    top2 = logits.topk(2, dim=-1).values
    peak = torch.cuda.max_memory_allocated() / 1e9
    torch.save({"tokens": out.cpu(), "logits": logits.cpu(),
                "gap": (top2[..., 0] - top2[..., 1]).cpu()}, path)
    del weights, logits, top2
    gc.collect()
    torch.cuda.empty_cache()
    steps = DECODE_WORLD_PROMPT + DECODE_WORLD_NEW - 1
    rec = {"ms_per_step": wall * 1e3 / steps, "peak_gb": peak,
           "launches": launches}
    log(f"decode_world one process {model}: {json.dumps(rec)}")
    return rec


def _greedy_agreement(got, want, gap) -> tuple[bool, list]:
    """Each row's tokens against the one-process tokens: equal up to its
    first generated position whose one-process top-2 gap is below
    DECODE_NEAR_TIE (past it a flip may lead anywhere). Returns (ok,
    each row's first such position, None for "all equal" rows that need
    none, or the first differing one)."""
    s0 = DECODE_WORLD_PROMPT
    ok, where = True, []
    for g, w, gp in zip(got.tolist(), want.tolist(), gap.tolist()):
        # The token at position t + 1 is the argmax of the logits at t.
        ties = [t + 1 for t in range(s0 - 1, len(w) - 1)
                if gp[t] < DECODE_NEAR_TIE]
        limit = ties[0] if ties else len(w)
        ok = ok and g[:limit] == w[:limit]
        first = next((i for i, (a, b) in enumerate(zip(g, w)) if a != b), None)
        where.append("all equal" if first is None else
                     f"first differs at {first}, first near-tie at "
                     f"{ties[0] if ties else None}")
    return ok, where


def decode_world_rank(model: str, overrides: dict, mesh: str,
                      reference: str) -> dict:
    """A rank of the decode-world gang (an op job): its slices of the
    seeded parameters, its greedy decode against the one-process tokens,
    the teacher-forced logits of those tokens against one process's, ms a
    step, the bytes one step all-reduces and its peak memory."""
    import gc

    import torch

    from mpi_operator_tpu_torch.cmd.train import parse_mesh_spec
    from mpi_operator_tpu_torch.launcher import bootstrap
    from mpi_operator_tpu_torch.models import generate as gen
    from mpi_operator_tpu_torch.models import llama as lib
    from mpi_operator_tpu_torch.parallel.mesh import create_mesh

    rdzv = bootstrap.initialize(device_type="cuda")
    device = bootstrap.process_device(rdzv.process_id, "cuda")
    cfg = lib.config_for(model, **overrides)
    shards = gen.DecodeShards.of(
        create_mesh(device=device, **parse_mesh_spec(mesh)), cfg)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    weights = gen.shard_decode_weights(
        cfg, gen.seeded_params(cfg, torch.Generator(
            device=device).manual_seed(0)), shards, device)
    build_s = time.perf_counter() - t0
    held_gb = sum(t.numel() * t.element_size()
                  for t in weights.values()) / 1e9
    ref = torch.load(reference)
    prompt = ref["tokens"][:, :DECODE_WORLD_PROMPT].to(device)
    gen.generate(cfg, prompt[:, :2], max_new=2, weights=weights,
                 shards=shards)  # warm
    torch.cuda.synchronize()
    _reset_all_launch_counts()
    t0 = time.perf_counter()
    out = gen.generate(cfg, prompt, max_new=DECODE_WORLD_NEW,
                       weights=weights, shards=shards)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _all_launch_counts()
    lo, hi = shards.rows(DECODE_WORLD_BATCH)
    dec = gen.Decoder(cfg, hi - lo, 2, weights, shards)
    counter = _collective_counter()
    with counter, torch.no_grad():
        dec.step(prompt[lo:hi, 0], 0)
    del dec
    logits = gen.decode_logits_teacher_forced(
        cfg, ref["tokens"].to(device), weights, shards).cpu()
    rel = norm_rel(logits, ref["logits"][lo:hi])
    ok, where = _greedy_agreement(out.cpu(), ref["tokens"], ref["gap"])
    peak = torch.cuda.max_memory_allocated() / 1e9
    del weights, logits
    gc.collect()
    torch.cuda.empty_cache()
    steps = DECODE_WORLD_PROMPT + DECODE_WORLD_NEW - 1
    return {"line": None, "ms_per_step": wall * 1e3 / steps,
            "new_tokens_per_s": DECODE_WORLD_BATCH * steps / wall,
            "build_s": build_s, "held_gb": held_gb, "peak_gb": peak,
            "step_bytes": counter.bytes, "teacher_forced_norm_rel": rel,
            "tokens_ok": ok, "where": where, "launches": launches}


def _tiny_checkpoints(tmp: Path) -> dict:
    """llama-tiny and llama-moe-tiny checkpoints of seeded f32 parameters
    (step 2), as the trainer would save them: name -> directory."""
    import torch

    from mpi_operator_tpu_torch.models import llama as lib
    from mpi_operator_tpu_torch.utils.checkpoint import CheckpointManager

    out = {}
    for name in DECODE_CLI_MESHES:
        model = lib.Llama(lib.config_for(name), device="cpu")
        lib.init_params(model, torch.Generator().manual_seed(5))
        out[name] = str(tmp / f"world-gen-{name}")
        CheckpointManager(out[name]).save(
            2, {"params": {k: v.detach() for k, v in
                           model.state_dict().items()}}, force=True)
    return out


def run_decode_world(tmp: Path) -> dict:
    """Phase ``decode_world``: each arm of DECODE_WORLD_ARMS on two
    processes over gloo against one process decoding the same seeded
    parameters (logits at DECODE_LOGITS_TOL, greedy tokens to the first
    near-tie), then ``cmd.generate`` gangs on tiny checkpoints against the
    one-process command (f32, tokens equal, process 0 alone printing).
    No arm launches a kernel but the norms', one a norm a step on each
    rank. Returns each path's launch counts."""
    refs, one = {}, {}
    for arm, (model, overrides, _) in DECODE_WORLD_ARMS.items():
        if model not in refs:
            refs[model] = str(tmp / f"ref-{model}.pt")
            one[model] = _decode_reference(model, overrides,
                                           Path(refs[model]))
    ckpts = _tiny_checkpoints(tmp)
    base = {name: ["--device", "cuda", "--checkpoint-dir", ck, "--model",
                   name, "--prompt", "12,7,42", "--prompt", "3,9,27",
                   "--max-new", "8"] for name, ck in ckpts.items()}
    _reset_all_launch_counts()
    cli_one = {name: _generate_lines(argv) for name, argv in base.items()}
    cli_launches = _all_launch_counts()
    jobs = [{"cmd": "op", "fn": "decode_world_rank",
             "args": {"model": model, "overrides": overrides, "mesh": mesh,
                      "reference": refs[model]}}
            for model, overrides, mesh in DECODE_WORLD_ARMS.values()]
    cli = [(name, mesh) for name, meshes in DECODE_CLI_MESHES.items()
           for mesh in meshes]
    jobs += [{"cmd": "generate", "argv": [*base[name], "--mesh", mesh]}
             for name, mesh in cli]
    free_card("the decode_world phase")
    ranks = _run_gang(jobs)
    cli_norms = _want_launches(CLI_DECODE_NORMS)
    want_cli = _want_launches(
        {k: len(base) * n for k, n in CLI_DECODE_NORMS.items()})
    ok = cli_launches == want_cli
    log(f"decode_world cmd.generate in this process, both models: launches "
        f"{cli_launches} (want {want_cli}) -> {'ok' if ok else 'FAIL'}")
    paths = {}
    for i, (arm, (model, _, _)) in enumerate(DECODE_WORLD_ARMS.items()):
        recs = [r[i] for r in ranks]
        layers = DECODE_WORLD_ARMS[arm][1].get("n_layers", 32)
        want = _want_launches(_llama_norms(
            layers, DECODE_WORLD_PROMPT + DECODE_WORLD_NEW - 1,
            backward=False))
        want_bytes = (DECODE_WORLD_SUMS[arm] * layers * DECODE_WORLD_BATCH
                      * 4096 * 4)
        arm_ok = all(
            r["tokens_ok"] and r["launches"] == want
            and r["teacher_forced_norm_rel"] <= DECODE_LOGITS_TOL
            and sum(r["step_bytes"].get(k, 0) for k in (
                "c10d.allreduce_",)) == want_bytes for r in recs)
        ok = ok and arm_ok
        paths[f"decode_world {arm}"] = recs[0]["launches"]
        log(f"decode_world {arm}: " + json.dumps(recs))
        log(f"decode_world {arm}: ms a step "
            f"{[round(r['ms_per_step'], 3) for r in recs]} against one "
            f"process's {one[model]['ms_per_step']:.3f}; new tokens/s "
            f"{recs[0]['new_tokens_per_s']:.1f}; peak GB a rank "
            f"{[round(r['peak_gb'], 2) for r in recs]} (held "
            f"{[round(r['held_gb'], 2) for r in recs]}) against one "
            f"process's {one[model]['peak_gb']:.2f}; all-reduced "
            f"{[r['step_bytes'] for r in recs]} a token a rank (want "
            f"{want_bytes} B); teacher-forced logits norm-rel "
            f"{[r['teacher_forced_norm_rel'] for r in recs]} (tol "
            f"{DECODE_LOGITS_TOL:.0e}); greedy tokens {recs[0]['where']} "
            f"-> {'ok' if arm_ok else 'FAIL'}")
    for j, (name, mesh) in enumerate(cli, start=len(DECODE_WORLD_ARMS)):
        lines = [r[j]["lines"] for r in ranks]
        launches = [r[j]["launches"] for r in ranks]
        cli_ok = (lines[0] == cli_one[name] and not any(lines[1:])
                  and all(c == cli_norms for c in launches))
        ok = ok and cli_ok
        paths[f"decode_world cmd.generate {name} {mesh}"] = launches[0]
        log(f"decode_world cmd.generate {name} --mesh {mesh}: "
            f"{json.dumps(lines[0])} (one process: "
            f"{[line['tokens'] for line in cli_one[name]]}); other ranks "
            f"printed {sum(len(x) for x in lines[1:])} lines; launches a "
            f"rank {launches} (want {cli_norms}) -> "
            f"{'ok' if cli_ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the decode world failed its checks")
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
# tensor-parallel plan), two steps each.
WORLD_MESH_STEPS = 2
# A loss of the dp=2 curve against the one-process curve of the same
# call: bf16 keeps 8 significant bits (3.9e-3 a rounding); the loss
# averages 64 x 76 predictions, and the runs differ only in the GEMMs'
# row counts and the order of the gradient sums. 2e-3 is half a bf16
# rounding at the loss.
WORLD_LOSS_RTOL = 2e-3
WORLD_TIMEOUT_S = 600
# What a gang rank takes on the card outside its caching allocator (the
# CUDA context, cuBLAS and kernel modules: ~1 GB a process, measured).
RANK_CONTEXT_BYTES = 1_500_000_000
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
def _recorded(train, curve: list, sigterm_after: int = 0, first_under=None):
    """Each step's (local) loss appended to ``curve``; with
    ``sigterm_after``, SIGTERM this process after that many steps, as a
    kubelet preempting its pod; with ``first_under`` (a context manager),
    the first step runs inside it."""
    import signal

    real = train.build_workload

    def build(*a, **kw):
        work = real(*a, **kw)
        step_fn = work.step_fn

        def step(*batch):
            if first_under is not None and not curve:
                with first_under:
                    loss = step_fn(*batch)
            else:
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


# The bytes a rank hands to each kind of collective (its input: what it
# contributes to an all-reduce, an all-gather or a reduce-scatter), by
# the c10d op the call reaches: the index of that op's input argument.
# An op not listed is counted with all its tensors, under its own name.
COLLECTIVE_INPUT = {
    "c10d.allreduce_": 0, "c10d.allreduce_coalesced_": 0,
    "c10d.broadcast_": 0, "c10d.send": 0, "c10d._allgather_base_": 1,
    "c10d.allgather_": 1, "c10d.allgather_into_tensor_coalesced_": 1,
    "c10d._reduce_scatter_base_": 1, "c10d.reduce_scatter_": 1,
    "c10d.reduce_scatter_tensor_coalesced_": 1, "c10d.alltoall_base_": 1,
    "_c10d_functional.all_reduce": 0,
    "_c10d_functional.all_gather_into_tensor": 0,
    "_c10d_functional.reduce_scatter_tensor": 0,
    "_c10d_functional.all_to_all_single": 0,
}
# Ops of c10d that move no payload of their own.
COLLECTIVE_QUIET = ("_c10d_functional.wait_tensor",
                    "_c10d_functional._wrap_tensor_autograd", "c10d.recv_",
                    "c10d.barrier")


def _collective_counter():
    """A dispatch mode that adds the bytes of each collective this process
    enters while it is on to ``bytes`` (op -> bytes), by
    COLLECTIVE_INPUT: what one step hands gloo, whoever calls it (FSDP2,
    DTensor's redistributions, the port's own sums)."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves

    class Counter(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.bytes = {}

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            name = str(func.overloadpacket)
            if "c10d" in name and name not in COLLECTIVE_QUIET:
                at = COLLECTIVE_INPUT.get(name)
                payload = (args if at is None else args[at],
                           kwargs if at is None else ())
                size = sum(t.numel() * t.element_size()
                           for t in tree_leaves(payload)
                           if isinstance(t, torch.Tensor))
                self.bytes[name] = self.bytes.get(name, 0) + size
            return func(*args, **(kwargs or {}))

    return Counter()


def _world_job(job: dict) -> dict:
    """One ``cmd.train``, ``cmd.eval`` or ``cmd.generate`` call in this
    process, with every launch counter set to 0 just before it and read
    just after; returns its last JSON line (None when it printed none),
    all of them, the counts (also by the flat kernels' head counts), the
    curve of its local losses and the trained model's local expert
    shapes. With ``count_bytes`` the first step (a warmup step, outside
    step_ms) runs under :func:`_collective_counter` and its bytes come
    back by op. An op job (``"cmd": "op"``) calls this script's function
    ``fn`` with ``args`` instead and returns what it returns."""
    import gc

    import torch

    if job.get("cmd") == "op":
        return globals()[job["fn"]](**job["args"])
    from mpi_operator_tpu_torch.cmd import eval as eval_cmd
    from mpi_operator_tpu_torch.cmd import generate as gen_cmd
    from mpi_operator_tpu_torch.cmd import train
    from mpi_operator_tpu_torch.ops import attention as attn

    import torch.distributed as dist

    from mpi_operator_tpu_torch.parallel import sharding

    entry = {"eval": eval_cmd.main, "generate": gen_cmd.main}.get(
        job.get("cmd"), train.main)
    curve, buf, works = [], io.StringIO(), []
    counter = _collective_counter() if job.get("count_bytes") else None
    torch.cuda.reset_peak_memory_stats()
    from mpi_operator_tpu_torch.parallel import pipeline

    for ledger in (sharding.SEQUENCE_BYTES, pipeline.PIPELINE_BYTES):
        for route in ledger:
            ledger[route] = 0
    _reset_all_launch_counts()
    with _recorded(train, curve, job.get("sigterm_after", 0), counter), \
            _kept(train, works), contextlib.redirect_stdout(buf):
        rc = entry(job["argv"])
    launches = _all_launch_counts()
    heads = dict(attn.LAUNCH_HEADS)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    peak_reserved_gb = torch.cuda.max_memory_reserved() / 1e9
    if rc != 0:
        raise AssertionError(f"{job['argv']} returned {rc}")
    experts = [_expert_shapes(w.model) for w in works]
    del works
    gc.collect()
    torch.cuda.empty_cache()
    lines = [json.loads(line) for line in buf.getvalue().splitlines()
             if line.startswith("{")]
    return {"line": lines[-1] if lines else None, "lines": lines,
            "launches": launches,
            "heads": heads, "curve": [float(x) for x in curve],
            "step_bytes": counter.bytes if counter is not None else None,
            "experts": experts[0] if experts else [], "peak_gb": peak_gb,
            "peak_reserved_gb": peak_reserved_gb,
            "backend": dist.get_backend() if dist.is_initialized() else None,
            "sequence_bytes": dict(sharding.SEQUENCE_BYTES),
            "pipeline_bytes": dict(pipeline.PIPELINE_BYTES)}


# One-process reference runs by argv, made once a run: the tp phase holds
# two gangs against each of its Mixtral and BERT calls.
_ONE_PROCESS: dict = {}


def _one_process(argv: list) -> dict:
    """:func:`_world_job` of ``argv`` in this process, the first time it
    is asked for in this run; the same result after."""
    key = tuple(argv)
    if key not in _ONE_PROCESS:
        _ONE_PROCESS[key] = _world_job({"argv": argv})
    return _ONE_PROCESS[key]


def _child_jobs(jobs: list, rank: int) -> int:
    """Each of ``jobs`` in turn in this gang rank, one JSON result line
    each; 1 when a released job waited past its limit, else 0."""
    import os

    for job in jobs:
        if job.get("sigterm_rank", rank) != rank:
            job = {**job, "sigterm_after": 0}
        if job.get("replica"):
            # One replica of a job whose pods each train their own model
            # (the observe phase's chaos job): no world.
            for key in OBSERVE_WORLD_ENV:
                os.environ.pop(key, None)
        print(json.dumps({"result": _world_job(job)}), flush=True)
        if job.get("release"):
            # Stay up after the steps until released, as the workers of
            # a longer job would: a job whose other workers have finished
            # cannot replace a dead one.
            deadline = time.monotonic() + OPERATOR_JOB_TIMEOUT_S
            while not Path(job["release"]).exists():
                if time.monotonic() > deadline:
                    return 1
                time.sleep(0.05)
    return 0


def world_child(spec: str) -> int:
    """A gang rank (the rendezvous env set by the parent). ``spec`` is a
    file of jobs (a pod's: those jobs, then exit) or a gang's directory
    (:func:`_run_gang`): its batches ``jobs<k>.json`` in turn, each
    followed by a ``{"batch": k}`` line, until a ``stop`` file appears."""
    import os

    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rank = int(os.environ["TPUJOB_PROCESS_ID"])
    share = int(os.environ.get("CHIP_SMOKE_RANK_MEMORY_BYTES", "0"))
    if share:
        torch.cuda.set_per_process_memory_fraction(
            min(1.0, share / torch.cuda.mem_get_info()[1]))
    home = Path(spec)
    if not home.is_dir():
        return _child_jobs(json.loads(home.read_text()), rank)
    batch = 0
    while True:
        batch += 1
        jobs = home / f"jobs{batch}.json"
        while not jobs.exists():
            if (home / "stop").exists():
                return 0
            time.sleep(0.1)
        if _child_jobs(json.loads(jobs.read_text()), rank):
            return 1
        print(json.dumps({"batch": batch}), flush=True)


# The gangs of the decode_world, world, sp, tp and pp phases, by size,
# kept running from one phase to the next: a rank's start (interpreter,
# torch, the card's context, the world's formation) is paid once a size,
# not once a phase. main stops them after the last of those phases.
_GANGS: dict = {}


def _start_gang(n: int) -> dict:
    """``n`` processes of one world on the card (``python3 chip_smoke.py
    --world-child <dir>``, gloo), each rank's caching allocator held to an
    equal share of the card's free memory (less RANK_CONTEXT_BYTES), so
    it hands cached blocks back before it takes what another rank needs."""
    import os

    import torch

    from mpi_operator_tpu_torch.utils.net import free_port_pair

    home = Path(tempfile.mkdtemp(prefix=f"chip_smoke_gang{n}_"))
    free, total = torch.cuda.mem_get_info()
    share = max(free // n - RANK_CONTEXT_BYTES, 0)
    log(f"gang of {n} on the card: each rank's allocator held to "
        f"{share / 1e9:.2f} GB ({free / 1e9:.2f} GB free of "
        f"{total / 1e9:.2f} GB)")
    port = free_port_pair()
    procs, logs = [], []
    for rank in range(n):
        env = {**os.environ,
               "TPUJOB_COORDINATOR_ADDRESS": f"127.0.0.1:{port}",
               "TPUJOB_NUM_PROCESSES": str(n),
               "TPUJOB_PROCESS_ID": str(rank), "TPU_WORKER_ID": str(rank),
               "TPUJOB_DIST_BACKEND": "gloo",
               "CHIP_SMOKE_RANK_MEMORY_BYTES": str(share)}
        out, err = home / f"rank{rank}.out", home / f"rank{rank}.err"
        logs.append((out, err))
        procs.append(subprocess.Popen(
            [sys.executable, __file__, "--world-child", str(home)], env=env,
            stdout=out.open("w"), stderr=err.open("w")))
    return {"home": home, "procs": procs, "logs": logs, "batches": 0}


def _stop_gangs() -> None:
    """Stop every gang of :data:`_GANGS`: the ``stop`` file, then each rank
    waited for (killed past WORLD_TIMEOUT_S)."""
    import shutil

    for n in list(_GANGS):
        gang = _GANGS.pop(n)
        (gang["home"] / "stop").write_text("")
        deadline = time.monotonic() + WORLD_TIMEOUT_S
        for p in gang["procs"]:
            try:
                p.wait(timeout=max(deadline - time.monotonic(), 1.0))
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
        shutil.rmtree(gang["home"], ignore_errors=True)


def _run_gang(jobs: list, n: int = WORLD_PROCESSES) -> list:
    """``jobs`` in each of ``n`` processes of one world on the card, the
    gang of ``n`` (:func:`_start_gang`) started on its first call and
    handed each later call's jobs as its next batch. A rank that fails
    stops every rank of the gang and fails the phase, naming the rank and
    showing the end of its log. Returns each rank's job results."""
    import os

    gang = _GANGS.get(n)
    if gang is None:
        if not _GANGS:
            atexit.register(_stop_gangs)
        gang = _GANGS[n] = _start_gang(n)
    gang["batches"] += 1
    batch = gang["batches"]
    spec = gang["home"] / f"jobs{batch}.json"
    part = spec.with_suffix(".part")
    part.write_text(json.dumps(jobs))
    os.replace(part, spec)
    procs, logs = gang["procs"], gang["logs"]
    marker = json.dumps({"batch": batch})

    def done(out: Path) -> bool:
        return marker in out.read_text().splitlines()

    deadline = time.monotonic() + WORLD_TIMEOUT_S
    try:
        while not all(done(out) for out, _ in logs):
            for rank, p in enumerate(procs):
                if p.poll() is not None:
                    raise AssertionError(
                        f"world rank {rank} exited {p.returncode}:\n"
                        f"{logs[rank][1].read_text()[-6000:]}")
            if time.monotonic() > deadline:
                raise AssertionError(
                    f"world ranks still running batch {batch} after "
                    f"{WORLD_TIMEOUT_S} s")
            time.sleep(0.2)
    except BaseException:
        import shutil

        _GANGS.pop(n, None)
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        shutil.rmtree(gang["home"], ignore_errors=True)
        raise
    results = []
    for out, _ in logs:
        lines = out.read_text().splitlines()
        start = (lines.index(json.dumps({"batch": batch - 1})) + 1
                 if batch > 1 else 0)
        results.append([json.loads(line)["result"]
                        for line in lines[start:lines.index(marker)]
                        if line.startswith('{"result"')])
    return results


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
    ranks = _run_gang(list(jobs.values()))
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
    want = _want_launches({**{k: BERT_LAYERS * 6 for k in flat},
                           **_norms(BERT_NORMS, 6)})
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
        want = _want_launches({**{k: BERT_LAYERS * WORLD_MESH_STEPS
                                  for k in flat},
                               **_norms(BERT_NORMS, WORLD_MESH_STEPS)})
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
    want = _want_launches({"flash_fwd": 2 * 3,
                           **_llama_norms(2, 3, backward=False)})
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
                           "flash_bwd_dkv": 3, **_llama_norms(1, 3)})
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


# -- sp: sequence parallelism on the one card -----------------------------

# llama3-8b at full width (dim 4096, 32/8 heads of 128, ffn 14336, vocab
# 128256), depth 1 (the whole script's run stays within its time budget
# so), B=1, S=8192 (4096 positions a rank on sp=2), two AdamW steps
# (three until the examples phase joined the run):
# ~1.27 G parameters, 20 GB of f32 parameters, gradients and AdamW
# moments a process. On the sp=2 gang each arm's loss curve is held
# at WORLD_LOSS_RTOL against the one-process run of the same call (at
# sp=1 the trainer runs the flat kernels and --sequence-parallel and
# --zigzag-ring change nothing, so one run serves the three arms).
SP_LAYERS, SP_STEPS, SP_HOPS = 1, 2, 2
SP_ARGS = [
    "--model", "llama3-8b", "--n-layers", str(SP_LAYERS), "--seq-len",
    str(SP_HOP_SEQ), "--global-batch", "1", "--xent-chunk", "1024",
    "--steps", str(SP_STEPS), "--warmup", "1", "--lr", "3e-4",
    "--log-every", "1",
]
SP_ARMS = {
    "ring zigzag": ["--mesh", "sp=2", "--sequence-parallel", "ring",
                    "--zigzag-ring"],
    "ring": ["--mesh", "sp=2", "--sequence-parallel", "ring"],
    "ulysses": ["--mesh", "sp=2", "--sequence-parallel", "ulysses"],
}
# gloo on CUDA tensors, each op in a pair of processes of its own: what
# the sequence-parallel transport could hand gloo without staging.
GLOO_PROBE_OPS = ("send/recv", "all_to_all_single", "all_reduce",
                  "all_gather", "broadcast")
GLOO_PROBE_TIMEOUT_S = 90


def gloo_probe_child(op: str) -> int:
    """One rank of a gloo probe pair (the env names the rank and port):
    ``op`` on CUDA tensors, one JSON line: whether it returned, and
    whether what it returned is right."""
    import os

    import torch
    import torch.distributed as dist

    rank = int(os.environ["GLOO_PROBE_RANK"])
    dist.init_process_group(
        "gloo", init_method=f"tcp://127.0.0.1:{os.environ['GLOO_PROBE_PORT']}",
        rank=rank, world_size=2)
    x = torch.full((1024,), float(rank + 1), device="cuda")
    line = {"op": op, "rank": rank}
    try:
        if op == "send/recv":
            if rank == 0:
                dist.send(x, 1)
                want = x
            else:
                dist.recv(x, 0)
                want = torch.full_like(x, 1.0)
            got = x
        elif op == "all_to_all_single":
            got = torch.empty_like(x)
            dist.all_to_all_single(got, x)
            want = torch.cat([torch.full((512,), 1.0, device="cuda"),
                              torch.full((512,), 2.0, device="cuda")])
        elif op == "all_reduce":
            dist.all_reduce(x)
            got, want = x, torch.full_like(x, 3.0)
        elif op == "all_gather":
            parts = [torch.empty_like(x) for _ in range(2)]
            dist.all_gather(parts, x)
            got = torch.cat(parts)
            want = torch.cat([torch.full_like(x, 1.0),
                              torch.full_like(x, 2.0)])
        else:
            dist.broadcast(x, 0)
            got, want = x, torch.full_like(x, 1.0)
        torch.cuda.synchronize()
        line["returned"], line["right"] = True, bool(torch.equal(got, want))
    except Exception as e:  # the probe's finding, not a fallback
        line["returned"], line["error"] = False, f"{type(e).__name__}: {e}"
    print(json.dumps(line), flush=True)
    dist.destroy_process_group()
    return 0


def gloo_cuda_probe(tmp: Path) -> dict:
    """Which gloo ops take CUDA tensors on this machine: each of
    GLOO_PROBE_OPS in a pair of processes of its own, all pairs at once.
    Returns op -> "right", "wrong values", the error it raised, or how
    the pair ended (hung, crashed). The transport stages the ring's hops
    through the host on gloo whatever this finds; its all-to-alls go to
    gloo as they are, so a gloo that refused them fails the Ulysses arm
    after this."""
    import os

    from mpi_operator_tpu_torch.utils.net import free_port_pair

    pairs = {}
    for i, op in enumerate(GLOO_PROBE_OPS):
        port = free_port_pair()
        procs = []
        for rank in range(2):
            out = tmp / f"gloo{i}-{rank}.out"
            env = {**os.environ, "GLOO_PROBE_RANK": str(rank),
                   "GLOO_PROBE_PORT": str(port)}
            procs.append((subprocess.Popen(
                [sys.executable, __file__, "--gloo-probe", op], env=env,
                stdout=out.open("w"), stderr=subprocess.STDOUT), out))
        pairs[op] = procs
    deadline = time.monotonic() + GLOO_PROBE_TIMEOUT_S
    found = {}
    for op, procs in pairs.items():
        ends = []
        for proc, out in procs:
            try:
                proc.wait(timeout=max(deadline - time.monotonic(), 0.1))
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
                ends.append("hung")
                continue
            lines = [json.loads(line) for line in out.read_text().splitlines()
                     if line.startswith('{"op"')]
            if not lines:
                ends.append(f"exited {proc.returncode} without a result: "
                            f"{out.read_text()[-300:]!r}")
            elif not lines[0]["returned"]:
                ends.append(lines[0]["error"][:200])
            else:
                ends.append("right" if lines[0]["right"] else "wrong values")
        found[op] = ends[0] if len(set(ends)) == 1 else " / ".join(ends)
        log(f"sp gloo probe {op} on CUDA tensors: {found[op]}")
    return found


def run_sp(tmp: Path) -> dict:
    """Phase ``sp``: which gloo ops take CUDA tensors; then llama3-8b /
    SP_LAYERS at S=8192 on two processes of one card over gloo (one
    gang, the SP_ARMS in turn), each arm's curve against the one-process
    run, each rank's launches against the hop count's (ring: the forward
    SP_HOPS a layer and again in the remat recompute, dq and dk/dv
    SP_HOPS a layer, the norms as one process launches them on the whole
    sequence; Ulysses: the one-process counts), step_ms, peak
    memory and the transport's bytes beside it. Returns rank 0's launch
    counts by arm."""
    import torch

    probe = gloo_cuda_probe(tmp)
    one = _world_job({"argv": SP_ARGS})
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    jobs = {arm: {"argv": [*SP_ARGS, *flags]} for arm, flags in SP_ARMS.items()}
    ranks = _run_gang(list(jobs.values()))
    gang_s = time.perf_counter() - t0
    got = {arm: [r[i] for r in ranks] for i, arm in enumerate(jobs)}
    flat = FLASH_NAMES["flat"]
    hops = SP_STEPS * SP_LAYERS * SP_HOPS
    failed = []
    for arm, results in got.items():
        want = (one["launches"] if arm == "ulysses" else _want_launches(
            {flat[0]: 2 * hops, flat[1]: hops, flat[2]: hops,
             **_llama_norms(SP_LAYERS, SP_STEPS)}))
        curve = [sum(c) / WORLD_PROCESSES
                 for c in zip(*(r["curve"] for r in results))]
        lines = [r["line"] for r in results]
        ok = (_close(curve, one["curve"], WORLD_LOSS_RTOL)
              and all(r["launches"] == want for r in results)
              and all(line["devices"] == 2 and line["steps"] == SP_STEPS
                      for line in lines))
        log(f"sp llama3-8b/{SP_LAYERS} S={SP_HOP_SEQ} {arm} sp=2: curve "
            f"{[round(x, 6) for x in curve]} vs one process "
            f"{[round(x, 6) for x in one['curve']]} (rtol {WORLD_LOSS_RTOL}); "
            f"launches a rank {[r['launches'] for r in results]} (want "
            f"{want}); step_ms {[line['step_ms'] for line in lines]} (one "
            f"process {one['line']['step_ms']}); peak GB "
            f"{[round(r['peak_gb'], 2) for r in results]} (one process "
            f"{one['peak_gb']:.2f}); backend {results[0]['backend']}, "
            f"transport bytes a rank {[r['sequence_bytes'] for r in results]}"
            f" -> {'ok' if ok else 'FAIL'}")
        if not ok:
            failed.append(arm)
    log(f"sp gang: {WORLD_PROCESSES} processes on one card over gloo "
        f"(the step times measure gloo through the host on one card, not a "
        f"multi-GPU node), {len(jobs)} jobs in {gang_s:.1f} s; gloo on CUDA "
        f"tensors: {json.dumps(probe)}")
    if failed:
        raise AssertionError(f"sp checks failed: {failed}")
    return {f"sp {arm}": got[arm][0]["launches"] for arm in got}


# -- tp: tensor parallelism and FSDP on every model the trainer shards ----

# Each run: (the one-process call, the flags that put it on its mesh, the
# processes, the flat kernels' launches a rank and the q/kv heads they
# see). Each runs TP_STEPS steps: two, so that the whole script's run
# stays within its time budget (Mixtral's fsdp=2 step moves 13 GB a rank
# through gloo). Mixtral at the world phase's ep=2 depth (1 layer, full
# width, B=2, S=2048) at a tenth of its rate: at 3e-4 the one-layer
# model overshoots by step 3 (10.88 -> 5.45 -> 7.68 on one process),
# which magnifies the bf16 rounding that a layout moves (tp sums its
# partial products in bf16 across the ranks, fsdp multiplies other row
# counts) past any fixed tolerance: 8.7e-2 (tp=2) and 4.3e-3 (fsdp=2)
# apart at 3e-4, from 3.1e-5 and 0 at the first step; ep=2 keeps 3e-4,
# its partial sums being exact (one nonzero part an element). On fsdp=2
# FSDP2 shards everything on dim 0 (the experts' E among it)
# and splits the batch, each kernel sees the 32/8 heads; on tp=2 each
# rank holds 16 q and 4 kv heads and half of every expert's hidden dim.
# vit-base and seq2seq-small on tp=2 (6/6 and 4/4 heads a rank),
# resnet101 on tp=2 as the replicated layout (the xla BN route: the
# pallas kernels refuse any multi-device mesh); bert-base S=512 with the
# train phase's gathered positions on sp=2 (each rank gathers the
# prediction slots in its columns), the ring on 12/12 heads a rank and
# Ulysses on 6/6; bert-base S=512 on sp=2,tp=2 over four processes in
# the mask layout (so that both layouts run on sp), the ring on 6/6
# heads a rank and Ulysses on 3/3 (sp splits the 6 local heads again).
# Each curve (the ranks' mean) is held to the one-process curve of the
# same call at WORLD_LOSS_RTOL.
TP_STEPS = 2
RESNET_TP_ARGS = _with_steps(
    [a if a != "pallas" else "xla" for a in RESNET_TRAIN_ARGS], TP_STEPS)
# The bert-base sequence-parallel arms at B=32 (64, the train phase's,
# until the entry phase joined the run: their ring and all-to-all bytes
# through gloo scale with the batch).
BERT_SP_ARGS = _with_flag(_with_steps(BERT_TRAIN_ARGS, TP_STEPS),
                          "--global-batch", "32")
# The mask layout: the positions layout runs on sp=2 above.
BERT_SP_TP_ARGS = _with_flag(_with_steps(
    [a if a != "positions" else "mask" for a in BERT_TRAIN_ARGS], TP_STEPS),
    "--global-batch", "32")
MOE_TP_ARGS = _with_steps(_with_flag(MOE_WORLD_ARGS, "--lr", "3e-5"),
                          TP_STEPS)
_MOE_FLASH = (2 * TP_STEPS, TP_STEPS, TP_STEPS)  # one layer, remat
_TP2 = ["--mesh", "tp=2"]
TP_RUNS = {
    "mixtral-8x7b/1 fsdp=2": (MOE_TP_ARGS, ["--mesh", "fsdp=2"], 2,
                              _MOE_FLASH, (32, 8)),
    "mixtral-8x7b/1 tp=2": (MOE_TP_ARGS, _TP2, 2, _MOE_FLASH, (16, 4)),
    "vit-base tp=2": (_with_steps(VIT_TRAIN_ARGS, TP_STEPS), _TP2, 2,
                      (VIT_LAYERS * TP_STEPS,) * 3, (6, 6)),
    "seq2seq-small tp=2": (_with_steps(S2S_TRAIN_ARGS, TP_STEPS), _TP2, 2,
                           (S2S_ATTENTION_CALLS * TP_STEPS,) * 3, (4, 4)),
    "resnet101 tp=2": (RESNET_TP_ARGS, _TP2, 2, (0, 0, 0), None),
    "bert-base sp=2 ring positions": (
        BERT_SP_ARGS, ["--mesh", "sp=2", "--sequence-parallel", "ring"], 2,
        (SP_HOPS * BERT_LAYERS * TP_STEPS,) * 3, (12, 12)),
    "bert-base sp=2 ulysses positions": (
        BERT_SP_ARGS, ["--mesh", "sp=2", "--sequence-parallel", "ulysses"],
        2, (BERT_LAYERS * TP_STEPS,) * 3, (6, 6)),
    "bert-base sp=2,tp=2 ring": (
        BERT_SP_TP_ARGS, ["--mesh", "sp=2,tp=2", "--sequence-parallel",
                          "ring"], 4,
        (SP_HOPS * BERT_LAYERS * TP_STEPS,) * 3, (6, 6)),
    "bert-base sp=2,tp=2 ulysses": (
        BERT_SP_TP_ARGS, ["--mesh", "sp=2,tp=2", "--sequence-parallel",
                          "ulysses"], 4, (BERT_LAYERS * TP_STEPS,) * 3,
        (3, 3)),
}
# Each run's norm launches a rank: as one process's, whether a rank
# normalises its half of the batch (fsdp), every row whole (tp) or its
# own positions (sp).
TP_NORMS = {
    "mixtral-8x7b/1 fsdp=2": _llama_norms(1, TP_STEPS),
    "mixtral-8x7b/1 tp=2": _llama_norms(1, TP_STEPS),
    "vit-base tp=2": _norms(VIT_NORMS, TP_STEPS),
    "seq2seq-small tp=2": _norms(S2S_NORMS, TP_STEPS),
    "resnet101 tp=2": {},
    **{name: _norms(BERT_NORMS, TP_STEPS) for name in TP_RUNS
       if name.startswith("bert-base")},
}


def run_tp(tmp: Path) -> dict:
    """Phase ``tp``: each of TP_RUNS on its gang of processes on the one
    card over gloo (the two-process runs in one gang, the four-process
    ones in another), against the one-process run of the same call: the
    curve, each rank's flat kernel launches and the head counts they saw,
    step_ms, peak GB a rank (allocated and reserved) and the bytes one
    step hands gloo a rank (the first step, counted by op). Returns rank
    0's launch counts by run."""
    import torch

    card = card_line()
    t0 = time.perf_counter()
    one = {name: _one_process(run[0]) for name, run in TP_RUNS.items()}
    free_card("the tp gangs")
    one_s = time.perf_counter() - t0
    got, gang_s = {}, {}
    for n in sorted({run[2] for run in TP_RUNS.values()}):
        names = [name for name, run in TP_RUNS.items() if run[2] == n]
        t0 = time.perf_counter()
        ranks = _run_gang([{"argv": TP_RUNS[name][0] + TP_RUNS[name][1],
                            "count_bytes": True} for name in names], n)
        gang_s[n] = time.perf_counter() - t0
        got.update({name: [r[i] for r in ranks]
                    for i, name in enumerate(names)})
    flat = FLASH_NAMES["flat"]
    failed = []
    for name, (argv, flags, n, counts, heads) in TP_RUNS.items():
        results, ref = got[name], one[name]
        want = _want_launches({**dict(zip(flat, counts)), **TP_NORMS[name]})
        want_heads = ({f"{k} {heads[0]}/{heads[1]}": c
                       for k, c in zip(flat, counts)} if heads else {})
        curve = [sum(c) / n for c in zip(*(r["curve"] for r in results))]
        lines = [r["line"] for r in results]
        ok = (_close(curve, ref["curve"], WORLD_LOSS_RTOL)
              and curve[-1] < curve[0]
              and all(r["launches"] == want and r["heads"] == want_heads
                      for r in results)
              and all(line["devices"] == n and line["steps"] == TP_STEPS
                      for line in lines))
        if name.startswith("mixtral"):
            # Each rank's experts after the steps: FSDP2's shard of dim 0
            # on fsdp=2; half of every expert's hidden dim on tp=2.
            shape = [8, 4096, 7168] if flags == _TP2 else [4, 4096, 14336]
            ok = ok and all(r["experts"] == [shape] for r in results)
        log(f"tp {name}: curve {[round(x, 6) for x in curve]} vs one "
            f"process {[round(x, 6) for x in ref['curve']]} (rtol "
            f"{WORLD_LOSS_RTOL}); flat launches a rank by heads "
            f"{[r['heads'] for r in results]} (want {want_heads}; every "
            f"other counter 0: "
            f"{all(r['launches'] == want for r in results)}); step_ms "
            f"{[line['step_ms'] for line in lines]} (one process "
            f"{ref['line']['step_ms']}); peak GB "
            f"{[round(r['peak_gb'], 2) for r in results]}, reserved "
            f"{[round(r['peak_reserved_gb'], 2) for r in results]} (one "
            f"process {ref['peak_gb']:.2f}, reserved "
            f"{ref['peak_reserved_gb']:.2f}); bytes to gloo a rank in step 1 "
            f"{[r['step_bytes'] for r in results]}; card {card} -> "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            failed.append(name)
    log(f"tp phase: one-process runs {one_s:.1f} s; gangs on one card over "
        f"gloo (the step times measure gloo through the host on one card, "
        f"not a multi-GPU node) {json.dumps({k: round(v, 1) for k, v in gang_s.items()})} s "
        f"by processes")
    if failed:
        raise AssertionError(f"tp checks failed: {failed}")
    return {f"tp {name}": got[name][0]["launches"] for name in TP_RUNS}


# -- pp: pipeline parallelism (GPipe over --mesh pp) -----------------------

# Each arm: (the one-process call, the flags that put it on its mesh, the
# processes, the microbatches M and stages P, the q/kv heads a rank's
# kernels see). llama3-8b / 2 layers at full width on pp=2: B=4, so the
# default derivation gives M = 2 P = 4 microbatches of one sequence, a
# layer a stage; mixtral-8x7b / 2 layers at the moe phase's B=2 (M = 2,
# the router loss through the pipeline) at the tp phase's 3e-5 (at 3e-4
# the shallow model overshoots and magnifies the bf16 rounding that
# another GEMM row count moves); llama3-8b on pp=2,tp=2 over four
# processes, 16/4 heads a rank.
PP_STEPS = 2
PP_LLAMA_ARGS = _with_flag(_with_steps(_with_flag(TRAIN_ARGS,
                                                  "--global-batch", "4"),
                                       PP_STEPS), "--warmup", "1")
PP_MOE_ARGS = _with_flag(_with_flag(_with_steps(MOE_TRAIN_ARGS, PP_STEPS),
                                    "--warmup", "1"), "--lr", "3e-5")
PP_RUNS = {
    "llama3-8b/2 pp=2": (PP_LLAMA_ARGS, ["--mesh", "pp=2"], 2, (4, 2),
                         (32, 8)),
    "mixtral-8x7b/2 pp=2": (PP_MOE_ARGS, ["--mesh", "pp=2"], 2, (2, 2),
                            (32, 8)),
    "llama3-8b/2 pp=2,tp=2": (PP_LLAMA_ARGS, ["--mesh", "pp=2,tp=2"], 4,
                              (4, 2), (16, 4)),
}
# The llama-tiny pipelined checkpoint that cmd.eval reads and one process
# resumes: f32 on the card's f32 kernels (a llama3-8b / 2 layers
# checkpoint is 17.9 GB of f32 parameters and moments a save, two saves
# a run, and cmd.eval builds a config's full depth).
PP_TINY_ARGS = ["--model", "llama-tiny", "--global-batch", "8", "--seq-len",
                "64", "--warmup", "1", "--lr", "1e-2", "--log-every", "1",
                "--save-every", "3"]


def _pp_config(argv: list):
    from mpi_operator_tpu_torch.cmd import train

    return train.llama_config_from_args(train.build_parser().parse_args(argv),
                                        1)


def _pp_state_gb(argv: list, mesh: dict) -> float:
    """The f32 parameters, gradients and two AdamW moments (16 B a
    parameter) of the heaviest rank of ``mesh``: the larger edge stage
    (the embedding, or the norm and head) with its layers, the layers
    split over tp, the embedding and head whole on every tp rank."""
    import torch

    from mpi_operator_tpu_torch.models import llama as lib

    cfg = _pp_config(argv)
    with torch.device("meta"):
        model = lib.Llama(cfg)
    per = cfg.n_layers // mesh["pp"]
    layer = sum(p.numel() for p in model.layer_0.parameters())
    edge = max(model.embed.weight.numel(), model.lm_head.weight.numel()
               + cfg.dim)
    return 16 * (edge + per * layer / mesh.get("tp", 1)) / 1e9


def _check_pp_arm(name: str, run: tuple, results: list, ref: dict,
                  card: str) -> bool:
    """One pp arm's ranks against the one-process run: the curve, the
    flat launches a rank at its heads, the hop bytes a step, logged with
    step_ms and peak GB a rank."""
    argv, _, n, (m, stages), heads = run
    flat = FLASH_NAMES["flat"]
    layers = int(argv[argv.index("--n-layers") + 1]) // stages
    counts = (2 * PP_STEPS * m * layers, PP_STEPS * m * layers,
              PP_STEPS * m * layers)
    want = _want_launches(dict(zip(flat, counts)))
    # Each rank's norms: its stage's blocks, and the final norm on the
    # last stage (ranks in pp-major order, mesh.STANDARD_AXES).
    want_ranks = [{**want, **_llama_norms(
        layers, PP_STEPS * m, final=i // (n // stages) == stages - 1)}
        for i in range(n)]
    want_heads = {f"{k} {heads[0]}/{heads[1]}": c
                  for k, c in zip(flat, counts)}
    seq = int(argv[argv.index("--seq-len") + 1])
    batch = int(argv[argv.index("--global-batch") + 1])
    # bf16 activations, one message each way a tick.
    hop = (2 * (m + stages - 1) * (batch // m) * seq
           * _pp_config(argv).dim * 2)
    hops = [r["pipeline_bytes"]["host"] / PP_STEPS for r in results]
    curve = [sum(c) / n for c in zip(*(r["curve"] for r in results))]
    lines = [r["line"] for r in results]
    ok = (_close(curve, ref["curve"], WORLD_LOSS_RTOL)
          and curve[-1] < curve[0]
          and all(r["launches"] == w and r["heads"] == want_heads
                  for r, w in zip(results, want_ranks))
          and all(h == hop for h in hops)
          and all(line["devices"] == n and line["steps"] == PP_STEPS
                  for line in lines))
    log(f"pp {name}: curve {[round(x, 6) for x in curve]} vs one "
        f"process {[round(x, 6) for x in ref['curve']]} (rtol "
        f"{WORLD_LOSS_RTOL}); flat launches a rank by heads "
        f"{[r['heads'] for r in results]} (want {want_heads}); norm "
        f"launches a rank {[_pick(r['launches'], NORM_KEYS) for r in results]}"
        f" (want {[_pick(w, NORM_KEYS) for w in want_ranks]}); every "
        f"counter as wanted: "
        f"{all(r['launches'] == w for r, w in zip(results, want_ranks))}; "
        f"hop bytes a "
        f"step a rank {hops} (want {hop}); step_ms "
        f"{[line['step_ms'] for line in lines]} (one process "
        f"{ref['line']['step_ms']}); peak GB "
        f"{[round(r['peak_gb'], 2) for r in results]}, reserved "
        f"{[round(r['peak_reserved_gb'], 2) for r in results]} (one "
        f"process {ref['peak_gb']:.2f}, reserved "
        f"{ref['peak_reserved_gb']:.2f}); card {card} -> "
        f"{'ok' if ok else 'FAIL'}")
    return ok


def run_pp(tmp: Path) -> dict:
    """Phase ``pp``: each of PP_RUNS on its gang of processes on the one
    card over gloo, against the one-process run of the same call: the
    curve, each rank's flat kernel launches at its heads, its hop bytes a
    step, step_ms and peak GB a rank. The four-process arm runs when its
    reckoned state a rank fits the gang's share. Then the llama-tiny
    pipelined checkpoint: ``cmd.eval`` on it and a one-process resume to
    step 6. Returns rank 0's launch counts by arm."""
    import shutil

    import torch

    card = card_line()
    runs = dict(PP_RUNS)
    free, _ = torch.cuda.mem_get_info()
    share = (free // 4 - RANK_CONTEXT_BYTES) / 1e9
    four = "llama3-8b/2 pp=2,tp=2"
    need = _pp_state_gb(PP_LLAMA_ARGS, {"pp": 2, "tp": 2})
    log(f"pp {four}: {need:.2f} GB of f32 state on its heaviest rank "
        f"against a four-rank share of {share:.2f} GB -> "
        f"{'runs' if need < share else 'left to the CPU tests'}")
    if need >= share:
        del runs[four]
    t0 = time.perf_counter()
    one = {name: _one_process(run[0]) for name, run in runs.items()}
    one_s = time.perf_counter() - t0
    free_card("the pp gangs")
    ckpt = tmp / "pp-tiny"
    failed, got, gang_s = [], {}, {}
    for n in sorted({run[2] for run in runs.values()}):
        names = [name for name, run in runs.items() if run[2] == n]
        jobs = [{"argv": runs[name][0] + runs[name][1]} for name in names]
        if n == 2:
            jobs.append({"argv": [*PP_TINY_ARGS, "--steps", "3", "--mesh",
                                  "pp=2", "--checkpoint-dir", str(ckpt)]})
        t0 = time.perf_counter()
        ranks = _run_gang(jobs, n)
        gang_s[n] = time.perf_counter() - t0
        got.update({name: [r[i] for r in ranks]
                    for i, name in enumerate(names)})
        # Each gang's arms as soon as it ends.
        failed += [name for name in names if not _check_pp_arm(
            name, runs[name], got[name], one[name], card)]

    # The pipelined llama-tiny checkpoint against one process's.
    straight = tmp / "one-tiny"
    _drive_trainer([*PP_TINY_ARGS, "--steps", "3", "--checkpoint-dir",
                    str(straight)])
    evals = ["--model", "llama-tiny", "--data", str(_token_file(
        tmp / "tiny.u32", 16, 64, 256, 0)), "--batch", "4", "--batches", "2",
             "--seq-len", "64"]
    e_pp, e_one = (_eval_line([*evals, "--checkpoint-dir", str(d)])
                   for d in (ckpt, straight))
    ok = (e_pp["step"] == e_one["step"] == 3
          and _close([e_pp["loss"]], [e_one["loss"]], WORLD_LOSS_RTOL))
    log(f"pp cmd.eval on the pp=2 llama-tiny checkpoint: loss "
        f"{e_pp['loss']} at step {e_pp['step']} vs one process's "
        f"{e_one['loss']} (rtol {WORLD_LOSS_RTOL}) -> "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        failed.append("eval")
    resumed, cont = [], []
    from mpi_operator_tpu_torch.cmd import train

    for directory, curve in ((ckpt, resumed), (straight, cont)):
        with _recorded(train, curve):
            _drive_trainer([*PP_TINY_ARGS, "--steps", "6",
                            "--checkpoint-dir", str(directory)])
    resumed, cont = ([float(x) for x in c] for c in (resumed, cont))
    ok = len(resumed) == 3 and _close(resumed, cont, WORLD_LOSS_RTOL)
    log(f"pp resume of the pp=2 checkpoint on one process, steps 4-6: "
        f"{resumed} vs one process's {cont} (rtol {WORLD_LOSS_RTOL}) -> "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        failed.append("resume")
    shutil.rmtree(ckpt, ignore_errors=True)
    log(f"pp phase: one-process runs {one_s:.1f} s; gangs on one card over "
        f"gloo (the step times measure gloo through the host on one card, "
        f"not a multi-GPU node) {json.dumps({k: round(v, 1) for k, v in gang_s.items()})} s "
        f"by processes")
    if failed:
        raise AssertionError(f"pp checks failed: {failed}")
    return {f"pp {name}": got[name][0]["launches"] for name in runs}


# Phase ``operator``: jobs taken from create to a terminal condition by
# the port's own control plane in this process (InMemoryAPIServer,
# TPUJobController, LocalPodRunner auto-binding to its node), every
# worker pod a process on the card.
OPERATOR_STARTUP_BOUND_S = 200  # PERF.md section 2, the reference's bound
OPERATOR_JOB_TIMEOUT_S = 240
OPERATOR_LOSS_RTOL = 1e-3
PI_YAML = "mpi_operator_tpu_torch/examples/pi.yaml"
# The operator phase's pi job in this run (in-memory control plane), for
# the kube phase to print its REST numbers beside.
OPERATOR_PI: dict = {}


def _operator_cluster(base_env=None):
    """(api, runner, stop) of an in-process operator: the controller on
    its own threads, the runner told how many CUDA devices there are
    (and given ``base_env`` for every pod)."""
    import threading

    import torch

    from mpi_operator_tpu_torch.controller.tpu_job_controller import (
        TPUJobController)
    from mpi_operator_tpu_torch.runtime.apiserver import InMemoryAPIServer
    from mpi_operator_tpu_torch.runtime.podrunner import LocalPodRunner

    api = InMemoryAPIServer()
    controller = TPUJobController(api)
    runner = LocalPodRunner(api, workdir=str(Path(__file__).resolve().parent),
                            cuda_devices=torch.cuda.device_count(),
                            base_env=base_env)
    stop = threading.Event()
    threading.Thread(target=lambda: controller.run(threadiness=2, stop=stop),
                     daemon=True).start()
    runner.start()
    return api, runner, stop


def _operator_job(name: str, accel: str, command) -> dict:
    """pi.yaml as ``name`` on ``accel``: with pi's command when
    ``command`` is None, with none (the builders' default, the
    healthcheck) when it is empty, else with ``command``."""
    import yaml

    from mpi_operator_tpu_torch.utils.net import free_port_pair

    doc = yaml.safe_load((Path(__file__).resolve().parent / PI_YAML)
                         .read_text())
    doc["metadata"].update(name=name, namespace="default")
    doc["spec"]["tpu"]["acceleratorType"] = accel
    doc["spec"]["jaxDistribution"] = {"coordinatorPort": free_port_pair()}
    container = doc["spec"]["tpuReplicaSpecs"]["Worker"]["template"][
        "spec"]["containers"][0]
    if command is not None:
        container["command"] = command
    if not container["command"]:
        del container["command"]
    return doc


def _await_job(api, name: str, workers: int) -> dict:
    """Poll the job from its create: seconds to every worker pod Running
    and to a terminal condition, and that condition."""
    t0 = time.perf_counter()
    running_s = None
    while time.perf_counter() - t0 < OPERATOR_JOB_TIMEOUT_S:
        pods = [p for p in api.list("pods", "default")
                if p["metadata"]["name"].startswith(f"{name}-worker-")]
        phases = [(p.get("status") or {}).get("phase") for p in pods]
        if running_s is None and len(pods) == workers and all(
                ph in ("Running", "Succeeded", "Failed") for ph in phases):
            running_s = time.perf_counter() - t0
        job = api.get("tpujobs", "default", name)
        for c in (job.get("status") or {}).get("conditions") or []:
            if c["status"] == "True" and c["type"] in ("Succeeded", "Failed"):
                return {"condition": c, "running_s": running_s,
                        "done_s": time.perf_counter() - t0}
        time.sleep(0.05)
    raise AssertionError(f"operator job {name} not finished after "
                         f"{OPERATOR_JOB_TIMEOUT_S} s")


def run_operator(tmp: Path, direct: dict) -> dict:
    """Phase ``operator``: the port's job path from create to a terminal
    condition. pi on ``h100-2`` (two pods sharing the card over gloo);
    the default worker command (the healthcheck) on ``h100-2``;
    llama3-8b / 2 layers on ``h100-1``, its pod running ``cmd.train.main``
    with the train phase's TRAIN_ARGS (``--world-child``), held against
    ``direct``, the train phase's summary of the same call; a malformed
    command; then ``python -m mpi_operator_tpu_torch.cmd.operator`` on the
    shipped pi.yaml as a process. Returns the Llama pod's launch counts."""
    failed = []

    def check(label: str, ok: bool, detail: str) -> None:
        log(f"operator {label}: {detail} -> {'ok' if ok else 'FAIL'}")
        if not ok:
            failed.append(label)

    api, runner, stop = _operator_cluster()
    try:
        api.create("tpujobs", _operator_job("pi", "h100-2", None))
        pi = _await_job(api, "pi", 2)
        OPERATOR_PI.update(pi)
        log(runner.pod_log("default", "pi-worker-0").strip()[-2000:])
        check("pi h100-2",
              pi["condition"]["type"] == "Succeeded"
              and pi["done_s"] < OPERATOR_STARTUP_BOUND_S
              and "pi is approximately" in runner.pod_log(
                  "default", "pi-worker-0"),
              f"create -> both pods Running {pi['running_s']:.3f} s, -> "
              f"{pi['condition']['type']} {pi['done_s']:.3f} s (startup "
              f"bound {OPERATOR_STARTUP_BOUND_S} s)")

        # Worker 1's preflight dial can beat worker 0's barrier (exit 13,
        # often on the card): the job carries the podFailurePolicy the
        # healthcheck's exit codes are for, which replaces that pod alone.
        doc = _operator_job("probe", "h100-2", [])
        doc["spec"]["runPolicy"].update(
            backoffLimit=3, podFailurePolicy={"rules": [{
                "action": "Restart",
                "onExitCodes": {"operator": "In", "values": [12, 13]}}]})
        api.create("tpujobs", doc)
        probe = _await_job(api, "probe", 2)
        lines = [json.loads(line) for line in runner.pod_log(
            "default", "probe-worker-0").splitlines() if line.startswith("{")]
        restarts = ((api.get("tpujobs", "default", "probe").get("status")
                     or {}).get("replicaStatuses", {}).get("Worker", {})
                    .get("restarts", 0))
        check("default command (healthcheck) h100-2",
              probe["condition"]["type"] == "Succeeded" and lines
              and lines[-1]["ok"] and lines[-1]["device"] == "cuda:0",
              f"{probe['condition']['type']} in {probe['done_s']:.3f} s, "
              f"{restarts} startup restart(s); {lines[-1:]}")
        if probe["condition"]["type"] != "Succeeded":
            for i in range(2):
                log(f"probe-worker-{i}: " + runner.pod_log(
                    "default", f"probe-worker-{i}").strip()[-2000:])

        spec = tmp / "operator_llama.json"
        spec.write_text(json.dumps([{"argv": TRAIN_ARGS}]))
        api.create("tpujobs", _operator_job(
            "llama", "h100-1",
            ["python", "chip_smoke.py", "--world-child", str(spec)]))
        llama = _await_job(api, "llama", 1)
        pod_log = runner.pod_log("default", "llama-worker-0")
        results = [json.loads(line)["result"] for line in pod_log.splitlines()
                   if line.startswith('{"result"')]
        if llama["condition"]["type"] != "Succeeded" or not results:
            raise AssertionError(
                f"operator llama3-8b job: {llama['condition']}\n"
                f"{pod_log[-6000:]}")
        got, launches = results[0]["line"], results[0]["launches"]
        layers, steps = 2, got["steps"]
        want = _want_launches({"flash_fwd": 2 * layers * steps,
                               "flash_bwd_dq": layers * steps,
                               "flash_bwd_dkv": layers * steps,
                               **_llama_norms(layers, steps)})
        rel = abs(got["first_loss"] - direct["first_loss"]) / abs(
            direct["first_loss"])
        check("llama3-8b/2 layers h100-1",
              steps == 6 and launches == want and math.isfinite(got["loss"])
              and got["loss"] < got["first_loss"]
              and rel <= OPERATOR_LOSS_RTOL,
              f"{llama['condition']['type']} in {llama['done_s']:.3f} s; "
              f"launches {launches} (want {want}); loss "
              f"{got['first_loss']:.6f} -> {got['loss']:.6f}; first loss vs "
              f"the direct call {direct['first_loss']:.6f}: rel {rel:.3e} "
              f"(tol {OPERATOR_LOSS_RTOL:.0e}); step_ms {got['step_ms']} "
              f"tokens/s {got.get('tokens_per_sec')} (direct call "
              f"{direct['step_ms']}, {direct.get('tokens_per_sec')})")

        api.create("tpujobs", _operator_job(
            "broken", "h100-1", ["python", "-c", "raise SystemExit(3)"]))
        broken = _await_job(api, "broken", 1)
        check("malformed command",
              broken["condition"]["type"] == "Failed"
              and "broken-worker-0" in broken["condition"]["message"],
              f"{broken['condition']['type']} in {broken['done_s']:.3f} s: "
              f"{broken['condition']['message'][:200]!r}")
    finally:
        stop.set()
        runner.stop()

    t0 = time.perf_counter()
    out = subprocess.run(
        [sys.executable, "-m", "mpi_operator_tpu_torch.cmd.operator",
         "--backend", "memory", "--apply", PI_YAML, "--exit-on-completion"],
        cwd=Path(__file__).resolve().parent, capture_output=True, text=True,
        timeout=OPERATOR_JOB_TIMEOUT_S)
    wall = time.perf_counter() - t0
    check("cmd.operator --apply pi.yaml",
          out.returncode == 0 and "TPUJob default/pi: Succeeded" in out.stdout,
          f"exit {out.returncode} in {wall:.3f} s wall: "
          f"{out.stdout.strip().splitlines()[-1:]}")
    if out.returncode != 0:
        log(out.stderr[-4000:])
    if failed:
        raise AssertionError(f"operator checks failed: {failed}")
    return launches


# -- kube: the operator as a process against an apiserver over REST ------

KUBE_PROBE_ANNOTATION = "chip-smoke/relist-probe"
KUBE_SETTLE_S = 3.0  # > the 2 s a 10-token burst takes to refill at 5 QPS


def _hold_watch(watch):
    """Drop a KubeWatch's stream and hold its reconnect until the returned
    event is set: while it is held, writes land that it cannot see."""
    import socket
    import threading

    gate = threading.Event()
    reopen = watch._open_stream

    def gated():
        gate.wait(OPERATOR_JOB_TIMEOUT_S)
        return reopen()

    watch._open_stream = gated
    conn = watch._conn
    conn.sock.shutdown(socket.SHUT_RDWR)
    conn.close()
    return gate


def _until(predicate, what: str, timeout: float = OPERATOR_JOB_TIMEOUT_S):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        got = predicate()
        if got:
            return got
        time.sleep(0.05)
    raise AssertionError(f"kube phase: timed out waiting for {what}")


def _scrape(port: int) -> dict:
    """The operator's /metrics as {series: value} (unlabelled series)."""
    import urllib.request

    with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics",
                                timeout=10) as resp:
        text = resp.read().decode()
    out = {}
    for line in text.splitlines():
        parts = line.split()
        if len(parts) == 2 and not line.startswith("#"):
            try:
                out[parts[0]] = float(parts[1])
            except ValueError:
                pass
    return out


def _scrape_or_none(port: int):
    try:
        return _scrape(port)
    except OSError:
        return None


def run_kube(tmp: Path, direct: dict) -> dict:
    """Phase ``kube``: ``python -m mpi_operator_tpu_torch.cmd.operator
    --backend kube --kubeconfig <file>`` as a process against
    ``APIServerFrontend`` (the envtest analog, a random bearer token, on
    localhost) over a fresh ``InMemoryAPIServer``. A ``LocalPodRunner``
    over its own REST client plays the node's kubelet here and nowhere in
    the product, told the card count. Jobs go in through a REST client:
    pi on ``h100-2``; llama3-8b / 2 layers on ``h100-1`` with TRAIN_ARGS,
    held to ``direct`` (the train phase's summary of the same call), and,
    while it runs, a 429 burst the operator must absorb (3 requests shed)
    and a compaction of the watch history while the node's pod watch is
    down, so that its resume 410s and it relists; a malformed command.
    Then ``--apply`` of the shipped pi.yaml as a process over REST, and
    ``--enable-scheduler`` with ``--backend kube`` refused. Returns the
    Llama pod's launch counts."""
    import secrets
    import signal
    import socket

    import torch

    from mpi_operator_tpu_torch.runtime.apiserver import InMemoryAPIServer
    from mpi_operator_tpu_torch.runtime.httpserver import APIServerFrontend
    from mpi_operator_tpu_torch.runtime.kube import KubeAPIServer, RestConfig
    from mpi_operator_tpu_torch.runtime.podrunner import LocalPodRunner

    failed = []
    root = Path(__file__).resolve().parent

    def check(label: str, ok: bool, detail: str) -> None:
        log(f"kube {label}: {detail} -> {'ok' if ok else 'FAIL'}")
        if not ok:
            failed.append(label)

    token = secrets.token_hex(16)
    fe = APIServerFrontend(InMemoryAPIServer(), token=token).start()
    kubeconfig = tmp / "kubeconfig"
    kubeconfig.write_text(json.dumps({
        "apiVersion": "v1", "kind": "Config", "current-context": "envtest",
        "clusters": [{"name": "envtest", "cluster": {"server": fe.url}}],
        "contexts": [{"name": "envtest", "context": {
            "cluster": "envtest", "user": "operator"}}],
        "users": [{"name": "operator", "user": {"token": token}}],
    }))
    client = KubeAPIServer(RestConfig(host=fe.url, token=token))
    node = KubeAPIServer(RestConfig(host=fe.url, token=token))
    runner = LocalPodRunner(node, workdir=str(root),
                            cuda_devices=torch.cuda.device_count())
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    operator_log = tmp / "operator.log"
    cmd = [sys.executable, "-m", "mpi_operator_tpu_torch.cmd.operator",
           "--backend", "kube", "--kubeconfig", str(kubeconfig)]
    operator = None
    try:
        runner.start()
        with open(operator_log, "w") as out:
            operator = subprocess.Popen(
                cmd + ["--monitoring-port", str(port)], cwd=root,
                stdout=out, stderr=subprocess.STDOUT)
        _until(lambda: _scrape_or_none(port), "the operator's /metrics")
        # The operator's start (the CRD preflight, then six informers' lists
        # and watch opens: 13 requests) overdraws its client's 10-token
        # burst at 5 QPS. Let the bucket refill, so that pi's times are a
        # running operator's and not its start's.
        time.sleep(KUBE_SETTLE_S)
        startup_throttle = _scrape(port).get(
            "tpu_operator_rest_client_throttle_seconds_total")
        log(f"kube operator start: {startup_throttle} s waited on the "
            f"client limiter (--kube-api-qps 5, burst 10)")

        client.create("tpujobs", _operator_job("pi", "h100-2", None))
        pi = _await_job(client, "pi", 2)
        log(runner.pod_log("default", "pi-worker-0").strip()[-2000:])
        memory = (f"{OPERATOR_PI['running_s']:.3f} s and "
                  f"{OPERATOR_PI['done_s']:.3f} s" if OPERATOR_PI else
                  "not run in this call")
        check("pi h100-2",
              pi["condition"]["type"] == "Succeeded"
              and pi["done_s"] < OPERATOR_STARTUP_BOUND_S
              and "pi is approximately" in runner.pod_log(
                  "default", "pi-worker-0"),
              f"over REST create -> both pods Running {pi['running_s']:.3f} "
              f"s, -> {pi['condition']['type']} {pi['done_s']:.3f} s "
              f"(in-memory, operator phase: {memory}; startup bound "
              f"{OPERATOR_STARTUP_BOUND_S} s)")

        # The Llama pod stays up after its steps until released, so the
        # faults below land while it runs.
        spec = tmp / "kube_llama.json"
        release = tmp / "kube_llama.release"
        spec.write_text(json.dumps([{"argv": TRAIN_ARGS,
                                     "release": str(release)}]))
        client.create("tpujobs", _operator_job(
            "llama", "h100-1",
            ["python", "chip_smoke.py", "--world-child", str(spec)]))
        t0 = time.perf_counter()
        api = fe.api  # read directly: no request of this script meets a 429
        _until(lambda: any((p.get("status") or {}).get("phase") == "Running"
                           for p in api.list("pods", "default")
                           if p["metadata"]["name"] == "llama-worker-0"),
               "the Llama pod Running")
        pod_watch = runner._pod_watch
        gate = _hold_watch(pod_watch)
        # With the node's pod watch down and this script's client idle,
        # the operator's own calls meet the burst: its re-create of the
        # job's headless Service, deleted behind its back.
        fe.throttle_429 = 3
        api.delete("services", "default", "llama-worker")
        _until(lambda: fe.throttle_429 == 0 and any(
            s["metadata"]["name"] == "llama-worker"
            for s in api.list("services", "default")),
            "the Service re-created through the 429 burst")
        pod = api.get("pods", "default", "llama-worker-0")
        pod["metadata"].setdefault("annotations", {})[
            KUBE_PROBE_ANNOTATION] = "1"
        rv = int(api.update("pods", pod)["metadata"]["resourceVersion"])
        _until(lambda: any(erv >= rv for erv, _ in fe._history["pods"]),
               "the probe in the watch history")
        fe.compact()
        gate.set()
        _until(lambda: pod_watch.relist_count >= 1, "the node's relist")
        release.write_text("go")
        llama = _await_job(client, "llama", 1)
        llama["done_s"] = time.perf_counter() - t0
        pod_log = runner.pod_log("default", "llama-worker-0")
        results = [json.loads(line)["result"] for line in pod_log.splitlines()
                   if line.startswith('{"result"')]
        if llama["condition"]["type"] != "Succeeded" or not results:
            raise AssertionError(
                f"kube llama3-8b job: {llama['condition']}\n"
                f"{pod_log[-6000:]}")
        got, launches = results[0]["line"], results[0]["launches"]
        layers, steps = 2, got["steps"]
        want = _want_launches({"flash_fwd": 2 * layers * steps,
                               "flash_bwd_dq": layers * steps,
                               "flash_bwd_dkv": layers * steps,
                               **_llama_norms(layers, steps)})
        rel = abs(got["first_loss"] - direct["first_loss"]) / abs(
            direct["first_loss"])
        metrics = _scrape(port)
        retries = metrics.get("tpu_operator_rest_client_retries_total", 0)
        check("llama3-8b/2 layers h100-1",
              steps == 6 and launches == want and math.isfinite(got["loss"])
              and got["loss"] < got["first_loss"]
              and rel <= OPERATOR_LOSS_RTOL,
              f"{llama['condition']['type']} in {llama['done_s']:.3f} s; "
              f"launches {launches} (want {want}); loss "
              f"{got['first_loss']:.6f} -> {got['loss']:.6f}; first loss vs "
              f"the direct call {direct['first_loss']:.6f}: rel {rel:.3e} "
              f"(tol {OPERATOR_LOSS_RTOL:.0e}); step_ms {got['step_ms']}")
        check("faults during the Llama job",
              fe.throttle_hits == 3 and retries >= 1
              and pod_watch.relist_count >= 1,
              f"429s served {fe.throttle_hits}; the operator's /metrics "
              f"tpu_operator_rest_client_retries_total {retries}, "
              f"throttle_seconds_total "
              f"{metrics.get('tpu_operator_rest_client_throttle_seconds_total')}"
              f"; the node's pod-watch relists {pod_watch.relist_count}, its "
              f"client's retries {node.retry_count}")

        client.create("tpujobs", _operator_job(
            "broken", "h100-1", ["python", "-c", "raise SystemExit(3)"]))
        broken = _await_job(client, "broken", 1)
        check("malformed command",
              broken["condition"]["type"] == "Failed"
              and "broken-worker-0" in broken["condition"]["message"],
              f"{broken['condition']['type']} in {broken['done_s']:.3f} s: "
              f"{broken['condition']['message'][:200]!r}")

        # One operator at a time (no leader election here): stop this one,
        # and free the name pi for the shipped manifest.
        operator.send_signal(signal.SIGINT)
        operator.wait(timeout=60)
        client.delete("tpujobs", "default", "pi")
        _until(lambda: not any(p["metadata"]["name"].startswith("pi-")
                               for p in api.list("pods", "default")),
               "pi's pods collected")
        t0 = time.perf_counter()
        out = subprocess.run(
            cmd + ["--apply", PI_YAML, "--exit-on-completion"], cwd=root,
            capture_output=True, text=True, timeout=OPERATOR_JOB_TIMEOUT_S)
        wall = time.perf_counter() - t0
        check("cmd.operator --backend kube --apply pi.yaml",
              out.returncode == 0
              and "TPUJob default/pi: Succeeded" in out.stdout,
              f"exit {out.returncode} in {wall:.3f} s wall: "
              f"{out.stdout.strip().splitlines()[-1:]}")
        if out.returncode != 0:
            log(out.stderr[-4000:])
        refused = subprocess.run(cmd + ["--enable-scheduler"], cwd=root,
                                 capture_output=True, text=True, timeout=60)
        check("--backend kube --enable-scheduler refused",
              refused.returncode == 1
              and "requires --backend memory" in refused.stderr,
              f"exit {refused.returncode}: {refused.stderr.strip()[-200:]!r}")
    finally:
        if operator is not None and operator.poll() is None:
            operator.kill()
            operator.wait()
        runner.stop()
        node.close()
        client.close()
        fe.stop()
    if failed:
        log(operator_log.read_text()[-4000:])
        raise AssertionError(f"kube checks failed: {failed}")
    return launches


# -- observe: the operator's observatories and chaos on GPU jobs ----------

# llama3-8b / 2 layers as a pod with step heartbeats: warmup 2, 8 timed
# steps, a window every 2 (4 windows, one device-memory sample each).
OBSERVE_STEPS = 10
OBSERVE_TRAIN_ARGS = _with_steps(TRAIN_ARGS, OBSERVE_STEPS) + [
    "--heartbeat-every", "2"]
# The in-process profile run: the trainer profiles timed steps 11-13, so
# warmup 2 + 14 steps.
PROFILE_STEPS = 16
PROFILE_TRAIN_ARGS = _with_steps(TRAIN_ARGS, PROFILE_STEPS)
FLASH_TRACE_NAMES = ("flash::fwd_kernel", "flash::bwd_dq_kernel",
                     "flash::bwd_dkv_kernel")
# The chaos job: 3 replicas (each pod trains its own llama-tiny on the
# card), 5 heartbeat windows of 128 steps each. A synchronous world would
# not do: its ranks wait for the slowest at every step's collective, so
# their step walls come out equal and the step-skew matrix (max / median
# of the window p50s) reads 1. With 3 replicas a 2x worker reads 2x the
# median; with 2 it would read 2 / 1.5 = 1.33, under the 1.5 threshold.
# The slowed worker starts late (its warmup step is stretched too) and
# falls behind, and the matrices close a window without it once the
# healthy replicas are 4 windows ahead: at 32 steps a window (~0.3 s
# healthy) window 0 closed so and the flip came a window later. At 128
# (~1.1 s healthy, ~2.2 s slowed) none does, so both conditions flip at
# window 2. The replacement's windows up to the dead worker's last are
# dropped as stale, so the conditions clear at the first window after
# it: the repair has two slowed windows (~4 s) after the flip to kill the
# worker before its last heartbeat (window 4). With 4 windows of 32 steps
# it had one (~0.6 s), and a run on a loaded host lost that race.
OBSERVE_REPLICAS = 3
OBSERVE_WORLD_ENV = ("TPUJOB_COORDINATOR_ADDRESS", "TPUJOB_NUM_PROCESSES",
                     "TPUJOB_PROCESS_ID")
OBSERVE_WINDOW_STEPS = 128
OBSERVE_WINDOWS = 5
REPLICA_ARGS = [
    "--model", "llama-tiny", "--seq-len", "128", "--global-batch", "8",
    "--steps", str(1 + OBSERVE_WINDOWS * OBSERVE_WINDOW_STEPS),
    "--warmup", "1",
    "--heartbeat-every", str(OBSERVE_WINDOW_STEPS),
    "--telemetry-every", "0", "--log-every", "0",
]
# random.Random(0)'s draws: WorkerSlower slows worker 0 and the
# LeakInjector leaks on worker 0 (rate 1, one victim each), the
# PodKiller kills all three at their start (rate 1), so the replacements
# start with the faults.
OBSERVE_CHAOS_SEED = 0
# Reported bytes climb 16 GiB a window: by the third window the trend
# projects the card's ~80 GB within the 6-window horizon.
OBSERVE_LEAK_BYTES = 16 << 30
OBSERVE_QUEUE = "gpus:h100=2"


def _observe_cluster():
    """An in-process operator with the observatories wired as
    ``cmd.operator`` wires them, and its monitoring server on a free
    port: (api, runner, controller, recorder, server, stop)."""
    import threading

    import torch

    from mpi_operator_tpu_torch.cmd.operator import start_monitoring
    from mpi_operator_tpu_torch.controller.tpu_job_controller import (
        TPUJobController)
    from mpi_operator_tpu_torch.runtime.apiserver import InMemoryAPIServer
    from mpi_operator_tpu_torch.runtime.podrunner import LocalPodRunner
    from mpi_operator_tpu_torch.utils import (
        devstats, flightrecorder, metrics, stepstats)

    api = InMemoryAPIServer()
    registry = metrics.Registry()
    recorder = flightrecorder.FlightRecorder()
    steps = stepstats.StepMatrix(recorder, registry=registry)
    memory = devstats.MemoryMatrix(recorder, registry=registry)
    controller = TPUJobController(api, registry=registry,
                                  flight_recorder=recorder,
                                  step_matrix=steps, memory_matrix=memory)
    runner = LocalPodRunner(api, workdir=str(Path(__file__).resolve().parent),
                            cuda_devices=torch.cuda.device_count(),
                            flight_recorder=recorder)
    stop = threading.Event()
    threading.Thread(target=lambda: controller.run(threadiness=2, stop=stop),
                     daemon=True).start()
    runner.start()
    server = start_monitoring(0, registry, lambda: True,
                              flight_recorder=recorder, step_matrix=steps,
                              memory_matrix=memory)
    return api, runner, controller, recorder, server, stop


def _debug_json(server, path: str) -> dict:
    import urllib.request

    url = f"http://127.0.0.1:{server.server_address[1]}{path}"
    with urllib.request.urlopen(url, timeout=10) as r:
        return json.loads(r.read().decode())


def _llama_parameters() -> int:
    """llama3-8b / 2 layers' parameter count: the embedding, the layers'
    projections and norms, the final norm and the head."""
    from mpi_operator_tpu_torch.models import llama as lib

    cfg = lib.llama3_8b(n_layers=2)
    hd = cfg.head_dim
    per_layer = (cfg.dim * (cfg.n_heads + 2 * cfg.n_kv_heads) * hd
                 + cfg.n_heads * hd * cfg.dim + 3 * cfg.dim * cfg.ffn_dim
                 + 2 * cfg.dim)
    return 2 * cfg.vocab_size * cfg.dim + cfg.n_layers * per_layer + cfg.dim


def _observe_heartbeats(api, runner, server, tmp: Path, direct: dict,
                        check) -> dict:
    """llama3-8b / 2 layers on h100-1 with --heartbeat-every 2 and
    TPU_JAX_TRACE=1: the pod's annotations, the /steps and /memory
    endpoints, the limit against the card's memory, step_ms beside the
    direct call, launches. Returns the pod's launch counts."""
    import torch

    spec = tmp / "observe_llama.json"
    spec.write_text(json.dumps([{"argv": OBSERVE_TRAIN_ARGS}]))
    doc = _operator_job("llama-hb", "h100-1",
                        ["python", "chip_smoke.py", "--world-child", str(spec)])
    doc["spec"]["runPolicy"]["cleanPodPolicy"] = "None"
    container = doc["spec"]["tpuReplicaSpecs"]["Worker"]["template"]["spec"][
        "containers"][0]
    container["env"] = [{"name": "TPU_JAX_TRACE", "value": "1"}]
    api.create("tpujobs", doc)
    done = _await_job(api, "llama-hb", 1)
    pod_log = runner.pod_log("default", "llama-hb-worker-0")
    results = [json.loads(line)["result"] for line in pod_log.splitlines()
               if line.startswith('{"result"')]
    if done["condition"]["type"] != "Succeeded" or not results:
        raise AssertionError(f"observe llama3-8b job: {done['condition']}\n"
                             f"{pod_log[-6000:]}")
    got, launches = results[0]["line"], results[0]["launches"]
    beats = [json.loads(line) for line in pod_log.splitlines()
             if line.startswith('{"event": "step_heartbeat"')]
    mems = [json.loads(line) for line in pod_log.splitlines()
            if line.startswith('{"compile_cache_entries"')]
    pod = api.get("pods", "default", "llama-hb-worker-0")
    notes = pod["metadata"].get("annotations") or {}
    from mpi_operator_tpu_torch.api.v2beta1 import constants

    hb_note = json.loads(notes.get(constants.STEP_HEARTBEAT_ANNOTATION, "{}"))
    mem_note = json.loads(notes.get(constants.DEVICE_MEMORY_ANNOTATION, "{}"))
    steps_doc = _debug_json(server, "/debug/jobs/default/llama-hb/steps")
    memory_doc = _debug_json(server, "/debug/jobs/default/llama-hb/memory")
    limit = torch.cuda.mem_get_info()[1]
    params = _llama_parameters()
    state_bytes = 12 * params  # f32 parameters + AdamW's two f32 moments
    windows = (OBSERVE_STEPS - 2) // 2
    check("heartbeats and memory samples",
          len(beats) == windows and len(mems) == windows
          and hb_note.get("window") == windows - 1
          and mem_note.get("window") == windows - 1,
          f"{len(beats)} step_heartbeat, {len(mems)} device_memory lines "
          f"(want {windows} each); pod annotations at window "
          f"{hb_note.get('window')} / {mem_note.get('window')}")
    for beat, mem in zip(beats, mems):
        log(f"observe heartbeat window {beat['window']}: p50 "
            f"{beat['step_wall_p50_ms']} ms max {beat['step_wall_max_ms']} ms "
            f"wait {beat['wait_share']}; memory in use "
            f"{mem['hbm_bytes_in_use']} peak {mem['hbm_peak_bytes']} limit "
            f"{mem['hbm_limit_bytes']} kernels {mem['compile_cache_entries']}")
    # A one-worker job closes no skew window (a window needs two
    # workers), so /steps shows the worker's last heartbeat; /memory's
    # windows close with one sample each.
    hb_worker = steps_doc["workers"].get("0", {})
    mem_windows = memory_doc["windows"]
    check("/debug/jobs/default/llama-hb/steps and /memory",
          hb_worker.get("window") == windows - 1
          and [w["window"] for w in mem_windows] == list(range(windows)),
          f"steps: worker 0 at window {hb_worker.get('window')}, p50 "
          f"{hb_worker.get('step_wall_p50_ms')} ms; memory: "
          f"{json.dumps(mem_windows[-1:])}")
    check("hbm_limit_bytes = the card's memory",
          all(m["hbm_limit_bytes"] == limit for m in mems),
          f"{mems[-1]['hbm_limit_bytes']} vs torch.cuda.mem_get_info()[1] "
          f"{limit}")
    check("hbm_bytes_in_use >= parameters + AdamW state",
          all(m["hbm_bytes_in_use"] >= state_bytes for m in mems),
          f"{min(m['hbm_bytes_in_use'] for m in mems)} B >= 12 B x "
          f"{params} parameters = {state_bytes} B; kernels loaded "
          f"{mems[-1]['compile_cache_entries']}")
    steps = got["steps"]
    want = _want_launches({"flash_fwd": 4 * steps, "flash_bwd_dq": 2 * steps,
                           "flash_bwd_dkv": 2 * steps,
                           **_llama_norms(2, steps)})
    p50 = sorted(b["step_wall_p50_ms"] for b in beats)
    check("llama3-8b/2 layers with heartbeats",
          steps == OBSERVE_STEPS and launches == want
          and math.isfinite(got["loss"]) and got["loss"] < got["first_loss"],
          f"launches {launches} (want {want}: 24/12/12 per 6 steps); "
          f"step_ms {got['step_ms']} with heartbeats (window p50s {p50}) "
          f"beside the direct call's {direct['step_ms']} "
          f"({got['step_ms'] / direct['step_ms'] - 1:+.2%})")
    report = got.get("jax_trace") or {}
    per_step = (report.get("transfers", {}).get("after_warmup_count", 0)
                / max(report.get("steps_after_warmup", 0), 1))
    check("TPU_JAX_TRACE=1 in the pod",
          bool(report) and report["compiles"]["after_warmup"] == 0
          and report["steps_after_warmup"] == OBSERVE_STEPS - 2,
          f"kernel builds/loads {report.get('compiles', {}).get('total')} "
          f"({report.get('compiles', {}).get('after_warmup')} after warmup); "
          f"host syncs {per_step:.2f} a step after warmup, "
          f"{report.get('transfer_bytes_per_step')} B a step; sites "
          f"{report.get('transfers', {}).get('top_sites')}")
    return launches


def _condition_changes(recorder, name: str, created: float) -> dict:
    """Each Straggling / MemoryPressure transition of the job, in order:
    (status, seconds from the create, the heartbeat window its verdict
    closed on). A transition two syncs race to write shows once."""
    from mpi_operator_tpu_torch.api.v2beta1.types import (
        JOB_MEMORY_PRESSURE, JOB_STRAGGLING)

    changes: dict = {JOB_STRAGGLING: [], JOB_MEMORY_PRESSURE: []}
    for e in recorder.timeline("default", name):
        if e.get("kind") != "condition" or e.get("type") not in changes:
            continue
        seen = changes[e["type"]]
        if seen and seen[-1][0] == e["status"]:
            continue
        window = re.search(r"at window (\d+)", e.get("message", ""))
        seen.append((e["status"], round(e["ts"] - created, 3),
                     int(window.group(1)) if window else None))
    return changes


def _heartbeat_window(api, pod: str):
    """The window of the pod's last step heartbeat annotation, or None."""
    from mpi_operator_tpu_torch.api.v2beta1 import constants

    notes = api.get("pods", "default", pod)["metadata"].get("annotations")
    raw = (notes or {}).get(constants.STEP_HEARTBEAT_ANNOTATION)
    return json.loads(raw).get("window") if raw else None


def _observe_chaos(api, runner, controller, recorder, tmp: Path,
                   check) -> None:
    """The seeded chaos job: 3 replicas on h100-3, all killed at their
    start and replaced (an Ignore rule on the preemption code 137), worker
    0 slowed 2x and leaking 16 GiB a window. Straggling and
    MemoryPressure must flip; then the host is repaired
    (``heal_worker``) and the worker killed, and both conditions must
    recover at a window after the dead worker's last: the memory matrix
    drops the dead worker, the step matrix waits for its clean
    replacement (whose windows up to the old one's last it drops as
    stale). The replicas stay up after their steps until released; the
    job must succeed."""
    from mpi_operator_tpu_torch import chaos
    from mpi_operator_tpu_torch.api.v2beta1.types import (
        JOB_MEMORY_PRESSURE, JOB_STRAGGLING)
    from mpi_operator_tpu_torch.controller import status as st

    release = tmp / "observe_release"
    spec = tmp / "observe_replica.json"
    spec.write_text(json.dumps([{"argv": REPLICA_ARGS, "replica": True,
                                 "release": str(release)}]))
    doc = _operator_job("replicas", f"h100-{OBSERVE_REPLICAS}",
                        ["python", "chip_smoke.py", "--world-child",
                         str(spec)])
    doc["spec"]["runPolicy"].update(
        cleanPodPolicy="None", backoffLimit=0,
        podFailurePolicy={"rules": [{
            "action": "Ignore",
            "onExitCodes": {"operator": "In", "values": [137]}}]})
    engine = chaos.ChaosEngine(chaos.ChaosPolicy(
        seed=OBSERVE_CHAOS_SEED,
        slow=(chaos.SlowWorkerChaos(slow_rate=1.0, factor=2.0, max_slow=1),),
        leak=(chaos.MemoryLeakChaos(leak_rate=1.0,
                                    bytes_per_window=OBSERVE_LEAK_BYTES,
                                    max_leak=1),),
        pods=(chaos.PodChaos(kill_rate=1.0, max_kills=OBSERVE_REPLICAS),)))
    injectors = (chaos.WorkerSlower(engine, api, runner, recorder),
                 chaos.LeakInjector(engine, api, runner, recorder),
                 chaos.PodKiller(engine, api, runner))
    kinds = (JOB_STRAGGLING, JOB_MEMORY_PRESSURE)

    def wait_for(value: str) -> bool:
        """Until both conditions read ``value``; False if the job ends
        or the time runs out first."""
        while time.perf_counter() - t0 < OPERATOR_JOB_TIMEOUT_S:
            job = api.get("tpujobs", "default", "replicas")
            conds = {c["type"]: c["status"] for c in
                     (job.get("status") or {}).get("conditions") or []}
            if all(conds.get(k) == value for k in kinds):
                return True
            if "True" in (conds.get("Succeeded"), conds.get("Failed")):
                return False
            time.sleep(0.01)
        return False

    t0, created = time.perf_counter(), time.time()
    api.create("tpujobs", doc)
    try:
        while time.perf_counter() - t0 < OPERATOR_JOB_TIMEOUT_S:
            pods = [p for p in api.list("pods", "default")
                    if p["metadata"]["name"].startswith("replicas-worker-")]
            if len(pods) == OBSERVE_REPLICAS and all(
                    (p.get("status") or {}).get("phase") == "Running"
                    for p in pods):
                break
            time.sleep(0.02)
        landed = [inj.tick() for inj in injectors]
        for kind, target, detail in engine.timeline():
            log(f"observe chaos fault: {kind} {target} {detail}".rstrip())
        flipped = wait_for("True")
        healed = killed = False
        if flipped:
            # The host is repaired: the faults end with the process.
            last = _heartbeat_window(api, "replicas-worker-0")
            healed = runner.heal_worker("default", "replicas-worker-0")
            killed = runner.kill_pod("default", "replicas-worker-0")
            log(f"observe chaos repair: heal_worker {healed}, kill_pod "
                f"{killed} (pod default/replicas-worker-0) at "
                f"{time.time() - created:.3f} s, after its heartbeat of "
                f"window {last}")
        recovered = flipped and wait_for("False")
    finally:
        release.touch()
    done = _await_job(api, "replicas", OBSERVE_REPLICAS)
    wall = time.time() - created
    job = api.get("tpujobs", "default", "replicas")
    conds = {c["type"]: c for c in (job.get("status") or {}).get(
        "conditions") or []}
    for c in conds.values():
        log(f"observe chaos condition {c['type']}={c['status']} "
            f"({c['reason']}): {c.get('message', '')}")
    steps_doc = controller.step_matrix.job_snapshot("default", "replicas")
    mem_doc = controller.memory_matrix.job_snapshot("default", "replicas")
    for w in (steps_doc or {}).get("windows", []):
        log(f"observe chaos step window {w['window']}: skew "
            f"{w['skew_ratio']} slowest worker {w['slowest_worker']} of "
            f"{w['workers']}, median p50 {w['median_p50_ms']} ms max "
            f"{w['max_p50_ms']} ms")
    for w in (mem_doc or {}).get("windows", []):
        log(f"observe chaos memory window {w['window']}: top worker "
            f"{w['top_worker']} of {w['workers']}, in use "
            f"{w['hbm_bytes_in_use']} limit {w['hbm_limit_bytes']} headroom "
            f"{w['headroom_ratio']}")
    changes = _condition_changes(recorder, "replicas", created)
    restarts = (job["status"].get("replicaStatuses", {}).get("Worker", {})
                .get("restarts", 0))
    check("chaos: 3 kills and the repair's replaced, the job Succeeded",
          landed == [1, 1, OBSERVE_REPLICAS] and healed and killed
          and done["condition"]["type"] == "Succeeded" and restarts == 0,
          f"faults landed (slow, leak, kill) {landed}; repair heal {healed} "
          f"kill {killed}; {done['condition']['type']} {wall:.3f} s from "
          f"the create, {restarts} charged restarts")
    straggling = conds.get(JOB_STRAGGLING, {})
    pressure = conds.get(JOB_MEMORY_PRESSURE, {})
    check("chaos: SlowWorkerChaos x2 flips Straggling, the repair clears it",
          [c[0] for c in changes[JOB_STRAGGLING]] == ["True", "False"]
          and straggling.get("reason") == st.TPUJOB_STRAGGLER_RECOVERED_REASON,
          f"(status, s from create, window) {changes[JOB_STRAGGLING]} (the "
          f"detector: > {steps_doc['skew_threshold'] if steps_doc else '?'} "
          f"x the median for "
          f"{steps_doc['consecutive_windows'] if steps_doc else '?'} "
          f"consecutive windows); now {straggling.get('status')} "
          f"({straggling.get('reason')})")
    check("chaos: MemoryLeakChaos flips MemoryPressure, the repair clears it",
          [c[0] for c in changes[JOB_MEMORY_PRESSURE]] == ["True", "False"]
          and pressure.get("reason") == st.TPUJOB_MEMORY_RECOVERED_REASON,
          f"(status, s from create, window) {changes[JOB_MEMORY_PRESSURE]}; "
          f"now {pressure.get('status')} ({pressure.get('reason')}); "
          f"flipped {flipped}, recovered {recovered}")


def _observe_queue(tmp: Path, check) -> None:
    """``cmd.operator --enable-queue --cluster-queue gpus:h100=2
    --enable-scheduler`` as a process with two h100-2 pi jobs: the second
    waits for quota, is admitted when the first finishes, both succeed;
    the gang scheduler binds each."""
    import os

    import yaml

    paths = []
    for name in ("first", "second"):
        doc = _operator_job(name, "h100-2", None)
        doc["spec"]["runPolicy"]["schedulingPolicy"] = {"queue": "gpus"}
        path = tmp / f"observe_queue_{name}.yaml"
        path.write_text(yaml.safe_dump(doc))
        paths += ["--apply", str(path)]
    t0 = time.perf_counter()
    out = subprocess.run(
        [sys.executable, "-m", "mpi_operator_tpu_torch.cmd.operator",
         "--backend", "memory", "--enable-queue", "--cluster-queue",
         OBSERVE_QUEUE, "--enable-scheduler", *paths, "--exit-on-completion"],
        cwd=Path(__file__).resolve().parent, capture_output=True, text=True,
        timeout=2 * OPERATOR_JOB_TIMEOUT_S, env=dict(os.environ))
    wall = time.perf_counter() - t0
    stamp = re.compile(r"^[IWE]\d{4} (\d\d):(\d\d):(\d\d\.\d+)")

    def at(needle: str):
        for line in out.stderr.splitlines():
            m = stamp.match(line)
            if m and needle in line:
                h, mi, sec = m.groups()
                return int(h) * 3600 + int(mi) * 60 + float(sec)
        return None

    first_done = at('condition Succeeded=True (TPUJobSucceeded) '
                    'namespace="default" tpujob="first"')
    second_in = at("admitted default/second")
    first_in = at("admitted default/first")
    bound = [line.split("] ", 1)[-1] for line in out.stderr.splitlines()
             if "bound gang" in line]
    for line in bound:
        log(f"observe queue: {line}")
    latency = (second_in - first_done
               if None not in (second_in, first_done) else None)
    check("queue: the second h100-2 job waits, then is admitted",
          out.returncode == 0
          and "TPUJob default/first: Succeeded" in out.stdout
          and "TPUJob default/second: Succeeded" in out.stdout
          and latency is not None and latency >= 0 and len(bound) == 2,
          f"exit {out.returncode} in {wall:.3f} s; first admitted at "
          f"{first_in}, Succeeded at {first_done}; second admitted at "
          f"{second_in}: admission latency after the first finished "
          f"{latency if latency is None else f'{latency:.3f} s'}; "
          f"{len(bound)} gang binds")
    if out.returncode != 0 or latency is None:
        log(out.stdout[-2000:])
        log(out.stderr[-6000:])


def _observe_trace(tmp: Path, check) -> dict:
    """llama3-8b / 2 layers in this process with --profile-dir over timed
    steps 11-13, the tracer armed and torch.cuda's sync debug mode on:
    the trace names the three flash kernels; the tracer's host syncs
    after warmup equal the ones sync debug mode reports. Returns the
    launch counts."""
    import warnings

    import torch

    from mpi_operator_tpu_torch.utils import torchtrace

    profile_dir = tmp / "profile"
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")

        class Boundary(torchtrace.TorchTracer):
            """Notes how many warnings came before the warmup boundary."""

            at_warmup = 0

            def note_warmup_complete(self):
                self.at_warmup = len(caught)
                super().note_warmup_complete()

        tracer = torchtrace.enable(Boundary())
        torch.cuda.set_sync_debug_mode("warn")
        try:
            summary, launches = _drive_trainer(
                PROFILE_TRAIN_ARGS + ["--profile-dir", str(profile_dir)])
        finally:
            torch.cuda.set_sync_debug_mode("default")
            torchtrace.disable()
    syncs = [w for w in caught[tracer.at_warmup:]
             if "synchronizing" in str(w.message)]
    report = tracer.report()
    sites: dict = {}
    for w in syncs:
        site = f"{w.filename}:{w.lineno}"
        sites[site] = sites.get(site, 0) + 1
    # The tracer counts the syncs a caller makes on a tensor; one that
    # torch makes inside itself (a synchronize, say) is printed apart.
    outside = sum(n for site, n in sites.items() if "/torch/" not in site)
    counted = report["transfers"]["after_warmup_count"]
    check("tracer host syncs = torch.cuda sync debug mode",
          counted == outside and report["compiles"]["after_warmup"] == 0,
          f"tracer {counted} syncs after warmup "
          f"({report['transfers']['top_sites']}); sync debug mode "
          f"{outside} outside torch, {len(syncs)} in all ({sites}); "
          f"{report['steps_after_warmup']} steps; kernel loads after "
          f"warmup {report['compiles']['after_warmup']}")
    traces = sorted(profile_dir.glob("*.json"))
    names: set = set()
    if traces:
        events = json.loads(traces[0].read_text()).get("traceEvents", [])
        names = {e.get("name", "") for e in events
                 if e.get("cat") == "kernel"}
    found = {k: sum(1 for n in names if k in n) for k in FLASH_TRACE_NAMES}
    flash = sorted(n for n in names if "flash::" in n)
    check("--profile-dir trace names the flash kernels",
          len(traces) == 1 and all(found.values()),
          f"{[t.name for t in traces]}: "
          f"{len(names)} kernel names, flash {flash[:6]}")
    steps = summary["steps"]
    want = _want_launches({"flash_fwd": 4 * steps, "flash_bwd_dq": 2 * steps,
                           "flash_bwd_dkv": 2 * steps,
                           **_llama_norms(2, steps)})
    check("profile run launches", launches == want,
          f"{launches} (want {want}); step_ms {summary['step_ms']} over "
          f"{steps} steps, 3 of them profiled")
    return launches


def run_observe(tmp: Path, direct: dict) -> dict:
    """Phase ``observe``: the operator's observatories on GPU jobs, chaos,
    the admission queue with the gang scheduler, the profiler and the
    tracer. Returns the Llama pod's launch counts."""
    failed = []

    def check(label: str, ok: bool, detail: str) -> None:
        log(f"observe {label}: {detail} -> {'ok' if ok else 'FAIL'}")
        if not ok:
            failed.append(label)

    api, runner, controller, recorder, server, stop = _observe_cluster()
    try:
        t0 = time.perf_counter()
        launches = _observe_heartbeats(api, runner, server, tmp, direct,
                                       check)
        log(f"observe heartbeats: {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        _observe_chaos(api, runner, controller, recorder, tmp, check)
        log(f"observe chaos: {time.perf_counter() - t0:.1f} s")
    finally:
        stop.set()
        runner.stop()
        server.shutdown()
        server.server_close()
    t0 = time.perf_counter()
    _observe_queue(tmp, check)
    log(f"observe queue: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    _observe_trace(tmp, check)
    log(f"observe trace: {time.perf_counter() - t0:.1f} s")
    if failed:
        raise AssertionError(f"observe checks failed: {failed}")
    return launches


# -- fleet: the control plane's seeded observatories, on this machine's host --

# Each bench's arguments. The straggler and memory documents must equal
# the committed JAX benches' output byte for byte (same seed, same gang:
# an h100-4 job's four worker pods mirror a v5e-16 slice's four hosts).
FLEET_BENCHES = (
    ("straggler", ["--jobs", "8", "--seed", "42"], "BENCH_STRAGGLER.json"),
    ("memory", ["--jobs", "8", "--seed", "42"], "BENCH_MEMORY.json"),
    ("goodput", ["--jobs", "8", "--rates", "0,0.3", "--seed", "42"], None),
    ("controlplane", ["--jobs", "100", "--seed", "42", "--lock-trace"], None),
)


def run_fleet(tmp: Path, card: str) -> None:
    """The port's four control-plane benches through their ``main()``:
    each exits 0 (its own gates), the straggler and memory documents
    equal the committed ones, and the 100-job storm converges under the
    lock-order tracer with no inversion. Their summary lines go to the
    log with a prefix, so the script's own last lines stay its own."""
    import importlib

    from mpi_operator_tpu_torch.utils import logging as logutil

    root = Path(__file__).resolve().parent
    failed = []

    def check(name: str, ok: bool, detail: str = "") -> None:
        log(f"fleet: {'ok' if ok else 'FAIL'} {name} {detail}".rstrip())
        if not ok:
            failed.append(name)

    prev = logutil.configure(level="warning")
    try:
        for name, argv, committed in FLEET_BENCHES:
            bench = importlib.import_module(
                f"mpi_operator_tpu_torch.cmd.bench_{name}")
            out = tmp / f"bench_{name}.json"
            summary = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(summary):
                rc = bench.main([*argv, "--out", str(out)])
            seconds = time.perf_counter() - t0
            log(f"fleet {name}: {summary.getvalue().strip()}")
            check(f"{name}: main exits 0", rc == 0,
                  f"(rc {rc}, {seconds:.2f} s)")
            if committed is not None:
                same = out.read_bytes() == (root / committed).read_bytes()
                check(f"{name}: document equals {committed}", same)
            if name == "controlplane":
                (res,) = json.loads(out.read_text())["results"]
                trace = res["lock_trace"]
                check("controlplane: 100 jobs converged",
                      res["converged"]
                      and res["outcomes"].get("Succeeded", 0) == 100,
                      f"{res['outcomes']} in {res['rounds']} rounds")
                check("controlplane: no lock-order inversion",
                      trace["inversions"] == [],
                      f"({trace['acquisitions']} acquisitions over "
                      f"{len(trace['locks'])} locks)")
                log(f"card: {card}; fleet controlplane on this host: "
                    f"{res['jobs_per_second_to_converged']} jobs/s to "
                    f"converged, reconcile p50 "
                    f"{res['reconcile']['p50_seconds'] * 1e3:.3f} ms p99 "
                    f"{res['reconcile']['p99_seconds'] * 1e3:.3f} ms, "
                    f"wall {res['wall_seconds']} s")
    finally:
        logutil.configure(**prev)
    if failed:
        raise AssertionError(f"fleet checks failed: {failed}")


# -- examples: the worker image's kernel build and a shipped example job --

WORKER_DOCKERFILE = "mpi_operator_tpu_torch/build/worker/Dockerfile"
EXAMPLE_YAML = "mpi_operator_tpu_torch/examples/seq2seq/seq2seq.yaml"
# The two rewrites of the shipped job's argv: a short run, and its
# checkpoints in this run's temporary directory.
EXAMPLE_STEPS = 3
EXAMPLE_FLAGS = ("--steps=", "--checkpoint-dir=")
# One process of seq2seq-small B=16 on the card (PR 6's train phase).
S2S_ONE_PROCESS_MS = "47.93-65"
# Put first on the example pods' PYTHONPATH: at the trainer's exit, one
# line with the process's kernel launches and peak device memory, so the
# pods run the shipped argv and still report what the phase checks.
POD_PROBE = '''"""chip_smoke.py's examples phase: report at exit."""
import atexit
import json
import sys


def _report():
    if "mpi_operator_tpu_torch.ops.attention" not in sys.modules:
        return
    import torch

    from mpi_operator_tpu_torch.ops import attention, bn, norm

    line = {"launches": {**attention.LAUNCHES, **bn.LAUNCHES,
                         **norm.LAUNCHES}}
    if torch.cuda.is_initialized():
        line["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        line["reserved_gb"] = torch.cuda.max_memory_reserved() / 1e9
    print(json.dumps({"pod_probe": line}), flush=True)


atexit.register(_report)
'''


def dockerfile_build_command() -> list:
    """The worker image's kernel-build line (``RUN [...]`` in exec form),
    read out of its Dockerfile."""
    path = Path(__file__).resolve().parent / WORKER_DOCKERFILE
    for line in path.read_text().splitlines():
        if line.startswith("RUN [") and "_build.build()" in line:
            return json.loads(line.removeprefix("RUN "))
    raise AssertionError(f"no kernel-build RUN line in {WORKER_DOCKERFILE}")


def image_check_child(root: str) -> int:
    """In a copy of the port built as the worker image builds it: every
    kernel library is there, and the flat flash forward loads from it
    without a build and agrees with its plain version."""
    sys.path.insert(0, root)
    import torch

    from mpi_operator_tpu_torch.ops import _build, attention

    builds = []
    _build.load_hook = lambda kind, name, _s: (
        builds.append(name) if kind == "build" else None)
    libraries = {n: _build.library_path(n).exists() for n in _build.KERNELS}
    gen = torch.Generator(device="cuda").manual_seed(0)
    b, s, h, d = 2, 256, 8, 64
    q, k, v = (torch.randn(b, s, h * d, device="cuda", generator=gen)
               .to(torch.bfloat16) for _ in range(3))
    out, lse = attention.flash_fwd(q, k, v, h, d ** -0.5, True)
    ref_out, ref_lse = attention.flash_fwd_plain(q, k, v, h, d ** -0.5, True)
    torch.cuda.synchronize()
    print(json.dumps({"image_check": {
        "module": _build.__file__, "libraries": libraries, "built": builds,
        "launches": attention.LAUNCHES["flash_fwd"],
        "out_norm_rel": norm_rel(out, ref_out),
        "lse_max_abs": max_abs(lse, ref_lse)}}), flush=True)
    return 0


def check_image_build(tmp: Path, check) -> float:
    """The worker image's kernel build on a copy of the port, by the
    Dockerfile's own command in the image's working directory; then the
    copy's libraries and its flash forward (``--image-check``). Returns
    the build's seconds."""
    import os
    import shutil

    root = Path(__file__).resolve().parent
    image = tmp / "image"
    shutil.copytree(root / "mpi_operator_tpu_torch",
                    image / "mpi_operator_tpu_torch",
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    argv = dockerfile_build_command()
    run = [sys.executable if argv[0] in ("python", "python3") else argv[0],
           *argv[1:]]
    # The Dockerfile runs it in WORKDIR before any PYTHONPATH is set.
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    t0 = time.perf_counter()
    out = subprocess.run(run, cwd=image, env=env, capture_output=True,
                         text=True, timeout=600)
    seconds = time.perf_counter() - t0
    built = sorted(p.name.split("-")[0] for p in
                   (image / "mpi_operator_tpu_torch" / "_build").glob("*.so"))
    from mpi_operator_tpu_torch.ops import _build

    check("worker image kernel build",
          out.returncode == 0 and built == sorted(_build.KERNELS),
          f"{WORKER_DOCKERFILE}'s {argv} (python = {run[0]}) in a copy of "
          f"the port: exit {out.returncode} in {seconds:.1f} s, "
          f"{len(built)} libraries {built}")
    if out.returncode:
        log(out.stdout[-4000:] + out.stderr[-4000:])
        return seconds
    probe = subprocess.run(
        [sys.executable, str(root / "chip_smoke.py"), "--image-check",
         str(image)], cwd=image, env=env, capture_output=True, text=True,
        timeout=300)
    lines = [json.loads(line)["image_check"] for line in
             probe.stdout.splitlines() if line.startswith('{"image_check"')]
    got = lines[0] if lines else {}
    check("worker image flash forward",
          probe.returncode == 0 and bool(got)
          and got["module"].startswith(str(image))
          and all(got["libraries"].values()) and not got["built"]
          and got["launches"] == 1
          and got["out_norm_rel"] <= NORM_REL_TOL["bf16"]
          and got["lse_max_abs"] <= LSE_ABS_TOL["bf16"],
          f"the copy's flash_fwd (bf16 [2, 256, 8*64], causal) without a "
          f"build: {got} (tol {NORM_REL_TOL['bf16']:.0e} norm-rel, lse "
          f"{LSE_ABS_TOL['bf16']:.0e})")
    if not got:
        log(probe.stdout[-4000:] + probe.stderr[-4000:])
    return seconds


def run_example_job(tmp: Path, check, one_process_ms=None) -> dict:
    """The shipped seq2seq example (``h100-8``: 8 pods on ``dp=8``,
    seq2seq-small at full width) through the port's operator in this
    process, its pods on the one card over gloo, the argv as shipped but
    for EXAMPLE_FLAGS. Returns rank 0's launch counts."""
    import os

    import yaml

    from mpi_operator_tpu_torch.utils.checkpoint import committed_steps
    from mpi_operator_tpu_torch.utils.net import free_port_pair

    root = Path(__file__).resolve().parent
    doc = yaml.safe_load((root / EXAMPLE_YAML).read_text())
    name, accel = doc["metadata"]["name"], doc["spec"]["tpu"]["acceleratorType"]
    n = doc["spec"]["tpuReplicaSpecs"]["Worker"]["replicas"]
    doc["metadata"]["namespace"] = "default"
    port = free_port_pair()
    doc["spec"]["jaxDistribution"] = {"coordinatorPort": port}
    main = doc["spec"]["tpuReplicaSpecs"]["Worker"]["template"]["spec"][
        "containers"][0]
    ckpt = tmp / "ckpt"
    shipped = list(main["command"])
    rewrite = {EXAMPLE_FLAGS[0]: f"--steps={EXAMPLE_STEPS}",
               EXAMPLE_FLAGS[1]: f"--checkpoint-dir={ckpt}"}
    main["command"] = [next((new for flag, new in rewrite.items()
                             if arg.startswith(flag)), arg)
                       for arg in shipped]
    changed = [(a, b) for a, b in zip(shipped, main["command"]) if a != b]
    log(f"examples {EXAMPLE_YAML}: {n} pods on {accel}, argv rewrites "
        f"{changed} (coordinator port {port}); pods run {main['command']}")
    if len(changed) != 2:
        raise AssertionError(f"want the two rewrites {EXAMPLE_FLAGS}, got "
                             f"{changed}")
    probe = tmp / "pod_probe"
    probe.mkdir()
    (probe / "sitecustomize.py").write_text(POD_PROBE)
    path = os.pathsep.join(filter(None, (str(probe), str(root),
                                         os.environ.get("PYTHONPATH"))))
    api, runner, stop = _operator_cluster(base_env={"PYTHONPATH": path})
    try:
        api.create("tpujobs", doc)
        job = _await_job(api, name, n)
        logs = [runner.pod_log("default", f"{name}-worker-{i}")
                for i in range(n)]
    finally:
        stop.set()
        runner.stop()
    lines = []
    for text in logs:
        parsed = [json.loads(line) for line in text.splitlines()
                  if line.startswith("{")]
        summary = next((p for p in parsed if "model" in p), None)
        pod = next((p["pod_probe"] for p in parsed if "pod_probe" in p), None)
        lines.append((summary, pod))
    if job["condition"]["type"] != "Succeeded" or not all(
            s and p for s, p in lines):
        for i, text in enumerate(logs):
            log(f"{name}-worker-{i}: {text.strip()[-3000:]}")
    check(f"{name} {accel} Succeeded",
          job["condition"]["type"] == "Succeeded"
          and job["done_s"] < OPERATOR_STARTUP_BOUND_S,
          f"create -> {n} pods Running {job['running_s']:.3f} s, -> "
          f"{job['condition']['type']} {job['done_s']:.3f} s (startup bound "
          f"{OPERATOR_STARTUP_BOUND_S} s)")
    want = _want_launches({**{k: S2S_ATTENTION_CALLS * EXAMPLE_STEPS
                              for k in FLASH_NAMES["flat"]},
                           **_norms(S2S_NORMS, EXAMPLE_STEPS)})
    for rank, (summary, pod) in enumerate(lines):
        ok = bool(summary and pod) and summary["steps"] == EXAMPLE_STEPS and (
            math.isfinite(summary["loss"])
            and summary["loss"] < summary["first_loss"]
            and pod["launches"] == want)
        check(f"{name} rank {rank}", ok,
              "no summary or probe line" if not (summary and pod) else
              f"loss {summary['first_loss']:.4f} -> {summary['loss']:.4f}; "
              f"launches {pod['launches']} (want {want}); step_ms "
              f"{summary['step_ms']} (one process: {one_process_ms} ms this "
              f"run, {S2S_ONE_PROCESS_MS} in PR 6); peak "
              f"{pod.get('peak_gb', 0):.2f} GB allocated, "
              f"{pod.get('reserved_gb', 0):.2f} GB reserved")
    steps = committed_steps(str(ckpt))
    check(f"{name} checkpoint", bool(steps) and max(steps) == EXAMPLE_STEPS,
          f"committed steps {sorted(steps or [])} in {ckpt}")
    return (lines[0][1] or {}).get("launches", {})


def run_examples(tmp: Path, one_process_ms=None) -> dict:
    """Phase ``examples``: the worker image's kernel build (its
    Dockerfile's line on a copy of the port), then the shipped seq2seq
    example through the port's operator. Returns rank 0's launches."""
    failed = []

    def check(label: str, ok: bool, detail: str) -> None:
        log(f"examples {label}: {detail} -> {'ok' if ok else 'FAIL'}")
        if not ok:
            failed.append(label)

    seconds = check_image_build(tmp, check)
    log(f"examples: worker image kernel build {seconds:.1f} s")
    launches = run_example_job(tmp, check, one_process_ms)
    if failed:
        raise AssertionError(f"examples checks failed: {failed}")
    return launches


# The dryrun's world: JAX's dryrun of the repo's compute check runs on 8
# devices, the n at which every composition (sp x tp x pp, MoE x pp) runs.
ENTRY_DRYRUN_PROCESSES = 8
ENTRY_PHASE_BUDGET_S = 60.0
# A dryrun composition's global first loss against the same model on one
# process on the card (f32 Llama and MoE: the sums' order and gloo's;
# ResNet-18 in bf16: cuDNN's per-batch-size algorithms besides).
DRYRUN_LOSS_RTOL = {"llama": 1e-4, "resnet": MODEL_LOSS_REL_TOL}


def _one_process_loss(comp) -> float:
    """``comp``'s first loss on one process on the card, no mesh: the
    whole model from ``entry.initial_state`` on the global batch (the
    ring and Ulysses compositions on the flat kernels alone)."""
    import dataclasses

    import torch

    from mpi_operator_tpu_torch import entry as entry_lib
    from mpi_operator_tpu_torch.models import llama, resnet

    state = entry_lib.initial_state(comp)
    arrays = [torch.as_tensor(a, device="cuda")
              for a in entry_lib.global_batch(comp)]
    with torch.no_grad():
        if comp.model == "resnet":
            model = resnet.resnet(18, num_classes=64, device="cuda")
            model.load_state_dict(state)
            model.to(memory_format=torch.channels_last).train()
            return float(resnet.loss_fn(model, arrays[0].permute(0, 3, 1, 2),
                                        arrays[1].long()))
        cfg = comp.llama_config()
        if cfg.attention_impl in ("ring", "ulysses"):
            cfg = dataclasses.replace(cfg, attention_impl="flash")
        model = llama.Llama(cfg, device="cuda")
        model.load_state_dict(state)
        return float(llama.loss_fn(model, arrays[0]))


def run_entry(card: str) -> dict:
    """Phase ``entry``: ``entry()`` and ``dryrun_multichip(8)`` on the card
    (the module docstring's item 17). The dryrun's world starts first, in
    a thread of this process; ``entry()`` and the one-process reference
    losses run here meanwhile. Returns the flat kernels' launches by
    path: ``entry``, and each dryrun composition's rank 0."""
    from concurrent.futures import ThreadPoolExecutor

    import torch

    from mpi_operator_tpu_torch import entry as entry_lib
    from mpi_operator_tpu_torch.ops import attention as attn

    failed = []

    def check(label: str, ok: bool, detail: str) -> None:
        log(f"entry {label}: {detail} -> {'ok' if ok else 'FAIL'}")
        if not ok:
            failed.append(label)

    t0 = time.perf_counter()
    pool = ThreadPoolExecutor(max_workers=1)
    dryrun = pool.submit(entry_lib.dryrun_multichip, ENTRY_DRYRUN_PROCESSES)
    fn, (model, images, q, k, v) = entry_lib.entry()
    gen = torch.Generator(device="cuda").manual_seed(0)
    images = torch.randn(images.shape, generator=gen, device="cuda").to(
        memory_format=torch.channels_last)
    q, k, v = (torch.randn(t.shape, generator=gen, device="cuda").to(t.dtype)
               for t in (q, k, v))
    _reset_all_launch_counts()
    logits, att = fn(model, images, q, k, v)
    torch.cuda.synchronize()
    launches = _all_launch_counts()
    h = q.shape[2]
    want, _ = attn.flash_fwd_plain(
        *(t.reshape(t.shape[0], t.shape[1], -1) for t in (q, k, v)), h,
        q.shape[-1] ** -0.5, True)
    err = norm_rel(att.reshape(want.shape), want)
    check("forward", tuple(logits.shape) == (8, 1000)
          and bool(logits.float().isfinite().all()),
          f"resnet101 logits {list(logits.shape)} finite "
          f"{bool(logits.float().isfinite().all())}")
    check("launches", launches == _want_launches({"flash_fwd": 1}),
          f"flash_fwd {launches['flash_fwd']} (want exactly 1; every "
          f"other kernel 0: {sum(launches.values()) == 1})")
    check("attention", err <= NORM_REL_TOL["bf16"],
          f"att {list(att.shape)} bf16 norm_rel_err={err:.3e} vs plain "
          f"(tol {NORM_REL_TOL['bf16']:.0e})")
    by_path = {"entry": {k: launches[k] for k in FLASH_NAMES["flat"]}}
    del fn, model, images, q, k, v, logits, att, want
    comps = entry_lib.compositions(ENTRY_DRYRUN_PROCESSES)
    reference = {c.name: _one_process_loss(c) for c in comps}
    torch.cuda.empty_cache()
    results = dryrun.result()
    pool.shutdown()
    dryrun_s = time.perf_counter() - t0
    for comp, r in zip(comps, results):
        counts = [{k: c[k] for k in FLASH_NAMES["flat"]}
                  for c in r["launches"]]
        attention = comp.model != "resnet"
        one = reference[comp.name]
        rel = abs(r["loss"] - one) / abs(one)
        rtol = DRYRUN_LOSS_RTOL["resnet" if comp.model == "resnet"
                                else "llama"]
        ok = (r["name"] == comp.name and math.isfinite(r["loss"])
              and rel <= rtol
              and all(all(c.values()) if attention else not any(c.values())
                      for c in counts))
        check(f"dryrun {r['name']}", ok,
              f"mesh {r['mesh']} loss {r['loss']:.6f}, one process "
              f"{one:.6f} (rel {rel:.2e}, tol {rtol:.0e}); rank 0 launches "
              f"{counts[0]['flash_fwd']}/{counts[0]['flash_bwd_dq']}/"
              f"{counts[0]['flash_bwd_dkv']}; sharded as planned "
              f"{min(r['sharded'])}-{max(r['sharded'])} of "
              f"{min(r['params'])}-{max(r['params'])} parameters a rank; "
              f"rank 0 {r['seconds']:.2f} s")
        by_path[f"entry dryrun {r['name']} rank 0"] = counts[0]
    seconds = time.perf_counter() - t0
    check("budget", seconds <= ENTRY_PHASE_BUDGET_S,
          f"phase {seconds:.1f} s (the dryrun of {ENTRY_DRYRUN_PROCESSES} "
          f"ranks {dryrun_s:.1f} s from the phase's start, entry() and the "
          f"references beside it) on {card} (budget "
          f"{ENTRY_PHASE_BUDGET_S:.0f} s)")
    if failed:
        raise AssertionError(f"entry checks failed: {failed}")
    return by_path


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--phases",
                        default="kernels,model,train,moe,decode,"
                                "decode_world,world,sp,tp,pp,operator,"
                                "observe,kube,fleet,examples,entry",
                        help="comma-separated subset of kernels,model,train,"
                             "moe,decode,decode_world,world,sp,tp,pp,"
                             "operator,observe,kube,fleet,examples,entry "
                             "and the opt-in profile, data and kernels_ab "
                             "(with --ab-parent); norm runs the kernels "
                             "phase's norm checks alone")
    parser.add_argument("--ab-parent", default="",
                        help="the opt-in kernels_ab phase's other checkout")
    parser.add_argument("--world-child", default="", help=argparse.SUPPRESS)
    parser.add_argument("--image-check", default="", help=argparse.SUPPRESS)
    parser.add_argument("--gloo-probe", default="", help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    phases = set(args.phases.split(","))

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing run", file=sys.stderr)
        return 1
    if args.world_child:  # a rank of the world phase's gang
        return world_child(args.world_child)
    if args.gloo_probe:  # a rank of one of the sp phase's gloo probes
        return gloo_probe_child(args.gloo_probe)
    if args.image_check:  # the examples phase's look at an image's build
        return image_check_child(args.image_check)
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
    s2s_step_ms = None  # the train phase's one-process seq2seq-small step
    if "kernels" in phases:
        t0 = time.perf_counter()
        records = {**check_kernels(), **check_bn_kernels()}
        check_lse_cotangent()
        check_head()
        log(f"card: {card}; kernels phase done in "
            f"{time.perf_counter() - t0:.1f} s")
    if "kernels" in phases or "norm" in phases:
        t0 = time.perf_counter()
        log(json.dumps({"norm_kernels": check_norm_kernels()}))
        log(f"card: {card}; norm kernels done in "
            f"{time.perf_counter() - t0:.1f} s")
    bn_paths, heads_launches, check_launches = {}, {}, {}
    if "model" in phases:
        t0 = time.perf_counter()
        check_model()
        check_model("llama3-8b/2 layers, 16/2 heads", **WIDE_HEADS)
        check_launches = check_model("llama3-8b/2 layers, 8/1 heads",
                                     **DEEP_HEADS)
        for label, heads in (("llama3-8b 16/2 heads of 256", WIDE_HEADS),
                             ("llama3-8b 8/1 heads of 512", DEEP_HEADS)):
            heads_launches[label] = run_heads_llama_train(label, heads)
        log(f"card: {card}; the 8/1 heads of 512 through the column split: "
            f"model check launches {json.dumps(check_launches)}")
        check_resnet_model()
        bn_paths = check_resnet_options()
        check_bert_model()
        check_vit_seq2seq_models()
        log(f"card: {card}; model phase done in "
            f"{time.perf_counter() - t0:.1f} s")
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
    if "kernels_ab" in phases:
        ab_flash_kernels(Path(args.ab_parent))
    if "train" in phases:
        t_train = time.perf_counter()
        # Each main path's own run gives its kernels' launch counts.
        summary, launches = run_train()
        dots_launches = run_train_dots(summary)
        r_summary, r_launches = run_resnet_train()
        b_summary, b_launches = run_bert_train()
        bhsd_launches = run_bert_bhsd_steps()
        flat_runs = run_vit_seq2seq_train()
        v_summary, s_summary = (flat_runs[k][0]
                                for k in ("vit-base", "seq2seq-small"))
        s2s_step_ms = s_summary["step_ms"]
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
            if name.startswith("bn_") and bn_paths:
                # The model phase's ResNet options, each counted alone.
                rec["launches_by_path"] = {k: c[name]
                                           for k, c in bn_paths.items()}
            if name in FLASH_NAMES["flat"]:
                # The other paths through the flat kernels, each counted
                # in its own run.
                rec["launches_by_path"] = {
                    "llama3-8b": launches[name],
                    "llama3-8b --remat-policy dots": dots_launches[name],
                    "bert-base": b_launches[name],
                    **{k: c[name] for k, (_, c) in flat_runs.items()},
                    "llama3-8b --data": d_launches[name],
                    "eval": e_launches[name]}
                for label, counts in heads_launches.items():
                    rec["launches_by_path"][label] = counts[name]
            if name in FLASH_NAMES["bhsd"] and check_launches:
                # The model phase's check at heads of 512 on flash-bhsd.
                rec["launches_by_path"] = {
                    "flash-bhsd train steps": bhsd_launches[name],
                    "llama3-8b 8/1 heads of 512 check":
                        check_launches["flash-bhsd"][name]}
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
            f"{costs['async']['write']:.4f} s behind the steps); train phase "
            f"done in {time.perf_counter() - t_train:.1f} s")
    moe_model = None
    if "moe" in phases:
        t0 = time.perf_counter()
        m_summary, m_launches, moe_model = run_moe_train()
        for name in FLASH_NAMES["flat"]:
            if name in records:
                records[name].setdefault("launches_by_path", {})[
                    "mixtral-8x7b"] = m_launches[name]
        log(f"card: {card}; moe mixtral-8x7b/{MOE_LAYERS} layers tokens/s "
            f"{m_summary['tokens_per_sec']} step_ms {m_summary['step_ms']} "
            f"routed MFU {m_summary['mfu_bf16_peak_routed']:.4f}; moe phase "
            f"done in {time.perf_counter() - t0:.1f} s")
    if "decode" in phases:
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory(prefix="chip_smoke_decode_") as tmp:
            d_paths = run_decode(Path(tmp), moe_model)
        moe_model = None
        for name in FLASH_NAMES["flat"]:
            if name in records:
                records[name].setdefault("launches_by_path", {}).update(
                    {f"decode {k}": c[name] for k, c in d_paths.items()})
        log(f"card: {card}; decode phase done in "
            f"{time.perf_counter() - t0:.1f} s")
    del moe_model
    if "decode_world" in phases:
        free_card("the decode_world phase")
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory(prefix="chip_smoke_dworld_") as tmp:
            by_path = run_decode_world(Path(tmp))
        for name in FLASH_NAMES["flat"]:
            if name in records:
                records[name].setdefault("launches_by_path", {}).update(
                    {k: c[name] for k, c in by_path.items()})
        log(f"card: {card}; decode_world phase done in "
            f"{time.perf_counter() - t0:.1f} s")
    if "world" in phases:
        free_card("the world phase")
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory(prefix="chip_smoke_world_") as tmp:
            by_path = run_world(Path(tmp))
        for name in FLASH_NAMES["flat"]:
            if name in records:
                records[name].setdefault("launches_by_path", {}).update(
                    {f"world {k}": c[name] for k, c in by_path.items()})
        log(f"card: {card}; world phase done in "
            f"{time.perf_counter() - t0:.1f} s")
    if "sp" in phases:
        free_card("the sp phase")
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory(prefix="chip_smoke_sp_") as tmp:
            by_path = run_sp(Path(tmp))
        for name in FLASH_NAMES["flat"]:
            if name in records:
                records[name].setdefault("launches_by_path", {}).update(
                    {k: c[name] for k, c in by_path.items()})
        log(f"card: {card}; sp phase done in "
            f"{time.perf_counter() - t0:.1f} s")
    if "tp" in phases:
        free_card("the tp phase")
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory(prefix="chip_smoke_tp_") as tmp:
            by_path = run_tp(Path(tmp))
        for name in FLASH_NAMES["flat"]:
            if name in records:
                records[name].setdefault("launches_by_path", {}).update(
                    {k: c[name] for k, c in by_path.items()})
        log(f"card: {card}; tp phase done in "
            f"{time.perf_counter() - t0:.1f} s")
    if "pp" in phases:
        free_card("the pp phase")
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory(prefix="chip_smoke_pp_") as tmp:
            by_path = run_pp(Path(tmp))
        for name in FLASH_NAMES["flat"]:
            if name in records:
                records[name].setdefault("launches_by_path", {}).update(
                    {k: c[name] for k, c in by_path.items()})
        log(f"card: {card}; pp phase done in "
            f"{time.perf_counter() - t0:.1f} s")
    # The last phase that runs a gang: hand their processes' memory back.
    _stop_gangs()
    direct = None
    if "operator" in phases:
        torch.cuda.empty_cache()
        direct = summary if "train" in phases else run_train()[0]
        free_card("the operator phase")
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory(prefix="chip_smoke_operator_") as tmp:
            o_launches = run_operator(Path(tmp), direct)
        for name in FLASH_NAMES["flat"]:
            if name in records:
                records[name].setdefault("launches_by_path", {})[
                    "operator llama3-8b"] = o_launches[name]
        log(f"card: {card}; operator phase done in "
            f"{time.perf_counter() - t0:.1f} s")
    if "observe" in phases:
        torch.cuda.empty_cache()
        if direct is None:
            direct = summary if "train" in phases else run_train()[0]
        free_card("the observe phase")
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory(prefix="chip_smoke_observe_") as tmp:
            h_launches = run_observe(Path(tmp), direct)
        for name in FLASH_NAMES["flat"]:
            if name in records:
                records[name].setdefault("launches_by_path", {})[
                    "observe llama3-8b heartbeats"] = h_launches[name]
        log(f"card: {card}; observe phase done in "
            f"{time.perf_counter() - t0:.1f} s")
    if "kube" in phases:
        torch.cuda.empty_cache()
        if direct is None:
            direct = summary if "train" in phases else run_train()[0]
        free_card("the kube phase")
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory(prefix="chip_smoke_kube_") as tmp:
            k_launches = run_kube(Path(tmp), direct)
        for name in FLASH_NAMES["flat"]:
            if name in records:
                records[name].setdefault("launches_by_path", {})[
                    "kube llama3-8b"] = k_launches[name]
        log(f"card: {card}; kube phase done in "
            f"{time.perf_counter() - t0:.1f} s")
    if "fleet" in phases:
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory(prefix="chip_smoke_fleet_") as tmp:
            run_fleet(Path(tmp), card)
        log(f"card: {card}; fleet phase done in "
            f"{time.perf_counter() - t0:.1f} s")
    if "examples" in phases:
        torch.cuda.empty_cache()
        free_card("the examples phase")
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory(prefix="chip_smoke_examples_") as tmp:
            x_launches = run_examples(Path(tmp), s2s_step_ms)
        for name in FLASH_NAMES["flat"]:
            if name in records:
                records[name].setdefault("launches_by_path", {})[
                    "examples seq2seq dp=8 rank 0"] = x_launches[name]
        log(f"card: {card}; examples phase done in "
            f"{time.perf_counter() - t0:.1f} s")
    if "entry" in phases:
        torch.cuda.empty_cache()
        free_card("the entry phase")
        t0 = time.perf_counter()
        by_path = run_entry(card)
        for name in FLASH_NAMES["flat"]:
            if name in records:
                records[name].setdefault("launches_by_path", {}).update(
                    {k: c[name] for k, c in by_path.items()})
        log(f"card: {card}; entry phase done in "
            f"{time.perf_counter() - t0:.1f} s")
    if records:
        log(json.dumps({"kernels": list(records.values())}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
