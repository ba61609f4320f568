#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main paths on one GPU and hold every
kernel against its plain PyTorch version.

    python3 chip_smoke.py                      # every phase
    python3 chip_smoke.py --phases kernels     # build + kernel checks only

Phases, in order:

1. the card (``nvidia-smi`` name and power limit) and the kernel build:
   every CUDA source under ``mpi_operator_tpu_torch/csrc/``, one ``nvcc``
   each, all started together;
2. ``kernels``: each kernel against its plain version on the card, with
   times by CUDA events beside the bound and one PyTorch library call at
   the main shape:
   - the flash kernels at the Llama training shape (B=2, S=2048, H=32,
     Hkv=8, D=128, bf16, causal), at a padded GQA shape (S=200, f32,
     non-causal) and at a masked-row shape (Sq > Sk, causal, f32);
   - the BN kernels at the ResNet-101 stem ([802816, 64] bf16 at B=64),
     stage 3's widest layer ([3136, 2048] bf16) and a ragged f32 shape
     ([1000, 130]);
3. ``model``: llama3-8b at full width, 2 layers, small B and S: loss and
   every gradient through the flash kernels against the dense oracle;
   then ResNet-101 at full width and depth, B=8, 224x224: loss, every
   gradient and the updated running statistics through the BN kernels
   against the plain-op BN route on the same weights;
4. ``train``: the trainer's own entry point
   (``mpi_operator_tpu_torch.cmd.train.main``) on both main paths: the
   Llama arm (full width, 2 layers, S=2048, 6 AdamW steps) and ResNet-101
   with ``--bn-kernel pallas`` (full width and depth, B=64, 224x224, 6
   SGD steps). Each loss must be finite and fall, and each run's launch
   counters (set to 0 just before it, read just after) must show every
   attention and every BN call went through the kernels;
5. ``profile`` (opt-in, ``--phases profile``): where one training step's
   time goes, for each arm (device kernel time by kind, idle share).

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
import time

# H100 SXM published dense peaks (NVIDIA data sheet), at the 700 W limit.
PEAK_FLOPS = {"bf16": 989e12, "f32": 67e12}  # f32: FMA pipes, no TF32
PEAK_BYTES_PER_S = 3.35e12

# Kernel checks. bf16 operands: the kernel computes in f32 and rounds
# each output to bf16 once (2^-9 relative), while the plain version runs
# in f32 on the same bf16 inputs, so the norm-relative error is ~1e-3;
# 1e-2 leaves room for summation order. f32: only summation order and
# expf differ (~1e-6 relative over a few hundred terms).
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

# Kernel -> the TPU kernel it replaces.
REPLACES = {
    "flash_fwd": "mpi_operator_tpu/ops/attention.py:707",
    "flash_bwd_dq": "mpi_operator_tpu/ops/attention.py:835",
    "flash_bwd_dkv": "mpi_operator_tpu/ops/attention.py:930",
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


def check_kernels() -> dict:
    """Each kernel against its plain version at three shapes. Returns the
    main-shape record per kernel (errors, times, bounds)."""
    import torch
    import torch.nn.functional as F

    from mpi_operator_tpu_torch.ops import _build
    from mpi_operator_tpu_torch.ops import attention as attn

    shapes = [
        ("main", dict(b=2, sq=2048, sk=2048, h=32, hkv=8, d=128,
                      dtype="bf16", causal=True)),
        ("padded-gqa", dict(b=2, sq=200, sk=200, h=8, hkv=2, d=64,
                            dtype="f32", causal=False)),
        ("masked-rows", dict(b=1, sq=130, sk=70, h=4, hkv=2, d=128,
                             dtype="f32", causal=True)),
    ]
    records = {}
    gen = torch.Generator(device="cuda").manual_seed(0)
    for label, s in shapes:
        dtype = torch.bfloat16 if s["dtype"] == "bf16" else torch.float32
        b, sq, sk, h, hkv, d = (s[k] for k in ("b", "sq", "sk", "h", "hkv", "d"))
        causal, scale = s["causal"], d ** -0.5

        def rand(*shape):
            return torch.randn(*shape, generator=gen, device="cuda").to(dtype)

        qf, kf, vf = rand(b, sq, h * d), rand(b, sk, hkv * d), rand(b, sk, hkv * d)
        do = rand(b, sq, h * d)
        f32 = [t.float() for t in (qf, kf, vf, do)]

        out, lse = attn.flash_fwd(qf, kf, vf, h, scale, causal)
        delta = (do.float() * out.float()).reshape(b, sq, h, d).sum(-1)
        dq = attn.flash_bwd_dq(qf, kf, vf, do, lse, delta, h, scale, causal)
        dk, dv = attn.flash_bwd_dkv(qf, kf, vf, do, lse, delta, h, scale,
                                    causal)
        torch.cuda.synchronize()
        out_p, lse_p = attn.flash_fwd_plain(*f32[:3], h, scale, causal)
        dq_p = attn.flash_bwd_dq_plain(*f32, lse, delta, h, scale, causal)
        dk_p, dv_p = attn.flash_bwd_dkv_plain(*f32, lse, delta, h, scale,
                                              causal)
        live = lse_p > attn.NEG_INF / 2
        dead_rows_ok = bool(
            torch.all(lse[~live] == attn.NEG_INF)
            and torch.all(out.reshape(b, sq, h, d)[~live] == 0)
        )
        errs = {
            "flash_fwd": (max(max_abs(out, out_p),
                              max_abs(lse[live], lse_p[live])),
                          norm_rel(out, out_p),
                          max_abs(lse[live], lse_p[live])),
            "flash_bwd_dq": (max_abs(dq, dq_p), norm_rel(dq, dq_p), 0.0),
            "flash_bwd_dkv": (max(max_abs(dk, dk_p), max_abs(dv, dv_p)),
                              max(norm_rel(dk, dk_p), norm_rel(dv, dv_p)), 0.0),
        }
        tol = NORM_REL_TOL[s["dtype"]]
        for name, (mabs, nrel, lse_err) in errs.items():
            ok = (nrel <= tol and lse_err <= LSE_ABS_TOL[s["dtype"]]
                  and math.isfinite(mabs) and dead_rows_ok)
            log(f"kernel {name} [{label} {s}]: max_abs_err={mabs:.3e} "
                f"norm_rel_err={nrel:.3e} (tol {tol:.0e}) lse_abs_err="
                f"{lse_err:.3e} masked_rows_ok={dead_rows_ok} -> "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"{name} disagrees with its plain "
                                     f"version at {label}")
        if label != "main":
            continue

        pairs = int(attn._visible(sq, sk, causal, "cuda").sum())
        calls = {
            "flash_fwd": (
                "fwd", lambda: attn.flash_fwd(qf, kf, vf, h, scale, causal),
                lambda: attn.flash_fwd_plain(qf, kf, vf, h, scale, causal)),
            "flash_bwd_dq": (
                "dq", lambda: attn.flash_bwd_dq(qf, kf, vf, do, lse, delta, h,
                                                scale, causal),
                lambda: attn.flash_bwd_dq_plain(qf, kf, vf, do, lse, delta,
                                                h, scale, causal)),
            "flash_bwd_dkv": (
                "dkv", lambda: attn.flash_bwd_dkv(qf, kf, vf, do, lse, delta,
                                                  h, scale, causal),
                lambda: attn.flash_bwd_dkv_plain(qf, kf, vf, do, lse, delta,
                                                 h, scale, causal)),
        }
        # Library yardstick, timed here only: SDPA on the same values in
        # its [B, H, S, D] layout (transposes made before timing).
        qt, kt, vt, dot = (
            t.reshape(b, t.shape[1], -1, d).transpose(1, 2).contiguous()
            for t in (qf, kf, vf, do)
        )
        qg, kg, vg = (t.detach().requires_grad_() for t in (qt, kt, vt))
        sdpa_out = F.scaled_dot_product_attention(
            qg, kg, vg, is_causal=causal, enable_gqa=True)
        library = {
            "fwd": lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=causal, enable_gqa=True),
            # dq, dk and dv in one call: the yardstick for both backward
            # kernels (PERF.md compares it with their sum).
            "bwd": lambda: torch.autograd.grad(
                sdpa_out, (qg, kg, vg), dot, retain_graph=True),
        }
        lib_ms = {k: time_ms(fn, 2, 10) for k, fn in library.items()}
        for name, (kind, kernel_fn, plain_fn) in calls.items():
            bound_ms, bound_by = bound(kind, s, s["dtype"], pairs)
            mabs, nrel, _ = errs[name]
            records[name] = {
                "name": name,
                "route": "cuda",
                "source": "mpi_operator_tpu_torch/csrc/"
                          + _build.KERNELS[name][0],
                "replaces": REPLACES[name],
                "launches": 0,
                "max_abs_err": mabs,
                "norm_rel_err": nrel,
                "ms": time_ms(kernel_fn, 2, 10),
                "plain_ms": time_ms(plain_fn, 1, 3),
                "bound_ms": bound_ms,
                "bound_by": bound_by,
                "library_ms": lib_ms["fwd" if kind == "fwd" else "bwd"],
            }
            log(f"kernel {name} [main] timing: " + json.dumps(
                {k: records[name][k] for k in
                 ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}))
        del sdpa_out
    # A CUDA tensor the kernels do not take raises; it never falls back
    # to the plain version.
    x16 = torch.zeros(1, 64, 2 * 128, device="cuda", dtype=torch.float16)
    x256 = torch.zeros(1, 64, 2 * 256, device="cuda")
    for bad, err in ((x16, TypeError), (x256, ValueError)):
        try:
            attn.flash_fwd(bad, bad, bad, 2, 0.1, True)
        except err as e:
            log(f"kernel flash_fwd refuses {bad.dtype} d={bad.shape[2] // 2}: "
                f"{type(e).__name__}: {e}")
        else:
            raise AssertionError("flash_fwd accepted operands it cannot take")
    torch.cuda.empty_cache()
    return records


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


def check_model() -> None:
    """llama3-8b, full width, 2 layers, B=1, S=256: loss and gradients
    through the kernels against the dense oracle on the same weights."""
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
    for impl in ("flash", "dense"):
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
    (lf, gf, lf_launch), (ld, gd, _) = results["flash"], results["dense"]
    loss_rel = abs(lf - ld) / abs(ld)
    worst = max((norm_rel(gf[n], gd[n]), n) for n in gd)
    ok = (math.isfinite(lf) and loss_rel <= MODEL_LOSS_REL_TOL
          and worst[0] <= MODEL_GRAD_NORM_REL_TOL
          and all(lf_launch[k] > 0 for k in lf_launch))
    log(f"model llama3-8b/2 layers B=1 S=256: loss kernel={lf:.6f} "
        f"oracle={ld:.6f} rel={loss_rel:.3e} (tol {MODEL_LOSS_REL_TOL:.0e}); "
        f"worst grad norm_rel={worst[0]:.3e} at {worst[1]} "
        f"(tol {MODEL_GRAD_NORM_REL_TOL:.0e}); kernel launches {lf_launch} "
        f"-> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("kernel path disagrees with the dense oracle")
    del results, gf, gd, state
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
    want = {"flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0,
            "bn_stats": RESNET_BN_LAYERS * steps,
            "bn_grads": RESNET_BN_LAYERS * steps}
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
    want = {"flash_fwd": 2 * layers * steps, "flash_bwd_dq": layers * steps,
            "flash_bwd_dkv": layers * steps, "bn_stats": 0, "bn_grads": 0}
    ok = (steps == 6 and math.isfinite(summary["loss"])
          and summary["loss"] < summary["first_loss"] and launches == want)
    log(f"train launches {launches} (want {want}); loss "
        f"{summary['first_loss']:.4f} -> {summary['loss']:.4f} -> "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("training run failed its checks")
    return summary, launches


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
    return ("flash" if "flash::" in name else
            "gemm_f32" if "f32f32" in name or "sgemm" in name else
            "gemm" if any(s in name.lower() for s in
                          ("gemm", "nvjet", "xmma", "cutlass")) else
            "adamw" if "multi_tensor_apply" in name else "other")


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


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--phases", default="kernels,model,train",
                        help="comma-separated subset of kernels,model,train "
                             "and the opt-in profile")
    args = parser.parse_args(argv)
    phases = set(args.phases.split(","))

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing run", file=sys.stderr)
        return 1
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
    for name in _build.KERNELS:
        # One summary line per source: its template instances' registers
        # and spills.
        text = _build.build_log(name)
        regs = [int(r) for r in re.findall(r"Used (\d+) registers", text)]
        spills = sum(int(b) for b in re.findall(r"(\d+) bytes spill", text))
        log(f"ptxas {name}: {len(regs)} kernel instances, registers "
            f"{min(regs, default=0)}-{max(regs, default=0)}, spill bytes "
            f"{spills}")

    records = {}
    if "kernels" in phases:
        records = {**check_kernels(), **check_bn_kernels()}
    if "model" in phases:
        check_model()
        check_resnet_model()
    if "profile" in phases:
        profile_step()
        profile_resnet_step()
    if "train" in phases:
        # Each main path's own run gives its kernels' launch counts.
        summary, launches = run_train()
        r_summary, r_launches = run_resnet_train()
        for name, rec in records.items():
            rec["launches"] = (r_launches if name.startswith("bn_")
                               else launches)[name]
        log(f"card: {card}; train llama tokens/s "
            f"{summary.get('tokens_per_sec')} step_ms {summary['step_ms']}; "
            f"train resnet101 images/s {r_summary['examples_per_sec']} "
            f"step_ms {r_summary['step_ms']}")
    if records:
        log(json.dumps({"kernels": list(records.values())}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
