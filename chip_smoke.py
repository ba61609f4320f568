#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one GPU and hold every
kernel against its plain PyTorch version.

    python3 chip_smoke.py                      # every phase
    python3 chip_smoke.py --phases kernels     # build + kernel checks only

Phases, in order:

1. the card (``nvidia-smi`` name and power limit) and the kernel build:
   every CUDA source under ``mpi_operator_tpu_torch/csrc/``, one ``nvcc``
   each, all started together;
2. ``kernels``: each flash kernel against its plain version on the card,
   at the Llama training shape (B=2, S=2048, H=32, Hkv=8, D=128, bf16,
   causal), at a padded GQA shape (S=200, f32, non-causal) and at a
   masked-row shape (Sq > Sk, causal, f32); times by CUDA events beside
   the bound and one PyTorch library call;
3. ``model``: llama3-8b at full width, 2 layers, small B and S: loss and
   every gradient through the kernels against the dense oracle path on
   the same weights;
4. ``train``: the trainer's own entry point
   (``mpi_operator_tpu_torch.cmd.train.main``) at full width, 2 layers,
   S=2048, 6 AdamW steps; the loss must be finite and fall, and the
   launch counters must show every attention call went through the
   kernels;
5. ``profile`` (opt-in, ``--phases profile``): where one training step's
   time goes (LM head, AdamW, device kernel time by kind, idle share).

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

TRAIN_ARGS = [
    "--model", "llama3-8b", "--n-layers", "2", "--seq-len", "2048",
    "--global-batch", "2", "--xent-chunk", "1024", "--steps", "6",
    "--warmup", "2", "--lr", "3e-4", "--log-every", "1",
]

# Kernel -> the TPU kernel it replaces.
REPLACES = {
    "flash_fwd": "mpi_operator_tpu/ops/attention.py:707",
    "flash_bwd_dq": "mpi_operator_tpu/ops/attention.py:835",
    "flash_bwd_dkv": "mpi_operator_tpu/ops/attention.py:930",
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


def run_train() -> tuple[dict, dict]:
    """The trainer's own entry point; returns (summary, launch counts)."""
    import torch

    from mpi_operator_tpu_torch.cmd import train
    from mpi_operator_tpu_torch.ops import attention as attn

    torch.cuda.reset_peak_memory_stats()
    buf = io.StringIO()
    attn.reset_launch_counts()
    with contextlib.redirect_stdout(buf):
        rc = train.main(TRAIN_ARGS)
    launches = dict(attn.LAUNCHES)
    if rc != 0:
        raise AssertionError(f"train.main returned {rc}")
    summary = json.loads(buf.getvalue().strip().splitlines()[-1])
    summary["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
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
            "flash_bwd_dkv": layers * steps}
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
    from torch.profiler import ProfilerActivity, profile

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

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(2):
            work.step_fn(tokens)
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
        us = evt.self_device_time_total
        name = evt.key
        kind = ("flash" if "flash::" in name else
                "gemm_f32" if "f32f32" in name or "sgemm" in name else
                "gemm" if any(s in name.lower() for s in
                              ("gemm", "nvjet", "xmma", "cutlass")) else
                "adamw" if "multi_tensor_apply" in name else "other")
        kinds[kind] = kinds.get(kind, 0.0) + us / 2e3  # ms per step
        kernels.append((us / 2e3, name[:90]))
    busy = sum(kinds.values())
    log("profile: " + json.dumps({
        "step_ms": step_ms, "lm_head_fwd_bwd_ms": head_ms,
        "adamw_step_ms": adamw_ms,
        "profiled_wall_ms_per_step": wall_ms / 2,
        "device_busy_ms_per_step": busy,
        "device_idle_share": 1 - busy / (wall_ms / 2),
        "device_ms_per_step_by_kind": kinds,
    }))
    for ms, name in sorted(kernels, reverse=True)[:12]:
        log(f"profile kernel {ms:9.3f} ms/step  {name}")
    del work, model, h
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
        for line in _build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                log(f"ptxas {name}: {line.strip()}")

    records = {}
    if "kernels" in phases:
        records = check_kernels()
    if "model" in phases:
        check_model()
    if "profile" in phases:
        profile_step()
    if "train" in phases:
        summary, launches = run_train()
        for name, rec in records.items():
            rec["launches"] = launches[name]
        log(f"card: {card}; train tokens/s {summary.get('tokens_per_sec')} "
            f"step_ms {summary['step_ms']}")
    if records:
        log(json.dumps({"kernels": list(records.values())}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
