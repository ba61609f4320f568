"""Decode from a trainer checkpoint -- the inference CLI (port of
``mpi_operator_tpu/cmd/generate.py``).

Reads the newest checkpoint the port's ``cmd.train`` wrote (its
``params`` entry only) and runs KV-cache autoregressive decoding
(``models/generate.py``) on it:

    python -m mpi_operator_tpu_torch.cmd.generate \\
        --checkpoint-dir /ckpt/llama --model llama-tiny \\
        --prompt 12,7,42 --max-new 16 [--temperature 0.8 --seed 1]

Prints one JSON line per prompt, in batch order (repeat ``--prompt`` to
decode several prompts of one length as one batch):
``{"step": ..., "prompt": [...], "tokens": [...], "new": [...]}``. Token
ids in and out: tokenizers are corpus-specific, the boundary the data
loader draws too. Sampling draws from a ``torch.Generator`` seeded with
``--seed`` (its draws differ from ``jax.random``'s; greedy decoding
gives the same tokens), the same tokens on every mesh.

Across processes (the rendezvous env, as ``cmd.train`` reads it) with
``--mesh`` over dp, fsdp, tp and (MoE) ep, the JAX command's axes (dp
over every process by default): each process keeps its slices of the
checkpoint's parameters, cast to the compute dtype before they go to
the device, decodes its rows with them, and only process 0 prints, so a
checkpoint too large for one card decodes on several.

Runs on ``cuda`` by default (raising when no GPU is present) and on the
CPU with ``--device cpu``.
"""

from __future__ import annotations

import argparse
import json


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="tpujob-generate-torch",
        description="KV-cache decoding from a cmd.train checkpoint",
    )
    p.add_argument("--checkpoint-dir", required=True)
    p.add_argument("--model", default="llama-tiny",
                   help="llama3-8b|llama-tiny|mixtral-8x7b|llama-moe-tiny "
                        "(must match the training run)")
    p.add_argument("--prompt", required=True, action="append",
                   help="comma-separated token ids, e.g. 12,7,42; repeat "
                        "the flag to decode a batch (prompts must share a "
                        "length: one static cache serves the batch)")
    p.add_argument("--max-new", type=int, default=32)
    p.add_argument("--temperature", type=float, default=0.0,
                   help="0 = greedy; > 0 = softmax sampling")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--mesh", default="",
                   help="axis=size pairs over dp, fsdp, tp and (MoE) ep, "
                        "e.g. tp=2 or tp=2,fsdp=2, to shard the weights "
                        "over the job's processes (default: dp over every "
                        "process)")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="where to decode; cuda raises when no GPU is present "
                        "(the run never moves to the CPU on its own)")
    return p


def check_decode_mesh(sizes: dict, cfg, model_name: str) -> None:
    """The JAX command's refusals of a decode mesh, in its words: an axis
    other than dp, fsdp, tp and ep; a tp that does not divide the dims it
    shards (the flat attention features, not the heads: indivisible
    heads stay whole); ep on a dense model or over an expert count it
    does not divide."""
    bad = [a for a, n in sizes.items()
           if a not in ("dp", "fsdp", "tp", "ep") and n > 1]
    if bad:
        raise SystemExit(
            f"decode meshes take dp/fsdp/tp (+ep for MoE); {bad} have no "
            f"decode-time meaning (pp layouts are unstacked above; there is "
            f"no sequence to shard)")
    tp = sizes.get("tp", 1)
    sharded_dims = {"dim": cfg.dim, "ffn_dim": cfg.ffn_dim,
                    "attn features": cfg.n_heads * cfg.head_dim,
                    "vocab": cfg.vocab_size}
    bad_dims = [k for k, v in sharded_dims.items() if v % tp]
    if tp > 1 and bad_dims:
        raise SystemExit(
            f"tp={tp} must divide the sharded dims; it does not divide "
            f"{bad_dims} ({ {k: sharded_dims[k] for k in bad_dims} })")
    ep = sizes.get("ep", 1)
    if ep > 1 and not cfg.is_moe:
        raise SystemExit(
            f"--mesh ep={ep} needs an MoE model; {model_name} is dense")
    if ep > 1 and cfg.n_experts % ep:
        raise SystemExit(f"{cfg.n_experts} experts not divisible by ep={ep}")


def check_fit(params: dict, cfg, step: int, model_name: str) -> None:
    """Refuse a checkpoint whose parameters are not ``cfg``'s, by name and
    shape, before any of them is cut or moved."""
    import torch

    from ..models.llama import Llama

    with torch.device("meta"):
        want = {n: tuple(p.shape) for n, p in Llama(cfg).named_parameters()}
    got = {n: tuple(t.shape) for n, t in params.items()}
    missing, unexpected = sorted(want.keys() - got.keys()), sorted(
        got.keys() - want.keys())
    shapes = [f"{n}: {got[n]} != {want[n]}" for n in sorted(want)
              if n in got and got[n] != want[n]]
    if missing or unexpected or shapes:
        detail = "; ".join(filter(None, (
            missing and f"missing {missing[:4]}",
            unexpected and f"unexpected {unexpected[:4]}",
            shapes and f"shape mismatch {shapes[:4]}")))
        raise SystemExit(f"checkpoint at step {step} does not fit --model "
                         f"{model_name}: {detail}")


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    try:
        prompts = [[int(t) for t in spec.split(",") if t.strip()]
                   for spec in args.prompt]
    except ValueError:
        raise SystemExit("--prompt must be comma-separated integer token ids")
    if any(not p for p in prompts):
        raise SystemExit("every --prompt must contain at least one token id")
    if len({len(p) for p in prompts}) > 1:
        raise SystemExit(
            f"batched prompts must share a length (got "
            f"{sorted({len(p) for p in prompts})}); one static KV cache "
            f"serves the batch -- pad or bucket upstream")
    if args.max_new < 1:
        raise SystemExit("--max-new must be >= 1")
    from .train import parse_mesh_spec

    try:
        sizes = parse_mesh_spec(args.mesh)
    except ValueError as e:
        raise SystemExit(f"--mesh {args.mesh!r}: {e}") from None

    import torch

    from ..launcher import bootstrap
    from ..models import llama as lib
    from ..models.generate import DecodeShards, generate, shard_decode_weights
    from ..ops._common import require_device
    from ..parallel.mesh import create_mesh
    from ..utils.checkpoint import read_llama_params

    try:
        cfg = lib.config_for(args.model)
    except KeyError:
        raise SystemExit(f"unknown --model {args.model!r} (llama family only)")
    bad = [t for p in prompts for t in p if not 0 <= t < cfg.vocab_size]
    if bad:
        raise SystemExit(
            f"prompt ids {bad} outside the model vocab [0, {cfg.vocab_size})")
    s0 = len(prompts[0])
    total = s0 + args.max_new
    if total > cfg.max_seq_len:
        # RoPE extrapolates silently past the training window: refuse,
        # before the checkpoint is read.
        raise SystemExit(
            f"prompt ({s0}) + --max-new ({args.max_new}) = {total} exceeds "
            f"the model context {cfg.max_seq_len}")
    if args.mesh:
        check_decode_mesh(sizes, cfg, args.model)
    device = require_device(args.device)
    # Forms the world of a multi-process job (idempotent); a one-process
    # job skips it.
    rdzv = bootstrap.initialize(device_type=device.type)
    if rdzv.is_distributed:
        device = bootstrap.process_device(rdzv.process_id, device.type)
    try:
        mesh = create_mesh(device=device, **sizes)
    except ValueError as e:
        raise SystemExit(f"--mesh {args.mesh!r}: {e}") from None
    shards = DecodeShards.of(mesh, cfg)

    # Every process reads the whole params to host, as JAX's reader does
    # on every host, and keeps its slices.
    step, params = read_llama_params(args.checkpoint_dir, args.model)
    check_fit(params, cfg, step, args.model)
    names = list(params)
    weights = shard_decode_weights(
        cfg, ((n, params.pop(n)) for n in names), shards, device)
    generator = None
    if args.temperature > 0:
        generator = torch.Generator(device=device).manual_seed(args.seed)
    out = generate(cfg, torch.tensor(prompts, device=device),
                   max_new=args.max_new, temperature=args.temperature,
                   generator=generator, weights=weights, shards=shards)
    if rdzv.process_id != 0:
        return 0  # one JSON line a prompt per job, not per process
    for row, p in zip(out.tolist(), prompts):
        print(json.dumps({"step": step, "prompt": p, "tokens": row,
                          "new": row[s0:]}))
    return 0


if __name__ == "__main__":
    from .train import run_as_process

    raise SystemExit(run_as_process(main))
