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
gives the same tokens).

Runs on ``cuda`` by default (raising when no GPU is present) and on the
CPU with ``--device cpu``. Sharded and multi-process decoding
(``--mesh``) are not ported yet.
"""

from __future__ import annotations

import argparse
import json
import sys


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
                   help="sharded decoding; not ported yet (ROADMAP.md queue "
                        "(a) item 14)")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="where to decode; cuda raises when no GPU is present "
                        "(the run never moves to the CPU on its own)")
    return p


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
    if args.mesh:
        raise SystemExit(
            f"--mesh {args.mesh} (sharded and multi-process decoding) is not "
            f"ported yet (ROADMAP.md queue (a) item 14)")
    from ..launcher.bootstrap import RendezvousConfig

    if RendezvousConfig.from_env().is_distributed:
        raise SystemExit(
            "multi-process decoding is not ported yet (ROADMAP.md queue (a) "
            "item 14); run cmd.generate as one process")

    import torch

    from ..models import llama as lib
    from ..models.generate import generate
    from ..ops._common import require_device
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
    device = require_device(args.device)

    step, params = read_llama_params(args.checkpoint_dir, args.model)
    model = lib.Llama(cfg, device=device)
    try:
        model.load_state_dict(params)
    except RuntimeError as e:
        raise SystemExit(f"checkpoint at step {step} does not fit --model "
                         f"{args.model}: {e}") from None
    del params
    model.eval()
    generator = None
    if args.temperature > 0:
        generator = torch.Generator(device=device).manual_seed(args.seed)
    out = generate(model, torch.tensor(prompts, device=device),
                   max_new=args.max_new, temperature=args.temperature,
                   generator=generator)
    for row, p in zip(out.tolist(), prompts):
        print(json.dumps({"step": step, "prompt": p, "tokens": row,
                          "new": row[s0:]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
