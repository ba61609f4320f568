"""Held-out evaluation (loss / perplexity) from a trainer checkpoint (port
of ``mpi_operator_tpu/cmd/eval.py``).

Reads the newest checkpoint the port's ``cmd.train`` wrote (its
``params`` entry only), streams a pre-tokenized corpus through the Llama
model with no optimizer and no autograd, and prints one JSON line with
the token-weighted mean cross-entropy and perplexity, with the JAX
command's keys and rounding (an MoE model's loss is the pure CE, without
the router's load-balance term):

    python -m mpi_operator_tpu_torch.cmd.eval \\
        --checkpoint-dir /ckpt/llama --model llama-tiny \\
        --data corpus.u32 --batch 8 --batches 50

Runs on ``cuda`` by default (raising when no GPU is present) and on the
CPU with ``--device cpu``. Attention takes the flash forward kernel
(``ops/attention.py``); no backward kernel runs.

Across processes (the rendezvous env, as ``cmd.train`` reads it) with
``--mesh`` over dp, fsdp and tp (dp over every process by default): each
process evaluates its rows of each batch (``ds.rows``) with the
parameters laid out as the trainer lays them out, the summed loss and
token count are added across the world, and only process 0 prints.
"""

from __future__ import annotations

import argparse
import json


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="tpujob-eval-torch",
        description="held-out loss/perplexity from a cmd.train checkpoint",
    )
    p.add_argument("--checkpoint-dir", required=True)
    p.add_argument("--model", default="llama-tiny",
                   help="llama3-8b|llama-tiny|mixtral-8x7b|llama-moe-tiny "
                        "(must match the training run)")
    p.add_argument("--data", required=True,
                   help="binary little-endian uint32 token file "
                        "(data/loader.py format, same as cmd.train --data)")
    p.add_argument("--batch", type=int, default=8, help="global batch size")
    p.add_argument("--batches", type=int, default=0,
                   help="number of batches to evaluate (0 = one full "
                        "epoch of distinct sequences)")
    p.add_argument("--seq-len", type=int, default=0,
                   help="sequence length (0 = the model's max_seq_len)")
    p.add_argument("--seed", type=int, default=0,
                   help="epoch-shuffle seed (fixed seed = fixed eval set)")
    p.add_argument("--mesh", default="",
                   help="axis=size pairs over dp, fsdp and tp (default: dp "
                        "over every process)")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="where to evaluate; cuda raises when no GPU is "
                        "present (the run never moves to the CPU on its own)")
    return p


def evaluate(model, ds, batch: int, n_batches: int, device,
             mesh=None) -> tuple:
    """Token-weighted mean next-token cross-entropy of ``model`` over
    batches 0..n_batches-1 of ``ds`` (rows ``ds.rows(b, batch, lo, hi)``,
    as the JAX command reads them: all of them, or this process's rows on
    a ``mesh`` of several processes). Returns ``(mean, tokens)`` over the
    whole batches.

    Each batch's ids are checked on the host against the vocabulary (on
    the card an out-of-range id is a device-side assert that kills the
    context). The loss sum and token count accumulate on the device; the
    one host sync (and, across processes, the one collective) is at the
    end."""
    import numpy as np
    import torch

    from ..models import llama as lib
    from ..parallel.mesh import TP, world_size
    from ..parallel.sharding import local_rows

    vocab = model.config.vocab_size
    ranges = [(0, batch)] if mesh is None else local_rows(batch, mesh)
    totals = torch.zeros(2, dtype=torch.float64, device=device)
    # no_grad rather than inference_mode: sharded parameters (DTensor,
    # FSDP2) take part in autograd-aware dispatch even here.
    with torch.no_grad():
        for b in range(n_batches):
            rows = np.concatenate([ds.rows(b, batch, lo, hi)
                                   for lo, hi in ranges])
            top = int(rows.max())
            if top >= vocab:
                raise SystemExit(
                    f"batch {b} holds token id {top}, outside the "
                    f"{vocab}-token vocabulary of the model"
                )
            tokens = torch.as_tensor(rows.astype(np.int64)).to(
                device, non_blocking=True)
            n = (tokens.shape[1] - 1) * tokens.shape[0]
            # Pure CE: the MoE load-balance term is a training
            # objective, not a model-quality number.
            loss = lib.loss_fn(model, tokens, include_aux=False)
            totals[0] += loss.double() * n
            totals[1] += n
    if world_size() > 1:
        import torch.distributed as dist

        # A tp rank holds its peers' rows: the world's sums count each
        # row tp times, which the mean does not see; the token count is
        # divided back.
        dist.all_reduce(totals)
        totals /= mesh.axis_size(TP) if mesh is not None else 1
    total, count = totals.tolist()
    return total / max(count, 1.0), int(count)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.batch < 1:
        raise SystemExit("--batch must be >= 1")
    if args.batches < 0:
        raise SystemExit("--batches must be >= 0 (0 = one full epoch)")
    from .train import parse_mesh_spec

    sizes = parse_mesh_spec(args.mesh)
    bad = [a for a, n in sizes.items() if a not in ("dp", "fsdp", "tp")
           and n > 1]
    if bad:
        raise SystemExit(f"eval meshes take dp/fsdp/tp; {bad} have no "
                         f"eval-time meaning here")

    import math

    from ..data import TokenDataset
    from ..launcher import bootstrap
    from ..models import llama as lib
    from ..ops._common import require_device
    from ..parallel.mesh import batch_shards, create_mesh
    from ..parallel.sharding import shard_params
    from ..utils.checkpoint import read_llama_params

    device = require_device(args.device)
    # Forms the world of a multi-process job (idempotent); a one-process
    # job skips it.
    rdzv = bootstrap.initialize(device_type=device.type)
    if rdzv.is_distributed:
        device = bootstrap.process_device(rdzv.process_id, device.type)
    try:
        cfg = lib.config_for(args.model, attention_impl="flash")
    except KeyError:
        raise SystemExit(f"unknown --model {args.model!r} (llama family only)")
    if cfg.is_moe and (sizes.get("tp", 1) > 1 or sizes.get("fsdp", 1) > 1):
        raise SystemExit(f"--mesh {args.mesh} with an MoE model is not "
                         f"ported yet (ROADMAP.md queue (a) item 13)")
    seq_len = args.seq_len or cfg.max_seq_len
    if seq_len > cfg.max_seq_len:
        raise SystemExit(
            f"--seq-len {seq_len} exceeds the model context {cfg.max_seq_len}"
        )

    try:
        mesh = create_mesh(device=device, **sizes)
    except ValueError as e:
        raise SystemExit(f"--mesh {args.mesh!r}: {e}") from None
    if args.batch % batch_shards(mesh):
        raise SystemExit(f"--batch {args.batch} not divisible by the dp*fsdp "
                         f"shard count {batch_shards(mesh)}")

    step, params = read_llama_params(args.checkpoint_dir, args.model)
    model = lib.Llama(cfg, device=device)
    try:
        model.load_state_dict(params)
    except RuntimeError as e:
        raise SystemExit(f"checkpoint at step {step} does not fit "
                         f"--model {args.model}: {e}") from None
    model.eval()
    shard_params(model, mesh, tp_plan=lambda: lib.tensor_parallel_plan(
        model, mesh.axis_size("tp")))

    ds = TokenDataset(args.data, seq_len, seed=args.seed)
    try:
        n_batches = args.batches or max(1, ds.num_sequences // args.batch)
        mean, tokens = evaluate(model, ds, args.batch, n_batches, device,
                                mesh)
    finally:
        ds.close()
    if rdzv.process_id != 0:
        return 0  # one JSON line per job, not per process
    print(json.dumps({
        "step": step,
        "model": args.model,
        "batches": n_batches,
        "tokens": tokens,
        "loss": round(mean, 6),
        "perplexity": round(math.exp(mean), 4),
    }))
    return 0


if __name__ == "__main__":
    from .train import run_as_process

    raise SystemExit(run_as_process(main))
