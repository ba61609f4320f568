"""The readings a cell's limits are set from (not part of a benchmark
run): on the chip, at the cell's own size, in one process

- for each of ``--seeds``: the program's checked steps against the f32
  reference (the lower readings: sound runs of the program);
- for each of ``--control-seeds`` (a subset of ``--seeds``, whose f32
  reference is reused): the control, the reference computed in fp8 in
  the program's place, and the faults planted in the reference in the
  program's place: ``half`` (each step on half its rows, the mean over
  the rest) and ``answer`` (each step's loss read 2% high, worked out
  from the f32 reference's readings).

    python3 perfbench/calibrate.py --workload <cell> --seeds 1,2,...,12 \\
        --control-seeds 1,2,3 [--out chiprun_out/calib.jsonl]

One JSON line a reading on standard output (and appended to ``--out``):
``{"seed", "side", "numbers": {loss_gap, grad_gap, change_gap}}``; a
last line with each number's lower reading (the largest of the
program's) and the smallest reading of each other side."""

from __future__ import annotations

import argparse
import json
import shutil
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from perfbench import check, run, spec  # noqa: E402


def readings(cell, seeds, control_seeds, device, emit) -> None:
    """Emit each seed's readings (``emit(record)``)."""
    for seed in seeds:
        workdir = tempfile.mkdtemp(prefix="perfbench-calib-")
        try:
            t0 = time.perf_counter()
            prog = run.Program(cell, seed, device, workdir)
            prog.free()
            t1 = time.perf_counter()
            ref = prog.reference()
            t2 = time.perf_counter()
            emit({"seed": seed, "side": "program",
                  "numbers": check.gaps(prog.signature, ref),
                  "leaves": check.per_leaf(prog.signature, ref),
                  "reference_grad": ref.grad,
                  "program_s": t1 - t0, "reference_s": t2 - t1,
                  "losses": prog.signature.losses,
                  "reference_losses": ref.losses})
            if seed in control_seeds:
                for side, kw in (("control_fp8", dict(precision="fp8")),
                                 ("fault_half", dict(fault="half"))):
                    t = time.perf_counter()
                    got = prog.reference(**kw)
                    emit({"seed": seed, "side": side,
                          "numbers": check.gaps(got, ref),
                          "leaves": check.per_leaf(got, ref),
                          "seconds": time.perf_counter() - t})
                # Each step's loss read 2% high, the rest as the reference.
                got = check.Signature([x * 1.02 for x in ref.losses],
                                      ref.grad, ref.change, ref.grad_sample)
                emit({"seed": seed, "side": "fault_answer",
                      "numbers": check.gaps(got, ref)})
        finally:
            shutil.rmtree(workdir, ignore_errors=True)


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    p.add_argument("--out", default="")
    a = p.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    cell = spec.load(a.workload)
    seeds = [int(s) for s in a.seeds.split(",") if s]
    control = {int(s) for s in a.control_seeds.split(",") if s}
    lines = []

    def emit(rec):
        rec["workload"] = a.workload
        line = json.dumps(rec)
        lines.append(rec)
        print(line, flush=True)
        if a.out:
            with open(a.out, "a") as f:
                f.write(line + "\n")

    readings(cell, seeds, control, torch.device("cuda", 0), emit)
    summary = {"workload": a.workload, "summary": {}}
    for side in sorted({r["side"] for r in lines}):
        recs = [r["numbers"] for r in lines if r["side"] == side]
        pick = max if side == "program" else min
        summary["summary"][side] = {
            n: pick(r[n] for r in recs) for n in check.NUMBERS}
    emit(summary)
    return 0


if __name__ == "__main__":
    sys.exit(main())
