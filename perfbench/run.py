"""One cell of the port's benchmark, run once:

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Set-up writes the cell's token file from the seed into TMPDIR, builds the
cell's job through the trainer's own objects, overwrites its weights with
the seed's (drawn on the device), runs the checked steps through the
window's own call and feed, and one more step. The window then trains
for ``--seconds`` (with ``--trace 1`` under ``torch.profiler``), the
device synchronized only at its two ends, each step's time from CUDA
events at its boundaries. After it the program's state is freed and the
plain reference follows the checked steps from the same weights and
batches (``check.py``). The last line of standard output is the result:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer ones), ``device``
(with ``--trace 1`` also ``busy_s`` and ``window_s``, and a
``breakdown``), and last ``checked``: each compared number beside its
limit, which also end standard error.

Exits 2, printing no result, without a CUDA device for each chip the
cell asks, and 3 if JAX, flax or the JAX package is loaded once the
window has closed."""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE.parent))
# Caches at fixed paths inside the checkout, so only a cell's first run in
# a checkout builds (the flash kernels' own cache is the program's
# mpi_operator_tpu_torch/_build/).
for _var, _sub in (("TRITON_CACHE_DIR", "triton"),
                   ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
    os.environ[_var] = str(HERE / ".cache" / _sub)
os.environ.setdefault("OMP_NUM_THREADS", "4")

FORBIDDEN = ("jax", "jaxlib", "flax", "mpi_operator_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name (before the first dot) is one
    of FORBIDDEN, compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


@dataclasses.dataclass
class Run:
    """What the metric readers read of one run."""
    cell: object
    setup_s: float
    window_s: float
    steps: int
    step_ms: list
    tokens: int
    waits: list
    peak_bytes: int
    trace: object = None


def trainer_seed(seed: int) -> int:
    """The trainer's --seed (data order, BERT's masking), which numpy's
    RandomState(seed + step) must take."""
    return seed % (1 << 31)


def _sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _ranges(cell) -> dict:
    from perfbench import spec

    out = {}
    for m in cell.per_layer:
        out.update(getattr(spec.reader(m["name"]), "RANGES", {}))
    return out


class Program:
    """The cell's job, set up: the token file written from the seed, the
    workload built through the trainer, the seed's weights loaded, and
    the checked steps run through the window's own call and feed, which
    give the program's ``Signature``."""

    def __init__(self, cell, seed: int, device, workdir: str):
        from perfbench import check, spec, tokens, trainer, weights

        self.cell, self.seed, self.device = cell, seed, device
        marks = self.phases = []

        def mark(name):
            marks.append((name, time.perf_counter()))

        mark("imports")
        self.family = spec.family_module("reference", cell.family)
        self.leaves = self.family.leaves(cell.config)
        self.data_seed = trainer_seed(seed)
        self.data = os.path.join(workdir, "corpus.u32")
        tokens.write(self.data, cell.traffic, cell.config["vocab_size"], seed)
        mark("token_file")
        self.args, self.work = trainer.build(cell, self.data, self.data_seed,
                                             device)
        mark("build_workload")
        weights.load(self.work.model, self.leaves, seed)
        mark("weights")
        self.feed = trainer.Feed(self.work, self.args, device)
        self.n_check = int(cell.workload["check"]["steps"])
        beta1 = cell.config["optimizer"]["betas"][0]
        losses, grad, sample = [], {}, {}
        for step in range(1, self.n_check + 1):
            losses.append(float(self.work.step_fn(*self.feed.next())))
            if step == 1:
                grad, sample = check.gradient_readings(
                    check.first_moments(self.work.model, self.work.optimizer),
                    self.leaves, seed, device, scale=1 / (1 - beta1))
        mark("checked_steps")
        self.signature = check.Signature(
            losses, grad, check.changes(self.work.model, self.leaves, seed),
            sample)
        mark("changes")

    def free(self) -> None:
        """Stop the feed and drop the program's state from the device."""
        import torch

        self.feed.close()
        self.work = self.feed = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference(self, precision: str = "f32", fault: str = ""):
        """The reference's ``Signature`` over the checked steps."""
        from perfbench.reference import train as ref_train

        batches = [self.family.batch(self.data, self.cell.traffic,
                                     self.cell.config, step, self.data_seed,
                                     self.device)
                   for step in range(self.n_check)]
        return ref_train.run(self.family, self.cell.config, self.cell.traffic,
                             batches, self.seed, self.device, precision,
                             fault)


def execute(cell, seed: int, seconds: float, traced: bool, device,
            t0: float = None) -> dict:
    """Run ``cell`` once on ``device``; the result as a dict."""
    import torch

    from perfbench import check, trace

    t0 = T0 if t0 is None else t0
    workdir = tempfile.mkdtemp(prefix="perfbench-")
    try:
        prog = Program(cell, seed, device, workdir)
        try:
            work, feed = prog.work, prog.feed
            work.step_fn(*feed.next())  # warm after the check's draws
            _sync(device)
            prog.phases.append(("warm_step", time.perf_counter()))
            if device.type == "cuda":
                torch.cuda.reset_peak_memory_stats(device)
            setup_s = time.perf_counter() - t0
            wanted = _ranges(cell) if traced else {}
            if traced:
                ranges = trace.Ranges(wanted, work.model)
                prof = trace.profiler(bool(wanted))
                prof.start()
            window = _window(work, feed, device, seconds)
            if traced:
                prof.stop()
                ranges.remove()
            peak = (torch.cuda.max_memory_allocated(device)
                    if device.type == "cuda" else 0)
            waits = feed.waits[prog.n_check + 1:]
            del work, feed
        finally:
            prog.free()
        run = Run(cell, setup_s, window["seconds"], window["steps"],
                  window["step_ms"], window["steps"] * cell.tokens_per_step(),
                  waits, peak)
        if traced:
            run.trace = trace.reduce(prof, set(wanted), window["seconds"])
            del prof
        numbers = check.gaps(prog.signature, prog.reference())
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    correct, lines = check.verdict(numbers, cell.workload["check"]["limits"])
    marks = [("", t0)] + prog.phases
    lines.insert(0, "setup phases (s): " + ", ".join(
        f"{b[0]} {b[1] - a[1]:.3f}" for a, b in zip(marks, marks[1:])))
    return _result(cell, run, traced, correct, window["failed"], numbers,
                   lines, device)


def _window(work, feed, device, seconds: float) -> dict:
    """Train for ``seconds``; the device synchronized at both ends."""
    import torch

    cuda = device.type == "cuda"
    _sync(device)
    marks = [torch.cuda.Event(enable_timing=True)] if cuda else []
    if cuda:
        marks[0].record()
    stamps = [time.perf_counter()]
    losses = []
    start = stamps[0]
    while True:
        losses.append(work.step_fn(*feed.next()))
        if cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            marks.append(ev)
        else:
            stamps.append(time.perf_counter())
        if time.perf_counter() - start >= seconds:
            break
    _sync(device)
    end = time.perf_counter()
    if cuda:
        step_ms = [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]
    else:
        step_ms = [1e3 * (b - a) for a, b in zip(stamps, stamps[1:])]
    failed = int((~torch.isfinite(torch.stack(losses))).sum())
    return {"seconds": end - start, "steps": len(losses),
            "step_ms": step_ms, "failed": failed}


def _result(cell, run, traced, correct, failed, numbers, lines, device):
    import torch

    from perfbench import spec

    metrics = {}
    for m in (cell.per_layer if traced else cell.end_to_end):
        value = spec.reader(m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    cuda = device.type == "cuda"
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": cell.chips, "memory_peak_bytes": run.peak_bytes}
    out = {"correct": correct, "attempted": run.steps, "failed": failed,
           "metrics": metrics, "device": dev}
    if traced and run.trace is not None:
        dev["busy_s"] = run.trace.busy_s
        dev["window_s"] = run.trace.window_s
        top = sorted(run.trace.kernels.items(), key=lambda kv: -kv[1][1])
        out["breakdown"] = {
            "device_ops": [[n, s] for n, (_, s) in top[:10]],
            "idle_gaps": [[n, s] for n, s in run.trace.gaps]}
    out["checked"] = {n: {"value": numbers[n],
                          "limit": cell.workload["check"]["limits"][n]}
                      for n in numbers}
    out["_lines"] = lines
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)

    from perfbench import spec

    cell = spec.load(a.workload)
    import torch

    if not torch.cuda.is_available() or (
            torch.cuda.device_count() < cell.chips):
        print(f"perfbench: {a.workload} needs {cell.chips} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    if cell.chips != 1:
        print("perfbench: a cell on more than one chip is not built yet",
              file=sys.stderr)
        return 2
    result = execute(cell, a.seed, a.seconds, bool(a.trace),
                     torch.device("cuda", 0))
    found = forbidden_modules()
    if found:
        print(f"perfbench: loaded in this process: {found}", file=sys.stderr)
        return 3
    lines = result.pop("_lines")
    for line in lines:
        print(line, file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
