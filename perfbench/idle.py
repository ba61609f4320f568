"""Where the device idles in a cell's window, by the program's range the
host was in:

    python3 perfbench/idle.py --workload <cell> --seed <n> --seconds <s>

A diagnostic beside ``run.py``, not one of the cell's runs: it sets the
cell up as ``run.py`` does and traces a window of the device's activity
and, of the host's side, only ``record_function`` ranges: the program's
(``utils/torchtrace.py``, armed while the profiler runs), and none of
the operators whose recording slowed BERT's step by half. Each idle gap
of the device is charged to the innermost program range open on the
thread that launched the operation ending the gap; failing that, to the
step phase (``step.*``) open then on any thread; else to ``outside``.
Gaps after the last step phase, the harness's own reads, are left out.

The last line of standard output is JSON: ``steps``, ``window_s``,
``busy_s`` (the union of the device's operations), ``idle_s`` (the gaps
charged, which ``window_s - busy_s`` bounds) and ``idle_by_range``
(``[[range, s], ...]``, largest first).
"""

from __future__ import annotations

import argparse
import bisect
import contextlib
import json
import os
import shutil
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

OUTSIDE = "outside"
STEP = "step."


@contextlib.contextmanager
def _user_scope_only():
    """The profiler started inside records, of the host's side, only
    ``record_function`` ranges (the user scope), not every operator."""
    from torch._C._profiler import RecordScope
    from torch.autograd import profiler as autograd_profiler

    enable = autograd_profiler._enable_profiler

    def scoped(config, activities, *_, **__):
        enable(config, activities, {RecordScope.USER_SCOPE})

    autograd_profiler._enable_profiler = scoped
    try:
        yield
    finally:
        autograd_profiler._enable_profiler = enable


class _Timeline:
    """The ranges open on one thread over time, from their intervals:
    at each change point, the open ones ordered by their start (the last
    the innermost)."""

    def __init__(self, intervals):
        edges = []
        for i, (start, end, _) in enumerate(intervals):
            edges.append((start, 1, i))
            edges.append((end, 0, i))
        edges.sort()
        self.times, self.open = [], []
        active = set()
        for t, kind, i in edges:
            (active.add if kind else active.discard)(i)
            now = tuple(intervals[j][2] for j in sorted(
                active, key=lambda j: intervals[j][0]))
            if self.times and self.times[-1] == t:
                self.open[-1] = now
            else:
                self.times.append(t)
                self.open.append(now)

    def at(self, t) -> tuple:
        i = bisect.bisect_right(self.times, t) - 1
        return self.open[i] if i >= 0 else ()


def collect(events, names: set, backward: str):
    """(annotations {thread: [(start, end, name)]}, launches
    {correlation: (thread, start)}, device [(start, end, correlation)])
    from the profiler's events, the annotations those of ``names`` and
    their backward parts. A thread is the host's thread id
    (``device_resource_id`` of a host event): recording the user scope
    alone leaves every launch the profiler's own ``start_thread_id``."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    ann, launches, device = {}, {}, []
    for e in events:
        start = e.start_ns()
        if e.device_type() == cuda:
            if not e.is_user_annotation():
                device.append((start, start + e.duration_ns(),
                               e.correlation_id()))
            continue
        name = e.name()
        if e.is_user_annotation():
            base = name[:-len(backward)] if name.endswith(backward) else name
            if base in names:
                ann.setdefault(e.device_resource_id(), []).append(
                    (start, start + e.duration_ns(), name))
        elif name.startswith("cu") and "::" not in name:
            launches[e.correlation_id()] = (e.device_resource_id(), start)
    return ann, launches, device


def idle_by_range(ann: dict, launches: dict, device: list) -> dict:
    """``busy_s``, ``idle_s`` and ``idle_by_range`` of the collected
    events (times in ns)."""
    steps = [iv for ivs in ann.values() for iv in ivs
             if iv[2].startswith(STEP)]
    phase = _Timeline(steps)
    lines = {th: _Timeline(ivs) for th, ivs in ann.items()}
    last = max((end for _, end, _ in steps), default=None)
    busy, idle = 0, {}
    cur_s = cur_e = None
    for start, end, corr in sorted(device):
        if cur_e is None:
            cur_s, cur_e = start, end
            continue
        if start <= cur_e:
            cur_e = max(cur_e, end)
            continue
        busy += cur_e - cur_s
        where = launches.get(corr)
        if where is None or last is None or where[1] <= last:
            label = OUTSIDE
            if where is not None:
                line = lines.get(where[0])
                opened = (line.at(where[1]) if line else ()) or (
                    phase.at(where[1]))
                label = opened[-1] if opened else OUTSIDE
            idle[label] = idle.get(label, 0) + (start - cur_e)
        cur_s, cur_e = start, end
    if cur_e is not None:
        busy += cur_e - cur_s
    ordered = sorted(([k, v / 1e9] for k, v in idle.items()),
                     key=lambda kv: -kv[1])
    return {"busy_s": busy / 1e9, "idle_s": sum(v for _, v in ordered),
            "idle_by_range": ordered}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    a = p.parse_args(argv)

    import torch
    from torch.profiler import ProfilerActivity, profile

    from mpi_operator_tpu_torch.utils import torchtrace
    from perfbench import run, spec

    cell = spec.load(a.workload)
    cuda = torch.cuda.is_available()
    device = torch.device("cuda", 0) if cuda else torch.device("cpu")
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    prof = profile(activities=acts)
    workdir = tempfile.mkdtemp(prefix="perfbench-idle-")
    try:
        prog = run.Program(cell, a.seed, device, workdir)
        try:
            prog.work.step_fn(*prog.feed.next())
            run._sync(device)
            with _user_scope_only() if cuda else contextlib.nullcontext():
                prof.start()
            window = run._window(prog.work, prog.feed, device, a.seconds)
            prof.stop()
        finally:
            prog.free()
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    out = idle_by_range(*collect(prof.profiler.kineto_results.events(),
                                 set(torchtrace.RANGES), torchtrace.BACKWARD))
    print(json.dumps({"steps": window["steps"],
                      "window_s": window["seconds"], **out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
