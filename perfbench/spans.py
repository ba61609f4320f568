"""The program's own ranges, counters and notes over the traced window
(``mpi_operator_tpu_torch/utils/torchtrace.py``: ``timed_range``,
``add_count``, ``spans``, ``counts``, ``notes``), reduced to what the
per-layer readers read.

The program arms its ranges while a torch profiler runs, so the traced
window's profiler (``trace.py``) arms them for the window's steps and no
others. Each range part times itself: CUDA events at its edges on the
card, its host edges everywhere. A range's time is its parts', its
backward part ``<range>.bwd`` included, less any remat recompute inside
a backward part: a forward range opened inside a backward part counts in
its own range, not in the backward parts around it. A step phase
(``step.*``) keeps the recompute: ``step.backward`` is the whole
backward, which autograd's own thread runs while the calling thread
waits inside ``step.backward``.

Against a program without these ranges every reading is None."""

from __future__ import annotations

import bisect
import dataclasses
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
STEP = "step."


@dataclasses.dataclass
class Program:
    """What the readers read of the program over the window."""
    ranges: dict    # range -> seconds (on the device where timed there)
    host: dict      # range -> host seconds
    paths: list     # [(ranges open, outermost first), exclusive s]
    counts: dict    # counter -> its sum
    syncs: int      # device-to-host syncs, the harness's own left out
    loads: list     # kernel libraries built or loaded


def _base(name: str, backward: str) -> str:
    return name[:-len(backward)] if name.endswith(backward) else name


def reduce_spans(spans: list, backward: str = ".bwd"):
    """(ranges, host, paths) of ``torchtrace.spans()``'s records
    ``(name, parent, thread, start_ns, host_s, device_s)``; a part still
    open counts nothing."""
    n = len(spans)
    took = [0.0] * n
    for i, (_, _, _, _, host, dev) in enumerate(spans):
        took[i] = dev if dev is not None else (host or 0.0)
    # A part opened with no other open on its thread lies in the step
    # phase open then on any thread.
    phases = sorted((s[3], s[3] + int(1e9 * s[4]), i)
                    for i, s in enumerate(spans)
                    if s[0].startswith(STEP) and s[4] is not None)
    starts = [p[0] for p in phases]
    outer = []
    for name, parent, _, t0, _, _ in spans:
        if parent < 0 and not name.startswith(STEP):
            k = bisect.bisect_right(starts, t0) - 1
            if k >= 0 and t0 <= phases[k][1]:
                parent = phases[k][2]
        outer.append(parent)

    deduct = [0.0] * n
    for i, (name, parent, _, _, _, _) in enumerate(spans):
        if (parent >= 0 and spans[parent][0].endswith(backward)
                and not name.endswith(backward)
                and not name.startswith(STEP)):
            a = parent
            while a >= 0 and spans[a][0].endswith(backward):
                deduct[a] += took[i]
                a = spans[a][1]

    ranges: dict = {}
    host: dict = {}
    inner = [0.0] * n
    chains = [()] * n
    for i, (name, _, _, _, h, _) in enumerate(spans):
        base = _base(name, backward)
        ranges[base] = ranges.get(base, 0.0) + took[i] - deduct[i]
        host[base] = host.get(base, 0.0) + (h or 0.0)
        p = outer[i]
        chains[i] = (chains[p] if p >= 0 else ()) + (name,)
        if p >= 0:
            inner[p] += took[i]
    paths: dict = {}
    for i in range(n):
        paths[chains[i]] = paths.get(chains[i], 0.0) + took[i] - inner[i]
    return ranges, host, sorted(paths.items(), key=lambda kv: -kv[1])


def _harness(site: str) -> bool:
    return os.path.abspath(site).startswith(HERE + os.sep)


_read: dict = {}


def program(run):
    """The program's ``Program`` over ``run``'s window, reduced once
    (and its readings written on stderr), or None where the program
    recorded none."""
    if id(run) not in _read:
        _read[id(run)] = _program(run)
    return _read[id(run)]


def _program(run):
    try:
        from mpi_operator_tpu_torch.utils import torchtrace as tt
    except ImportError:
        return None
    if not hasattr(tt, "spans"):
        return None
    records = tt.spans()
    if not records:
        return None
    ranges, host, paths = reduce_spans(records, tt.BACKWARD)
    notes = tt.notes()
    out = Program(
        ranges, host, paths, {k: int(v) for k, v in tt.counts().items()},
        sum(n for (kind, site), n in notes.items()
            if kind == "sync" and not _harness(site)),
        sorted(site for kind, site in notes if kind == "kernel load"))
    steps = max(run.steps, 1)
    print(f"spans: kernel builds or loads in the window: {len(out.loads)} "
          f"{out.loads}", file=sys.stderr)
    print(f"spans: syncs in the window: "
          f"{dict((s, n) for (k, s), n in notes.items() if k == 'sync')}",
          file=sys.stderr)
    for chain, s in paths[:40]:
        print(f"spans: {1e3 * s / steps:10.4f} ms a step  "
              f"{' > '.join(chain)}", file=sys.stderr)
    return out


def range_ms(run, *names):
    """Milliseconds an optimizer step inside any of ``names`` (on the
    device where timed there), or None where the run holds none."""
    p = program(run)
    if p is None or not run.steps or not any(n in p.ranges for n in names):
        return None
    return 1e3 * sum(p.ranges.get(n, 0.0) for n in names) / run.steps
