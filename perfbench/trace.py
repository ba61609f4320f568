"""The traced run: profiler ranges that the harness opens around the
calls into a layer, and the reduction of ``torch.profiler``'s events to
what the per-layer readers read.

A reader names its ranges (``RANGES = {range: module class}``). Each
module of that class gets forward hooks that open and close
``perfbench::<range>``. A kernel belongs to a range when the host
launched it inside the range (the forward, and under remat its
recompute) or inside the backward of an operator that ran inside it
(the autograd node whose sequence number is that operator's).

The host's operators are recorded only where a cell's metrics need
ranges: recording every operator costs the host tens of microseconds
each, which slowed BERT's step of many small launches by half, while the
device's activity alone costs it little."""

from __future__ import annotations

import bisect
import dataclasses

import torch

PREFIX = "perfbench::"
BACKWARD = "autograd::engine::evaluate_function"


class Ranges:
    """The forward hooks of the given ranges on ``model``'s modules."""

    def __init__(self, ranges: dict, model):
        self._handles = []
        for name, cls in ranges.items():
            for module in model.modules():
                if type(module).__name__ == cls:
                    enter, leave = self._pair(name)
                    self._handles += [
                        module.register_forward_pre_hook(enter),
                        module.register_forward_hook(leave)]

    @staticmethod
    def _pair(name: str):
        stack = []

        def enter(*_):
            rf = torch.autograd.profiler.record_function(PREFIX + name)
            rf.__enter__()
            stack.append(rf)

        def leave(*_):
            if stack:
                stack.pop().__exit__(None, None, None)

        return enter, leave

    def remove(self) -> None:
        for h in self._handles:
            h.remove()
        self._handles = []


def profiler(host_ops: bool):
    """A profiler of the device's activity, and of the host's operators
    when ``host_ops`` (or when there is no device)."""
    from torch.profiler import ProfilerActivity, profile

    acts = []
    if host_ops or not torch.cuda.is_available():
        acts.append(ProfilerActivity.CPU)
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    return profile(activities=acts)


@dataclasses.dataclass
class Trace:
    """What the readers read of a traced window."""
    window_s: float           # the traced window's wall seconds
    busy_s: float             # union of the device's operations in it
    kernels: dict             # name -> [launches, device seconds]
    ranges: dict              # range -> device seconds of its kernels
    gaps: list                # [(what the host launched next, idle s)]


class _Spans:
    """Intervals on each host thread, for containment queries."""

    def __init__(self):
        self._raw: dict = {}
        self._merged: dict = {}

    def add(self, thread, start, end):
        self._raw.setdefault(thread, []).append((start, end))
        self._merged.pop(thread, None)

    def _m(self, thread):
        if thread not in self._merged:
            out = []
            for s, e in sorted(self._raw.get(thread, [])):
                if out and s <= out[-1][1]:
                    out[-1][1] = max(out[-1][1], e)
                else:
                    out.append([s, e])
            self._merged[thread] = ([s for s, _ in out], [e for _, e in out])
        return self._merged[thread]

    def contains(self, thread, t) -> bool:
        starts, ends = self._m(thread)
        i = bisect.bisect_right(starts, t) - 1
        return i >= 0 and t <= ends[i]


def _short(kernel: str) -> str:
    """A device op's name without its template arguments and signature:
    where the host's operators were not recorded, a gap is named by the
    operation that ended it."""
    name = kernel.split("(")[0].split("<")[0]
    return name.replace("void ", "")[:80]


def reduce(prof, ranges, window_s: float, top_gaps: int = 10) -> Trace:
    """The profiler's events of one traced window as a ``Trace``."""
    cuda = torch.autograd.DeviceType.CUDA
    device = []          # (start, end, name, correlation, linked op)
    launches = {}        # runtime correlation -> (thread, start)
    op_names = {}        # host op correlation -> name
    fwd = {r: _Spans() for r in ranges}
    ops = []             # (thread, start, sequence number) of host ops
    backward = []        # (forward thread, sequence nr, thread, start, end)
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        start = e.start_ns()
        end = start + e.duration_ns()
        if e.device_type() == cuda:
            if not e.is_user_annotation():
                device.append((start, end, name, e.correlation_id(),
                               e.linked_correlation_id()))
            continue
        if e.is_user_annotation():
            if name.startswith(PREFIX) and name[len(PREFIX):] in fwd:
                fwd[name[len(PREFIX):]].add(e.start_thread_id(), start, end)
            continue
        if name.startswith(BACKWARD):
            backward.append((e.fwd_thread_id(), e.sequence_nr(),
                             e.start_thread_id(), start, end))
        elif name.startswith("cu") and "::" not in name:
            launches[e.correlation_id()] = (e.start_thread_id(), start)
            continue
        corr = e.correlation_id()
        if corr > 0 and (corr not in op_names or "::" in name):
            # The driver's lazy-loading events share the launching op's id.
            op_names[corr] = name
        if e.sequence_nr() >= 0:
            ops.append((e.start_thread_id(), start, e.sequence_nr()))

    spans = {}
    for r, f in fwd.items():
        seqs = {(th, seq) for th, t, seq in ops if f.contains(th, t)}
        s = _Spans()
        for th, raw in f._raw.items():
            for a, b in raw:
                s.add(th, a, b)
        for fth, seq, th, a, b in backward:
            if (fth, seq) in seqs:
                s.add(th, a, b)
        spans[r] = s

    kernels: dict = {}
    in_range = {r: 0 for r in ranges}
    for start, end, name, corr, _ in device:
        k = kernels.setdefault(name, [0, 0.0])
        k[0] += 1
        k[1] += (end - start) / 1e9
        where = launches.get(corr)
        if where is None:
            continue
        for r, s in spans.items():
            if s.contains(*where):
                in_range[r] += end - start

    busy, gaps = 0, {}
    device.sort()
    cur_s = cur_e = None
    for start, end, name, _, linked in device:
        if cur_e is None:
            cur_s, cur_e = start, end
            continue
        if start > cur_e:
            busy += cur_e - cur_s
            label = op_names.get(linked) if linked > 0 else None
            label = label or _short(name)
            gaps[label] = gaps.get(label, 0.0) + (start - cur_e) / 1e9
            cur_s, cur_e = start, end
        else:
            cur_e = max(cur_e, end)
    if cur_e is not None:
        busy += cur_e - cur_s
    top = sorted(gaps.items(), key=lambda kv: -kv[1])[:top_gaps]
    return Trace(window_s, busy / 1e9, kernels,
                 {r: ns / 1e9 for r, ns in in_range.items()}, top)
