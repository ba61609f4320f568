"""Runtime kernel-build / host-sync tracer for the training stack (the
port's counterpart of ``mpi_operator_tpu/utils/jaxtrace.py``).

When armed it hooks the two chokepoints of the bug classes the JAX
version watches, in their PyTorch form:

- **compiles** — every kernel library ``ops/_build.py`` builds (``nvcc``,
  ``build``) or loads (``ctypes``, ``kernel``) in this process. The port
  has no jit cache; a build or a load is where it pays compile-like
  cost. One after :func:`note_warmup_complete` is a new instantiation in
  the middle of a run: a shape or path the warmup steps did not cover.

- **device-to-host transfers** — the syncs that copy a CUDA tensor to
  the host: ``.item()``, ``.cpu()``, ``.tolist()``, ``.numpy()`` and
  ``bool()``, ``float()``, ``int()`` of a tensor. Each counts its bytes
  and is attributed to the first caller frame outside torch and outside
  this module, as the JAX version attributes to the first frame outside
  jax. Tensors on the CPU move nothing and are not counted.

Zero cost when off: hooks are installed once, on first :func:`enable`,
and check one module global before doing any work; un-armed processes
never install them. Arm with ``TPU_JAX_TRACE=1`` (the JAX package's
variable, so one job spec arms either package; read when this module is
imported, which ``cmd/train.py`` does) or ``torchtrace.enable()``.

It also holds the step's **named ranges and counters**
(:func:`arm_ranges`, :func:`timed_range`, :func:`add_count`): the phases
of ``parallel/accum.py``'s step, the parameter casts, norms, head and
MoE parts of the models, and the wait for a batch. Armed by hand or
while a torch profiler runs, each range is a ``record_function``, so a
device trace puts every kernel under the range its launch came from,
and each times itself (:func:`spans`: host edges and CUDA events), so
its device time is known without a trace; the syncs and kernel loads
of the armed steps are noted (:func:`notes`). Disarmed (the default)
they cost a few attribute reads a range and touch no tensor.

The report has the JAX version's schema and rides in the trainer's
summary under the same key, ``"jax_trace"``, so a consumer reads either
package::

    {"compiles": {"total": 3, "seconds": 1.82, "after_warmup": 0,
                  "sites": []},
     "transfers": {"count": 2, "bytes": 8, "after_warmup_count": 0,
                   "after_warmup_bytes": 0, "top_sites": {...}},
     "steps_after_warmup": 64,
     "transfer_bytes_per_step": 0.0}
"""

from __future__ import annotations

import os
import sys
import threading
import time
import traceback
from collections import Counter
from typing import Optional

ENV_FLAG = "TPU_JAX_TRACE"

# Frames of caller stack kept per compile-after-warmup sample.
_STACK_DEPTH = 8
# Distinct transfer sites kept in the report.
_TOP_SITES = 8

# The Tensor methods that copy a CUDA tensor to the host.
SYNC_METHODS = ("item", "cpu", "tolist", "numpy", "__bool__", "__float__",
                "__int__")

_SELF_FILE = os.path.abspath(__file__)


def _foreign(filename: str) -> bool:
    fn = filename.replace(os.sep, "/")
    return not ("/torch/" in fn or os.path.abspath(filename) == _SELF_FILE)


def _caller_site() -> str:
    """file:line of the nearest frame outside torch and this module —
    the code that forced the sync or the build."""
    for frame in reversed(traceback.extract_stack()):
        if _foreign(frame.filename):
            return f"{frame.filename}:{frame.lineno}"
    return "<unknown>"


def _caller_stack() -> list[str]:
    frames = [f"{f.filename}:{f.lineno}:{f.name}"
              for f in traceback.extract_stack() if _foreign(f.filename)]
    return frames[-_STACK_DEPTH:]


class TorchTracer:
    """Counts kernel builds/loads and device-to-host syncs, split at the
    warmup boundary. Builds can come from any thread, so all state is
    lock-guarded (the lock is internal, never visible to locktrace)."""

    def __init__(self):
        self._mu = threading.Lock()
        self._warmup_done = False
        self._steps_after_warmup = 0
        self._compiles = 0
        self._compile_seconds = 0.0
        self._compiles_after_warmup = 0
        self._compile_sites: list[dict] = []
        self._transfers = 0
        self._transfer_bytes = 0
        self._transfers_after_warmup = 0
        self._transfer_bytes_after_warmup = 0
        self._transfer_sites: Counter = Counter()

    # -- hook callbacks --------------------------------------------------

    def on_compile(self, duration_secs: float, kernel: str = "") -> None:
        with self._mu:
            self._compiles += 1
            self._compile_seconds += duration_secs
            if self._warmup_done:
                self._compiles_after_warmup += 1
                site = {
                    "seconds": round(duration_secs, 6),
                    "stack": _caller_stack(),
                }
                if kernel:
                    site["kernel"] = kernel
                self._compile_sites.append(site)

    def on_transfer(self, nbytes: int) -> None:
        site = _caller_site()
        with self._mu:
            self._transfers += 1
            self._transfer_bytes += nbytes
            self._transfer_sites[site] += 1
            if self._warmup_done:
                self._transfers_after_warmup += 1
                self._transfer_bytes_after_warmup += nbytes

    # -- step-loop annotations ------------------------------------------

    def note_warmup_complete(self) -> None:
        """The step loop finished warmup (and synced): builds and
        transfers from here on are hot-path regressions."""
        with self._mu:
            self._warmup_done = True

    def note_step(self) -> None:
        with self._mu:
            if self._warmup_done:
                self._steps_after_warmup += 1

    # -- reporting -------------------------------------------------------

    def report(self) -> dict:
        """JSON-friendly summary, attached to the trainer's summary as
        ``"jax_trace"``."""
        with self._mu:
            steps = self._steps_after_warmup
            per_step = (
                self._transfer_bytes_after_warmup / steps if steps else 0.0
            )
            return {
                "compiles": {
                    "total": self._compiles,
                    "seconds": round(self._compile_seconds, 6),
                    "after_warmup": self._compiles_after_warmup,
                    "sites": [dict(s) for s in self._compile_sites],
                },
                "transfers": {
                    "count": self._transfers,
                    "bytes": self._transfer_bytes,
                    "after_warmup_count": self._transfers_after_warmup,
                    "after_warmup_bytes": self._transfer_bytes_after_warmup,
                    "top_sites": dict(
                        self._transfer_sites.most_common(_TOP_SITES)
                    ),
                },
                "steps_after_warmup": steps,
                "transfer_bytes_per_step": round(per_step, 3),
            }


# ----------------------------------------------------------------------
# Process-global switch + hook installation
# ----------------------------------------------------------------------

_tracer: Optional[TorchTracer] = None
_hooks_installed = False


def enabled() -> bool:
    return _tracer is not None


def tracer() -> Optional[TorchTracer]:
    """The active tracer, or None when tracing is off."""
    return _tracer


def enable(active: Optional[TorchTracer] = None) -> TorchTracer:
    """Arm tracing; returns the tracer. Installs the process-wide hooks
    on first use — call before the steps under test (builds that already
    happened are not back-counted)."""
    global _tracer
    _tracer = active if active is not None else TorchTracer()
    _install_hooks()
    return _tracer


def disable() -> None:
    global _tracer
    _tracer = None


def note_warmup_complete() -> None:
    """Module-level convenience: no-op when tracing is off."""
    t = _tracer
    if t is not None:
        t.note_warmup_complete()


def note_step() -> None:
    t = _tracer
    if t is not None:
        t.note_step()


def host_read(x):
    """The explicit device-to-host read of a step boundary: tensor ``x``
    as a Python number (a 0-d tensor) or nested list, ``x.tolist()``. It
    waits for the queued work that produces ``x``, as ``float(x)`` would;
    spelling it so marks the sync as meant, and the static checker's
    host-sync rules (``analysis/torchcheck.py``, TPU503 and TPU506)
    exempt it. When tracing is on it is counted as any ``.tolist()``."""
    return x.tolist()


# ----------------------------------------------------------------------
# Named ranges and counters of the train step
# ----------------------------------------------------------------------

# Every name timed_range is given. A range's backward part is the name
# with BACKWARD appended.
RANGES = (
    "step.forward",    # parallel/accum.py: a microbatch's loss
    "step.backward",   # its .backward(), the remat recompute inside
    "step.optimizer",  # the learning rate set and optimizer.step()
    "step.pipeline",   # a pipeline's forward_backward (models/llama_pp.py)
    "data.wait",       # data/loader.py: Prefetcher waiting for a batch
    "cast",            # an f32 parameter cast to the compute dtype
    "norm",            # RMSNorm, BERT's LayerNorm
    "head",            # the LM / MLM head and its cross-entropy
    "moe",             # models/moe.py: MoEMLP.forward, whole
    "moe.route",       # router product, softmax, routing, their casts
    "moe.dispatch",    # tokens into expert slots (the GShard product)
    "moe.experts",     # the three expert products and SiLU
    "moe.combine",     # expert slots back to tokens, partial sums
)
BACKWARD = ".bwd"

_ranges_armed = False
# name -> device tensor: add_count's sums while armed.
_counts: dict = {}
# (kind, site) -> times, while armed: "sync", "kernel load".
_notes: Counter = Counter()
# Every range part opened while armed (_Span), in the order opened.
_spans: list = []
# .parts: the range parts open on this thread, innermost last.
_open_parts = threading.local()


def arm_ranges(on: bool) -> None:
    """Arm or disarm the named ranges and counters; arming clears what
    they recorded. Arm between steps: a step's forward and its backward
    see the same state. They are armed besides while a torch profiler
    runs, so any profile of the step holds them."""
    global _ranges_armed
    if on:
        _counts.clear()
        _notes.clear()
        _spans.clear()
        _install_hooks()
    _ranges_armed = bool(on)


def _profiling() -> bool:
    """A torch profiler is running: the flag torch keeps for such checks
    (``torch.autograd.profiler._is_profiler_enabled``)."""
    return getattr(sys.modules.get("torch.autograd.profiler"),
                   "_is_profiler_enabled", False)


def ranges_armed() -> bool:
    """Armed by :func:`arm_ranges`, or while a torch profiler runs."""
    return _ranges_armed or _profiling()


class _Disarmed:
    """The one context every disarmed :func:`timed_range` returns: its
    markers hand their tensors back untouched."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def enter(self, *tensors):
        return tensors[0] if len(tensors) == 1 else tensors

    leave = enter


_DISARMED = _Disarmed()
_armed = None


class _Armed:
    """torch, ``record_function`` and the armed ranges' autograd
    functions, made at the first armed range: this module imports no
    torch until then."""

    def __init__(self):
        import torch
        from torch.autograd.profiler import record_function

        _install_hooks()
        self.torch, self.record_function = torch, record_function

        class Entry(torch.autograd.Function):
            """Identity on a range's inputs, one node a call. Its
            backward runs once they all have their gradients: autograd
            runs ready nodes newest first, so after the range's other
            backward work. It closes the range's backward part."""

            @staticmethod
            def forward(ctx, rng, *xs):
                ctx.rng = rng
                ctx.set_materialize_grads(False)
                return tuple(x.view_as(x) for x in xs)

            @staticmethod
            def backward(ctx, *grads):
                ctx.rng._close()
                return (None, *grads)

        class Exit(torch.autograd.Function):
            """Identity on a range's outputs; its backward, once they
            have their gradients, opens the range's backward part."""

            @staticmethod
            def forward(ctx, rng, *xs):
                ctx.rng = rng
                ctx.set_materialize_grads(False)
                return tuple(x.view_as(x) for x in xs)

            @staticmethod
            def backward(ctx, *grads):
                ctx.rng._open()
                return (None, *grads)

        class Cast(torch.autograd.Function):
            """``x.to(dtype)`` of each tensor inside ``cast``, and the
            gradients cast back, as ``to``'s own backward casts them,
            inside ``cast.bwd``: one node for the range and its edges."""

            @staticmethod
            def forward(ctx, dtype, *xs):
                ctx.dtypes = [x.dtype for x in xs]
                ctx.set_materialize_grads(False)
                with _Span("cast"):
                    return tuple(x.to(dtype) if x.dtype != dtype
                                 else x.view_as(x) for x in xs)

            @staticmethod
            def backward(ctx, *grads):
                with _Span("cast" + BACKWARD):
                    return (None, *(None if g is None else g.to(d)
                                    for g, d in zip(grads, ctx.dtypes)))

        self.Entry, self.Exit, self.Cast = Entry, Exit, Cast

    def event(self):
        """A timing event recorded on the current CUDA stream, or None
        where CUDA is not in use (or the stream is being captured)."""
        cuda = self.torch.cuda
        if not cuda.is_initialized() or cuda.is_current_stream_capturing():
            return None
        ev = cuda.Event(enable_timing=True)
        ev.record()
        return ev


def _armed_parts() -> _Armed:
    global _armed
    if _armed is None:
        _armed = _Armed()
    return _armed


def _parts() -> list:
    parts = getattr(_open_parts, "parts", None)
    if parts is None:
        parts = _open_parts.parts = []
    return parts


class _Span:
    """One timed part of a range, opened when made: a
    ``record_function(name)`` on this thread, so a device trace puts the
    kernels launched inside under it, its ``perf_counter_ns`` edges and,
    where CUDA is in use, an event on the current stream at each edge,
    so the part's device time is known with no trace at all."""

    __slots__ = ("name", "parent", "thread", "t0", "t1", "e0", "e1", "_rf")

    def __init__(self, name: str):
        a = _armed_parts()
        self.name = name
        self._rf = a.record_function(name)
        self._rf.__enter__()
        parts = _parts()
        self.parent = parts[-1] if parts else None
        self.thread = threading.get_ident()
        parts.append(self)
        _spans.append(self)
        self.t1 = self.e1 = None
        self.t0 = time.perf_counter_ns()
        self.e0 = a.event()

    def close(self) -> None:
        self.e1 = _armed.event()
        self.t1 = time.perf_counter_ns()
        parts = _parts()
        # A backward part may close after one opened later on its thread.
        for i in range(len(parts) - 1, -1, -1):
            if parts[i] is self:
                del parts[i]
                break
        self._rf.__exit__(None, None, None)
        self._rf = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


class _Range:
    """An armed range. Its forward part is a :class:`_Span` on the
    entering thread. Its backward part ``<name>.bwd`` runs on the thread
    that runs the backward, from the node :meth:`leave` makes to the one
    :meth:`enter` makes (``_Armed.Exit``, ``_Armed.Entry``)."""

    __slots__ = ("name", "_fwd", "_bwd", "_entered", "_done")

    def __init__(self, name: str):
        self.name = name
        self._bwd = None
        self._entered = self._done = False

    def __enter__(self):
        self._fwd = _Span(self.name)
        return self

    def __exit__(self, *exc):
        self._fwd.close()
        return False

    def _marked(self, fn, tensors):
        """``tensors`` with those that take a gradient through one ``fn``
        node."""
        torch = _armed.torch
        out = list(tensors)
        at = [i for i, t in enumerate(tensors)
              if isinstance(t, torch.Tensor) and t.requires_grad]
        if at and torch.is_grad_enabled():
            for i, y in zip(at, fn.apply(self, *(tensors[i] for i in at))):
                out[i] = y
            if fn is _armed.Entry:
                self._entered = True
        return out[0] if len(out) == 1 else tuple(out)

    def enter(self, *tensors):
        """``tensors`` as they cross into the range (inputs, parameters)."""
        return self._marked(_armed.Entry, tensors)

    def leave(self, *tensors):
        """``tensors`` as they leave the range. With no input marked
        (nothing in the range takes a gradient) there is no backward
        part to open."""
        if not self._entered:
            return tensors[0] if len(tensors) == 1 else tensors
        return self._marked(_armed.Exit, tensors)

    def _open(self):
        if self._bwd is None and not self._done:
            self._bwd = _Span(self.name + BACKWARD)

    def _close(self):
        if self._bwd is not None:
            self._bwd.close()
            self._bwd = None
            self._done = True


def timed_range(name: str):
    """The range ``name`` (one of :data:`RANGES`) as a context::

        with torchtrace.timed_range("norm") as r:
            x, scale = r.enter(x, self.scale)
            ...
            return r.leave(out)

    Disarmed, a shared no-op whose ``enter``/``leave`` return their
    tensors. Armed, a timed part around the block, and an identity
    autograd node at ``enter`` and at ``leave`` that time the block's
    backward as ``name + BACKWARD``. Under remat the recompute opens the
    same forward range inside the backward."""
    if not ranges_armed():
        return _DISARMED
    return _Range(name)


# The copies a block cast on entry (cast_block), on the thread that runs
# the block: the forward's, or under remat the backward's.
_blocks = threading.local()


def cast(dtype, *tensors):
    """The ``cast`` range: ``t.to(dtype)`` of each of ``tensors`` (None
    passes), and in the backward the gradients cast back inside
    ``cast.bwd``; the values are ``to``'s either way. Inside a
    :func:`cast_block` that cast them, its copies."""
    if not ranges_armed():
        out = tuple(None if t is None else t.to(dtype) for t in tensors)
        return out[0] if len(out) == 1 else out
    copies = getattr(_blocks, "copies", None)
    if copies is not None:
        try:
            out = tuple(None if t is None else copies[id(t), dtype]
                        for t in tensors)
            return out[0] if len(out) == 1 else out
        except KeyError:
            pass
    a = _armed_parts()
    xs = [t for t in tensors if t is not None]
    if a.torch.is_grad_enabled() and any(x.requires_grad for x in xs):
        ys = iter(a.Cast.apply(dtype, *xs))
    else:
        with _Span("cast"):
            ys = iter([x.to(dtype) for x in xs])
    out = tuple(None if t is None else next(ys) for t in tensors)
    return out[0] if len(out) == 1 else out


class _CastBlock:
    """An armed :func:`cast_block`: the casts made, and the copies it
    hands out while entered."""

    __slots__ = ("_copies", "_prev")

    def __init__(self, dtype, tensors):
        tensors = [t for t in tensors if t is not None]
        copies = cast(dtype, *tensors) if tensors else ()
        if len(tensors) == 1:
            copies = (copies,)
        self._copies = {(id(t), dtype): c for t, c in zip(tensors, copies)}

    def __enter__(self):
        self._prev = getattr(_blocks, "copies", None)
        _blocks.copies = self._copies
        return self

    def __exit__(self, *exc):
        _blocks.copies = self._prev
        return False


def cast_block(dtype, params):
    """A block's parameter casts as one ``cast`` range instead of one a
    call: armed, the tensors ``params()`` returns are cast together
    here, and :func:`cast` inside the block hands out these copies (the
    same values, made once). Disarmed, a no-op that calls nothing."""
    if not ranges_armed():
        return _DISARMED
    return _CastBlock(dtype, params())


def add_count(name: str, value) -> None:
    """Add ``value.sum()`` (a tensor, on the device) into the counter
    ``name`` while armed. Nothing is read to the host: read
    :func:`counts` after the steps."""
    if not ranges_armed():
        return
    total = value.detach().sum()
    have = _counts.get(name)
    if have is None:
        _counts[name] = total
    else:
        have.add_(total)


def counts() -> dict:
    """name -> the device tensor of each counter added while armed."""
    return dict(_counts)


def notes() -> Counter:
    """(kind, site) -> times, noted while armed: ``"sync"``, a
    device-to-host copy (site: the caller's ``file:line``), and
    ``"kernel load"``, a kernel library built or loaded (site: the
    library)."""
    return Counter(_notes)


def spans() -> list:
    """The range parts timed while armed, in the order opened, as
    ``(name, parent, thread, start_ns, host_s, device_s)``: ``parent``
    is the index of the part open on the same thread when it opened (-1
    for none), ``start_ns`` on ``time.perf_counter_ns``'s clock,
    ``host_s`` None while the part is open, ``device_s`` the time
    between its CUDA events (None without them). Read after the steps:
    it waits for the device."""
    index = {id(s): i for i, s in enumerate(_spans)}
    if any(s.e1 is not None for s in _spans):
        _armed.torch.cuda.synchronize()
    out = []
    for s in _spans:
        host = None if s.t1 is None else (s.t1 - s.t0) / 1e9
        dev = (s.e0.elapsed_time(s.e1) / 1e3
               if s.e0 is not None and s.e1 is not None else None)
        parent = -1 if s.parent is None else index.get(id(s.parent), -1)
        out.append((s.name, parent, s.thread, s.t0, host, dev))
    return out


def _on_kernel_load(kind: str, name: str, seconds: float) -> None:
    t = _tracer
    if t is not None:
        t.on_compile(seconds, f"{kind} {name}")
    if ranges_armed():
        _notes["kernel load", f"{kind} {name}"] += 1


# Set while a traced method runs: a tensor subclass's __torch_function__
# re-dispatches the call through the same (traced) method, which must
# not count the one sync twice.
_inside = threading.local()


def _traced(method: str, orig):
    def traced(self, *args, **kwargs):
        t = _tracer
        armed = ranges_armed()
        if (t is None and not armed) or getattr(_inside, "active", False):
            return orig(self, *args, **kwargs)
        if self.is_cuda:
            if t is not None:
                t.on_transfer(self.element_size() * self.nelement())
            if armed:
                _notes["sync", _caller_site()] += 1
        _inside.active = True
        try:
            return orig(self, *args, **kwargs)
        finally:
            _inside.active = False

    traced.__name__ = method
    traced.__doc__ = orig.__doc__
    return traced


def _install_hooks() -> None:
    """Hook ops/_build.py's build and load points and wrap the sync
    methods of ``torch.Tensor``. Idempotent; every hook gates on the
    module globals, so a disabled tracer with disarmed ranges costs a
    few attribute reads per call."""
    global _hooks_installed
    if _hooks_installed:
        return
    _hooks_installed = True

    import torch

    from ..ops import _build

    _build.load_hook = _on_kernel_load
    for method in SYNC_METHODS:
        setattr(torch.Tensor, method, _traced(method,
                                              getattr(torch.Tensor, method)))


def _env_enabled() -> bool:
    return os.environ.get(ENV_FLAG, "").strip().lower() not in (
        "", "0", "false", "off", "no",
    )


if _env_enabled():  # pragma: no cover - exercised via subprocess tests
    enable()
