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
import threading
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


def _on_kernel_load(kind: str, name: str, seconds: float) -> None:
    t = _tracer
    if t is not None:
        t.on_compile(seconds, f"{kind} {name}")


# Set while a traced method runs: a tensor subclass's __torch_function__
# re-dispatches the call through the same (traced) method, which must
# not count the one sync twice.
_inside = threading.local()


def _traced(method: str, orig):
    def traced(self, *args, **kwargs):
        t = _tracer
        if t is None or getattr(_inside, "active", False):
            return orig(self, *args, **kwargs)
        if self.is_cuda:
            t.on_transfer(self.element_size() * self.nelement())
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
    module global, so a disabled tracer costs one attribute read per
    call."""
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
