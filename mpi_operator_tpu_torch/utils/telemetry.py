"""Training-loop telemetry: step wall time, throughput, and goodput (the
port's copy of ``TrainingTelemetry`` and ``FinalOnce`` from
``mpi_operator_tpu/utils/telemetry.py``).

- each step's wall time feeds a ``tpu_operator_train_step_duration_seconds``
  histogram plus tokens/examples counters in a metrics registry;
- a compact ``train_telemetry`` JSONL record is emitted every ``interval``
  steps (and on ``close()``) to a file or stderr, stamped with this
  worker's identity (``TPU_WORKER_ID`` and hostname);
- goodput = productive (post-warmup) step time over total wall time;
  checkpoint seconds (``record_checkpoint``) stay in the denominator and
  are reported apart as ``checkpoint_s``.

The windowed step heartbeats and device-memory samples of the JAX
version come with the device samplers (ROADMAP.md queue (a) item 10).

Step durations are dispatch-to-dispatch wall times: CUDA launches are
asynchronous, so one step's number can lag its device time, but the
back-pressure of a steady loop makes the sequence converge to the real
step time without a device sync per step.
"""

from __future__ import annotations

import os
import socket
import sys
import threading
import time
from typing import Callable, Optional, TextIO

from ..api.v2beta1 import constants
from . import metrics
from .logging import emit_json

# Train steps range from ~1ms (tiny CPU models in tests) to minutes.
STEP_BUCKETS = (
    0.001, 0.005, 0.01, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0,
    60.0, 120.0,
)


class FinalOnce:
    """One-shot latch for the "emit ``final: true`` exactly once" SIGTERM
    contract: only the first claim wins."""

    def __init__(self):
        self._lock = threading.Lock()
        self._claimed = False

    def claim(self) -> bool:
        """True exactly once; every later claim returns False."""
        with self._lock:
            if self._claimed:
                return False
            self._claimed = True
            return True


class TrainingTelemetry:
    """Accumulates per-step timings and derives throughput/goodput.

    ``record_step`` is called once per optimizer step with that step's
    wall time and whether it was warmup (warmup time counts toward total
    wall time but not toward productive time, so kernel builds and
    allocator warmup land in the goodput denominator exactly once).
    """

    def __init__(
        self,
        *,
        tokens_per_step: int = 0,
        examples_per_step: int = 0,
        registry: Optional[metrics.Registry] = None,
        interval: int = 0,
        jsonl_path: str = "",
        clock: Callable[[], float] = time.perf_counter,
    ):
        self.tokens_per_step = tokens_per_step
        self.examples_per_step = examples_per_step
        self.interval = interval
        self._clock = clock
        self._file: Optional[TextIO] = None
        if jsonl_path:
            self._file = open(jsonl_path, "a", buffering=1)

        worker = os.environ.get(constants.ENV_TPU_WORKER_ID, "").strip()
        self.worker_id: Optional[int] = int(worker) if worker.isdigit() else None
        self.hostname = os.environ.get("HOSTNAME") or socket.gethostname()
        self._final_once = FinalOnce()

        registry = registry or metrics.DEFAULT_REGISTRY
        self.registry = registry
        self.step_duration = metrics.new_histogram(
            "tpu_operator_train_step_duration_seconds",
            "Wall time per optimizer step (dispatch-to-dispatch)",
            registry=registry,
            buckets=STEP_BUCKETS,
        )
        self.steps_total = metrics.new_counter(
            "tpu_operator_train_steps_total",
            "Optimizer steps completed, by phase",
            ("phase",),
            registry,
        )
        self.tokens_total = metrics.new_counter(
            "tpu_operator_train_tokens_total",
            "Tokens processed by post-warmup steps",
            registry=registry,
        )
        self.examples_total = metrics.new_counter(
            "tpu_operator_train_examples_total",
            "Examples processed by post-warmup steps",
            registry=registry,
        )
        self.goodput = metrics.new_gauge(
            "tpu_operator_train_goodput_ratio",
            "Productive step time over total wall time",
            registry=registry,
        )
        self.throughput = metrics.new_gauge(
            "tpu_operator_train_tokens_per_second",
            "Recent tokens/second (examples/second for token-free models)",
            registry=registry,
        )

        self._origin: Optional[float] = None
        self._productive_s = 0.0
        self._last_emit_step = 0
        self._last_emit_time: Optional[float] = None
        self._last_emit_productive = 0.0
        self._checkpoint_s = 0.0

    def _out(self) -> TextIO:
        return self._file if self._file is not None else sys.stderr

    def start(self) -> None:
        """Open the wall clock."""
        self._origin = self._last_emit_time = self._clock()

    def record_step(self, step: int, duration_s: float, *,
                    warmup: bool = False) -> None:
        if self._origin is None:
            self.start()
        self.step_duration.observe(duration_s)
        self.steps_total.inc(1, "warmup" if warmup else "train")
        if not warmup:
            self._productive_s += duration_s
            if self.tokens_per_step:
                self.tokens_total.inc(self.tokens_per_step)
            if self.examples_per_step:
                self.examples_total.inc(self.examples_per_step)
        if self.interval and step % self.interval == 0:
            self.emit(step)

    def record_checkpoint(self, duration_s: float) -> None:
        """Charge durable-save wall time. Checkpoint seconds stay in the
        goodput denominator (they are not productive step time) but are
        reported separately so the operator-side goodput ledger can carve
        them out of the job's productive phase."""
        self._checkpoint_s += max(0.0, duration_s)

    def _stamp_identity(self, rec: dict) -> dict:
        if self.worker_id is not None:
            rec["worker_id"] = self.worker_id
        rec["hostname"] = self.hostname
        return rec

    def wall_s(self) -> float:
        if self._origin is None:
            return 0.0
        return max(self._clock() - self._origin, 1e-9)

    def goodput_ratio(self) -> float:
        wall = self.wall_s()
        return min(self._productive_s / wall, 1.0) if wall > 0 else 0.0

    def snapshot(self, step: int) -> dict:
        """One JSONL record: cumulative goodput + rates over the window
        since the previous emit."""
        now = self._clock()
        window_s = (
            now - self._last_emit_time
            if self._last_emit_time is not None
            else self.wall_s()
        )
        window_steps = step - self._last_emit_step
        window_productive = self._productive_s - self._last_emit_productive
        per_step = window_productive / window_steps if window_steps > 0 else 0.0
        rate = window_steps / window_s if window_s > 0 else 0.0
        goodput = self.goodput_ratio()
        rec = self._stamp_identity({
            "event": "train_telemetry",
            "step": step,
            "step_ms": round(per_step * 1000, 3),
            "steps_per_sec": round(rate, 3),
            "goodput": round(goodput, 4),
            "wall_s": round(self.wall_s(), 3),
        })
        if self.tokens_per_step:
            rec["tokens_per_sec"] = round(rate * self.tokens_per_step, 1)
        if self.examples_per_step:
            rec["examples_per_sec"] = round(rate * self.examples_per_step, 1)
        if self._checkpoint_s > 0:
            rec["checkpoint_s"] = round(self._checkpoint_s, 3)
        self.goodput.set(round(goodput, 6))
        self.throughput.set(
            round(rate * (self.tokens_per_step or self.examples_per_step), 3)
        )
        self._last_emit_step = step
        self._last_emit_time = now
        self._last_emit_productive = self._productive_s
        return rec

    def emit(self, step: int, *, final: bool = False) -> dict:
        rec = self.snapshot(step)
        if final:
            rec["final"] = True
        emit_json(rec, stream=self._out())
        return rec

    def close(self, step: int, *, final: bool = False) -> Optional[dict]:
        """Final emit, then file close. Plain shutdown emits only when
        periodic records are on and a step landed since the last one;
        ``final=True`` (the SIGTERM path) always emits, once per process
        (FinalOnce)."""
        if final:
            final = self._final_once.claim()
        rec = None
        if final or (self.interval and step > self._last_emit_step):
            rec = self.emit(step, final=final)
        if self._file is not None:
            self._file.close()
            self._file = None
        return rec
