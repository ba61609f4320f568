"""Training-loop telemetry: step wall time, throughput, and goodput (the
port's copy of ``mpi_operator_tpu/utils/telemetry.py``: the same records,
keys and numbers on the same step durations; only the device sampler
behind ``device_memory`` reads the GPU, utils/devstats.py).

The scaling decisions in the source papers (arxiv 2011.03641, 1909.09756)
all start from the same three numbers per run: how long a step takes, how
many tokens/examples per second that buys, and what fraction of total wall
time was *productive* step time (goodput) — the rest being compile,
restart, checkpoint, and input stalls.  This module owns that bookkeeping
for ``cmd.train``:

- each step's wall time feeds a ``tpu_operator_train_step_duration_seconds``
  histogram plus tokens/examples counters in a metrics registry (the same
  registry shape the operator scrapes, so a sidecar exporter can serve it);
- a compact JSONL record is emitted every ``interval`` steps (and on
  ``close()``) to a file and/or stderr, one object per line, so progress is
  greppable from pod logs without parsing the human log lines;
- every record is stamped with this worker's identity (``TPU_WORKER_ID``
  and hostname, read once at construction), so per-worker JSONL streams
  are joinable without path-name archaeology;
- with ``heartbeat_interval`` set, a windowed ``step_heartbeat`` record
  (step-wall p50/max, barrier/collective-wait share) is emitted every N
  post-warmup steps and handed to an optional publisher — the raw input
  of the operator-side step-skew observatory (utils/stepstats.py), which
  joins heartbeats across workers to find stragglers;
- with a ``devstats_sampler`` wired (utils/devstats.DeviceMemorySampler),
  each closed heartbeat window also emits one ``device_memory`` record
  (device-memory in-use/peak/limit watermarks; the ``hbm_*`` keys are
  the reference's) — the raw input of the operator-side
  device-memory observatory (utils/devstats.MemoryMatrix).

The SIGTERM contract — emit ``final: true`` exactly once per process,
across the telemetry record, the heartbeat flush, and the devstats
sample — is owned by one shared ``FinalOnce`` latch, so a double
delivery of SIGTERM (kubelet retry, supervisor impatience) can never
double-emit the final records.

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

# Train steps range from ~1ms (tiny CPU models in tests) to minutes:
# wider buckets than the server-latency defaults.
STEP_BUCKETS = (
    0.001, 0.005, 0.01, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0,
    60.0, 120.0,
)


class FinalOnce:
    """One-shot latch for the "emit ``final: true`` exactly once" SIGTERM
    contract: only the first claim wins. Shared by the final telemetry
    record, the final heartbeat flush and the final device-memory sample
    (and the checkpoint's final save)."""

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
        stream: Optional[TextIO] = None,
        clock: Callable[[], float] = time.perf_counter,
        heartbeat_interval: int = 0,
        heartbeat_publisher: Optional[Callable[[dict], None]] = None,
        devstats_sampler: Optional[Callable[[int], Optional[dict]]] = None,
    ):
        self.tokens_per_step = tokens_per_step
        self.examples_per_step = examples_per_step
        self.interval = interval
        self._clock = clock
        self._stream = stream if stream is not None else sys.stderr
        self._file: Optional[TextIO] = None
        if jsonl_path:
            self._file = open(jsonl_path, "a", buffering=1)

        # Worker identity, read ONCE at construction (the pod env never
        # changes mid-process): joins the per-worker JSONL streams.
        worker = os.environ.get(constants.ENV_TPU_WORKER_ID, "").strip()
        self.worker_id: Optional[int] = int(worker) if worker.isdigit() else None
        self.hostname = os.environ.get("HOSTNAME") or socket.gethostname()

        # Windowed step heartbeats (the step-skew observatory's input):
        # every ``heartbeat_interval`` post-warmup steps, one compact
        # record with the window's step-wall p50/max and wait share.
        self.heartbeat_interval = max(heartbeat_interval, 0)
        self.heartbeat_publisher = heartbeat_publisher
        self._hb_durations: list[float] = []
        self._hb_wait_s = 0.0
        self._hb_window = 0

        # Device-memory observatory input: one watermark sample per
        # closed heartbeat window (utils/devstats.DeviceMemorySampler).
        self.devstats_sampler = devstats_sampler
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
            "Productive step time over total wall time (compiles, restarts, "
            "checkpoints included in the denominator)",
            registry=registry,
        )
        self.throughput = metrics.new_gauge(
            "tpu_operator_train_tokens_per_second",
            "Recent tokens/second (examples/second for token-free models)",
            registry=registry,
        )

        self._origin: Optional[float] = None
        self._productive_s = 0.0
        self._checkpoint_s = 0.0
        self._last_emit_step = 0
        self._last_emit_time: Optional[float] = None
        self._last_emit_productive = 0.0

    def start(self) -> None:
        """Open the wall clock."""
        self._origin = self._last_emit_time = self._clock()

    def record_step(
        self,
        step: int,
        duration_s: float,
        *,
        warmup: bool = False,
        wait_s: float = 0.0,
    ) -> None:
        """``wait_s`` is the slice of this step spent blocked on the gang
        (barrier/collective wait) when the workload can tell it apart —
        it feeds the heartbeat's wait share, never the goodput split."""
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
            if self.heartbeat_interval:
                # Warmup (compile) steps stay out of the window: their
                # wall times would read as fake skew to the detector.
                self._hb_durations.append(duration_s)
                self._hb_wait_s += max(0.0, min(wait_s, duration_s))
                if len(self._hb_durations) >= self.heartbeat_interval:
                    self.emit_heartbeat(step)
        if self.interval and step % self.interval == 0:
            self.emit(step)

    def _stamp_identity(self, rec: dict) -> dict:
        """Every emitted record carries the worker's identity so the
        per-pod JSONL files (and the tailed pod logs) join by content."""
        if self.worker_id is not None:
            rec["worker_id"] = self.worker_id
        rec["hostname"] = self.hostname
        return rec

    def emit_heartbeat(self, step: int) -> Optional[dict]:
        """Close the current heartbeat window: emit one ``step_heartbeat``
        JSONL record and hand it to the publisher (in the pods the
        kubelet sim tails, that record becomes a pod annotation patch).
        Returns None when the window is empty."""
        durations = sorted(self._hb_durations)
        if not durations:
            return None
        n = len(durations)
        mid = n // 2
        p50 = (
            durations[mid]
            if n % 2
            else (durations[mid - 1] + durations[mid]) / 2.0
        )
        total = sum(durations)
        rec = self._stamp_identity({
            "event": "step_heartbeat",
            "window": self._hb_window,
            "step": step,
            "steps": n,
            "step_wall_p50_ms": round(p50 * 1000, 3),
            "step_wall_max_ms": round(durations[-1] * 1000, 3),
            "wait_share": round(self._hb_wait_s / total, 4) if total > 0 else 0.0,
            "window_s": round(total, 6),
        })
        self._hb_window += 1
        self._hb_durations = []
        self._hb_wait_s = 0.0
        emit_json(rec, stream=self._file if self._file is not None else self._stream)
        if self.heartbeat_publisher is not None:
            try:
                self.heartbeat_publisher(rec)
            except Exception:
                # A broken publisher (apiserver away, annotation conflict
                # storm) must never take the training loop down with it.
                pass
        # The device-memory observatory samples at the same cadence: one
        # watermark record per closed heartbeat window.
        self.emit_device_memory(rec["window"])
        return rec

    def emit_device_memory(
        self, window: int, *, final: bool = False
    ) -> Optional[dict]:
        """Emit one ``device_memory`` JSONL record for ``window`` via the
        wired sampler (None without one).  Sampler breakage is swallowed:
        memory telemetry must never take the training loop down."""
        if self.devstats_sampler is None:
            return None
        try:
            rec = self.devstats_sampler(window)
        except Exception:
            return None
        if not rec:
            return None
        rec = self._stamp_identity(dict(rec))
        if final:
            rec["final"] = True
        emit_json(
            rec, stream=self._file if self._file is not None else self._stream
        )
        return rec

    def record_checkpoint(self, duration_s: float) -> None:
        """Charge durable-save wall time.  Checkpoint seconds stay in the
        goodput denominator (they are not productive step time) but are
        reported separately so the operator-side goodput ledger can carve
        them out of the job's productive phase."""
        self._checkpoint_s += max(0.0, duration_s)

    # -- derived numbers -------------------------------------------------

    def wall_s(self) -> float:
        if self._origin is None:
            return 0.0
        return max(self._clock() - self._origin, 1e-9)

    def goodput_ratio(self) -> float:
        wall = self.wall_s()
        return min(self._productive_s / wall, 1.0) if wall > 0 else 0.0

    def snapshot(self, step: int) -> dict:
        """One JSONL record: cumulative ratios + rates over the window
        since the previous emit (rates over the whole run would smear
        every transient slowdown into invisibility)."""
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
        # Shared structured-log writer: same sorted-keys one-object-per-line
        # shape as before, with flush + write locking for free.
        emit_json(rec, stream=self._file if self._file is not None else self._stream)
        return rec

    def close(self, step: int, *, final: bool = False) -> Optional[dict]:
        """Final emit, then file close.  Plain shutdown emits only when
        periodic records are enabled and a step landed since the last
        one; ``final=True`` (the preemption/SIGTERM path) always emits,
        so a killed worker's partial goodput and step count are never
        lost with the process.

        The FinalOnce latch makes ``final`` idempotent: a second SIGTERM
        delivery degrades to a plain close instead of double-emitting the
        final records."""
        if final:
            final = self._final_once.claim()
        rec = None
        if self.heartbeat_interval and self._hb_durations:
            # Flush the partial window: a preempted worker's last steps
            # still reach the operator-side step matrix.
            self.emit_heartbeat(step)
        if final:
            # The dying worker's last watermark: the OOM-forensics
            # snapshot the operator freezes must be as fresh as possible.
            self.emit_device_memory(self._hb_window, final=True)
        if final or (self.interval and step > self._last_emit_step):
            rec = self.emit(step, final=final)
        if self._file is not None:
            self._file.close()
            self._file = None
        return rec
