"""Fleet device-memory observatory: the worker's sampler and the per-job
MemoryMatrix (the port's copy of ``mpi_operator_tpu/utils/devstats.py``).

The operator side (``MemoryMatrix``) and ``FakeMemoryBackend`` are the
JAX package's. The worker side, ``DeviceMemorySampler``, reads the GPU
where the JAX version reads ``jax.local_devices()``: the device is named
by the trainer, and on a CUDA device the record maps as

- ``hbm_bytes_in_use``  <- ``torch.cuda.memory_stats(device)["allocated_bytes.all.current"]``
- ``hbm_peak_bytes``    <- ``["allocated_bytes.all.peak"]`` (and the
  sampler's own running peak, as the JAX version keeps it)
- ``hbm_limit_bytes``   <- ``torch.cuda.mem_get_info(device)[1]``, the
  card's total memory
- ``compile_cache_entries`` <- the kernels ``ops/_build.py:kernel`` has
  loaded in this process.

The caching allocator's reserved bytes have no key in the reference's
record, so the port adds none. On the CPU (tests), as JAX's CPU
fallback sums ``jax.live_arrays()``, the sampler sums the bytes of the
tensors the trainer holds (parameters, gradients, optimizer state) with
limit 0, so the matrix reports the watermark but never projects from
it. ``torch`` is imported inside the sampler only: the matrix and
everything above it import none. The JAX package's own description
follows.

The time-attribution stack (profiler, goodput ledger, step-skew matrix)
is blind to *device memory*: an HBM OOM kills a gang with zero forensics
and no early warning, even though the watermark that predicts it grows
for many windows first.  MLPerf-scale TPU pod training (arxiv
1909.09756) treats HBM headroom as the first-class capacity signal; this
module gives the operator that signal over the same
worker-annotation → informer pipeline the step-skew observatory
(utils/stepstats.py) proved out:

- **worker side** — ``DeviceMemorySampler`` samples per-device HBM at
  each telemetry/heartbeat window (``device.memory_stats()`` with a
  ``live_arrays``-sum fallback and a deterministic fake backend for
  CPU/tests), and utils/telemetry.py emits the sample as a
  ``device_memory`` JSONL record the kubelet sim patches onto the Pod
  as the device-memory annotation;
- **operator side** — ``MemoryMatrix`` joins samples across the gang
  via the pod informer (reusing stepstats' roster/window-closure
  semantics), computes fleet peak/headroom per closed window, runs a
  linear watermark-trend projector, and answers the controller's
  per-sync ``pressure_verdict`` — projected HBM exhaustion within K
  windows raises the ``MemoryPressure`` job condition, recovery flips
  it False;
- **OOM forensics** — when a worker pod dies with the OOM exit code,
  the last joined snapshot is frozen into the flight-recorder timeline
  (kind ``memory``) so the postmortem survives the pod.

Bounds mirror stepstats: tracked jobs are pruned to the flight
recorder's LRU at scrape time (``collect`` also re-derives the
``tpu_operator_job_hbm_peak_bytes`` / ``_headroom_ratio`` gauges), the
per-job window history is a ring, and open windows are capped.  The
monitoring server serves one job's live matrix at
``/debug/jobs/<ns>/<name>/memory``.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Callable, Optional

from ..runtime import locktrace
from . import flightrecorder, metrics
from .stepstats import MAX_OPEN_WINDOW_LAG, MAX_WORKERS_PER_JOB

# Pressure detector defaults: raise MemoryPressure when the linear
# watermark trend projects HBM exhaustion within K closed windows.  K is
# chosen to leave a checkpoint-and-resize window before the OOM lands;
# the trend needs MIN_TREND_WINDOWS points before it projects at all so
# two noisy samples cannot fire the condition.
DEFAULT_PRESSURE_HORIZON_WINDOWS = 6
DEFAULT_TREND_WINDOWS = 8
MIN_TREND_WINDOWS = 3

# Per-job ring: recent closed windows kept for /memory and the trend fit.
DEFAULT_WINDOW_HISTORY = 64

# The OOM-killer exit signature (128 + SIGKILL) — kubelet reports the
# same code for container OOMKilled; the reaper (runtime/podrunner.py)
# surfaces it in containerStatuses.
OOM_EXIT_CODE = 137

# Deterministic fake-backend defaults: one v5e chip's HBM.
DEFAULT_FAKE_LIMIT_BYTES = 16 * 1024**3
DEFAULT_FAKE_BASE_BYTES = 4 * 1024**3


# -- worker side ---------------------------------------------------------


class FakeMemoryBackend:
    """Deterministic ``device.memory_stats()`` stand-in for CPU and
    tests: a fixed base footprint plus an optional window-periodic
    ripple, a pure function of the window index so same-seed bench runs
    replay bit-identically."""

    def __init__(
        self,
        *,
        limit_bytes: int = DEFAULT_FAKE_LIMIT_BYTES,
        base_bytes: int = DEFAULT_FAKE_BASE_BYTES,
        ripple_bytes: int = 0,
    ):
        if limit_bytes <= 0:
            raise ValueError(f"limit_bytes must be > 0, got {limit_bytes!r}")
        if not 0 <= base_bytes <= limit_bytes:
            raise ValueError(
                f"base_bytes must be in [0, limit_bytes], got {base_bytes!r}"
            )
        self.limit_bytes = int(limit_bytes)
        self.base_bytes = int(base_bytes)
        self.ripple_bytes = int(ripple_bytes)

    def stats(self, window: int) -> dict:
        # A small deterministic ripple (period 4) models allocator churn
        # without a trend, so the control arm never drifts upward.
        ripple = self.ripple_bytes * ((window % 4) - 1)
        in_use = max(self.base_bytes + ripple, 0)
        return {
            "bytes_in_use": in_use,
            "peak_bytes_in_use": in_use,
            "bytes_limit": self.limit_bytes,
        }


def _leak_bytes_from_env() -> int:
    """The chaos MemoryLeak fault's worker-side half: the injected
    per-window increment (runtime/podrunner.py child env)."""
    import os

    from ..api.v2beta1 import constants

    raw = os.environ.get(constants.ENV_MEM_LEAK_BYTES, "")
    if not raw:
        return 0
    try:
        return max(int(raw), 0)
    except ValueError:
        return 0


def _compile_cache_entries() -> int:
    """Kernels loaded in this process by ``ops/_build.py:kernel``, the
    port's counterpart of the JAX version's jit-cache size. 0 in a
    process that has imported no kernel module."""
    import sys

    build = sys.modules.get(__package__.rsplit(".", 1)[0] + ".ops._build")
    return len(build.loaded_kernels()) if build is not None else 0


def tensor_bytes(tensors) -> int:
    """Bytes of the local storage of ``tensors`` (a DTensor counts its
    local shard), each storage once."""
    seen, total = set(), 0
    for t in tensors:
        if t is None:
            continue
        local = t.to_local() if hasattr(t, "to_local") else t
        key = (local.untyped_storage().data_ptr(), local.device)
        if key in seen:
            continue
        seen.add(key)
        total += local.untyped_storage().nbytes()
    return total


class DeviceMemorySampler:
    """Per-window device-memory watermark sampler for the training worker.

    Resolution order per sample: an explicitly injected backend
    (tests/bench), else the named device: on CUDA its allocator's
    statistics and the card's total memory (the module docstring's
    mapping); on the CPU the byte sum of ``live_tensors()`` (limit 0).
    A CUDA device never falls back to the CPU sum: a failing read there
    raises, and the telemetry that calls the sampler emits no record for
    the window. The chaos leak increment (``TPU_MEM_LEAK_BYTES``)
    inflates the *reported* bytes-in-use by ``leak x (window + 1)``, as
    the JAX version does.
    """

    def __init__(
        self,
        *,
        device="cpu",
        live_tensors: Optional[Callable[[], object]] = None,
        backend: Optional[FakeMemoryBackend] = None,
        leak_bytes_per_window: Optional[int] = None,
        compile_cache_fn: Callable[[], int] = _compile_cache_entries,
    ):
        self._device = device
        self._live_tensors = live_tensors
        self._backend = backend
        self._leak = (
            _leak_bytes_from_env()
            if leak_bytes_per_window is None
            else max(int(leak_bytes_per_window), 0)
        )
        self._compile_cache_fn = compile_cache_fn
        self._peak = 0

    @property
    def leak_bytes_per_window(self) -> int:
        return self._leak

    def _device_stats(self) -> dict:
        import torch

        device = torch.device(self._device)
        if device.type == "cuda":
            stats = torch.cuda.memory_stats(device)
            return {
                "bytes_in_use": int(stats.get("allocated_bytes.all.current", 0)),
                "peak_bytes_in_use": int(stats.get("allocated_bytes.all.peak", 0)),
                "bytes_limit": int(torch.cuda.mem_get_info(device)[1]),
            }
        if device.type != "cpu":
            raise ValueError(f"no memory statistics for device {device}")
        live = (tensor_bytes(self._live_tensors())
                if self._live_tensors is not None else 0)
        return {"bytes_in_use": live, "peak_bytes_in_use": live,
                "bytes_limit": 0}

    def sample(self, window: int) -> dict:
        """One ``device_memory`` record for a closed telemetry window."""
        window = int(window)
        if self._backend is not None:
            stats = self._backend.stats(window)
        else:
            stats = self._device_stats()
        in_use = int(stats.get("bytes_in_use", 0) or 0)
        peak = int(stats.get("peak_bytes_in_use", 0) or 0)
        limit = int(stats.get("bytes_limit", 0) or 0)
        if self._leak:
            in_use += self._leak * (window + 1)
        self._peak = max(self._peak, peak, in_use)
        try:
            cache_entries = int(self._compile_cache_fn())
        except Exception:
            cache_entries = 0
        return {
            "event": "device_memory",
            "window": window,
            "hbm_bytes_in_use": in_use,
            "hbm_peak_bytes": self._peak,
            "hbm_limit_bytes": limit,
            "compile_cache_entries": cache_entries,
        }


# -- operator side -------------------------------------------------------


def _roster_entry(worker: str, pod: str) -> dict:
    """Membership placeholder for a worker the informer has seen but
    that has not reported a device-memory sample yet (window -1 orders
    before any real sample)."""
    return {
        "worker": worker,
        "hostname": "",
        "pod": pod,
        "window": -1,
        "hbm_bytes_in_use": 0,
        "hbm_peak_bytes": 0,
        "hbm_limit_bytes": 0,
        "compile_cache_entries": 0,
    }


def _slope(points: list[tuple[float, float]]) -> float:
    """Least-squares slope of y over x — bytes per window for the
    watermark trend."""
    n = len(points)
    mean_x = sum(x for x, _ in points) / n
    mean_y = sum(y for _, y in points) / n
    denom = sum((x - mean_x) ** 2 for x, _ in points)
    if denom <= 0:
        return 0.0
    num = sum((x - mean_x) * (y - mean_y) for x, y in points)
    return num / denom


class _JobMemory:
    """One job's join state: latest sample per worker, open windows
    awaiting the full gang, closed-window ring, projector state."""

    __slots__ = (
        "workers", "open_windows", "closed", "pressure",
        "projected_windows", "frozen", "last_closed_window",
    )

    def __init__(self, history: int):
        self.workers: dict[str, dict] = {}
        self.open_windows: dict[int, dict[str, dict]] = {}
        self.closed: deque = deque(maxlen=history)
        self.pressure = False
        self.projected_windows: Optional[float] = None
        self.frozen: set[str] = set()  # workers already OOM-frozen
        self.last_closed_window = -1


class MemoryMatrix:
    """Joins per-worker device-memory samples into per-job fleet
    watermarks, a linear exhaustion projection, and OOM forensics.

    ``observe_pod`` is the single write path (wired as a pod informer
    handler); everything else reads.  All numbers derive from sample
    content, never wall clocks, so a simulated-clock bench replays
    bit-identically.
    """

    def __init__(
        self,
        flight_recorder: flightrecorder.FlightRecorder,
        registry: Optional[metrics.Registry] = None,
        clock: Callable[[], float] = time.time,
        *,
        pressure_horizon_windows: int = DEFAULT_PRESSURE_HORIZON_WINDOWS,
        trend_windows: int = DEFAULT_TREND_WINDOWS,
        window_history: int = DEFAULT_WINDOW_HISTORY,
    ):
        if pressure_horizon_windows < 1:
            raise ValueError(
                f"pressure_horizon_windows must be >= 1, "
                f"got {pressure_horizon_windows!r}"
            )
        if trend_windows < MIN_TREND_WINDOWS:
            raise ValueError(
                f"trend_windows must be >= {MIN_TREND_WINDOWS}, "
                f"got {trend_windows!r}"
            )
        self._recorder = flight_recorder
        self._clock = clock
        self.pressure_horizon_windows = pressure_horizon_windows
        self.trend_windows = trend_windows
        self._history = max(window_history, trend_windows)
        self._lock = locktrace.lock("devstats")
        self._jobs: dict[tuple[str, str], _JobMemory] = {}

        self.hbm_peak = None
        if registry is not None:
            self.hbm_peak = metrics.new_gauge(
                "tpu_operator_job_hbm_peak_bytes",
                "Fleet HBM peak bytes per TPUJob (max worker peak over "
                "the latest joined device-memory window)",
                ("namespace", "tpujob"),
                registry,
            )
            self.hbm_headroom = metrics.new_gauge(
                "tpu_operator_job_hbm_headroom_ratio",
                "Fleet HBM headroom per TPUJob ((limit - in_use) / limit "
                "for the worst worker in the latest joined window; 1.0 "
                "when the limit is unknown)",
                ("namespace", "tpujob"),
                registry,
            )
            registry.on_scrape(self.collect)

    # -- write path ------------------------------------------------------

    def observe_pod(self, pod: dict) -> None:
        """Fold one pod event into the owning job's matrix.

        Mirrors stepstats.StepMatrix.observe_pod: worker pods without a
        device-memory annotation still register gang membership, a
        terminal pod leaves the roster, and folds are idempotent per
        (worker, window).  Additionally, a terminal pod carrying the OOM
        exit code freezes the last joined snapshot into the flight
        recorder before the roster forgets it."""
        import json

        from ..api.v2beta1 import constants

        meta = pod.get("metadata") or {}
        labels = meta.get("labels") or {}
        job_name = labels.get(constants.JOB_NAME_LABEL)
        if not job_name:
            return
        if labels.get(constants.JOB_ROLE_LABEL) != constants.ROLE_WORKER:
            return
        namespace = meta.get("namespace", "")
        worker = labels.get(constants.REPLICA_INDEX_LABEL)
        if worker is None:
            worker = meta.get("name", "")
        worker = str(worker)
        phase = (pod.get("status") or {}).get("phase", "")
        terminal = phase in ("Succeeded", "Failed")

        raw = (meta.get("annotations") or {}).get(
            constants.DEVICE_MEMORY_ANNOTATION
        )
        if not raw:
            with self._lock:
                job = self._jobs.get((namespace, job_name))
                if terminal:
                    if job is not None:
                        self._freeze_if_oom(
                            namespace, job_name, job, worker, pod
                        )
                        if worker in job.workers:
                            del job.workers[worker]
                            self._close_ready_windows(job)
                    return
                if job is None:
                    job = self._jobs[(namespace, job_name)] = _JobMemory(
                        self._history
                    )
                if (
                    worker not in job.workers
                    and len(job.workers) < MAX_WORKERS_PER_JOB
                ):
                    job.workers[worker] = _roster_entry(
                        worker, meta.get("name", "")
                    )
            return
        try:
            record = json.loads(raw)
        except ValueError:
            return
        if not isinstance(record, dict):
            return
        window = record.get("window")
        in_use = record.get("hbm_bytes_in_use")
        if not isinstance(window, int) or not isinstance(
            in_use, (int, float)
        ):
            return

        sample = {
            "worker": worker,
            "hostname": str(record.get("hostname", "")),
            "pod": meta.get("name", ""),
            "window": window,
            "hbm_bytes_in_use": int(in_use),
            "hbm_peak_bytes": int(
                record.get("hbm_peak_bytes", in_use) or in_use
            ),
            "hbm_limit_bytes": int(record.get("hbm_limit_bytes", 0) or 0),
            "compile_cache_entries": int(
                record.get("compile_cache_entries", 0) or 0
            ),
        }
        with self._lock:
            job = self._jobs.get((namespace, job_name))
            if job is None:
                job = self._jobs[(namespace, job_name)] = _JobMemory(
                    self._history
                )
            known = job.workers.get(worker)
            if known is not None and known["window"] >= window:
                if terminal:
                    self._freeze_if_oom(namespace, job_name, job, worker, pod)
                    if worker in job.workers:
                        del job.workers[worker]
                        self._close_ready_windows(job)
                return  # stale or duplicate delivery
            if known is None and len(job.workers) >= MAX_WORKERS_PER_JOB:
                return
            job.workers[worker] = sample
            if window > job.last_closed_window:
                job.open_windows.setdefault(window, {})[worker] = sample
            if terminal:
                # The final flush of a finished worker: fold it, freeze
                # the OOM postmortem if that is how it died, then leave
                # the roster so later windows can close without it.
                self._freeze_if_oom(namespace, job_name, job, worker, pod)
                del job.workers[worker]
            self._close_ready_windows(job)

    @staticmethod
    def _is_oom(pod: dict) -> bool:
        for cs in (pod.get("status") or {}).get("containerStatuses") or []:
            terminated = (cs.get("state") or {}).get("terminated") or {}
            if terminated.get("exitCode") == OOM_EXIT_CODE:
                return True
            if terminated.get("reason") == "OOMKilled":
                return True
        return False

    def _freeze_if_oom(
        self,
        namespace: str,
        job_name: str,
        job: _JobMemory,
        worker: str,
        pod: dict,
    ) -> None:
        """OOM forensics: freeze the last joined fleet snapshot (plus
        the dying worker's own last sample) into the flight-recorder
        timeline, once per worker.  Caller holds the lock."""
        if worker in job.frozen or not self._is_oom(pod):
            return
        job.frozen.add(worker)
        attrs: dict = {"worker": worker}
        last = job.workers.get(worker)
        if last is not None:
            attrs["worker_window"] = last["window"]
            attrs["worker_hbm_bytes_in_use"] = last["hbm_bytes_in_use"]
            attrs["worker_hbm_peak_bytes"] = last["hbm_peak_bytes"]
        if job.closed:
            fleet = job.closed[-1]
            attrs["window"] = fleet["window"]
            attrs["hbm_bytes_in_use"] = fleet["hbm_bytes_in_use"]
            attrs["hbm_peak_bytes"] = fleet["hbm_peak_bytes"]
            attrs["hbm_limit_bytes"] = fleet["hbm_limit_bytes"]
            attrs["headroom_ratio"] = fleet["headroom_ratio"]
            attrs["top_worker"] = fleet["top_worker"]
        pod_name = ((pod.get("metadata") or {}).get("name", ""))
        self._recorder.record(
            namespace,
            job_name,
            flightrecorder.MEMORY,
            reason="OOMKilled",
            message=(
                f"worker {worker} (pod {pod_name}) died with the OOM exit "
                f"code {OOM_EXIT_CODE}; last joined device-memory snapshot "
                f"frozen"
            ),
            **attrs,
        )

    def _close_ready_windows(self, job: _JobMemory) -> None:
        """stepstats' closure contract verbatim: close every open window
        the whole known gang has reported, plus any window lagging more
        than MAX_OPEN_WINDOW_LAG behind the newest; windows close in
        order.  Caller holds the lock."""
        if not job.open_windows:
            return
        newest = max(job.open_windows)
        for window in sorted(job.open_windows):
            members = job.open_windows[window]
            full = len(members) >= len(job.workers)
            lagged = window <= newest - MAX_OPEN_WINDOW_LAG
            if not (full or lagged):
                break
            del job.open_windows[window]
            if members:
                self._close_window(job, window, members)
            job.last_closed_window = max(job.last_closed_window, window)

    def _close_window(
        self, job: _JobMemory, window: int, members: dict[str, dict]
    ) -> None:
        """One joined window: fleet watermark (worst worker), tightest
        limit, headroom, then re-run the trend projector.  Caller holds
        the lock."""
        top = max(
            sorted(members), key=lambda w: members[w]["hbm_bytes_in_use"]
        )
        in_use = members[top]["hbm_bytes_in_use"]
        peak = max(s["hbm_peak_bytes"] for s in members.values())
        limits = [
            s["hbm_limit_bytes"]
            for s in members.values()
            if s["hbm_limit_bytes"] > 0
        ]
        limit = min(limits) if limits else 0
        headroom = (
            round((limit - in_use) / limit, 6) if limit > 0 else 1.0
        )
        job.closed.append({
            "window": window,
            "workers": len(members),
            "hbm_bytes_in_use": in_use,
            "hbm_peak_bytes": peak,
            "hbm_limit_bytes": limit,
            "headroom_ratio": headroom,
            "top_worker": top,
        })
        self._project(job)

    def _project(self, job: _JobMemory) -> None:
        """Linear watermark-trend projector over the recent closed
        windows: windows-to-exhaustion = headroom / slope.  Needs
        MIN_TREND_WINDOWS limit-bearing points and a rising trend;
        otherwise no projection and no pressure.  Caller holds the
        lock."""
        recent = [
            w for w in list(job.closed)[-self.trend_windows:]
            if w["hbm_limit_bytes"] > 0
        ]
        if len(recent) < MIN_TREND_WINDOWS:
            job.pressure = False
            job.projected_windows = None
            return
        latest = recent[-1]
        remaining = latest["hbm_limit_bytes"] - latest["hbm_bytes_in_use"]
        if remaining <= 0:
            job.pressure = True
            job.projected_windows = 0.0
            return
        points = [
            (float(w["window"]), float(w["hbm_bytes_in_use"]))
            for w in recent
        ]
        slope = _slope(points)
        if slope <= 0:
            job.pressure = False
            job.projected_windows = None
            return
        projected = remaining / slope
        job.projected_windows = round(projected, 3)
        job.pressure = projected <= self.pressure_horizon_windows

    # -- read paths ------------------------------------------------------

    def pressure_verdict(self, namespace: str, name: str) -> Optional[dict]:
        """The controller's per-sync question: None when the matrix has
        no joined windows for the job yet (insufficient data — say
        nothing); else whether the trend projects exhaustion within the
        horizon, how soon, and who is at the watermark."""
        with self._lock:
            job = self._jobs.get((namespace, name))
            if job is None or not job.closed:
                return None
            latest = job.closed[-1]
            return {
                "pressure": job.pressure,
                "projected_windows": job.projected_windows,
                "headroom_ratio": latest["headroom_ratio"],
                "hbm_peak_bytes": latest["hbm_peak_bytes"],
                "hbm_limit_bytes": latest["hbm_limit_bytes"],
                "top_worker": latest["top_worker"],
                "window": latest["window"],
            }

    def job_snapshot(self, namespace: str, name: str) -> Optional[dict]:
        """The ``/debug/jobs/<ns>/<name>/memory`` payload, or None when
        the job has never produced a sample (the endpoint's 404)."""
        with self._lock:
            job = self._jobs.get((namespace, name))
            if job is None:
                return None
            latest = job.closed[-1] if job.closed else None
            return {
                "namespace": namespace,
                "name": name,
                "pressure": job.pressure,
                "projected_windows": job.projected_windows,
                "pressure_horizon_windows": self.pressure_horizon_windows,
                "hbm_peak_bytes": (
                    latest["hbm_peak_bytes"] if latest else 0
                ),
                "hbm_limit_bytes": (
                    latest["hbm_limit_bytes"] if latest else 0
                ),
                "headroom_ratio": (
                    latest["headroom_ratio"] if latest else 1.0
                ),
                "top_worker": latest["top_worker"] if latest else None,
                "oom_workers": sorted(job.frozen),
                "workers": {
                    worker: dict(sample)
                    for worker, sample in sorted(job.workers.items())
                },
                "windows": list(job.closed),
            }

    def jobs(self) -> list:
        with self._lock:
            return list(self._jobs.keys())

    def __len__(self) -> int:
        with self._lock:
            return len(self._jobs)

    # -- scrape hook -----------------------------------------------------

    def collect(self) -> None:
        """Scrape-time recompute + pruning (the stepstats contract): the
        HBM gauges are re-derived from live state with stale series
        dropped, and any job the flight recorder has LRU-evicted loses
        its matrix too."""
        known = set(self._recorder.jobs())
        with self._lock:
            for key in [k for k in self._jobs if k not in known]:
                del self._jobs[key]
            latest = {
                key: job.closed[-1]
                for key, job in self._jobs.items()
                if job.closed
            }
        if self.hbm_peak is None:
            return
        self.hbm_peak.remove_matching()
        self.hbm_headroom.remove_matching()
        for (namespace, name), window in latest.items():
            self.hbm_peak.set(
                float(window["hbm_peak_bytes"]), namespace, name
            )
            self.hbm_headroom.set(
                float(window["headroom_ratio"]), namespace, name
            )
