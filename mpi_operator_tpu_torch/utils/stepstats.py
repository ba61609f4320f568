"""Fleet step-skew observatory: the per-job StepMatrix.

Synchronous allreduce training runs at the speed of its slowest host —
the TPU-pod scaling papers (arxiv 1909.09756, 2011.03641) treat
cross-host step-time skew as the first-order scaling loss — yet per-pod
telemetry alone cannot see it: every worker's own step clock looks
healthy while the whole gang waits on one straggler.  The worker side
(utils/telemetry.py) emits windowed ``step_heartbeat`` records; the
kubelet sim (runtime/podrunner.py) patches them onto each worker's Pod
as the step-heartbeat annotation; the ordinary pod informer watch then
delivers them here, where the ``StepMatrix`` joins heartbeats *across*
workers per job:

- **fleet skew** — max/median step-wall ratio per closed window, the
  slowest-host attribution, and the per-window skew histogram
  ``tpu_operator_job_step_skew``;
- **straggler detection** — a worker whose window p50 exceeds
  ``k × median`` for ``windows`` consecutive closed windows is a
  straggler: the controller surfaces the ``Straggling`` job condition
  (+ flight-recorder entry), and ``tpu_operator_job_stragglers`` gauges
  the live count per job;
- **skew-wait attribution** — per closed window, the gang's wall-clock
  excess over the typical worker ((max − median) p50 × steps)
  accumulates as ``skew_wait_seconds``, which the goodput ledger
  (utils/goodput.py) carves out of the job's ``productive`` phase so
  skew is priced, not hidden.

Bounds mirror the goodput ledger's pruning contract: tracked jobs are
bounded by the flight recorder's own LRU (``collect`` drops any job the
recorder no longer knows, and ``remove_matching`` clears its gauge
series), per-job window history is a ring, and open (unjoined) windows
are capped.  The monitoring server serves one job's live matrix at
``/debug/jobs/<ns>/<name>/steps``.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Callable, Optional

from ..runtime import locktrace
from . import flightrecorder, metrics

# Straggler detector defaults: a worker slower than 1.5x the gang median
# for 3 consecutive closed windows is straggling.  k is chosen above
# ordinary jitter (input stalls, GC) but below the 2x the chaos bench
# injects; 3 windows filters one-off hiccups without sitting on a real
# straggler for long.
DEFAULT_SKEW_THRESHOLD = 1.5
DEFAULT_CONSECUTIVE_WINDOWS = 3

# Per-job rings/caps: recent closed windows kept for /steps, open
# windows allowed to lag before force-closing, workers tracked per job.
DEFAULT_WINDOW_HISTORY = 64
MAX_OPEN_WINDOW_LAG = 4
MAX_WORKERS_PER_JOB = 512

# Skew is a unitless max/median ratio >= 1; buckets resolve the region
# around the detection threshold and the chaos factors.
SKEW_BUCKETS = (1.02, 1.05, 1.1, 1.2, 1.35, 1.5, 1.75, 2.0, 3.0, 5.0, 10.0)


def _median(values: list[float]) -> float:
    ordered = sorted(values)
    n = len(ordered)
    mid = n // 2
    if n % 2:
        return ordered[mid]
    return (ordered[mid - 1] + ordered[mid]) / 2.0


def _roster_entry(worker: str, pod: str) -> dict:
    """Membership placeholder for a worker the informer has seen but
    that has not heartbeated yet (window -1 orders before any real
    heartbeat)."""
    return {
        "worker": worker,
        "hostname": "",
        "pod": pod,
        "window": -1,
        "step": 0,
        "steps": 0,
        "step_wall_p50_ms": 0.0,
        "step_wall_max_ms": 0.0,
        "wait_share": 0.0,
    }


class _JobMatrix:
    """One job's join state: latest heartbeat per worker, open windows
    awaiting the full gang, closed-window ring, detector counters."""

    __slots__ = (
        "workers", "open_windows", "closed", "consecutive", "straggling",
        "skew_wait_s", "last_closed_window",
    )

    def __init__(self, history: int):
        self.workers: dict[str, dict] = {}
        self.open_windows: dict[int, dict[str, dict]] = {}
        self.closed: deque = deque(maxlen=history)
        self.consecutive: dict[str, int] = {}
        self.straggling: set[str] = set()
        self.skew_wait_s = 0.0
        self.last_closed_window = -1


class StepMatrix:
    """Joins per-worker step heartbeats into per-job skew, straggler
    verdicts, and skew-wait seconds.

    ``observe_pod`` is the single write path (wired as a pod informer
    handler); everything else reads.  All numbers derive from heartbeat
    content, never wall clocks, so a simulated-clock bench replays
    bit-identically.
    """

    def __init__(
        self,
        flight_recorder: flightrecorder.FlightRecorder,
        registry: Optional[metrics.Registry] = None,
        clock: Callable[[], float] = time.time,
        *,
        skew_threshold: float = DEFAULT_SKEW_THRESHOLD,
        consecutive_windows: int = DEFAULT_CONSECUTIVE_WINDOWS,
        window_history: int = DEFAULT_WINDOW_HISTORY,
    ):
        if skew_threshold <= 1.0:
            raise ValueError(
                f"skew_threshold must be > 1, got {skew_threshold!r}"
            )
        if consecutive_windows < 1:
            raise ValueError(
                f"consecutive_windows must be >= 1, got {consecutive_windows!r}"
            )
        self._recorder = flight_recorder
        self._clock = clock
        self.skew_threshold = skew_threshold
        self.consecutive_windows = consecutive_windows
        self._history = max(window_history, 1)
        self._lock = locktrace.lock("stepstats")
        self._jobs: dict[tuple[str, str], _JobMatrix] = {}

        self.step_skew = None
        if registry is not None:
            # Unitless max/median ratio — the one deliberate exception to
            # the histograms-are-seconds convention (rule TPU103): skew IS
            # the quantity, and scaling it into seconds would tie the
            # series to the workload's step time.
            self.step_skew = metrics.new_histogram(  # noqa: TPU103
                "tpu_operator_job_step_skew",
                "Per-window fleet step skew (max/median worker step-wall "
                "p50) across joined heartbeat windows",
                (),
                registry,
                buckets=SKEW_BUCKETS,
            )
            self.stragglers = metrics.new_gauge(
                "tpu_operator_job_stragglers",
                "Workers currently flagged as stragglers per TPUJob "
                "(window p50 > k x gang median for M consecutive windows)",
                ("namespace", "tpujob"),
                registry,
            )
            registry.on_scrape(self.collect)

    # -- write path ------------------------------------------------------

    def observe_pod(self, pod: dict) -> None:
        """Fold one pod event into the owning job's matrix.

        Worker pods *without* a heartbeat annotation still register gang
        membership: the informer knows the gang's roster before the
        first heartbeat lands, so the first window only closes when the
        whole gang has reported it — not when the first arrival happens
        to be the only worker seen so far.  A terminal pod leaves the
        roster (a dead worker must not wedge window closure for the
        living).  Heartbeat folds are idempotent per (worker, window):
        informer resyncs and duplicate MODIFIED events never
        double-count."""
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
        # Replica index first: unlike TPU_WORKER_ID (which repeats per
        # slice in multislice jobs), it is unique across the whole gang.
        worker = labels.get(constants.REPLICA_INDEX_LABEL)
        if worker is None:
            worker = meta.get("name", "")
        worker = str(worker)
        phase = (pod.get("status") or {}).get("phase", "")

        raw = (meta.get("annotations") or {}).get(
            constants.STEP_HEARTBEAT_ANNOTATION
        )
        if not raw:
            with self._lock:
                job = self._jobs.get((namespace, job_name))
                if phase in ("Succeeded", "Failed"):
                    if job is not None and worker in job.workers:
                        del job.workers[worker]
                        self._close_ready_windows(job)
                    return
                if job is None:
                    job = self._jobs[(namespace, job_name)] = _JobMatrix(
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
        p50_ms = record.get("step_wall_p50_ms")
        if not isinstance(window, int) or not isinstance(
            p50_ms, (int, float)
        ):
            return

        hb = {
            "worker": worker,
            "hostname": str(record.get("hostname", "")),
            "pod": meta.get("name", ""),
            "window": window,
            "step": int(record.get("step", 0) or 0),
            "steps": int(record.get("steps", 0) or 0),
            "step_wall_p50_ms": float(p50_ms),
            "step_wall_max_ms": float(
                record.get("step_wall_max_ms", p50_ms) or p50_ms
            ),
            "wait_share": float(record.get("wait_share", 0.0) or 0.0),
        }
        with self._lock:
            job = self._jobs.get((namespace, job_name))
            if job is None:
                job = self._jobs[(namespace, job_name)] = _JobMatrix(
                    self._history
                )
            known = job.workers.get(worker)
            if known is not None and known["window"] >= window:
                return  # stale or duplicate delivery
            if (
                known is None
                and len(job.workers) >= MAX_WORKERS_PER_JOB
            ):
                return
            job.workers[worker] = hb
            if window > job.last_closed_window:
                job.open_windows.setdefault(window, {})[worker] = hb
            if phase in ("Succeeded", "Failed"):
                # The final flush of a finished worker: fold it, then
                # leave the roster so later windows can close without it.
                del job.workers[worker]
            self._close_ready_windows(job)

    def _close_ready_windows(self, job: _JobMatrix) -> None:
        """Close every open window the whole known gang has reported,
        plus any window lagging more than MAX_OPEN_WINDOW_LAG behind the
        newest (a dead worker must not wedge detection for the living).
        Caller holds the lock."""
        if not job.open_windows:
            return
        newest = max(job.open_windows)
        for window in sorted(job.open_windows):
            members = job.open_windows[window]
            full = len(members) >= len(job.workers)
            lagged = window <= newest - MAX_OPEN_WINDOW_LAG
            if not (full or lagged):
                # Windows close in order: an unready window blocks the
                # ones after it, keeping the detector's "consecutive"
                # counters aligned to a single window sequence.
                break
            del job.open_windows[window]
            if len(members) >= 2:
                self._close_window(job, window, members)
            job.last_closed_window = max(job.last_closed_window, window)

    def _close_window(
        self, job: _JobMatrix, window: int, members: dict[str, dict]
    ) -> None:
        """One joined window: skew ratio, slowest-host attribution,
        skew-wait accrual, detector update.  Caller holds the lock."""
        p50s = {w: hb["step_wall_p50_ms"] for w, hb in members.items()}
        med = _median(list(p50s.values()))
        slowest = max(sorted(p50s), key=lambda w: p50s[w])
        ratio = p50s[slowest] / med if med > 0 else 1.0
        steps = max(hb["steps"] for hb in members.values())
        # Price only above-threshold skew: ordinary step-time jitter
        # (input stalls, GC) stays inside productive — otherwise every
        # healthy gang would bleed skew_wait from the noise floor, and
        # the "skew_wait > 0 iff straggling" invariant the bench gates
        # on would be meaningless.
        wait_s = 0.0
        if ratio > self.skew_threshold:
            wait_s = max(0.0, (p50s[slowest] - med) / 1000.0) * steps
        job.skew_wait_s += wait_s
        job.closed.append({
            "window": window,
            "workers": len(members),
            "skew_ratio": round(ratio, 6),
            "slowest_worker": slowest,
            "median_p50_ms": round(med, 3),
            "max_p50_ms": round(p50s[slowest], 3),
            "skew_wait_s": round(wait_s, 6),
        })
        if self.step_skew is not None:
            self.step_skew.observe(ratio)
        for worker, p50 in p50s.items():
            if p50 > self.skew_threshold * med:
                job.consecutive[worker] = job.consecutive.get(worker, 0) + 1
                if job.consecutive[worker] >= self.consecutive_windows:
                    job.straggling.add(worker)
            else:
                job.consecutive[worker] = 0
                job.straggling.discard(worker)

    # -- read paths ------------------------------------------------------

    def straggler_verdict(self, namespace: str, name: str) -> Optional[dict]:
        """The controller's per-sync question: None when the matrix has
        no joined windows for the job yet (insufficient data — say
        nothing); else whether the gang currently has stragglers, who,
        and at what skew."""
        with self._lock:
            job = self._jobs.get((namespace, name))
            if job is None or not job.closed:
                return None
            latest = job.closed[-1]
            return {
                "straggling": bool(job.straggling),
                "workers": sorted(job.straggling),
                "skew_ratio": latest["skew_ratio"],
                "slowest_worker": latest["slowest_worker"],
                "window": latest["window"],
            }

    def skew_wait_seconds(self, namespace: str, name: str) -> float:
        """Cumulative gang wall-clock seconds lost to step skew — the
        goodput ledger's ``skew_wait`` carve (utils/goodput.py)."""
        with self._lock:
            job = self._jobs.get((namespace, name))
            return job.skew_wait_s if job is not None else 0.0

    def job_snapshot(self, namespace: str, name: str) -> Optional[dict]:
        """The ``/debug/jobs/<ns>/<name>/steps`` payload, or None when
        the job has never produced a heartbeat (the endpoint's 404)."""
        with self._lock:
            job = self._jobs.get((namespace, name))
            if job is None:
                return None
            latest = job.closed[-1] if job.closed else None
            return {
                "namespace": namespace,
                "name": name,
                "straggling": bool(job.straggling),
                "stragglers": sorted(job.straggling),
                "skew_ratio": latest["skew_ratio"] if latest else 0.0,
                "slowest_worker": (
                    latest["slowest_worker"] if latest else None
                ),
                "skew_wait_seconds": round(job.skew_wait_s, 6),
                "skew_threshold": self.skew_threshold,
                "consecutive_windows": self.consecutive_windows,
                "workers": {
                    worker: {
                        **hb,
                        "consecutive_slow_windows": job.consecutive.get(
                            worker, 0
                        ),
                        "straggling": worker in job.straggling,
                    }
                    for worker, hb in sorted(job.workers.items())
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
        """Scrape-time recompute + pruning (the goodput-ledger contract):
        the straggler gauge is re-derived from live state with stale
        series dropped, and any job the flight recorder has LRU-evicted
        loses its matrix too — the recorder's ``max_jobs`` bounds this
        table transitively."""
        known = set(self._recorder.jobs())
        with self._lock:
            for key in [k for k in self._jobs if k not in known]:
                del self._jobs[key]
            counts = {
                key: len(job.straggling) for key, job in self._jobs.items()
            }
        if self.step_skew is None:
            return
        self.stragglers.remove_matching()
        for (namespace, name), count in counts.items():
            self.stragglers.set(float(count), namespace, name)
