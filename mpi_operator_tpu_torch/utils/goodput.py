"""Job-lifecycle goodput ledger: per-phase wall-clock attribution.

``utils/telemetry.py`` knows what fraction of a *process's* wall time was
productive step time; nothing accounts for the hours a TPUJob loses
*outside* the training loop — queue wait, scheduling, pod startup,
rendezvous, restart downtime — exactly the accounting the MLPerf TPU-pod
papers (arxiv 1909.09756, 2011.03641) show dominates time-to-train at
scale.  The flight recorder (utils/flightrecorder.py) already captures
every raw event needed: condition transitions (controller + queue
manager), scheduling decisions (scheduler core), and pod phase flips
(pod runner).  The ``GoodputLedger`` joins them into the missing
job-level layer.

Each job's wall clock decomposes into a **closed phase vocabulary**
(PhaseProfiler-style exclusive accounting — phases tile the wall time):

- ``queue_wait``        suspended/unadmitted (quota pending, evicted,
                        queue missing, user-suspended);
- ``scheduling``        admitted, gang not yet placed;
- ``pod_pending``       gang bound / pods created, none running yet;
- ``bootstrap``         first pod running → whole gang running
                        (rendezvous, image pull, device init);
- ``productive``        gang running (minus checkpoint time reported by
                        training telemetry);
- ``checkpoint``        durable-save time carved out of productive,
                        joined from train_telemetry records;
- ``restart_downtime``  a worker died / the gang was preempted →
                        back to whole-gang running;
- ``unattributed``      residue (clock skew, rounding) — kept explicit
                        so the sum is exactly the wall time.

The ledger is scrape-driven like utils/statemetrics.py: per-job goodput
gauges and fleet aggregates are recomputed on ``Registry.on_scrape``;
terminal jobs additionally land in per-phase histograms exactly once.
The monitoring server serves ``/debug/jobs/<ns>/<name>/goodput`` and the
fleet ``/debug/goodput`` rollup from the same snapshots, and
``bench_goodput.py`` drives the whole stack under seeded chaos to emit
the goodput-vs-kill-rate curve.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Optional

from . import flightrecorder, metrics

# -- phase vocabulary (closed; schema consumers key on it) ---------------

PHASE_QUEUE_WAIT = "queue_wait"
PHASE_SCHEDULING = "scheduling"
PHASE_POD_PENDING = "pod_pending"
PHASE_BOOTSTRAP = "bootstrap"
PHASE_PRODUCTIVE = "productive"
PHASE_CHECKPOINT = "checkpoint"
# Gang wall time lost waiting on the slowest worker each step — carved
# out of productive by the step-skew join (utils/stepstats.py), the same
# way checkpoint seconds are carved by the telemetry join.
PHASE_SKEW_WAIT = "skew_wait"
PHASE_RESTART_DOWNTIME = "restart_downtime"
UNATTRIBUTED = "unattributed"

GOODPUT_PHASES = (
    PHASE_QUEUE_WAIT,
    PHASE_SCHEDULING,
    PHASE_POD_PENDING,
    PHASE_BOOTSTRAP,
    PHASE_PRODUCTIVE,
    PHASE_CHECKPOINT,
    PHASE_SKEW_WAIT,
    PHASE_RESTART_DOWNTIME,
    UNATTRIBUTED,
)

# Terminal pseudo-state: no phase accrues past the terminal condition.
_ENDED = "_ended"

# Job phases run from seconds (tests) to days (real pods): much wider
# buckets than server-latency defaults.
PHASE_BUCKETS = (
    0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 120.0, 300.0, 600.0, 1800.0,
    3600.0, 14400.0, 86400.0,
)

# The live states a timeline walks through (everything but checkpoint,
# which is carved out of productive by the telemetry join, and
# unattributed, which is the residue).
_LIVE_STATES = (
    PHASE_QUEUE_WAIT,
    PHASE_SCHEDULING,
    PHASE_POD_PENDING,
    PHASE_BOOTSTRAP,
    PHASE_PRODUCTIVE,
    PHASE_RESTART_DOWNTIME,
)


def _next_state(state: str, entry: dict) -> str:
    """Transition function over flight-recorder entries.  Guards keep
    re-recorded or out-of-order entries from bouncing the state machine:
    e.g. a pod flip during restart downtime stays downtime until the
    controller re-asserts the whole-gang Running condition."""
    if state == _ENDED:
        # Terminal is absorbing: post-mortem entries (late pod flips,
        # condition rewrites) must never resurrect a finished job — the
        # phases-sum-to-wall invariant depends on charging stopping for
        # good at the terminal timestamp.
        return _ENDED
    kind = entry.get("kind")
    reason = entry.get("reason", "")
    if kind == flightrecorder.CONDITION:
        type_ = entry.get("type", "")
        is_true = entry.get("status", "True") == "True"
        if type_ in ("Succeeded", "Failed") and is_true:
            return _ENDED
        if type_ == "Running" and is_true:
            return PHASE_PRODUCTIVE
        if type_ == "Restarting" and is_true:
            return PHASE_RESTART_DOWNTIME
        if type_ == "Suspended":
            if is_true:
                return PHASE_QUEUE_WAIT
            return PHASE_SCHEDULING if state == PHASE_QUEUE_WAIT else state
        if type_ == "QuotaReserved":
            if not is_true:  # Pending / Evicted
                return PHASE_QUEUE_WAIT
            # Admitted: only forward motion — a re-assert while the gang
            # is already placed or running must not rewind the state.
            if state in (PHASE_QUEUE_WAIT, PHASE_SCHEDULING):
                return PHASE_SCHEDULING
            return state
        if type_ == "QueueNotFound" and is_true:
            return PHASE_QUEUE_WAIT
        if type_ == "Scheduled":
            if is_true:
                if state in (PHASE_QUEUE_WAIT, PHASE_SCHEDULING):
                    return PHASE_POD_PENDING
                return state
            # Unschedulable: back to the scheduling queue.
            if state == PHASE_POD_PENDING:
                return PHASE_SCHEDULING
            return state
        return state
    if kind == flightrecorder.SCHEDULING:
        if reason == "Scheduled" and state in (
            PHASE_QUEUE_WAIT, PHASE_SCHEDULING
        ):
            return PHASE_POD_PENDING
        if reason == "Preempted" and state in (
            PHASE_POD_PENDING, PHASE_BOOTSTRAP, PHASE_PRODUCTIVE
        ):
            return PHASE_RESTART_DOWNTIME
        return state  # FailedScheduling et al.: still scheduling
    if kind == flightrecorder.POD:
        phase = entry.get("phase", "")
        if phase == "Pending" and state == PHASE_SCHEDULING:
            return PHASE_POD_PENDING
        if phase == "Running" and state in (
            PHASE_SCHEDULING, PHASE_POD_PENDING
        ):
            return PHASE_BOOTSTRAP
        if phase == "Failed" and state in (
            PHASE_POD_PENDING, PHASE_BOOTSTRAP, PHASE_PRODUCTIVE
        ):
            return PHASE_RESTART_DOWNTIME
        return state
    # EVENT entries duplicate condition/scheduling information; the state
    # machine keys off the authoritative sources only.
    return state


def attribute_timeline(entries: list, now: Optional[float] = None) -> dict:
    """Decompose one flight-recorder timeline into per-phase seconds.

    Exclusive accounting: the interval between consecutive entries is
    charged to the state the job was in *during* that interval, so the
    phases sum to the wall time by construction.  A terminal condition
    freezes the clock — post-mortem timeline entries (and ``now``) never
    extend a finished job's wall time.
    """
    phases = {p: 0.0 for p in GOODPUT_PHASES}
    entries = sorted(entries, key=lambda e: e.get("seq", 0))
    if not entries:
        return {
            "phases": phases, "wall_seconds": 0.0, "terminal": False,
            "restarts": 0, "start_ts": None, "end_ts": None,
        }
    t0 = float(entries[0].get("ts", 0.0))
    state = PHASE_SCHEDULING
    prev_ts = t0
    restarts = 0
    terminal_ts: Optional[float] = None
    for entry in entries:
        # Monotonic guard: seq order is authoritative; a timestamp that
        # runs backwards (clock skew) charges zero, never negative.
        ts = max(float(entry.get("ts", prev_ts)), prev_ts)
        if state != _ENDED:
            phases[state] += ts - prev_ts
        prev_ts = ts
        new = _next_state(state, entry)
        if new == _ENDED and terminal_ts is None:
            terminal_ts = ts
        if new == PHASE_RESTART_DOWNTIME and state != PHASE_RESTART_DOWNTIME:
            restarts += 1
        state = new
    if state == _ENDED and terminal_ts is not None:
        wall = terminal_ts - t0
        end_ts = terminal_ts
    else:
        end_ts = prev_ts if now is None else max(float(now), prev_ts)
        phases[state] += end_ts - prev_ts
        wall = end_ts - t0
    return {
        "phases": phases,
        "wall_seconds": wall,
        "terminal": state == _ENDED,
        "restarts": restarts,
        "start_ts": t0,
        "end_ts": end_ts,
    }


class GoodputLedger:
    """Joins flight-recorder timelines and training telemetry into
    per-job and fleet goodput, exposed three ways: scrape-time metrics,
    the ``/debug`` endpoints, and the bench artifact."""

    def __init__(
        self,
        flight_recorder: flightrecorder.FlightRecorder,
        registry: Optional[metrics.Registry] = None,
        clock: Callable[[], float] = time.time,
        skew_provider: Optional[Callable[[str, str], float]] = None,
    ):
        self._recorder = flight_recorder
        self._clock = clock
        # (namespace, name) -> cumulative skew-wait seconds; the operator
        # wires StepMatrix.skew_wait_seconds here so gang stall time is
        # carved out of productive (zero-arg default: no observatory).
        self._skew_provider = skew_provider
        self._lock = threading.Lock()
        # Latest train_telemetry record per job (checkpoint_s join).
        self._telemetry: dict[tuple[str, str], dict] = {}
        # Terminal jobs already observed into the phase histograms.
        self._finalized: set[tuple[str, str]] = set()

        self.goodput_ratio = None
        if registry is not None:
            self.goodput_ratio = metrics.new_gauge(
                "tpu_operator_job_goodput_ratio",
                "Productive wall-time fraction per TPUJob (flight-recorder "
                "phase attribution)",
                ("namespace", "tpujob"),
                registry,
            )
            self.phase_seconds = metrics.new_histogram(
                "tpu_operator_job_phase_seconds",
                "Per-phase wall seconds of terminal TPUJobs (observed once "
                "per job at completion)",
                ("phase",),
                registry,
                buckets=PHASE_BUCKETS,
            )
            self.fleet_goodput = metrics.new_gauge(
                "tpu_operator_job_goodput_fleet_ratio",
                "Fleet goodput: sum of productive seconds over sum of wall "
                "seconds across tracked TPUJobs",
                (),
                registry,
            )
            self.fleet_phase_seconds = metrics.new_gauge(
                "tpu_operator_job_phase_fleet_seconds",
                "Fleet-aggregate wall seconds by lifecycle phase",
                ("phase",),
                registry,
            )
            registry.on_scrape(self.collect)

    # -- telemetry join --------------------------------------------------

    def observe_telemetry(self, namespace: str, name: str, record: dict) -> None:
        """Feed one ``train_telemetry`` record (utils/telemetry.py
        snapshot shape).  ``checkpoint_s`` is carved out of the job's
        productive time; later records replace earlier ones (the fields
        are cumulative)."""
        with self._lock:
            self._telemetry[(namespace, name)] = dict(record)

    # -- snapshots -------------------------------------------------------

    def job_snapshot(
        self, namespace: str, name: str, now: Optional[float] = None
    ) -> Optional[dict]:
        """Per-job decomposition, or None when the flight recorder has
        never seen the job (the endpoint's 404 signal)."""
        entries = self._recorder.timeline(namespace, name)
        if entries is None:
            return None
        if now is None:
            now = self._clock()
        att = attribute_timeline(entries, now=now)
        phases = att["phases"]
        with self._lock:
            tel = self._telemetry.get((namespace, name))
        checkpoint_s = float((tel or {}).get("checkpoint_s", 0.0) or 0.0)
        carve = min(checkpoint_s, phases[PHASE_PRODUCTIVE])
        phases[PHASE_CHECKPOINT] += carve
        phases[PHASE_PRODUCTIVE] -= carve
        # Skew-wait carve mirrors the checkpoint one: both are wall time
        # the job spent nominally "training" but not making progress, and
        # both are clamped so the tiling invariant (phases sum to wall)
        # survives a noisy estimate.
        skew_s = (
            float(self._skew_provider(namespace, name))
            if self._skew_provider is not None
            else 0.0
        )
        skew_carve = min(max(skew_s, 0.0), phases[PHASE_PRODUCTIVE])
        phases[PHASE_SKEW_WAIT] += skew_carve
        phases[PHASE_PRODUCTIVE] -= skew_carve
        wall = att["wall_seconds"]
        attributed = sum(phases[p] for p in GOODPUT_PHASES if p != UNATTRIBUTED)
        phases[UNATTRIBUTED] += max(0.0, wall - attributed)
        goodput = phases[PHASE_PRODUCTIVE] / wall if wall > 0 else 0.0
        return {
            "namespace": namespace,
            "name": name,
            "wall_seconds": round(wall, 6),
            "goodput_ratio": round(goodput, 6),
            "terminal": att["terminal"],
            "restarts": att["restarts"],
            "phases": {p: round(phases[p], 6) for p in GOODPUT_PHASES},
            "phase_shares": {
                p: round(phases[p] / wall, 6) if wall > 0 else 0.0
                for p in GOODPUT_PHASES
            },
        }

    def fleet_snapshot(self, now: Optional[float] = None) -> dict:
        """Fleet rollup across every job the recorder tracks: aggregate
        goodput (Σ productive / Σ wall), per-phase totals and shares,
        plus a compact per-job table for the ``/debug/goodput`` page."""
        if now is None:
            now = self._clock()
        snaps = []
        for namespace, name in self._recorder.jobs():
            snap = self.job_snapshot(namespace, name, now=now)
            if snap is not None:
                snaps.append(snap)
        total_wall = sum(s["wall_seconds"] for s in snaps)
        phase_seconds = {
            p: round(sum(s["phases"][p] for s in snaps), 6)
            for p in GOODPUT_PHASES
        }
        productive = phase_seconds[PHASE_PRODUCTIVE]
        return {
            "job_count": len(snaps),
            "terminal_jobs": sum(1 for s in snaps if s["terminal"]),
            "restarts": sum(s["restarts"] for s in snaps),
            "wall_seconds": round(total_wall, 6),
            "goodput_ratio": round(
                productive / total_wall if total_wall > 0 else 0.0, 6
            ),
            "phase_seconds": phase_seconds,
            "phase_shares": {
                p: round(v / total_wall, 6) if total_wall > 0 else 0.0
                for p, v in phase_seconds.items()
            },
            "jobs": [
                {
                    "namespace": s["namespace"],
                    "name": s["name"],
                    "goodput_ratio": s["goodput_ratio"],
                    "wall_seconds": s["wall_seconds"],
                    "terminal": s["terminal"],
                    "restarts": s["restarts"],
                }
                for s in snaps
            ],
        }

    # -- scrape hook -----------------------------------------------------

    def collect(self) -> None:
        """statemetrics-style full recompute per scrape: drop every
        per-job goodput series and re-derive from the recorder, so
        evicted jobs never leave stale series behind.  Terminal jobs
        land in the per-phase histograms exactly once."""
        if self.goodput_ratio is None:
            return
        now = self._clock()
        known: set[tuple[str, str]] = set()
        snaps = []
        for namespace, name in self._recorder.jobs():
            snap = self.job_snapshot(namespace, name, now=now)
            if snap is not None:
                known.add((namespace, name))
                snaps.append(snap)

        self.goodput_ratio.remove_matching()
        total_wall = 0.0
        phase_totals = {p: 0.0 for p in GOODPUT_PHASES}
        for snap in snaps:
            key = (snap["namespace"], snap["name"])
            self.goodput_ratio.set(
                snap["goodput_ratio"], snap["namespace"], snap["name"]
            )
            total_wall += snap["wall_seconds"]
            for p in GOODPUT_PHASES:
                phase_totals[p] += snap["phases"][p]
            if snap["terminal"]:
                with self._lock:
                    fresh = key not in self._finalized
                    if fresh:
                        self._finalized.add(key)
                if fresh:
                    for p in GOODPUT_PHASES:
                        self.phase_seconds.observe(snap["phases"][p], p)
        self.fleet_goodput.set(
            round(phase_totals[PHASE_PRODUCTIVE] / total_wall, 6)
            if total_wall > 0 else 0.0
        )
        for p in GOODPUT_PHASES:
            self.fleet_phase_seconds.set(round(phase_totals[p], 6), p)
        with self._lock:
            # Evicted jobs can never be re-observed (timeline() is None),
            # so dropping their keys keeps both tables bounded by the
            # recorder's own max_jobs LRU.
            self._finalized &= known
            for key in [k for k in self._telemetry if k not in known]:
                del self._telemetry[key]
