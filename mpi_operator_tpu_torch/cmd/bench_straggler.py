"""Straggler-detection benchmark: how fast the step-skew observatory
finds a degraded host, and how accurately it prices the skew.

``bench_goodput`` measures where whole-pod failures put the time;
this harness measures the subtler failure mode — a worker that keeps
running, just slower than its gang — which pod-phase chaos can never
produce.  It drives N TPUJob gangs on a simulated clock, injects
``SlowWorker`` chaos (chaos/policy.py) through the same ``WorkerSlower``
→ ``slow_worker`` surface production uses, and feeds each worker's
windowed step heartbeats through the kube-native path: heartbeat →
pod annotation patch → pod informer → ``StepMatrix``
(utils/stepstats.py) → ``Straggling`` condition → goodput ``skew_wait``
carve.

Per injected slowdown factor it reports:

- **detection latency** — closed windows from the first slowed window to
  the ``Straggling`` condition (the acceptance gate: <= the detector's
  ``consecutive_windows`` at factor 2.0);
- **false-positive rate** — jobs flagged ``Straggling`` that had no
  slowed worker (must be zero, including the whole factor-1.0 control
  arm, where chaos "slows" its victims by a no-op 1.0x);
- **skew accuracy** — the matrix's measured max/median ratio versus the
  injected factor;
- **skew-wait attribution** — the ledger's ``skew_wait`` phase is > 0
  only for straggler jobs, and the per-phase seconds still tile each
  job's wall clock.

Determinism: control logic runs on the simulated clock, chaos victims
and step-time jitter come from seeded RNGs, and every reported number
derives from sim time or window indices — so the same seed reproduces
the document bit-for-bit.

The port's copy of the root ``bench_straggler.py``, run on the port's
control plane. Its gang is ``h100-4``: four worker pods, one GPU each,
on one 4-GPU node, mirroring the JAX bench's four-host ``v5e-16`` slice
member for member, so the same arguments write the same document byte
for byte (the committed ``BENCH_STRAGGLER.json`` at ``--jobs 8
--seed 42``). It imports neither torch nor JAX: a process of the
control plane, it touches no device.

Run:  python -m mpi_operator_tpu_torch.cmd.bench_straggler --jobs 8 --seed 42
      python -m mpi_operator_tpu_torch.cmd.bench_straggler \
          --factors 1.0,2.0,4.0 --lock-trace
Emits BENCH_STRAGGLER_torch.json (schema-checked) and prints one JSON
summary line.
"""

from __future__ import annotations

import argparse
import json
import random
import sys
import time

from mpi_operator_tpu_torch import chaos
from mpi_operator_tpu_torch.api.v2beta1 import (
    REPLICA_TYPE_WORKER,
    ReplicaSpec,
    TPUJob,
    TPUJobSpec,
    TPUSpec,
)
from mpi_operator_tpu_torch.api.v2beta1 import constants
from mpi_operator_tpu_torch.api.v2beta1.types import JOB_STRAGGLING
from mpi_operator_tpu_torch.controller.tpu_job_controller import TPUJobController
from mpi_operator_tpu_torch.runtime import locktrace, retry
from mpi_operator_tpu_torch.runtime.apiserver import ApiError, InMemoryAPIServer
from mpi_operator_tpu_torch.utils import flightrecorder, goodput, metrics, stepstats
from mpi_operator_tpu_torch.utils import logging as logutil

TEMPLATE = {"spec": {"containers": [{"name": "main", "image": "gpu-image"}]}}
NOW = 1000.0
# h100-4 = 4 GPUs, one a worker pod = a 4-worker gang per job.
WORKERS_PER_JOB = 4
# Healthy step wall time and heartbeat window in the sim.
BASE_STEP_MS = 100.0
STEPS_PER_WINDOW = 10
# Sim seconds per window round: covers the slowest worker's window
# (factor x base x steps) at the factors the acceptance curve uses.
ROUND_S = 2.5
# The acceptance arms: control (no-op slowdown) and the 2x degraded host.
FACTORS = (1.0, 2.0)

SCHEMA_VERSION = 1


def log(*args):
    print(*args, file=sys.stderr, flush=True)


class StragglerRunner:
    """The bench's kubelet sim: flips created pods Running (recording
    flight-recorder POD entries, as LocalPodRunner does), exposes the
    ``slow_worker`` surface ``WorkerSlower`` drives, and emits each
    worker's step heartbeats — slowed by the chaos factor — as pod
    annotation patches, exactly the transport the live runner tails out
    of pod logs."""

    def __init__(
        self,
        api: InMemoryAPIServer,
        recorder: flightrecorder.FlightRecorder,
        rng: random.Random,
    ):
        self.api = api
        self.recorder = recorder
        self.rng = rng
        # (namespace, pod-name) -> chaos slowdown factor.
        self.slow: dict[tuple[str, str], float] = {}
        self._window: dict[tuple[str, str], int] = {}

    def tick(self) -> None:
        for pod in self.api.list("pods"):
            meta = pod.get("metadata") or {}
            if ((pod.get("status") or {}).get("phase") or "Pending") != "Pending":
                continue
            status = dict(pod.get("status") or {})
            # This kubelet sim is the run's node agent: it owns pod phase
            # here as runtime/podrunner.py does in a live cluster.
            status["phase"] = "Running"  # noqa: TPU302
            pod["status"] = status
            self.api.update_status("pods", pod)
            job_name = (meta.get("labels") or {}).get(constants.JOB_NAME_LABEL)
            if job_name:
                self.recorder.record(
                    meta.get("namespace", ""), job_name, flightrecorder.POD,
                    reason="Running", pod=meta.get("name", ""),
                    phase="Running",
                )

    # -- WorkerSlower surface -------------------------------------------

    def slow_worker(self, namespace: str, name: str, factor: float) -> bool:
        if factor < 1.0:
            return False
        try:
            self.api.get("pods", namespace, name)
        except ApiError:
            return False
        self.slow[(namespace, name)] = factor
        return True

    # -- heartbeat emission ---------------------------------------------

    def emit_window(self) -> int:
        """One heartbeat window for every running worker: the worker's
        step clock is BASE_STEP_MS x its chaos factor x ~2% seeded
        jitter; the record lands as the pod's step-heartbeat annotation
        (the informer delivers it to the StepMatrix from there)."""
        emitted = 0
        for pod in sorted(
            self.api.list("pods"),
            key=lambda p: (p.get("metadata") or {}).get("name", ""),
        ):
            meta = pod.get("metadata") or {}
            if (pod.get("status") or {}).get("phase") != "Running":
                continue
            key = (meta.get("namespace", ""), meta.get("name", ""))
            factor = self.slow.get(key, 1.0)
            window = self._window.get(key, 0)
            p50_ms = BASE_STEP_MS * factor * self.rng.uniform(0.98, 1.02)
            index = (meta.get("labels") or {}).get(
                constants.REPLICA_INDEX_LABEL, "0"
            )
            record = {
                "event": "step_heartbeat",
                "window": window,
                "step": (window + 1) * STEPS_PER_WINDOW,
                "steps": STEPS_PER_WINDOW,
                "step_wall_p50_ms": round(p50_ms, 3),
                "step_wall_max_ms": round(p50_ms * 1.1, 3),
                "wait_share": 0.0,
                "window_s": round(p50_ms * STEPS_PER_WINDOW / 1000.0, 6),
                "worker_id": int(index),
                "hostname": f"{key[1]}.host",
            }
            fresh = self.api.get("pods", key[0], key[1])
            annotations = fresh["metadata"].setdefault("annotations", {})
            annotations[constants.STEP_HEARTBEAT_ANNOTATION] = json.dumps(
                record, sort_keys=True
            )
            self.api.update("pods", fresh)
            self._window[key] = window + 1
            emitted += 1
        return emitted


def _expected_ratio(slowed: int, workers: int, factor: float) -> float:
    """The max/median step-wall ratio a gang with ``slowed`` of
    ``workers`` members degraded by ``factor`` should exhibit (the
    jitter-free ground truth the bench grades the matrix against)."""
    p50s = sorted([1.0] * (workers - slowed) + [factor] * slowed)
    n = len(p50s)
    mid = n // 2
    med = p50s[mid] if n % 2 else (p50s[mid - 1] + p50s[mid]) / 2.0
    return p50s[-1] / med if med > 0 else 1.0


def straggler_job(name: str) -> TPUJob:
    job = TPUJob()
    job.metadata.name = name
    job.metadata.namespace = "default"
    job.spec = TPUJobSpec(
        tpu=TPUSpec(accelerator_type="h100-4"),
        replica_specs={
            REPLICA_TYPE_WORKER: ReplicaSpec(
                replicas=WORKERS_PER_JOB, template=dict(TEMPLATE)
            )
        },
    )
    job.spec.run_policy.clean_pod_policy = "None"
    return job


def _straggling_jobs(api: InMemoryAPIServer) -> set:
    flagged = set()
    for job in api.list("tpujobs", "default"):
        for cond in (job.get("status") or {}).get("conditions") or []:
            if cond.get("type") == JOB_STRAGGLING and cond.get("status") == "True":
                flagged.add(job["metadata"]["name"])
    return flagged


def run_factor(factor: float, jobs: int, seed: int, windows: int) -> dict:
    """Drive ``jobs`` gangs through ``windows`` heartbeat windows with
    SlowWorker chaos at one slowdown factor; return the per-factor
    result block of BENCH_STRAGGLER_torch.json.  Same seed => bit-identical
    block (every number derives from sim time, window indices, or the
    seeded RNGs)."""
    rng = random.Random(seed)

    time_ = [NOW]
    clock = lambda: time_[0]  # noqa: E731
    raw = InMemoryAPIServer(clock=clock)
    registry = metrics.Registry()
    recorder = flightrecorder.FlightRecorder(
        capacity_per_job=1024, max_jobs=jobs + 8, clock=clock
    )
    matrix = stepstats.StepMatrix(recorder, registry=registry, clock=clock)
    ledger = goodput.GoodputLedger(
        recorder, registry=registry, clock=clock,
        skew_provider=matrix.skew_wait_seconds,
    )
    controller = TPUJobController(
        raw, registry=registry, clock=clock, flight_recorder=recorder,
        step_matrix=matrix,
    )
    runner = StragglerRunner(raw, recorder, rng)

    # One SlowWorker victim per gang on average, budgeted to half the
    # fleet so the control population (never-slowed gangs) stays large
    # enough to measure false positives against.
    engine = chaos.ChaosEngine(chaos.ChaosPolicy(
        seed=seed,
        slow=(chaos.SlowWorkerChaos(
            slow_rate=1.0 / WORKERS_PER_JOB,
            factor=factor,
            namespace="default",
            max_slow=max(1, jobs // 2),
        ),),
    ))
    slower = chaos.WorkerSlower(engine, raw, runner)

    controller.factory.set_resync_interval(1e9)
    for informer in controller.factory._informers.values():
        informer._clock = clock
    controller.queue._clock = clock
    controller.start()

    def pump():
        for _ in range(10):
            if controller.factory.pump_all() == 0:
                return

    def drain():
        for _ in range(jobs * 8 + 100):
            key, _ = controller.queue.get(timeout=0)
            if key is None:
                return
            try:
                controller.sync_handler(key)
            except ApiError:
                controller.queue.add_rate_limited(key)
            else:
                controller.queue.forget(key)
            finally:
                controller.queue.done(key)

    real_sleep = retry.sleep
    retry.sleep = lambda s: None
    wall0 = time.perf_counter()
    detected_at: dict[str, int] = {}
    try:
        for i in range(jobs):
            raw.create("tpujobs", straggler_job(f"straggle-{i:04d}").to_dict())

        # Boot: pods created, flipped Running, jobs marked Running.
        for _ in range(4):
            time_[0] += 1.0
            pump()
            drain()
            runner.tick()
            pump()
            drain()

        # Chaos draws its victims once the fleet is up; every later tick
        # is a no-op re-draw against already-slowed or budget-exhausted
        # policies, matching the live soak's pacing loop.
        slower.tick()
        slowed = sorted(
            target.split(" ", 1)[1] for kind, target, _ in engine.timeline()
            if kind == chaos.SLOW_WORKER
        )
        slowed_per_gang: dict[str, int] = {}
        for name in slowed:
            gang = name.split("/", 1)[1].rsplit("-worker-", 1)[0]
            slowed_per_gang[gang] = slowed_per_gang.get(gang, 0) + 1
        # Ground truth per gang: the max/median ratio the injection
        # *should* produce.  A gang where chaos slowed >= half the
        # workers shifts the median itself — max/median legitimately
        # cannot flag that, so only gangs whose expected ratio clears
        # the detector threshold count as detectable stragglers.
        expected = {
            gang: _expected_ratio(m, WORKERS_PER_JOB, factor)
            for gang, m in slowed_per_gang.items()
        }
        straggler_jobs = {
            gang for gang, ratio in expected.items()
            if ratio > stepstats.DEFAULT_SKEW_THRESHOLD
        }

        for window in range(windows):
            time_[0] += ROUND_S
            runner.emit_window()
            pump()
            drain()
            for name in _straggling_jobs(raw):
                detected_at.setdefault(name, window)
    finally:
        retry.sleep = real_sleep

    log(f"factor {factor}: {len(slowed)} slowed worker(s), "
        f"{len(straggler_jobs)} detectable straggler gang(s) in "
        f"{time.perf_counter() - wall0:.2f}s wall")

    flagged_ever = set(detected_at)
    true_positives = flagged_ever & straggler_jobs
    false_positives = flagged_ever - straggler_jobs
    # Detection latency in closed windows: slowdown is active from
    # window 0, so first-flagged-at window w means w+1 windows to detect.
    latencies = sorted(detected_at[name] + 1 for name in true_positives)

    # Skew accuracy: the matrix's latest measured ratio per detectable
    # straggler gang versus the injection's expected max/median ratio.
    errors, ratios = [], []
    for name in sorted(straggler_jobs):
        snap = matrix.job_snapshot("default", name)
        if snap is not None and snap["skew_ratio"] > 0:
            ratios.append(snap["skew_ratio"])
            errors.append(abs(snap["skew_ratio"] - expected[name]))
    skew_mean = sum(ratios) / len(ratios) if ratios else 0.0
    skew_err = sum(errors) / len(errors) if errors else 0.0

    # Goodput join: skew_wait must be carved exactly for straggler gangs,
    # and the phase decomposition must still tile each job's wall clock.
    skew_wait_total = 0.0
    skew_wait_positive = []
    tiling_violations = 0
    for job in raw.list("tpujobs", "default"):
        name = job["metadata"]["name"]
        snap = ledger.job_snapshot("default", name, now=time_[0])
        if snap is None:
            continue
        wait = snap["phases"][goodput.PHASE_SKEW_WAIT]
        skew_wait_total += wait
        if wait > 0:
            skew_wait_positive.append(name)
        attributed = sum(snap["phases"].values())
        if snap["wall_seconds"] > 0 and (
            abs(attributed - snap["wall_seconds"]) > 0.01 * snap["wall_seconds"]
        ):
            tiling_violations += 1
    fleet = ledger.fleet_snapshot(now=time_[0])

    return {
        "factor": factor,
        "jobs": jobs,
        "seed": seed,
        "workers_per_job": WORKERS_PER_JOB,
        "windows": windows,
        "sim_seconds": round(time_[0] - NOW, 6),
        "slowed_workers": len(slowed),
        "slowed_jobs": len(slowed_per_gang),
        "straggler_jobs": len(straggler_jobs),
        "detected_jobs": len(true_positives),
        "false_positive_jobs": len(false_positives),
        "detection_windows": latencies,
        "detection_windows_max": max(latencies) if latencies else 0,
        "skew_ratio_mean": round(skew_mean, 6),
        "skew_abs_error_mean": round(skew_err, 6),
        "skew_wait_seconds_total": round(skew_wait_total, 6),
        "skew_wait_positive_jobs": len(skew_wait_positive),
        "skew_wait_only_in_straggler_jobs": (
            set(skew_wait_positive) <= straggler_jobs
        ),
        "phase_tiling_violations": tiling_violations,
        "wall_seconds_total": fleet["wall_seconds"],
        "phase_seconds": fleet["phase_seconds"],
        "phase_shares": fleet["phase_shares"],
    }


# ----------------------------------------------------------------------
# Artifact schema
# ----------------------------------------------------------------------

_RESULT_KEYS = {
    "factor": float,
    "jobs": int,
    "seed": int,
    "workers_per_job": int,
    "windows": int,
    "sim_seconds": float,
    "slowed_workers": int,
    "slowed_jobs": int,
    "straggler_jobs": int,
    "detected_jobs": int,
    "false_positive_jobs": int,
    "detection_windows": list,
    "detection_windows_max": int,
    "skew_ratio_mean": float,
    "skew_abs_error_mean": float,
    "skew_wait_seconds_total": float,
    "skew_wait_positive_jobs": int,
    "skew_wait_only_in_straggler_jobs": bool,
    "phase_tiling_violations": int,
    "wall_seconds_total": float,
    "phase_seconds": dict,
    "phase_shares": dict,
}


def check_schema(doc: dict) -> None:
    """Schema gate for BENCH_STRAGGLER_torch.json; raises ValueError with a
    path-qualified message on the first violation.  Beyond shape it
    enforces the observatory's invariants: the goodput phase vocabulary
    stays closed (skew_wait included), per-phase seconds tile the fleet
    wall clock within 1%, and the factor-1.0 control arm carved zero
    skew_wait."""
    if doc.get("schema_version") != SCHEMA_VERSION:
        raise ValueError(
            f"schema_version: expected {SCHEMA_VERSION}, "
            f"got {doc.get('schema_version')!r}"
        )
    if doc.get("benchmark") != "straggler":
        raise ValueError(f"benchmark: got {doc.get('benchmark')!r}")
    results = doc.get("results")
    if not isinstance(results, list) or not results:
        raise ValueError("results: expected a non-empty list")
    vocabulary = set(goodput.GOODPUT_PHASES)
    if goodput.PHASE_SKEW_WAIT not in vocabulary:  # pragma: no cover
        raise ValueError("goodput vocabulary lost the skew_wait phase")
    for i, res in enumerate(results):
        where = f"results[{i}]"
        for key, type_ in _RESULT_KEYS.items():
            if key not in res:
                raise ValueError(f"{where}.{key}: missing")
            value = res[key]
            if type_ is float and isinstance(value, int):
                value = float(value)
            if not isinstance(value, type_):
                raise ValueError(
                    f"{where}.{key}: expected {type_.__name__}, "
                    f"got {type(res[key]).__name__}"
                )
        for field in ("phase_seconds", "phase_shares"):
            if set(res[field]) != vocabulary:
                raise ValueError(
                    f"{where}.{field}: phase keys {sorted(res[field])} != "
                    f"goodput vocabulary {sorted(vocabulary)}"
                )
        wall = res["wall_seconds_total"]
        attributed = sum(res["phase_seconds"].values())
        if wall > 0 and abs(attributed - wall) > 0.01 * wall:
            raise ValueError(
                f"{where}.phase_seconds: sum {attributed:.6f} deviates "
                f">1% from wall_seconds_total {wall:.6f}"
            )
        if res["factor"] <= 1.0 and res["skew_wait_seconds_total"] > 0:
            raise ValueError(
                f"{where}.skew_wait_seconds_total: control arm carved "
                f"{res['skew_wait_seconds_total']}s of skew_wait"
            )


def build_doc(
    factors: list[float], jobs: int, seed: int, windows: int
) -> dict:
    results = []
    for factor in factors:
        result = run_factor(factor, jobs, seed, windows)
        log(
            f"factor {factor}: detected {result['detected_jobs']}/"
            f"{result['straggler_jobs']} straggler gang(s) in <= "
            f"{result['detection_windows_max']} window(s), "
            f"{result['false_positive_jobs']} false positive(s), "
            f"skew {result['skew_ratio_mean']:.3f} "
            f"(err {result['skew_abs_error_mean']:.3f})"
        )
        results.append(result)
    return {
        "benchmark": "straggler",
        "schema_version": SCHEMA_VERSION,
        "jobs": jobs,
        "seed": seed,
        "factors": list(factors),
        "detector": {
            "skew_threshold": stepstats.DEFAULT_SKEW_THRESHOLD,
            "consecutive_windows": stepstats.DEFAULT_CONSECUTIVE_WINDOWS,
        },
        "results": results,
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="bench-straggler",
        description="straggler-detection benchmark (memory backend)",
    )
    p.add_argument("--jobs", type=int, default=8)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--windows", type=int, default=8,
                   help="heartbeat windows to drive per factor")
    p.add_argument("--factors", default=",".join(str(f) for f in FACTORS),
                   help="comma-separated slowdown factors (e.g. 1.0,2.0,4.0)")
    p.add_argument("--lock-trace", action="store_true",
                   help="arm the lock-order race detector; any inversion "
                        "fails the bench")
    p.add_argument("--out", default="BENCH_STRAGGLER_torch.json")
    args = p.parse_args(argv)

    logutil.configure(level=logutil.parse_level("warning"))
    if args.lock_trace and not locktrace.enabled():
        locktrace.enable()
    factors = [float(f) for f in args.factors.split(",") if f.strip()]
    doc = build_doc(factors, args.jobs, args.seed, args.windows)
    check_schema(doc)
    with open(args.out, "w") as f:
        json.dump(doc, f, indent=2, sort_keys=True)
        f.write("\n")
    log(f"wrote {args.out}")

    by_factor = {r["factor"]: r for r in doc["results"]}
    degraded = [r for r in doc["results"] if r["factor"] > 1.0]
    print(json.dumps({
        "metric": "straggler_detection_windows",
        "value": max(
            (r["detection_windows_max"] for r in degraded), default=0
        ),
        "unit": (
            f"windows to Straggling at factor "
            f"{degraded[-1]['factor'] if degraded else 0} "
            f"({doc['jobs']} jobs, seed {doc['seed']})"
        ),
        "false_positives": sum(
            r["false_positive_jobs"] for r in doc["results"]
        ),
        "skew_abs_error_mean": (
            degraded[-1]["skew_abs_error_mean"] if degraded else 0.0
        ),
    }))

    ok = True
    budget = stepstats.DEFAULT_CONSECUTIVE_WINDOWS
    for res in degraded:
        if res["straggler_jobs"] and res["detected_jobs"] < res["straggler_jobs"]:
            log(f"FAIL: factor {res['factor']}: detected "
                f"{res['detected_jobs']}/{res['straggler_jobs']} gangs")
            ok = False
        if res["detection_windows_max"] > budget:
            log(f"FAIL: factor {res['factor']}: detection took "
                f"{res['detection_windows_max']} windows (> {budget})")
            ok = False
        if not res["skew_wait_only_in_straggler_jobs"]:
            log(f"FAIL: factor {res['factor']}: skew_wait carved for a "
                f"gang with no slowed worker")
            ok = False
    for res in doc["results"]:
        if res["false_positive_jobs"]:
            log(f"FAIL: factor {res['factor']}: "
                f"{res['false_positive_jobs']} false positive(s)")
            ok = False
        if res["phase_tiling_violations"]:
            log(f"FAIL: factor {res['factor']}: "
                f"{res['phase_tiling_violations']} job(s) whose phases "
                f"no longer tile their wall clock")
            ok = False
    control = by_factor.get(1.0)
    if control is not None and control["skew_wait_seconds_total"] > 0:
        log("FAIL: control arm accrued skew_wait")
        ok = False

    if args.lock_trace:
        tracer = locktrace.tracer()
        report = tracer.report() if tracer is not None else {"inversions": []}
        if report["inversions"]:
            for inv in report["inversions"]:
                log(f"FAIL: lock inversion {inv['forward']} vs "
                    f"{inv['reverse']}")
            ok = False
        else:
            log(f"lock-trace: {report.get('acquisitions', 0)} acquisitions, "
                f"0 inversions")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
