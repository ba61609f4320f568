"""Device-memory observatory benchmark: how early the HBM watermark
trend flags a leaking gang, with zero false alarms on a healthy fleet.

``bench_straggler`` grades the *time* dimension of gang health; this
harness grades the *memory* dimension — a worker whose HBM footprint
grows every window until the allocator OOM-kills the gang.  It drives N
TPUJob gangs on a simulated clock, injects ``MemoryLeak`` chaos
(chaos/policy.py) through the same ``LeakInjector`` → ``leak_worker``
surface production uses, and feeds each worker's per-window HBM samples
(the real ``DeviceMemorySampler`` with the deterministic fake backend)
through the kube-native path: device-memory annotation → pod informer →
``MemoryMatrix`` (utils/devstats.py) → ``MemoryPressure`` condition.

Per arm (control = no leak, leak = fixed bytes/window) it reports:

- **detection lead** — closed windows between the ``MemoryPressure``
  condition first flipping True and the injected exhaustion (reported
  bytes-in-use crossing the HBM limit); the acceptance gate is lead >=
  the detector's ``pressure_horizon_windows``, i.e. the operator gets
  the whole checkpoint-and-resize budget it promises;
- **false-positive rate** — jobs flagged ``MemoryPressure`` that had no
  leaking worker (must be zero, including the whole control arm, whose
  fake backend carries a trendless allocator ripple);
- **watermark fidelity** — fleet peak bytes and final headroom as the
  matrix joined them.

Determinism: control logic runs on the simulated clock, chaos victims
come from one seeded RNG, and the fake backend is a pure function of the
window index — so the same seed reproduces the document
bit-for-bit.

The port's copy of the root ``bench_memory.py``, run on the port's
control plane. Its gang is ``h100-4``: four worker pods, one GPU each,
mirroring the JAX bench's four-host ``v5e-16`` slice member for member,
so the same arguments write the same document byte for byte (the
committed ``BENCH_MEMORY.json`` at ``--jobs 8 --seed 42``). It imports
neither torch nor JAX: a process of the control plane, it touches no
device.

Run:  python -m mpi_operator_tpu_torch.cmd.bench_memory --jobs 8 --seed 42
      python -m mpi_operator_tpu_torch.cmd.bench_memory \
          --leak-bytes 1073741824 --lock-trace
Emits BENCH_MEMORY_torch.json (schema-checked) and prints one JSON
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
from mpi_operator_tpu_torch.api.v2beta1.types import JOB_MEMORY_PRESSURE
from mpi_operator_tpu_torch.controller.tpu_job_controller import TPUJobController
from mpi_operator_tpu_torch.runtime import locktrace, retry
from mpi_operator_tpu_torch.runtime.apiserver import ApiError, InMemoryAPIServer
from mpi_operator_tpu_torch.utils import devstats, flightrecorder, metrics
from mpi_operator_tpu_torch.utils import logging as logutil

TEMPLATE = {"spec": {"containers": [{"name": "main", "image": "gpu-image"}]}}
NOW = 1000.0
# h100-4 = 4 GPUs, one a worker pod = a 4-worker gang per job.
WORKERS_PER_JOB = 4
# Sim seconds per heartbeat-window round.
ROUND_S = 2.5
# Allocator-churn ripple on the fake backend: visible, trendless — the
# control arm's false-positive bait.
RIPPLE_BYTES = 32 * 1024**2
# Default injected leak: 480 MiB/window against the fake backend's
# 12 GiB of free HBM => exhaustion at window 25, detection expected
# pressure_horizon_windows earlier.
LEAK_BYTES = 480 * 1024**2

SCHEMA_VERSION = 1


def log(*args):
    print(*args, file=sys.stderr, flush=True)


class MemoryRunner:
    """The bench's kubelet sim: flips created pods Running (recording
    flight-recorder POD entries, as LocalPodRunner does), exposes the
    ``leak_worker`` surface ``LeakInjector`` drives, and emits each
    worker's per-window HBM sample — produced by the *real*
    ``DeviceMemorySampler`` over the deterministic fake backend — as pod
    annotation patches, exactly the transport the live runner tails out
    of pod logs."""

    def __init__(
        self,
        api: InMemoryAPIServer,
        recorder: flightrecorder.FlightRecorder,
    ):
        self.api = api
        self.recorder = recorder
        # (namespace, pod-name) -> that worker's sampler; leak_worker
        # swaps in a leaking sampler, modelling the env-injected restart.
        self._samplers: dict[tuple[str, str], devstats.DeviceMemorySampler] = {}
        self._window: dict[tuple[str, str], int] = {}
        # job-name -> first window its reported bytes-in-use crossed the
        # HBM limit (the injected exhaustion the detector must beat).
        self.exhausted_at: dict[str, int] = {}

    def _sampler(self, leak: int = 0) -> devstats.DeviceMemorySampler:
        return devstats.DeviceMemorySampler(
            backend=devstats.FakeMemoryBackend(ripple_bytes=RIPPLE_BYTES),
            leak_bytes_per_window=leak,
        )

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

    # -- LeakInjector surface -------------------------------------------

    def leak_worker(
        self, namespace: str, name: str, bytes_per_window: int
    ) -> bool:
        if bytes_per_window <= 0:
            return False
        try:
            self.api.get("pods", namespace, name)
        except ApiError:
            return False
        self._samplers[(namespace, name)] = self._sampler(bytes_per_window)
        return True

    # -- sample emission -------------------------------------------------

    def emit_window(self) -> int:
        """One device-memory window for every running worker: the
        worker's sampler (leaking or not) produces the record, which
        lands as the pod's device-memory annotation (the informer
        delivers it to the MemoryMatrix from there)."""
        emitted = 0
        for pod in sorted(
            self.api.list("pods"),
            key=lambda p: (p.get("metadata") or {}).get("name", ""),
        ):
            meta = pod.get("metadata") or {}
            if (pod.get("status") or {}).get("phase") != "Running":
                continue
            key = (meta.get("namespace", ""), meta.get("name", ""))
            window = self._window.get(key, 0)
            sampler = self._samplers.get(key)
            if sampler is None:
                sampler = self._samplers[key] = self._sampler()
            record = sampler.sample(window)
            limit = record["hbm_limit_bytes"]
            if limit > 0 and record["hbm_bytes_in_use"] >= limit:
                job_name = (meta.get("labels") or {}).get(
                    constants.JOB_NAME_LABEL
                )
                if job_name:
                    self.exhausted_at.setdefault(job_name, window)
            fresh = self.api.get("pods", key[0], key[1])
            annotations = fresh["metadata"].setdefault("annotations", {})
            annotations[constants.DEVICE_MEMORY_ANNOTATION] = json.dumps(
                record, sort_keys=True
            )
            self.api.update("pods", fresh)
            self._window[key] = window + 1
            emitted += 1
        return emitted


def memory_job(name: str) -> TPUJob:
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


def _pressure_jobs(api: InMemoryAPIServer) -> set:
    flagged = set()
    for job in api.list("tpujobs", "default"):
        for cond in (job.get("status") or {}).get("conditions") or []:
            if (cond.get("type") == JOB_MEMORY_PRESSURE
                    and cond.get("status") == "True"):
                flagged.add(job["metadata"]["name"])
    return flagged


def run_arm(leak_bytes: int, jobs: int, seed: int, windows: int) -> dict:
    """Drive ``jobs`` gangs through ``windows`` device-memory windows
    with MemoryLeak chaos at one bytes/window increment (0 = control
    arm, chaos disarmed); return the per-arm result block of
    BENCH_MEMORY_torch.json.  Same seed => bit-identical block (every number
    derives from sim time, window indices, or the seeded chaos RNG)."""
    random.Random(seed)  # reserved: the arm itself is jitter-free

    time_ = [NOW]
    clock = lambda: time_[0]  # noqa: E731
    raw = InMemoryAPIServer(clock=clock)
    registry = metrics.Registry()
    recorder = flightrecorder.FlightRecorder(
        capacity_per_job=1024, max_jobs=jobs + 8, clock=clock
    )
    matrix = devstats.MemoryMatrix(recorder, registry=registry, clock=clock)
    controller = TPUJobController(
        raw, registry=registry, clock=clock, flight_recorder=recorder,
        memory_matrix=matrix,
    )
    runner = MemoryRunner(raw, recorder)

    # One MemoryLeak victim per gang on average, budgeted to half the
    # fleet so the control population (never-leaked gangs) stays large
    # enough to measure false positives against.
    engine = chaos.ChaosEngine(chaos.ChaosPolicy(
        seed=seed,
        leak=(chaos.MemoryLeakChaos(
            leak_rate=1.0 / WORKERS_PER_JOB,
            bytes_per_window=leak_bytes,
            namespace="default",
            max_leak=max(1, jobs // 2),
        ),) if leak_bytes > 0 else (),
    ))
    injector = chaos.LeakInjector(engine, raw, runner, flight_recorder=recorder)

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
            raw.create("tpujobs", memory_job(f"hbm-{i:04d}").to_dict())

        # Boot: pods created, flipped Running, jobs marked Running.
        for _ in range(4):
            time_[0] += 1.0
            pump()
            drain()
            runner.tick()
            pump()
            drain()

        # Chaos draws its victims once the fleet is up; every later tick
        # is a no-op re-draw against already-leaked or budget-exhausted
        # policies, matching the live soak's pacing loop.
        injector.tick()
        leaked = sorted(
            target.split(" ", 1)[1] for kind, target, _ in engine.timeline()
            if kind == chaos.MEM_LEAK
        )
        leak_jobs = sorted({
            name.split("/", 1)[1].rsplit("-worker-", 1)[0] for name in leaked
        })

        for window in range(windows):
            time_[0] += ROUND_S
            runner.emit_window()
            pump()
            drain()
            for name in _pressure_jobs(raw):
                detected_at.setdefault(name, window)
    finally:
        retry.sleep = real_sleep

    log(f"leak {leak_bytes}B/window: {len(leaked)} leaked worker(s) in "
        f"{len(leak_jobs)} gang(s), {time.perf_counter() - wall0:.2f}s wall")

    flagged_ever = set(detected_at)
    true_positives = flagged_ever & set(leak_jobs)
    false_positives = flagged_ever - set(leak_jobs)
    detections = sorted(detected_at[name] for name in true_positives)
    # Detection lead: windows between the condition flipping True and
    # the injected exhaustion — the checkpoint-and-resize budget the
    # detector actually delivered.
    leads = sorted(
        runner.exhausted_at[name] - detected_at[name]
        for name in true_positives
        if name in runner.exhausted_at
    )

    # Watermark fidelity from the matrix's joined state.
    peak_max = 0
    headroom_min = 1.0
    for name in sorted(set(leak_jobs) or {f"hbm-{i:04d}" for i in range(jobs)}):
        snap = matrix.job_snapshot("default", name)
        if snap is None:
            continue
        peak_max = max(peak_max, snap["hbm_peak_bytes"])
        headroom_min = min(headroom_min, snap["headroom_ratio"])

    return {
        "leak_bytes_per_window": leak_bytes,
        "jobs": jobs,
        "seed": seed,
        "workers_per_job": WORKERS_PER_JOB,
        "windows": windows,
        "sim_seconds": round(time_[0] - NOW, 6),
        "leaked_workers": len(leaked),
        "leaked_jobs": len(leak_jobs),
        "exhausted_jobs": len(runner.exhausted_at),
        "detected_jobs": len(true_positives),
        "false_positive_jobs": len(false_positives),
        "detection_windows": detections,
        "detection_lead_windows": leads,
        "detection_lead_min": min(leads) if leads else 0,
        "hbm_peak_bytes_max": peak_max,
        "headroom_ratio_min": round(headroom_min, 6),
    }


# ----------------------------------------------------------------------
# Artifact schema
# ----------------------------------------------------------------------

_RESULT_KEYS = {
    "leak_bytes_per_window": int,
    "jobs": int,
    "seed": int,
    "workers_per_job": int,
    "windows": int,
    "sim_seconds": float,
    "leaked_workers": int,
    "leaked_jobs": int,
    "exhausted_jobs": int,
    "detected_jobs": int,
    "false_positive_jobs": int,
    "detection_windows": list,
    "detection_lead_windows": list,
    "detection_lead_min": int,
    "hbm_peak_bytes_max": int,
    "headroom_ratio_min": float,
}


def check_schema(doc: dict) -> None:
    """Schema gate for BENCH_MEMORY_torch.json; raises ValueError with a
    path-qualified message on the first violation.  Beyond shape it
    enforces the observatory's invariants: no arm carries false
    positives, the control arm never fires at all, and every leak-arm
    detection leads the injected exhaustion by at least the detector's
    pressure horizon."""
    if doc.get("schema_version") != SCHEMA_VERSION:
        raise ValueError(
            f"schema_version: expected {SCHEMA_VERSION}, "
            f"got {doc.get('schema_version')!r}"
        )
    if doc.get("benchmark") != "memory":
        raise ValueError(f"benchmark: got {doc.get('benchmark')!r}")
    detector = doc.get("detector")
    if not isinstance(detector, dict) or not isinstance(
        detector.get("pressure_horizon_windows"), int
    ):
        raise ValueError("detector.pressure_horizon_windows: missing")
    horizon = detector["pressure_horizon_windows"]
    results = doc.get("results")
    if not isinstance(results, list) or not results:
        raise ValueError("results: expected a non-empty list")
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
        if res["false_positive_jobs"]:
            raise ValueError(
                f"{where}.false_positive_jobs: "
                f"{res['false_positive_jobs']} gang(s) flagged "
                f"MemoryPressure without a leaking worker"
            )
        if res["leak_bytes_per_window"] == 0:
            if res["leaked_workers"] or res["detected_jobs"]:
                raise ValueError(
                    f"{where}: control arm leaked or detected "
                    f"({res['leaked_workers']} worker(s), "
                    f"{res['detected_jobs']} detection(s))"
                )
        elif res["leaked_jobs"]:
            if res["detected_jobs"] < res["leaked_jobs"]:
                raise ValueError(
                    f"{where}.detected_jobs: {res['detected_jobs']}/"
                    f"{res['leaked_jobs']} leaking gang(s) detected"
                )
            if res["detection_lead_min"] < horizon:
                raise ValueError(
                    f"{where}.detection_lead_min: "
                    f"{res['detection_lead_min']} window(s) < pressure "
                    f"horizon {horizon}"
                )


def build_doc(leak_bytes: int, jobs: int, seed: int, windows: int) -> dict:
    results = []
    for arm in (0, leak_bytes):
        result = run_arm(arm, jobs, seed, windows)
        log(
            f"arm leak={arm}: detected {result['detected_jobs']}/"
            f"{result['leaked_jobs']} leaking gang(s), lead >= "
            f"{result['detection_lead_min']} window(s), "
            f"{result['false_positive_jobs']} false positive(s)"
        )
        results.append(result)
    return {
        "benchmark": "memory",
        "schema_version": SCHEMA_VERSION,
        "jobs": jobs,
        "seed": seed,
        "leak_bytes_per_window": leak_bytes,
        "detector": {
            "pressure_horizon_windows":
                devstats.DEFAULT_PRESSURE_HORIZON_WINDOWS,
            "trend_windows": devstats.DEFAULT_TREND_WINDOWS,
            "min_trend_windows": devstats.MIN_TREND_WINDOWS,
        },
        "results": results,
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="bench-memory",
        description="device-memory pressure-detection benchmark",
    )
    p.add_argument("--jobs", type=int, default=8)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--windows", type=int, default=28,
                   help="device-memory windows to drive per arm")
    p.add_argument("--leak-bytes", type=int, default=LEAK_BYTES,
                   help="injected leak increment in bytes/window "
                        "(the control arm always runs leak-free)")
    p.add_argument("--lock-trace", action="store_true",
                   help="arm the lock-order race detector; any inversion "
                        "fails the bench")
    p.add_argument("--out", default="BENCH_MEMORY_torch.json")
    args = p.parse_args(argv)

    logutil.configure(level=logutil.parse_level("warning"))
    if args.lock_trace and not locktrace.enabled():
        locktrace.enable()
    doc = build_doc(args.leak_bytes, args.jobs, args.seed, args.windows)

    ok = True
    try:
        check_schema(doc)
    except ValueError as exc:
        log(f"FAIL: {exc}")
        ok = False
    with open(args.out, "w") as f:
        json.dump(doc, f, indent=2, sort_keys=True)
        f.write("\n")
    log(f"wrote {args.out}")

    leak_arms = [r for r in doc["results"] if r["leak_bytes_per_window"] > 0]
    print(json.dumps({
        "metric": "memory_pressure_lead_windows",
        "value": min(
            (r["detection_lead_min"] for r in leak_arms), default=0
        ),
        "unit": (
            f"windows of warning before HBM exhaustion at "
            f"{args.leak_bytes} B/window leak "
            f"({doc['jobs']} jobs, seed {doc['seed']})"
        ),
        "false_positives": sum(
            r["false_positive_jobs"] for r in doc["results"]
        ),
        "pressure_horizon_windows":
            doc["detector"]["pressure_horizon_windows"],
    }))

    for res in leak_arms:
        if res["leaked_jobs"] and res["exhausted_jobs"] < res["leaked_jobs"]:
            log(f"FAIL: leak arm: only {res['exhausted_jobs']}/"
                f"{res['leaked_jobs']} leaking gang(s) reached exhaustion "
                f"inside {res['windows']} windows — raise --windows")
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
