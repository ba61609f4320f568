"""Control-plane performance observatory: fleet-scale reconcile benchmark.

``cmd.train`` answers "how fast does a training step run"; this harness
answers "how fast does the *operator* run" — and, via the phase profiler
(utils/profiling.py), *where* the time goes.  It spins up the full
memory-backend stack (InMemoryAPIServer + informers + QueueManager +
GangScheduler + TPUJobController + a deterministic kubelet sim) and
drives a storm of N queue-admitted, gang-scheduled TPUJobs to terminal
state, measuring:

- jobs/sec to converged (every job Succeeded/Failed, wall clock);
- reconcile p50/p99 plus per-phase time shares (cache reads, render,
  apiserver writes, status updates, scheduler snapshot/reserve/bind,
  queue admission) summing to ~100% of reconcile time;
- watch-to-reconcile propagation latency (apiserver emission ->
  informer delivery -> controller dequeue), p50/p99 per stage;
- watch-event fan-out: events delivered per apiserver write;
- workqueue depth/retry curves and longest-running-processor;
- per-pass cache-scan counts (what the informer indexes saved).

Determinism: control logic runs on a simulated clock (the
chaos soak's harness idiom) and every random choice comes from
one ``random.Random(seed)``, so the same seed reproduces the same job
outcomes; only the wall-clock *timings* vary run to run.  ``--chaos``
wraps the apiserver in the ChaosEngine so the profile includes
conflict-retry and watch-delay behavior.

The port's copy of the root ``bench_controlplane.py``, run on the
port's control plane. Its gang is ``h100-4``: four worker pods, one GPU
each, on one 4-GPU node a concurrent job (inventory ``h100-4:<n>``,
quota ``h100=<4n>`` GPUs), mirroring the JAX bench's one four-host
``v5e-16`` slice a job, so the same seed gives the same outcomes,
rounds and depth curves (and, under ``--chaos``, the same fault
counts). Only the node inventory differs: one node a job where the
slice has four hosts, so the scheduler's node scans are a quarter of
JAX's and registering the inventory takes three fewer apiserver writes
a concurrent job. It imports neither torch nor JAX: a process of the control
plane, it touches no device.

Run:  python -m mpi_operator_tpu_torch.cmd.bench_controlplane \
          --jobs 1000 --seed 42
      python -m mpi_operator_tpu_torch.cmd.bench_controlplane \
          --jobs 1000,5000,10000 --chaos
Emits BENCH_CONTROLPLANE_torch.json (schema-checked) and prints one
JSON summary line.
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
from mpi_operator_tpu_torch.api.v2beta1.types import SchedulingPolicy
from mpi_operator_tpu_torch.controller.tpu_job_controller import TPUJobController
from mpi_operator_tpu_torch.queue import QueueManager, bootstrap_queues
from mpi_operator_tpu_torch.runtime import locktrace, retry
from mpi_operator_tpu_torch.runtime.apiserver import ApiError, InMemoryAPIServer
from mpi_operator_tpu_torch.scheduler import (
    DEFAULT_SCHEDULER_NAME,
    GangScheduler,
    register_nodes,
)
from mpi_operator_tpu_torch.utils import metrics, profiling, statemetrics
from mpi_operator_tpu_torch.utils import logging as logutil

TEMPLATE = {"spec": {"containers": [{"name": "main", "image": "gpu-image"}]}}
NOW = 1000.0
BENCH_QUEUE = "bench-q"
# h100-4 = 4 GPUs, one a worker pod = a 4-worker gang per job.
WORKERS_PER_JOB = 4
CHIPS_PER_JOB = 4
# Priority-class mix (scheduler/core.py DEFAULT_PRIORITIES plus the
# unclassed default), weighted toward plain jobs like a real fleet.
PRIORITY_MIX = ("", "", "", "", "high-priority", "low-priority")

SCHEMA_VERSION = 1


def log(*args):
    print(*args, file=sys.stderr, flush=True)


class BenchRunner:
    """The chaos soak's FakeRunner, generalized: the gang size comes
    from the worker pods' world-size annotation instead of a constant,
    so one runner serves any mix of job shapes.  Owns only pod *phase*:
    a bound Pending pod goes Running; a gang fully Running for
    ``RUN_TICKS`` consecutive ticks succeeds atomically."""

    RUN_TICKS = 3

    def __init__(self, api: InMemoryAPIServer):
        self.api = api
        self._gang_age: dict[str, int] = {}

    def tick(self) -> None:
        for pod in self.api.list("pods"):
            status = pod.get("status") or {}
            if (status.get("phase") or "Pending") == "Pending" and (
                pod.get("spec") or {}
            ).get("nodeName"):
                pod["status"] = {"phase": "Running"}
                self.api.update_status("pods", pod)
        gangs: dict[str, list[dict]] = {}
        for pod in self.api.list("pods"):
            name = ((pod.get("metadata") or {}).get("labels") or {}).get(
                constants.JOB_NAME_LABEL
            )
            if name:
                gangs.setdefault(name, []).append(pod)
        for name in sorted(gangs):
            members = gangs[name]
            world = 0
            for pod in members:
                stamp = (
                    (pod.get("metadata") or {}).get("annotations") or {}
                ).get(constants.WORLD_SIZE_ANNOTATION)
                if stamp:
                    world = int(stamp)
                    break
            phases = [(p.get("status") or {}).get("phase") for p in members]
            if world and len(members) == world and all(
                ph == "Running" for ph in phases
            ):
                age = self._gang_age.get(name, 0) + 1
                self._gang_age[name] = age
                if age >= self.RUN_TICKS:
                    for pod in members:
                        pod["status"] = {
                            "phase": "Succeeded",
                            "containerStatuses": [{
                                "name": "main",
                                "state": {"terminated": {"exitCode": 0}},
                            }],
                        }
                        self.api.update_status("pods", pod)
            elif not all(ph == "Succeeded" for ph in phases):
                self._gang_age[name] = 0


def bench_job(name: str, priority_class: str) -> TPUJob:
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
    # "All" bounds live pods at the admitted-concurrency working set:
    # a finished job's workers are deleted, so 10k jobs never means
    # 40k live pod objects.
    job.spec.run_policy.clean_pod_policy = "All"
    job.spec.run_policy.scheduling_policy = SchedulingPolicy(
        queue=BENCH_QUEUE, priority_class=priority_class
    )
    return job


def bench_chaos_policy(seed: int) -> chaos.ChaosPolicy:
    """Moderate, convergence-safe fault rates: transient write faults
    plus delayed watches — enough to light up the conflict-retry and
    propagation-latency paths without killing pods."""
    return chaos.ChaosPolicy(
        seed=seed,
        verbs=(chaos.VerbFaults(
            conflict_rate=0.05, server_error_rate=0.03, timeout_rate=0.01
        ),),
        watch=chaos.WatchFaults(delay_rate=0.05, delay_rounds=2),
    )


def _downsample(curve: list, points: int = 120) -> list:
    if len(curve) <= points:
        return curve
    step = len(curve) / points
    return [curve[int(i * step)] for i in range(points)]


def run_scale(
    jobs: int,
    seed: int,
    with_chaos: bool = False,
    max_rounds: int = 0,
    lock_trace: bool = False,
) -> dict:
    """Drive ``jobs`` TPUJobs to terminal state; return the per-scale
    result block of the BENCH_CONTROLPLANE_torch.json artifact."""
    # Admitted concurrency: quota and slice inventory both sized to it,
    # so admission waves, scheduling pressure, and the live-pod working
    # set all scale sublinearly with the storm size.
    concurrency = min(64, max(8, jobs // 16))
    rng = random.Random(seed)

    # The tracer must be armed before the stack below is built: locks
    # created while tracing is off stay plain forever.
    tracer = None
    if lock_trace:
        tracer = locktrace.enable(locktrace.LockTracer(capture_stacks=False))

    time_ = [NOW]
    clock = lambda: time_[0]  # noqa: E731
    raw = InMemoryAPIServer(clock=clock)
    registry = metrics.Registry()
    profiler = profiling.profiler_for(registry)
    engine = None
    api = raw
    if with_chaos:
        engine = chaos.ChaosEngine(bench_chaos_policy(seed))
        api = chaos.ChaoticAPIServer(raw, engine)

    # Fixtures go through the RAW server (not the system under test).
    register_nodes(raw, f"h100-4:{concurrency}")
    bootstrap_queues(
        raw, [f"{BENCH_QUEUE}:h100={CHIPS_PER_JOB * concurrency}"],
        namespace="default",
    )

    controller = TPUJobController(
        api, gang_scheduler_name=DEFAULT_SCHEDULER_NAME,
        registry=registry, clock=clock,
    )
    manager = QueueManager(api, registry=registry, clock=clock)
    # Shared registry => shared profiler: scheduler phases land in the
    # same snapshot (metric names are disjoint, so no collisions).
    scheduler = GangScheduler(
        api, registry=registry, clock=clock, gang_wait_timeout=1e9
    )
    runner = BenchRunner(raw)

    # Simulated clocks everywhere control logic reads time (the chaos
    # soak idiom), including the workqueues' delayed-retry heaps, so a
    # rate-limited requeue promotes on the next round tick — not after a
    # wall-clock delay — and the drive loop is seed-deterministic.
    for factory in (controller.factory, manager.factory):
        factory.set_resync_interval(4.0)
        for informer in factory._informers.values():
            informer._clock = clock
    controller.queue._clock = clock
    manager.queue._clock = clock
    controller.start()
    manager.start()

    # Name-shuffled creation order + priority mix: admission is
    # priority-then-FIFO, so the storm must not arrive pre-sorted.
    names = [f"bench-{i:05d}" for i in range(jobs)]
    rng.shuffle(names)
    log(f"creating {jobs} TPUJobs ({WORKERS_PER_JOB}-worker h100-4 "
        f"gangs, concurrency {concurrency})...")
    wall0 = time.perf_counter()
    for name in names:
        raw.create(
            "tpujobs", bench_job(name, rng.choice(PRIORITY_MIX)).to_dict()
        )

    def pump():
        for _ in range(10):
            if controller.factory.pump_all() + manager.factory.pump_all() == 0:
                return

    def drain_controller_queue():
        # process_next_work_item semantics, non-blocking: rate-limited
        # requeue on error, forget on success.
        for _ in range(jobs * 4 + 100):
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

    # Collapse conflict-retry backoff wall time for the run (restored
    # after): delay *values* still come from the same code path.
    real_sleep = retry.sleep
    retry.sleep = lambda s: None

    if max_rounds <= 0:
        # ~concurrency jobs finish per admission wave; each wave needs
        # admit + schedule + RUN_TICKS + teardown rounds.  Padded 2x.
        waves = (jobs + concurrency - 1) // concurrency
        max_rounds = 40 + 16 * waves

    depth_curve: list[int] = []
    retries_curve: list[float] = []
    rounds_used = None
    try:
        for rnd in range(max_rounds):
            time_[0] += 1.0
            pump()
            try:
                manager.sync_handler("bench-tick")
            except ApiError:
                pass  # injected fault; next round retries
            pump()
            drain_controller_queue()
            pump()
            try:
                scheduler.schedule_once()
            except ApiError:
                pass
            runner.tick()
            depth_curve.append(
                len(controller.queue) + controller.queue.pending_delayed()
            )
            retries_curve.append(controller.queue.stats().get(
                "retries_total", 0.0
            ))
            done = (controller.jobs_successful.value()
                    + controller.jobs_failed.value())
            if done >= jobs:
                rounds_used = rnd + 1
                break
    finally:
        retry.sleep = real_sleep
        scheduler.stop()
        # Disarm the global switch; locks already created keep reporting
        # to this tracer, so the settling sweep below is still traced.
        if tracer is not None:
            locktrace.disable()

    # Settling sweep: the manager observes the last finishes and
    # releases their quota charges.
    pump()
    try:
        manager.sync_handler("bench-final")
    except ApiError:
        manager.sync_handler("bench-final-retry")
    wall = time.perf_counter() - wall0

    # Ground-truth outcomes from the apiserver, not the counters.
    outcomes: dict[str, int] = {}
    for job in raw.list("tpujobs", "default"):
        phase = statemetrics.job_phase(job)
        outcomes[phase] = outcomes.get(phase, 0) + 1
    converged = (
        rounds_used is not None
        and sum(outcomes.get(p, 0) for p in ("Succeeded", "Failed")) == jobs
    )

    snap = profiler.snapshot()
    writes = len(raw.actions)
    delivered = profiler.watch_propagation.sample_count(
        profiling.STAGE_DELIVERED
    )
    result = {
        "jobs": jobs,
        "seed": seed,
        "chaos": with_chaos,
        "concurrency": concurrency,
        "converged": converged,
        "rounds": rounds_used,
        "wall_seconds": round(wall, 3),
        "jobs_per_second_to_converged": (
            round(jobs / wall, 2) if converged and wall > 0 else 0.0
        ),
        "outcomes": outcomes,
        "reconcile": {
            "passes": snap["reconcile"]["passes"],
            "seconds": round(snap["reconcile"]["seconds"], 6),
            "p50_seconds": round(profiling.histogram_quantile(
                controller.sync_duration, 0.50, "success"
            ), 6),
            "p99_seconds": round(profiling.histogram_quantile(
                controller.sync_duration, 0.99, "success"
            ), 6),
        },
        "reconcile_phase_shares": {
            name: round(share, 4)
            for name, share in snap["reconcile_phase_shares"].items()
        },
        "phases": snap["phases"],
        "watch_propagation": snap["watch_propagation"],
        "cache_scans": snap["cache_scans"],
        "watch_fanout": {
            "apiserver_writes": writes,
            "events_delivered": delivered,
            "events_per_write": (
                round(delivered / writes, 3) if writes else 0.0
            ),
        },
        "workqueue": {
            "controller": {
                **controller.queue.stats(),
                "peak_depth": max(depth_curve, default=0),
                "depth_curve": _downsample(depth_curve),
                "retries_curve": _downsample(retries_curve),
            },
            "queue_manager": manager.queue.stats(),
        },
    }
    if engine is not None:
        fault_counts: dict[str, int] = {}
        for kind, _, _ in engine.timeline():
            fault_counts[kind] = fault_counts.get(kind, 0) + 1
        result["fault_counts"] = fault_counts
    if tracer is not None:
        trace_report = tracer.report()
        result["lock_trace"] = trace_report
        log(
            f"lock-trace: {trace_report['acquisitions']} acquisitions "
            f"across {len(trace_report['locks'])} locks, "
            f"{len(trace_report['inversions'])} inversion(s), "
            f"{len(trace_report['long_holds'])} long hold(s)"
        )
    return result


# ----------------------------------------------------------------------
# Artifact schema
# ----------------------------------------------------------------------

_RESULT_KEYS = {
    "jobs": int,
    "seed": int,
    "chaos": bool,
    "converged": bool,
    "wall_seconds": float,
    "jobs_per_second_to_converged": float,
    "outcomes": dict,
    "reconcile": dict,
    "reconcile_phase_shares": dict,
    "phases": dict,
    "watch_propagation": dict,
    "cache_scans": dict,
    "watch_fanout": dict,
    "workqueue": dict,
}


def check_schema(doc: dict) -> None:
    """Schema gate for BENCH_CONTROLPLANE_torch.json; raises ValueError with a
    path-qualified message on the first violation."""
    if doc.get("schema_version") != SCHEMA_VERSION:
        raise ValueError(
            f"schema_version: expected {SCHEMA_VERSION}, "
            f"got {doc.get('schema_version')!r}"
        )
    if doc.get("benchmark") != "controlplane":
        raise ValueError(f"benchmark: got {doc.get('benchmark')!r}")
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
        for key in ("passes", "p50_seconds", "p99_seconds"):
            if key not in res["reconcile"]:
                raise ValueError(f"{where}.reconcile.{key}: missing")
        shares = res["reconcile_phase_shares"]
        unknown = set(shares) - set(profiling.RECONCILE_PHASES) - {
            profiling.UNATTRIBUTED
        }
        if unknown:
            raise ValueError(
                f"{where}.reconcile_phase_shares: unknown phases {unknown}"
            )
        total = sum(shares.values())
        if shares and not 0.95 <= total <= 1.05:
            raise ValueError(
                f"{where}.reconcile_phase_shares: shares sum to "
                f"{total:.4f}, expected ~1.0"
            )
        for scope, scan in res["cache_scans"].items():
            for key in ("passes", "objects", "objects_per_pass"):
                if key not in scan:
                    raise ValueError(
                        f"{where}.cache_scans.{scope}.{key}: missing"
                    )
        fanout = res["watch_fanout"]
        for key in ("apiserver_writes", "events_delivered",
                    "events_per_write"):
            if key not in fanout:
                raise ValueError(f"{where}.watch_fanout.{key}: missing")
        # Optional: present only when the run was driven with --lock-trace.
        if "lock_trace" in res:
            trace = res["lock_trace"]
            for key in ("acquisitions", "locks", "inversions", "long_holds"):
                if key not in trace:
                    raise ValueError(f"{where}.lock_trace.{key}: missing")


def build_doc(scales: list[int], seed: int, with_chaos: bool,
              max_rounds: int = 0, lock_trace: bool = False) -> dict:
    results = []
    for jobs in scales:
        result = run_scale(
            jobs, seed, with_chaos=with_chaos, max_rounds=max_rounds,
            lock_trace=lock_trace,
        )
        log(
            f"{jobs} jobs: converged={result['converged']} in "
            f"{result['wall_seconds']}s "
            f"({result['jobs_per_second_to_converged']} jobs/s), "
            f"reconcile p99 {result['reconcile']['p99_seconds'] * 1e3:.2f} ms, "
            f"fan-out {result['watch_fanout']['events_per_write']} "
            f"events/write"
        )
        results.append(result)
    return {
        "benchmark": "controlplane",
        "schema_version": SCHEMA_VERSION,
        "seed": seed,
        "chaos": with_chaos,
        "results": results,
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="bench-controlplane",
        description="fleet-scale control-plane benchmark (memory backend)",
    )
    p.add_argument("--jobs", default="1000",
                   help="comma-separated storm sizes (e.g. 1000,5000,10000)")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--chaos", action="store_true",
                   help="wrap the apiserver in the seeded ChaosEngine")
    p.add_argument("--max-rounds", type=int, default=0,
                   help="round budget per scale (0 = auto from storm size)")
    p.add_argument("--lock-trace", action="store_true",
                   help="arm the runtime lock-order tracer "
                        "(runtime/locktrace.py) and attach its report to "
                        "each result block")
    p.add_argument("--out", default="BENCH_CONTROLPLANE_torch.json")
    args = p.parse_args(argv)

    # A 10k-job storm at info level prints one line per condition flip;
    # the bench's own stderr narration is the signal here.
    logutil.configure(level=logutil.parse_level("warning"))
    scales = [int(s) for s in args.jobs.split(",") if s.strip()]
    doc = build_doc(scales, args.seed, args.chaos, args.max_rounds,
                    lock_trace=args.lock_trace)
    check_schema(doc)
    with open(args.out, "w") as f:
        json.dump(doc, f, indent=2, sort_keys=True)
        f.write("\n")
    log(f"wrote {args.out}")

    head = doc["results"][-1]
    print(json.dumps({
        "metric": "controlplane_jobs_per_sec_to_converged",
        "value": head["jobs_per_second_to_converged"],
        "unit": f"jobs/sec (storm of {head['jobs']}, seed {head['seed']})",
        "reconcile_p99_ms": round(
            head["reconcile"]["p99_seconds"] * 1e3, 3
        ),
        "watch_to_reconcile_p99_ms": round(
            head["watch_propagation"].get("reconcile", {}).get(
                "p99_seconds", 0.0
            ) * 1e3, 3
        ),
    }))
    return 0 if all(r["converged"] for r in doc["results"]) else 1


if __name__ == "__main__":
    sys.exit(main())
