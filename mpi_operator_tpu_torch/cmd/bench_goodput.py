"""Goodput-under-preemption benchmark: the goodput-vs-kill-rate curve.

``bench_controlplane`` measures how fast the operator reconciles;
this harness measures what the *jobs* get out of it — the fraction of
each TPUJob's wall clock that was productive gang-running time, and
where the rest went (queue wait, scheduling, pod startup, rendezvous,
checkpointing, restart downtime), as attributed by the goodput ledger
(utils/goodput.py) from flight-recorder timelines.

It drives N queue-admitted, gang-scheduled TPUJobs to terminal state on
a simulated clock, per chaos kill rate r (the ``PodKiller`` with
the preemption signature: SIGKILL 137 and node loss) and per
resilience arm:

- ``sync``       — synchronous checkpointing (every save blocks the
                   step path for the full write) and no standby
                   capacity: a preempted worker re-runs the whole
                   schedule→pending→bootstrap pipeline.
- ``resilient``  — the resilience stack: async checkpointing (the step path
                   pays only a host snapshot; a background write
                   publishes the commit marker later) plus
                   ``spec.tpu.hotSpares: 1`` standby workers the
                   controller promotes into a dead worker's seat, so
                   restart downtime collapses to rejoin time.

Both arms run with an ``Ignore`` podFailurePolicy so preemptions never
charge backoffLimit, and on clusters of identical capacity (the
baseline arm simply leaves the standby headroom idle).  Per (arm, rate)
the artifact reports fleet goodput, per-phase wall seconds/shares,
spare promotions, and the per-job per-phase *loss* versus that arm's
r=0 baseline — the curve the preemption papers (arxiv 1909.09756) draw
from real fleets.  A ``checkpoint_scaling`` block re-runs the r=0
fleet at two save frequencies per mode, demonstrating that sync
checkpoint seconds scale with save frequency while async seconds do
not (the write pipeline, not the save cadence, bounds them).

Determinism: control logic runs on the simulated clock and every random
choice comes from one ``random.Random(seed)`` (chaos draws from the
seeded ChaosEngine), and every reported number derives from the sim
clock — not wall time — so the same seed reproduces the artifact
bit-for-bit.  ``--baseline`` turns that into a regression gate: when
the given file exists, the freshly computed artifact must match it
byte-for-byte.

The port's copy of the root ``bench_goodput.py``, run on the port's
control plane. Its gang is ``h100-4``: four worker pods, one GPU each,
on one 4-GPU node a concurrent job plus the spares' nodes (inventory
``h100-4:<n>``, quota ``h100=<4n>`` GPUs), mirroring the JAX bench's
four-host ``v5e-16`` slices member for member, so the same arguments
write the same document byte for byte. It imports neither torch nor
JAX: a process of the control plane, it touches no device.

Run:  python -m mpi_operator_tpu_torch.cmd.bench_goodput --jobs 100 --seed 42
      python -m mpi_operator_tpu_torch.cmd.bench_goodput \
          --jobs 200 --rates 0,0.1,0.3
      python -m mpi_operator_tpu_torch.cmd.bench_goodput \
          --out BENCH_GOODPUT_torch.json \
          --baseline BENCH_GOODPUT_torch.json   # diff against a kept run
Emits BENCH_GOODPUT_torch.json (schema-checked) and prints one JSON
summary line.
"""

from __future__ import annotations

import argparse
import json
import os
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
from mpi_operator_tpu_torch.api.v2beta1.types import (
    PodFailurePolicy,
    PodFailurePolicyOnExitCodes,
    PodFailurePolicyOnPodCondition,
    PodFailurePolicyRule,
    SchedulingPolicy,
)
from mpi_operator_tpu_torch.controller.tpu_job_controller import TPUJobController
from mpi_operator_tpu_torch.queue import QueueManager, bootstrap_queues
from mpi_operator_tpu_torch.runtime import retry
from mpi_operator_tpu_torch.runtime.apiserver import ApiError, InMemoryAPIServer
from mpi_operator_tpu_torch.scheduler import (
    DEFAULT_SCHEDULER_NAME,
    GangScheduler,
    register_nodes,
)
from mpi_operator_tpu_torch.utils import flightrecorder, goodput, metrics, statemetrics
from mpi_operator_tpu_torch.utils import logging as logutil

TEMPLATE = {"spec": {"containers": [{"name": "main", "image": "gpu-image"}]}}
NOW = 1000.0
BENCH_QUEUE = "goodput-q"
# h100-4 = 4 GPUs, one a worker pod = a 4-worker gang per job.
WORKERS_PER_JOB = 4
CHIPS_PER_JOB = 4
# The acceptance curve: baseline, moderate, heavy preemption pressure.
KILL_RATES = (0.0, 0.1, 0.3)
# The resilience arms: the plain stack vs the resilience stack.
ARMS = ("sync", "resilient")
HOT_SPARES = 1

# Checkpoint cost model (simulated seconds / ticks).  A sync save
# blocks the step path for the full write; an async save blocks it only
# for the host snapshot, then a background writer spends
# ASYNC_WRITE_TICKS off the step path before the commit marker lands —
# and while a write is in flight no new snapshot is taken (the
# one-writer-in-flight rule of utils/checkpoint.py), which is exactly
# why async checkpoint seconds stop scaling with save frequency.
SYNC_WRITE_S = 0.5
ASYNC_SNAPSHOT_S = 0.02
ASYNC_WRITE_TICKS = 2
DEFAULT_SAVE_EVERY = 2

# Per-arm save cadence: the sync arm saves every other step (paying the
# full write every step would be absurd); the resilient arm saves every
# step, because the async step-path cost is a host snapshot — affording
# max-frequency saves is exactly what async checkpointing buys.
ARM_SAVE_EVERY = {"sync": 2, "resilient": 1}

# Cold pod startup: a freshly bound pod spends this many ticks Pending
# (image pull, CUDA runtime init, rendezvous bootstrap) before Running.
# A promoted hot spare's replacement skips it entirely — the standby
# already paid it while parked — which is the whole point of spares.
STARTUP_TICKS = 3

SCHEMA_VERSION = 2


def log(*args):
    print(*args, file=sys.stderr, flush=True)


class GoodputRunner:
    """bench_controlplane.BenchRunner plus the things this bench needs:
    every phase flip lands on the owning job's flight-recorder timeline
    (the ledger's raw input — in production the LocalPodRunner does
    this), the ``kill_pod``/``fail_node`` surface the ``PodKiller``
    drives, and a per-gang checkpoint/rollback model feeding
    ``checkpoint_s`` telemetry into the goodput ledger.  A bound pod
    stays Pending for STARTUP_TICKS ticks before Running — except a
    promoted hot spare's replacement, which was already bootstrapped
    and parked, so it goes Running on first sight (warm rejoin).

    Progress model: a gang advances one tick per round in which every
    worker is Running.  On disruption its progress rolls back to the
    last *committed* save — sync commits at the save tick, async
    commits when the background write finishes — so the redo work after
    a kill is exactly what the checkpoint cadence left unprotected.
    """

    RUN_TICKS = 12

    def __init__(
        self,
        api: InMemoryAPIServer,
        recorder: flightrecorder.FlightRecorder,
        ledger: goodput.GoodputLedger | None = None,
        checkpoint_mode: str = "sync",
        save_every: int = DEFAULT_SAVE_EVERY,
    ):
        if checkpoint_mode not in ("sync", "async"):
            raise ValueError(f"checkpoint_mode: {checkpoint_mode!r}")
        if save_every < 1:
            raise ValueError(f"save_every must be >= 1, got {save_every!r}")
        self.api = api
        self.recorder = recorder
        self.ledger = ledger
        self.checkpoint_mode = checkpoint_mode
        self.save_every = save_every
        self._gang_age: dict[str, int] = {}
        self._saved: dict[str, int] = {}       # last committed step
        self._snap_age: dict[str, int] = {}    # step of the in-flight write
        self._write_left: dict[str, int] = {}  # async write ticks remaining
        self._ckpt_s: dict[str, float] = {}    # cumulative step-path seconds
        self._bound_ticks: dict[tuple[str, str], int] = {}

    def _flip(self, pod: dict, phase: str, reason: str = "",
              message: str = "", exit_code=None) -> None:
        meta = pod.get("metadata") or {}
        status = dict(pod.get("status") or {})
        # This kubelet sim is the run's node agent: it owns pod phase
        # here as runtime/podrunner.py does in a live cluster.
        status["phase"] = phase  # noqa: TPU302
        if reason:
            status["reason"] = reason
        if message:
            status["message"] = message
        if exit_code is not None:
            status["containerStatuses"] = [{
                "name": "main",
                "state": {"terminated": {"exitCode": exit_code}},
            }]
        pod["status"] = status
        self.api.update_status("pods", pod)
        labels = meta.get("labels") or {}
        job_name = labels.get(constants.JOB_NAME_LABEL)
        # Standby pods are held capacity, not gang members: their
        # lifecycle must not perturb the job's phase attribution.
        if job_name and labels.get(
            constants.JOB_ROLE_LABEL
        ) != constants.ROLE_SPARE:
            attrs = {} if exit_code is None else {"exit_code": exit_code}
            self.recorder.record(
                meta.get("namespace", ""), job_name, flightrecorder.POD,
                reason=reason or phase, message=message,
                pod=meta.get("name", ""), phase=phase, **attrs,
            )

    def _checkpoint_tick(self, name: str, age: int) -> None:
        """One productive tick's checkpoint accounting for gang ``name``."""
        if self.checkpoint_mode == "sync":
            if age % self.save_every == 0:
                self._ckpt_s[name] = (
                    self._ckpt_s.get(name, 0.0) + SYNC_WRITE_S
                )
                self._saved[name] = age
            return
        left = self._write_left.get(name, 0)
        if left > 0:
            left -= 1
            self._write_left[name] = left
            if left == 0:
                # Background write finished: the snapshot commits.
                self._saved[name] = self._snap_age.get(name, 0)
        if self._write_left.get(name, 0) == 0 and age % self.save_every == 0:
            self._ckpt_s[name] = (
                self._ckpt_s.get(name, 0.0) + ASYNC_SNAPSHOT_S
            )
            self._snap_age[name] = age
            self._write_left[name] = ASYNC_WRITE_TICKS

    def tick(self) -> None:
        for pod in self.api.list("pods"):
            meta = pod.get("metadata") or {}
            key = (meta.get("namespace", ""), meta.get("name", ""))
            status = pod.get("status") or {}
            phase = status.get("phase") or "Pending"
            if phase == "Pending" and (pod.get("spec") or {}).get("nodeName"):
                annotations = meta.get("annotations") or {}
                if constants.PROMOTED_FROM_ANNOTATION in annotations:
                    # A promoted hot spare's seat: the standby already
                    # paid cold startup while parked, so the replacement
                    # rejoins warm — no staged Pending ticks.
                    self._flip(pod, "Running")
                else:
                    seen = self._bound_ticks.get(key, 0) + 1
                    if seen >= STARTUP_TICKS:
                        self._bound_ticks.pop(key, None)
                        self._flip(pod, "Running")
                    else:
                        self._bound_ticks[key] = seen
            elif phase != "Pending":
                self._bound_ticks.pop(key, None)
        gangs: dict[str, list[dict]] = {}
        for pod in self.api.list("pods"):
            labels = ((pod.get("metadata") or {}).get("labels") or {})
            name = labels.get(constants.JOB_NAME_LABEL)
            # Gang membership is workers only: parked spares carry the
            # job label too but never join the barrier.
            if name and labels.get(
                constants.JOB_ROLE_LABEL
            ) == constants.ROLE_WORKER:
                gangs.setdefault(name, []).append(pod)
        for name in sorted(gangs):
            members = gangs[name]
            namespace = (
                (members[0].get("metadata") or {}).get("namespace", "")
            )
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
                self._checkpoint_tick(name, age)
                if self.ledger is not None:
                    self.ledger.observe_telemetry(namespace, name, {
                        "checkpoint_s": round(
                            self._ckpt_s.get(name, 0.0), 6
                        ),
                    })
                if age >= self.RUN_TICKS:
                    for pod in members:
                        self._flip(pod, "Succeeded", exit_code=0)
            elif not all(ph == "Succeeded" for ph in phases):
                # Disruption: progress rolls back to the last committed
                # save; an in-flight async write dies with the gang.
                self._gang_age[name] = self._saved.get(name, 0)
                self._write_left[name] = 0

    # -- PodKiller surface ----------------------------------------------

    def kill_pod(self, namespace: str, name: str) -> bool:
        """SIGKILL: the preemption signature (exit code 137)."""
        try:
            pod = self.api.get("pods", namespace, name)
        except ApiError:
            return False
        if (pod.get("status") or {}).get("phase") != "Running":
            return False
        self._flip(pod, "Failed", reason="Killed",
                   message="chaos: SIGKILL", exit_code=137)
        return True

    def fail_node(self, namespace: str, name: str) -> bool:
        """Node death: Failed with reason=NodeLost, no exit code."""
        try:
            pod = self.api.get("pods", namespace, name)
        except ApiError:
            return False
        if (pod.get("status") or {}).get("phase") != "Running":
            return False
        self._flip(pod, "Failed", reason="NodeLost",
                   message="chaos: node died")
        return True


def ignore_preemption_rules() -> PodFailurePolicy:
    """Preemptions are not the job's fault: Ignore 137 and node loss so
    chaos kills replace pods without charging backoffLimit."""
    return PodFailurePolicy(rules=[
        PodFailurePolicyRule(
            action="Ignore",
            on_exit_codes=PodFailurePolicyOnExitCodes(
                operator="In", values=[137]
            ),
        ),
        PodFailurePolicyRule(
            action="Ignore",
            on_pod_conditions=[
                PodFailurePolicyOnPodCondition(reason="NodeLost")
            ],
        ),
    ])


def goodput_job(name: str, hot_spares: int = 0) -> TPUJob:
    job = TPUJob()
    job.metadata.name = name
    job.metadata.namespace = "default"
    job.spec = TPUJobSpec(
        tpu=TPUSpec(accelerator_type="h100-4", hot_spares=hot_spares),
        replica_specs={
            REPLICA_TYPE_WORKER: ReplicaSpec(
                replicas=WORKERS_PER_JOB, template=dict(TEMPLATE)
            )
        },
    )
    # Keep terminal pods (clean_pod_policy=None): post-mortem timelines
    # are the measurement here, and terminal pods hold no capacity.
    job.spec.run_policy.clean_pod_policy = "None"
    job.spec.run_policy.backoff_limit = 3
    job.spec.run_policy.pod_failure_policy = ignore_preemption_rules()
    job.spec.run_policy.scheduling_policy = SchedulingPolicy(queue=BENCH_QUEUE)
    return job


def run_rate(
    kill_rate: float,
    jobs: int,
    seed: int,
    max_rounds: int = 0,
    arm: str = "sync",
    save_every: int = 0,
) -> dict:
    """Drive ``jobs`` TPUJobs to terminal state at one chaos kill rate
    under one resilience arm; return the per-(arm, rate) result block of
    BENCH_GOODPUT_torch.json.  Every reported number derives from the
    simulated clock, so same seed => bit-identical block."""
    if arm not in ARMS:
        raise ValueError(f"arm: {arm!r} not in {ARMS}")
    hot_spares = HOT_SPARES if arm == "resilient" else 0
    checkpoint_mode = "async" if arm == "resilient" else "sync"
    if save_every <= 0:
        save_every = ARM_SAVE_EVERY[arm]
    concurrency = min(64, max(8, jobs // 16))
    # Standby headroom: enough extra slices for every in-flight job to
    # hold its spares as whole hosts.  Both arms get the same capacity —
    # the baseline arm just leaves it idle — so the curves compare
    # resilience mechanisms, not cluster sizes.
    chips_per_host = CHIPS_PER_JOB // WORKERS_PER_JOB
    spare_chips = concurrency * HOT_SPARES * chips_per_host
    spare_slices = (spare_chips + CHIPS_PER_JOB - 1) // CHIPS_PER_JOB
    rng = random.Random(seed)

    time_ = [NOW]
    clock = lambda: time_[0]  # noqa: E731
    raw = InMemoryAPIServer(clock=clock)
    registry = metrics.Registry()
    recorder = flightrecorder.FlightRecorder(
        capacity_per_job=1024, max_jobs=jobs + 8, clock=clock
    )
    ledger = goodput.GoodputLedger(recorder, registry=registry, clock=clock)

    register_nodes(raw, f"h100-4:{concurrency + spare_slices}")
    # Quota stays worker-sized: spare pods never charge the ledger.
    bootstrap_queues(
        raw, [f"{BENCH_QUEUE}:h100={CHIPS_PER_JOB * concurrency}"],
        namespace="default",
    )

    controller = TPUJobController(
        raw, gang_scheduler_name=DEFAULT_SCHEDULER_NAME,
        registry=registry, clock=clock, flight_recorder=recorder,
    )
    manager = QueueManager(
        raw, registry=registry, clock=clock, flight_recorder=recorder
    )
    scheduler = GangScheduler(
        raw, registry=registry, clock=clock, gang_wait_timeout=1e9,
        flight_recorder=recorder,
    )
    runner = GoodputRunner(
        raw, recorder, ledger=ledger,
        checkpoint_mode=checkpoint_mode, save_every=save_every,
    )

    killer = None
    engine = None
    kills_budget = 0
    if kill_rate > 0:
        # 90/10 SIGKILL/node-death mix, budgeted so the fleet converges
        # once the chaos quota is spent.  The curve parameter is
        # preemption *pressure* (it sizes the budget); the per-pod
        # per-tick rate is scaled well below it so the budget spreads
        # over the run as isolated preemptions — a burst that guns down
        # whole gangs in one tick is a correlated-failure study, not a
        # preemption curve.
        # Budget semantics: rate r means an r chance per job of being
        # preempted once over its run.
        kills_budget = max(1, int(jobs * kill_rate))
        per_tick = kill_rate / 10.0
        engine = chaos.ChaosEngine(chaos.ChaosPolicy(
            seed=seed,
            pods=(chaos.PodChaos(
                kill_rate=per_tick * 0.9,
                node_death_rate=per_tick * 0.1,
                roles=(constants.ROLE_WORKER,),
                namespace="default",
                max_kills=kills_budget,
            ),),
        ))
        killer = chaos.PodKiller(engine, raw, runner)

    # Simulated clocks everywhere control logic reads time (the chaos
    # soak idiom), so the drive loop is seed-deterministic.
    for factory in (controller.factory, manager.factory):
        factory.set_resync_interval(4.0)
        for informer in factory._informers.values():
            informer._clock = clock
    controller.queue._clock = clock
    manager.queue._clock = clock
    controller.start()
    manager.start()

    names = [f"goodput-{i:05d}" for i in range(jobs)]
    rng.shuffle(names)
    log(f"creating {jobs} TPUJobs at kill rate {kill_rate} arm {arm} "
        f"({WORKERS_PER_JOB}-worker gangs, {hot_spares} spares, "
        f"concurrency {concurrency})...")
    wall0 = time.perf_counter()
    for name in names:
        raw.create("tpujobs", goodput_job(name, hot_spares).to_dict())

    def pump():
        for _ in range(10):
            if controller.factory.pump_all() + manager.factory.pump_all() == 0:
                return

    def drain_controller_queue():
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

    real_sleep = retry.sleep
    retry.sleep = lambda s: None

    if max_rounds <= 0:
        # Baseline waves plus a recovery allowance per budgeted kill
        # (reschedule + startup + RUN_TICKS redo, padded).
        waves = (jobs + concurrency - 1) // concurrency
        max_rounds = (
            40 + (12 + STARTUP_TICKS + 2 * GoodputRunner.RUN_TICKS) * waves
            + (4 + STARTUP_TICKS + GoodputRunner.RUN_TICKS) * kills_budget
        )

    rounds_used = None
    try:
        for rnd in range(max_rounds):
            time_[0] += 1.0
            pump()
            try:
                manager.sync_handler("bench-tick")
            except ApiError:
                pass
            pump()
            drain_controller_queue()
            pump()
            try:
                scheduler.schedule_once()
            except ApiError:
                pass
            if killer is not None:
                killer.tick()
            runner.tick()
            done = (controller.jobs_successful.value()
                    + controller.jobs_failed.value())
            if done >= jobs:
                rounds_used = rnd + 1
                break
    finally:
        retry.sleep = real_sleep
        scheduler.stop()

    # Settling sweep: the manager observes the last finishes and
    # releases their quota charges.
    pump()
    try:
        manager.sync_handler("bench-final")
    except ApiError:
        manager.sync_handler("bench-final-retry")
    log(f"rate {kill_rate} arm {arm}: drove to round {rounds_used} in "
        f"{time.perf_counter() - wall0:.2f}s wall")

    # Ground-truth outcomes from the apiserver, not the counters.
    outcomes: dict[str, int] = {}
    for job in raw.list("tpujobs", "default"):
        phase = statemetrics.job_phase(job)
        outcomes[phase] = outcomes.get(phase, 0) + 1
    converged = (
        rounds_used is not None
        and sum(outcomes.get(p, 0) for p in ("Succeeded", "Failed")) == jobs
    )

    fleet = ledger.fleet_snapshot(now=time_[0])
    kills = 0
    if engine is not None:
        kills = sum(
            1 for kind, _, _ in engine.timeline()
            if kind in (chaos.POD_KILL, chaos.NODE_DEATH)
        )
    attributed = sum(fleet["phase_seconds"].values())
    wall_total = fleet["wall_seconds"]
    residual = (
        abs(attributed - wall_total) / wall_total if wall_total > 0 else 0.0
    )
    ckpt_per_job = (
        fleet["phase_seconds"][goodput.PHASE_CHECKPOINT] / jobs
        if jobs else 0.0
    )
    return {
        "arm": arm,
        "kill_rate": kill_rate,
        "jobs": jobs,
        "seed": seed,
        "concurrency": concurrency,
        "hot_spares": hot_spares,
        "save_every": save_every,
        "converged": converged,
        "rounds": rounds_used,
        "sim_seconds": round(time_[0] - NOW, 6),
        "outcomes": outcomes,
        "kills": kills,
        "restarts_total": fleet["restarts"],
        "spare_promotions": int(controller.spare_promotions.value()),
        "goodput_ratio": fleet["goodput_ratio"],
        "wall_seconds_total": wall_total,
        "phase_seconds": fleet["phase_seconds"],
        "phase_shares": fleet["phase_shares"],
        "checkpoint_seconds_per_job": round(ckpt_per_job, 6),
        "attribution_residual_ratio": round(residual, 6),
    }


# ----------------------------------------------------------------------
# Artifact schema
# ----------------------------------------------------------------------

_RESULT_KEYS = {
    "arm": str,
    "kill_rate": float,
    "jobs": int,
    "seed": int,
    "hot_spares": int,
    "save_every": int,
    "converged": bool,
    "sim_seconds": float,
    "outcomes": dict,
    "kills": int,
    "restarts_total": int,
    "spare_promotions": int,
    "goodput_ratio": float,
    "wall_seconds_total": float,
    "phase_seconds": dict,
    "phase_shares": dict,
    "checkpoint_seconds_per_job": float,
    "attribution_residual_ratio": float,
    "loss_attribution_vs_baseline": dict,
}

_SCALING_KEYS = ("save_every_1", "save_every_2", "scaling_ratio")


def check_schema(doc: dict) -> None:
    """Schema gate for BENCH_GOODPUT_torch.json; raises ValueError with a
    path-qualified message on the first violation.  Beyond shape, it
    enforces the ledger's core invariants: the phase vocabulary is
    closed, and per-phase seconds sum to the fleet wall time within 1%."""
    if doc.get("schema_version") != SCHEMA_VERSION:
        raise ValueError(
            f"schema_version: expected {SCHEMA_VERSION}, "
            f"got {doc.get('schema_version')!r}"
        )
    if doc.get("benchmark") != "goodput":
        raise ValueError(f"benchmark: got {doc.get('benchmark')!r}")
    arms = doc.get("arms")
    if not isinstance(arms, list) or not arms:
        raise ValueError("arms: expected a non-empty list")
    curve = doc.get("curve")
    if not isinstance(curve, list) or not curve:
        raise ValueError("curve: expected a non-empty list")
    for i, point in enumerate(curve):
        if point.get("arm") not in arms:
            raise ValueError(f"curve[{i}].arm: {point.get('arm')!r}")
        for key in ("kill_rate", "goodput_ratio"):
            if not isinstance(point.get(key), (int, float)):
                raise ValueError(f"curve[{i}].{key}: missing or non-numeric")
    results = doc.get("results")
    if not isinstance(results, list) or not results:
        raise ValueError("results: expected a non-empty list")
    if len(curve) != len(results):
        raise ValueError(
            f"curve: {len(curve)} points for {len(results)} results"
        )
    vocabulary = set(goodput.GOODPUT_PHASES)
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
        if res["arm"] not in arms:
            raise ValueError(f"{where}.arm: {res['arm']!r} not in arms")
        for field in ("phase_seconds", "phase_shares",
                      "loss_attribution_vs_baseline"):
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
        if not 0.0 <= res["goodput_ratio"] <= 1.0:
            raise ValueError(
                f"{where}.goodput_ratio: {res['goodput_ratio']} not in [0,1]"
            )
    scaling = doc.get("checkpoint_scaling")
    if not isinstance(scaling, dict):
        raise ValueError("checkpoint_scaling: expected a dict")
    for mode in ("sync", "async"):
        block = scaling.get(mode)
        if not isinstance(block, dict):
            raise ValueError(f"checkpoint_scaling.{mode}: expected a dict")
        for key in _SCALING_KEYS:
            if not isinstance(block.get(key), (int, float)):
                raise ValueError(
                    f"checkpoint_scaling.{mode}.{key}: missing or "
                    f"non-numeric"
                )


def build_doc(
    rates: list[float], jobs: int, seed: int, max_rounds: int = 0
) -> dict:
    results: list[dict] = []
    for arm in ARMS:
        arm_results = []
        for rate in rates:
            result = run_rate(
                rate, jobs, seed, max_rounds=max_rounds, arm=arm
            )
            log(
                f"rate {rate} arm {arm}: converged={result['converged']} "
                f"in {result['rounds']} rounds, goodput "
                f"{result['goodput_ratio']:.4f}, {result['kills']} kills, "
                f"{result['restarts_total']} restarts, "
                f"{result['spare_promotions']} promotions"
            )
            arm_results.append(result)
        # Per-job average per-phase seconds lost versus this arm's first
        # rate (its baseline): where does preemption pressure put the
        # time, and how much of it does each resilience arm buy back?
        base = arm_results[0]
        for res in arm_results:
            res["loss_attribution_vs_baseline"] = {
                p: round(
                    res["phase_seconds"][p] / res["jobs"]
                    - base["phase_seconds"][p] / base["jobs"], 6,
                )
                for p in goodput.GOODPUT_PHASES
            }
        results.extend(arm_results)

    # Save-frequency scaling: same seeded fleet at r=0, save cadence 1
    # vs 2 ticks, per checkpoint mode.  Sync seconds halve when the
    # cadence halves (ratio ~2); async seconds are bounded by the write
    # pipeline, not the cadence (ratio ~1).
    scaling_jobs = min(jobs, 32)
    scaling: dict[str, dict] = {}
    for arm, mode in (("sync", "sync"), ("resilient", "async")):
        per_cadence = {}
        for cadence in (1, 2):
            res = run_rate(
                0.0, scaling_jobs, seed, max_rounds=max_rounds,
                arm=arm, save_every=cadence,
            )
            per_cadence[cadence] = res["checkpoint_seconds_per_job"]
        ratio = (
            per_cadence[1] / per_cadence[2] if per_cadence[2] > 0 else 0.0
        )
        scaling[mode] = {
            "save_every_1": per_cadence[1],
            "save_every_2": per_cadence[2],
            "scaling_ratio": round(ratio, 6),
        }
        log(f"checkpoint scaling {mode}: se=1 {per_cadence[1]}s/job, "
            f"se=2 {per_cadence[2]}s/job, ratio {ratio:.3f}")

    return {
        "benchmark": "goodput",
        "schema_version": SCHEMA_VERSION,
        "jobs": jobs,
        "seed": seed,
        "kill_rates": list(rates),
        "arms": list(ARMS),
        "hot_spares": HOT_SPARES,
        "arm_save_every": dict(ARM_SAVE_EVERY),
        "run_ticks": GoodputRunner.RUN_TICKS,
        "curve": [
            {
                "arm": r["arm"],
                "kill_rate": r["kill_rate"],
                "goodput_ratio": r["goodput_ratio"],
            }
            for r in results
        ],
        "results": results,
        "checkpoint_scaling": scaling,
    }


def canonical_bytes(doc: dict) -> bytes:
    """The artifact's on-disk form: the unit of the --baseline gate."""
    return (json.dumps(doc, indent=2, sort_keys=True) + "\n").encode()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="bench-goodput",
        description="goodput-under-preemption benchmark (memory backend)",
    )
    p.add_argument("--jobs", type=int, default=100)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--rates", default=",".join(str(r) for r in KILL_RATES),
                   help="comma-separated chaos kill rates (e.g. 0,0.1,0.3)")
    p.add_argument("--max-rounds", type=int, default=0,
                   help="round budget per rate (0 = auto from fleet size)")
    p.add_argument("--out", default="BENCH_GOODPUT_torch.json")
    p.add_argument("--baseline", default="",
                   help="committed artifact to diff against; when the "
                        "file exists the fresh artifact must match it "
                        "byte-for-byte (the CI regression gate)")
    args = p.parse_args(argv)

    logutil.configure(level=logutil.parse_level("warning"))
    rates = [float(r) for r in args.rates.split(",") if r.strip()]
    doc = build_doc(rates, args.jobs, args.seed, args.max_rounds)
    check_schema(doc)
    payload = canonical_bytes(doc)

    if args.baseline and os.path.exists(args.baseline):
        with open(args.baseline, "rb") as f:
            committed = f.read()
        if committed != payload:
            log(f"FAIL: artifact diverged from baseline {args.baseline} "
                f"({len(committed)} committed bytes vs {len(payload)} "
                f"fresh); re-run with --out to regenerate after an "
                f"intentional change")
            return 1
        log(f"baseline {args.baseline}: bit-identical")
    with open(args.out, "wb") as f:
        f.write(payload)
    log(f"wrote {args.out}")

    curve = doc["curve"]
    by_arm = {
        arm: [pt for pt in curve if pt["arm"] == arm] for arm in doc["arms"]
    }
    # Relative goodput loss at the heaviest kill rate, per arm — the
    # headline: the resilient arm should lose single-digit percent.
    loss_pct = {}
    for arm, points in by_arm.items():
        g0 = points[0]["goodput_ratio"]
        loss_pct[arm] = round(
            100.0 * (g0 - points[-1]["goodput_ratio"]) / g0 if g0 else 0.0,
            3,
        )
    print(json.dumps({
        "metric": "goodput_vs_kill_rate",
        "value": by_arm[doc["arms"][-1]][-1]["goodput_ratio"],
        "unit": (
            f"fleet goodput at kill rate {curve[-1]['kill_rate']} "
            f"({doc['jobs']} jobs, seed {doc['seed']}, "
            f"arm {doc['arms'][-1]})"
        ),
        "curve": curve,
        "goodput_loss_pct_at_max_rate": loss_pct,
        "checkpoint_scaling": doc["checkpoint_scaling"],
    }))
    ok = all(r["converged"] for r in doc["results"])
    # Preemption must not *improve* goodput: each arm's curve is
    # monotone (within float dust) from its r=0 baseline down.
    for arm, points in by_arm.items():
        if points and (
            points[0]["goodput_ratio"] + 1e-9 < points[-1]["goodput_ratio"]
        ):
            log(f"FAIL: arm {arm} goodput at baseline below goodput at "
                f"max kill rate")
            ok = False
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
