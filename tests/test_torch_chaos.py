"""The port's chaos harness against the JAX package's.

- the engine: one seed and one script of decision calls give both
  packages' engines the same fault timeline, draw for draw;
- the soak of ``tests/test_chaos.py`` (controller, queue and gang
  scheduler over a ``ChaoticAPIServer``, a ``PodKiller`` against a fake
  kubelet, seeded) on both packages with twin jobs (``v5e-16`` / ``h100-4``,
  4 workers each) and twin quotas: the port's run converges, replays
  from its seed, takes no lock pair in both orders, and injects the JAX
  run's fault timeline;
- the pod-side injectors against the port's runner hooks, and a torn
  checkpoint commit delivered through the runner's env falling back to
  the previous committed step.
"""

from __future__ import annotations

import importlib
import re
from types import SimpleNamespace

import pytest

pytestmark = pytest.mark.kernel

JAX, PORT = "mpi_operator_tpu", "mpi_operator_tpu_torch"
NOW = 1000.0
TEMPLATE = {"spec": {"containers": [{"name": "main", "image": "img"}]}}
SOAK_JOBS = 3
SOAK_WORKERS = 4
SOAK_QUEUE = "chaos-q"
# Twin soak clusters: 2 jobs of quota, room for 3 gangs.
SOAK = {
    JAX: {"accel": "v5e-16", "nodes": "v5e-16:3", "gen": "v5e", "quota": 32},
    PORT: {"accel": "h100-4", "nodes": "h100-8:2", "gen": "h100", "quota": 8},
}


def side(pkg: str) -> SimpleNamespace:
    mod = lambda name: importlib.import_module(f"{pkg}.{name}")  # noqa: E731
    return SimpleNamespace(
        pkg=pkg, chaos=mod("chaos"), api=mod("api.v2beta1"),
        types=mod("api.v2beta1.types"), constants=mod("api.v2beta1.constants"),
        status=mod("controller.status"),
        controller=mod("controller.tpu_job_controller"),
        apiserver=mod("runtime.apiserver"), retry=mod("runtime.retry"),
        locktrace=mod("runtime.locktrace"), queue=mod("queue"),
        scheduler=mod("scheduler"), metrics=mod("utils.metrics"),
        flightrecorder=mod("utils.flightrecorder"))


# -- the engine ---------------------------------------------------------------

def drive_engine(pkg: str, seed: int) -> tuple:
    """One fixed script of decision calls over every fault surface."""
    c = side(pkg).chaos
    kill = c.PodChaos(kill_rate=0.3, node_death_rate=0.2, max_kills=5)
    slow = c.SlowWorkerChaos(slow_rate=0.4, factor=2.0, max_slow=3)
    leak = c.MemoryLeakChaos(leak_rate=0.5, bytes_per_window=1 << 30,
                             max_leak=2)
    torn = c.TornWriteChaos(torn_rate=0.3, max_torn=2)
    engine = c.ChaosEngine(c.ChaosPolicy(
        seed=seed,
        verbs=(c.VerbFaults(conflict_rate=0.2, server_error_rate=0.1,
                            timeout_rate=0.05),),
        watch=c.WatchFaults(drop_rate=0.1, delay_rate=0.1, gone_rate=0.05),
        pods=(kill,), slow=(slow,), leak=(leak,), torn=(torn,)))
    decisions = []
    for i in range(60):
        err = engine.fault_for(("create", "update", "delete")[i % 3], "pods",
                               f"p{i % 7}")
        decisions.append(type(err).__name__ if err else None)
        decisions.append(engine.watch_fault("pods", f"default/p{i % 5}"))
        mode = engine.pod_fault(0, kill)
        if mode:
            engine.confirm_kill(0, mode, f"default/w{i % 4}")
        decisions.append(mode)
        if engine.slow_fault(0, slow):
            engine.confirm_slow(0, f"default/w{i % 4}", slow.factor)
        if engine.leak_fault(0, leak):
            engine.confirm_leak(0, f"default/w{i % 4}", leak.bytes_per_window)
        if engine.torn_fault(0, torn):
            engine.confirm_torn(0, f"default/w{i % 4}")
    return engine.timeline(), decisions


@pytest.mark.parametrize("seed", [0, 7, 42, 1234])
def test_same_seed_gives_both_packages_one_fault_timeline(seed):
    port, jax = drive_engine(PORT, seed), drive_engine(JAX, seed)
    assert port == jax
    kinds = {kind for kind, _, _ in port[0]}
    assert {"conflict", "watch_drop", "pod_kill", "slow_worker", "mem_leak",
            "torn_write"} <= kinds


def test_other_seed_other_timeline():
    assert drive_engine(PORT, 1)[0] != drive_engine(PORT, 2)[0]


def test_port_metrics_keep_the_reference_names():
    s = side(PORT)
    registry = s.metrics.Registry()
    engine = s.chaos.ChaosEngine(s.chaos.ChaosPolicy(seed=0),
                                 registry=registry)
    engine.record(s.chaos.POD_KILL, "pod default/w0")
    assert 'tpu_operator_chaos_faults_injected_total{kind="pod_kill"} 1' in (
        registry.expose())


# -- the soak -----------------------------------------------------------------

class FakeRunner:
    """``tests/test_chaos.py``'s kubelet sim: binds go Running; a gang
    fully Running for RUN_TICKS ticks succeeds together; the PodKiller's
    hooks fail a pod the way the runner does (SIGKILL -> 137, node death
    -> Failed/NodeLost)."""

    RUN_TICKS = 3

    def __init__(self, api, label: str):
        self.api, self.label = api, label
        self._gang_age: dict[str, int] = {}

    def tick(self) -> None:
        for pod in self.api.list("pods"):
            status = pod.get("status") or {}
            if (status.get("phase") or "Pending") == "Pending" and (
                    pod.get("spec") or {}).get("nodeName"):
                pod["status"] = {"phase": "Running"}
                self.api.update_status("pods", pod)
        gangs: dict[str, list] = {}
        for pod in self.api.list("pods"):
            name = ((pod.get("metadata") or {}).get("labels") or {}).get(
                self.label)
            if name:
                gangs.setdefault(name, []).append(pod)
        for name in sorted(gangs):
            members = gangs[name]
            phases = [(p.get("status") or {}).get("phase") for p in members]
            if len(members) == SOAK_WORKERS and all(
                    ph == "Running" for ph in phases):
                age = self._gang_age.get(name, 0) + 1
                self._gang_age[name] = age
                if age >= self.RUN_TICKS:
                    for pod in members:
                        pod["status"] = {"phase": "Succeeded",
                                         "containerStatuses": [{
                                             "name": "main", "state": {
                                                 "terminated": {
                                                     "exitCode": 0}}}]}
                        self.api.update_status("pods", pod)
            elif not all(ph == "Succeeded" for ph in phases):
                self._gang_age[name] = 0

    def _fail(self, namespace, name, status) -> bool:
        try:
            pod = self.api.get("pods", namespace, name)
        except Exception:
            return False
        if (pod.get("status") or {}).get("phase") != "Running":
            return False
        pod["status"] = status
        self.api.update_status("pods", pod)
        return True

    def kill_pod(self, namespace, name) -> bool:
        return self._fail(namespace, name, {
            "phase": "Failed", "containerStatuses": [{
                "name": "main", "state": {"terminated": {"exitCode": 137}}}]})

    def fail_node(self, namespace, name) -> bool:
        return self._fail(namespace, name,
                          {"phase": "Failed", "reason": "NodeLost"})


def soak_job(s, name: str, accel: str):
    a, t = s.api, s.types
    job = a.TPUJob()
    job.metadata.name = name
    job.metadata.namespace = "default"
    job.spec = a.TPUJobSpec(
        tpu=a.TPUSpec(accelerator_type=accel),
        replica_specs={a.REPLICA_TYPE_WORKER: a.ReplicaSpec(
            replicas=SOAK_WORKERS, template=dict(TEMPLATE))})
    job.spec.run_policy.clean_pod_policy = "None"
    job.spec.run_policy.backoff_limit = 3
    job.spec.run_policy.scheduling_policy = t.SchedulingPolicy(
        queue=SOAK_QUEUE)
    job.spec.run_policy.pod_failure_policy = t.PodFailurePolicy(rules=[
        t.PodFailurePolicyRule(
            action="Ignore",
            on_exit_codes=t.PodFailurePolicyOnExitCodes(
                operator="In", values=[137])),
        t.PodFailurePolicyRule(
            action="Ignore",
            on_pod_conditions=[t.PodFailurePolicyOnPodCondition(
                reason="NodeLost")]),
    ])
    return job


def run_soak(pkg: str, seed: int, max_rounds: int = 250) -> dict:
    """``tests/test_chaos.py:run_soak`` for either package."""
    s, cell = side(pkg), SOAK[pkg]
    c = s.chaos
    time_ = [NOW]
    clock = lambda: time_[0]  # noqa: E731
    raw = s.apiserver.InMemoryAPIServer(clock=clock)
    registry = s.metrics.Registry()
    engine = c.ChaosEngine(c.ChaosPolicy(
        seed=seed,
        verbs=(c.VerbFaults(conflict_rate=0.15, server_error_rate=0.08,
                            timeout_rate=0.02),),
        watch=c.WatchFaults(drop_rate=0.05, delay_rate=0.08, gone_rate=0.02,
                            delay_rounds=2),
        pods=(c.PodChaos(kill_rate=0.08, node_death_rate=0.04,
                         namespace="default", max_kills=6),)),
        registry=registry)
    capi = c.ChaoticAPIServer(raw, engine)
    s.scheduler.register_nodes(raw, cell["nodes"])
    s.queue.bootstrap_queues(
        raw, [f"{SOAK_QUEUE}:{cell['gen']}={cell['quota']}"],
        namespace="default")
    controller = s.controller.TPUJobController(
        capi, gang_scheduler_name=s.scheduler.DEFAULT_SCHEDULER_NAME,
        registry=registry, clock=clock)
    manager = s.queue.QueueManager(capi, registry=registry, clock=clock)
    scheduler = s.scheduler.GangScheduler(
        capi, registry=s.metrics.Registry(), clock=clock,
        gang_wait_timeout=1e9)
    runner = FakeRunner(raw, s.constants.JOB_NAME_LABEL)
    killer = c.PodKiller(engine, capi, runner)
    for factory in (controller.factory, manager.factory):
        factory.set_resync_interval(4.0)
        for informer in factory._informers.values():
            informer._clock = clock
    controller.start()
    manager.start()
    for i in range(SOAK_JOBS):
        raw.create("tpujobs",
                   soak_job(s, f"chaos-{i}", cell["accel"]).to_dict())
    keys = [f"default/chaos-{i}" for i in range(SOAK_JOBS)]
    ApiError = s.apiserver.ApiError

    def pump():
        for _ in range(10):
            if controller.factory.pump_all() + manager.factory.pump_all() == 0:
                return

    def jobs():
        return [s.api.TPUJob.from_dict(raw.get("tpujobs", "default",
                                               f"chaos-{i}"))
                for i in range(SOAK_JOBS)]

    breaches, rounds_used = [], None
    for rnd in range(max_rounds):
        time_[0] += 1.0
        pump()
        try:
            manager.sync_handler("soak-tick")
        except ApiError:
            pass
        pump()
        for key in keys:
            try:
                controller.sync_handler(key)
            except ApiError:
                pass
        pump()
        try:
            scheduler.schedule_once()
        except ApiError:
            pass
        killer.tick()
        runner.tick()
        used = manager.ledger.usage(SOAK_QUEUE, cell["gen"])
        if used > manager.ledger.nominal(SOAK_QUEUE, cell["gen"]):
            breaches.append((rnd, used))
        if all(s.status.has_condition(j.status, "Succeeded") for j in jobs()):
            rounds_used = rnd + 1
            break
    pump()
    try:
        manager.sync_handler("soak-final")
    except ApiError:
        manager.sync_handler("soak-final-retry")
    final = jobs()
    return {
        "timeline": engine.timeline(),
        "rounds": rounds_used,
        "breaches": breaches,
        "conditions": [[(cd.type, cd.status, cd.reason,
                         cd.last_transition_time)
                        for cd in j.status.conditions] for j in final],
        "succeeded": [s.status.has_condition(j.status, "Succeeded")
                      for j in final],
        "restarts": [(j.status.replica_statuses.get("Worker")
                      or SimpleNamespace(restarts=0)).restarts for j in final],
        "ledger_usage": manager.ledger.usage(SOAK_QUEUE, cell["gen"]),
        "orphans": [p["metadata"]["name"] for p in raw.list("pods")
                    if not {r.get("name") for r in
                            p["metadata"].get("ownerReferences") or []
                            if r.get("controller")} <= {j.name for j in final}],
    }


def event_names_masked(timeline: list) -> list:
    return [(kind, re.sub(r"^(create|update) (events/.*)\.[0-9a-f]+$",
                          r"write \2", target), detail)
            for kind, target, detail in timeline]


@pytest.fixture
def fast_retries(monkeypatch):
    for pkg in (JAX, PORT):
        monkeypatch.setattr(side(pkg).retry, "sleep", lambda s: None)


@pytest.mark.usefixtures("fast_retries")
def test_soak_converges_and_injects_the_jax_packages_faults():
    port, jax = run_soak(PORT, 42), run_soak(JAX, 42)
    assert port["rounds"] is not None, "the port's soak did not converge"
    assert all(port["succeeded"])
    assert port["breaches"] == [] and port["ledger_usage"] == 0
    assert port["orphans"] == []
    assert port["restarts"] == [0] * SOAK_JOBS  # kills were policy-Ignored
    kinds = [kind for kind, _, _ in port["timeline"]]
    assert "conflict" in kinds and "server_error" in kinds
    assert {"pod_kill", "node_death"} & set(kinds)
    # Twin jobs make the same API calls in the same order, so one seed
    # injects one fault timeline and the runs end alike. Masked: an
    # Event's name carries a process-wide counter of its package, and an
    # Event naming a node is created in one package where the other
    # aggregates it into an update (a v5e worker binds to a host of its
    # own, an h100 worker to a shared 8-GPU node).
    assert event_names_masked(port["timeline"]) == event_names_masked(
        jax["timeline"])
    for key in ("rounds", "conditions", "restarts", "succeeded"):
        assert port[key] == jax[key], key


@pytest.mark.usefixtures("fast_retries")
def test_soak_replays_from_its_seed():
    first, second = run_soak(PORT, 1234), run_soak(PORT, 1234)
    assert first["timeline"] == second["timeline"]
    assert first["conditions"] == second["conditions"]
    assert run_soak(PORT, 99)["timeline"] != first["timeline"]


@pytest.mark.usefixtures("fast_retries")
def test_soak_takes_no_lock_pair_in_both_orders():
    locktrace = side(PORT).locktrace
    tracer = locktrace.enable(locktrace.LockTracer(capture_stacks=False))
    try:
        result = run_soak(PORT, 42)
    finally:
        locktrace.disable()
    assert result["rounds"] is not None
    report = tracer.report()
    assert report["acquisitions"] > 1000 and len(report["locks"]) >= 5
    assert any(report["edges"].values())
    assert report["inversions"] == []


# -- the pod-side injectors on the port's runner -------------------------------

def _running_pod(api, name, *, role="worker", phase="Running"):
    c = side(PORT).constants
    api.create("pods", {
        "metadata": {"name": name, "namespace": "default", "labels": {
            c.JOB_NAME_LABEL: "j1", c.JOB_ROLE_LABEL: role}},
        "spec": {"nodeName": "n0", "containers": [{"command": ["true"]}]},
        "status": {"phase": phase}})


def _injectors(seed: int, **policies):
    s = side(PORT)
    from mpi_operator_tpu_torch.runtime.podrunner import LocalPodRunner

    api = s.apiserver.InMemoryAPIServer()
    for i in range(3):
        _running_pod(api, f"j1-worker-{i}")
    _running_pod(api, "j1-launcher-0", role="launcher")
    runner = LocalPodRunner(api, cuda_devices=0)
    recorder = s.flightrecorder.FlightRecorder(clock=lambda: 5.0)
    engine = s.chaos.ChaosEngine(s.chaos.ChaosPolicy(seed=seed, **policies))
    return api, runner, engine, recorder


def test_slow_and_leak_reach_the_replacements_env():
    """WorkerSlower and LeakInjector register their faults with the
    port's runner; the next process of each victim gets them in its env
    (TPUJOB_CHAOS_STEP_SLOWDOWN, TPU_MEM_LEAK_BYTES), as the trainer and
    the device-memory sampler read them."""
    c = side(PORT).chaos
    constants = side(PORT).constants
    api, runner, engine, recorder = _injectors(
        3, slow=(c.SlowWorkerChaos(slow_rate=1.0, factor=2.0, max_slow=1),),
        leak=(c.MemoryLeakChaos(leak_rate=1.0, bytes_per_window=1 << 30,
                                max_leak=1),))
    slower = c.WorkerSlower(engine, api, runner, flight_recorder=recorder)
    leaker = c.LeakInjector(engine, api, runner, flight_recorder=recorder)
    assert (slower.tick(), leaker.tick()) == (1, 1)
    assert (slower.tick(), leaker.tick()) == (0, 0)  # budgets spent
    assert engine.timeline() == [
        ("slow_worker", "pod default/j1-worker-0", "factor=2.0"),
        ("mem_leak", "pod default/j1-worker-0",
         f"bytes_per_window={1 << 30}")]
    env = runner._child_env(api.get("pods", "default", "j1-worker-0"))
    assert env[constants.ENV_STEP_SLOWDOWN] == "2.0"
    assert env[constants.ENV_MEM_LEAK_BYTES] == str(1 << 30)
    other = runner._child_env(api.get("pods", "default", "j1-worker-1"))
    assert constants.ENV_STEP_SLOWDOWN not in other
    kinds = [e["kind"] for e in recorder.timeline("default", "j1")]
    assert kinds == ["slow_worker", "mem_leak"]


def test_torn_write_through_the_runner_falls_back_to_the_previous_step(
        tmp_path, monkeypatch):
    """TornWriteInjector arms the port runner's one-shot env; a writer
    started under that env (the victim's replacement) tears its commit,
    and a restore falls back to the previous committed step."""
    import torch

    from mpi_operator_tpu_torch.utils.checkpoint import (
        AsyncCheckpointManager, CheckpointManager, committed_steps)

    c = side(PORT).chaos
    constants = side(PORT).constants
    api, runner, engine, recorder = _injectors(
        0, torn=(c.TornWriteChaos(torn_rate=1.0, max_torn=1),))
    killed = []
    monkeypatch.setattr(runner, "kill_pod",
                        lambda ns, name: killed.append(name) or True)
    injector = c.TornWriteInjector(engine, api, runner,
                                   flight_recorder=recorder)
    assert injector.tick() == 1 and killed == ["j1-worker-0"]
    pod = api.get("pods", "default", "j1-worker-0")
    env = runner._child_env(pod)
    assert env[constants.ENV_TORN_WRITE] == "1"
    # One-shot: the restart after that writes clean commits again.
    assert constants.ENV_TORN_WRITE not in runner._child_env(pod)

    state = lambda v: {"params": {"w": torch.full((4,), float(v))},  # noqa: E731
                       "opt_state": {"step": torch.tensor(float(v))}}
    clean = CheckpointManager(str(tmp_path), save_interval_steps=1)
    clean.save(1, state(1), force=True)
    clean.close()
    monkeypatch.setenv(constants.ENV_TORN_WRITE,
                       env[constants.ENV_TORN_WRITE])
    victim = AsyncCheckpointManager(str(tmp_path), save_interval_steps=1)
    assert victim.save(2, state(2)) and victim.drain(10.0)
    victim.close()
    assert victim.torn_writes == 1
    assert committed_steps(str(tmp_path)) == {1}
    step, restored = CheckpointManager(str(tmp_path)).restore_latest(state(0))
    assert step == 1
    assert torch.equal(restored["params"]["w"], torch.full((4,), 1.0))
    (entry,) = recorder.timeline("default", "j1", kind="torn_write")
    assert "killed mid-commit (marker withheld)" in entry["message"]
