"""The port's trainer feeding the operator's observatories, on the CPU.

- ``cmd.train --heartbeat-every 2`` on llama-tiny writes the JAX
  trainer's ``step_heartbeat`` and ``device_memory`` records: the same
  keys, windows and step counts on the same flags;
- the chaos step slowdown (``TPUJOB_CHAOS_STEP_SLOWDOWN=2``) doubles the
  heartbeats' p50 wall, as in the JAX trainer;
- through the port's operator (controller, runner, real worker
  processes): a seeded ``ChaosEngine`` slows one worker, leaks on
  another and kills all three at their start; the replacements carry the
  faults, ``Straggling`` and ``MemoryPressure`` flip, and the job
  succeeds.

The operator job is a set of replicas (each pod trains its own model;
``python -m tests.test_torch_observe`` drops the world env before
``cmd.train``). A straggler in one synchronous world cannot show in the
step-skew matrix: every rank waits for the slowest at each step's
collective, so their step walls come out equal. Its device-memory
samples come from ``FakeMemoryBackend`` (16 GiB), the CPU having no
limit to project against.
"""

from __future__ import annotations

import functools
import importlib
import json
import os
import statistics
import sys
import threading
import time
from pathlib import Path

import pytest

pytestmark = pytest.mark.kernel

REPO_ROOT = Path(__file__).resolve().parent.parent
def tiny(seq_len: int = 16) -> list:
    return ["--model", "llama-tiny", "--seq-len", str(seq_len),
            "--global-batch", "8", "--telemetry-every", "0", "--log-every",
            "0"]


TINY = tiny()
WORLD_ENV = ("TPUJOB_COORDINATOR_ADDRESS", "TPUJOB_NUM_PROCESSES",
             "TPUJOB_PROCESS_ID")
GiB = 1024 ** 3


def records(path: Path, event: str) -> list:
    return [r for r in (json.loads(line) for line in path.read_text()
                        .splitlines() if line.startswith("{"))
            if r.get("event") == event]


def test_heartbeat_records_match_the_jax_trainers(tmp_path, monkeypatch):
    from mpi_operator_tpu.cmd import train as jax_train
    from mpi_operator_tpu.ops import attention as jattn
    from mpi_operator_tpu_torch.cmd import train

    # The JAX flat flash path reads ``os`` it never imports.
    monkeypatch.setattr(jattn, "os", os, raising=False)
    monkeypatch.setenv("TPU_WORKER_ID", "0")
    argv = TINY + ["--steps", "8", "--warmup", "2", "--heartbeat-every", "2"]
    port_path, jax_path = tmp_path / "port.jsonl", tmp_path / "jax.jsonl"
    assert train.main(["--device", "cpu", *argv, "--telemetry-path",
                       str(port_path)]) == 0
    assert jax_train.main([*argv, "--telemetry-path", str(jax_path)]) == 0
    for event in ("step_heartbeat", "device_memory"):
        port, jax = records(port_path, event), records(jax_path, event)
        assert len(port) == len(jax) == 3, event  # 6 timed steps, 2 a window
        assert [set(r) for r in port] == [set(r) for r in jax]
        same = ("window", "step", "steps", "worker_id", "event")
        assert ([{k: r[k] for k in same if k in r} for r in port]
                == [{k: r[k] for k in same if k in r} for r in jax])
    mem = records(port_path, "device_memory")
    # The CPU sample: the trainer's held tensors, no limit.
    assert all(r["hbm_bytes_in_use"] > 0 and r["hbm_limit_bytes"] == 0
               for r in mem)


def test_step_slowdown_doubles_the_heartbeat_wall(tmp_path, monkeypatch):
    """Each slowed step sleeps (factor - 1) x its own measured time before
    the wall is taken, so a heartbeat's p50 is twice the unpadded step.
    Held within the run, against the pads the trainer asked for: a CPU
    that idles through the pads also computes slower between them, so a
    second, unslowed run is no yardstick for the factor."""
    import threading

    import torch

    from mpi_operator_tpu_torch.cmd import train

    torch.set_num_threads(1)
    pads, real_sleep = [], train.time.sleep

    def sleep(seconds):
        if threading.current_thread() is threading.main_thread():
            pads.append(seconds * 1000)
        real_sleep(seconds)

    monkeypatch.setattr(train.time, "sleep", sleep)
    monkeypatch.setenv("TPUJOB_CHAOS_STEP_SLOWDOWN", "2")
    path = tmp_path / "slow.jsonl"
    # S=64: steps of tens of ms, so a late wake-up from the pad's sleep
    # stays small beside the pad.
    assert train.main(["--device", "cpu", *tiny(64), "--steps", "9",
                       "--warmup", "1", "--heartbeat-every", "2",
                       "--telemetry-path", str(path)]) == 0
    beats = records(path, "step_heartbeat")
    assert len(beats) == 4 and len(pads) == 9
    # Pads of the post-warmup steps, two a window: a wall is its step
    # plus a pad of the same length, plus the sleep's late wake-up.
    for beat, window_pads in zip(beats, zip(pads[1::2], pads[2::2])):
        ratio = beat["step_wall_p50_ms"] / statistics.mean(window_pads)
        assert 1.95 <= ratio <= 2.5, (beat, window_pads)


# -- flip and recover: the controller on the trainers' own records -----------

def _worker_records(pkg: str, p50s_ms: list, leaks: list) -> tuple:
    """One worker's heartbeat and device-memory records, window by
    window, from ``pkg``'s own TrainingTelemetry and DeviceMemorySampler:
    two steps a window at ``p50s_ms[w]``, ``leaks[w]`` bytes a window
    added to a flat 4 GiB of a 16 GiB FakeMemoryBackend."""
    import importlib
    import io

    telemetry = importlib.import_module(f"{pkg}.utils.telemetry")
    devstats = importlib.import_module(f"{pkg}.utils.devstats")
    metrics = importlib.import_module(f"{pkg}.utils.metrics")
    backend = devstats.FakeMemoryBackend()
    leaked = [0]

    def sample(window):
        rec = devstats.DeviceMemorySampler(
            backend=backend, leak_bytes_per_window=0,
            compile_cache_fn=lambda: 3).sample(window)
        leaked[0] += leaks[window]
        rec["hbm_bytes_in_use"] += leaked[0]
        rec["hbm_peak_bytes"] = max(rec["hbm_peak_bytes"],
                                    rec["hbm_bytes_in_use"])
        return rec

    stream = io.StringIO()
    telem = telemetry.TrainingTelemetry(
        registry=metrics.Registry(), stream=stream, heartbeat_interval=2,
        devstats_sampler=sample)
    step = 0
    for p50 in p50s_ms:
        for _ in range(2):
            step += 1
            telem.record_step(step, p50 / 1000.0)
    lines = [json.loads(line) for line in stream.getvalue().splitlines()]
    return ([r for r in lines if r["event"] == "step_heartbeat"],
            [r for r in lines if r["event"] == "device_memory"])


# Worker 3 at 2x for windows 0-2, then at the gang's pace; worker 1's
# reported memory climbs 2 GiB a window for windows 0-3, then stays.
WINDOWS = 12
P50S = [[100.0] * WINDOWS] * 3 + [[200.0] * 3 + [100.0] * (WINDOWS - 3)]
LEAKS = [[0] * WINDOWS, [2 * GiB] * 4 + [0] * (WINDOWS - 4),
         [0] * WINDOWS, [0] * WINDOWS]


def _flip_and_recover(pkg: str, accel: str):
    from tests.test_torch_builders import normalize
    from tests.test_torch_controller import Fixture

    constants = importlib.import_module(f"{pkg}.api.v2beta1.constants")
    f = Fixture(pkg, accel, 4)
    f.synced()
    f.set_workers("Running")
    f.sync()
    records = [_worker_records(pkg, P50S[i], LEAKS[i]) for i in range(4)]
    seen = []
    for window in range(WINDOWS):
        for i, (beats, mems) in enumerate(records):
            pod = f.api.get("pods", "default", f"test-job-worker-{i}")
            notes = pod["metadata"].setdefault("annotations", {})
            notes[constants.STEP_HEARTBEAT_ANNOTATION] = json.dumps(
                beats[window], sort_keys=True)
            notes[constants.DEVICE_MEMORY_ANNOTATION] = json.dumps(
                mems[window], sort_keys=True)
            f.api.update("pods", pod)
        f.sync()
        job = f.get_job()
        seen.append(sorted((c.type, c.status, c.reason)
                           for c in job.status.conditions
                           if c.type in ("Straggling", "MemoryPressure")))
    names = {accel: "<accel>",
             f.s.topology.resolve(accel).topology: "<topology>"}
    return seen, normalize(f.snapshot(), names, {})


def test_conditions_flip_and_recover_as_the_jax_controllers():
    """The port's telemetry records of a 2x worker and a leaking one,
    patched onto the pods window by window as the runner patches them:
    Straggling flips at window 2 and recovers at window 3, MemoryPressure
    flips at window 2 and recovers once the trend over the last 8
    windows is flat; the JAX controller fed its own records does the
    same, object for object."""
    port_seen, port = _flip_and_recover(
        "mpi_operator_tpu_torch", "h100-4")
    jax_seen, jax = _flip_and_recover("mpi_operator_tpu", "v5e-16")
    assert port == jax and port_seen == jax_seen
    straggling = [dict((t, (st, r)) for t, st, r in w).get("Straggling")
                  for w in port_seen]
    pressure = [dict((t, (st, r)) for t, st, r in w).get("MemoryPressure")
                for w in port_seen]
    assert straggling[:2] == [None, None]
    assert straggling[2] == ("True", "TPUJobStraggling")
    assert straggling[3:] == [("False", "TPUJobStragglerRecovered")] * (
        WINDOWS - 3)
    assert pressure[:2] == [None, None]
    assert pressure[2] == ("True", "TPUJobMemoryPressure")
    recovered = pressure.index(("False", "TPUJobMemoryRecovered"))
    assert all(p == ("True", "TPUJobMemoryPressure")
               for p in pressure[2:recovered])
    assert set(pressure[recovered:]) == {("False", "TPUJobMemoryRecovered")}


# -- through the port's operator ----------------------------------------------

def replica_main(argv_json: str, release: str = "") -> int:
    """A replica pod: ``cmd.train`` on its own (the world env dropped),
    device-memory samples from a 16 GiB ``FakeMemoryBackend``. With
    ``release``, the pod stays up after its steps until that file
    exists, as the workers of a longer job would."""
    from mpi_operator_tpu_torch.cmd import train
    from mpi_operator_tpu_torch.utils import devstats

    for key in WORLD_ENV:
        os.environ.pop(key, None)
    devstats.DeviceMemorySampler = functools.partial(
        devstats.DeviceMemorySampler, backend=devstats.FakeMemoryBackend())
    rc = train.main(json.loads(argv_json))
    deadline = time.time() + RELEASE_TIMEOUT_S
    while release and not os.path.exists(release):
        if time.time() > deadline:
            return 1
        time.sleep(0.05)
    return rc


RELEASE_TIMEOUT_S = 300


REPLICAS = 3
# Draws of random.Random(0): slow worker-0 (rate 1), leak worker-1 (its
# draw 0.42 < 0.5 after worker-0's 0.76), kill all three (rate 1).
CHAOS_SEED = 0
# 3x, windows of 3 steps (their p50 the middle one): three workers
# sharing a loaded CPU jitter; the detector needs 3 of the 4 windows
# above 1.5x the median.
SLOWDOWN = 3.0


def _job(name: str, steps: int = 13, heartbeat_every: int = 3,
         release: str = "") -> dict:
    argv = ["--device", "cpu", *TINY, "--steps", str(steps), "--warmup", "1",
            "--heartbeat-every", str(heartbeat_every)]
    return {
        "apiVersion": "kubeflow.org/v2beta1", "kind": "TPUJob",
        "metadata": {"name": name, "namespace": "default"},
        "spec": {
            "tpu": {"acceleratorType": f"h100-{REPLICAS}"},
            "runPolicy": {
                "cleanPodPolicy": "None", "backoffLimit": 0,
                "podFailurePolicy": {"rules": [{
                    "action": "Ignore",
                    "onExitCodes": {"operator": "In", "values": [137]}}]}},
            "tpuReplicaSpecs": {"Worker": {
                "replicas": REPLICAS, "restartPolicy": "Never",
                "template": {"spec": {"containers": [{
                    "name": "replica", "image": "local",
                    "command": ["python", "-m", "tests.test_torch_observe",
                                json.dumps(argv),
                                *([release] if release else [])]}]}}}},
        },
    }


def _wait(predicate, timeout: float, what: str):
    deadline = time.time() + timeout
    while time.time() < deadline:
        got = predicate()
        if got:
            return got
        time.sleep(0.05)
    raise AssertionError(f"timed out waiting for {what}")


@pytest.mark.e2e
def test_chaos_flips_straggling_and_memory_pressure_through_the_operator():
    from mpi_operator_tpu_torch import chaos
    from mpi_operator_tpu_torch.api.v2beta1.types import (
        JOB_MEMORY_PRESSURE, JOB_STRAGGLING)
    from mpi_operator_tpu_torch.controller import status as st
    from mpi_operator_tpu_torch.controller.tpu_job_controller import (
        TPUJobController)
    from mpi_operator_tpu_torch.runtime.apiserver import InMemoryAPIServer
    from mpi_operator_tpu_torch.runtime.podrunner import LocalPodRunner
    from mpi_operator_tpu_torch.utils import devstats, flightrecorder, stepstats

    api = InMemoryAPIServer()
    recorder = flightrecorder.FlightRecorder()
    steps = stepstats.StepMatrix(recorder)
    memory = devstats.MemoryMatrix(recorder)
    controller = TPUJobController(api, flight_recorder=recorder,
                                  step_matrix=steps, memory_matrix=memory)
    runner = LocalPodRunner(api, workdir=str(REPO_ROOT), cuda_devices=0,
                            base_env={"OMP_NUM_THREADS": "1"},
                            flight_recorder=recorder)
    engine = chaos.ChaosEngine(chaos.ChaosPolicy(
        seed=CHAOS_SEED,
        slow=(chaos.SlowWorkerChaos(slow_rate=1.0, factor=SLOWDOWN,
                                    max_slow=1),),
        leak=(chaos.MemoryLeakChaos(leak_rate=0.5, bytes_per_window=2 * GiB,
                                    max_leak=1),),
        pods=(chaos.PodChaos(kill_rate=1.0, max_kills=REPLICAS),)))
    injectors = [chaos.WorkerSlower(engine, api, runner, recorder),
                 chaos.LeakInjector(engine, api, runner, recorder),
                 chaos.PodKiller(engine, api, runner)]
    stop = threading.Event()
    thread = threading.Thread(
        target=lambda: controller.run(threadiness=2, stop=stop), daemon=True)
    thread.start()
    runner.start()
    try:
        api.create("tpujobs", _job("replicas"))

        def running():
            pods = api.list("pods", "default")
            return len(pods) == REPLICAS and all(
                (p.get("status") or {}).get("phase") == "Running"
                for p in pods)

        _wait(running, 60, "the replicas to run")
        assert [inj.tick() for inj in injectors] == [1, 1, REPLICAS]
        assert engine.timeline() == [
            ("slow_worker", "pod default/replicas-worker-0",
             f"factor={SLOWDOWN}"),
            ("mem_leak", "pod default/replicas-worker-1",
             f"bytes_per_window={2 * GiB}"),
            *[("pod_kill", f"pod default/replicas-worker-{i}", "")
              for i in range(REPLICAS)]]

        def finished():
            job = api.get("tpujobs", "default", "replicas")
            conds = {c["type"]: c for c in
                     (job.get("status") or {}).get("conditions") or []}
            done = [c for t, c in conds.items()
                    if t in ("Succeeded", "Failed") and c["status"] == "True"]
            return (done[0], conds) if done else None

        done, conds = _wait(finished, 120, "the replicas job to finish")
        assert done["type"] == "Succeeded", done
    finally:
        stop.set()
        runner.stop()
        thread.join(timeout=10)

    straggling = conds[JOB_STRAGGLING]
    assert straggling["status"] == "True"
    assert straggling["reason"] == st.TPUJOB_STRAGGLING_REASON
    assert "straggling worker(s) 0" in straggling["message"]
    pressure = conds[JOB_MEMORY_PRESSURE]
    assert pressure["status"] == "True"
    assert pressure["reason"] == st.TPUJOB_MEMORY_PRESSURE_REASON
    assert "worker 1" in pressure["message"]
    # The matrices joined the replacements' heartbeats: worker 0 slowest,
    # worker 1's reported bytes climbing 2 GiB a window.
    snap = steps.job_snapshot("default", "replicas")
    assert len(snap["windows"]) == 4, snap
    assert sum(w["skew_ratio"] > 1.5 and w["slowest_worker"] == "0"
               for w in snap["windows"]) >= 3, snap
    mem = memory.job_snapshot("default", "replicas")
    tops = [(w["top_worker"], w["hbm_bytes_in_use"]) for w in mem["windows"]]
    assert [t for t, _ in tops[:3]] == ["1"] * 3
    assert tops[2][1] - tops[1][1] == 2 * GiB
    # The kills were the preemption signature under an Ignore rule: each
    # pod was replaced without charging the restart budget.
    job = api.get("tpujobs", "default", "replicas")
    assert job["status"]["replicaStatuses"]["Worker"].get("restarts", 0) == 0
    kinds = [e["kind"] for e in recorder.timeline("default", "replicas")]
    assert "slow_worker" in kinds and "mem_leak" in kinds


if __name__ == "__main__":
    sys.exit(replica_main(*sys.argv[1:]))
