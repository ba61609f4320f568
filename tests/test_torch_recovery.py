"""A fault that ends, on the CPU, through the port's operator.

A seeded ``ChaosEngine`` slows worker 0 of three replicas 4x and leaks
2 GiB a window on the same worker, killing all three at their start so
the replacements carry the faults. The replicas stay up after their
steps until released, as a longer job's workers would: a job whose other
workers have finished cannot replace a dead one. ``Straggling`` and
``MemoryPressure`` flip when window 2 closes (window 3 on a loaded
machine, where the others can run 4 windows ahead of the slowed worker
and close its window 0 without it). Then the host is repaired
(``LocalPodRunner.heal_worker``) and the worker killed before its next
window:

- the memory matrix lets the dead worker go, so the next window closes
  on clean samples (the others', with the replacement's when it reports
  in time) and ``MemoryPressure`` turns False;
- the step matrix keeps the dead worker's last heartbeat, so the next
  windows wait for the clean replacement (whose earlier windows it drops
  as stale) and ``Straggling`` turns False.

``chip_smoke.py``'s observe phase runs the same sequence on the card.
"""

from __future__ import annotations

import json
import threading

import pytest

from tests.test_torch_observe import GiB, REPLICAS, REPO_ROOT, _job, _wait

pytestmark = pytest.mark.kernel

# random.Random(0)'s first draws land the slowdown and the leak (rate 1,
# one victim each) on worker 0; the kills land on all three.
CHAOS_SEED = 0
# Well above the 1.5x threshold: a loaded machine's step walls jitter.
SLOWDOWN = 4.0
# 5 windows of 12 steps: the slowed worker's next window ends ~36 steps
# after the flip, time enough to end its process before it reports; the
# windows after the flip are the replacement's to clear the conditions.
WINDOW_STEPS = 12
WINDOWS = 5


def _conditions(api, name: str) -> dict:
    job = api.get("tpujobs", "default", name)
    return {c["type"]: c for c in
            (job.get("status") or {}).get("conditions") or []}


@pytest.mark.e2e
def test_conditions_recover_when_the_faulty_worker_is_healed(tmp_path):
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
        leak=(chaos.MemoryLeakChaos(leak_rate=1.0, bytes_per_window=2 * GiB,
                                    max_leak=1),),
        pods=(chaos.PodChaos(kill_rate=1.0, max_kills=REPLICAS),)))
    injectors = [chaos.WorkerSlower(engine, api, runner, recorder),
                 chaos.LeakInjector(engine, api, runner, recorder),
                 chaos.PodKiller(engine, api, runner)]
    release = tmp_path / "release"
    stop = threading.Event()
    thread = threading.Thread(
        target=lambda: controller.run(threadiness=2, stop=stop), daemon=True)
    thread.start()
    runner.start()
    try:
        api.create("tpujobs", _job("healed", steps=1 + WINDOWS * WINDOW_STEPS,
                                   heartbeat_every=WINDOW_STEPS,
                                   release=str(release)))

        def running():
            pods = api.list("pods", "default")
            return len(pods) == REPLICAS and all(
                (p.get("status") or {}).get("phase") == "Running"
                for p in pods)

        _wait(running, 60, "the replicas to run")
        assert [inj.tick() for inj in injectors] == [1, 1, REPLICAS]
        assert engine.timeline()[:2] == [
            ("slow_worker", "pod default/healed-worker-0",
             f"factor={SLOWDOWN}"),
            ("mem_leak", "pod default/healed-worker-0",
             f"bytes_per_window={2 * GiB}")]

        def status_is(value: str):
            def check():
                conds = _conditions(api, "healed")
                return all(conds.get(t, {}).get("status") == value
                           for t in (JOB_STRAGGLING, JOB_MEMORY_PRESSURE))
            return check

        _wait(status_is("True"), 90, "Straggling and MemoryPressure to flip")
        # The host is repaired: the faults end with the process.
        assert runner.heal_worker("default", "healed-worker-0")
        assert runner.kill_pod("default", "healed-worker-0")
        assert not runner.heal_worker("default", "healed-worker-0")
        _wait(status_is("False"), 90, "both conditions to recover")
        release.touch()

        def finished():
            conds = _conditions(api, "healed")
            done = [c for t, c in conds.items()
                    if t in ("Succeeded", "Failed") and c["status"] == "True"]
            return done[0] if done else None

        done = _wait(finished, 60, "the job to finish")
        assert done["type"] == "Succeeded", done
    finally:
        release.touch()
        stop.set()
        runner.stop()
        thread.join(timeout=10)
        # What the matrices joined, shown when the test fails.
        print(json.dumps({"steps": steps.job_snapshot("default", "healed"),
                          "memory": memory.job_snapshot("default", "healed")},
                         indent=1))

    # Each condition went True, then False (a transition two syncs race
    # to write is recorded twice).
    for kind, reasons in (
            (JOB_STRAGGLING, [st.TPUJOB_STRAGGLING_REASON,
                              st.TPUJOB_STRAGGLER_RECOVERED_REASON]),
            (JOB_MEMORY_PRESSURE, [st.TPUJOB_MEMORY_PRESSURE_REASON,
                                   st.TPUJOB_MEMORY_RECOVERED_REASON])):
        changes = [e["reason"] for e in recorder.timeline("default", "healed")
                   if e.get("kind") == "condition" and e.get("type") == kind]
        assert [r for i, r in enumerate(changes)
                if i == 0 or r != changes[i - 1]] == reasons, changes
    # Three windows above 1.5x with worker 0 the slowest flipped
    # Straggling; in the last window, the replacement's, worker 0 is not
    # above it.
    windows = steps.job_snapshot("default", "healed")["windows"]
    slow = [w["window"] for w in windows
            if w["skew_ratio"] > 1.5 and w["slowest_worker"] == "0"]
    assert len(slow) >= 3 and slow[-1] <= 3, windows
    assert windows[-1]["window"] == WINDOWS - 1
    assert (windows[-1]["slowest_worker"] != "0"
            or windows[-1]["skew_ratio"] <= 1.5), windows
    # The leaking worker's reported bytes climbed 2 GiB a window; the
    # last window is clean.
    windows = memory.job_snapshot("default", "healed")["windows"]
    leaks = [w["hbm_bytes_in_use"] for w in windows if w["top_worker"] == "0"
             and w["window"] <= slow[-1]]
    assert len(leaks) >= 2 and leaks[-1] - leaks[-2] == 2 * GiB, windows
    assert windows[-1]["window"] == WINDOWS - 1
    assert windows[-1]["hbm_bytes_in_use"] < leaks[0], windows
    job = api.get("tpujobs", "default", "healed")
    assert job["status"]["replicaStatuses"]["Worker"].get("restarts", 0) == 0
