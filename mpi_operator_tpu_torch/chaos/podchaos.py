"""Pod- and node-level chaos against the LocalPodRunner (the port's copy
of ``mpi_operator_tpu/chaos/podchaos.py``: every fault lands through the
port runner's hooks, which hand it to the GPU worker's env at its next
(re)start).

``PodKiller.tick()`` is one chaos round: every running pod matching an
active ``PodChaos`` policy gets one seeded draw deciding whether it is
SIGKILLed (preemption signature, exit code 137) or loses its node
(phase=Failed with ``status.reason=NodeLost``, no exit code).  The caller
paces ticks — a thread in a live soak, explicit calls in a deterministic
replay.
"""

from __future__ import annotations

import threading

from ..api.v2beta1.constants import JOB_NAME_LABEL, JOB_ROLE_LABEL
from ..runtime.apiserver import InMemoryAPIServer
from .engine import (
    MEM_LEAK,
    NODE_DEATH,
    POD_KILL,
    SLOW_WORKER,
    TORN_WRITE,
    ChaosEngine,
)

__all__ = ["LeakInjector", "PodKiller", "TornWriteInjector", "WorkerSlower"]


def _record_fault(
    recorder, pod_meta: dict, kind: str, detail: str
) -> None:
    """Land a chaos fault on the victim job's flight-recorder timeline
    (kinds ``slow_worker``/``mem_leak``), so a postmortem shows the
    injection alongside the conditions it provoked.  No-op without a
    recorder or when the pod carries no job label."""
    if recorder is None:
        return
    labels = pod_meta.get("labels") or {}
    job = labels.get(JOB_NAME_LABEL)
    if not job:
        return
    recorder.record(
        pod_meta.get("namespace", ""),
        job,
        kind,
        reason="ChaosInjected",
        message=f"pod {pod_meta.get('name', '')}: {detail}",
        pod=pod_meta.get("name", ""),
    )


class PodKiller:
    def __init__(self, engine: ChaosEngine, api: InMemoryAPIServer, runner):
        # List against the raw server: the killer is the chaos, it should
        # not itself be a victim of injected read faults.
        self._engine = engine
        self._api = getattr(api, "inner", api)
        self._runner = runner
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def tick(self) -> int:
        """One chaos round; returns the number of kills that landed."""
        kills = 0
        for index, policy in enumerate(self._engine.policy.pods):
            if policy.kill_rate <= 0.0 and policy.node_death_rate <= 0.0:
                continue
            pods = self._api.list("pods", policy.namespace or None)
            for pod in pods:
                if (pod.get("status") or {}).get("phase") != "Running":
                    continue
                meta = pod.get("metadata") or {}
                labels = meta.get("labels") or {}
                role = labels.get(JOB_ROLE_LABEL, "")
                if policy.roles and role not in policy.roles:
                    continue
                mode = self._engine.pod_fault(index, policy)
                if mode is None:
                    continue
                namespace = meta.get("namespace", "")
                name = meta.get("name", "")
                if mode == POD_KILL:
                    landed = self._runner.kill_pod(namespace, name)
                elif mode == NODE_DEATH:
                    landed = self._runner.fail_node(namespace, name)
                else:  # pragma: no cover - engine vocabulary is closed
                    landed = False
                if landed:
                    self._engine.confirm_kill(
                        index, mode, f"{namespace}/{name}"
                    )
                    kills += 1
        return kills

    # -- background pacing (live soaks) ---------------------------------

    def start(self, interval: float = 0.05) -> None:
        if self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, args=(interval,), daemon=True,
            name="chaos-podkiller",
        )
        self._thread.start()

    def _loop(self, interval: float) -> None:
        while not self._stop.is_set():
            self.tick()
            self._stop.wait(interval)

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None


class WorkerSlower:
    """SlowWorker chaos: each tick gives every matching running worker
    one seeded draw deciding whether it becomes a degraded host
    (``runner.slow_worker``, which stretches the victim's step clock by
    the policy's factor at its next (re)start).  Already-slowed victims
    are skipped — a straggler stays one straggler, not a compounding
    slowdown.  Same pacing contract as PodKiller: a thread in live
    soaks, explicit ``tick()`` calls in deterministic replays.

    With a flight recorder wired, every landed slowdown also lands on
    the victim job's timeline as a ``slow_worker`` entry.
    """

    def __init__(
        self,
        engine: ChaosEngine,
        api: InMemoryAPIServer,
        runner,
        flight_recorder=None,
    ):
        self._engine = engine
        self._api = getattr(api, "inner", api)
        self._runner = runner
        self._recorder = flight_recorder
        self._slowed: set[tuple[str, str]] = set()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def tick(self) -> int:
        """One chaos round; returns the number of slowdowns that landed."""
        slowed = 0
        for index, policy in enumerate(self._engine.policy.slow):
            if policy.slow_rate <= 0.0:
                continue
            pods = self._api.list("pods", policy.namespace or None)
            for pod in pods:
                if (pod.get("status") or {}).get("phase") != "Running":
                    continue
                meta = pod.get("metadata") or {}
                labels = meta.get("labels") or {}
                role = labels.get(JOB_ROLE_LABEL, "")
                if policy.roles and role not in policy.roles:
                    continue
                key = (meta.get("namespace", ""), meta.get("name", ""))
                if key in self._slowed:
                    continue
                if not self._engine.slow_fault(index, policy):
                    continue
                if self._runner.slow_worker(key[0], key[1], policy.factor):
                    self._slowed.add(key)
                    self._engine.confirm_slow(
                        index, f"{key[0]}/{key[1]}", policy.factor
                    )
                    _record_fault(
                        self._recorder, meta, SLOW_WORKER,
                        f"slowed by factor={policy.factor}",
                    )
                    slowed += 1
        return slowed

    # -- background pacing (live soaks) ---------------------------------

    def start(self, interval: float = 0.05) -> None:
        if self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, args=(interval,), daemon=True,
            name="chaos-workerslower",
        )
        self._thread.start()

    def _loop(self, interval: float) -> None:
        while not self._stop.is_set():
            self.tick()
            self._stop.wait(interval)

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None


class TornWriteInjector:
    """TornWrite chaos: each tick gives every matching running worker one
    seeded draw deciding whether it dies mid-checkpoint-commit.  A landed
    fault arms a one-shot torn commit (``runner.tear_write``: at the
    victim's next (re)start its writer persists the step data but
    withholds the commit marker) and then SIGKILLs the current process
    (``runner.kill_pod``, exit 137 — the preemption signature), so the
    replacement worker both produces the torn write and later has to
    restore around one.  Same pacing contract as PodKiller: a thread in
    live soaks, explicit ``tick()`` calls in deterministic replays.

    With a flight recorder wired, every landed tear also lands on the
    victim job's timeline as a ``torn_write`` entry.
    """

    def __init__(
        self,
        engine: ChaosEngine,
        api: InMemoryAPIServer,
        runner,
        flight_recorder=None,
    ):
        self._engine = engine
        self._api = getattr(api, "inner", api)
        self._runner = runner
        self._recorder = flight_recorder
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def tick(self) -> int:
        """One chaos round; returns the number of tears that landed."""
        torn = 0
        for index, policy in enumerate(self._engine.policy.torn):
            if policy.torn_rate <= 0.0:
                continue
            pods = self._api.list("pods", policy.namespace or None)
            for pod in pods:
                if (pod.get("status") or {}).get("phase") != "Running":
                    continue
                meta = pod.get("metadata") or {}
                labels = meta.get("labels") or {}
                role = labels.get(JOB_ROLE_LABEL, "")
                if policy.roles and role not in policy.roles:
                    continue
                key = (meta.get("namespace", ""), meta.get("name", ""))
                if not self._engine.torn_fault(index, policy):
                    continue
                if self._runner.tear_write(key[0], key[1]):
                    # Kill after arming: the death is the fault being
                    # modelled; the armed tear reaches the replacement.
                    self._runner.kill_pod(key[0], key[1])
                    self._engine.confirm_torn(index, f"{key[0]}/{key[1]}")
                    _record_fault(
                        self._recorder, meta, TORN_WRITE,
                        "killed mid-commit (marker withheld)",
                    )
                    torn += 1
        return torn

    # -- background pacing (live soaks) ---------------------------------

    def start(self, interval: float = 0.05) -> None:
        if self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, args=(interval,), daemon=True,
            name="chaos-tornwriteinjector",
        )
        self._thread.start()

    def _loop(self, interval: float) -> None:
        while not self._stop.is_set():
            self.tick()
            self._stop.wait(interval)

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None


class LeakInjector:
    """MemoryLeak chaos: each tick gives every matching running worker
    one seeded draw deciding whether its reported HBM starts growing by
    the policy's per-window increment (``runner.leak_worker``, which
    injects TPU_MEM_LEAK_BYTES at the victim's next (re)start).
    Already-leaking victims are skipped — one leak per victim, not a
    compounding one.  Same pacing contract as PodKiller: a thread in
    live soaks, explicit ``tick()`` calls in deterministic replays.

    With a flight recorder wired, every landed leak also lands on the
    victim job's timeline as a ``mem_leak`` entry.
    """

    def __init__(
        self,
        engine: ChaosEngine,
        api: InMemoryAPIServer,
        runner,
        flight_recorder=None,
    ):
        self._engine = engine
        self._api = getattr(api, "inner", api)
        self._runner = runner
        self._recorder = flight_recorder
        self._leaked: set[tuple[str, str]] = set()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def tick(self) -> int:
        """One chaos round; returns the number of leaks that landed."""
        leaked = 0
        for index, policy in enumerate(self._engine.policy.leak):
            if policy.leak_rate <= 0.0 or policy.bytes_per_window <= 0:
                continue
            pods = self._api.list("pods", policy.namespace or None)
            for pod in pods:
                if (pod.get("status") or {}).get("phase") != "Running":
                    continue
                meta = pod.get("metadata") or {}
                labels = meta.get("labels") or {}
                role = labels.get(JOB_ROLE_LABEL, "")
                if policy.roles and role not in policy.roles:
                    continue
                key = (meta.get("namespace", ""), meta.get("name", ""))
                if key in self._leaked:
                    continue
                if not self._engine.leak_fault(index, policy):
                    continue
                if self._runner.leak_worker(
                    key[0], key[1], policy.bytes_per_window
                ):
                    self._leaked.add(key)
                    self._engine.confirm_leak(
                        index, f"{key[0]}/{key[1]}",
                        policy.bytes_per_window,
                    )
                    _record_fault(
                        self._recorder, meta, MEM_LEAK,
                        f"leaking {policy.bytes_per_window} bytes/window",
                    )
                    leaked += 1
        return leaked

    # -- background pacing (live soaks) ---------------------------------

    def start(self, interval: float = 0.05) -> None:
        if self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, args=(interval,), daemon=True,
            name="chaos-leakinjector",
        )
        self._thread.start()

    def _loop(self, interval: float) -> None:
        while not self._stop.is_set():
            self.tick()
            self._stop.wait(interval)

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
