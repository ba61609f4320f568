"""Seeded chaos engine: one RNG, one ordered event log, one decision
point per fault surface (the port's copy of
``mpi_operator_tpu/chaos/engine.py``; the draws, their order and the
event log are the JAX package's, so one seed gives both packages one
fault timeline).

Determinism contract: every fault decision consumes exactly one draw
from a single ``random.Random(seed)``, and every *injected* fault is
appended to an ordered event log.  Given the same policy and the same
sequence of decision calls (e.g. a single-threaded, manually-pumped
stack), the same seed therefore reproduces the identical fault sequence
— the property the soak test asserts, and the property that makes a
failing chaos run replayable from its seed alone.  Under free-running
threads the per-call *order* is up to the OS scheduler, but the invariant
suite (convergence, no leaks, ledger balance) holds for every
interleaving.
"""

from __future__ import annotations

import random
from dataclasses import dataclass
from typing import Optional

from ..runtime.apiserver import (
    ApiError,
    ConflictError,
    ServerError,
    ServerTimeoutError,
)
from ..runtime import locktrace
from ..utils.metrics import Registry, new_counter
from .policy import (
    ChaosPolicy,
    MemoryLeakChaos,
    PodChaos,
    SlowWorkerChaos,
    TornWriteChaos,
)

# Fault kinds (event-log / metric label vocabulary).
CONFLICT = "conflict"
SERVER_ERROR = "server_error"
TIMEOUT = "timeout"
WATCH_DROP = "watch_drop"
WATCH_DELAY = "watch_delay"
WATCH_GONE = "watch_gone"
POD_KILL = "pod_kill"
NODE_DEATH = "node_death"
SLOW_WORKER = "slow_worker"
MEM_LEAK = "mem_leak"
TORN_WRITE = "torn_write"


@dataclass(frozen=True)
class ChaosEvent:
    seq: int
    kind: str
    target: str  # e.g. "update pods/ns/train-worker-0"
    detail: str = ""


class ChaosEngine:
    """Interprets a ChaosPolicy with a seeded RNG and logs what it did."""

    def __init__(
        self,
        policy: ChaosPolicy,
        registry: Optional[Registry] = None,
    ):
        self.policy = policy
        self.seed = policy.seed
        self._rng = random.Random(policy.seed)
        self._lock = locktrace.lock("chaos.engine")
        self._events: list[ChaosEvent] = []
        self._kill_counts: dict[int, int] = {}
        self._slow_counts: dict[int, int] = {}
        self._leak_counts: dict[int, int] = {}
        self._torn_counts: dict[int, int] = {}
        self.faults_total = new_counter(
            "tpu_operator_chaos_faults_injected_total",
            "Faults injected by the chaos engine, by kind.",
            ("kind",),
            registry=registry,
        )
        self.pod_kills_total = new_counter(
            "tpu_operator_chaos_pod_kills_total",
            "Pods killed by the chaos engine, by mode (pod_kill|node_death).",
            ("mode",),
            registry=registry,
        )
        self.pod_slowdowns_total = new_counter(
            "tpu_operator_chaos_pod_slowdowns_total",
            "Workers degraded by the chaos engine (SlowWorker faults).",
            registry=registry,
        )
        self.pod_leaks_total = new_counter(
            "tpu_operator_chaos_pod_leaks_total",
            "Workers given an injected HBM leak by the chaos engine "
            "(MemoryLeak faults).",
            registry=registry,
        )
        self.pod_torn_writes_total = new_counter(
            "tpu_operator_chaos_pod_torn_writes_total",
            "Workers killed mid-checkpoint-commit by the chaos engine "
            "(TornWrite faults: step data persisted, commit marker "
            "withheld).",
            registry=registry,
        )

    # -- event log -------------------------------------------------------

    def record(self, kind: str, target: str, detail: str = "") -> ChaosEvent:
        with self._lock:
            event = ChaosEvent(len(self._events), kind, target, detail)
            self._events.append(event)
        self.faults_total.inc(1.0, kind)
        return event

    def events(self) -> tuple[ChaosEvent, ...]:
        with self._lock:
            return tuple(self._events)

    def timeline(self) -> list[tuple[str, str, str]]:
        """(kind, target, detail) triples in injection order — the stable
        comparison form for same-seed replay assertions."""
        return [(e.kind, e.target, e.detail) for e in self.events()]

    def roll(self) -> float:
        with self._lock:
            return self._rng.random()

    # -- apiserver verbs -------------------------------------------------

    def fault_for(
        self, verb: str, resource: str, name: str
    ) -> Optional[ApiError]:
        """Decide one verb call's fate; return the error to raise (already
        recorded) or None.  Consumes exactly one draw when a policy
        matches, zero otherwise."""
        policy = self.policy.verb_policy(verb, resource)
        if policy is None or policy.total_rate <= 0.0:
            return None
        r = self.roll()
        target = f"{verb} {resource}/{name}"
        if r < policy.conflict_rate:
            self.record(CONFLICT, target)
            return ConflictError(resource, name, "chaos: injected conflict")
        r -= policy.conflict_rate
        if r < policy.server_error_rate:
            self.record(SERVER_ERROR, target)
            return ServerError(resource, name, "chaos: injected 500")
        r -= policy.server_error_rate
        if r < policy.timeout_rate:
            self.record(TIMEOUT, target)
            return ServerTimeoutError(resource, name, "chaos: injected timeout")
        return None

    # -- watch streams ---------------------------------------------------

    def watch_fault(self, resource: str, key: str) -> Optional[str]:
        """Decide one watch event's fate: WATCH_DROP, WATCH_DELAY,
        WATCH_GONE, or None (deliver normally)."""
        watch = self.policy.watch
        if watch is None or not watch.applies(resource):
            return None
        r = self.roll()
        target = f"watch {resource}/{key}"
        if r < watch.gone_rate:
            self.record(WATCH_GONE, target)
            return WATCH_GONE
        r -= watch.gone_rate
        if r < watch.drop_rate:
            self.record(WATCH_DROP, target)
            return WATCH_DROP
        r -= watch.drop_rate
        if r < watch.delay_rate:
            self.record(WATCH_DELAY, target, f"rounds={watch.delay_rounds}")
            return WATCH_DELAY
        return None

    # -- pod / node chaos ------------------------------------------------

    def pod_fault(self, policy_index: int, policy: PodChaos) -> Optional[str]:
        """Decide one (policy, pod, tick)'s fate: POD_KILL, NODE_DEATH, or
        None.  A confirmed kill must be reported via confirm_kill so the
        max_kills budget counts only kills that actually landed."""
        if policy.kill_rate <= 0.0 and policy.node_death_rate <= 0.0:
            return None
        if policy.max_kills:
            with self._lock:
                if self._kill_counts.get(policy_index, 0) >= policy.max_kills:
                    return None
        r = self.roll()
        if r < policy.kill_rate:
            return POD_KILL
        if r < policy.kill_rate + policy.node_death_rate:
            return NODE_DEATH
        return None

    def confirm_kill(self, policy_index: int, mode: str, key: str) -> None:
        with self._lock:
            self._kill_counts[policy_index] = (
                self._kill_counts.get(policy_index, 0) + 1
            )
        self.record(mode, f"pod {key}")
        self.pod_kills_total.inc(1.0, mode)

    # -- slow workers ----------------------------------------------------

    def slow_fault(
        self, policy_index: int, policy: SlowWorkerChaos
    ) -> bool:
        """Decide one (policy, pod, tick)'s fate: slow the worker or not.
        One draw per decision (the determinism contract); a landed
        slowdown must be reported via confirm_slow so the max_slow budget
        counts only victims that actually degraded."""
        if policy.slow_rate <= 0.0:
            return False
        if policy.max_slow:
            with self._lock:
                if (
                    self._slow_counts.get(policy_index, 0)
                    >= policy.max_slow
                ):
                    return False
        return self.roll() < policy.slow_rate

    def confirm_slow(
        self, policy_index: int, key: str, factor: float
    ) -> None:
        with self._lock:
            self._slow_counts[policy_index] = (
                self._slow_counts.get(policy_index, 0) + 1
            )
        self.record(SLOW_WORKER, f"pod {key}", f"factor={factor}")
        self.pod_slowdowns_total.inc(1.0)

    # -- leaking workers -------------------------------------------------

    def leak_fault(
        self, policy_index: int, policy: MemoryLeakChaos
    ) -> bool:
        """Decide one (policy, pod, tick)'s fate: give the worker an
        injected HBM leak or not.  One draw per decision (the
        determinism contract); a landed leak must be reported via
        confirm_leak so the max_leak budget counts only victims that
        actually started leaking."""
        if policy.leak_rate <= 0.0:
            return False
        if policy.max_leak:
            with self._lock:
                if (
                    self._leak_counts.get(policy_index, 0)
                    >= policy.max_leak
                ):
                    return False
        return self.roll() < policy.leak_rate

    def confirm_leak(
        self, policy_index: int, key: str, bytes_per_window: int
    ) -> None:
        with self._lock:
            self._leak_counts[policy_index] = (
                self._leak_counts.get(policy_index, 0) + 1
            )
        self.record(
            MEM_LEAK, f"pod {key}", f"bytes_per_window={bytes_per_window}"
        )
        self.pod_leaks_total.inc(1.0)

    # -- torn checkpoint commits -----------------------------------------

    def torn_fault(
        self, policy_index: int, policy: TornWriteChaos
    ) -> bool:
        """Decide one (policy, pod, tick)'s fate: tear the worker's next
        checkpoint commit or not.  One draw per decision (the determinism
        contract); a landed tear must be reported via confirm_torn so the
        max_torn budget counts only victims that actually got armed."""
        if policy.torn_rate <= 0.0:
            return False
        if policy.max_torn:
            with self._lock:
                if (
                    self._torn_counts.get(policy_index, 0)
                    >= policy.max_torn
                ):
                    return False
        return self.roll() < policy.torn_rate

    def confirm_torn(self, policy_index: int, key: str) -> None:
        with self._lock:
            self._torn_counts[policy_index] = (
                self._torn_counts.get(policy_index, 0) + 1
            )
        self.record(TORN_WRITE, f"pod {key}")
        self.pod_torn_writes_total.inc(1.0)
