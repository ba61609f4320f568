"""Fault policies for the chaos harness (the port's copy of
``mpi_operator_tpu/chaos/policy.py``).

Everything here is declarative and immutable: a ``ChaosPolicy`` is a full
description of one chaos run (which verbs flake, how the watch streams
misbehave, which pods die) plus the seed that makes the run replayable.
The engine (``chaos/engine.py``) interprets the policy; the wrappers
(``chaos/apiserver.py``, ``chaos/podchaos.py``) apply it.

Reference analogs: kube-apiserver's ``APIServerTracing`` fault-injection
test shims and chaos-mesh's PodChaos/NetworkChaos CRDs, collapsed to the
three fault surfaces this operator actually exercises — apiserver verbs,
watch streams, and pod/node lifetime.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from ..api.v2beta1.constants import ROLE_LAUNCHER, ROLE_WORKER

# Verbs that mutate state; fault injection on these models write races
# (conflicts) and apiserver hiccups (500s/timeouts).
WRITE_VERBS = ("create", "update", "update_status", "delete")
READ_VERBS = ("get", "list")


def _check_rate(name: str, value: float) -> None:
    if not 0.0 <= value <= 1.0:
        raise ValueError(f"{name} must be in [0, 1], got {value!r}")


@dataclass(frozen=True)
class VerbFaults:
    """Per-call fault rates for apiserver verbs.

    Exactly one uniform draw decides each call's fate, partitioned
    conflict → server error → timeout, so rates are mutually exclusive
    and their sum is the per-call fault probability.
    """

    conflict_rate: float = 0.0
    server_error_rate: float = 0.0
    timeout_rate: float = 0.0
    verbs: tuple[str, ...] = WRITE_VERBS
    resources: tuple[str, ...] = ()  # () = every resource

    def __post_init__(self) -> None:
        _check_rate("conflict_rate", self.conflict_rate)
        _check_rate("server_error_rate", self.server_error_rate)
        _check_rate("timeout_rate", self.timeout_rate)
        if self.total_rate > 1.0:
            raise ValueError(
                f"fault rates sum to {self.total_rate}, must be <= 1"
            )

    @property
    def total_rate(self) -> float:
        return self.conflict_rate + self.server_error_rate + self.timeout_rate

    def applies(self, verb: str, resource: str) -> bool:
        if verb not in self.verbs:
            return False
        return not self.resources or resource in self.resources


@dataclass(frozen=True)
class WatchFaults:
    """Per-event fault rates for watch streams.

    ``drop`` loses the event (a lossy stream the informer can only heal
    by resync), ``delay`` re-delivers it ``delay_rounds`` drains later
    (out-of-order delivery), ``gone`` compacts the stream — everything
    buffered is lost and the drain raises 410 Gone, forcing a relist.
    """

    drop_rate: float = 0.0
    delay_rate: float = 0.0
    gone_rate: float = 0.0
    delay_rounds: int = 2
    resources: tuple[str, ...] = ()  # () = every resource

    def __post_init__(self) -> None:
        _check_rate("drop_rate", self.drop_rate)
        _check_rate("delay_rate", self.delay_rate)
        _check_rate("gone_rate", self.gone_rate)
        if self.drop_rate + self.delay_rate + self.gone_rate > 1.0:
            raise ValueError("watch fault rates must sum to <= 1")
        if self.delay_rounds < 1:
            raise ValueError("delay_rounds must be >= 1")

    def applies(self, resource: str) -> bool:
        return not self.resources or resource in self.resources


@dataclass(frozen=True)
class PodChaos:
    """Random pod kills and node deaths.

    ``kill_rate`` SIGKILLs the pod's process — the reaper classifies it
    like any crash and surfaces exit code 137, the preemption signature
    a ``podFailurePolicy`` rule can match.  ``node_death_rate``
    rips the pod out from under the runner and flips its phase to
    ``Failed`` with ``status.reason=NodeLost`` (no exit code), the shape
    an ``onPodConditions``-style reason rule matches.
    """

    kill_rate: float = 0.0
    node_death_rate: float = 0.0
    roles: tuple[str, ...] = (ROLE_WORKER, ROLE_LAUNCHER)
    namespace: str = ""  # "" = every namespace
    max_kills: int = 0  # 0 = unlimited

    def __post_init__(self) -> None:
        _check_rate("kill_rate", self.kill_rate)
        _check_rate("node_death_rate", self.node_death_rate)
        if self.kill_rate + self.node_death_rate > 1.0:
            raise ValueError("pod chaos rates must sum to <= 1")


@dataclass(frozen=True)
class SlowWorkerChaos:
    """Degraded-host injection: a matching running worker is slowed by
    ``factor`` (its step wall time stretched, optimization math intact).

    Models the straggler failure mode the step-skew observatory
    (utils/stepstats.py) exists to catch — a host that keeps making
    progress, just slower than the gang, which pod-phase chaos can never
    produce.  ``factor`` multiplies the worker's step clock: 1.0 is a
    no-op (useful as the bench's control arm), 2.0 halves its step rate.
    """

    slow_rate: float = 0.0
    factor: float = 2.0
    roles: tuple[str, ...] = (ROLE_WORKER,)
    namespace: str = ""  # "" = every namespace
    max_slow: int = 0  # 0 = unlimited

    def __post_init__(self) -> None:
        _check_rate("slow_rate", self.slow_rate)
        if self.factor < 1.0:
            raise ValueError(
                f"factor must be >= 1 (a speed-up is not chaos), "
                f"got {self.factor!r}"
            )


@dataclass(frozen=True)
class MemoryLeakChaos:
    """Leaking-worker injection: a matching running worker's *reported*
    HBM grows by ``bytes_per_window`` every telemetry window.

    Models the slow-burn memory leak the device-memory observatory
    (utils/devstats.py; on the GPU ``torch.cuda.memory_stats``) exists to
    catch early — a watermark that climbs
    for many windows before the OOM killer fires, which pod-phase chaos
    can never produce.  ``bytes_per_window=0`` is a no-op (useful as the
    bench's control arm).
    """

    leak_rate: float = 0.0
    bytes_per_window: int = 0
    roles: tuple[str, ...] = (ROLE_WORKER,)
    namespace: str = ""  # "" = every namespace
    max_leak: int = 0  # 0 = unlimited

    def __post_init__(self) -> None:
        _check_rate("leak_rate", self.leak_rate)
        if self.bytes_per_window < 0:
            raise ValueError(
                f"bytes_per_window must be >= 0 (memory un-leaking is "
                f"not chaos), got {self.bytes_per_window!r}"
            )


@dataclass(frozen=True)
class TornWriteChaos:
    """Torn-checkpoint injection: a matching running worker's *next*
    checkpoint commit is torn — the step data reaches disk but the commit
    marker never lands — and the worker is killed at that moment.

    Models the exact death window the commit-marker protocol
    (utils/checkpoint.py, DCP step directories) exists to survive: a preemption between the
    fsync of the checkpoint payload and the atomic rename that publishes
    it.  Restore must skip the uncommitted newest step and fall back to
    an older committed one, not crash on (or worse, trust) a torn write.
    """

    torn_rate: float = 0.0
    roles: tuple[str, ...] = (ROLE_WORKER,)
    namespace: str = ""  # "" = every namespace
    max_torn: int = 0  # 0 = unlimited

    def __post_init__(self) -> None:
        _check_rate("torn_rate", self.torn_rate)
        if self.max_torn < 0:
            raise ValueError(
                f"max_torn must be >= 0, got {self.max_torn!r}"
            )


@dataclass(frozen=True)
class ChaosPolicy:
    """One replayable chaos run: seed + the active fault policies."""

    seed: int = 0
    verbs: tuple[VerbFaults, ...] = ()
    watch: Optional[WatchFaults] = None
    pods: tuple[PodChaos, ...] = ()
    slow: tuple[SlowWorkerChaos, ...] = ()
    leak: tuple[MemoryLeakChaos, ...] = ()
    torn: tuple[TornWriteChaos, ...] = ()

    def verb_policy(self, verb: str, resource: str) -> Optional[VerbFaults]:
        """First policy matching (verb, resource); None = no faults."""
        for policy in self.verbs:
            if policy.applies(verb, resource):
                return policy
        return None
