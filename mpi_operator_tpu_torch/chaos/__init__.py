"""Seeded, deterministic fault injection for the operator stack (the
port's copy of ``mpi_operator_tpu/chaos/``; one ``random.Random(seed)``
draws the same fault timeline in both packages).

The harness wraps the two process-local substrates everything else runs
on — ``runtime.apiserver.InMemoryAPIServer`` and
``runtime.podrunner.LocalPodRunner`` — behind declarative fault policies
driven by one ``random.Random(seed)``, so any chaos run is replayable
from its seed.  Faults reach the GPU workers only through the port
runner's hooks (``kill_pod``, ``slow_worker``, ``leak_worker``,
``tear_write``, ``fail_node``): the step slowdown as
``TPUJOB_CHAOS_STEP_SLOWDOWN`` (``cmd/train.py``), the leak as
``TPU_MEM_LEAK_BYTES`` (``utils/devstats.py``), the torn commit as
``TPUJOB_CHAOS_TORN_WRITE`` (``utils/checkpoint.py``).
"""

from .apiserver import ChaoticAPIServer, ChaoticWatch
from .engine import (
    CONFLICT,
    MEM_LEAK,
    NODE_DEATH,
    POD_KILL,
    SERVER_ERROR,
    SLOW_WORKER,
    TIMEOUT,
    TORN_WRITE,
    WATCH_DELAY,
    WATCH_DROP,
    WATCH_GONE,
    ChaosEngine,
    ChaosEvent,
)
from .podchaos import LeakInjector, PodKiller, TornWriteInjector, WorkerSlower
from .policy import (
    READ_VERBS,
    WRITE_VERBS,
    ChaosPolicy,
    MemoryLeakChaos,
    PodChaos,
    SlowWorkerChaos,
    TornWriteChaos,
    VerbFaults,
    WatchFaults,
)

__all__ = [
    "CONFLICT",
    "MEM_LEAK",
    "NODE_DEATH",
    "POD_KILL",
    "READ_VERBS",
    "SERVER_ERROR",
    "SLOW_WORKER",
    "TIMEOUT",
    "TORN_WRITE",
    "WATCH_DELAY",
    "WATCH_DROP",
    "WATCH_GONE",
    "WRITE_VERBS",
    "ChaosEngine",
    "ChaosEvent",
    "ChaosPolicy",
    "ChaoticAPIServer",
    "ChaoticWatch",
    "LeakInjector",
    "MemoryLeakChaos",
    "PodChaos",
    "PodKiller",
    "SlowWorkerChaos",
    "TornWriteChaos",
    "TornWriteInjector",
    "VerbFaults",
    "WatchFaults",
    "WorkerSlower",
]
