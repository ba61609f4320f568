"""Bounded per-job flight recorder: one ordered timeline per TPUJob.

Kubernetes has no single object that answers "what happened to this job,
in order" — you reconstruct it by joining Events, status conditions, and
pod phases by hand, and Events expire after an hour.  The flight recorder
maintains that join live, in memory, bounded: every condition transition
(controller), recorded Event (utils/events subscription), scheduling
decision (scheduler core), and pod phase flip (podrunner) lands as one
timeline entry under the owning job, and the monitoring server serves it
as JSON at ``/debug/jobs/<ns>/<name>/timeline``.

Bounds: a ring buffer per job (``capacity_per_job``) and an LRU cap on
the number of jobs tracked (``max_jobs``) — a long-running operator keeps
recent history for recent jobs and nothing grows without limit.  Entries
survive job deletion (post-mortem is the whole point) until evicted.
"""

from __future__ import annotations

import itertools
import json
import threading
import time
from collections import OrderedDict, deque
from typing import Optional

DEFAULT_CAPACITY_PER_JOB = 256
DEFAULT_MAX_JOBS = 256

# Entry kinds (the subscribed sources).
CONDITION = "condition"
EVENT = "event"
SCHEDULING = "scheduling"
POD = "pod"
# Chaos faults targeting a job's workers (chaos/podchaos.py injectors)
# land on the victim job's timeline under the engine's fault-kind
# vocabulary, and the device-memory observatory (utils/devstats.py)
# freezes its last joined snapshot as a MEMORY entry when a pod dies
# with the OOM exit code.
SLOW_WORKER = "slow_worker"
MEM_LEAK = "mem_leak"
MEMORY = "memory"
TORN_WRITE = "torn_write"
KINDS = (
    CONDITION, EVENT, SCHEDULING, POD, SLOW_WORKER, MEM_LEAK, MEMORY,
    TORN_WRITE,
)


class FlightRecorder:
    def __init__(
        self,
        capacity_per_job: int = DEFAULT_CAPACITY_PER_JOB,
        max_jobs: int = DEFAULT_MAX_JOBS,
        clock=time.time,
    ):
        self._capacity = capacity_per_job
        self._max_jobs = max_jobs
        self._clock = clock
        self._lock = threading.Lock()
        # Insertion/touch order == LRU order for job eviction.
        self._jobs: "OrderedDict[tuple[str, str], deque]" = OrderedDict()
        # Monotonic order key: entries sort stably even when the clock's
        # resolution collapses adjacent timestamps.
        self._seq = itertools.count(1)

    def record(
        self,
        namespace: str,
        name: str,
        kind: str,
        reason: str = "",
        message: str = "",
        **attrs,
    ) -> dict:
        entry = {
            "seq": next(self._seq),
            "ts": round(self._clock(), 6),
            "kind": kind,
            "reason": reason,
            "message": message,
        }
        for k, v in attrs.items():
            # JSON-safe like span attrs: repr anything exotic.
            entry[k] = (
                v if isinstance(v, (str, int, float, bool, type(None)))
                else repr(v)
            )
        with self._lock:
            timeline = self._jobs.get((namespace, name))
            if timeline is None:
                timeline = self._jobs[(namespace, name)] = deque(
                    maxlen=self._capacity
                )
                while len(self._jobs) > self._max_jobs:
                    self._jobs.popitem(last=False)
            else:
                self._jobs.move_to_end((namespace, name))
            timeline.append(entry)
        return entry

    def observe_event(self, ev) -> None:
        """utils/events.EventRecorder subscriber: fold recorded Events for
        TPUJob-kind involved objects into the owning job's timeline."""
        if getattr(ev, "involved_kind", "") != "TPUJob":
            return
        self.record(
            ev.involved_namespace,
            ev.involved_name,
            EVENT,
            reason=ev.reason,
            message=ev.message,
            type=ev.type,
            count=getattr(ev, "count", 1),
        )

    def timeline(
        self,
        namespace: str,
        name: str,
        *,
        kind: Optional[str] = None,
        limit: Optional[int] = None,
    ) -> Optional[list]:
        """Ordered entries for one job; None when the job was never seen
        (distinguishes 404 from an empty-but-known timeline).  ``kind``
        keeps only entries of that kind; ``limit`` keeps the *newest* N
        after filtering (the tail is what post-mortems read first)."""
        with self._lock:
            timeline = self._jobs.get((namespace, name))
            if timeline is None:
                return None
            entries = list(timeline)
        if kind is not None:
            entries = [e for e in entries if e.get("kind") == kind]
        if limit is not None and limit >= 0:
            entries = entries[-limit:] if limit > 0 else []
        return entries

    def timeline_object(
        self,
        namespace: str,
        name: str,
        *,
        kind: Optional[str] = None,
        limit: Optional[int] = None,
    ) -> Optional[dict]:
        entries = self.timeline(namespace, name, kind=kind, limit=limit)
        if entries is None:
            return None
        return {"namespace": namespace, "name": name, "entries": entries}

    def to_json(
        self,
        namespace: str,
        name: str,
        *,
        kind: Optional[str] = None,
        limit: Optional[int] = None,
    ) -> Optional[str]:
        obj = self.timeline_object(namespace, name, kind=kind, limit=limit)
        return None if obj is None else json.dumps(obj, sort_keys=True)

    def jobs(self) -> list:
        with self._lock:
            return list(self._jobs.keys())

    def forget(self, namespace: str, name: str) -> None:
        with self._lock:
            self._jobs.pop((namespace, name), None)

    def __len__(self) -> int:
        with self._lock:
            return len(self._jobs)
