"""Kubernetes Event recording.

Reference analog: the record.EventRecorder created in
/root/reference/v2/pkg/controller/mpi_job_controller.go:262-267 and used as
the user-facing audit trail at every anomaly (:489, :497, :575, :608...),
with message truncation to 1024 chars (:1565-1571).
"""

from __future__ import annotations

import itertools
import time
from collections import deque
from dataclasses import dataclass
from typing import Any, Callable

EVENT_TYPE_NORMAL = "Normal"
EVENT_TYPE_WARNING = "Warning"

# Buffer/aggregation bounds (client-go event correlator analogs): the
# in-process buffer is a ring so a long-running operator cannot grow
# memory without limit, and identical events inside the similarity
# window collapse into one Event with an incremented ``count`` (kube's
# EventSeries/aggregation behavior; its aggregator also uses a
# 10-minute window).
DEFAULT_EVENT_BUFFER = 1000
DEFAULT_AGGREGATION_WINDOW = 600.0

# Scheduler event reasons (kube-scheduler vocabulary).
SCHEDULED_REASON = "Scheduled"
FAILED_SCHEDULING_REASON = "FailedScheduling"
PREEMPTED_REASON = "Preempted"

# eventMessageLimit, mpi_job_controller.go:116 analog.
MESSAGE_LIMIT = 1024


def format_failed_scheduling(total_nodes: int, reasons) -> str:
    """Render kube-scheduler's FailedScheduling message shape:
    ``0/4 nodes are available: 3 Insufficient google.com/tpu, 1 node(s)
    had mismatched TPU generation.`` — ``reasons`` is a mapping of
    reason string -> node count."""
    if not reasons:
        detail = "no nodes registered" if total_nodes == 0 else "no reason recorded"
        return f"0/{total_nodes} nodes are available: {detail}."
    parts = ", ".join(
        f"{count} {reason}" for reason, count in sorted(reasons.items())
    )
    return f"0/{total_nodes} nodes are available: {parts}."


def truncate_message(message: str) -> str:
    """Truncate to the apiserver-friendly limit (:1565-1571 analog)."""
    if len(message) <= MESSAGE_LIMIT:
        return message
    suffix = "..."
    return message[: MESSAGE_LIMIT - len(suffix)] + suffix


@dataclass
class Event:
    type: str
    reason: str
    message: str
    involved_kind: str
    involved_name: str
    involved_namespace: str
    timestamp: float
    source: str
    # Event-series fields: ``timestamp`` stays the first occurrence;
    # aggregated repeats bump ``count`` and ``last_timestamp``.
    count: int = 1
    last_timestamp: float = 0.0

    def to_object(self, name: str) -> dict:
        return {
            "apiVersion": "v1",
            "kind": "Event",
            "metadata": {"name": name, "namespace": self.involved_namespace},
            "type": self.type,
            "reason": self.reason,
            "message": self.message,
            "involvedObject": {
                "kind": self.involved_kind,
                "name": self.involved_name,
                "namespace": self.involved_namespace,
            },
            "source": {"component": self.source},
            "eventTime": self.timestamp,
            "count": self.count,
            "lastTimestamp": self.last_timestamp or self.timestamp,
        }


class EventRecorder:
    """Records Events against an API server and keeps them inspectable.

    ``api`` may be None, in which case events are only buffered in-process
    (fixture mode, like the fake record.FakeRecorder).
    """

    def __init__(
        self,
        api=None,
        source: str = "tpu-job-controller",
        clock=time.time,
        capacity: int = DEFAULT_EVENT_BUFFER,
        aggregation_window: float = DEFAULT_AGGREGATION_WINDOW,
    ):
        self._api = api
        self.source = source
        self._clock = clock
        self._seq = itertools.count(1)
        self.events: deque[Event] = deque(maxlen=capacity)
        self._window = aggregation_window
        # (involvedObject, type, reason, message) -> (Event, apiserver
        # object name) for the live aggregation window.
        self._recent: dict[tuple, tuple[Event, str]] = {}
        self._subscribers: list[Callable[[Event], None]] = []

    def subscribe(self, fn: Callable[[Event], None]) -> None:
        """Register an observer called once per recorded occurrence (new
        Events AND aggregated repeats, with the up-to-date Event)."""
        self._subscribers.append(fn)

    def _notify(self, ev: Event) -> None:
        for fn in self._subscribers:
            try:
                fn(ev)
            except Exception:  # observers must never break reconciliation
                pass

    def event(self, obj: Any, type_: str, reason: str, message: str) -> None:
        meta = obj.metadata if hasattr(obj, "metadata") else None
        if meta is not None:
            kind = getattr(obj, "kind", "")
            name, namespace = meta.name, meta.namespace
        else:  # plain dict object
            kind = obj.get("kind", "")
            m = obj.get("metadata") or {}
            name, namespace = m.get("name", ""), m.get("namespace", "")
        message = truncate_message(message)
        now = self._clock()
        key = (kind, namespace, name, type_, reason, message)

        # Lazy window prune: keys whose last occurrence aged out.
        for k in [
            k for k, (e, _) in self._recent.items()
            if now - (e.last_timestamp or e.timestamp) > self._window
        ]:
            del self._recent[k]

        aggregated = self._recent.get(key)
        if aggregated is not None:
            ev, event_name = aggregated
            ev.count += 1
            ev.last_timestamp = now
            if self._api is not None:
                try:
                    stored = self._api.get("events", namespace, event_name)
                    stored["count"] = ev.count
                    stored["lastTimestamp"] = now
                    self._api.update("events", stored)
                except Exception:  # events must never break reconciliation
                    pass
            self._notify(ev)
            return

        ev = Event(
            type=type_,
            reason=reason,
            message=message,
            involved_kind=kind,
            involved_name=name,
            involved_namespace=namespace,
            timestamp=now,
            source=self.source,
            last_timestamp=now,
        )
        event_name = f"{name}.{next(self._seq):08x}"
        self.events.append(ev)
        self._recent[key] = (ev, event_name)
        if self._api is not None:
            try:
                self._api.create("events", ev.to_object(event_name))
            except Exception:  # events must never break reconciliation
                pass
        self._notify(ev)

    def eventf(self, obj: Any, type_: str, reason: str, fmt: str, *args: Any) -> None:
        self.event(obj, type_, reason, fmt % args if args else fmt)
