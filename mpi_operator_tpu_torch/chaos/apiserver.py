"""Fault-injecting wrappers around the in-memory API server (the port's
copy of ``mpi_operator_tpu/chaos/apiserver.py``, over the port's
``InMemoryAPIServer``).

``ChaoticAPIServer`` duck-types ``runtime.apiserver.InMemoryAPIServer``:
verbs consult the engine before delegating, so an injected fault means
the write *never happened* (the strictest interpretation a client must
survive).  ``watch()`` returns a ``ChaoticWatch`` that drops, delays, and
compacts (410 Gone) the event stream per policy.

Everything not explicitly wrapped passes through via ``__getattr__`` —
the wrapper stays honest as the inner server grows surface area.
"""

from __future__ import annotations

from typing import Optional

from ..runtime.apiserver import GoneError, InMemoryAPIServer, WatchEvent
from .engine import WATCH_DELAY, WATCH_DROP, WATCH_GONE, ChaosEngine


def _event_key(event: WatchEvent) -> str:
    meta = event.object.get("metadata") or {}
    ns = meta.get("namespace", "")
    name = meta.get("name", "")
    return f"{ns}/{name}" if ns else name


class ChaoticWatch:
    """Wraps a runtime Watch; the server keeps delivering to the inner
    watch, and faults are applied at drain time (the informer pump's
    single consumption point)."""

    def __init__(self, inner, engine: ChaosEngine, raw: InMemoryAPIServer):
        self._inner = inner
        self._engine = engine
        self._raw = raw
        # Delayed events: (rounds_until_release, event), FIFO per round.
        self._delayed: list[list] = []

    @property
    def resource(self) -> str:
        return self._inner.resource

    @property
    def namespace(self) -> Optional[str]:
        return self._inner.namespace

    def baseline(self) -> list[dict]:
        """Relist against the *raw* server: a compaction recovery that
        itself flaked forever would make convergence unfalsifiable."""
        return self._raw.list(self.resource, self.namespace)

    def drain(self) -> list[WatchEvent]:
        released: list[WatchEvent] = []
        for entry in self._delayed:
            entry[0] -= 1
        while self._delayed and self._delayed[0][0] <= 0:
            released.append(self._delayed.pop(0)[1])
        out: list[WatchEvent] = list(released)
        incoming = self._inner.drain()
        for event in incoming:
            fate = self._engine.watch_fault(self.resource, _event_key(event))
            if fate == WATCH_GONE:
                # Compaction storm: everything buffered (delivered or
                # delayed) is behind the compaction point and is lost;
                # the informer must relist.
                self._delayed.clear()
                raise GoneError(
                    "watch", self.resource, "chaos: stream compacted"
                )
            if fate == WATCH_DROP:
                continue
            if fate == WATCH_DELAY:
                delay = self._engine.policy.watch.delay_rounds
                self._delayed.append([delay, event])
                continue
            out.append(event)
        return out

    def next(self, timeout: Optional[float] = None) -> Optional[WatchEvent]:
        # The blocking path is used by consumers outside the informer
        # pump (e.g. test helpers); faults apply on the drain path only.
        return self._inner.next(timeout)

    def stop(self) -> None:
        self._delayed.clear()
        self._inner.stop()


class ChaoticAPIServer:
    """InMemoryAPIServer facade that injects verb faults per policy."""

    def __init__(self, inner: InMemoryAPIServer, engine: ChaosEngine):
        self._inner = inner
        self._engine = engine

    @property
    def inner(self) -> InMemoryAPIServer:
        return self._inner

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def _maybe_fault(self, verb: str, resource: str, name: str) -> None:
        error = self._engine.fault_for(verb, resource, name)
        if error is not None:
            raise error

    # -- verbs -----------------------------------------------------------

    def get(self, resource: str, namespace: str, name: str) -> dict:
        self._maybe_fault("get", resource, name)
        return self._inner.get(resource, namespace, name)

    def list(
        self,
        resource: str,
        namespace: Optional[str] = None,
        label_selector: Optional[dict] = None,
    ) -> list[dict]:
        self._maybe_fault("list", resource, "*")
        return self._inner.list(resource, namespace, label_selector)

    def create(self, resource: str, obj: dict) -> dict:
        name = (obj.get("metadata") or {}).get("name", "")
        self._maybe_fault("create", resource, name)
        return self._inner.create(resource, obj)

    def update(self, resource: str, obj: dict) -> dict:
        name = (obj.get("metadata") or {}).get("name", "")
        self._maybe_fault("update", resource, name)
        return self._inner.update(resource, obj)

    def update_status(self, resource: str, obj: dict) -> dict:
        name = (obj.get("metadata") or {}).get("name", "")
        self._maybe_fault("update_status", resource, name)
        return self._inner.update_status(resource, obj)

    def delete(self, resource: str, namespace: str, name: str) -> None:
        self._maybe_fault("delete", resource, name)
        return self._inner.delete(resource, namespace, name)

    def watch(self, resource: str, namespace: Optional[str] = None):
        inner = self._inner.watch(resource, namespace)
        watch_policy = self._engine.policy.watch
        if watch_policy is not None and watch_policy.applies(resource):
            return ChaoticWatch(inner, self._engine, self._inner)
        return inner
