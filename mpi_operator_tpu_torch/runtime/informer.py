"""Shared informers and listers.

Reference analog: the generated informer/lister machinery in
/root/reference/v2/pkg/client/informers + k8s.io/client-go informers, as
wired in mpi_job_controller.go:249-347 (event handlers) and :355-377
(WaitForCacheSync before workers start).

Each informer keeps a local cache (the lister's view) fed by an apiserver
watch stream.  Event delivery is *pumped*: ``pump()`` applies buffered
watch events to the cache and fires handlers.  Tests pump synchronously
for determinism; the operator process runs a pump loop in a thread.  This
mirrors the real informer property that the cache can lag the apiserver,
which is exactly what the reference's deep-copy-before-mutate discipline
(mpi_job_controller.go:475-478) is guarding against.
"""

from __future__ import annotations

import copy
import time
from dataclasses import dataclass
from typing import TYPE_CHECKING, Callable, Optional, Union

from ..utils import profiling
from . import locktrace
from .apiserver import (
    ADDED,
    DELETED,
    ApiError,
    GoneError,
    InMemoryAPIServer,
    match_labels,
)

if TYPE_CHECKING:
    from .kube import KubeAPIServer


# -- built-in indexers --------------------------------------------------
# client-go cache.Indexers analog: secondary key maps maintained
# incrementally on every cache mutation, so grouped reads (pods by
# phase, objects by namespace) cost O(groups) instead of a full scan
# with a deep copy per object.

def _namespace_of(obj: dict) -> str:
    return (obj.get("metadata") or {}).get("namespace", "")


def _phase_of(obj: dict) -> str:
    # Mirrors statemetrics pod-phase semantics: no phase yet == Pending.
    return (obj.get("status") or {}).get("phase") or "Pending"


DEFAULT_INDEXERS: dict[str, Callable[[dict], str]] = {
    "namespace": _namespace_of,
    "phase": _phase_of,
}


def split_key(key: str) -> tuple[str, str]:
    """"namespace/name" -> (namespace, name) (cache.SplitMetaNamespaceKey)."""
    if "/" in key:
        ns, name = key.split("/", 1)
        return ns, name
    return "", key


def meta_namespace_key(obj: dict) -> str:
    meta = obj.get("metadata") or {}
    ns = meta.get("namespace", "")
    name = meta.get("name", "")
    return f"{ns}/{name}" if ns else name


@dataclass
class EventHandler:
    on_add: Optional[Callable[[dict], None]] = None
    on_update: Optional[Callable[[dict, dict], None]] = None
    on_delete: Optional[Callable[[dict], None]] = None


class Lister:
    """Read-only view over an informer cache (namespace/name keyed dicts)."""

    def __init__(self, informer: "Informer"):
        self._informer = informer

    def get(self, namespace: str, name: str) -> Optional[dict]:
        return self._informer.cache_get(namespace, name)

    def list(
        self,
        namespace: Optional[str] = None,
        label_selector: Optional[dict[str, str]] = None,
    ) -> list[dict]:
        return self._informer.cache_list(namespace, label_selector)

    def by_index(self, index: str, value: str) -> list[dict]:
        """Objects whose indexer maps to ``value`` (cache.Indexer.ByIndex
        analog) — no full-cache scan."""
        return self._informer.cache_by_index(index, value)

    def index_counts(self, index: str) -> dict[str, int]:
        """``{index value: object count}`` without copying any object —
        the cheap path for by-phase/by-namespace gauges."""
        return self._informer.cache_index_counts(index)


class Informer:
    def __init__(
        self,
        api: Union[InMemoryAPIServer, KubeAPIServer],
        resource: str,
        namespace: str = "",
        resync_interval: Optional[float] = None,
        clock: Callable[[], float] = time.monotonic,
        profiler: Optional[profiling.PhaseProfiler] = None,
        indexers: Optional[dict[str, Callable[[dict], str]]] = None,
    ):
        self._api = api
        self.resource = resource
        self.namespace = namespace  # "" = cluster-wide (server.go:139-147 analog)
        # Reflector resyncPeriod analog: when set, pump() periodically
        # relists so events lost in flight (a lossy watch under fault
        # injection) cannot leave the cache stale forever.
        self.resync_interval = resync_interval
        self._clock = clock
        self.profiler = profiler
        self._lock = locktrace.rlock(f"informer.{resource}")
        self._cache: dict[str, dict] = {}
        self._indexers = dict(DEFAULT_INDEXERS if indexers is None else indexers)
        # index name -> index value -> cache keys
        self._indexes: dict[str, dict[str, set[str]]] = {
            name: {} for name in self._indexers
        }
        self._handlers: list[EventHandler] = []
        self._watch = None
        self._synced = False
        self._stopped = False
        self._need_resync = False
        self._last_sync = clock()
        self.lister = Lister(self)

    # -- cache reads -----------------------------------------------------

    def cache_get(self, namespace: str, name: str) -> Optional[dict]:
        with self._lock:
            obj = self._cache.get(f"{namespace}/{name}" if namespace else name)
            return None if obj is None else _deep_copy(obj)

    def cache_list(
        self,
        namespace: Optional[str] = None,
        label_selector: Optional[dict[str, str]] = None,
    ) -> list[dict]:
        with self._lock:
            if self.profiler is not None:
                self.profiler.record_scan(self.resource, len(self._cache))
            out = []
            for obj in self._cache.values():
                meta = obj.get("metadata") or {}
                if namespace is not None and meta.get("namespace", "") != namespace:
                    continue
                if not match_labels(label_selector, meta.get("labels") or {}):
                    continue
                out.append(_deep_copy(obj))
            out.sort(
                key=lambda o: (
                    o["metadata"].get("namespace", ""),
                    o["metadata"]["name"],
                )
            )
            return out

    def cache_by_index(self, index: str, value: str) -> list[dict]:
        with self._lock:
            keys = self._indexes[index].get(value, ())
            return sorted(
                (_deep_copy(self._cache[k]) for k in keys if k in self._cache),
                key=lambda o: (
                    o["metadata"].get("namespace", ""),
                    o["metadata"]["name"],
                ),
            )

    def cache_index_counts(self, index: str) -> dict[str, int]:
        with self._lock:
            return {
                value: len(keys)
                for value, keys in self._indexes[index].items()
                if keys
            }

    # -- index maintenance (call with self._lock held) -------------------

    def _index_insert(self, key: str, obj: dict) -> None:
        for name, indexer in self._indexers.items():
            self._indexes[name].setdefault(indexer(obj), set()).add(key)

    def _index_discard(self, key: str, obj: Optional[dict]) -> None:
        if obj is None:
            return
        for name, indexer in self._indexers.items():
            value = indexer(obj)
            keys = self._indexes[name].get(value)
            if keys is not None:
                keys.discard(key)
                if not keys:
                    del self._indexes[name][value]

    def _rebuild_indexes(self) -> None:
        self._indexes = {name: {} for name in self._indexers}
        for key, obj in self._cache.items():
            self._index_insert(key, obj)

    # -- lifecycle -------------------------------------------------------

    def add_event_handler(self, handler: EventHandler) -> None:
        # The pump loop runs on its own thread: registration must not
        # race an in-flight handler iteration (list.append is atomic in
        # CPython, but the guarded/unguarded split is exactly what the
        # TPU401 checker bans — one discipline everywhere).
        with self._lock:
            self._handlers.append(handler)

    def _handlers_snapshot(self) -> list[EventHandler]:
        """Handlers as of now; iterate the snapshot so delivery never
        holds the cache lock and never races add_event_handler."""
        with self._lock:
            return list(self._handlers)

    def set_resync_interval(self, seconds: Optional[float]) -> None:
        """Arm/change the reflector resync period (pump reads it under
        the lock; a cross-thread bare-attribute write would race)."""
        with self._lock:
            self.resync_interval = seconds

    def _in_scope(self, obj: dict) -> bool:
        return not self.namespace or (obj.get("metadata") or {}).get(
            "namespace", ""
        ) == self.namespace

    def start(self) -> None:
        """Open the watch, then load the initial listing into the cache.

        Opening the watch first guarantees no lost updates: anything that
        changes between list and first pump arrives as a watch event.
        Namespace-scoped informers open namespace-scoped watches/lists so
        RBAC-scoped deployments never need cluster-wide permissions.
        Re-entrant (leadership regained after a step-down): the fresh list
        *replaces* the previous term's cache, and objects that disappeared
        while we were not watching fire on_delete instead of lingering as
        ghosts.
        """
        with self._lock:
            if self._watch is not None:
                return
            self._stopped = False
        self.resync()

    def resync(self) -> None:
        """(Re)open the watch and replace the cache from a fresh list.

        Reflector ListAndWatch relist analog: called at start, after the
        watch reports 410 Gone (compaction), and on the periodic resync
        interval.  Objects that vanished fire on_delete; everything else
        re-fires on_add (no-op adds collapse in the workqueue, as in
        client-go's resync).  Raises ApiError if the relist itself fails;
        pump() treats that as "still stale, retry next round".
        """
        with self._lock:
            if self._stopped:
                return
            old_watch, self._watch = self._watch, None
        if old_watch is not None:
            old_watch.stop()
        ns = self.namespace or None
        watch = self._api.watch(self.resource, namespace=ns)
        # REST watches already paid for a baseline LIST (their 410
        # resume mirror); reuse it instead of issuing a second full
        # LIST per resource against the apiserver.
        try:
            if hasattr(watch, "baseline"):
                listing = watch.baseline()
            else:
                listing = self._api.list(self.resource, ns)
        except ApiError:
            watch.stop()
            raise
        with self._lock:
            if self._stopped:
                watch.stop()
                return
            self._watch = watch
            fresh = {
                meta_namespace_key(obj): obj
                for obj in listing
                if self._in_scope(obj)
            }
            removed = [
                obj for key, obj in self._cache.items() if key not in fresh
            ]
            self._cache = fresh
            self._rebuild_indexes()
            self._synced = True
            self._need_resync = False
            self._last_sync = self._clock()
        # Handlers fire outside the lock (a snapshot: registration may
        # race the relist).
        handlers = self._handlers_snapshot()
        for obj in removed:
            for h in handlers:
                if h.on_delete:
                    h.on_delete(_deep_copy(obj))
        for obj in self.cache_list():
            for h in handlers:
                if h.on_add:
                    h.on_add(obj)

    @property
    def has_synced(self) -> bool:
        return self._synced

    def pump(self) -> int:
        """Apply buffered watch events to the cache; fire handlers.

        Returns the number of events processed.  Events already reflected in
        the initial list (same resourceVersion) collapse into no-op updates,
        which handlers still see — the workqueue dedups, as in client-go.
        """
        # Snapshot under the lock: stop() may null the watch concurrently
        # (the pump loop is not joined before stop_all at step-down), and
        # _last_sync/_synced/resync_interval are written by resync() and
        # set_resync_interval() on other threads.
        with self._lock:
            watch = self._watch
            stale = self._need_resync
            synced = self._synced
            if not stale and self.resync_interval is not None:
                stale = (
                    self._clock() - self._last_sync >= self.resync_interval
                )
        if watch is None:
            if not synced:
                raise RuntimeError(
                    f"informer for {self.resource} not started; call start() first"
                )
            return 0  # started, then stopped: clean shutdown
        if stale:
            with self._lock:
                self._need_resync = True  # sticky until a relist succeeds
            try:
                self.resync()
            except ApiError:
                return 0  # apiserver unavailable; retry next pump
            with self._lock:
                watch = self._watch
            if watch is None:
                return 0
        handlers = self._handlers_snapshot()
        try:
            events = watch.drain()
        except GoneError:
            # Compacted away mid-stream: the buffer is suspect; relist on
            # the next pump round (keeps this round cheap and non-raising).
            with self._lock:
                self._need_resync = True
            return 0
        for event in events:
            if not self._in_scope(event.object):
                continue
            key = meta_namespace_key(event.object)
            with self._lock:
                old = self._cache.get(key)
                self._index_discard(key, old)
                if event.type == DELETED:
                    self._cache.pop(key, None)
                else:
                    self._cache[key] = event.object
                    self._index_insert(key, event.object)
            if self.profiler is not None:
                self.profiler.observe_delivery(event.emitted_at)
            # Handlers run with the event's emission stamp visible so an
            # enqueue they trigger can attribute the key to this event
            # (even across object->owner key mapping).
            profiling.set_current_event_stamp(event.emitted_at)
            try:
                if event.type == ADDED and old is None:
                    for h in handlers:
                        if h.on_add:
                            h.on_add(_deep_copy(event.object))
                elif event.type == DELETED:
                    for h in handlers:
                        if h.on_delete:
                            h.on_delete(
                                _deep_copy(old if old is not None else event.object)
                            )
                else:  # MODIFIED, or ADDED already seen via initial list
                    base = old if old is not None else event.object
                    for h in handlers:
                        if h.on_update:
                            h.on_update(_deep_copy(base), _deep_copy(event.object))
            finally:
                profiling.clear_current_event_stamp()
        return len(events)

    def stop(self) -> None:
        with self._lock:
            self._stopped = True
            if self._watch is not None:
                self._watch.stop()
                self._watch = None


class InformerFactory:
    """Shared informer factory (one informer per resource).

    Reference analog: kubeinformers.NewSharedInformerFactory +
    informers.NewSharedInformerFactory in app/server.go:139-147.
    """

    def __init__(
        self,
        api: Union[InMemoryAPIServer, KubeAPIServer],
        namespace: str = "",
        resync_interval: Optional[float] = None,
        profiler: Optional[profiling.PhaseProfiler] = None,
    ):
        self._api = api
        self.namespace = namespace
        self.resync_interval = resync_interval
        self.profiler = profiler
        self._informers: dict[str, Informer] = {}

    def informer(self, resource: str) -> Informer:
        if resource not in self._informers:
            self._informers[resource] = Informer(
                self._api,
                resource,
                namespace=self.namespace,
                resync_interval=self.resync_interval,
                profiler=self.profiler,
            )
        return self._informers[resource]

    def set_resync_interval(self, seconds: Optional[float]) -> None:
        """Apply a resync period to existing and future informers (lets a
        chaos harness arm resync on a controller-owned factory)."""
        self.resync_interval = seconds
        for informer in self._informers.values():
            informer.set_resync_interval(seconds)

    def start_all(self) -> None:
        for informer in self._informers.values():
            informer.start()

    def pump_all(self) -> int:
        """One pump round across all informers; returns events processed."""
        return sum(informer.pump() for informer in self._informers.values())

    def pump_until_quiet(self, max_rounds: int = 100) -> None:
        """Pump until no informer has buffered events (test convenience)."""
        for _ in range(max_rounds):
            if self.pump_all() == 0:
                return
        raise RuntimeError("informers did not quiesce")

    def stop_all(self) -> None:
        for informer in self._informers.values():
            informer.stop()


def _deep_copy(obj: dict) -> dict:
    return copy.deepcopy(obj)
