"""In-memory Kubernetes API server.

This is the storage + watch hub everything else plugs into.  It serves three
duties the reference splits across external machinery:

1. the *fake clientset* used by unit tests (reference analog:
   k8s.io/client-go/kubernetes/fake as wired in
   /root/reference/v2/pkg/controller/mpi_job_controller_test.go:149-150);
2. the *envtest* backend for integration tests — a real-enough apiserver
   with no kubelet, where tests flip pod phases by hand (reference analog:
   /root/reference/v2/test/integration/main_test.go:42-59);
3. the default backend the operator process runs against in local mode
   (a real-cluster REST backend can implement the same surface).

Semantics kept faithful to Kubernetes: monotonic ``resourceVersion`` with
optimistic-concurrency conflicts, uid assignment, AlreadyExists/NotFound
errors, label-selector list filtering, a ``status`` subresource that
ignores non-status changes, watch streams with ADDED/MODIFIED/DELETED
events, and cascading deletion along ownerReferences (the garbage
collector the reference leans on when an MPIJob is deleted).
"""

from __future__ import annotations

import copy
import itertools
import time
import uuid
from dataclasses import dataclass
from typing import Callable, Optional

from ..utils import profiling
from . import locktrace
from ..utils.logging import DEBUG, get_logger


class ApiError(Exception):
    code = 0
    reason = ""

    def __init__(self, resource: str, name: str, detail: str = ""):
        self.resource = resource
        self.name = name
        msg = f"{self.reason}: {resource} {name!r}"
        if detail:
            msg += f": {detail}"
        super().__init__(msg)


class NotFoundError(ApiError):
    code = 404
    reason = "NotFound"


class AlreadyExistsError(ApiError):
    code = 409
    reason = "AlreadyExists"


class ConflictError(ApiError):
    code = 409
    reason = "Conflict"


class InvalidError(ApiError):
    code = 422
    reason = "Invalid"


class ServerError(ApiError):
    """Transient 500 (apiserver hiccup); retriable via runtime/retry."""

    code = 500
    reason = "InternalError"


class ServerTimeoutError(ApiError):
    """504: the request may or may not have been applied (chaos treats it
    as not applied, the strictest interpretation for callers)."""

    code = 504
    reason = "Timeout"


class GoneError(ApiError):
    """410 Gone: the watch fell behind a compaction and must relist
    (client-go reflector's ``ResourceExpired`` relist trigger)."""

    code = 410
    reason = "Gone"


# Watch event types (k8s watch.EventType analog).
ADDED = "ADDED"
MODIFIED = "MODIFIED"
DELETED = "DELETED"


@dataclass(frozen=True)
class WatchEvent:
    type: str  # ADDED | MODIFIED | DELETED
    resource: str  # plural, e.g. "pods"
    object: dict  # full object at event time (deep copy)
    # profiling.clock() stamp at emission; the anchor for watch-to-
    # reconcile propagation latency.  Chaos-delayed watches re-deliver
    # the same event object, so an injected delay shows up honestly.
    emitted_at: Optional[float] = None


@dataclass(frozen=True)
class ResourceType:
    plural: str
    api_version: str
    kind: str


# The resource universe the operator touches (reference analog: the four
# clientsets created in v2/cmd/mpi-operator/app/server.go:262-285).
RESOURCES: dict[str, ResourceType] = {
    r.plural: r
    for r in [
        ResourceType("nodes", "v1", "Node"),
        ResourceType("pods", "v1", "Pod"),
        ResourceType("services", "v1", "Service"),
        ResourceType("configmaps", "v1", "ConfigMap"),
        ResourceType("secrets", "v1", "Secret"),
        ResourceType("events", "v1", "Event"),
        ResourceType("jobs", "batch/v1", "Job"),
        ResourceType("leases", "coordination.k8s.io/v1", "Lease"),
        ResourceType("podgroups", "scheduling.x-k8s.io/v1alpha1", "PodGroup"),
        ResourceType("tpujobs", "kubeflow.org/v2beta1", "TPUJob"),
        ResourceType("clusterqueues", "kubeflow.org/v2beta1", "ClusterQueue"),
        ResourceType("localqueues", "kubeflow.org/v2beta1", "LocalQueue"),
    ]
}


class Watch:
    """One watch stream: a buffered queue of events plus a stop handle."""

    def __init__(self, server: "InMemoryAPIServer", resource: str,
                 namespace: Optional[str] = None):
        self._server = server
        self.resource = resource
        self.namespace = namespace  # None = cluster-wide
        self._events: list[WatchEvent] = []
        self._cond = locktrace.condition("apiserver.watch")
        self._stopped = False

    def _deliver(self, event: WatchEvent) -> None:
        if self.namespace and (
            (event.object.get("metadata") or {}).get("namespace", "")
            != self.namespace
        ):
            return
        with self._cond:
            if self._stopped:
                return
            self._events.append(event)
            self._cond.notify_all()

    def drain(self) -> list[WatchEvent]:
        """Return and clear all buffered events (non-blocking)."""
        with self._cond:
            events, self._events = self._events, []
            return events

    def next(self, timeout: Optional[float] = None) -> Optional[WatchEvent]:
        """Block until an event arrives (or timeout / stop); None on neither."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cond:
            while not self._events and not self._stopped:
                remaining = None if deadline is None else deadline - time.monotonic()
                if remaining is not None and remaining <= 0:
                    return None
                self._cond.wait(remaining)
            if self._events:
                return self._events.pop(0)
            return None

    def stop(self) -> None:
        with self._cond:
            self._stopped = True
            self._cond.notify_all()
        self._server._remove_watch(self)


def match_labels(selector: Optional[dict[str, str]], labels: dict[str, str]) -> bool:
    if not selector:
        return True
    return all(labels.get(k) == v for k, v in selector.items())


class InMemoryAPIServer:
    """Thread-safe in-memory object store with Kubernetes semantics."""

    def __init__(self, clock: Callable[[], float] = time.time):
        self._lock = locktrace.rlock("apiserver.store")
        self._clock = clock
        self._log = get_logger("apiserver")
        self._rv = itertools.count(1)
        # resource plural -> {(namespace, name) -> object dict}
        self._store: dict[str, dict[tuple[str, str], dict]] = {
            plural: {} for plural in RESOURCES
        }
        self._watches: list[Watch] = []
        # Recorded write actions, for reference-style "expected actions"
        # unit assertions (fixture pattern, mpi_job_controller_test.go:58-88).
        self.actions: list[tuple[str, str, str]] = []  # (verb, resource, ns/name)

    # -- helpers ---------------------------------------------------------

    def _meta(self, obj: dict) -> dict:
        return obj.setdefault("metadata", {})

    def _key(self, obj: dict) -> tuple[str, str]:
        meta = self._meta(obj)
        return meta.get("namespace", ""), meta.get("name", "")

    def _check_resource(self, resource: str) -> None:
        if resource not in self._store:
            raise NotFoundError("resources", resource, "unknown resource type")

    def _notify(self, type_: str, resource: str, obj: dict) -> None:
        event = WatchEvent(
            type_, resource, copy.deepcopy(obj), emitted_at=profiling.clock()
        )
        for watch in list(self._watches):
            if watch.resource == resource:
                watch._deliver(event)

    def _record(self, verb: str, resource: str, obj: dict) -> None:
        ns, name = self._key(obj)
        self.actions.append((verb, resource, f"{ns}/{name}"))
        # Request log (kube-apiserver audit-log analog): every write verb
        # at debug, so `--log-level debug` shows the full mutation stream.
        if self._log.enabled_for(DEBUG):
            self._log.debug(
                "%s %s %s/%s", verb, resource, ns, name,
                rv=(obj.get("metadata") or {}).get("resourceVersion", ""),
            )

    def clear_actions(self) -> None:
        # Writers append via _record() under self._lock; clearing must
        # take the same lock or it races an in-flight write (TPU401).
        with self._lock:
            self.actions.clear()

    # -- CRUD ------------------------------------------------------------

    def _admit(self, resource: str, obj: dict) -> dict:
        """CRD structural-schema admission (real-apiserver analog): writes
        to CRD-backed resources (TPUJob, ClusterQueue, LocalQueue) are
        validated against the generated openAPIV3Schema — a malformed pod
        template or quota entry fails here, at create/update time, not
        later at pod-creation time — and unknown fields are pruned the
        way a real apiserver prunes them (typos never reach storage)."""
        from ..api.schema import admission_schema_for, prune, validate_schema

        admission = admission_schema_for(resource)
        if admission is None:
            return obj
        schema, path = admission
        errors = validate_schema(obj, schema, path=path)
        if errors:
            name = self._key(obj)[1]
            shown = "; ".join(errors[:5])
            if len(errors) > 5:
                shown += f" (+{len(errors) - 5} more)"
            raise InvalidError(resource, name, shown)
        return prune(obj, schema)

    def create(self, resource: str, obj: dict) -> dict:
        self._check_resource(resource)
        obj = copy.deepcopy(obj)
        obj = self._admit(resource, obj)
        with self._lock:
            key = self._key(obj)
            if not key[1]:
                raise InvalidError(resource, "", "metadata.name is required")
            if key in self._store[resource]:
                raise AlreadyExistsError(resource, key[1])
            meta = self._meta(obj)
            meta.setdefault("uid", str(uuid.uuid4()))
            meta["resourceVersion"] = str(next(self._rv))
            meta.setdefault("creationTimestamp", self._clock())
            rt = RESOURCES[resource]
            obj.setdefault("apiVersion", rt.api_version)
            obj.setdefault("kind", rt.kind)
            self._store[resource][key] = obj
            self._record("create", resource, obj)
            self._notify(ADDED, resource, obj)
            return copy.deepcopy(obj)

    def get(self, resource: str, namespace: str, name: str) -> dict:
        self._check_resource(resource)
        with self._lock:
            obj = self._store[resource].get((namespace, name))
            if obj is None:
                raise NotFoundError(resource, f"{namespace}/{name}")
            return copy.deepcopy(obj)

    def list(
        self,
        resource: str,
        namespace: Optional[str] = None,
        label_selector: Optional[dict[str, str]] = None,
    ) -> list[dict]:
        self._check_resource(resource)
        with self._lock:
            out = []
            for (ns, _), obj in self._store[resource].items():
                if namespace is not None and ns != namespace:
                    continue
                if not match_labels(label_selector, self._meta(obj).get("labels") or {}):
                    continue
                out.append(copy.deepcopy(obj))
            out.sort(key=lambda o: (o["metadata"].get("namespace", ""), o["metadata"]["name"]))
            return out

    def _update(self, resource: str, obj: dict, *, status_only: bool) -> dict:
        self._check_resource(resource)
        obj = copy.deepcopy(obj)
        if not status_only:
            obj = self._admit(resource, obj)
        with self._lock:
            key = self._key(obj)
            current = self._store[resource].get(key)
            if current is None:
                raise NotFoundError(resource, key[1])
            rv = self._meta(obj).get("resourceVersion")
            current_rv = current["metadata"]["resourceVersion"]
            if rv and rv != current_rv:
                raise ConflictError(
                    resource, key[1], f"resourceVersion {rv} != {current_rv}"
                )
            if status_only:
                # Status subresource: only .status changes; spec/meta kept.
                merged = copy.deepcopy(current)
                if "status" in obj:
                    merged["status"] = obj["status"]
                else:
                    merged.pop("status", None)
                new = merged
            else:
                # Spec update: status is carried over from storage (writes to
                # the main resource never change status, like k8s).
                new = obj
                if "status" in current:
                    new["status"] = copy.deepcopy(current["status"])
                else:
                    new.pop("status", None)
                # Immutable fields survive from storage.
                for immutable in ("uid", "creationTimestamp"):
                    if immutable in current["metadata"]:
                        new["metadata"][immutable] = current["metadata"][immutable]
            new["metadata"]["resourceVersion"] = str(next(self._rv))
            self._store[resource][key] = new
            self._record("update_status" if status_only else "update", resource, new)
            self._notify(MODIFIED, resource, new)
            return copy.deepcopy(new)

    def update(self, resource: str, obj: dict) -> dict:
        return self._update(resource, obj, status_only=False)

    def update_status(self, resource: str, obj: dict) -> dict:
        return self._update(resource, obj, status_only=True)

    def delete(self, resource: str, namespace: str, name: str) -> None:
        self._check_resource(resource)
        with self._lock:
            obj = self._store[resource].pop((namespace, name), None)
            if obj is None:
                raise NotFoundError(resource, f"{namespace}/{name}")
            # Deletion is a write: the DELETED event carries a fresh
            # resourceVersion (kube semantics — watch streams stay
            # rv-monotonic, which the HTTP frontend's watch cache needs).
            obj["metadata"]["resourceVersion"] = str(next(self._rv))
            self._record("delete", resource, obj)
            self._notify(DELETED, resource, obj)
            self._garbage_collect(obj["metadata"].get("uid"), namespace)

    def _garbage_collect(self, owner_uid: Optional[str], namespace: str) -> None:
        """Cascading deletion along ownerReferences (kube GC analog)."""
        if not owner_uid:
            return
        for resource, store in self._store.items():
            doomed = [
                (ns, name)
                for (ns, name), obj in store.items()
                if ns == namespace
                and any(
                    ref.get("uid") == owner_uid
                    for ref in obj["metadata"].get("ownerReferences") or []
                )
            ]
            for ns, name in doomed:
                # Recursive: children of children go too.
                try:
                    self.delete(resource, ns, name)
                except NotFoundError:
                    pass

    # -- watch -----------------------------------------------------------

    def watch(self, resource: str, namespace: Optional[str] = None) -> Watch:
        """Open a watch; ``namespace`` scopes delivery (None =
        cluster-wide), mirroring the kube backend's namespaced watch
        paths so RBAC-scoped deployments work identically."""
        self._check_resource(resource)
        watch = Watch(self, resource, namespace)
        with self._lock:
            self._watches.append(watch)
        return watch

    def _remove_watch(self, watch: Watch) -> None:
        with self._lock:
            if watch in self._watches:
                self._watches.remove(watch)
