"""Typed clients over an API server.

Reference analog: the four clientsets the operator wires up in
/root/reference/v2/cmd/mpi-operator/app/server.go:262-285 (kubeClient,
mpiJobClient, volcanoClient, leaderElectionClient) — here a ``KubeClient``
(core+batch), a ``TPUJobClient`` (our CRD, generated-clientset analog of
v2/pkg/client/clientset/versioned), and a ``SchedulingClient`` (PodGroups).

All clients speak dicts to the backend and typed objects to callers.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Optional, Union

from ..api.v2beta1.types import TPUJob
from .apiserver import InMemoryAPIServer
from .objects import KubeObject

if TYPE_CHECKING:
    from .kube import KubeAPIServer


class ResourceClient:
    """Namespaced CRUD for one resource, KubeObject-typed."""

    def __init__(self, api: Union[InMemoryAPIServer, KubeAPIServer],
                 resource: str, namespace: str):
        self._api = api
        self.resource = resource
        self.namespace = namespace

    def _localize(self, obj: KubeObject) -> dict:
        d = obj.to_dict()
        d["metadata"].setdefault("namespace", self.namespace)
        return d

    def create(self, obj: KubeObject) -> KubeObject:
        return KubeObject.from_dict(self._api.create(self.resource, self._localize(obj)))

    def get(self, name: str) -> KubeObject:
        return KubeObject.from_dict(self._api.get(self.resource, self.namespace, name))

    def list(self, label_selector: Optional[dict[str, str]] = None) -> list[KubeObject]:
        return [
            KubeObject.from_dict(d)
            for d in self._api.list(self.resource, self.namespace, label_selector)
        ]

    def update(self, obj: KubeObject) -> KubeObject:
        return KubeObject.from_dict(self._api.update(self.resource, self._localize(obj)))

    def update_status(self, obj: KubeObject) -> KubeObject:
        return KubeObject.from_dict(
            self._api.update_status(self.resource, self._localize(obj))
        )

    def delete(self, name: str) -> None:
        self._api.delete(self.resource, self.namespace, name)


class KubeClient:
    """Core/v1 + batch/v1 + coordination surface used by the operator."""

    def __init__(self, api: Union[InMemoryAPIServer, KubeAPIServer]):
        self.api = api

    def pods(self, namespace: str) -> ResourceClient:
        return ResourceClient(self.api, "pods", namespace)

    def nodes(self) -> ResourceClient:
        # Nodes are cluster-scoped: the empty namespace is their home.
        return ResourceClient(self.api, "nodes", "")

    def services(self, namespace: str) -> ResourceClient:
        return ResourceClient(self.api, "services", namespace)

    def configmaps(self, namespace: str) -> ResourceClient:
        return ResourceClient(self.api, "configmaps", namespace)

    def secrets(self, namespace: str) -> ResourceClient:
        return ResourceClient(self.api, "secrets", namespace)

    def jobs(self, namespace: str) -> ResourceClient:
        return ResourceClient(self.api, "jobs", namespace)

    def events(self, namespace: str) -> ResourceClient:
        return ResourceClient(self.api, "events", namespace)

    def leases(self, namespace: str) -> ResourceClient:
        return ResourceClient(self.api, "leases", namespace)


class SchedulingClient:
    """Gang-scheduling PodGroups (volcano clientset analog)."""

    def __init__(self, api: Union[InMemoryAPIServer, KubeAPIServer]):
        self.api = api

    def podgroups(self, namespace: str) -> ResourceClient:
        return ResourceClient(self.api, "podgroups", namespace)


class TPUJobResourceClient:
    """Namespaced CRUD for TPUJobs, TPUJob-typed."""

    def __init__(self, api: Union[InMemoryAPIServer, KubeAPIServer],
                 namespace: str):
        self._api = api
        self.namespace = namespace

    def _localize(self, job: TPUJob) -> dict:
        d = job.to_dict()
        d["metadata"].setdefault("namespace", self.namespace)
        return d

    def create(self, job: TPUJob) -> TPUJob:
        return TPUJob.from_dict(self._api.create("tpujobs", self._localize(job)))

    def get(self, name: str) -> TPUJob:
        return TPUJob.from_dict(self._api.get("tpujobs", self.namespace, name))

    def list(self, label_selector: Optional[dict[str, str]] = None) -> list[TPUJob]:
        return [
            TPUJob.from_dict(d)
            for d in self._api.list("tpujobs", self.namespace, label_selector)
        ]

    def update(self, job: TPUJob) -> TPUJob:
        return TPUJob.from_dict(self._api.update("tpujobs", self._localize(job)))

    def update_status(self, job: TPUJob) -> TPUJob:
        return TPUJob.from_dict(self._api.update_status("tpujobs", self._localize(job)))

    def delete(self, name: str) -> None:
        self._api.delete("tpujobs", self.namespace, name)


class TPUJobClient:
    def __init__(self, api: Union[InMemoryAPIServer, KubeAPIServer]):
        self.api = api

    def tpujobs(self, namespace: str) -> TPUJobResourceClient:
        return TPUJobResourceClient(self.api, namespace)
