"""Kubernetes-shaped object model.

The operator reconciles TPUJobs into ordinary Kubernetes objects (Pods,
Services, ConfigMaps, batch Jobs, PodGroups).  This module provides the
minimal-but-faithful object model those objects share: ``ObjectMeta``,
``OwnerReference``, and a generic ``KubeObject`` wrapper whose payload
(spec/status/data) stays in plain dict form, exactly as an apiserver would
store JSON.

Reference analog: k8s.io/apimachinery/pkg/apis/meta/v1 as consumed by
/root/reference/v2/pkg/apis/kubeflow/v2beta1/types.go:25-38 and the object
builders in /root/reference/v2/pkg/controller/mpi_job_controller.go:1103-1546.
"""

from __future__ import annotations

import copy
import re
from dataclasses import dataclass, field
from typing import Any, Optional

DNS1123_LABEL_RE = re.compile(r"^[a-z0-9]([-a-z0-9]*[a-z0-9])?$")
DNS1123_LABEL_MAX = 63


def is_dns1123_label(value: str) -> list[str]:
    """Validate an RFC 1123 DNS label; returns a list of error strings.

    Reference analog: k8s.io/apimachinery/pkg/util/validation.IsDNS1123Label
    as used in /root/reference/v2/pkg/apis/kubeflow/validation/validation.go:62.
    """
    errs = []
    if len(value) > DNS1123_LABEL_MAX:
        errs.append(f"must be no more than {DNS1123_LABEL_MAX} characters")
    if not DNS1123_LABEL_RE.match(value):
        errs.append(
            "a lowercase RFC 1123 label must consist of lower case "
            "alphanumeric characters or '-', and must start and end with an "
            "alphanumeric character"
        )
    return errs


@dataclass
class OwnerReference:
    api_version: str = ""
    kind: str = ""
    name: str = ""
    uid: str = ""
    controller: bool = False
    block_owner_deletion: bool = False

    def to_dict(self) -> dict:
        return {
            "apiVersion": self.api_version,
            "kind": self.kind,
            "name": self.name,
            "uid": self.uid,
            "controller": self.controller,
            "blockOwnerDeletion": self.block_owner_deletion,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "OwnerReference":
        return cls(
            api_version=d.get("apiVersion", ""),
            kind=d.get("kind", ""),
            name=d.get("name", ""),
            uid=d.get("uid", ""),
            controller=bool(d.get("controller", False)),
            block_owner_deletion=bool(d.get("blockOwnerDeletion", False)),
        )


@dataclass
class ObjectMeta:
    name: str = ""
    namespace: str = ""
    labels: dict[str, str] = field(default_factory=dict)
    annotations: dict[str, str] = field(default_factory=dict)
    uid: str = ""
    resource_version: str = ""
    generation: int = 0
    creation_timestamp: Optional[float] = None
    deletion_timestamp: Optional[float] = None
    owner_references: list[OwnerReference] = field(default_factory=list)
    finalizers: list[str] = field(default_factory=list)

    def to_dict(self) -> dict:
        d: dict[str, Any] = {}
        if self.name:
            d["name"] = self.name
        if self.namespace:
            d["namespace"] = self.namespace
        if self.labels:
            d["labels"] = dict(self.labels)
        if self.annotations:
            d["annotations"] = dict(self.annotations)
        if self.uid:
            d["uid"] = self.uid
        if self.resource_version:
            d["resourceVersion"] = self.resource_version
        if self.generation:
            d["generation"] = self.generation
        if self.creation_timestamp is not None:
            d["creationTimestamp"] = self.creation_timestamp
        if self.deletion_timestamp is not None:
            d["deletionTimestamp"] = self.deletion_timestamp
        if self.owner_references:
            d["ownerReferences"] = [r.to_dict() for r in self.owner_references]
        if self.finalizers:
            d["finalizers"] = list(self.finalizers)
        return d

    @classmethod
    def from_dict(cls, d: Optional[dict]) -> "ObjectMeta":
        d = d or {}
        return cls(
            name=d.get("name", ""),
            namespace=d.get("namespace", ""),
            labels=dict(d.get("labels") or {}),
            annotations=dict(d.get("annotations") or {}),
            uid=d.get("uid", ""),
            resource_version=d.get("resourceVersion", ""),
            generation=int(d.get("generation", 0) or 0),
            creation_timestamp=d.get("creationTimestamp"),
            deletion_timestamp=d.get("deletionTimestamp"),
            owner_references=[
                OwnerReference.from_dict(r) for r in d.get("ownerReferences") or []
            ],
            finalizers=list(d.get("finalizers") or []),
        )


class KubeObject:
    """A generic Kubernetes object: typed metadata + dict payload.

    The payload keys (``spec``, ``status``, ``data`` ...) mirror the JSON an
    apiserver stores, so golden-object tests compare plain dicts, and the
    in-memory API server round-trips without information loss.
    """

    def __init__(
        self,
        api_version: str = "",
        kind: str = "",
        metadata: Optional[ObjectMeta] = None,
        **payload: Any,
    ):
        self.api_version = api_version
        self.kind = kind
        self.metadata = metadata or ObjectMeta()
        self.payload: dict[str, Any] = dict(payload)

    # Convenience accessors for the common payload members.
    @property
    def spec(self) -> dict:
        return self.payload.setdefault("spec", {})

    @spec.setter
    def spec(self, value: dict) -> None:
        self.payload["spec"] = value

    @property
    def status(self) -> dict:
        return self.payload.setdefault("status", {})

    @status.setter
    def status(self, value: dict) -> None:
        self.payload["status"] = value

    @property
    def data(self) -> dict:
        return self.payload.setdefault("data", {})

    @data.setter
    def data(self, value: dict) -> None:
        self.payload["data"] = value

    @property
    def name(self) -> str:
        return self.metadata.name

    @property
    def namespace(self) -> str:
        return self.metadata.namespace

    def to_dict(self) -> dict:
        d = {
            "apiVersion": self.api_version,
            "kind": self.kind,
            "metadata": self.metadata.to_dict(),
        }
        for k, v in self.payload.items():
            # Empty payload members are omitted, the way an apiserver omits
            # empty optional fields — so merely reading `.spec` (whose getter
            # installs an empty dict for ergonomic mutation) never changes
            # the serialized form or equality.
            if v is None or v == {}:
                continue
            d[k] = copy.deepcopy(v)
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "KubeObject":
        payload = {
            k: copy.deepcopy(v)
            for k, v in d.items()
            if k not in ("apiVersion", "kind", "metadata")
        }
        return cls(
            api_version=d.get("apiVersion", ""),
            kind=d.get("kind", ""),
            metadata=ObjectMeta.from_dict(d.get("metadata")),
            **payload,
        )

    def deep_copy(self) -> "KubeObject":
        return KubeObject.from_dict(self.to_dict())

    def __repr__(self) -> str:  # pragma: no cover
        return f"<KubeObject {self.kind} {self.metadata.namespace}/{self.metadata.name}>"

    def __eq__(self, other: object) -> bool:
        if not isinstance(other, KubeObject):
            return NotImplemented
        return self.to_dict() == other.to_dict()


def new_controller_ref(owner: Any, api_version: str, kind: str) -> OwnerReference:
    """Build the controller OwnerReference for objects created for ``owner``.

    Reference analog: metav1.NewControllerRef as called in
    /root/reference/v2/pkg/controller/mpi_job_controller.go:1124 etc.
    """
    meta = owner.metadata if hasattr(owner, "metadata") else owner
    return OwnerReference(
        api_version=api_version,
        kind=kind,
        name=meta.name,
        uid=meta.uid,
        controller=True,
        block_owner_deletion=True,
    )


def get_controller_of(obj: KubeObject) -> Optional[OwnerReference]:
    """Return the controlling OwnerReference, if any.

    Reference analog: metav1.GetControllerOf in
    /root/reference/v2/pkg/controller/mpi_job_controller.go:1044.
    """
    for ref in obj.metadata.owner_references:
        if ref.controller:
            return ref
    return None
