"""ClusterQueue / LocalQueue API types (group ``kubeflow.org``, version
``v2beta1``; the port's copy of ``mpi_operator_tpu/api/v2beta1/queue_types.py``,
with quotas counted in GPUs).

Kueue analog (sigs.k8s.io/kueue): the reference operator's production
story gates MPIJobs behind Kueue, which admits suspended jobs against
per-queue quotas.  This in-repo counterpart keeps the same two-level
shape, collapsed to the one resource GPU fleets ration — GPUs
(``nvidia.com/gpu``):

- ``ClusterQueue`` (cluster-scoped) owns a nominal GPU quota per GPU
  generation (``h100``), may join a *cohort* whose members lend each other unused
  quota (bounded by ``borrowingLimit``), and declares whether it reclaims
  lent quota by evicting borrowers (``preemption.reclaimWithinCohort``).
- ``LocalQueue`` (namespaced) is the submission point: a TPUJob names a
  LocalQueue via ``spec.runPolicy.schedulingPolicy.queue``, and the
  LocalQueue binds that namespace to one ClusterQueue.

Both follow the TPUJob dataclass idiom (types.py): camelCase wire form,
empty/None fields omitted from ``to_dict``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Optional

from ...runtime.objects import ObjectMeta
from .types import API_VERSION

CLUSTER_QUEUE_KIND = "ClusterQueue"
CLUSTER_QUEUE_PLURAL = "clusterqueues"
LOCAL_QUEUE_KIND = "LocalQueue"
LOCAL_QUEUE_PLURAL = "localqueues"

# preemption.reclaimWithinCohort values (Kueue vocabulary): Never = lent
# quota comes back only as borrowers finish; Any = evict the youngest
# borrowing workloads when an owner needs its nominal quota back.
RECLAIM_NEVER = "Never"
RECLAIM_ANY = "Any"


@dataclass
class GenerationQuota:
    """GPU quota of one ClusterQueue for one GPU generation.

    ``nominal_quota`` is the GPU count this queue owns outright;
    ``borrowing_limit`` caps how many GPUs it may borrow on top from
    cohort peers (None = unbounded, Kueue's default)."""

    generation: str = ""
    nominal_quota: int = 0
    borrowing_limit: Optional[int] = None

    def to_dict(self) -> dict:
        d: dict[str, Any] = {}
        if self.generation:
            d["generation"] = self.generation
        d["nominalQuota"] = self.nominal_quota
        if self.borrowing_limit is not None:
            d["borrowingLimit"] = self.borrowing_limit
        return d

    @classmethod
    def from_dict(cls, d: Optional[dict]) -> "GenerationQuota":
        d = d or {}
        return cls(
            generation=d.get("generation", ""),
            nominal_quota=int(d.get("nominalQuota", 0) or 0),
            borrowing_limit=d.get("borrowingLimit"),
        )


@dataclass
class PreemptionPolicy:
    reclaim_within_cohort: str = RECLAIM_NEVER

    def to_dict(self) -> dict:
        d: dict[str, Any] = {}
        if self.reclaim_within_cohort:
            d["reclaimWithinCohort"] = self.reclaim_within_cohort
        return d

    @classmethod
    def from_dict(cls, d: Optional[dict]) -> "PreemptionPolicy":
        d = d or {}
        return cls(
            reclaim_within_cohort=d.get("reclaimWithinCohort", RECLAIM_NEVER)
        )


@dataclass
class ClusterQueueSpec:
    cohort: str = ""
    quotas: list[GenerationQuota] = field(default_factory=list)
    preemption: PreemptionPolicy = field(default_factory=PreemptionPolicy)

    def to_dict(self) -> dict:
        d: dict[str, Any] = {}
        if self.cohort:
            d["cohort"] = self.cohort
        if self.quotas:
            d["quotas"] = [q.to_dict() for q in self.quotas]
        preemption = self.preemption.to_dict()
        if preemption:
            d["preemption"] = preemption
        return d

    @classmethod
    def from_dict(cls, d: Optional[dict]) -> "ClusterQueueSpec":
        d = d or {}
        return cls(
            cohort=d.get("cohort", ""),
            quotas=[GenerationQuota.from_dict(q) for q in d.get("quotas") or []],
            preemption=PreemptionPolicy.from_dict(d.get("preemption")),
        )


@dataclass
class ClusterQueueStatus:
    """Mirrored by the QueueManager: how the queue currently stands."""

    pending_workloads: int = 0
    admitted_workloads: int = 0
    # generation -> GPUs currently admitted against this queue.
    usage: dict[str, int] = field(default_factory=dict)

    def to_dict(self) -> dict:
        d: dict[str, Any] = {}
        if self.pending_workloads:
            d["pendingWorkloads"] = self.pending_workloads
        if self.admitted_workloads:
            d["admittedWorkloads"] = self.admitted_workloads
        if self.usage:
            d["usage"] = dict(self.usage)
        return d

    @classmethod
    def from_dict(cls, d: Optional[dict]) -> "ClusterQueueStatus":
        d = d or {}
        return cls(
            pending_workloads=int(d.get("pendingWorkloads", 0) or 0),
            admitted_workloads=int(d.get("admittedWorkloads", 0) or 0),
            usage={k: int(v) for k, v in (d.get("usage") or {}).items()},
        )


@dataclass
class ClusterQueue:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: ClusterQueueSpec = field(default_factory=ClusterQueueSpec)
    status: ClusterQueueStatus = field(default_factory=ClusterQueueStatus)

    api_version: str = API_VERSION
    kind: str = CLUSTER_QUEUE_KIND

    @property
    def name(self) -> str:
        return self.metadata.name

    def quota_for(self, generation: str) -> Optional[GenerationQuota]:
        for quota in self.spec.quotas:
            if quota.generation == generation:
                return quota
        return None

    def to_dict(self) -> dict:
        d: dict[str, Any] = {
            "apiVersion": self.api_version,
            "kind": self.kind,
            "metadata": self.metadata.to_dict(),
            "spec": self.spec.to_dict(),
        }
        status = self.status.to_dict()
        if status:
            d["status"] = status
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "ClusterQueue":
        return cls(
            api_version=d.get("apiVersion", API_VERSION),
            kind=d.get("kind", CLUSTER_QUEUE_KIND),
            metadata=ObjectMeta.from_dict(d.get("metadata")),
            spec=ClusterQueueSpec.from_dict(d.get("spec")),
            status=ClusterQueueStatus.from_dict(d.get("status")),
        )

    def deep_copy(self) -> "ClusterQueue":
        return ClusterQueue.from_dict(self.to_dict())


@dataclass
class LocalQueueSpec:
    cluster_queue: str = ""

    def to_dict(self) -> dict:
        d: dict[str, Any] = {}
        if self.cluster_queue:
            d["clusterQueue"] = self.cluster_queue
        return d

    @classmethod
    def from_dict(cls, d: Optional[dict]) -> "LocalQueueSpec":
        d = d or {}
        return cls(cluster_queue=d.get("clusterQueue", ""))


@dataclass
class LocalQueue:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: LocalQueueSpec = field(default_factory=LocalQueueSpec)

    api_version: str = API_VERSION
    kind: str = LOCAL_QUEUE_KIND

    @property
    def name(self) -> str:
        return self.metadata.name

    @property
    def namespace(self) -> str:
        return self.metadata.namespace

    def to_dict(self) -> dict:
        return {
            "apiVersion": self.api_version,
            "kind": self.kind,
            "metadata": self.metadata.to_dict(),
            "spec": self.spec.to_dict(),
        }

    @classmethod
    def from_dict(cls, d: dict) -> "LocalQueue":
        return cls(
            api_version=d.get("apiVersion", API_VERSION),
            kind=d.get("kind", LOCAL_QUEUE_KIND),
            metadata=ObjectMeta.from_dict(d.get("metadata")),
            spec=LocalQueueSpec.from_dict(d.get("spec")),
        )
