"""TPUJob API types (group ``kubeflow.org``, version ``v2beta1``).

A TPUJob declares a gang of TPU worker pods forming one (or more) pod
slices, plus an optional CPU-only launcher Job for orchestration duties.

Redesign of the reference MPIJob API
(/root/reference/v2/pkg/apis/kubeflow/v2beta1/types.go:25-81) for TPU:

- ``slotsPerWorker`` + ``mpiImplementation``  →  ``tpu:`` block
  (acceleratorType/topology), from which worker count and chips-per-pod
  are *derived* (see api/topology.py).
- ``sshAuthMountPath`` (the SSH rendezvous) →  ``jaxDistribution:`` block:
  workers rendezvous via ``jax.distributed.initialize`` against worker-0's
  coordinator port, so there is no per-job SSH Secret at all.
- Launcher is *optional* (TPU jobs are SPMD: every worker runs the same
  program); the reference required it because only `mpirun` knew how to
  start ranks.  Worker is *required* — the inverse of the reference's
  validation (validation.go:117-136).

Status reuses the kubeflow-common shape: conditions
(Created/Running/Restarting/Succeeded/Failed), per-replica-type counts, and
start/completion timestamps (kubeflow/common JobStatus, consumed at
/root/reference/v2/pkg/controller/mpi_job_controller_status.go:38-142).
"""

from __future__ import annotations

import copy
from dataclasses import dataclass, field
from typing import Any, Optional

from ...runtime.objects import ObjectMeta

GROUP_NAME = "kubeflow.org"
GROUP_VERSION = "v2beta1"
API_VERSION = f"{GROUP_NAME}/{GROUP_VERSION}"
KIND = "TPUJob"
PLURAL = "tpujobs"

# Replica types.
REPLICA_TYPE_LAUNCHER = "Launcher"
REPLICA_TYPE_WORKER = "Worker"

# Restart policies (subset of core/v1 allowed for replica specs,
# reference analog: validation.go:40-44).
RESTART_POLICY_NEVER = "Never"
RESTART_POLICY_ON_FAILURE = "OnFailure"

# CleanPodPolicy values (kubeflow-common analog).
CLEAN_POD_POLICY_NONE = "None"
CLEAN_POD_POLICY_RUNNING = "Running"
CLEAN_POD_POLICY_ALL = "All"

# Job condition types (kubeflow-common analog, consumed by
# mpi_job_controller_status.go).
JOB_CREATED = "Created"
JOB_SCHEDULED = "Scheduled"
JOB_RUNNING = "Running"
JOB_RESTARTING = "Restarting"
JOB_SUSPENDED = "Suspended"
JOB_SUCCEEDED = "Succeeded"
JOB_FAILED = "Failed"
# Admission-queue condition types (Kueue Workload-condition analogs,
# written by queue/manager.py when --enable-queue is on).
JOB_QUOTA_RESERVED = "QuotaReserved"
JOB_QUEUE_NOT_FOUND = "QueueNotFound"
# Step-skew observatory verdict (utils/stepstats.py): True while the
# gang has a detected straggler, flipped False on recovery.  Orthogonal
# to the lifecycle conditions — a Straggling job is still Running.
JOB_STRAGGLING = "Straggling"
# Device-memory observatory verdict (utils/devstats.py): True while the
# fleet HBM watermark trend projects exhaustion within the pressure
# horizon, flipped False on recovery.  Same orthogonality as Straggling.
JOB_MEMORY_PRESSURE = "MemoryPressure"

# podFailurePolicy actions (batch/v1 PodFailurePolicyAction analog, with
# ``Restart`` standing in for batch's ``Count`` — the TPU operator
# replaces failed workers rather than tallying them).
POD_FAILURE_POLICY_ACTION_IGNORE = "Ignore"
POD_FAILURE_POLICY_ACTION_RESTART = "Restart"
POD_FAILURE_POLICY_ACTION_FAIL_JOB = "FailJob"
# onExitCodes operators (batch/v1 PodFailurePolicyOnExitCodesOperator).
POD_FAILURE_POLICY_OP_IN = "In"
POD_FAILURE_POLICY_OP_NOT_IN = "NotIn"
# Condition reason when a FailJob rule terminates the job.
JOB_POD_FAILURE_POLICY_REASON = "PodFailurePolicy"


@dataclass
class PodFailurePolicyOnExitCodes:
    """Exit-code requirement (batch/v1 PodFailurePolicyOnExitCodesRequirement).

    Matches when any terminated container (optionally restricted to
    ``container_name``) exited non-zero with a code In/NotIn ``values``.
    Exit code 0 never matches — success is not a failure class.
    """

    operator: str = POD_FAILURE_POLICY_OP_IN
    values: list[int] = field(default_factory=list)
    container_name: str = ""

    def matches(self, pod: dict) -> bool:
        codes = _terminated_exit_codes(pod, self.container_name)
        if self.operator == POD_FAILURE_POLICY_OP_NOT_IN:
            return any(c != 0 and c not in self.values for c in codes)
        return any(c != 0 and c in self.values for c in codes)

    def to_dict(self) -> dict:
        d: dict[str, Any] = {"operator": self.operator, "values": list(self.values)}
        if self.container_name:
            d["containerName"] = self.container_name
        return d

    @classmethod
    def from_dict(cls, d: Optional[dict]) -> "PodFailurePolicyOnExitCodes":
        d = d or {}
        return cls(
            operator=d.get("operator", POD_FAILURE_POLICY_OP_IN),
            values=[int(v) for v in d.get("values") or []],
            container_name=d.get("containerName", ""),
        )


@dataclass
class PodFailurePolicyOnPodCondition:
    """Pod-condition requirement (batch/v1 ...OnPodConditionsPattern).

    ``reason`` is a TPU extension: the in-process kubelet reports failure
    classes (Evicted, NodeLost, Error) through ``status.reason`` rather
    than synthetic conditions, so rules may match on it directly.
    """

    type: str = ""
    status: str = "True"
    reason: str = ""

    def matches(self, pod: dict) -> bool:
        status = pod.get("status") or {}
        if self.reason and status.get("reason") != self.reason:
            return False
        if self.type:
            for cond in status.get("conditions") or []:
                if cond.get("type") == self.type and cond.get("status") == self.status:
                    break
            else:
                return False
        return bool(self.reason or self.type)

    def to_dict(self) -> dict:
        d: dict[str, Any] = {}
        if self.type:
            d["type"] = self.type
            d["status"] = self.status
        if self.reason:
            d["reason"] = self.reason
        return d

    @classmethod
    def from_dict(cls, d: Optional[dict]) -> "PodFailurePolicyOnPodCondition":
        d = d or {}
        return cls(
            type=d.get("type", ""),
            status=d.get("status", "True"),
            reason=d.get("reason", ""),
        )


@dataclass
class PodFailurePolicyRule:
    """One ordered rule: first match wins (batch/v1 PodFailurePolicyRule).

    Exactly one of ``on_exit_codes`` / ``on_pod_conditions`` must be set
    (validation enforces this); a rule with conditions matches when *any*
    listed pattern matches.
    """

    action: str = ""
    on_exit_codes: Optional[PodFailurePolicyOnExitCodes] = None
    on_pod_conditions: list[PodFailurePolicyOnPodCondition] = field(
        default_factory=list
    )

    def matches(self, pod: dict) -> bool:
        if self.on_exit_codes is not None:
            return self.on_exit_codes.matches(pod)
        if self.on_pod_conditions:
            return any(p.matches(pod) for p in self.on_pod_conditions)
        return False

    def to_dict(self) -> dict:
        d: dict[str, Any] = {"action": self.action}
        if self.on_exit_codes is not None:
            d["onExitCodes"] = self.on_exit_codes.to_dict()
        if self.on_pod_conditions:
            d["onPodConditions"] = [p.to_dict() for p in self.on_pod_conditions]
        return d

    @classmethod
    def from_dict(cls, d: Optional[dict]) -> "PodFailurePolicyRule":
        d = d or {}
        return cls(
            action=d.get("action", ""),
            on_exit_codes=(
                PodFailurePolicyOnExitCodes.from_dict(d["onExitCodes"])
                if "onExitCodes" in d
                else None
            ),
            on_pod_conditions=[
                PodFailurePolicyOnPodCondition.from_dict(p)
                for p in d.get("onPodConditions") or []
            ],
        )


@dataclass
class PodFailurePolicy:
    """Ordered failure-classification rules (batch/v1 PodFailurePolicy).

    The controller consults :meth:`match` when a worker pod fails:
    ``Ignore`` replaces the pod without charging ``backoffLimit`` (TPU
    preemptions are not the job's fault), ``Restart`` replaces it and
    charges the budget, ``FailJob`` fails the whole job immediately with
    condition reason ``PodFailurePolicy`` (assertion-style exit codes
    should not burn through retries).
    """

    rules: list[PodFailurePolicyRule] = field(default_factory=list)

    def match(self, pod: dict) -> Optional[PodFailurePolicyRule]:
        for rule in self.rules:
            if rule.matches(pod):
                return rule
        return None

    def to_dict(self) -> dict:
        return {"rules": [r.to_dict() for r in self.rules]}

    @classmethod
    def from_dict(cls, d: Optional[dict]) -> "PodFailurePolicy":
        d = d or {}
        return cls(
            rules=[PodFailurePolicyRule.from_dict(r) for r in d.get("rules") or []]
        )


def _terminated_exit_codes(pod: dict, container_name: str = "") -> list[int]:
    """Exit codes of terminated containers, from containerStatuses."""
    codes: list[int] = []
    status = pod.get("status") or {}
    for cs in status.get("containerStatuses") or []:
        if container_name and cs.get("name") != container_name:
            continue
        terminated = (cs.get("state") or {}).get("terminated") or {}
        code = terminated.get("exitCode")
        if code is not None:
            codes.append(int(code))
    return codes


@dataclass
class SchedulingPolicy:
    """Gang-scheduling knobs (kubeflow-common SchedulingPolicy analog)."""

    min_available: Optional[int] = None
    queue: str = ""
    priority_class: str = ""

    def to_dict(self) -> dict:
        d: dict[str, Any] = {}
        if self.min_available is not None:
            d["minAvailable"] = self.min_available
        if self.queue:
            d["queue"] = self.queue
        if self.priority_class:
            d["priorityClass"] = self.priority_class
        return d

    @classmethod
    def from_dict(cls, d: Optional[dict]) -> "SchedulingPolicy":
        d = d or {}
        return cls(
            min_available=d.get("minAvailable"),
            queue=d.get("queue", ""),
            priority_class=d.get("priorityClass", ""),
        )


@dataclass
class RunPolicy:
    """Runtime policies (kubeflow-common RunPolicy analog).

    ``ttl_seconds_after_finished`` / ``active_deadline_seconds`` /
    ``backoff_limit`` pass through to the launcher batch Job exactly like
    the reference does (mpi_job_controller.go:1318-1323); for launcher-less
    jobs the controller enforces them itself.
    """

    clean_pod_policy: Optional[str] = None
    ttl_seconds_after_finished: Optional[int] = None
    active_deadline_seconds: Optional[int] = None
    backoff_limit: Optional[int] = None
    scheduling_policy: Optional[SchedulingPolicy] = None
    suspend: Optional[bool] = None
    pod_failure_policy: Optional[PodFailurePolicy] = None

    def to_dict(self) -> dict:
        d: dict[str, Any] = {}
        if self.clean_pod_policy is not None:
            d["cleanPodPolicy"] = self.clean_pod_policy
        if self.ttl_seconds_after_finished is not None:
            d["ttlSecondsAfterFinished"] = self.ttl_seconds_after_finished
        if self.active_deadline_seconds is not None:
            d["activeDeadlineSeconds"] = self.active_deadline_seconds
        if self.backoff_limit is not None:
            d["backoffLimit"] = self.backoff_limit
        if self.scheduling_policy is not None:
            d["schedulingPolicy"] = self.scheduling_policy.to_dict()
        if self.suspend is not None:
            d["suspend"] = self.suspend
        if self.pod_failure_policy is not None:
            d["podFailurePolicy"] = self.pod_failure_policy.to_dict()
        return d

    @classmethod
    def from_dict(cls, d: Optional[dict]) -> "RunPolicy":
        d = d or {}
        return cls(
            clean_pod_policy=d.get("cleanPodPolicy"),
            ttl_seconds_after_finished=d.get("ttlSecondsAfterFinished"),
            active_deadline_seconds=d.get("activeDeadlineSeconds"),
            backoff_limit=d.get("backoffLimit"),
            scheduling_policy=(
                SchedulingPolicy.from_dict(d["schedulingPolicy"])
                if "schedulingPolicy" in d
                else None
            ),
            suspend=d.get("suspend"),
            pod_failure_policy=(
                PodFailurePolicy.from_dict(d["podFailurePolicy"])
                if "podFailurePolicy" in d
                else None
            ),
        )


@dataclass
class TPUSpec:
    """The TPU slice this job trains on.

    ``accelerator_type`` is ``<generation>-<chips>`` (e.g. ``v5e-16``);
    ``topology`` optionally pins the slice shape (``4x4``); ``num_slices``
    > 1 asks for a multislice job (data-parallel over DCN);
    ``hot_spares`` > 0 over-provisions that many standby workers kept
    warm (scheduled, bootstrapped, parked before the barrier) so a
    restart-eligible worker death is repaired by promotion instead of
    the full schedule→pending→bootstrap pipeline.
    """

    accelerator_type: str = ""
    topology: str = ""
    num_slices: int = 1
    runtime_version: str = ""
    hot_spares: int = 0

    def to_dict(self) -> dict:
        d: dict[str, Any] = {}
        if self.accelerator_type:
            d["acceleratorType"] = self.accelerator_type
        if self.topology:
            d["topology"] = self.topology
        if self.num_slices != 1:
            d["numSlices"] = self.num_slices
        if self.runtime_version:
            d["runtimeVersion"] = self.runtime_version
        if self.hot_spares != 0:
            d["hotSpares"] = self.hot_spares
        return d

    @classmethod
    def from_dict(cls, d: Optional[dict]) -> "TPUSpec":
        d = d or {}
        num_slices = d.get("numSlices")
        hot_spares = d.get("hotSpares")
        return cls(
            accelerator_type=d.get("acceleratorType", ""),
            topology=d.get("topology", ""),
            # An explicit invalid value (0, negative) is preserved so
            # validation can reject it; only absence defaults to 1.
            num_slices=1 if num_slices is None else int(num_slices),
            runtime_version=d.get("runtimeVersion", ""),
            # Same preservation contract: absence defaults to 0, an
            # explicit negative survives for validation to reject.
            hot_spares=0 if hot_spares is None else int(hot_spares),
        )


@dataclass
class JAXDistributionSpec:
    """Rendezvous wiring for ``jax.distributed.initialize``.

    Replaces the reference's SSH bootstrap block (``sshAuthMountPath`` +
    generated Secret, mpi_job_controller.go:1178-1213): the only shared
    state TPU workers need is the coordinator address, which is always
    worker-0's stable DNS name plus this port.
    """

    coordinator_port: int = 0
    heartbeat_timeout_seconds: Optional[int] = None

    def to_dict(self) -> dict:
        d: dict[str, Any] = {}
        if self.coordinator_port:
            d["coordinatorPort"] = self.coordinator_port
        if self.heartbeat_timeout_seconds is not None:
            d["heartbeatTimeoutSeconds"] = self.heartbeat_timeout_seconds
        return d

    @classmethod
    def from_dict(cls, d: Optional[dict]) -> "JAXDistributionSpec":
        d = d or {}
        return cls(
            coordinator_port=int(d.get("coordinatorPort", 0) or 0),
            heartbeat_timeout_seconds=d.get("heartbeatTimeoutSeconds"),
        )


@dataclass
class ReplicaSpec:
    """One replica group (kubeflow-common ReplicaSpec analog).

    ``template`` is a PodTemplateSpec kept in plain dict form (the operator
    treats it as opaque except for the fields it decorates).
    """

    replicas: Optional[int] = None
    restart_policy: str = ""
    template: dict = field(default_factory=dict)

    def to_dict(self) -> dict:
        d: dict[str, Any] = {}
        if self.replicas is not None:
            d["replicas"] = self.replicas
        if self.restart_policy:
            d["restartPolicy"] = self.restart_policy
        if self.template:
            d["template"] = copy.deepcopy(self.template)
        return d

    @classmethod
    def from_dict(cls, d: Optional[dict]) -> "ReplicaSpec":
        d = d or {}
        return cls(
            replicas=d.get("replicas"),
            restart_policy=d.get("restartPolicy", ""),
            template=copy.deepcopy(d.get("template") or {}),
        )


@dataclass
class TPUJobSpec:
    tpu: TPUSpec = field(default_factory=TPUSpec)
    jax_distribution: JAXDistributionSpec = field(default_factory=JAXDistributionSpec)
    run_policy: RunPolicy = field(default_factory=RunPolicy)
    replica_specs: dict[str, ReplicaSpec] = field(default_factory=dict)

    def to_dict(self) -> dict:
        d: dict[str, Any] = {}
        tpu = self.tpu.to_dict()
        if tpu:
            d["tpu"] = tpu
        jd = self.jax_distribution.to_dict()
        if jd:
            d["jaxDistribution"] = jd
        rp = self.run_policy.to_dict()
        if rp:
            d["runPolicy"] = rp
        if self.replica_specs:
            d["tpuReplicaSpecs"] = {
                k: v.to_dict() for k, v in self.replica_specs.items()
            }
        return d

    @classmethod
    def from_dict(cls, d: Optional[dict]) -> "TPUJobSpec":
        d = d or {}
        return cls(
            tpu=TPUSpec.from_dict(d.get("tpu")),
            jax_distribution=JAXDistributionSpec.from_dict(d.get("jaxDistribution")),
            run_policy=RunPolicy.from_dict(d.get("runPolicy")),
            replica_specs={
                k: ReplicaSpec.from_dict(v)
                for k, v in (d.get("tpuReplicaSpecs") or {}).items()
            },
        )


@dataclass
class JobCondition:
    type: str = ""
    status: str = ""  # "True" | "False" | "Unknown"
    reason: str = ""
    message: str = ""
    last_update_time: Optional[float] = None
    last_transition_time: Optional[float] = None

    def to_dict(self) -> dict:
        d: dict[str, Any] = {"type": self.type, "status": self.status}
        if self.reason:
            d["reason"] = self.reason
        if self.message:
            d["message"] = self.message
        if self.last_update_time is not None:
            d["lastUpdateTime"] = self.last_update_time
        if self.last_transition_time is not None:
            d["lastTransitionTime"] = self.last_transition_time
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "JobCondition":
        return cls(
            type=d.get("type", ""),
            status=d.get("status", ""),
            reason=d.get("reason", ""),
            message=d.get("message", ""),
            last_update_time=d.get("lastUpdateTime"),
            last_transition_time=d.get("lastTransitionTime"),
        )


@dataclass
class ReplicaStatus:
    active: int = 0
    succeeded: int = 0
    failed: int = 0
    # Cumulative failure-replacements for launcher-less elastic jobs (the
    # analog of a batch Job's retry count: runPolicy.backoffLimit bounds
    # it). Unlike active/succeeded/failed this survives pod replacement.
    restarts: int = 0

    def to_dict(self) -> dict:
        d: dict[str, Any] = {}
        if self.active:
            d["active"] = self.active
        if self.succeeded:
            d["succeeded"] = self.succeeded
        if self.failed:
            d["failed"] = self.failed
        if self.restarts:
            d["restarts"] = self.restarts
        return d

    @classmethod
    def from_dict(cls, d: Optional[dict]) -> "ReplicaStatus":
        d = d or {}
        return cls(
            active=int(d.get("active", 0) or 0),
            succeeded=int(d.get("succeeded", 0) or 0),
            failed=int(d.get("failed", 0) or 0),
            restarts=int(d.get("restarts", 0) or 0),
        )


@dataclass
class JobStatus:
    conditions: list[JobCondition] = field(default_factory=list)
    replica_statuses: dict[str, ReplicaStatus] = field(default_factory=dict)
    start_time: Optional[float] = None
    completion_time: Optional[float] = None
    last_reconcile_time: Optional[float] = None

    def to_dict(self) -> dict:
        d: dict[str, Any] = {}
        if self.conditions:
            d["conditions"] = [c.to_dict() for c in self.conditions]
        if self.replica_statuses:
            d["replicaStatuses"] = {
                k: v.to_dict() for k, v in self.replica_statuses.items()
            }
        if self.start_time is not None:
            d["startTime"] = self.start_time
        if self.completion_time is not None:
            d["completionTime"] = self.completion_time
        if self.last_reconcile_time is not None:
            d["lastReconcileTime"] = self.last_reconcile_time
        return d

    @classmethod
    def from_dict(cls, d: Optional[dict]) -> "JobStatus":
        d = d or {}
        return cls(
            conditions=[JobCondition.from_dict(c) for c in d.get("conditions") or []],
            replica_statuses={
                k: ReplicaStatus.from_dict(v)
                for k, v in (d.get("replicaStatuses") or {}).items()
            },
            start_time=d.get("startTime"),
            completion_time=d.get("completionTime"),
            last_reconcile_time=d.get("lastReconcileTime"),
        )


@dataclass
class TPUJob:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: TPUJobSpec = field(default_factory=TPUJobSpec)
    status: JobStatus = field(default_factory=JobStatus)

    api_version: str = API_VERSION
    kind: str = KIND

    @property
    def name(self) -> str:
        return self.metadata.name

    @property
    def namespace(self) -> str:
        return self.metadata.namespace

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
    def from_dict(cls, d: dict) -> "TPUJob":
        return cls(
            api_version=d.get("apiVersion", API_VERSION),
            kind=d.get("kind", KIND),
            metadata=ObjectMeta.from_dict(d.get("metadata")),
            spec=TPUJobSpec.from_dict(d.get("spec")),
            status=JobStatus.from_dict(d.get("status")),
        )

    def deep_copy(self) -> "TPUJob":
        return TPUJob.from_dict(self.to_dict())
