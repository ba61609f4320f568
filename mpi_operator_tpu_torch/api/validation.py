"""Field-level validation for TPUJob (the port's
``mpi_operator_tpu/api/validation.py``, the GPU variant).

Three rules differ from the JAX package's, all else is the same rule
with the same path and message:

- the accelerator is ``h100-<gpus>`` (``api/topology.py``); a TPU
  generation is refused with a message that names the GPU form;
- worker replicas == the GPU count, one pod per GPU (the JAX package:
  slice hosts x numSlices), and ``numSlices > 1`` is refused: a larger
  ``h100-N`` spans nodes instead;
- ``nvidia.com/gpu`` is accepted and ``google.com/tpu`` rejected, the
  flip of the JAX package's rule.

Reference analog: ValidateMPIJob,
/root/reference/v2/pkg/apis/kubeflow/validation/validation.go:46-152.
Same structure (an ErrorList of typed field errors with JSON paths), with
the MPI-specific rules swapped for TPU rules:

- worker hostname DNS-1123 check on ``<name>-worker-<replicas-1>``
  (validation.go:53-65 analog — worker pods get stable DNS identity);
- Worker spec required, replicas >= 1 and == the GPU count
  (inverts validation.go:117-136, where Launcher was the required one);
- Launcher optional, replicas == 1 when present (validation.go:119-127);
- restartPolicy in {Never, OnFailure} (validation.go:40-44);
- runPolicy: cleanPodPolicy in {None, Running, All}, non-negative
  ttl/activeDeadline/backoff (validation.go:88-106);
- >= 1 container per template (validation.go:146-150);
- accelerator block: acceleratorType/topology must resolve (replaces the
  slotsPerWorker/mpiImplementation checks, validation.go:70-84);
- no ``google.com/tpu`` resources anywhere.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..runtime.objects import is_dns1123_label
from . import topology
from .v2beta1 import constants
from .v2beta1.types import (
    CLEAN_POD_POLICY_ALL,
    CLEAN_POD_POLICY_NONE,
    CLEAN_POD_POLICY_RUNNING,
    POD_FAILURE_POLICY_ACTION_FAIL_JOB,
    POD_FAILURE_POLICY_ACTION_IGNORE,
    POD_FAILURE_POLICY_ACTION_RESTART,
    POD_FAILURE_POLICY_OP_IN,
    POD_FAILURE_POLICY_OP_NOT_IN,
    REPLICA_TYPE_LAUNCHER,
    REPLICA_TYPE_WORKER,
    RESTART_POLICY_NEVER,
    RESTART_POLICY_ON_FAILURE,
    ReplicaSpec,
    RunPolicy,
    TPUJob,
    TPUJobSpec,
)

VALID_CLEAN_POD_POLICIES = (
    CLEAN_POD_POLICY_NONE,
    CLEAN_POD_POLICY_RUNNING,
    CLEAN_POD_POLICY_ALL,
)
VALID_RESTART_POLICIES = (RESTART_POLICY_NEVER, RESTART_POLICY_ON_FAILURE)
VALID_POD_FAILURE_POLICY_ACTIONS = (
    POD_FAILURE_POLICY_ACTION_IGNORE,
    POD_FAILURE_POLICY_ACTION_RESTART,
    POD_FAILURE_POLICY_ACTION_FAIL_JOB,
)
VALID_POD_FAILURE_POLICY_OPERATORS = (
    POD_FAILURE_POLICY_OP_IN,
    POD_FAILURE_POLICY_OP_NOT_IN,
)


@dataclass(frozen=True)
class FieldError:
    """One validation error (k8s field.Error analog)."""

    type: str  # "Required" | "Invalid" | "NotSupported"
    field: str  # JSON path, e.g. "spec.tpuReplicaSpecs[Worker].replicas"
    value: object = None
    detail: str = ""

    def __str__(self) -> str:
        if self.type == "Required":
            return f"{self.field}: Required value: {self.detail}"
        if self.type == "NotSupported":
            return f"{self.field}: Unsupported value: {self.value!r}: {self.detail}"
        return f"{self.field}: Invalid value: {self.value!r}: {self.detail}"


def required(path: str, detail: str) -> FieldError:
    return FieldError("Required", path, detail=detail)


def invalid(path: str, value: object, detail: str) -> FieldError:
    return FieldError("Invalid", path, value=value, detail=detail)


def not_supported(path: str, value: object, supported) -> FieldError:
    return FieldError(
        "NotSupported", path, value=value, detail=f"supported values: {sorted(supported)}"
    )


def validate_tpujob(job: TPUJob) -> list[FieldError]:
    errs = _validate_job_name(job)
    errs += _validate_spec(job.spec, "spec")
    return errs


def _validate_job_name(job: TPUJob) -> list[FieldError]:
    # validation.go:53-65 analog: the longest generated pod hostname must be
    # a valid DNS-1123 label.
    replicas = 1
    worker = job.spec.replica_specs.get(REPLICA_TYPE_WORKER)
    if worker is not None and worker.replicas is not None and worker.replicas > 0:
        replicas = worker.replicas
    hostname = f"{job.metadata.name}-worker-{replicas - 1}"
    label_errs = is_dns1123_label(hostname)
    if label_errs:
        return [
            invalid(
                "metadata.name",
                job.metadata.name,
                f"will not be able to create pod with invalid DNS label "
                f"{hostname!r}: {'; '.join(label_errs)}",
            )
        ]
    return []


def _validate_spec(spec: TPUJobSpec, path: str) -> list[FieldError]:
    errs = _validate_replica_specs(spec, f"{path}.tpuReplicaSpecs")
    errs += _validate_tpu(spec, path)
    errs += _validate_run_policy(spec.run_policy, f"{path}.runPolicy")
    if spec.jax_distribution.coordinator_port <= 0:
        errs.append(
            required(
                f"{path}.jaxDistribution.coordinatorPort",
                "must have a coordinator port for torch.distributed rendezvous",
            )
        )
    elif not (0 < spec.jax_distribution.coordinator_port < 65536):
        errs.append(
            invalid(
                f"{path}.jaxDistribution.coordinatorPort",
                spec.jax_distribution.coordinator_port,
                "must be a valid port number",
            )
        )
    elif spec.tpu.num_slices > 1:
        # Refused in _validate_tpu; kept so the rule set stays the JAX
        # package's. Worker 0 of a multislice job would bind the store on
        # coordinatorPort, the gang barrier on coordinatorPort+1 and the
        # megascale coordinator on DEFAULT_MEGASCALE_PORT.
        port = spec.jax_distribution.coordinator_port
        if constants.DEFAULT_MEGASCALE_PORT in (port, port + 1):
            errs.append(
                invalid(
                    f"{path}.jaxDistribution.coordinatorPort",
                    port,
                    f"coordinatorPort and coordinatorPort+1 must not collide "
                    f"with the megascale DCN port "
                    f"{constants.DEFAULT_MEGASCALE_PORT} when numSlices > 1",
                )
            )
    return errs


def _validate_tpu(spec: TPUJobSpec, spec_path: str) -> list[FieldError]:
    errs: list[FieldError] = []
    tpu = spec.tpu
    path = f"{spec_path}.tpu"
    if not tpu.accelerator_type:
        errs.append(required(f"{path}.acceleratorType", "must declare the GPU type, h100-<gpus>"))
        return errs
    try:
        shape = topology.resolve(tpu.accelerator_type, tpu.topology)
    except topology.TopologyError as e:
        errs.append(invalid(f"{path}.acceleratorType", tpu.accelerator_type, str(e)))
        return errs
    if tpu.num_slices < 1:
        errs.append(invalid(f"{path}.numSlices", tpu.num_slices, "must be >= 1"))
        return errs
    if tpu.num_slices > 1:
        errs.append(
            invalid(
                f"{path}.numSlices",
                tpu.num_slices,
                f"must be 1 on GPUs: a job larger than one node is one "
                f"h100-<gpus> type, a multiple of {topology.GPUS_PER_NODE}",
            )
        )
        return errs
    if tpu.hot_spares < 0:
        errs.append(
            invalid(f"{path}.hotSpares", tpu.hot_spares, "must be >= 0")
        )
    worker = spec.replica_specs.get(REPLICA_TYPE_WORKER)
    if worker is not None and worker.replicas is not None:
        want = shape.chips
        if worker.replicas != want:
            errs.append(
                invalid(
                    f"{spec_path}.tpuReplicaSpecs[{REPLICA_TYPE_WORKER}].replicas",
                    worker.replicas,
                    f"{shape.accelerator_type} (topology {shape.topology}) "
                    f"needs exactly {want} worker(s), one per GPU",
                )
            )
    return errs


def _validate_run_policy(policy: RunPolicy, path: str) -> list[FieldError]:
    # validation.go:88-106 analog.
    errs: list[FieldError] = []
    if policy.clean_pod_policy is None:
        errs.append(required(f"{path}.cleanPodPolicy", "must have clean Pod policy"))
    elif policy.clean_pod_policy not in VALID_CLEAN_POD_POLICIES:
        errs.append(
            not_supported(
                f"{path}.cleanPodPolicy", policy.clean_pod_policy, VALID_CLEAN_POD_POLICIES
            )
        )
    for name, value in (
        ("ttlSecondsAfterFinished", policy.ttl_seconds_after_finished),
        ("activeDeadlineSeconds", policy.active_deadline_seconds),
        ("backoffLimit", policy.backoff_limit),
    ):
        if value is not None and value < 0:
            errs.append(invalid(f"{path}.{name}", value, "must be greater than or equal to 0"))
    sp = policy.scheduling_policy
    if sp is not None and sp.queue:
        for detail in is_dns1123_label(sp.queue):
            errs.append(
                invalid(f"{path}.schedulingPolicy.queue", sp.queue, detail)
            )
    if policy.pod_failure_policy is not None:
        errs += _validate_pod_failure_policy(
            policy.pod_failure_policy, f"{path}.podFailurePolicy"
        )
    return errs


def _validate_pod_failure_policy(policy, path: str) -> list[FieldError]:
    # batch/v1 validation analog: every rule names a supported action and
    # exactly one requirement; In-operator exit codes must be non-zero
    # (exit 0 is success, not a failure class).
    errs: list[FieldError] = []
    if not policy.rules:
        errs.append(required(f"{path}.rules", "must declare at least one rule"))
    for i, rule in enumerate(policy.rules):
        rpath = f"{path}.rules[{i}]"
        if rule.action not in VALID_POD_FAILURE_POLICY_ACTIONS:
            errs.append(
                not_supported(
                    f"{rpath}.action", rule.action, VALID_POD_FAILURE_POLICY_ACTIONS
                )
            )
        has_codes = rule.on_exit_codes is not None
        has_conds = bool(rule.on_pod_conditions)
        if has_codes == has_conds:
            errs.append(
                invalid(
                    rpath,
                    rule.to_dict(),
                    "must specify exactly one of onExitCodes, onPodConditions",
                )
            )
        if has_codes:
            oec = rule.on_exit_codes
            if oec.operator not in VALID_POD_FAILURE_POLICY_OPERATORS:
                errs.append(
                    not_supported(
                        f"{rpath}.onExitCodes.operator",
                        oec.operator,
                        VALID_POD_FAILURE_POLICY_OPERATORS,
                    )
                )
            if not oec.values:
                errs.append(
                    required(f"{rpath}.onExitCodes.values", "must list exit codes")
                )
            elif oec.operator == POD_FAILURE_POLICY_OP_IN and 0 in oec.values:
                errs.append(
                    invalid(
                        f"{rpath}.onExitCodes.values",
                        oec.values,
                        "must not contain 0 for the In operator",
                    )
                )
        for j, pat in enumerate(rule.on_pod_conditions):
            if not pat.type and not pat.reason:
                errs.append(
                    required(
                        f"{rpath}.onPodConditions[{j}]",
                        "must set type and/or reason",
                    )
                )
            if pat.type and pat.status not in ("True", "False", "Unknown"):
                errs.append(
                    not_supported(
                        f"{rpath}.onPodConditions[{j}].status",
                        pat.status,
                        ("True", "False", "Unknown"),
                    )
                )
    return errs


def _validate_replica_specs(spec: TPUJobSpec, path: str) -> list[FieldError]:
    # validation.go:108-136 analog with Launcher/Worker requirements swapped.
    errs: list[FieldError] = []
    if not spec.replica_specs:
        errs.append(required(path, "must have replica specs"))
        return errs
    for rtype in spec.replica_specs:
        if rtype not in (REPLICA_TYPE_LAUNCHER, REPLICA_TYPE_WORKER):
            errs.append(
                not_supported(
                    f"{path}[{rtype}]",
                    rtype,
                    (REPLICA_TYPE_LAUNCHER, REPLICA_TYPE_WORKER),
                )
            )
    launcher = spec.replica_specs.get(REPLICA_TYPE_LAUNCHER)
    if launcher is not None:
        lpath = f"{path}[{REPLICA_TYPE_LAUNCHER}]"
        errs += _validate_replica_spec(launcher, lpath)
        if launcher.replicas is not None and launcher.replicas != 1:
            errs.append(invalid(f"{lpath}.replicas", launcher.replicas, "must be 1"))

    worker = spec.replica_specs.get(REPLICA_TYPE_WORKER)
    wpath = f"{path}[{REPLICA_TYPE_WORKER}]"
    if worker is None:
        errs.append(required(wpath, f"must have {REPLICA_TYPE_WORKER} replica spec"))
        return errs
    errs += _validate_replica_spec(worker, wpath)
    if worker.replicas is not None and worker.replicas <= 0:
        errs.append(
            invalid(f"{wpath}.replicas", worker.replicas, "must be greater than or equal to 1")
        )
    return errs


def _validate_replica_spec(spec: ReplicaSpec, path: str) -> list[FieldError]:
    # validation.go:138-151 analog + the TPU-resource rejection.
    errs: list[FieldError] = []
    if spec.replicas is None:
        errs.append(required(f"{path}.replicas", "must define number of replicas"))
    if spec.restart_policy not in VALID_RESTART_POLICIES:
        errs.append(
            not_supported(f"{path}.restartPolicy", spec.restart_policy, VALID_RESTART_POLICIES)
        )
    pod_spec = spec.template.get("spec") or {}
    if not (pod_spec.get("containers") or []):
        errs.append(
            required(
                f"{path}.template.spec.containers", "must define at least one container"
            )
        )
    for kind in ("containers", "initContainers", "ephemeralContainers"):
        for i, container in enumerate(pod_spec.get(kind) or []):
            for bound in ("limits", "requests"):
                resources = (container.get("resources") or {}).get(bound) or {}
                if constants.TPU_RESOURCE_NAME in resources:
                    errs.append(
                        invalid(
                            f"{path}.template.spec.{kind}[{i}].resources.{bound}",
                            constants.TPU_RESOURCE_NAME,
                            "GPU TPUJob pods must not request TPU resources",
                        )
                    )
    return errs
