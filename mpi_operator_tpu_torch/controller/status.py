"""TPUJob status/conditions engine.

Reference analog: /root/reference/v2/pkg/controller/mpi_job_controller_status.go
(kubeflow-common condition bookkeeping): Created/Running/Restarting/
Suspended/Succeeded/Failed conditions with transition-time preservation and
the mutual-exclusion rules (Running <-> Restarting replace each other;
Failed/Succeeded flip Running to False).
"""

from __future__ import annotations

import time
from typing import Optional

from ..api.v2beta1.types import (
    JOB_FAILED,
    JOB_RESTARTING,
    JOB_RUNNING,
    JOB_SUCCEEDED,
    JOB_SUSPENDED,
    JobCondition,
    JobStatus,
    ReplicaStatus,
    TPUJob,
)

# Event/condition reasons (mpi_job_controller_status.go:25-36 analog).
TPUJOB_CREATED_REASON = "TPUJobCreated"
TPUJOB_SUCCEEDED_REASON = "TPUJobSucceeded"
TPUJOB_RUNNING_REASON = "TPUJobRunning"
TPUJOB_FAILED_REASON = "TPUJobFailed"
TPUJOB_EVICTED_REASON = "TPUJobEvicted"
TPUJOB_RESTARTING_REASON = "TPUJobRestarting"
TPUJOB_SUSPENDED_REASON = "TPUJobSuspended"
TPUJOB_RESUMED_REASON = "TPUJobResumed"
# Gang-scheduler surfacing (kube-scheduler vocabulary, not kubeflow's).
TPUJOB_SCHEDULED_REASON = "TPUJobScheduled"
TPUJOB_UNSCHEDULABLE_REASON = "Unschedulable"
# Step-skew observatory (utils/stepstats.py) verdicts.
TPUJOB_STRAGGLING_REASON = "TPUJobStraggling"
TPUJOB_STRAGGLER_RECOVERED_REASON = "TPUJobStragglerRecovered"
# Device-memory observatory (utils/devstats.py) verdicts.
TPUJOB_MEMORY_PRESSURE_REASON = "TPUJobMemoryPressure"
TPUJOB_MEMORY_RECOVERED_REASON = "TPUJobMemoryRecovered"

CONDITION_TRUE = "True"
CONDITION_FALSE = "False"


def initialize_replica_statuses(job: TPUJob, replica_type: str) -> None:
    """:38-46 analog: reset one replica type's per-sync counters. The
    cumulative ``restarts`` counter survives (it bounds elastic
    replacement via runPolicy.backoffLimit)."""
    prior = job.status.replica_statuses.get(replica_type)
    job.status.replica_statuses[replica_type] = ReplicaStatus(
        restarts=prior.restarts if prior else 0
    )


def new_condition(
    type_: str, reason: str, message: str, status: str = CONDITION_TRUE, now: Optional[float] = None
) -> JobCondition:
    now = time.time() if now is None else now
    return JobCondition(
        type=type_,
        status=status,
        reason=reason,
        message=message,
        last_update_time=now,
        last_transition_time=now,
    )


def get_condition(status: JobStatus, type_: str) -> Optional[JobCondition]:
    for condition in status.conditions:
        if condition.type == type_:
            return condition
    return None


def has_condition(status: JobStatus, type_: str) -> bool:
    return any(
        c.type == type_ and c.status == CONDITION_TRUE for c in status.conditions
    )


def is_succeeded(status: JobStatus) -> bool:
    return has_condition(status, JOB_SUCCEEDED)


def is_failed(status: JobStatus) -> bool:
    return has_condition(status, JOB_FAILED)


def is_finished(status: JobStatus) -> bool:
    return is_succeeded(status) or is_failed(status)


def is_suspended(status: JobStatus) -> bool:
    return has_condition(status, JOB_SUSPENDED)


def update_job_conditions(
    job: TPUJob, type_: str, reason: str, message: str,
    status: str = CONDITION_TRUE, now: Optional[float] = None,
) -> bool:
    """Set one condition; True iff the stored conditions changed (the
    signal observability layers key transition timestamps off)."""
    return set_condition(
        job.status, new_condition(type_, reason, message, status, now)
    )


def set_condition(status: JobStatus, condition: JobCondition) -> bool:
    """:100-117 analog: idempotent set with transition-time preservation.
    Returns True when the condition list actually changed."""
    current = get_condition(status, condition.type)
    if (
        current is not None
        and current.status == condition.status
        and current.reason == condition.reason
    ):
        return False  # nothing changed
    if current is not None and current.status == condition.status:
        condition.last_transition_time = current.last_transition_time
    status.conditions = _filter_out_condition(status.conditions, condition.type) + [
        condition
    ]
    return True


def _filter_out_condition(
    conditions: list[JobCondition], cond_type: str
) -> list[JobCondition]:
    """:119-142 analog: drop same-type (and Running<->Restarting pairs);
    flip Running/Failed to False when a terminal condition lands."""
    out = []
    for c in conditions:
        if cond_type == JOB_RESTARTING and c.type == JOB_RUNNING:
            continue
        if cond_type == JOB_RUNNING and c.type == JOB_RESTARTING:
            continue
        if c.type == cond_type:
            continue
        if cond_type in (JOB_FAILED, JOB_SUCCEEDED) and c.type in (
            JOB_RUNNING,
            JOB_FAILED,
        ):
            c = JobCondition(**{**c.__dict__})
            c.status = CONDITION_FALSE
        out.append(c)
    return out
