"""Child-object builders for a TPUJob (the port's
``mpi_operator_tpu/controller/builders.py``, the GPU variant).

What differs from the JAX package's builders, and nothing else:

- one worker pod per GPU: each worker requests ``nvidia.com/gpu: 1``
  (limits and requests) where the JAX worker requests its host's
  ``google.com/tpu`` chips;
- the worker env is exactly what the port's launcher
  (``launcher/bootstrap.RendezvousConfig.from_env``) reads:
  ``TPUJOB_COORDINATOR_ADDRESS``, ``TPUJOB_NUM_PROCESSES`` (the pod
  count), ``TPUJOB_PROCESS_ID`` (the pod index), ``TPUJOB_NAME``,
  ``TPUJOB_NAMESPACE``, ``TPU_ACCELERATOR_TYPE``, ``TPU_TOPOLOGY`` and,
  when a span is open, ``TPU_TRACE_CONTEXT``. It drops what means
  nothing on a GPU node: ``TPU_WORKER_ID``, ``TPU_WORKER_HOSTNAMES``,
  ``TPU_CHIPS_PER_HOST``, ``TPUJOB_NUM_SLICES``/``TPUJOB_SLICE_ID`` and
  every ``MEGASCALE_*`` (validation refuses ``numSlices > 1``);
- the default worker command is the port's
  ``mpi_operator_tpu_torch.launcher.healthcheck`` and a hot spare runs the
  port's ``mpi_operator_tpu_torch.launcher.park``; the spare's env drops
  ``TPU_CHIPS_PER_HOST`` as the worker's does.

Reference analog: the object builders in
/root/reference/v2/pkg/controller/mpi_job_controller.go:1103-1546, with the
SSH/MPI machinery replaced by rendezvous env:

- headless workers Service  — identical role (stable DNS for workers);
- ConfigMap                 — carries the worker FQDN list (hostfile analog,
  :1106-1128) and an elastic ``discover_hosts.sh`` (:1131-1145 analog);
- worker Pods               — hostname+subdomain identity (:1262-1263
  analog), plus the coordinator env *instead of* mounted SSH keys, and
  ``nvidia.com/gpu`` resource injection *instead of* ``slotsPerWorker``
  env (:1363-1377);
- launcher batch Job        — optional, RunPolicy passthrough (:1306-1325
  analog) minus all mpirun/OMPI env;
- PodGroup                  — gang scheduling with minMember = every
  worker (one torch.distributed world forms only when all its ranks
  join, :1218-1240 analog).
"""

from __future__ import annotations

import copy
import functools

from ..api import topology
from ..api.v2beta1 import constants
from ..api.v2beta1.types import (
    API_VERSION,
    KIND,
    REPLICA_TYPE_LAUNCHER,
    REPLICA_TYPE_WORKER,
    TPUJob,
)
from ..runtime.objects import KubeObject, ObjectMeta, OwnerReference
from ..utils import trace


def _traced(span_name: str):
    """Open a span on the default tracer around an object builder. Builders
    run inside the controller's ``reconcile`` span on the same thread, so
    these become its children in ``/debug/trace``."""

    def deco(fn):
        @functools.wraps(fn)
        def wrapper(job: TPUJob, *args, **kwargs):
            with trace.span(span_name, job=f"{job.namespace}/{job.name}"):
                return fn(job, *args, **kwargs)

        return wrapper

    return deco


def controller_ref(job: TPUJob) -> dict:
    return OwnerReference(
        api_version=API_VERSION,
        kind=KIND,
        name=job.metadata.name,
        uid=job.metadata.uid,
        controller=True,
        block_owner_deletion=True,
    ).to_dict()


def default_labels(job_name: str, role: str) -> dict[str, str]:
    # mpi_job_controller.go:1502-1508 analog.
    return {
        constants.OPERATOR_NAME_LABEL: constants.OPERATOR_NAME,
        constants.JOB_NAME_LABEL: job_name,
        constants.JOB_ROLE_LABEL: role,
    }


def worker_selector(job_name: str) -> dict[str, str]:
    return default_labels(job_name, constants.ROLE_WORKER)


def spare_selector(job_name: str) -> dict[str, str]:
    return default_labels(job_name, constants.ROLE_SPARE)


def worker_name(job: TPUJob, index: int) -> str:
    return f"{job.name}{constants.WORKER_SUFFIX}-{index}"


def spare_name(job: TPUJob, index: int) -> str:
    return f"{job.name}{constants.SPARE_SUFFIX}-{index}"


def spare_group_name(job: TPUJob) -> str:
    # The spares form their OWN gang: the worker gang must never wait on
    # standby capacity, and the scheduler can evict the spare gang as the
    # cheapest preemption victim without decapitating the workers.
    return job.name + constants.SPARE_SUFFIX


def hot_spares(job: TPUJob) -> int:
    return max(getattr(job.spec.tpu, "hot_spares", 0) or 0, 0)


def workers_service_name(job: TPUJob) -> str:
    return job.name + constants.WORKER_SUFFIX


def launcher_name(job: TPUJob) -> str:
    return job.name + constants.LAUNCHER_SUFFIX


def config_name(job: TPUJob) -> str:
    return job.name + constants.CONFIG_SUFFIX


def worker_replicas(job: TPUJob) -> int:
    spec = job.spec.replica_specs.get(REPLICA_TYPE_WORKER)
    return spec.replicas if spec and spec.replicas is not None else 0


def worker_fqdn(job: TPUJob, index: int) -> str:
    # "<job>-worker-i.<job>-worker.<ns>.svc" (newConfigMap :1110 analog).
    return f"{worker_name(job, index)}.{workers_service_name(job)}.{job.namespace}.svc"


def coordinator_address(job: TPUJob) -> str:
    # Worker 0 always hosts the torch.distributed store.
    return f"{worker_fqdn(job, 0)}:{job.spec.jax_distribution.coordinator_port}"


def slice_shape(job: TPUJob) -> topology.SliceShape:
    return topology.resolve(job.spec.tpu.accelerator_type, job.spec.tpu.topology)


@_traced("builders.new_service")
def new_service(job: TPUJob, name: str, selector: dict[str, str]) -> KubeObject:
    """Headless Service (newService :1157-1174 analog)."""
    return KubeObject(
        "v1",
        "Service",
        ObjectMeta(
            name=name,
            namespace=job.namespace,
            labels={"app": job.name},
            owner_references=[OwnerReference.from_dict(controller_ref(job))],
        ),
        spec={"clusterIP": "None", "selector": dict(selector)},
    )


def new_workers_service(job: TPUJob) -> KubeObject:
    return new_service(job, workers_service_name(job), worker_selector(job.name))


@_traced("builders.new_config_map")
def new_config_map(job: TPUJob, replicas: int) -> KubeObject:
    """Worker-hostnames ConfigMap (newConfigMap :1106-1128 analog).

    The reference renders an MPI hostfile; we render the newline-separated
    FQDN list of the workers, so sidecars/debug
    tooling can mount the same source of truth the env wiring used.
    """
    hostnames = "".join(worker_fqdn(job, i) + "\n" for i in range(replicas))
    return KubeObject(
        "v1",
        "ConfigMap",
        ObjectMeta(
            name=config_name(job),
            namespace=job.namespace,
            labels={"app": job.name},
            owner_references=[OwnerReference.from_dict(controller_ref(job))],
        ),
        data={constants.HOSTNAMES_KEY: hostnames},
    )


def update_discover_hosts(
    config_map: KubeObject, job: TPUJob, running_worker_pods: list[dict]
) -> None:
    """Elastic host-discovery script (:1131-1145 analog): echoes the FQDN of
    every *currently Running* worker, sorted, for elastic workloads."""
    names = sorted(p["metadata"]["name"] for p in running_worker_pods)
    script = "#!/bin/sh\n" + "".join(
        f"echo {name}.{workers_service_name(job)}.{job.namespace}.svc\n"
        for name in names
    )
    config_map.data[constants.DISCOVER_HOSTS_KEY] = script


def _worker_env(job: TPUJob, index: int, shape: topology.SliceShape) -> list[dict]:
    """The rendezvous env block — the entire replacement for the reference's
    SSH keys + hostfile + OMPI/I_MPI env (:177-201, :1363-1377).

    One torch.distributed world of one process per GPU: the process id is
    the pod index and the world size the pod count. The key set is listed
    in the module docstring.
    """
    replicas = worker_replicas(job)
    env = [
        {"name": constants.ENV_TPU_ACCELERATOR_TYPE, "value": shape.accelerator_type},
        {"name": constants.ENV_TPU_TOPOLOGY, "value": shape.topology},
        {"name": constants.ENV_COORDINATOR_ADDRESS, "value": coordinator_address(job)},
        {"name": constants.ENV_NUM_PROCESSES, "value": str(replicas)},
        {"name": constants.ENV_PROCESS_ID, "value": str(index)},
        {"name": constants.ENV_JOB_NAME, "value": job.name},
        {"name": constants.ENV_JOB_NAMESPACE, "value": job.namespace},
    ]
    ctx = trace.current_context()
    if ctx is not None:
        # Trace propagation: the worker process adopts this on startup,
        # so its log lines carry the reconcile's trace id.
        env.append(
            {"name": constants.ENV_TRACE_CONTEXT, "value": ctx.encode()}
        )
    return env


@_traced("builders.new_worker")
def new_worker(job: TPUJob, index: int, gang_scheduler_name: str = "") -> KubeObject:
    """Worker Pod (newWorker :1249-1304 analog)."""
    shape = slice_shape(job)
    template = copy.deepcopy(job.spec.replica_specs[REPLICA_TYPE_WORKER].template)
    pod_spec = template.setdefault("spec", {})
    tmeta = template.setdefault("metadata", {})

    labels = dict(tmeta.get("labels") or {})
    labels.update(default_labels(job.name, constants.ROLE_WORKER))
    labels[constants.REPLICA_INDEX_LABEL] = str(index)
    annotations = dict(tmeta.get("annotations") or {})
    # Elastic stamp: which world size this pod's rendezvous env encodes.
    annotations[constants.WORLD_SIZE_ANNOTATION] = str(worker_replicas(job))

    name = worker_name(job, index)
    pod_spec["hostname"] = name
    pod_spec["subdomain"] = workers_service_name(job)  # matches the Service
    if pod_spec.get("hostNetwork"):
        pod_spec["dnsPolicy"] = "ClusterFirstWithHostNet"
    pod_spec["restartPolicy"] = job.spec.replica_specs[
        REPLICA_TYPE_WORKER
    ].restart_policy

    containers = pod_spec.get("containers") or [{}]
    container = containers[0]
    # Default worker command: the port's torch.distributed collective
    # health check — the analog of the reference's default
    # `/usr/sbin/sshd -De` (:1272-1274): something safe every worker can
    # run when the user gives no command. Unlike sshd it *completes*,
    # proving the world wires up.
    if not container.get("command") and not container.get("args"):
        container["command"] = [
            "python", "-m", "mpi_operator_tpu_torch.launcher.healthcheck"]
    container.setdefault("env", [])
    container["env"] = list(container["env"]) + _worker_env(job, index, shape)
    # nvidia.com/gpu resource injection, one GPU a pod (replaces slots env
    # :1363-1377).
    resources = container.setdefault("resources", {})
    for bound in ("limits", "requests"):
        section = resources.setdefault(bound, {})
        section.setdefault(constants.GPU_RESOURCE_NAME, 1)
    pod_spec["containers"] = containers

    if gang_scheduler_name:
        pod_spec["schedulerName"] = gang_scheduler_name
        annotations["scheduling.k8s.io/group-name"] = job.name

    meta = ObjectMeta(
        name=name,
        namespace=job.namespace,
        labels=labels,
        annotations=annotations,
        owner_references=[OwnerReference.from_dict(controller_ref(job))],
    )
    return KubeObject("v1", "Pod", meta, spec=pod_spec)


@_traced("builders.new_launcher_job")
def new_launcher_job(job: TPUJob, gang_scheduler_name: str = "") -> KubeObject:
    """Launcher batch Job (newLauncherJob :1306-1325 analog), optional in a
    TPUJob: orchestration-only duties (eval loops, logging), never rank
    bootstrap — workers self-assemble via torch.distributed."""
    launcher_spec = job.spec.replica_specs[REPLICA_TYPE_LAUNCHER]
    template = copy.deepcopy(launcher_spec.template)
    pod_spec = template.setdefault("spec", {})
    tmeta = template.setdefault("metadata", {})

    labels = dict(tmeta.get("labels") or {})
    labels.update(default_labels(job.name, constants.ROLE_LAUNCHER))
    # batch/v1 convention label so launcher pods are findable by job name.
    labels["job-name"] = launcher_name(job)
    annotations = dict(tmeta.get("annotations") or {})

    pod_spec["restartPolicy"] = launcher_spec.restart_policy
    containers = pod_spec.get("containers") or [{}]
    container = containers[0]
    container.setdefault("env", [])
    shape = slice_shape(job)
    container["env"] = list(container["env"]) + [
        {"name": constants.ENV_COORDINATOR_ADDRESS, "value": coordinator_address(job)},
        {"name": constants.ENV_NUM_PROCESSES, "value": str(worker_replicas(job))},
        {"name": constants.ENV_TPU_ACCELERATOR_TYPE, "value": shape.accelerator_type},
        {"name": constants.ENV_TPU_TOPOLOGY, "value": shape.topology},
        {"name": constants.ENV_JOB_NAME, "value": job.name},
        {"name": constants.ENV_JOB_NAMESPACE, "value": job.namespace},
    ]
    ctx = trace.current_context()
    if ctx is not None:
        # Same propagation contract as worker pods (_worker_env).
        container["env"] = container["env"] + [
            {"name": constants.ENV_TRACE_CONTEXT, "value": ctx.encode()}
        ]
    pod_spec["containers"] = containers

    if gang_scheduler_name:
        pod_spec["schedulerName"] = gang_scheduler_name
        annotations["scheduling.k8s.io/group-name"] = job.name

    job_spec: dict = {
        "template": {
            "metadata": {"labels": labels, "annotations": annotations},
            "spec": pod_spec,
        }
    }
    rp = job.spec.run_policy
    if rp.ttl_seconds_after_finished is not None:
        job_spec["ttlSecondsAfterFinished"] = rp.ttl_seconds_after_finished
    if rp.active_deadline_seconds is not None:
        job_spec["activeDeadlineSeconds"] = rp.active_deadline_seconds
    if rp.backoff_limit is not None:
        job_spec["backoffLimit"] = rp.backoff_limit

    return KubeObject(
        "batch/v1",
        "Job",
        ObjectMeta(
            name=launcher_name(job),
            namespace=job.namespace,
            labels={"app": job.name},
            owner_references=[OwnerReference.from_dict(controller_ref(job))],
        ),
        spec=job_spec,
    )


@_traced("builders.new_pod_group")
def new_pod_group(job: TPUJob, min_member: int) -> KubeObject:
    """PodGroup (newPodGroup :1218-1240 analog)."""
    priority_class = ""
    for rtype in (REPLICA_TYPE_LAUNCHER, REPLICA_TYPE_WORKER):
        spec = job.spec.replica_specs.get(rtype)
        if spec is not None:
            priority_class = (spec.template.get("spec") or {}).get(
                "priorityClassName", ""
            )
            if priority_class:
                break
    sp = job.spec.run_policy.scheduling_policy
    queue = job.metadata.annotations.get("scheduling.volcano.sh/queue-name", "")
    if sp is not None:
        if sp.min_available is not None:
            min_member = sp.min_available
        if sp.queue:
            queue = sp.queue
        if sp.priority_class:
            priority_class = sp.priority_class
    spec: dict = {"minMember": min_member}
    if queue:
        spec["queue"] = queue
    if priority_class:
        spec["priorityClassName"] = priority_class
    return KubeObject(
        "scheduling.x-k8s.io/v1alpha1",
        "PodGroup",
        ObjectMeta(
            name=job.name,
            namespace=job.namespace,
            owner_references=[OwnerReference.from_dict(controller_ref(job))],
        ),
        spec=spec,
    )


@_traced("builders.new_spare")
def new_spare(job: TPUJob, index: int, gang_scheduler_name: str = "") -> KubeObject:
    """Hot-spare standby Pod (spec.tpu.hotSpares).

    Same template, node shape, and chip footprint as a worker — it must be
    schedulable anywhere a worker is — but it runs the ``park`` launcher
    instead of the user command, so it bootstraps (image pulled, runtime
    warm) and then blocks *before* the collective barrier. Promotion turns
    its reserved node into a pre-bound replacement worker, skipping
    schedule->pending->bootstrap entirely.
    """
    shape = slice_shape(job)
    template = copy.deepcopy(job.spec.replica_specs[REPLICA_TYPE_WORKER].template)
    pod_spec = template.setdefault("spec", {})
    tmeta = template.setdefault("metadata", {})

    labels = dict(tmeta.get("labels") or {})
    labels.update(default_labels(job.name, constants.ROLE_SPARE))
    labels[constants.REPLICA_INDEX_LABEL] = str(index)
    annotations = dict(tmeta.get("annotations") or {})
    annotations[constants.STANDBY_ANNOTATION] = "true"
    annotations[constants.WORLD_SIZE_ANNOTATION] = str(worker_replicas(job))

    name = spare_name(job, index)
    pod_spec["hostname"] = name
    pod_spec["subdomain"] = workers_service_name(job)
    if pod_spec.get("hostNetwork"):
        pod_spec["dnsPolicy"] = "ClusterFirstWithHostNet"
    pod_spec["restartPolicy"] = "Never"

    containers = pod_spec.get("containers") or [{}]
    container = containers[0]
    # A spare must never start training: the user command is replaced with
    # the parking loop unconditionally. The rendezvous env is *not* stamped
    # here — the promoted replacement worker is a fresh pod whose env is
    # restamped by new_worker at promotion time.
    container["command"] = ["python", "-m", "mpi_operator_tpu_torch.launcher.park"]
    container.pop("args", None)
    container.setdefault("env", [])
    container["env"] = list(container["env"]) + [
        {"name": constants.ENV_TPU_ACCELERATOR_TYPE, "value": shape.accelerator_type},
        {"name": constants.ENV_TPU_TOPOLOGY, "value": shape.topology},
        {"name": constants.ENV_JOB_NAME, "value": job.name},
        {"name": constants.ENV_JOB_NAMESPACE, "value": job.namespace},
    ]
    # A worker's footprint, one GPU: the spare *holds* a worker-shaped slot
    # so the promoted pod can bind to it without a scheduling pass.
    resources = container.setdefault("resources", {})
    for bound in ("limits", "requests"):
        section = resources.setdefault(bound, {})
        section.setdefault(constants.GPU_RESOURCE_NAME, 1)
    pod_spec["containers"] = containers

    if gang_scheduler_name:
        pod_spec["schedulerName"] = gang_scheduler_name
        annotations["scheduling.k8s.io/group-name"] = spare_group_name(job)

    meta = ObjectMeta(
        name=name,
        namespace=job.namespace,
        labels=labels,
        annotations=annotations,
        owner_references=[OwnerReference.from_dict(controller_ref(job))],
    )
    return KubeObject("v1", "Pod", meta, spec=pod_spec)


@_traced("builders.new_spare_group")
def new_spare_group(job: TPUJob) -> KubeObject:
    """PodGroup for the spare gang.

    Inherits the job's priorityClassName so a high-priority job pre-reserves
    standby capacity at its own priority; minMember is the spare count (the
    worker gang never waits on spares).
    """
    priority_class = ""
    for rtype in (REPLICA_TYPE_LAUNCHER, REPLICA_TYPE_WORKER):
        rspec = job.spec.replica_specs.get(rtype)
        if rspec is not None:
            priority_class = (rspec.template.get("spec") or {}).get(
                "priorityClassName", ""
            )
            if priority_class:
                break
    sp = job.spec.run_policy.scheduling_policy
    if sp is not None and sp.priority_class:
        priority_class = sp.priority_class
    spec: dict = {"minMember": hot_spares(job)}
    if priority_class:
        spec["priorityClassName"] = priority_class
    return KubeObject(
        "scheduling.x-k8s.io/v1alpha1",
        "PodGroup",
        ObjectMeta(
            name=spare_group_name(job),
            namespace=job.namespace,
            owner_references=[OwnerReference.from_dict(controller_ref(job))],
        ),
        spec=spec,
    )
