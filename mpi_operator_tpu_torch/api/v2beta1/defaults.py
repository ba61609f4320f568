"""Defaulting for TPUJob (the port's ``mpi_operator_tpu/api/v2beta1/defaults.py``).

The one GPU change: worker replicas default to the job's GPU count (one
worker pod per GPU, ``api/topology.py``), where the JAX package defaults
them to TPU hosts x numSlices. Without it an ``h100-16`` job would
default to 2 workers (its nodes) and then fail its own admission.

Reference analog: SetDefaults_MPIJob and friends,
/root/reference/v2/pkg/apis/kubeflow/v2beta1/default.go:26-77.

Differences, by design:
- Worker replicas default from the GPU count (one pod per GPU) rather
  than to 0 — a TPUJob's worker count is a property of its accelerator.
- There is no SSH mount path or MPI implementation to default; instead the
  coordinator port defaults to 8476.
- A Launcher spec is defaulted only if present (it is optional).
"""

from __future__ import annotations

from .. import topology
from . import constants
from .types import (
    REPLICA_TYPE_LAUNCHER,
    REPLICA_TYPE_WORKER,
    ReplicaSpec,
    TPUJob,
)


def _set_defaults_launcher(spec: ReplicaSpec | None) -> None:
    # default.go:27-38 analog.
    if spec is None:
        return
    if not spec.restart_policy:
        spec.restart_policy = constants.DEFAULT_LAUNCHER_RESTART_POLICY
    if spec.replicas is None:
        spec.replicas = 1


def _set_defaults_worker(
    spec: ReplicaSpec | None, accelerator_type: str, topo: str, num_slices: int
) -> None:
    # default.go:41-50 analog, except replicas default to the GPU count.
    if spec is None:
        return
    if not spec.restart_policy:
        spec.restart_policy = constants.DEFAULT_RESTART_POLICY
    if spec.replicas is None and accelerator_type and num_slices >= 1:
        try:
            spec.replicas = topology.resolve(accelerator_type, topo).chips
        except topology.TopologyError:
            pass  # left for validation to report
    if spec.replicas is None:
        spec.replicas = 0


def set_defaults_tpujob(job: TPUJob) -> None:
    # default.go:53-59 analog.
    if job.spec.run_policy.clean_pod_policy is None:
        job.spec.run_policy.clean_pod_policy = constants.DEFAULT_CLEAN_POD_POLICY
    # Remaining run-policy fields pass through to the batch Job API, which
    # does its own defaulting (default.go:57-58 analog).

    if not job.spec.jax_distribution.coordinator_port:
        job.spec.jax_distribution.coordinator_port = constants.DEFAULT_COORDINATOR_PORT

    # Fill in the standard topology so everything downstream (env wiring,
    # mesh construction) sees an explicit shape.
    tpu = job.spec.tpu
    if tpu.accelerator_type and not tpu.topology:
        try:
            tpu.topology = topology.default_topology(
                *topology.parse_accelerator_type(tpu.accelerator_type)
            )
        except topology.TopologyError:
            pass  # left for validation to report

    _set_defaults_launcher(job.spec.replica_specs.get(REPLICA_TYPE_LAUNCHER))
    _set_defaults_worker(
        job.spec.replica_specs.get(REPLICA_TYPE_WORKER),
        tpu.accelerator_type,
        tpu.topology,
        tpu.num_slices,
    )
