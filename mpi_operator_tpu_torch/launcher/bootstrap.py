"""Rendezvous bootstrap for training workers (port of
``mpi_operator_tpu/launcher/bootstrap.py``).

The controller injects the rendezvous env; ``initialize()`` reads it and
forms the job's ``torch.distributed`` world: the gang barrier on the
coordinator port + 1 (``launcher/barrier.py``), then
``init_process_group`` over a TCP store at the coordinator address. A
one-process job needs no world and skips all of it, as in JAX, so the
same worker image runs unchanged on one host.

The port runs one process per device, PyTorch's idiom (the JAX package
can drive many devices from one process). Process ``i`` takes
``cuda:(i mod visible devices)``. The default process group is NCCL on
the card and gloo on the CPU; ``TPUJOB_DIST_BACKEND=gloo`` puts ranks
that share one card on gloo, which NCCL refuses. Beside the default
group, two gloo groups on CPU tensors: ``control_group()`` carries the
control collectives (the preempt agreement, the async checkpoint's save
agreement) and
``checkpoint_group()`` DCP's coordination, so the async writer thread
never interleaves collectives with the step's.
"""

from __future__ import annotations

import datetime
import os
from dataclasses import dataclass
from typing import Mapping, Optional

from ..api.v2beta1 import constants
from ..utils import trace
from ..utils.logging import get_logger

log = get_logger("launcher")


@dataclass
class RendezvousConfig:
    coordinator_address: str = ""
    num_processes: int = 1
    process_id: int = 0
    worker_id: int = 0
    worker_hostnames: tuple[str, ...] = ()
    accelerator_type: str = ""
    topology: str = ""
    chips_per_host: int = 0
    num_slices: int = 1
    slice_id: int = 0
    megascale_coordinator_address: str = ""
    megascale_num_slices: int = 0
    megascale_slice_id: int = -1
    megascale_port: int = 0
    job_name: str = ""
    job_namespace: str = ""

    @classmethod
    def from_env(cls, environ: Optional[Mapping[str, str]] = None
                 ) -> "RendezvousConfig":
        env = os.environ if environ is None else environ

        def _int(name: str, default: int) -> int:
            try:
                return int(env.get(name, default))
            except (TypeError, ValueError):
                return default

        names = env.get(constants.ENV_TPU_WORKER_HOSTNAMES, "")
        hostnames = tuple(h for h in names.split(",") if h)
        return cls(
            coordinator_address=env.get(constants.ENV_COORDINATOR_ADDRESS, ""),
            num_processes=_int(constants.ENV_NUM_PROCESSES, 1),
            process_id=_int(constants.ENV_PROCESS_ID, 0),
            worker_id=_int(constants.ENV_TPU_WORKER_ID, 0),
            worker_hostnames=hostnames,
            accelerator_type=env.get(constants.ENV_TPU_ACCELERATOR_TYPE, ""),
            topology=env.get(constants.ENV_TPU_TOPOLOGY, ""),
            chips_per_host=_int(constants.ENV_TPU_CHIPS_PER_HOST, 0),
            num_slices=_int(constants.ENV_NUM_SLICES, 1),
            slice_id=_int(constants.ENV_SLICE_ID, 0),
            megascale_coordinator_address=env.get(
                constants.ENV_MEGASCALE_COORDINATOR_ADDRESS, ""),
            megascale_num_slices=_int(constants.ENV_MEGASCALE_NUM_SLICES, 0),
            megascale_slice_id=_int(constants.ENV_MEGASCALE_SLICE_ID, -1),
            megascale_port=_int(constants.ENV_MEGASCALE_PORT, 0),
            job_name=env.get(constants.ENV_JOB_NAME, ""),
            job_namespace=env.get(constants.ENV_JOB_NAMESPACE, ""),
        )

    @property
    def is_distributed(self) -> bool:
        return self.num_processes > 1

    @property
    def is_coordinator(self) -> bool:
        return self.process_id == 0

    @property
    def is_multislice(self) -> bool:
        return self.num_slices > 1

    @property
    def hosts_per_slice(self) -> int:
        return max(len(self.worker_hostnames), 1)

    def check_multislice(self) -> None:
        """Fail fast on inconsistent multislice wiring, which otherwise
        surfaces as a hang at the first collective.

        The slice-local identity (TPU_WORKER_ID/HOSTNAMES) must agree with
        the global identity (process id, slice id): process_id = slice_id
        x hosts_per_slice + worker_id, and the whole world must divide
        evenly into slices. Every MEGASCALE_* value that is set must agree
        with the TPUJOB_* identity.
        """
        if not self.is_multislice:
            return
        if not self.megascale_coordinator_address:
            raise RuntimeError(
                f"num_slices={self.num_slices} but "
                f"{constants.ENV_MEGASCALE_COORDINATOR_ADDRESS} is unset"
            )
        if (self.megascale_num_slices
                and self.megascale_num_slices != self.num_slices):
            raise RuntimeError(
                f"{constants.ENV_MEGASCALE_NUM_SLICES}="
                f"{self.megascale_num_slices} disagrees with "
                f"{constants.ENV_NUM_SLICES}={self.num_slices}"
            )
        if 0 <= self.megascale_slice_id != self.slice_id:
            raise RuntimeError(
                f"{constants.ENV_MEGASCALE_SLICE_ID}="
                f"{self.megascale_slice_id} disagrees with "
                f"{constants.ENV_SLICE_ID}={self.slice_id}"
            )
        if self.megascale_port:
            addr_port = self.megascale_coordinator_address.rpartition(":")[2]
            if addr_port.isdigit() and int(addr_port) != self.megascale_port:
                raise RuntimeError(
                    f"{constants.ENV_MEGASCALE_PORT}={self.megascale_port} "
                    "disagrees with the port in "
                    f"{constants.ENV_MEGASCALE_COORDINATOR_ADDRESS}="
                    f"{self.megascale_coordinator_address}"
                )
        if self.num_processes % self.num_slices:
            raise RuntimeError(
                f"world of {self.num_processes} processes does not divide "
                f"into {self.num_slices} slices"
            )
        per_slice = self.num_processes // self.num_slices
        if self.worker_hostnames and per_slice != self.hosts_per_slice:
            raise RuntimeError(
                f"slice-local hostname list has {self.hosts_per_slice} "
                f"hosts but the world implies {per_slice} per slice"
            )
        expect = self.slice_id * per_slice + self.worker_id
        if self.process_id != expect:
            raise RuntimeError(
                f"process_id {self.process_id} inconsistent with slice "
                f"{self.slice_id} worker {self.worker_id} (expected {expect})"
            )

    def coordinator(self) -> tuple[str, int]:
        """(host, port) of the process group's store; the gang barrier
        listens on port + 1."""
        host, _, port = self.coordinator_address.partition(":")
        return host, int(port or constants.DEFAULT_COORDINATOR_PORT)


_groups: dict = {}


def process_device(process_id: int, device_type: str):
    """This process's device: ``cuda:(process_id mod visible devices)``,
    or the CPU."""
    import torch

    if device_type != "cuda":
        return torch.device("cpu")
    visible = torch.cuda.device_count()
    if not visible:
        raise RuntimeError(f"process {process_id} asked for a CUDA device "
                           f"but none is visible")
    return torch.device("cuda", process_id % visible)


def default_backend(device_type: str) -> str:
    """``TPUJOB_DIST_BACKEND`` when set, else NCCL on the card and gloo on
    the CPU."""
    backend = os.environ.get(constants.ENV_DIST_BACKEND, "")
    if backend not in ("", "nccl", "gloo"):
        raise ValueError(f"{constants.ENV_DIST_BACKEND}={backend!r}; want "
                         f"nccl or gloo")
    return backend or ("nccl" if device_type == "cuda" else "gloo")


def form_world(cfg: RendezvousConfig, *, device_type: str = "cuda",
               backend: Optional[str] = None,
               initialization_timeout_seconds: int = 300,
               readiness_barrier: bool = True) -> None:
    """Form the ``torch.distributed`` world ``cfg`` describes, whatever its
    size: the gang barrier (when ``readiness_barrier`` and there is more
    than one process), then the default process group at the coordinator
    address and the two gloo side groups. :func:`initialize` calls it for
    a multi-process job; a one-process world is formed only on request
    (the healthcheck's probe of the collective path)."""
    import torch
    import torch.distributed as dist

    if dist.is_initialized():
        return
    cfg.check_multislice()
    if cfg.is_multislice:
        log.info("multislice world: slice %d/%d, coordinator %s",
                 cfg.slice_id, cfg.num_slices,
                 cfg.megascale_coordinator_address)
    host, port = cfg.coordinator()
    if not cfg.coordinator_address and cfg.is_distributed:
        raise RuntimeError(
            f"a {cfg.num_processes}-process world needs "
            f"{constants.ENV_COORDINATOR_ADDRESS}")
    if readiness_barrier and cfg.is_distributed:
        from . import barrier

        barrier.gang_barrier(
            coordinator_host=host, port=port + 1, rank=cfg.process_id,
            world_size=cfg.num_processes,
            timeout_s=initialization_timeout_seconds,
        )
    backend = backend or default_backend(device_type)
    device = process_device(cfg.process_id, device_type)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    timeout = datetime.timedelta(seconds=initialization_timeout_seconds)
    log.info("init_process_group backend=%s coordinator=%s:%d process=%d/%d "
             "device=%s", backend, host or "127.0.0.1", port, cfg.process_id,
             cfg.num_processes, device)
    kw = {"device_id": device} if backend == "nccl" else {}
    dist.init_process_group(
        backend, init_method=f"tcp://{host or '127.0.0.1'}:{port}",
        world_size=cfg.num_processes, rank=cfg.process_id, timeout=timeout,
        **kw,
    )
    for name in ("control", "checkpoint"):
        _groups[name] = dist.new_group(backend="gloo", timeout=timeout)


def control_group():
    """The gloo group of the control collectives (CPU tensors)."""
    return _groups.get("control")


def checkpoint_group():
    """The gloo group DCP coordinates checkpoints over (CPU tensors)."""
    return _groups.get("checkpoint")


def initialize(config: Optional[RendezvousConfig] = None, *,
               device_type: str = "cuda",
               initialization_timeout_seconds: int = 300,
               readiness_barrier: bool = True) -> RendezvousConfig:
    """Join the job's world (idempotent). Single-process jobs
    (num_processes == 1) skip it entirely."""
    # Adopt the controller-stamped trace context before anything logs.
    trace.adopt_from_environ()
    cfg = config or RendezvousConfig.from_env()
    if not cfg.is_distributed:
        log.info("single-process job; skipping distributed initialization")
        return cfg
    form_world(cfg, device_type=device_type,
               initialization_timeout_seconds=initialization_timeout_seconds,
               readiness_barrier=readiness_barrier)
    return cfg


def shutdown() -> None:
    """Leave the world: destroy the side groups and the default group."""
    import torch.distributed as dist

    _groups.clear()
    if dist.is_initialized():
        dist.destroy_process_group()
