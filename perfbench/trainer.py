"""The system under test, driven as the trainer's own loop drives it
(``cmd/train.py:main``): the cell's flags through ``build_parser``, the
world through ``launcher/bootstrap.py:initialize``, the mesh, the
workload through ``build_workload``, batches from ``Workload.batch_fn``
through the ``data/loader.py:Prefetcher`` (host tensors copied to the
device on the step's stream), and ``Workload.step_fn(*batch)`` once an
optimizer step. Nothing here copies the step."""

from __future__ import annotations

import time

# The prefetcher runs over steps [0, END); the harness stops long before.
END = 1 << 40


def build(cell, data: str, trainer_seed: int, device):
    """(args, workload) of the cell, its model holding the program's own
    initial weights (the harness overwrites them)."""
    from mpi_operator_tpu_torch.cmd import train
    from mpi_operator_tpu_torch.launcher import bootstrap
    from mpi_operator_tpu_torch.parallel.mesh import create_mesh

    args = train.build_parser().parse_args(
        cell.trainer_flags(data, trainer_seed, device.type))
    train.check_moe_mesh(args)
    train.check_sp_mesh(args)
    bootstrap.initialize(device_type=device.type)
    mesh = create_mesh(device=device, **train.parse_mesh_spec(args.mesh))
    return args, train.build_workload(args, mesh, mesh.size)


class Feed:
    """The workload's batches in step order, each on the device, with the
    host seconds each one was waited for."""

    def __init__(self, work, args, device):
        from mpi_operator_tpu_torch.data import Prefetcher

        if work.batch_fn is None:
            raise ValueError("the cell trains on --data, so the workload "
                             "needs its batch_fn")
        self.device = device
        self.prefetcher = Prefetcher(work.batch_fn, 0, END,
                                     depth=max(args.prefetch_depth, 1))
        self._it = iter(self.prefetcher)
        self.waits: list = []

    def next(self) -> tuple:
        t0 = time.perf_counter()
        _, host = next(self._it)
        self.waits.append(time.perf_counter() - t0)
        return tuple(t.to(self.device, non_blocking=True) for t in host)

    def close(self) -> None:
        self.prefetcher.close()
