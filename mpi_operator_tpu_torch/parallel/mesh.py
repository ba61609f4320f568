"""Mesh construction (port of ``mpi_operator_tpu/parallel/mesh.py``).

Axis convention (outer -> inner), as in the JAX package:

    ('dp', 'pp', 'fsdp', 'ep', 'tp', 'sp')

Any subset may be used; sizes multiply to the world size (one process
per device). A size of ``-1`` means "whatever is left" (at most one
axis). A world of one keeps a one-device :class:`Mesh`; a larger world
gets a ``torch.distributed`` ``DeviceMesh`` with the same axis names in
the same order. ``pp`` holds the layer stages of a pipelined Llama
(``parallel/pipeline.py``): its process group (``Mesh.submesh("pp")``)
carries the activations from stage to stage, and the ranks of one stage
keep their dp/fsdp/ep/tp/sp groups. ``ep`` shards the MoE experts; the
batch splits over dp and fsdp only, so an ep rank holds its dp row's
batch. ``sp`` shards the sequence: its ranks hold the same rows, each
its own positions (``parallel/sharding.py:local_positions``), and its
process group (``Mesh.submesh("sp")``) carries the ring and the
all-to-alls.
"""

from __future__ import annotations

from dataclasses import dataclass
from math import prod
from typing import Any, Optional

import torch

DP = "dp"
PP = "pp"  # pipeline parallelism: layer stages live here
FSDP = "fsdp"
EP = "ep"  # expert parallelism: MoE expert dim lives here
TP = "tp"
SP = "sp"

STANDARD_AXES = (DP, PP, FSDP, EP, TP, SP)
BATCH_AXES = (DP, FSDP)  # the batch dim shards over these

@dataclass(frozen=True)
class MeshConfig:
    """Named axis sizes, resolved against a device count."""

    axes: tuple[tuple[str, int], ...]

    @classmethod
    def of(cls, **sizes: int) -> "MeshConfig":
        return cls(tuple(sizes.items()))

    def resolve(self, n_devices: int) -> "MeshConfig":
        sizes = dict(self.axes)
        wild = [name for name, size in sizes.items() if size == -1]
        if len(wild) > 1:
            raise ValueError(f"at most one -1 axis allowed, got {wild}")
        fixed = prod(size for size in sizes.values() if size != -1)
        if wild:
            if n_devices % fixed != 0:
                raise ValueError(
                    f"device count {n_devices} not divisible by fixed axes "
                    f"{fixed}")
            sizes[wild[0]] = n_devices // fixed
        elif fixed != n_devices:
            raise ValueError(
                f"mesh axes {dict(self.axes)} require {fixed} devices, have "
                f"{n_devices}")
        return MeshConfig(tuple(sizes.items()))

    def canonical(self) -> "MeshConfig":
        """The axes in the outer->inner order, whatever order they were
        given in, so kwargs order never changes which axis is outer."""
        sizes = dict(self.axes)
        order = [a for a in STANDARD_AXES if a in sizes]
        order += [a for a in sizes if a not in STANDARD_AXES]
        return MeshConfig(tuple((a, sizes[a]) for a in order))

    @property
    def names(self) -> tuple[str, ...]:
        return tuple(name for name, _ in self.axes)

    @property
    def shape(self) -> tuple[int, ...]:
        return tuple(size for _, size in self.axes)


@dataclass(frozen=True)
class Mesh:
    """The run's mesh: axis names and sizes, this process's device and,
    for a world of more than one process, the ``DeviceMesh`` over it."""

    axis_names: tuple[str, ...]
    shape: tuple[int, ...]
    device: torch.device
    device_mesh: Optional[Any] = None

    @property
    def sizes(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.shape))

    @property
    def size(self) -> int:
        return prod(self.shape)

    def axis_size(self, name: str) -> int:
        return self.sizes.get(name, 1)

    def submesh(self, *names: str):
        """The ``DeviceMesh`` over ``names`` (those of size > 1 only), or
        None when none of them is larger than 1."""
        wide = tuple(n for n in names if self.axis_size(n) > 1)
        if not wide:
            return None
        return self.device_mesh[wide if len(wide) > 1 else wide[0]]

    def coordinate(self, name: str) -> int:
        """This process's index along axis ``name`` (0 off the mesh)."""
        if self.device_mesh is None or name not in self.axis_names:
            return 0
        return self.device_mesh.get_coordinate()[self.axis_names.index(name)]


def world_size() -> int:
    """The number of processes in this job's world (1 without one)."""
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_initialized() else 1


def create_mesh(device="cuda", config: Optional[MeshConfig] = None,
                **sizes: int) -> Mesh:
    """Build the Mesh over this job's world: ``create_mesh(dp=-1)``,
    ``create_mesh(dp=2, fsdp=2)``... Defaults to pure data parallelism
    over every process. Raises ValueError when the axes do not multiply
    to the world size."""
    if config is None:
        config = MeshConfig.of(**sizes) if sizes else MeshConfig.of(dp=-1)
    n = world_size()
    config = config.canonical().resolve(n)
    device = torch.device(device)
    if n == 1:
        return Mesh(config.names, config.shape, device)
    from torch.distributed.device_mesh import init_device_mesh

    dm = init_device_mesh(device.type, config.shape,
                          mesh_dim_names=config.names)
    return Mesh(config.names, config.shape, device, dm)


def batch_shards(mesh: Mesh) -> int:
    """How many ways the batch dim splits: dp x fsdp."""
    return prod(mesh.axis_size(a) for a in BATCH_AXES)


def local_batch_size(global_batch: int, mesh: Mesh) -> int:
    """The rows of the global batch this process holds: the batch dim
    shards over dp x fsdp and is whole on every pp, tp, ep and sp rank.
    Raises when the global batch does not split evenly."""
    n = batch_shards(mesh)
    if global_batch % n:
        raise ValueError(
            f"global batch {global_batch} not divisible by dp x fsdp = {n}")
    return global_batch // n
