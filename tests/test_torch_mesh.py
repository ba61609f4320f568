"""The port's mesh and batch layout (``mpi_operator_tpu_torch/parallel``)
against the JAX package's: ``MeshConfig.resolve`` (the same sizes, or
the same error) and the outer->inner axis order of ``create_mesh`` over
a set of specs; and, on the 8-device CPU mesh, each device's shard of
a global batch as the JAX trainer places it against the rows the port
gives the process at that device's mesh coordinate (``local_rows``,
``local_batch_size``), exactly.
"""

import jax
import numpy as np
import pytest

from mpi_operator_tpu.cmd import train as jtrain
from mpi_operator_tpu.parallel import mesh as jmesh
from mpi_operator_tpu.parallel import shard_batch as jax_shard_batch
from mpi_operator_tpu_torch.parallel import mesh as tmesh
from mpi_operator_tpu_torch.parallel import sharding as tsharding

pytestmark = pytest.mark.kernel

SPECS = {
    "dp-rest": ({"dp": -1}, 8),
    "dp-fsdp": ({"fsdp": 4, "dp": 2}, 8),
    "fsdp-rest": ({"tp": 2, "fsdp": -1}, 8),
    "four-axes": ({"tp": 2, "dp": 1, "sp": 2, "fsdp": 2}, 8),
    "pp-ep": ({"ep": 2, "pp": 2, "dp": -1}, 8),
    "one": ({"dp": 1}, 1),
    "two-rest": ({"dp": -1, "fsdp": -1}, 8),
    "indivisible": ({"dp": -1, "tp": 3}, 8),
    "too-few": ({"dp": 4, "fsdp": 4}, 8),
    "too-many": ({"dp": 2}, 8),
}


def _resolve(lib, sizes: dict, n: int):
    try:
        return lib.MeshConfig.of(**sizes).resolve(n).axes
    except ValueError as e:
        return str(e)


@pytest.mark.parametrize("name", sorted(SPECS))
def test_mesh_config_resolves_as_the_jax_packages(name):
    sizes, n = SPECS[name]
    assert _resolve(tmesh, sizes, n) == _resolve(jmesh, sizes, n)
    if not isinstance(_resolve(jmesh, sizes, n), str):
        want = jmesh.create_mesh(devices=jax.devices()[:n], **sizes)
        got = tmesh.MeshConfig.of(**sizes).canonical()
        assert got.names == tuple(want.axis_names)


def test_create_mesh_refuses_the_unported_axes_by_item():
    # Every axis is ported (pp last): only the world size stands in
    # their way here.
    for axis in ("ep", "sp", "pp"):
        with pytest.raises(ValueError, match="require 2 devices, have 1"):
            tmesh.create_mesh(device="cpu", dp=1, **{axis: 2})
    assert not hasattr(tmesh, "UNPORTED_AXES")


class _Coordinates:
    """A DeviceMesh stand-in: this process's coordinate on the mesh."""

    def __init__(self, coordinate):
        self.coordinate = list(coordinate)

    def get_coordinate(self):
        return self.coordinate


BATCH_MESHES = ["dp=8", "dp=2,fsdp=4", "dp=4,tp=2", "dp=2,fsdp=2,tp=2",
                "fsdp=8"]


@pytest.mark.parametrize("spec", BATCH_MESHES)
def test_each_process_holds_its_devices_rows_of_the_jax_batch(spec):
    """One process per device: the process at a device's mesh coordinate
    holds exactly that device's shard of a global batch as the JAX
    trainer places it (``parallel.shard_batch``; tp ranks the same
    rows)."""
    mesh = jmesh.create_mesh(**jtrain.parse_mesh_spec(spec))
    whole = np.random.RandomState(4).randint(0, 256, (16, 8))
    tokens = jax_shard_batch(whole, mesh)
    names = tuple(mesh.axis_names)
    for shard in tokens.addressable_shards:
        coord = np.argwhere(mesh.devices == shard.device)[0]
        port = tmesh.Mesh(names, tuple(mesh.devices.shape), None,
                          _Coordinates(coord))
        mine = tsharding.shard_batch((whole,), port)[0]
        np.testing.assert_array_equal(mine, np.asarray(shard.data))
        assert len(mine) == tmesh.local_batch_size(16, port)


def test_microbatch_rows_are_each_microbatchs_shard():
    """With accumulation each process holds its shard of every
    microbatch (global rows [i*B/A, (i+1)*B/A)), so its local rows split
    into A parts are those shards, in order."""
    port = tmesh.Mesh(("dp", "fsdp"), (2, 2), None, _Coordinates((1, 0)))
    assert tsharding.batch_index(port) == 2
    assert tsharding.local_rows(16, port, 2) == [(4, 6), (12, 14)]
    with pytest.raises(ValueError, match="not divisible by dp x fsdp = 4 x "
                                         "accumulation steps 3"):
        tsharding.local_rows(16, port, 3)
    with pytest.raises(ValueError, match="not divisible by dp x fsdp = 4"):
        tmesh.local_batch_size(10, port)


SEQUENCE_MESHES = ["sp=8", "dp=2,sp=4", "dp=2,fsdp=2,sp=2"]


@pytest.mark.parametrize("spec", SEQUENCE_MESHES)
def test_each_process_holds_its_devices_positions_of_the_jax_batch(spec):
    """On sp the process at a device's coordinate holds that device's
    block of a [B, S] batch as the JAX trainer places it
    (``shard_batch(..., sequence_axis=1)``): its rows (sp ranks the same
    rows) and its contiguous run of positions (``local_positions``)."""
    mesh = jmesh.create_mesh(**jtrain.parse_mesh_spec(spec))
    whole = np.random.RandomState(5).randint(0, 256, (8, 16))
    tokens = jax_shard_batch(whole, mesh, sequence_axis=1)
    names = tuple(mesh.axis_names)
    for shard in tokens.addressable_shards:
        coord = np.argwhere(mesh.devices == shard.device)[0]
        port = tmesh.Mesh(names, tuple(mesh.devices.shape), None,
                          _Coordinates(coord))
        rows = tsharding.shard_batch((whole,), port)[0]
        mine = rows[:, tsharding.local_positions(16, port)]
        np.testing.assert_array_equal(mine, np.asarray(shard.data))


@pytest.mark.parametrize("n", [2, 4])
def test_zigzag_positions_are_the_jax_ring_layout(n):
    """With the zigzag ring, sp rank i holds block i of the sequence in
    JAX's zigzag order (``zigzag_indices``): its chunks i and 2n-1-i."""
    import importlib

    jring = importlib.import_module("mpi_operator_tpu.ops.ring_attention")
    perm = jring.zigzag_indices(8 * n, n)
    for i in range(n):
        port = tmesh.Mesh(("sp",), (n,), None, _Coordinates((i,)))
        np.testing.assert_array_equal(
            tsharding.local_positions(8 * n, port, zigzag=True),
            perm[i * 8:(i + 1) * 8])
    with pytest.raises(ValueError, match="not divisible by 2 x sp"):
        tsharding.local_positions(8 * n + 2, port, zigzag=True)
