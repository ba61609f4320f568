"""GPU node inventory: the scheduler's capacity model (the port's
``mpi_operator_tpu/scheduler/inventory.py``).

A GPU node pool exposes one Kubernetes Node per server, with
``nvidia.com/gpu`` in ``status.capacity`` (the NVIDIA device plugin's
resource). The memory backend has no cloud to discover, so the operator
materialises the same shape from a compact ``--node-inventory`` spec, in
the ``h100-<gpus>`` convention of ``api/topology.py``:

    h100-8:2                ->  2 slices of h100-8 (one 8-GPU node each)
    h100-16                 ->  1 slice of h100-16 (two 8-GPU nodes)

Each slice becomes ``num_hosts`` Node objects of ``chips_per_host`` GPUs,
registered as the ``nodes`` resource on the API server; nodes carry their
slice name, node index and coordinate (``topology.host_grid``: the node
index) so the scheduler packs a gang onto the fewest nodes. The label
keys keep the operator's own prefix.
"""

from __future__ import annotations

from ..api import topology

# Node label keys (GKE analogs, under one operator-owned prefix).
LABEL_ACCELERATOR = "tpu.operator.kubeflow.org/accelerator-type"
LABEL_GENERATION = "tpu.operator.kubeflow.org/generation"
LABEL_TOPOLOGY = "tpu.operator.kubeflow.org/topology"
LABEL_SLICE = "tpu.operator.kubeflow.org/slice"
LABEL_HOST_INDEX = "tpu.operator.kubeflow.org/host-index"
LABEL_HOST_COORD = "tpu.operator.kubeflow.org/host-coord"

GPU_RESOURCE = "nvidia.com/gpu"


class InventoryError(ValueError):
    pass


def parse_inventory(spec: str) -> list[tuple[topology.SliceShape, int]]:
    """``"h100-8:2,h100-16"`` -> [(SliceShape(h100-8), 2), (SliceShape(h100-16), 1)].

    Entry grammar: ``accelType[/topology][:count]``.
    """
    out: list[tuple[topology.SliceShape, int]] = []
    for raw in spec.split(","):
        entry = raw.strip()
        if not entry:
            continue
        count = 1
        if ":" in entry:
            entry, _, count_str = entry.rpartition(":")
            try:
                count = int(count_str)
            except ValueError:
                raise InventoryError(
                    f"bad slice count {count_str!r} in inventory entry {raw!r}"
                ) from None
            if count <= 0:
                raise InventoryError(
                    f"slice count must be positive in inventory entry {raw!r}"
                )
        accel, _, topo = entry.partition("/")
        try:
            shape = topology.resolve(accel, topo)
        except topology.TopologyError as e:
            raise InventoryError(f"inventory entry {raw!r}: {e}") from None
        out.append((shape, count))
    if not out:
        raise InventoryError(f"empty node inventory spec {spec!r}")
    return out


def slice_name(shape: topology.SliceShape, index: int) -> str:
    return f"{shape.accelerator_type}-{index}"


def node_name(shape: topology.SliceShape, slice_index: int, host: int) -> str:
    return f"gpu-{shape.accelerator_type}-s{slice_index}-h{host}"


def build_nodes(spec: str) -> list[dict]:
    """Render the inventory spec into Node objects (one per GPU server)."""
    nodes: list[dict] = []
    slice_counter: dict[str, int] = {}
    for shape, count in parse_inventory(spec):
        grid = topology.host_grid(shape)
        for _ in range(count):
            idx = slice_counter.get(shape.accelerator_type, 0)
            slice_counter[shape.accelerator_type] = idx + 1
            for host in range(shape.num_hosts):
                coord = "-".join(str(c) for c in grid[host])
                nodes.append(
                    {
                        "apiVersion": "v1",
                        "kind": "Node",
                        "metadata": {
                            "name": node_name(shape, idx, host),
                            "labels": {
                                LABEL_ACCELERATOR: shape.accelerator_type,
                                LABEL_GENERATION: shape.generation,
                                LABEL_TOPOLOGY: shape.topology,
                                LABEL_SLICE: slice_name(shape, idx),
                                LABEL_HOST_INDEX: str(host),
                                LABEL_HOST_COORD: coord,
                            },
                        },
                        "status": {
                            "capacity": {GPU_RESOURCE: shape.chips_per_host},
                            "allocatable": {GPU_RESOURCE: shape.chips_per_host},
                        },
                    }
                )
    return nodes


def register_nodes(api, spec: str) -> list[dict]:
    """Create the inventory's Node objects on the API server (idempotent:
    an already-registered node is left as-is, so operator restarts against
    a persistent backend do not duplicate or clobber)."""
    from ..runtime.apiserver import AlreadyExistsError

    created = []
    for node in build_nodes(spec):
        try:
            created.append(api.create("nodes", node))
        except AlreadyExistsError:
            created.append(api.get("nodes", "", node["metadata"]["name"]))
    return created
