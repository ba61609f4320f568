"""GPU node topology math (the port's ``mpi_operator_tpu/api/topology.py``).

The JAX package resolves a TPU slice (``v5e-16`` -> 4 hosts of 4 chips).
The port keeps the same ``acceleratorType`` field and the same
``<generation>-<count>`` convention, with one generation, ``h100``, and
the count counting GPUs:

- a node is one 8-GPU H100 SXM server (the shape of GKE's
  ``a3-highgpu-8g`` and NVIDIA's DGX H100);
- ``h100-1`` ... ``h100-8`` fit on one node; a larger type is a multiple
  of 8 and spans ``count / 8`` whole nodes (``h100-16`` is 2 nodes);
- the topology string is ``<nodes>x<gpus a node>``: ``h100-2`` is
  ``1x2``, ``h100-16`` is ``2x8``. An explicit topology must match;
- the controller runs one worker pod per GPU (``controller/builders.py``),
  so ``SliceShape.chips`` is also the job's worker count.

The TPU generations (``v4``, ``v5e``, ``v5p``, ``v6e``) are refused with
a message that names ``h100-<gpus>``, the mirror of the JAX package
refusing GPU resources.
"""

from __future__ import annotations

from dataclasses import dataclass

GPUS_PER_NODE = 8

# generation name -> GPUs of one node
GENERATIONS: dict[str, int] = {"h100": GPUS_PER_NODE}

# The JAX package's generations: named in the refusal so a TPU manifest
# sent to the port says what to write instead.
TPU_GENERATIONS = ("v4", "v5e", "v5p", "v6e")


class TopologyError(ValueError):
    pass


@dataclass(frozen=True)
class SliceShape:
    """Resolved shape of one job's GPUs: ``num_hosts`` nodes of
    ``chips_per_host`` GPUs each (``chips`` GPUs in all)."""

    generation: str
    chips: int
    topology: str  # "<nodes>x<gpus a node>"
    num_hosts: int
    chips_per_host: int

    @property
    def accelerator_type(self) -> str:
        return f"{self.generation}-{self.chips}"

    def dims(self) -> tuple[int, ...]:
        return parse_topology(self.topology)


def parse_accelerator_type(accelerator_type: str) -> tuple[str, int]:
    """``"h100-16"`` -> ``("h100", 16)``."""
    parts = accelerator_type.rsplit("-", 1)
    if len(parts) == 2 and parts[0] in TPU_GENERATIONS:
        raise TopologyError(
            f"invalid acceleratorType {accelerator_type!r}: TPU generation "
            f"{parts[0]!r} is not served by the GPU operator; want "
            f"h100-<gpus> (one worker pod per GPU)"
        )
    if len(parts) != 2 or parts[0] not in GENERATIONS:
        raise TopologyError(
            f"invalid acceleratorType {accelerator_type!r}: want "
            f"<generation>-<gpus> with generation in {sorted(GENERATIONS)}, "
            f"e.g. h100-8"
        )
    try:
        chips = int(parts[1])
    except ValueError:
        raise TopologyError(
            f"invalid acceleratorType {accelerator_type!r}: GPU count "
            f"{parts[1]!r} is not an integer"
        ) from None
    if chips <= 0:
        raise TopologyError(
            f"invalid acceleratorType {accelerator_type!r}: GPU count must be positive"
        )
    return parts[0], chips


def parse_topology(topology: str) -> tuple[int, ...]:
    """``"2x8"`` -> ``(2, 8)``."""
    try:
        dims = tuple(int(p) for p in topology.split("x"))
    except ValueError:
        raise TopologyError(f"invalid topology {topology!r}") from None
    if len(dims) != 2 or any(d <= 0 for d in dims):
        raise TopologyError(
            f"invalid topology {topology!r}: want <nodes>x<gpus a node> "
            f"with positive counts"
        )
    return dims


def default_topology(generation: str, chips: int) -> str:
    per_node = GENERATIONS.get(generation)
    if per_node is None:
        raise TopologyError(f"unknown GPU generation {generation!r}")
    if chips <= per_node:
        return f"1x{chips}"
    if chips % per_node:
        raise TopologyError(
            f"no standard topology for {generation}-{chips}: a job larger "
            f"than one node takes whole {per_node}-GPU nodes, so its GPU "
            f"count must be a multiple of {per_node}"
        )
    return f"{chips // per_node}x{per_node}"


def resolve(accelerator_type: str, topology: str = "") -> SliceShape:
    """Resolve acceleratorType (+ optional explicit topology) to a SliceShape.

    Raises TopologyError on inconsistency: a GPU count that does not fill
    whole nodes, a topology whose product is not the GPU count, or one
    that puts more GPUs on a node than the node has.
    """
    generation, chips = parse_accelerator_type(accelerator_type)
    per_node = GENERATIONS[generation]
    want = default_topology(generation, chips)
    if not topology:
        topology = want
    nodes, gpus = parse_topology(topology)
    if nodes * gpus != chips:
        raise TopologyError(
            f"topology {topology!r} has {nodes * gpus} GPUs but acceleratorType "
            f"{accelerator_type!r} declares {chips}"
        )
    if topology != want:
        raise TopologyError(
            f"topology {topology!r} does not match {accelerator_type!r}: "
            f"{per_node}-GPU nodes give {want}"
        )
    return SliceShape(
        generation=generation,
        chips=chips,
        topology=topology,
        num_hosts=nodes,
        chips_per_host=gpus,
    )


def host_grid(shape: SliceShape) -> list[tuple[int, ...]]:
    """Coordinate of every node of the shape, indexed by node id: the
    node index along the first dimension (``(i, 0)``). GPU nodes are
    joined all to all inside and by the network between, so there is no
    torus to keep contiguous; the scheduler's packer only needs the
    order, and packs a gang onto the fewest nodes."""
    return [(i, 0) for i in range(shape.num_hosts)]


def resolve_shape_or_none(accelerator_type: str, topology: str = ""):
    """``resolve`` that returns None instead of raising — the scheduler
    consumes inventory/pod hints best-effort and must not crash on a
    malformed one."""
    try:
        return resolve(accelerator_type, topology)
    except TopologyError:
        return None
