"""Scheduler cache: per-node GPU accounting with two-phase reservations
(the port's ``mpi_operator_tpu/scheduler/cache.py``: it counts
``nvidia.com/gpu``, one a worker pod, where the JAX package counts
``google.com/tpu`` chips; "chips" below are GPUs).

kube-scheduler analog: the scheduler cache + "assume" protocol — a pod's
resources are charged optimistically at reserve time so concurrent gang
placement never double-books a host, then committed at bind or rolled
back if any member of the gang fails placement.  The invariant the
fault-injection tier checks: ``allocated + reserved + free == capacity``
on every node, at every step, including across bind conflicts, node
loss mid-reserve, and whole-gang preemption.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from ..api.v2beta1 import constants as api_constants
from . import inventory

PodKey = tuple[str, str]  # (namespace, name)


def is_standby_pod(pod: dict) -> bool:
    """Parked hot-spare pod (spec.tpu.hotSpares): holds chips that are
    charged as allocated but are reclaimable by promotion or preemption."""
    annotations = (pod.get("metadata") or {}).get("annotations") or {}
    return annotations.get(api_constants.STANDBY_ANNOTATION) == "true"


def pod_chips(pod: dict) -> int:
    """``nvidia.com/gpu`` request of a pod's first container (builders
    inject one on every worker; launcher pods request none)."""
    containers = (pod.get("spec") or {}).get("containers") or [{}]
    resources = containers[0].get("resources") or {}
    for bound in ("requests", "limits"):
        value = (resources.get(bound) or {}).get(inventory.GPU_RESOURCE)
        if value is not None:
            try:
                return int(value)
            except (TypeError, ValueError):
                return 0
    return 0


@dataclass
class NodeInfo:
    """One GPU node's capacity as the scheduler sees it."""

    name: str
    capacity: int
    accelerator_type: str = ""
    generation: str = ""
    topology: str = ""
    slice_name: str = ""
    host_index: int = 0
    allocated: int = 0  # chips of bound, non-terminal pods
    reserved: int = 0  # chips of in-flight gang reservations
    standby: int = 0  # subset of allocated held by parked hot-spare pods
    labels: dict = field(default_factory=dict)

    @property
    def free(self) -> int:
        return self.capacity - self.allocated - self.reserved

    @classmethod
    def from_node_object(cls, node: dict) -> "NodeInfo":
        meta = node.get("metadata") or {}
        labels = dict(meta.get("labels") or {})
        capacity = (node.get("status") or {}).get("capacity") or {}
        try:
            chips = int(capacity.get(inventory.GPU_RESOURCE, 0))
        except (TypeError, ValueError):
            chips = 0
        try:
            host_index = int(labels.get(inventory.LABEL_HOST_INDEX, 0))
        except (TypeError, ValueError):
            host_index = 0
        return cls(
            name=meta.get("name", ""),
            capacity=chips,
            accelerator_type=labels.get(inventory.LABEL_ACCELERATOR, ""),
            generation=labels.get(inventory.LABEL_GENERATION, ""),
            topology=labels.get(inventory.LABEL_TOPOLOGY, ""),
            slice_name=labels.get(inventory.LABEL_SLICE, ""),
            host_index=host_index,
            labels=labels,
        )


class SchedulerCache:
    """Nodes + the pod->node ledger.  Not thread-safe on its own; the
    GangScheduler serialises access under its scheduling lock."""

    def __init__(self):
        self.nodes: dict[str, NodeInfo] = {}
        self._reserved: dict[PodKey, tuple[str, int]] = {}
        self._bound: dict[PodKey, tuple[str, int]] = {}

    # -- node set --------------------------------------------------------

    def add_node(self, node: NodeInfo) -> None:
        existing = self.nodes.get(node.name)
        if existing is not None:
            # Keep the ledger: only refresh the static identity fields.
            node.allocated = existing.allocated
            node.reserved = existing.reserved
            node.standby = existing.standby
        self.nodes[node.name] = node

    def remove_node(self, name: str) -> None:
        """Node loss: the node's chips vanish *with* every reservation and
        allocation charged to it (nothing to leak — there is no capacity
        left to leak from)."""
        self.nodes.pop(name, None)
        for ledger in (self._reserved, self._bound):
            for key in [k for k, (n, _) in ledger.items() if n == name]:
                del ledger[key]

    # -- reservations (two-phase) ----------------------------------------

    def reserve(self, key: PodKey, node_name: str, chips: int) -> None:
        self.release(key)  # re-reserve replaces, never stacks
        node = self.nodes[node_name]
        if node.free < chips:
            raise RuntimeError(
                f"reserve over capacity on {node_name}: want {chips}, free {node.free}"
            )
        node.reserved += chips
        self._reserved[key] = (node_name, chips)

    def commit(self, key: PodKey) -> None:
        """Reservation -> allocation (the pod is bound)."""
        node_name, chips = self._reserved.pop(key)
        node = self.nodes.get(node_name)
        if node is not None:
            node.reserved -= chips
            node.allocated += chips
        self._bound[key] = (node_name, chips)

    def release(self, key: PodKey) -> None:
        """Undo a reservation or an allocation (idempotent)."""
        for ledger, attr in ((self._reserved, "reserved"), (self._bound, "allocated")):
            entry = ledger.pop(key, None)
            if entry is not None:
                node = self.nodes.get(entry[0])
                if node is not None:
                    setattr(node, attr, getattr(node, attr) - entry[1])

    def assignment(self, key: PodKey) -> Optional[str]:
        for ledger in (self._reserved, self._bound):
            if key in ledger:
                return ledger[key][0]
        return None

    # -- preemption simulation -------------------------------------------

    def release_bound(self, key: PodKey) -> Optional[tuple[str, int]]:
        """Tentatively free a bound pod's chips; returns the undo token."""
        entry = self._bound.pop(key, None)
        if entry is not None:
            node = self.nodes.get(entry[0])
            if node is not None:
                node.allocated -= entry[1]
        return entry

    def charge_bound(self, key: PodKey, node_name: str, chips: int) -> None:
        node = self.nodes.get(node_name)
        if node is not None:
            node.allocated += chips
        self._bound[key] = (node_name, chips)

    # -- reconciliation ---------------------------------------------------

    def reconcile(self, pods: list[dict]) -> None:
        """Rebuild the allocation ledger from live pod state (bound +
        non-terminal = charged), and drop reservations whose pod is gone
        or has since bound.  Guarantees deletions/completions observed
        between scheduling passes re-account their chips — no leaks even
        without a watch stream."""
        for node in self.nodes.values():
            node.allocated = 0
            node.standby = 0
        self._bound.clear()
        present: set[PodKey] = set()
        for pod in pods:
            meta = pod.get("metadata") or {}
            key = (meta.get("namespace", ""), meta.get("name", ""))
            present.add(key)
            node_name = (pod.get("spec") or {}).get("nodeName")
            phase = (pod.get("status") or {}).get("phase", "")
            if not node_name or phase in ("Succeeded", "Failed"):
                continue
            chips = pod_chips(pod)
            node = self.nodes.get(node_name)
            if node is not None:
                node.allocated += chips
                if is_standby_pod(pod):
                    # Informational tally (rebuilt every pass): standby
                    # chips are inside `allocated`, never double-counted.
                    node.standby += chips
                self._bound[key] = (node_name, chips)
        for key in [k for k in self._reserved if k not in present or k in self._bound]:
            self.release(key)

    # -- aggregates (tests, gauges) ---------------------------------------

    def total_capacity(self) -> int:
        return sum(n.capacity for n in self.nodes.values())

    def total_allocated(self) -> int:
        return sum(n.allocated for n in self.nodes.values())

    def total_reserved(self) -> int:
        return sum(n.reserved for n in self.nodes.values())

    def total_standby(self) -> int:
        return sum(n.standby for n in self.nodes.values())

    def total_free(self) -> int:
        return sum(n.free for n in self.nodes.values())

    def slice_free(self, slice_name: str) -> int:
        return sum(n.free for n in self.nodes.values() if n.slice_name == slice_name)
