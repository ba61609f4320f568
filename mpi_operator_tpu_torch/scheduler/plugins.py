"""Scheduling plugins: the filter -> score surface of the framework (the
port's ``mpi_operator_tpu/scheduler/plugins.py``: capacity is
``nvidia.com/gpu``, so ``GPUCapacityPlugin`` replaces the JAX package's
``TPUCapacityPlugin``; ``TopologyPackPlugin`` is unchanged and, with one
node per slice coordinate, packs a gang onto the fewest 8-GPU nodes).

kube-scheduler analog: scheduler-plugins' framework interfaces, reduced
to the two extension points this operator needs.  Every plugin exposes

- ``name``          — stable identifier (profile config, logs, metrics)
- ``filter(ctx, pod, node)`` — None if the node is feasible, else a
  human-readable reason string (aggregated into the kube-style
  ``0/N nodes are available: ...`` event message)
- ``score(ctx, pod, node)``  — additive integer score; higher is better

``SchedulingContext`` carries gang-level state across a single pass so
plugins can coordinate (the topology packer remembers which slice the
gang's earlier members landed on).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from ..api import topology
from ..api.v2beta1 import constants
from . import inventory
from .cache import NodeInfo, pod_chips


def pod_accelerator_type(pod: dict) -> str:
    """Worker pods carry their slice identity in env (builders stamp
    ``TPU_ACCELERATOR_TYPE``); that is the scheduler's placement hint."""
    containers = (pod.get("spec") or {}).get("containers") or [{}]
    for entry in containers[0].get("env") or []:
        if entry.get("name") == constants.ENV_TPU_ACCELERATOR_TYPE:
            return entry.get("value", "")
    return ""


def pod_generation(pod: dict) -> str:
    accel = pod_accelerator_type(pod)
    if not accel:
        return ""
    try:
        generation, _ = topology.parse_accelerator_type(accel)
    except topology.TopologyError:
        return ""
    return generation


@dataclass
class SchedulingContext:
    """Per-pass state shared by the plugins while one gang is placed."""

    gang_name: str = ""
    # Total chips the gang still needs (decremented as members reserve).
    remaining_chips: int = 0
    # Slice the gang's already-reserved members landed on (packing target).
    chosen_slice: str = ""
    # slice name -> free chips at pass start (for tightest-fit scoring).
    slice_free: dict[str, int] = field(default_factory=dict)


class Plugin:
    """Base plugin: feasible everywhere, indifferent to placement."""

    name = "plugin"

    def filter(self, ctx: SchedulingContext, pod: dict, node: NodeInfo) -> Optional[str]:
        return None

    def score(self, ctx: SchedulingContext, pod: dict, node: NodeInfo) -> int:
        return 0


class GPUCapacityPlugin(Plugin):
    """NodeResourcesFit analog for the single resource that matters:
    ``nvidia.com/gpu``, plus generation compatibility (a job asked for
    one GPU generation runs on nodes of that generation)."""

    name = "GPUCapacity"

    def filter(self, ctx: SchedulingContext, pod: dict, node: NodeInfo) -> Optional[str]:
        generation = pod_generation(pod)
        if generation and node.generation and generation != node.generation:
            return "node(s) had mismatched GPU generation"
        if node.free < pod_chips(pod):
            return f"Insufficient {inventory.GPU_RESOURCE}"
        return None

    def score(self, ctx: SchedulingContext, pod: dict, node: NodeInfo) -> int:
        # Mild most-allocated bias: prefer reusing partially-filled hosts
        # over cracking open empty ones, so whole hosts stay free for
        # gangs that need them.
        return node.capacity - node.free


class CoschedulingPlugin(Plugin):
    """Gang gate (scheduler-plugins coscheduling analog).

    All-or-nothing admission itself lives in the core's gang loop — by
    the time a member pod reaches the plugins, the gang has already been
    admitted as a unit.  This plugin contributes the per-node demand
    check: once a gang is mid-placement, a node too small for even one
    member is infeasible regardless of aggregate capacity.
    """

    name = "Coscheduling"

    def filter(self, ctx: SchedulingContext, pod: dict, node: NodeInfo) -> Optional[str]:
        if ctx.gang_name and node.capacity < pod_chips(pod):
            return f"Insufficient {inventory.GPU_RESOURCE}"
        return None


class TopologyPackPlugin(Plugin):
    """Pack a gang onto one contiguous slice block before spilling.

    Scoring tiers (additive with the other plugins' scores):

    - +1000: node belongs to the slice this gang already started filling
      (never fragment a gang across slices if its first member fit);
    - +500:  node's slice can hold the gang's *entire remaining* demand
      (prefer slices the whole gang fits in, so small gangs don't
      poach hosts from the one slice a big gang needs);
    - minus the slice's free chips: tightest-fit, so the emptiest slice
      stays intact for the biggest future gang;
    - minus the host index: earlier hosts first — combined with
      ``topology.host_grid``'s row-major host ordering this yields
      physically contiguous blocks within the slice.
    """

    name = "TopologyPack"

    def score(self, ctx: SchedulingContext, pod: dict, node: NodeInfo) -> int:
        score = 0
        if not node.slice_name:
            return score
        if ctx.chosen_slice and node.slice_name == ctx.chosen_slice:
            score += 1000
        free_in_slice = ctx.slice_free.get(node.slice_name, 0)
        if free_in_slice >= ctx.remaining_chips > 0:
            score += 500
        score -= free_in_slice
        score -= node.host_index
        return score


DEFAULT_PLUGINS: tuple[Plugin, ...] = (
    CoschedulingPlugin(),
    GPUCapacityPlugin(),
    TopologyPackPlugin(),
)


def run_filters(
    plugins: tuple[Plugin, ...], ctx: SchedulingContext, pod: dict, node: NodeInfo
) -> Optional[str]:
    for plugin in plugins:
        reason = plugin.filter(ctx, pod, node)
        if reason is not None:
            return reason
    return None


def run_scores(
    plugins: tuple[Plugin, ...], ctx: SchedulingContext, pod: dict, node: NodeInfo
) -> int:
    return sum(plugin.score(ctx, pod, node) for plugin in plugins)
