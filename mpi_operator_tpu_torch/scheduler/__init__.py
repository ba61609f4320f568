"""In-process gang scheduler (the port's ``mpi_operator_tpu/scheduler``,
placing one-GPU worker pods onto 8-GPU nodes; originally for TPU slices).

An in-memory kube-scheduler analog with a filter -> score -> reserve ->
bind pipeline, specialised for the one thing TPU training jobs need
that the default scheduler lacks: *all-or-nothing* placement of a whole
slice's worth of workers, with whole-gang preemption and
topology-aware packing.  See ``docs/scheduling.md``.
"""

from .binder import Binder, BindError, FlakyBinder
from .cache import NodeInfo, SchedulerCache, pod_chips
from .core import (
    DEFAULT_PRIORITIES,
    DEFAULT_SCHEDULER_NAME,
    GROUP_ANNOTATION,
    GangScheduler,
    gang_of,
)
from .inventory import (
    InventoryError,
    GPU_RESOURCE,
    build_nodes,
    parse_inventory,
    register_nodes,
)
from .plugins import (
    DEFAULT_PLUGINS,
    CoschedulingPlugin,
    Plugin,
    SchedulingContext,
    GPUCapacityPlugin,
    TopologyPackPlugin,
)

__all__ = [
    "Binder",
    "BindError",
    "FlakyBinder",
    "NodeInfo",
    "SchedulerCache",
    "pod_chips",
    "DEFAULT_PRIORITIES",
    "DEFAULT_SCHEDULER_NAME",
    "GROUP_ANNOTATION",
    "GangScheduler",
    "gang_of",
    "InventoryError",
    "GPU_RESOURCE",
    "build_nodes",
    "parse_inventory",
    "register_nodes",
    "DEFAULT_PLUGINS",
    "CoschedulingPlugin",
    "Plugin",
    "SchedulingContext",
    "GPUCapacityPlugin",
    "TopologyPackPlugin",
]
