"""kubeflow.org/v2beta1 TPUJob API group.

Reference analog: /root/reference/v2/pkg/apis/kubeflow/v2beta1 (scheme
registration register.go:24-45 collapses to these re-exports).
"""

from .constants import *  # noqa: F401,F403
from .defaults import set_defaults_tpujob  # noqa: F401
from .queue_types import (  # noqa: F401
    CLUSTER_QUEUE_KIND,
    CLUSTER_QUEUE_PLURAL,
    LOCAL_QUEUE_KIND,
    LOCAL_QUEUE_PLURAL,
    RECLAIM_ANY,
    RECLAIM_NEVER,
    ClusterQueue,
    ClusterQueueSpec,
    ClusterQueueStatus,
    GenerationQuota,
    LocalQueue,
    LocalQueueSpec,
    PreemptionPolicy,
)
from .types import (  # noqa: F401
    API_VERSION,
    GROUP_NAME,
    GROUP_VERSION,
    JOB_CREATED,
    JOB_FAILED,
    JOB_QUEUE_NOT_FOUND,
    JOB_QUOTA_RESERVED,
    JOB_RESTARTING,
    JOB_RUNNING,
    JOB_SUCCEEDED,
    JOB_SUSPENDED,
    KIND,
    PLURAL,
    REPLICA_TYPE_LAUNCHER,
    REPLICA_TYPE_WORKER,
    JAXDistributionSpec,
    JobCondition,
    JobStatus,
    ReplicaSpec,
    ReplicaStatus,
    RunPolicy,
    SchedulingPolicy,
    TPUJob,
    TPUJobSpec,
    TPUSpec,
)
