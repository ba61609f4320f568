"""Well-known names shared by the API, controller, and launcher (the
port's copy of ``mpi_operator_tpu/api/v2beta1/constants.py``, plus
``ENV_DIST_BACKEND``; the port keeps its own copy instead of importing
the JAX package).

Reference analogs: v2/pkg/apis/kubeflow/v2beta1/constants.go:5-14 plus the
kubeflow-common label names and the controller's env wiring
(/root/reference/v2/pkg/controller/mpi_job_controller.go:104-205).
"""

# Operator identity.
OPERATOR_NAME = "tpu-operator"
ENV_KUBEFLOW_NAMESPACE = "KUBEFLOW_NAMESPACE"

# Default restart policies (constants.go:22-26 analog).
DEFAULT_RESTART_POLICY = "Never"
DEFAULT_LAUNCHER_RESTART_POLICY = "OnFailure"

# Labels (kubeflow-common label-name analogs, applied by
# mpi_job_controller.go:1502-1508).
OPERATOR_NAME_LABEL = "training.kubeflow.org/operator-name"
JOB_NAME_LABEL = "training.kubeflow.org/job-name"
JOB_ROLE_LABEL = "training.kubeflow.org/job-role"
REPLICA_INDEX_LABEL = "training.kubeflow.org/replica-index"

# Role label values / object-name suffixes (mpi_job_controller.go:104-112).
ROLE_LAUNCHER = "launcher"
ROLE_WORKER = "worker"
# Hot-spare standby workers (spec.tpu.hotSpares): scheduled and
# bootstrapped like workers but parked before the barrier, so a worker
# death is repaired by *promotion* (restamp env, pre-bind to the spare's
# node) instead of the full schedule→pending→bootstrap pipeline.
ROLE_SPARE = "spare"
LAUNCHER_SUFFIX = "-launcher"
WORKER_SUFFIX = "-worker"
SPARE_SUFFIX = "-spare"

# Resource names. The port's worker pods request one GPU each
# (GPU_RESOURCE_NAME); its validation rejects TPU_RESOURCE_NAME, the flip
# of the JAX package's rule.
TPU_RESOURCE_NAME = "google.com/tpu"
GPU_RESOURCE_NAME = "nvidia.com/gpu"

# Env wiring for worker pods — replaces both the hostfile ConfigMap text
# (newConfigMap, mpi_job_controller.go:1106-1128) and the OMPI/I_MPI env
# blocks (:177-201):
ENV_TPU_WORKER_ID = "TPU_WORKER_ID"  # pod index, GKE-compatible
ENV_TPU_WORKER_HOSTNAMES = "TPU_WORKER_HOSTNAMES"  # comma-separated FQDNs
ENV_TPU_ACCELERATOR_TYPE = "TPU_ACCELERATOR_TYPE"
ENV_TPU_TOPOLOGY = "TPU_TOPOLOGY"
ENV_TPU_CHIPS_PER_HOST = "TPU_CHIPS_PER_HOST"
ENV_COORDINATOR_ADDRESS = "TPUJOB_COORDINATOR_ADDRESS"  # host:port of worker-0
ENV_NUM_PROCESSES = "TPUJOB_NUM_PROCESSES"
ENV_PROCESS_ID = "TPUJOB_PROCESS_ID"
ENV_JOB_NAME = "TPUJOB_NAME"
ENV_JOB_NAMESPACE = "TPUJOB_NAMESPACE"
ENV_NUM_SLICES = "TPUJOB_NUM_SLICES"
ENV_SLICE_ID = "TPUJOB_SLICE_ID"

# The torch.distributed backend of the default process group: "nccl" or
# "gloo". Unset: NCCL when the run's tensors live on the card, gloo on
# the CPU. Gloo on the card is for ranks that share one GPU, which NCCL
# refuses; it stages each collective through the host. The pod runner
# sets it when one world's pods outnumber the machine's CUDA devices.
ENV_DIST_BACKEND = "TPUJOB_DIST_BACKEND"

# Chaos-injected per-worker slowdown factor (chaos SlowWorker fault →
# LocalPodRunner child env → cmd/train.py step clock): the trainer
# stretches every step's wall time by this factor, modelling a slow
# host without touching the optimization math.  Unset/1.0 = no-op.
ENV_STEP_SLOWDOWN = "TPUJOB_CHAOS_STEP_SLOWDOWN"

# Chaos-injected per-window HBM leak (chaos MemoryLeak fault →
# LocalPodRunner child env → utils/devstats.py sampler): the victim's
# *reported* bytes-in-use grows by this many bytes every telemetry
# window, driving the real MemoryPressure detector path without
# allocating anything.  Unset/0 = no-op.
ENV_MEM_LEAK_BYTES = "TPU_MEM_LEAK_BYTES"

# Chaos-injected torn checkpoint commit (chaos TornWriteChaos fault →
# LocalPodRunner child env → utils/checkpoint.AsyncCheckpointManager):
# the victim's next checkpoint write lands its step data but dies before
# the commit marker — the on-disk state a writer killed mid-commit
# leaves behind.  One-shot (the runner pops it after one injection);
# unset/0 = no-op.
ENV_TORN_WRITE = "TPUJOB_CHAOS_TORN_WRITE"

# Grace budget (seconds) the preempted final save may spend draining an
# in-flight async checkpoint write before giving up — kept under the
# pod's terminationGracePeriodSeconds so SIGKILL never lands mid-commit.
ENV_CHECKPOINT_GRACE = "TPUJOB_CHECKPOINT_GRACE_S"

# Cross-process trace propagation (W3C traceparent analog): the controller
# stamps the reconcile's (trace id, span id) into every pod it builds, and
# launcher/train adopt it on startup, so operator, launcher, and worker
# spans share one trace id end to end (utils/trace.TraceContext).
ENV_TRACE_CONTEXT = "TPU_TRACE_CONTEXT"

# Multislice (DCN) rendezvous: when numSlices > 1, libtpu's megascale
# runtime forms the cross-slice transport from these variables — the same
# contract GKE's JobSet TPU integration sets for its pods. Slice 0's host
# 0 is the megascale coordinator (distinct from the jax.distributed
# coordinator only in port); ICI stays within a slice, DCN carries the
# cross-slice collectives.
ENV_MEGASCALE_COORDINATOR_ADDRESS = "MEGASCALE_COORDINATOR_ADDRESS"
ENV_MEGASCALE_NUM_SLICES = "MEGASCALE_NUM_SLICES"
ENV_MEGASCALE_SLICE_ID = "MEGASCALE_SLICE_ID"
ENV_MEGASCALE_PORT = "MEGASCALE_PORT"

# Rendezvous defaults.
DEFAULT_COORDINATOR_PORT = 8476  # the store; the gang barrier listens on +1
DEFAULT_MEGASCALE_PORT = 8080  # libtpu megascale's conventional port
DEFAULT_CLEAN_POD_POLICY = "None"

# Elastic restart/rejoin (BASELINE.md milestone 5): every worker pod is
# stamped with the world size its rendezvous env was rendered for.  A
# resize makes the stamp stale; unlike Elastic Horovod (which re-execs
# discover_hosts.sh without restarting, proposals/elastic-horovod.md),
# a torch.distributed world cannot change size in place, so the controller
# restarts stale pods with fresh env — honest restart-and-rejoin.
WORLD_SIZE_ANNOTATION = "tpujob.kubeflow.org/world-size"

# Per-worker step heartbeat (utils/telemetry.py window records), patched
# onto the worker's own Pod by the kubelet sim (runtime/podrunner.py
# tails the pod log for ``step_heartbeat`` JSONL lines) — the kube-native
# transport the step-skew observatory (utils/stepstats.py) consumes via
# the ordinary pod informer watch.  Value: one JSON object.
STEP_HEARTBEAT_ANNOTATION = "tpujob.kubeflow.org/step-heartbeat"

# Per-worker device-memory sample (utils/devstats.py window records),
# patched onto the worker's own Pod by the kubelet sim exactly like the
# step heartbeat above — the transport the device-memory observatory
# (utils/devstats.MemoryMatrix) consumes via the pod informer watch.
# Value: one JSON object.
DEVICE_MEMORY_ANNOTATION = "tpujob.kubeflow.org/device-memory"

# Hot-spare bookkeeping.  STANDBY_ANNOTATION marks a parked spare pod
# ("true"): the scheduler's chip gauges tally standby capacity
# separately and prefer standby gangs as preemption victims.
# PROMOTED_FROM_ANNOTATION on a worker records the spare pod whose warm
# slot it took — the pod is created pre-bound to that spare's node, so
# it skips the scheduler entirely and restart downtime collapses to
# rejoin time.
STANDBY_ANNOTATION = "tpujob.kubeflow.org/standby"
PROMOTED_FROM_ANNOTATION = "tpujob.kubeflow.org/promoted-from"

# ConfigMap keys (hostfile/discover_hosts.sh analogs,
# mpi_job_controller.go:1106-1145).
CONFIG_SUFFIX = "-config"
HOSTNAMES_KEY = "hostnames"
DISCOVER_HOSTS_KEY = "discover_hosts.sh"
