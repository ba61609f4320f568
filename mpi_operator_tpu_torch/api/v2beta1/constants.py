"""The env names the port's launcher and trainer read (a copy of the
needed part of ``mpi_operator_tpu/api/v2beta1/constants.py``; the port
keeps its own copy instead of importing the JAX package)."""

# Env wiring the controller renders into worker pods.
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
# refuses; it stages each collective through the host.
ENV_DIST_BACKEND = "TPUJOB_DIST_BACKEND"

# Chaos-injected per-worker slowdown factor: the trainer stretches every
# step's wall time by this factor. Unset/1.0 = no-op.
ENV_STEP_SLOWDOWN = "TPUJOB_CHAOS_STEP_SLOWDOWN"

# Chaos torn-write hook: when set (non-empty, not "0"), the async
# checkpoint writer withholds the NEXT commit marker, leaving the step
# data without its marker, as a writer killed mid-commit would.
ENV_TORN_WRITE = "TPUJOB_CHAOS_TORN_WRITE"

# Grace budget (seconds) for the preempted final checkpoint save.
ENV_CHECKPOINT_GRACE = "TPUJOB_CHECKPOINT_GRACE_S"

# Cross-process trace propagation: "<trace_id>-<span_id>".
ENV_TRACE_CONTEXT = "TPU_TRACE_CONTEXT"

# Multislice (DCN) rendezvous wiring, checked for consistency before the
# world forms (launcher/bootstrap.py check_multislice).
ENV_MEGASCALE_COORDINATOR_ADDRESS = "MEGASCALE_COORDINATOR_ADDRESS"
ENV_MEGASCALE_NUM_SLICES = "MEGASCALE_NUM_SLICES"
ENV_MEGASCALE_SLICE_ID = "MEGASCALE_SLICE_ID"
ENV_MEGASCALE_PORT = "MEGASCALE_PORT"

# Rendezvous defaults: the coordinator's port; the gang barrier listens
# on the port after it.
DEFAULT_COORDINATOR_PORT = 8476
