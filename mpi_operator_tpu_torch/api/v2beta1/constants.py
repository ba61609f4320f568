"""The env names the port's trainer reads (a copy of the needed part of
``mpi_operator_tpu/api/v2beta1/constants.py``; the port keeps its own
copy instead of importing the JAX package)."""

# Env wiring the controller renders into worker pods.
ENV_TPU_WORKER_ID = "TPU_WORKER_ID"  # pod index, GKE-compatible
ENV_NUM_PROCESSES = "TPUJOB_NUM_PROCESSES"
ENV_PROCESS_ID = "TPUJOB_PROCESS_ID"

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
