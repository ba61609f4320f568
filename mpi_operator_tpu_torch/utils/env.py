"""Environment plumbing for chipless subprocesses (the port's counterpart
of ``mpi_operator_tpu/utils/env.py``)."""

from __future__ import annotations

import os

# Every variable that tells a process which world to join: the
# controller's rendezvous env (``launcher/bootstrap.py``) and
# ``torch.distributed``'s own. A child that inherits one of them joins
# (or waits for) its parent's world instead of forming its own.
WORLD_ENV_VARS = (
    "TPUJOB_COORDINATOR_ADDRESS",
    "TPUJOB_NUM_PROCESSES",
    "TPUJOB_PROCESS_ID",
    "TPUJOB_DIST_BACKEND",
    "TPU_WORKER_ID",
    "MASTER_ADDR",
    "MASTER_PORT",
    "RANK",
    "WORLD_SIZE",
    "LOCAL_RANK",
)


def cpu_subprocess_env() -> dict:
    """A copy of ``os.environ`` for a child that must run on the CPU: no
    CUDA device visible, every world variable of :data:`WORLD_ENV_VARS`
    scrubbed, and one intra-op thread (gangs of such children share the
    host's cores).

    The single source of truth for chipless subprocess harnesses
    (``entry.dryrun_multichip`` on ``device="cpu"``): a child that keeps
    one of these variables grabs the card or joins its parent's world.
    A caller that forms a world of its own sets its variables on the
    copy."""
    env = dict(os.environ)
    env["CUDA_VISIBLE_DEVICES"] = ""
    env["OMP_NUM_THREADS"] = "1"
    for var in WORLD_ENV_VARS:
        env.pop(var, None)
    return env
