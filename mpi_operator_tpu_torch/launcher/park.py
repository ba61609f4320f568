"""Hot-spare parking loop — the standby worker command (the port's copy of
``mpi_operator_tpu/launcher/park.py``; it imports no torch, so a spare
holds no CUDA context).

A spare pod (``spec.tpu.hotSpares``) must pay the expensive part of worker
startup *before* it is needed: get scheduled, pull the image, warm the
Python runtime. What it must NOT do is join the collective barrier — a
parked spare is invisible to the training gang. So the command is simply:
announce readiness as one JSON line, then sleep until told to stop.

Termination contract: promotion deletes the spare pod, which delivers
SIGTERM; the loop exits 0 immediately (there is no state to drain). Exit 0
matters — a podFailurePolicy must never classify a promoted-away spare as
a worker failure.

Run as ``python -m mpi_operator_tpu_torch.launcher.park``.
"""

from __future__ import annotations

import os
import signal
import sys
import threading

from ..api.v2beta1 import constants
from ..utils.logging import emit_json, get_logger

log = get_logger("launcher.park")

EXIT_OK = 0

ENV_PARK_TIMEOUT = "TPUJOB_PARK_TIMEOUT_S"  # mostly for tests; default: forever
_POLL_INTERVAL_S = 1.0


def main() -> int:
    stop = threading.Event()

    def _on_term(signum: int, frame: object) -> None:
        log.info("park: received signal %d, unparking", signum)
        stop.set()

    signal.signal(signal.SIGTERM, _on_term)
    signal.signal(signal.SIGINT, _on_term)

    emit_json(
        {
            "parked": True,
            "job_name": os.environ.get(constants.ENV_JOB_NAME, ""),
            "job_namespace": os.environ.get(constants.ENV_JOB_NAMESPACE, ""),
            "pid": os.getpid(),
        },
        stream=sys.stdout,
    )

    timeout_raw = os.environ.get(ENV_PARK_TIMEOUT, "")
    deadline: float | None
    try:
        deadline = float(timeout_raw) if timeout_raw else None
    except ValueError:
        deadline = None

    waited = 0.0
    while not stop.is_set():
        if deadline is not None and waited >= deadline:
            break
        stop.wait(_POLL_INTERVAL_S)
        waited += _POLL_INTERVAL_S
    return EXIT_OK


if __name__ == "__main__":
    sys.exit(main())
