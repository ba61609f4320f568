"""Rendezvous bootstrap for training workers (port of
``mpi_operator_tpu/launcher/bootstrap.py``, single-process case).

The controller injects the rendezvous env; ``initialize()`` reads it.
A one-process job needs no world; a multi-process one raises until
world formation over ``torch.distributed`` is ported (ROADMAP.md queue
(a) item 6).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Mapping, Optional

from ..api.v2beta1 import constants
from ..utils import trace
from ..utils.logging import get_logger

log = get_logger("launcher")


@dataclass
class RendezvousConfig:
    """The part of the rendezvous env a one-process worker reads; the
    coordinator address, slices and megascale wiring come with world
    formation."""

    num_processes: int = 1
    process_id: int = 0

    @classmethod
    def from_env(cls, environ: Optional[Mapping[str, str]] = None
                 ) -> "RendezvousConfig":
        env = os.environ if environ is None else environ

        def _int(name: str, default: int) -> int:
            try:
                return int(env.get(name, default))
            except (TypeError, ValueError):
                return default

        return cls(
            num_processes=_int(constants.ENV_NUM_PROCESSES, 1),
            process_id=_int(constants.ENV_PROCESS_ID, 0),
        )

    @property
    def is_distributed(self) -> bool:
        return self.num_processes > 1


def initialize(config: Optional[RendezvousConfig] = None) -> RendezvousConfig:
    """Join the job's world. Single-process jobs (num_processes == 1)
    need none, so the same worker image runs unchanged on one host."""
    # Adopt the controller-stamped trace context before anything logs.
    trace.adopt_from_environ()
    cfg = config or RendezvousConfig.from_env()
    if not cfg.is_distributed:
        log.info("single-process job; skipping distributed initialization")
        return cfg
    raise NotImplementedError(
        f"a {cfg.num_processes}-process world needs torch.distributed world "
        f"formation, which is not ported yet (ROADMAP.md queue (a) item 6)"
    )
