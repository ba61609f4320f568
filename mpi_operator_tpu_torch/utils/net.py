"""Small networking helpers (the port's copy of
``mpi_operator_tpu/utils/net.py``)."""

from __future__ import annotations

import socket


def free_port_pair() -> int:
    """A free port p whose p+1 is also free.

    The gang barrier binds coordinatorPort+1 next to the process group's
    coordinatorPort, so anything allocating a rendezvous port must probe
    both: a half-free pair hangs worker 0 at bind time.
    """
    for _ in range(64):
        with socket.socket() as a:
            a.bind(("127.0.0.1", 0))
            p = a.getsockname()[1]
        if p + 1 >= 65536:
            continue
        try:
            with socket.socket() as b:
                b.bind(("127.0.0.1", p + 1))
            return p
        except OSError:
            continue
    raise RuntimeError("no adjacent free port pair found")
