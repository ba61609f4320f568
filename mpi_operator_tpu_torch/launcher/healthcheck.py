"""Collective smoke test, the default worker command (port of
``mpi_operator_tpu/launcher/healthcheck.py``): join the world, gather
every rank's process id over the default group on its device, check
that every rank answered, exit 0. A one-process job proves the device
answers with a local reduction on it.

Failure taxonomy: the common startup races each get a distinct exit code
(below) so a ``runPolicy.podFailurePolicy`` rule can match them, e.g.
Restart on DNS-not-ready or connection-refused (the coordinator pod is
not up yet) while a genuine collective failure still burns the backoff
budget. Every preflight probe runs under its own timeout
(``TPUJOB_HEALTHCHECK_PROBE_TIMEOUT_S``, default 5 s).

    python -m mpi_operator_tpu_torch.launcher.healthcheck [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import socket
import sys

from ..api.v2beta1 import constants
from ..utils.logging import emit_json, get_logger
from .bootstrap import RendezvousConfig, initialize, shutdown

log = get_logger("launcher.healthcheck")

# Exit codes (stable contract for podFailurePolicy onExitCodes rules).
EXIT_OK = 0
EXIT_UNHEALTHY = 1  # world assembled but the collective check failed
EXIT_DNS_NOT_READY = 12  # coordinator hostname does not resolve yet
EXIT_CONNECTION_REFUSED = 13  # resolves, but nothing is listening yet
EXIT_BARRIER_TIMEOUT = 14  # gang never fully assembled

ENV_PROBE_TIMEOUT = "TPUJOB_HEALTHCHECK_PROBE_TIMEOUT_S"
DEFAULT_PROBE_TIMEOUT_S = 5.0


class ProbeFailure(RuntimeError):
    """A preflight probe failed; carries the exit code to die with."""

    def __init__(self, exit_code: int, message: str):
        super().__init__(message)
        self.exit_code = exit_code


def probe_rendezvous(cfg: RendezvousConfig, *,
                     timeout_s: float = DEFAULT_PROBE_TIMEOUT_S) -> None:
    """Preflight the rendezvous path, one bounded probe at a time.

    1. Resolve the coordinator hostname (headless-service DNS records
       appear only once the coordinator pod has an IP): failure is
       ``EXIT_DNS_NOT_READY``.
    2. Non-coordinator ranks dial the barrier side port (coordinator
       port + 1): a refused or unreachable dial is
       ``EXIT_CONNECTION_REFUSED``. Rank 0 skips this: it hosts the
       barrier itself.

    Raises ProbeFailure.
    """
    if not cfg.is_distributed or not cfg.coordinator_address:
        return
    host, port = cfg.coordinator()
    try:
        infos = socket.getaddrinfo(host, port, type=socket.SOCK_STREAM)
    except socket.gaierror as e:
        raise ProbeFailure(EXIT_DNS_NOT_READY,
                           f"coordinator {host!r} does not resolve yet: {e}")
    if not infos:
        raise ProbeFailure(EXIT_DNS_NOT_READY,
                           f"coordinator {host!r} resolved to nothing")
    if cfg.is_coordinator:
        return
    barrier_port = port + 1
    try:
        with socket.create_connection((host, barrier_port), timeout=timeout_s):
            pass  # reachable; the barrier server drops silent probes
    except OSError as e:
        raise ProbeFailure(
            EXIT_CONNECTION_REFUSED,
            f"barrier port {host}:{barrier_port} not accepting: {e}")


def collective_probe(cfg: RendezvousConfig, device) -> bool:
    """The check itself: every rank's process id, gathered over the
    default group on this process's ``device`` (the collective path the
    trainer's gradients take: NCCL on the card), must be 0..n-1 once
    each. A one-process job that formed no world proves the device
    answers with a reduction on it."""
    import torch
    import torch.distributed as dist

    if not dist.is_initialized():
        ones = torch.ones(4, device=device)
        return bool(int(ones.sum().item()) == 4)
    mine = torch.tensor([cfg.process_id], dtype=torch.int64, device=device)
    seen = [torch.empty_like(mine) for _ in range(dist.get_world_size())]
    dist.all_gather(seen, mine)
    return sorted(int(t.item()) for t in seen) == list(
        range(cfg.num_processes))


def run_healthcheck(config: RendezvousConfig | None = None, *,
                    device_type: str = "cuda",
                    probe_timeout_s: float = DEFAULT_PROBE_TIMEOUT_S,
                    barrier_timeout_s: float = 300.0) -> dict:
    import torch

    from .bootstrap import process_device

    cfg = config or RendezvousConfig.from_env()
    probe_rendezvous(cfg, timeout_s=probe_timeout_s)
    try:
        cfg = initialize(cfg, device_type=device_type,
                         initialization_timeout_seconds=int(barrier_timeout_s))
    except TimeoutError as e:
        raise ProbeFailure(EXIT_BARRIER_TIMEOUT, str(e))
    device = process_device(cfg.process_id, device_type)
    local = torch.cuda.device_count() if device.type == "cuda" else 1
    return {
        "ok": collective_probe(cfg, device),
        "process_id": cfg.process_id,
        "num_processes": cfg.num_processes,
        "device": str(device),
        "device_count": cfg.num_processes,
        "local_device_count": local,
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="tpujob-healthcheck-torch")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="cuda raises when no GPU is present")
    args = p.parse_args(argv)
    try:
        probe_timeout_s = float(
            os.environ.get(ENV_PROBE_TIMEOUT, DEFAULT_PROBE_TIMEOUT_S))
    except ValueError:
        probe_timeout_s = DEFAULT_PROBE_TIMEOUT_S
    from ..ops._common import require_device

    require_device(args.device)
    try:
        result = run_healthcheck(device_type=args.device,
                                 probe_timeout_s=probe_timeout_s)
    except ProbeFailure as e:
        log.warning("healthcheck probe failed: %s", e)
        emit_json({"ok": False, "error": str(e), "exit_code": e.exit_code},
                  stream=sys.stdout)
        return e.exit_code
    finally:
        # Leave the world before the interpreter exits: a gloo group torn
        # down by the exit itself can abort the process (SIGABRT), which
        # fails the pod that runs this as its default command.
        shutdown()
    # One JSON line on stdout (sorted keys), as the JAX command prints.
    emit_json(result, stream=sys.stdout)
    return EXIT_OK if result["ok"] else EXIT_UNHEALTHY


if __name__ == "__main__":
    sys.exit(main())
