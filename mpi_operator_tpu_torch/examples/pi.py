"""Monte-Carlo pi over torch.distributed — the operator's e2e payload
(the port's ``examples/v2beta1/pi/pi.py``).

Each worker draws rank-seeded samples, counts the hits inside the unit
circle with one torch op on its device, then an ``all_gather`` over the
job's world (``launcher/bootstrap.initialize``) sums the counts. Exit
code 0 iff the estimate is within 0.05 of pi, which is what the job's
Succeeded condition reports.

Run by the operator (``pi.yaml``) or by hand:
``python -m mpi_operator_tpu_torch.examples.pi [--device cpu]``.
"""

from __future__ import annotations

import argparse
import math
import sys

from ..launcher.bootstrap import initialize, process_device, shutdown

SAMPLES_PER_PROCESS = 100_000


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    p.add_argument("--samples", type=int, default=SAMPLES_PER_PROCESS,
                   help="samples a process draws")
    args = p.parse_args(argv)

    import torch
    import torch.distributed as dist

    cfg = initialize(device_type=args.device)
    device = process_device(cfg.process_id, args.device)
    # Rank-seeded local sampling (the reference's srand(rank)).
    gen = torch.Generator().manual_seed(cfg.process_id)
    xy = torch.rand(args.samples, 2, generator=gen).to(device)
    hits = ((xy * xy).sum(dim=1) < 1.0).sum().reshape(1)
    if cfg.is_distributed:
        gathered = [torch.zeros_like(hits) for _ in range(cfg.num_processes)]
        dist.all_gather(gathered, hits)
        total_hits = int(torch.cat(gathered).sum())
    else:
        total_hits = int(hits)
    total_samples = args.samples * cfg.num_processes
    pi = 4.0 * total_hits / total_samples
    if cfg.is_coordinator:
        result = (f"pi is approximately {pi:.6f} ({total_samples} samples, "
                  f"{cfg.num_processes} processes, {device.type})")
        # The job's result line is the program's output, as the JAX pi
        # example (which lives outside its package) prints it.
        print(result, flush=True)  # noqa: TPU201
    if cfg.is_distributed:
        shutdown()
    return 0 if abs(pi - math.pi) < 0.05 else 1


if __name__ == "__main__":
    sys.exit(main())
