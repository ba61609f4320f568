"""Mesh construction (port of ``mpi_operator_tpu/parallel/mesh.py``).

Axis convention (outer -> inner), as in the JAX package:

    ('dp', 'pp', 'fsdp', 'ep', 'tp', 'sp')

A size of ``-1`` means "whatever is left" (at most one axis). This slice
of the port runs on one device: every axis resolves to 1, and asking for
a larger axis raises until ``torch.distributed`` meshes are ported
(ROADMAP.md queue (a) items 6-7).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

DP = "dp"
PP = "pp"  # pipeline parallelism: layer stages live here
FSDP = "fsdp"
EP = "ep"  # expert parallelism: MoE expert dim lives here
TP = "tp"
SP = "sp"

STANDARD_AXES = (DP, PP, FSDP, EP, TP, SP)


@dataclass(frozen=True)
class Mesh:
    """A one-device mesh: the axis names and sizes (all 1) and the
    device every tensor of the run lives on."""

    axis_names: tuple[str, ...]
    shape: tuple[int, ...]
    device: torch.device

    @property
    def sizes(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.shape))


def create_mesh(device="cuda", **sizes: int) -> Mesh:
    """Build a Mesh. ``create_mesh(dp=-1)`` -> the one-device mesh.

    A size of -1 (at most one axis) or 1 resolves to 1. Raises ValueError
    for any axis larger than 1: multi-device meshes come with
    torch.distributed (ROADMAP.md queue (a) items 6-7)."""
    sizes = sizes or {DP: -1}
    wide = {a: n for a, n in sizes.items() if n > 1}
    if wide:
        raise ValueError(
            f"mesh axes {wide} need more than one device; multi-device "
            f"meshes are not ported yet (ROADMAP.md queue (a) items 6-7)"
        )
    bad = {a: n for a, n in sizes.items() if n not in (1, -1)}
    if bad or list(sizes.values()).count(-1) > 1:
        raise ValueError(
            f"bad mesh axes {sizes}: sizes are 1, or -1 on at most one axis"
        )
    # Canonical outer->inner order, as in the JAX package.
    names = [a for a in STANDARD_AXES if a in sizes]
    names += [a for a in sizes if a not in STANDARD_AXES]
    return Mesh(tuple(names), (1,) * len(names), torch.device(device))
