"""Shared helpers for the CUDA kernels in this package."""

from __future__ import annotations

import torch

# ----------------------------------------------------------------------
# Tile plumbing, in ONE place. The flash kernels' thread map (256
# threads; each thread owns 4 rows x 4 columns of a 64 x 64 score tile
# and 4 rows x 8 head-dim columns of the accumulators) is built for
# 64 x 64 tiles: small enough that the three f32 [64, D<=128] operand
# tiles plus the p tile fit one block's shared memory on Hopper
# (~116-166 KB of the 227 KB a block may use) and that enough blocks
# exist to fill 132 SMs at the Llama shape (B=2, S=2048, H=32 -> 2048
# forward blocks). ops/_build.py passes these to nvcc as -D defines; the
# kernel's static_assert refuses any other value.
# ----------------------------------------------------------------------

DEFAULT_BLOCK_Q = 64   # flash attention q-tile (rows per block)
DEFAULT_BLOCK_K = 64   # flash attention k-tile (rows per inner step)


def clamp_tile(tile: int, extent: int, floor: int = 1) -> int:
    """The shared tile clamp: a tile never exceeds the axis extent it
    walks (short sequences, small row counts) but keeps a floor so a
    degenerate extent still yields a legal walk."""
    return min(tile, max(extent, floor))


def require_device(device) -> torch.device:
    """Resolve ``device`` and raise when ``cuda`` is asked for but absent.

    Entry points run on the card unless the caller asks for the CPU; they
    never quietly move to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but no CUDA device is available; "
            f"pass device='cpu' (--device cpu) to run on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(dev)!r}; want cuda or cpu")
    return dev
