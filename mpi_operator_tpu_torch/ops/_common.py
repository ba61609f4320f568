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

# ----------------------------------------------------------------------
# BN reductions (csrc/bn_stats.cu, csrc/bn_grads.cu) over an [M, C]
# operand with C innermost. The TPU kernels stream 512-row tiles through
# one core in order and carry the sums across grid steps; on the H100
# blocks run in parallel on 132 SMs, so the rows are cut into chunks,
# each block writes its chunk's per-channel partial sums, and a second
# short pass adds the partials in a fixed order (the same sums from run
# to run; no float atomics).
#
# Thread map: 256 threads a block. Each thread loads 16 bytes at a time
# (8 bf16 or 4 f32 channels) where C and the pointers allow it, else
# fewer; up to 32 threads sit side by side across a row's channels (one
# coalesced 512-byte warp read at C >= 256 bf16), the rest stand on the
# following rows. A narrow layer (the stem, C=64 bf16: 8 threads a row)
# thus reads 32 rows per pass and a wide one (C=2048) gets 8 channel
# tiles on the grid.
#
# Row tile: not a constant as on the TPU. Only the grid must fill the
# card: chunks are sized so that a layer gets about 4 blocks per SM
# (528), but a block never walks fewer than 64 rows, so the partials
# stay small beside the operand. At B=64 the stem ([802816, 64]) gets
# 523 chunks of 1536 rows and stage 3 ([3136, 2048]) 49 chunks of 64
# rows on each of its 8 channel tiles.
# ----------------------------------------------------------------------

BN_THREADS = 256        # threads per block (csrc/bn_common.cuh BN_THREADS)
BN_MAX_LANES = 32       # threads across the channels of one row
BN_VEC_BYTES = 16       # the widest load a thread makes
BN_TARGET_BLOCKS = 4 * 132  # about 4 blocks on each of the H100's 132 SMs
BN_MIN_TILE_M = 64      # rows a block walks at least


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def bn_geometry(m: int, c: int, elem_bytes: int, ptrs=()) -> tuple:
    """The launch geometry of a BN reduction over ``[m, c]`` operands
    whose widest element has ``elem_bytes`` bytes and whose first
    elements sit at the addresses ``ptrs``.

    Returns ``(vec, lanes, rows_per_chunk, n_chunks)``: channels per
    thread load (a power of two dividing ``c``, 16 bytes at most, every
    pointer aligned to it), threads across a row, rows per block and
    blocks along the rows."""
    vec = BN_VEC_BYTES // elem_bytes
    while vec > 1 and (c % vec or any(p % (vec * elem_bytes) for p in ptrs)):
        vec //= 2
    vectors = _ceil_div(c, vec)
    lanes = min(1 << (vectors - 1).bit_length(), BN_MAX_LANES)
    channel_tiles = _ceil_div(vectors, lanes)
    row_step = BN_THREADS // lanes
    chunks = max(1, _ceil_div(BN_TARGET_BLOCKS, channel_tiles))
    rows_per_chunk = max(BN_MIN_TILE_M, _ceil_div(m, chunks))
    rows_per_chunk = _ceil_div(rows_per_chunk, row_step) * row_step
    return vec, lanes, rows_per_chunk, _ceil_div(m, rows_per_chunk)


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
