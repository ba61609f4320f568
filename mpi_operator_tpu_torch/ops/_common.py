"""Shared helpers for the CUDA kernels in this package."""

from __future__ import annotations

import torch

# ----------------------------------------------------------------------
# Tile plumbing, in ONE place. Two kinds of flash body:
#
# - bf16 forward, dq and dk/dv run on the tensor cores (wgmma, cp.async
#   rings; csrc/flash_fwd.cuh, csrc/flash_bwd_dq.cuh and
#   csrc/flash_bwd_dkv.cuh hold their tiles): the forward and dq 128 q
#   rows a block (two warpgroups of 64) by 64-row k/v tiles, dk/dv 128 k
#   rows a block by 64-row q tiles. They are instantiated at head dims 64,
#   128 and 256 (at 256 dq holds 64 q rows a block and dk/dv 64 k rows,
#   its two warpgroups splitting dK from dV, to fit shared memory and
#   registers); another head dim runs on the next one up with its extra
#   columns zero-filled in shared memory (flash_tc_head_dim), after the
#   wrapper pads one that is not a multiple of 8 with zero columns to the
#   next multiple (flash_padded_head_dim: the bodies load rows in 16-byte
#   chunks).
# - f32 forward, dq and dk/dv keep the SIMT thread map below (256
#   threads; each thread owns 4 rows x 4 columns of a 64 x 64 score tile
#   and 4 rows x W/16 head-dim columns of the accumulators, W = 128 or
#   256): f32 FMA on f32 tiles in shared memory. ops/_build.py passes these
#   to nvcc as -D defines; the kernels' static_assert refuses any other
#   value.
#
# Past 256 (FLASH_SPLIT_WIDTH) both kinds split each head's columns across
# a thread-block cluster (flash_split_plan; csrc/flash_common.cuh): n
# blocks of 256 columns share one tile and sum their partial scores in
# distributed shared memory, up to FLASH_MAX_HEAD_DIM.
# ----------------------------------------------------------------------

DEFAULT_BLOCK_Q = 64   # SIMT flash q-tile (rows per block)
DEFAULT_BLOCK_K = 64   # SIMT flash k-tile (rows per inner step)
# Head dims of the bf16 tensor-core bodies; the last is the widest a block
# holds (csrc/flash_common.cuh SPLIT_W).
FLASH_TC_HEAD_DIMS = (64, 128, 256)
FLASH_SPLIT_WIDTH = FLASH_TC_HEAD_DIMS[-1]
# The widest head dim a flash launch takes (csrc/flash_common.cuh MAX_D):
# a cluster of FLASH_MAX_HEAD_DIM / FLASH_SPLIT_WIDTH = 4 blocks.
FLASH_MAX_HEAD_DIM = 1024


def flash_padded_head_dim(head_dim: int) -> int:
    """The head dim a bf16 flash launch hands the kernel: ``head_dim``
    rounded up to a multiple of 8 (the bodies load rows in 16-byte
    chunks), the columns past ``head_dim`` zeros that the wrapper adds to
    q, k, v and do and slices off out, dq, dk and dv."""
    return -(-head_dim // 8) * 8


def flash_split_plan(head_dim: int) -> tuple:
    """``(n, width)`` of a flash launch at ``head_dim``: ``n`` blocks of a
    thread-block cluster share one tile, block ``r`` holding the columns
    ``[r * width, (r + 1) * width)`` (those past ``head_dim`` zero-filled
    in shared memory and never stored) and running the ``width``-wide
    body. Up to FLASH_SPLIT_WIDTH ``n`` is 1 and ``width`` the bf16
    body's today (the smallest of FLASH_TC_HEAD_DIMS that covers it);
    past it ``n = ceil(head_dim / FLASH_SPLIT_WIDTH)`` and ``width`` is
    FLASH_SPLIT_WIDTH. The f32 bodies split at the same ``n``. Raises
    ValueError for a head dim below 1 or past FLASH_MAX_HEAD_DIM."""
    if not 1 <= head_dim <= FLASH_MAX_HEAD_DIM:
        raise ValueError(
            f"the flash kernels take head_dim between 1 and "
            f"{FLASH_MAX_HEAD_DIM}, got {head_dim}")
    if head_dim <= FLASH_SPLIT_WIDTH:
        return 1, next(w for w in FLASH_TC_HEAD_DIMS if head_dim <= w)
    return -(-head_dim // FLASH_SPLIT_WIDTH), FLASH_SPLIT_WIDTH


def flash_tc_head_dim(head_dim: int) -> int:
    """The head dim a block of a bf16 flash launch at ``head_dim`` runs at
    (flash_split_plan's width): the smallest of FLASH_TC_HEAD_DIMS that
    covers it, or past the widest, the widest, with the head split across
    a cluster. Raises ValueError for a head dim the kernels cannot take."""
    return flash_split_plan(head_dim)[1]

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
