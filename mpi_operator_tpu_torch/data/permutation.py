"""Stateless shuffled epoch order: a Feistel permutation over [0, N)
(the port's copy of ``mpi_operator_tpu/data/permutation.py``).

Position -> sequence id is a pure O(1) function of (N, seed, position),
so every worker computes exactly its slice of any step and resume
carries one integer.

Wire contract: the constants and round structure are IDENTICAL to
``native/tokenloader.cpp`` (the C++ fast path) and to the JAX package's
copy; ``tests/test_torch_data.py`` holds all three together.
"""

from __future__ import annotations

_MASK64 = (1 << 64) - 1
_GOLDEN = 0x9E3779B97F4A7C15


def _mix64(z: int) -> int:
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return z ^ (z >> 31)


class Feistel:
    """4-round balanced Feistel over 2·b bits, cycle-walked down to
    [0, n) — a bijection for every (n, seed)."""

    def __init__(self, n: int, seed: int):
        self.n = n
        bl = max(n - 1, 1).bit_length()
        self.half_bits = max((bl + 1) // 2, 1)
        self.mask = (1 << self.half_bits) - 1
        self.keys = [
            _mix64((seed + _GOLDEN * (r + 1)) & _MASK64) for r in range(4)
        ]

    def _encrypt_once(self, v: int) -> int:
        left, right = v >> self.half_bits, v & self.mask
        for key in self.keys:
            left, right = right, left ^ (_mix64(right ^ key) & self.mask)
        return (left << self.half_bits) | right

    def permute(self, i: int) -> int:
        if self.n <= 1:
            return 0
        v = self._encrypt_once(i)
        while v >= self.n:  # cycle-walk: still a bijection on [0, n)
            v = self._encrypt_once(v)
        return v


def feistel_permute(n: int, seed: int, i: int) -> int:
    """Shuffled position ``i`` of an ``n``-element epoch with ``seed``."""
    return Feistel(n, seed).permute(i)
