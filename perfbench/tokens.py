"""The general traffic generator: a token corpus drawn from the seed, as
the uint32 file that the trainer's ``--data`` reads (``traffic/*.json``
give its size and distribution; the configuration gives the vocabulary).
The same seed writes the same file."""

from __future__ import annotations

import numpy as np

DISTRIBUTIONS = ("uniform",)


def corpus(traffic: dict, vocab: int, seed: int) -> np.ndarray:
    """``corpus_sequences`` x ``seq_len`` token ids below ``vocab``."""
    kind = traffic.get("tokens", "uniform")
    if kind not in DISTRIBUTIONS:
        raise ValueError(f"token distribution {kind!r}; want one of "
                         f"{DISTRIBUTIONS}")
    n = int(traffic["corpus_sequences"]) * int(traffic["seq_len"])
    rng = np.random.Generator(np.random.PCG64(seed))
    return rng.integers(0, vocab, n, dtype=np.uint32)


def write(path, traffic: dict, vocab: int, seed: int) -> int:
    """Write the corpus to ``path`` (little-endian uint32); its bytes."""
    tokens = corpus(traffic, vocab, seed).astype("<u4")
    tokens.tofile(str(path))
    return tokens.nbytes
