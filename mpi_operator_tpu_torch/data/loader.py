"""Token dataset + batch prefetcher (the port's copy of
``mpi_operator_tpu/data/loader.py``).

``TokenDataset`` reads fixed-length sequences out of a flat binary file
of little-endian uint32 tokens (the standard pre-tokenized corpus
layout). Shuffling is the stateless Feistel permutation
(``data/permutation.py``): ``batch(step)`` is a pure function of
(file, seq_len, seed, step), so resuming a preempted job at step k
reproduces the identical data order, and the port's batches equal the
JAX package's row for row.

The hot path (permute + mmap'd copy) runs in native C++
(``native/tokenloader.cpp`` via ctypes) when the shared library is
built; the pure-Python fallback is wire-identical, just slower.

``Prefetcher`` overlaps host batch assembly with device compute: a
background thread runs ``fn(step)`` ``depth`` steps ahead. It hands over
whatever ``fn`` returns; the trainer's ``fn`` returns host tensors
(pinned when the run is on the card) and the consuming thread starts the
host-to-device copy on its own stream, so a batch can never be read
before its copy lands.
"""

from __future__ import annotations

import ctypes
import os
import pathlib
import queue
import threading
from typing import Callable, Iterator, Optional

import numpy as np

from ..utils import torchtrace
from ..utils.logging import get_logger
from .permutation import Feistel

log = get_logger("data.loader")

ENV_NATIVE_LIB = "TPUJOB_TOKENLOADER_LIB"
_REPO_NATIVE = pathlib.Path(__file__).resolve().parents[2] / "native"


def _load_native() -> Optional[ctypes.CDLL]:
    candidates = []
    if os.environ.get(ENV_NATIVE_LIB):
        candidates.append(os.environ[ENV_NATIVE_LIB])
    candidates.append(str(_REPO_NATIVE / "libtpujob_tokenloader.so"))
    for path in candidates:
        if not os.path.exists(path):
            continue
        try:
            lib = ctypes.CDLL(path)
        except OSError:
            continue
        lib.tpujob_tl_open.argtypes = [ctypes.c_char_p, ctypes.c_longlong]
        lib.tpujob_tl_open.restype = ctypes.c_void_p
        lib.tpujob_tl_num_sequences.argtypes = [ctypes.c_void_p]
        lib.tpujob_tl_num_sequences.restype = ctypes.c_longlong
        lib.tpujob_tl_fill.argtypes = [
            ctypes.c_void_p, ctypes.c_ulonglong, ctypes.c_longlong,
            ctypes.c_longlong, ctypes.POINTER(ctypes.c_uint32),
        ]
        lib.tpujob_tl_fill.restype = ctypes.c_int
        lib.tpujob_tl_close.argtypes = [ctypes.c_void_p]
        lib.tpujob_tl_close.restype = None
        lib.tpujob_tl_permute.argtypes = [ctypes.c_ulonglong] * 3
        lib.tpujob_tl_permute.restype = ctypes.c_ulonglong
        return lib
    return None


def write_token_file(path, tokens) -> None:
    """Write a flat little-endian uint32 token file (tests/tools)."""
    np.asarray(tokens, dtype="<u4").tofile(str(path))


class TokenDataset:
    """Fixed-length sequences from a binary uint32 token file with
    stateless shuffled epochs."""

    def __init__(self, path, seq_len: int, *, seed: int = 0,
                 use_native: Optional[bool] = None):
        self.path = str(path)
        self.seq_len = int(seq_len)
        self.seed = int(seed)
        self._lib = _load_native() if use_native in (None, True) else None
        if use_native is True and self._lib is None:
            raise RuntimeError("native tokenloader requested but not built")
        self._handle = None
        if self._lib is not None:
            self._handle = self._lib.tpujob_tl_open(
                self.path.encode(), self.seq_len
            )
            if not self._handle:
                raise ValueError(
                    f"{self.path}: not readable or smaller than one "
                    f"sequence of {seq_len} tokens"
                )
            self.num_sequences = int(
                self._lib.tpujob_tl_num_sequences(self._handle)
            )
            self._mm = None
        else:
            size = os.path.getsize(self.path)
            self.num_sequences = size // (4 * self.seq_len)
            if self.num_sequences < 1:
                raise ValueError(
                    f"{self.path}: not readable or smaller than one "
                    f"sequence of {seq_len} tokens"
                )
            self._mm = np.memmap(self.path, dtype="<u4", mode="r",
                                 shape=(self.num_sequences, self.seq_len))

    @property
    def native(self) -> bool:
        return self._handle is not None

    def close(self) -> None:
        if self._handle is not None:
            self._lib.tpujob_tl_close(self._handle)
            self._handle = None
        self._mm = None

    # -- batch assembly ---------------------------------------------------

    def _epoch_seed(self, epoch: int) -> int:
        return (self.seed + epoch) & (2**64 - 1)

    def fill(self, epoch: int, start: int, count: int) -> np.ndarray:
        """``count`` sequences at shuffled-epoch positions
        [start, start+count) (wrapping) of epoch ``epoch``."""
        seed = self._epoch_seed(epoch)
        if self._handle is not None:
            out = np.empty((count, self.seq_len), dtype=np.uint32)
            rc = self._lib.tpujob_tl_fill(
                self._handle, seed, start, count,
                out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
            )
            if rc != 0:
                raise RuntimeError(f"tpujob_tl_fill failed rc={rc}")
            return out
        f = Feistel(self.num_sequences, seed)
        rows = [
            self._mm[f.permute((start + j) % self.num_sequences)]
            for j in range(count)
        ]
        return np.stack(rows).astype(np.uint32)

    def rows(self, step: int, global_batch: int, lo: int,
             hi: int) -> np.ndarray:
        """Global rows [lo, hi) of batch ``step``."""
        if not 0 <= lo <= hi <= global_batch:
            raise ValueError(
                f"rows [{lo}, {hi}) outside global batch {global_batch}"
            )
        if hi == lo:
            return np.empty((0, self.seq_len), dtype=np.uint32)
        gstart = step * global_batch + lo
        epoch, start = divmod(gstart, self.num_sequences)
        # A batch can straddle epoch boundaries (several, if the corpus is
        # smaller than the slice): walk them so every part uses its own
        # epoch's permutation seed.
        parts = []
        remaining = hi - lo
        while remaining > 0:
            take = min(remaining, self.num_sequences - start)
            parts.append(self.fill(epoch, start, take))
            remaining -= take
            epoch, start = epoch + 1, 0
        return np.concatenate(parts) if len(parts) > 1 else parts[0]

    def batch(self, step: int, global_batch: int,
              *, process_index: int = 0, process_count: int = 1) -> np.ndarray:
        """This process's rows of global batch ``step``: step s covers
        shuffled positions [s·B, (s+1)·B) of epoch (s·B) // N with the
        epoch's own seed, so the union over processes is the global batch
        and resume at any step reproduces the stream exactly."""
        if global_batch % process_count:
            raise ValueError(
                f"global batch {global_batch} not divisible by "
                f"{process_count} processes"
            )
        per_proc = global_batch // process_count
        return self.rows(
            step, global_batch,
            process_index * per_proc, (process_index + 1) * per_proc,
        )


class Prefetcher:
    """Background-thread batch prefetch with bounded depth.

    ``fn(step)`` assembles one batch; the prefetcher keeps ``depth`` of
    them ready so host assembly overlaps device compute. Iterate it for
    steps [start, end); an error in ``fn`` is raised on the consuming
    side. ``close()`` stops the thread when the consumer leaves early
    (a preempted run). Each wait for a batch is the step's ``data.wait``
    range (``utils/torchtrace.py``)."""

    def __init__(self, fn: Callable[[int], object], start: int, end: int,
                 *, depth: int = 2):
        self._fn = fn
        self._q: queue.Queue = queue.Queue(maxsize=max(depth, 1))
        self._err: Optional[BaseException] = None
        self._stop = threading.Event()
        self._steps = range(start, end)
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="prefetch")
        self._thread.start()

    def _run(self) -> None:
        try:
            for step in self._steps:
                if self._stop.is_set():
                    return
                self._q.put((step, self._fn(step)))
        except BaseException as exc:  # surfaced on the consuming side
            self._err = exc
        finally:
            self._q.put(None)

    def __iter__(self) -> Iterator:
        while True:
            with torchtrace.timed_range("data.wait"):
                item = self._q.get()
            if item is None:
                if self._err is not None:
                    raise self._err
                return
            yield item

    def close(self, timeout_s: float = 10.0) -> None:
        """Stop the thread: drop the batches it made and let it see the
        stop flag."""
        self._stop.set()
        for _ in range(max(int(timeout_s / 0.05), 1)):
            try:
                while True:
                    self._q.get_nowait()
            except queue.Empty:
                pass
            self._thread.join(0.05)
            if not self._thread.is_alive():
                return
        log.warning("prefetch thread still running after %.1fs", timeout_s)
