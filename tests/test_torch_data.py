"""The port's data layer (``mpi_operator_tpu_torch/data``) against the JAX
package's: the Feistel order, ``TokenDataset`` rows and batches on one
token file (across an epoch boundary, across several epochs, split over
processes, the too-small-file error), the native assembler against the
Python path, and the ``Prefetcher``'s order, errors, overlap and early
close. Every comparison is exact: both sides are integer arithmetic on
the same file.
"""

import threading
import time

import numpy as np
import pytest

from mpi_operator_tpu.data import TokenDataset as JaxTokenDataset
from mpi_operator_tpu.data import feistel_permute as jax_feistel_permute
from mpi_operator_tpu_torch.data import (
    Prefetcher,
    TokenDataset,
    feistel_permute,
    write_token_file,
)
from mpi_operator_tpu_torch.data.loader import _load_native

pytestmark = pytest.mark.kernel


@pytest.fixture
def token_file(tmp_path):
    # 64 sequences of 16 tokens; sequence i is [i*16, i*16+16) so a row's
    # first token identifies its source sequence.
    path = tmp_path / "tokens.bin"
    write_token_file(path, np.arange(64 * 16, dtype=np.uint32))
    return path


@pytest.fixture
def native_lib():
    lib = _load_native()
    if lib is None:
        pytest.skip("native/libtpujob_tokenloader.so is not built")
    return lib


@pytest.mark.parametrize("n", [1, 2, 3, 5, 16, 64, 100, 1000, 1023, 4097])
@pytest.mark.parametrize("seed", [0, 7, 2**63 + 11])
def test_feistel_matches_jax_and_is_a_bijection(n, seed):
    got = [feistel_permute(n, seed, i) for i in range(min(n, 300))]
    want = [jax_feistel_permute(n, seed, i) for i in range(min(n, 300))]
    assert got == want
    if n <= 1023:
        assert sorted(feistel_permute(n, seed, i) for i in range(n)) == list(
            range(n))


def test_feistel_matches_native(native_lib):
    for n in (5, 64, 1000):
        for seed in (0, 99):
            for i in range(min(n, 64)):
                assert native_lib.tpujob_tl_permute(n, seed, i) == (
                    feistel_permute(n, seed, i)), (n, seed, i)


def _pair(path, seq_len=16, seed=0):
    return (TokenDataset(path, seq_len, seed=seed, use_native=False),
            JaxTokenDataset(path, seq_len, seed=seed, use_native=False))


@pytest.mark.parametrize("step,batch", [
    (0, 8), (3, 8),
    (7, 10),   # positions [70, 80): inside epoch 1
    (6, 10),   # positions [60, 70): epoch 0, then epoch 1
    (0, 160),  # 2.5 epochs in one batch
    (17, 12),  # positions [204, 216): epoch 3
])
def test_batches_equal_jax(token_file, step, batch):
    ours, theirs = _pair(token_file, seed=3)
    np.testing.assert_array_equal(ours.batch(step, batch),
                                  theirs.batch(step, batch))
    assert ours.batch(step, batch).dtype == np.uint32


def test_rows_and_process_split_equal_jax(token_file):
    ours, theirs = _pair(token_file, seed=5)
    for lo, hi in [(0, 12), (3, 5), (5, 12), (0, 0), (11, 12)]:
        np.testing.assert_array_equal(ours.rows(7, 12, lo, hi),
                                      theirs.rows(7, 12, lo, hi))
    full = ours.batch(7, 12)
    parts = [ours.batch(7, 12, process_index=i, process_count=4)
             for i in range(4)]
    np.testing.assert_array_equal(np.concatenate(parts), full)
    for i in range(4):
        np.testing.assert_array_equal(
            parts[i], theirs.batch(7, 12, process_index=i, process_count=4))
    with pytest.raises(ValueError, match="outside"):
        ours.rows(0, 8, 2, 9)
    with pytest.raises(ValueError, match="not divisible"):
        ours.batch(0, 8, process_count=3)


def test_every_epoch_covers_the_corpus_in_a_new_order(token_file):
    ds = TokenDataset(token_file, 16, use_native=False)
    big = ds.batch(0, 160)  # 2.5 epochs of the 64-sequence corpus
    ids = [int(r[0]) // 16 for r in big]
    assert sorted(ids[:64]) == sorted(ids[64:128]) == list(range(64))
    assert ids[:64] != ids[64:128]
    assert ids[128:] != ids[64:96]  # epoch 2 has its own order
    np.testing.assert_array_equal(big[5], np.arange(big[5][0],
                                                     big[5][0] + 16))


def test_native_and_python_paths_identical(token_file, native_lib):
    nat = TokenDataset(token_file, 16, seed=9)
    pyf = TokenDataset(token_file, 16, seed=9, use_native=False)
    assert nat.native and not pyf.native
    for step, b in ((0, 8), (5, 8), (6, 10), (0, 160)):
        np.testing.assert_array_equal(nat.batch(step, b), pyf.batch(step, b))
    nat.close()


def test_too_small_file_rejected_as_jax_does(tmp_path):
    path = tmp_path / "tiny.bin"
    write_token_file(path, np.arange(4, dtype=np.uint32))
    for cls in (TokenDataset, JaxTokenDataset):
        for native in (False, None):
            with pytest.raises(ValueError, match="smaller than one"):
                cls(path, 16, use_native=native)


def test_written_file_is_little_endian_uint32(tmp_path):
    path = tmp_path / "t.bin"
    write_token_file(path, [1, 2**32 - 1])
    assert path.read_bytes() == b"\x01\x00\x00\x00\xff\xff\xff\xff"


class TestPrefetcher:
    def test_yields_all_steps_in_order(self):
        seen = list(Prefetcher(lambda s: s * 10, 3, 9, depth=2))
        assert seen == [(s, s * 10) for s in range(3, 9)]

    def test_propagates_worker_errors(self):
        def boom(step):
            if step == 2:
                raise RuntimeError("assembly failed")
            return step

        it = iter(Prefetcher(boom, 0, 5, depth=1))
        assert next(it) == (0, 0)
        assert next(it) == (1, 1)
        with pytest.raises(RuntimeError, match="assembly failed"):
            list(it)

    def test_overlaps_assembly(self):
        calls = []

        def slow(step):
            calls.append(step)
            time.sleep(0.02)
            return step

        pf = Prefetcher(slow, 0, 4, depth=2)
        deadline = time.time() + 5
        while len(calls) < 2 and time.time() < deadline:
            time.sleep(0.01)  # the worker runs ahead with no consumer
        assert len(calls) >= 2
        assert [s for s, _ in pf] == [0, 1, 2, 3]

    def test_close_stops_a_thread_the_consumer_left(self):
        started = threading.Event()

        def fn(step):
            started.set()
            return step

        pf = Prefetcher(fn, 0, 10_000, depth=1)
        it = iter(pf)
        assert next(it) == (0, 0)
        assert started.wait(5)
        pf.close(timeout_s=5)
        assert not pf._thread.is_alive()
