"""The plain reference against the port at tiny sizes on the CPU, where
both sides compute in f32: the same batches, and the same losses,
gradients and parameter changes to round-off."""

import numpy as np
import pytest
import torch

from perfbench import run
from perfbench.reference import common
from perfbench.tests import tiny


@pytest.mark.parametrize("family", ["mixtral", "bert"])
def test_run_matches_reference(family):
    r = run.execute(tiny.cell(family), 2**31 + 977, 0.3, False,
                    torch.device("cpu"))
    assert r["correct"] is True
    for name, got in r["checked"].items():
        assert got["value"] < 1e-5, name
    assert r["attempted"] >= 1 and r["failed"] == 0
    assert list(r)[-2:] == ["checked", "_lines"]


def test_batches_are_the_trainers(tmp_path):
    from mpi_operator_tpu_torch.cmd import train
    from mpi_operator_tpu_torch.data import TokenDataset, write_token_file
    from mpi_operator_tpu_torch.parallel.mesh import create_mesh

    rng = np.random.RandomState(0)
    path = tmp_path / "c.u32"
    write_token_file(path, rng.randint(0, 1000, 37 * 16))
    ds = TokenDataset(path, 16, seed=5, use_native=False)
    for step in range(12):  # crosses epochs of 37 sequences
        want = ds.rows(step, 8, 0, 8).astype(np.int64) % 300
        got = common.batch_rows(path, 16, 8, step, 5, 300)
        np.testing.assert_array_equal(got, want)
    args = train.build_parser().parse_args(
        ["--model", "bert-tiny", "--mlm-layout", "positions", "--seq-len",
         "16", "--global-batch", "8", "--data", str(path), "--seed", "5",
         "--device", "cpu"])
    fn = train._token_batch_fn(args, 128, 8, create_mesh(device="cpu"))
    for step in range(3):
        want = [t.numpy() for t in fn(step)]
        rows = common.batch_rows(path, 16, 8, step, 5, 128)
        got = common.mlm_batch(rows, 5, step)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
