"""The port's trainer with expert parallelism on the CPU over gloo, against
the JAX trainer on the 8-device CPU mesh with ``dp=-1,ep=2`` (dp=4) at
the same global batch: ``llama-moe-tiny`` (4 experts, top-2) on two
processes with ``--mesh ep=2`` (each rank sees the whole batch and holds
2 experts) and on four with ``dp=2,ep=2``, from the JAX init, the first
and third step's global loss at rtol 1e-5 (f32 both sides; only the
order of the sums differs). Then an ``ep=2`` checkpoint (each rank wrote
its experts) is read whole on one process: resumed by the trainer and
evaluated by ``cmd.eval``. The spawn helper is
``tests/test_torch_world.py``'s.
"""

import contextlib
import io
import json

import numpy as np
import pytest
import torch

from tests.test_torch_world import (
    BASE,
    assert_matches_jax,
    compare_to_jax,
    run_gang,
)

pytestmark = pytest.mark.kernel

MOE = {"llama-moe-tiny": ["--model", "llama-moe-tiny"]}


@pytest.mark.parametrize("mesh,n", [("ep=2", 2), ("dp=2,ep=2", 4)])
def test_expert_parallel_matches_the_jax_trainer(tmp_path, mesh, n):
    want, lines = compare_to_jax(tmp_path, mesh, "dp=-1,ep=2", n,
                                 models=MOE)["llama-moe-tiny"]
    assert_matches_jax(want, lines, n)


def test_ep_checkpoint_restores_on_one_process(tmp_path):
    """Two ranks train 2 steps with ``--mesh ep=2`` and save (experts
    sharded over ep); one process resumes to step 3 from it and matches
    a straight one-process run to 3 (rtol 1e-5); the expert weights read
    back whole, and ``cmd.eval`` takes the checkpoint."""
    from mpi_operator_tpu_torch.cmd import eval as teval
    from mpi_operator_tpu_torch.cmd import train
    from mpi_operator_tpu_torch.data import write_token_file
    from mpi_operator_tpu_torch.utils.checkpoint import CheckpointManager

    argv = ["--model", "llama-moe-tiny", *BASE]
    ck = str(tmp_path / "ck")
    save = ["--device", "cpu", *argv, "--steps", "2", "--save-every", "2",
            "--checkpoint-dir", ck]
    ranks = run_gang(2, [{"argv": ["--mesh", "ep=2", *save]}])
    assert [r[0]["line"]["final_step"] for r in ranks] == [2, 2]

    step, state = CheckpointManager(ck).read_latest()
    assert step == 2
    wg = state["params"]["layer_0.moe.expert_wg"]
    assert wg.shape == (4, 64, 128)
    # Each rank wrote its two experts: they differ (different gradients).
    assert not torch.equal(wg[:2], wg[2:])

    lines = []
    for extra in (["--checkpoint-dir", ck], []):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert train.main(["--device", "cpu", *argv, *extra]) == 0
        lines.append(json.loads(buf.getvalue().strip().splitlines()[-1]))
    resumed, straight = lines
    assert (resumed["final_step"], resumed["steps"]) == (3, 1)
    np.testing.assert_allclose(resumed["loss"], straight["loss"], rtol=1e-5)

    corpus = tmp_path / "corpus.u32"
    write_token_file(corpus, np.random.RandomState(0).randint(0, 256, 4096))
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert teval.main(["--device", "cpu", "--checkpoint-dir", ck,
                           "--model", "llama-moe-tiny", "--data",
                           str(corpus), "--batch", "4", "--batches", "2",
                           "--seq-len", "16"]) == 0
    line = json.loads(buf.getvalue().strip().splitlines()[-1])
    assert line["step"] == 3 and np.isfinite(line["loss"])

