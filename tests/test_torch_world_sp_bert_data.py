"""BERT ``--mlm-layout positions`` on ``--mesh sp=2`` from a token file
(``--data``) in two microbatches (``--grad-accum 2``), and its
checkpoint moved to one process, on the CPU over gloo.

Each sp rank draws its rows of the stream and their masking (from
``RandomState(seed + step)`` for the global batch), keeps its columns of
the [B, S] inputs and the whole [B, P] slots, targets and weights
(``cmd/train.py:_bert_columns``), and splits them into the microbatches
on rows. From the JAX init:

- the ring on ``sp=2`` against the JAX trainer on ``dp=-1,sp=2`` with
  the same ``--data`` and ``--grad-accum``: the first and third
  global-batch losses on every rank at rtol 1e-5 (each step reads
  another batch of the stream, so the loss need not fall);
- the same run saved at step 2 and resumed on one process to step 3:
  its loss at rtol 1e-5 against the JAX trainer's third and the straight
  one-process run's, and every parameter at rtol 1e-5, atol 1e-6 plus
  twice the difference between the straight runs on ``sp=2`` and on one
  process, as ``tests/test_torch_world_sp_bert.py`` holds llama-tiny's.
  The key projections' biases are held apart: softmax is blind to a
  shift of every key by the same ``q . b``, so their exact gradient is 0
  and AdamW's normalised update moves them on rounding noise alone, by
  up to about lr a step; they may differ by at most 2 lr a step run.
"""

import numpy as np
import pytest
import torch

from tests.test_torch_world import BASE, RTOL, jax_reference, run_gang

pytestmark = pytest.mark.kernel
ATOL = 1e-6
LR = float(BASE[BASE.index("--lr") + 1])
STEPS = int(BASE[BASE.index("--steps") + 1])
KEY_BIAS = ".wk.bias"

POSITIONS = ["--model", "bert-tiny", "--mlm-layout", "positions"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(JAX losses, the sp=2 ranks' records, the one-process records):
    the straight sp=2 run to step 3 (saving every 2 steps) and the run
    saved at 2 in one gang; then, on one process, the resume to 3 and the
    straight run to 3."""
    from mpi_operator_tpu_torch.data import write_token_file

    tmp = tmp_path_factory.mktemp("sp2data")
    corpus = tmp / "corpus.u32"
    write_token_file(corpus, np.random.RandomState(1).randint(0, 256, 40 * 16))
    argv = [*POSITIONS, *BASE, "--data", str(corpus), "--grad-accum", "2"]
    want, init = jax_reference(argv, "dp=-1,sp=2")
    weights = str(tmp / "init.pt")
    torch.save(init, weights)

    def run(steps, directory, *extra):
        return {"argv": ["--device", "cpu", *argv, "--steps", str(steps),
                         "--save-every", "2", "--checkpoint-dir",
                         str(tmp / directory), *extra], "weights": weights}

    sp2 = ["--mesh", "sp=2"]
    ranks = run_gang(2, [run(STEPS, "sp", *sp2), run(2, "moved", *sp2)])
    one = run_gang(1, [run(STEPS, "moved"), run(STEPS, "one")])[0]
    return want, ranks, one, tmp


def _params(directory) -> dict:
    from mpi_operator_tpu_torch.utils.checkpoint import CheckpointManager

    step, state = CheckpointManager(str(directory)).read_latest()
    assert step == STEPS
    return state["params"]


def test_positions_on_a_token_file_match_the_jax_trainer(runs):
    want, ranks, _, _ = runs
    lines = [r[0]["line"] for r in ranks]
    for line in lines:
        assert line["devices"] == 2 and line["final_step"] == STEPS
        np.testing.assert_allclose(line["first_loss"], want[0], rtol=RTOL)
        np.testing.assert_allclose(line["loss"], want[-1], rtol=RTOL)
    assert len({line["loss"] for line in lines}) == 1


def test_positions_sp2_checkpoint_resumes_on_one_process(runs):
    want, ranks, (resumed, straight), tmp = runs
    assert ranks[0][1]["line"]["final_step"] == 2
    assert (resumed["line"]["final_step"], resumed["line"]["steps"]) == (
        STEPS, 1)
    for loss in (want[-1], straight["line"]["loss"]):
        np.testing.assert_allclose(resumed["line"]["loss"], loss, rtol=RTOL)
    got, one, spread = (_params(tmp / d) for d in ("moved", "one", "sp"))
    assert got.keys() == one.keys() == spread.keys()
    assert sum(name.endswith(KEY_BIAS) for name in one) == 2  # 2 layers
    for name, value in one.items():
        if name.endswith(KEY_BIAS):
            assert float((got[name] - value).abs().max()) <= 2 * LR * STEPS
            continue
        excess = ((got[name] - value).abs() - RTOL * value.abs() - ATOL
                  - 2 * (spread[name] - value).abs())
        assert float(excess.max()) <= 0, name
