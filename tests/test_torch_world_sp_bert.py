"""BERT on an ``sp`` mesh and an sp checkpoint moved to one process, on
the CPU over gloo.

- bert-tiny with ``--mlm-layout mask`` on the ``sp=2`` ring (the
  non-causal ring: no ids, every hop sees every column) against the JAX
  trainer's ``dp=-1,sp=2``: the learned position table reads global
  positions, the [B, S] inputs, mask and targets shard on S, and the MLM
  loss divides by the global weight count. First and third global-batch
  losses at rtol 1e-5.
- llama-tiny on a token file (``--data``: each rank slices its columns
  of its rows of the stream, as of the synthetic batch), saved on
  ``sp=2`` with the zigzag ring at step 2 and resumed on one process to
  step 3, against the straight one-process run to 3: the loss at rtol
  1e-5 (the resume tests' tolerance), and every parameter at rtol 1e-5,
  atol 1e-6 plus twice the difference between the straight runs on
  ``sp=2`` and on one process (those two differ only in the order of
  the gradient's sums, which AdamW's normalised update can magnify where
  a gradient is near 0; the resume may add nothing beyond it).
"""

import numpy as np
import pytest

from tests.test_torch_world import (BASE, MODELS, RTOL, assert_matches_jax,
                                    compare_to_jax, run_gang)

pytestmark = pytest.mark.kernel
ATOL = 1e-6


def test_bert_mask_layout_on_the_sp2_ring(tmp_path):
    models = {"bert-tiny": MODELS["bert-tiny"]}
    want, lines = compare_to_jax(tmp_path, "sp=2", "dp=-1,sp=2", 2,
                                 models=models)["bert-tiny"]
    assert_matches_jax(want, lines, 2)


def _params(directory) -> dict:
    from mpi_operator_tpu_torch.utils.checkpoint import CheckpointManager

    step, state = CheckpointManager(str(directory)).read_latest()
    assert step == 3
    return state["params"]


def test_sp2_checkpoint_resumes_on_one_process(tmp_path):
    from mpi_operator_tpu_torch.data import write_token_file

    corpus = tmp_path / "corpus.u32"
    write_token_file(corpus, np.random.RandomState(1).randint(0, 256, 40 * 16))
    argv = ["--device", "cpu", *MODELS["llama-tiny"], *BASE,
            "--save-every", "2", "--data", str(corpus)]
    sp2 = ["--mesh", "sp=2", "--zigzag-ring"]

    def run(steps, directory, *extra):
        return {"argv": [*argv, "--steps", str(steps), "--checkpoint-dir",
                         str(tmp_path / directory), *extra]}

    saved, _ = run_gang(2, [run(2, "moved", *sp2), run(3, "sp", *sp2)])[0]
    assert saved["line"]["final_step"] == 2
    resumed, straight = run_gang(1, [run(3, "moved"), run(3, "one")])[0]
    assert (resumed["line"]["final_step"], resumed["line"]["steps"]) == (3, 1)
    np.testing.assert_allclose(resumed["line"]["loss"],
                               straight["line"]["loss"], rtol=RTOL)
    got, want, spread = (_params(tmp_path / d) for d in ("moved", "one", "sp"))
    assert got.keys() == want.keys() == spread.keys()
    for name, value in want.items():
        excess = ((got[name] - value).abs() - RTOL * value.abs() - ATOL
                  - 2 * (spread[name] - value).abs())
        assert float(excess.max()) <= 0, name
