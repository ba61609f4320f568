"""BERT on an ``sp`` mesh and an sp checkpoint moved to one process, on
the CPU over gloo.

- bert-tiny on ``sp=2`` against the JAX trainer's ``dp=-1,sp=2``, from
  the JAX init: the learned position table reads global positions, the
  [B, S] inputs shard on S, and the MLM loss divides by the global
  weight count. With ``--mlm-layout mask`` (the non-causal ring: no ids,
  every hop sees every column) the mask and targets shard on S too. With
  ``--mlm-layout positions`` (the ring and Ulysses) the [B, P] slots,
  targets and weights stay whole on every sp rank, as JAX replicates
  them over sp: each rank gathers the slots that fall in its columns and
  weighs the others 0 (``parallel/sharding.py:owned_slots``), so each
  slot counts once. One gang for the three arms; first and third
  global-batch losses at rtol 1e-5. The slot map itself: every slot of a
  random batch is owned by exactly one rank, for sp 2 and 4, contiguous
  and zigzag. (Positions on a token file and its checkpoint:
  ``tests/test_torch_world_sp_bert_data.py``.)
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

import types

import numpy as np
import pytest
import torch

from tests.test_torch_world import (BASE, MODELS, RTOL, assert_matches_jax,
                                    compare_to_jax, run_gang)

pytestmark = pytest.mark.kernel
ATOL = 1e-6

POSITIONS = ["--model", "bert-tiny", "--mlm-layout", "positions"]


@pytest.fixture(scope="module")
def sp2(tmp_path_factory):
    arms = {
        "mask": MODELS["bert-tiny"],
        "positions ring": POSITIONS,
        "positions ulysses": [*POSITIONS, "--sequence-parallel", "ulysses"],
    }
    return compare_to_jax(tmp_path_factory.mktemp("sp2"), "sp=2",
                          "dp=-1,sp=2", 2, models=arms)


@pytest.mark.parametrize("arm", ["positions ring", "positions ulysses"])
def test_bert_positions_on_sp2_match_the_jax_trainer(sp2, arm):
    want, lines = sp2[arm]
    assert_matches_jax(want, lines, 2)


def test_bert_mask_layout_on_the_sp2_ring(sp2):
    want, lines = sp2["mask"]
    assert_matches_jax(want, lines, 2)


@pytest.mark.parametrize("sp", [2, 4])
@pytest.mark.parametrize("zigzag", [False, True], ids=["contiguous", "zigzag"])
def test_every_slot_has_one_owner(sp, zigzag):
    from mpi_operator_tpu_torch.parallel.sharding import (local_positions,
                                                          owned_slots)

    seq, n_pred, rows = 32, 5, 6
    rng = np.random.RandomState(sp)
    slots = torch.tensor(np.sort(np.stack(
        [rng.permutation(seq)[:n_pred] for _ in range(rows)]), axis=1))
    owners = torch.zeros_like(slots)
    for rank in range(sp):
        mesh = types.SimpleNamespace(axis_size=lambda _: sp,
                                     coordinate=lambda _, r=rank: r)
        positions = torch.as_tensor(local_positions(seq, mesh, zigzag))
        col, owned = owned_slots(slots, positions)
        assert col.shape == owned.shape == slots.shape
        assert int(col.min()) >= 0 and int(col.max()) < seq // sp
        # An owned slot's local column holds its global position.
        assert torch.equal(positions[col][owned], slots[owned])
        owners += owned
    assert torch.all(owners == 1)


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
