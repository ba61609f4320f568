"""The port's trainer on an ``sp`` mesh, on the CPU over gloo, against
the JAX trainer on the 8-device CPU mesh at the same ``--global-batch``:
llama-tiny on ``sp=2`` (two processes) with the ring, the zigzag ring
and Ulysses, each against JAX's ``dp=-1,sp=2`` with the same flags.

Both sides start from the JAX init (``interop``); each process draws the
global batch, keeps its rows and its positions of the sequence (the
zigzag chunk pair with ``--zigzag-ring``), and builds its next-token
targets on the whole sequence. The summary's first and third
global-batch losses on every rank at rtol 1e-5 (f32 both sides, only the
order of the sums differs). ``test_torch_world_sp_mesh.py`` composes sp
with dp and fsdp; ``test_torch_world_sp_bert.py`` holds BERT on sp and a
checkpoint moved from sp to one process.
"""

import pytest

from tests.test_torch_world import MODELS, assert_matches_jax, compare_to_jax

pytestmark = pytest.mark.kernel

# One gang runs the three arms in turn, one job each.
ARMS = {
    "ring": MODELS["llama-tiny"],
    "zigzag": [*MODELS["llama-tiny"], "--zigzag-ring"],
    "ulysses": [*MODELS["llama-tiny"], "--sequence-parallel", "ulysses"],
}


@pytest.fixture(scope="module")
def sp2(tmp_path_factory):
    return compare_to_jax(tmp_path_factory.mktemp("sp2"), "sp=2",
                          "dp=-1,sp=2", 2, models=ARMS)


@pytest.mark.parametrize("arm", sorted(ARMS))
def test_sp2_matches_the_jax_trainer(sp2, arm):
    assert_matches_jax(*sp2[arm], 2)
