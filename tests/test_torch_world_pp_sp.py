"""The port's trainer on ``pp=2,sp=2``, on the CPU over gloo, against the
JAX trainer on the same mesh of CPU devices: llama-tiny with 4 layers,
each stage's attention the ring, the zigzag ring or Ulysses over its sp
group with global RoPE positions (JAX's ``ring-shard`` and
``ulysses-shard`` in its pipeline), four processes, one gang. First and
third global-batch losses on every rank at rtol 1e-5.
"""

import pytest

from tests.test_torch_world import assert_matches_jax, compare_to_jax
from tests.test_torch_world_pp import LLAMA4

pytestmark = pytest.mark.kernel

ARMS = {
    "ring": LLAMA4["llama-tiny"],
    "zigzag": [*LLAMA4["llama-tiny"], "--zigzag-ring"],
    "ulysses": [*LLAMA4["llama-tiny"], "--sequence-parallel", "ulysses"],
}


@pytest.fixture(scope="module")
def pp2sp2(tmp_path_factory):
    return compare_to_jax(tmp_path_factory.mktemp("pp2sp2"), "pp=2,sp=2",
                          "pp=2,sp=2", 4, models=ARMS)


@pytest.mark.parametrize("arm", sorted(ARMS))
def test_pp_sp_matches_the_jax_trainer(pp2sp2, arm):
    assert_matches_jax(*pp2sp2[arm], 4)
