"""The port's trainer on ``pp=2,tp=2``, on the CPU over gloo, against the
JAX trainer on the same mesh of CPU devices: llama-tiny with 4 layers
(the stage's blocks under the Megatron plan over its tp group) and
llama-moe-tiny (the experts' hidden dim over tp, the router loss through
the pipeline's aux), four processes, one gang. First and third
global-batch losses on every rank at rtol 1e-5.
"""

import pytest

from tests.test_torch_world import assert_matches_jax, compare_to_jax
from tests.test_torch_world_pp import LLAMA4

pytestmark = pytest.mark.kernel

ARMS = {**LLAMA4, "llama-moe-tiny": ["--model", "llama-moe-tiny"]}


@pytest.fixture(scope="module")
def pp2tp2(tmp_path_factory):
    return compare_to_jax(tmp_path_factory.mktemp("pp2tp2"), "pp=2,tp=2",
                          "pp=2,tp=2", 4, models=ARMS)


@pytest.mark.parametrize("model", sorted(ARMS))
def test_pp_tp_matches_the_jax_trainer(pp2tp2, model):
    assert_matches_jax(*pp2tp2[model], 4)
