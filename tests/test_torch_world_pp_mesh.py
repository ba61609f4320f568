"""The port's trainer on ``pp`` composed with the batch axes, on the CPU
over gloo, against the JAX trainer on the same mesh of CPU devices:
llama-tiny with 4 layers on ``dp=2,pp=2`` (each dp rank its share of
every microbatch, the stage's gradients averaged over dp) and
``pp=2,fsdp=2`` (FSDP2 on each stage's blocks over its fsdp group, the
embedding and head whole, as JAX's ZeRO-3 gather over its blocks), four
processes each. First and third global-batch losses on every rank at
rtol 1e-5.
"""

import pytest

from tests.test_torch_world import assert_matches_jax, compare_to_jax
from tests.test_torch_world_pp import LLAMA4

pytestmark = pytest.mark.kernel


@pytest.mark.parametrize("mesh", ["dp=2,pp=2", "pp=2,fsdp=2"])
def test_pp_batch_axes_match_the_jax_trainer(tmp_path, mesh):
    got = compare_to_jax(tmp_path, mesh, mesh, 4, models=LLAMA4)
    assert_matches_jax(*got["llama-tiny"], 4)
