"""The port's trainer with llama-moe-tiny on ``pp=2,ep=2``, on the CPU
over gloo, against the JAX trainer on the same mesh of CPU devices: each
stage's experts split over its ep group, the router loss summed over the
pipeline's real (stage, microbatch) pairs and divided by the microbatch
count (and by dp, through the average). First and third global-batch
losses on every rank at rtol 1e-5.
"""

import pytest

from tests.test_torch_world import assert_matches_jax, compare_to_jax
from tests.test_torch_world_pp_tp import ARMS

pytestmark = pytest.mark.kernel


def test_pp_ep_matches_the_jax_trainer(tmp_path):
    models = {"llama-moe-tiny": ARMS["llama-moe-tiny"]}
    got = compare_to_jax(tmp_path, "pp=2,ep=2", "pp=2,ep=2", 4,
                         models=models)
    assert_matches_jax(*got["llama-moe-tiny"], 4)
