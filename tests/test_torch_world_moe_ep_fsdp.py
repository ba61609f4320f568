"""The MoE Llama on ``--mesh ep=2,fsdp=2``, four processes on the CPU over
gloo, against the JAX trainer on the 8-device CPU mesh with
``dp=-1,ep=2,fsdp=2``: llama-moe-tiny (4 experts, top-2); FSDP2 splits
the experts' dim 0, already split over ep, again over fsdp (a strided
shard, where JAX's ``P(ep, fsdp, tp)`` splits the model dim over fsdp),
from the JAX init, the first and third global-batch loss at rtol 1e-5.
The spawn helper is ``tests/test_torch_world.py``'s.
"""

import pytest

from tests.test_torch_world import assert_matches_jax, compare_to_jax
from tests.test_torch_world_ep import MOE

pytestmark = pytest.mark.kernel


def test_moe_matches_the_jax_trainer(tmp_path):
    want, lines = compare_to_jax(tmp_path, "ep=2,fsdp=2", "dp=-1,ep=2,fsdp=2", 4,
                                 models=MOE)["llama-moe-tiny"]
    assert_matches_jax(want, lines, 4)
