"""The MoE Llama on ``--mesh tp=2``, two processes on the CPU over gloo,
against the JAX trainer on the 8-device CPU mesh with ``dp=-1,tp=2``:
llama-moe-tiny (4 experts, top-2; attention on the local heads, each
rank half of every expert's hidden dim, its partial outputs summed with
its peer's), from the JAX init, the first and third global-batch loss at
rtol 1e-5 (f32 both sides; only the order of the sums differs). The
spawn helper is ``tests/test_torch_world.py``'s.
"""

import pytest

from tests.test_torch_world import assert_matches_jax, compare_to_jax
from tests.test_torch_world_ep import MOE

pytestmark = pytest.mark.kernel


def test_moe_matches_the_jax_trainer(tmp_path):
    want, lines = compare_to_jax(tmp_path, "tp=2", "dp=-1,tp=2", 2,
                                 models=MOE)["llama-moe-tiny"]
    assert_matches_jax(want, lines, 2)
