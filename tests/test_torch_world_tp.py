"""The port's trainer on two processes with ``--mesh tp=2`` (Megatron
tensor parallelism on DTensor: column-parallel q/k/v and the MLP's input
projections, row-parallel outputs; attention on the local heads) on the
CPU over gloo, against the JAX trainer on the 8-device CPU mesh with
``dp=-1,tp=2`` (dp=4) at the same global batch: llama-tiny (4 q heads
and 2 kv heads: one kv head a rank) and bert-tiny (2 heads: one a rank)
from the JAX init, the first and third step's global loss at rtol 1e-5
(f32 both sides, only the order of the sums differs). Then the flash
kernels' plain versions see the local head counts. The spawn helper is
``tests/test_torch_world.py``'s.
"""

import pytest

from tests.test_torch_world import MODELS, assert_matches_jax, compare_to_jax

pytestmark = pytest.mark.kernel


@pytest.fixture(scope="module")
def tp2(tmp_path_factory):
    return compare_to_jax(tmp_path_factory.mktemp("tp2"), "tp=2",
                          "dp=-1,tp=2", 2)


@pytest.mark.parametrize("model", sorted(MODELS))
def test_tp2_matches_the_jax_trainer(tp2, model):
    want, lines = tp2[model]
    assert_matches_jax(want, lines, 2)
