"""The port's trainer on four processes with ``--mesh dp=2,fsdp=2`` (HSDP:
FSDP2 over fsdp, replicas over dp) on the CPU over gloo, against the JAX
trainer on the 8-device CPU mesh with ``dp=-1,fsdp=2`` (dp=4) at the same
global batch: llama-tiny and bert-tiny from the JAX init, the first and
third step's global loss at rtol 1e-5 (f32 both sides, only the order of
the sums differs). The spawn helper is ``tests/test_torch_world.py``'s.
"""

import pytest

from tests.test_torch_world import MODELS, assert_matches_jax, compare_to_jax

pytestmark = pytest.mark.kernel


@pytest.fixture(scope="module")
def hsdp(tmp_path_factory):
    return compare_to_jax(tmp_path_factory.mktemp("hsdp"), "dp=2,fsdp=2",
                          "dp=-1,fsdp=2", 4)


@pytest.mark.parametrize("model", sorted(MODELS))
def test_dp2_fsdp2_matches_the_jax_trainer(hsdp, model):
    want, lines = hsdp[model]
    assert_matches_jax(want, lines, 4)
