"""Tensor x sequence parallelism, on four processes on the CPU over gloo,
against the JAX trainer on the 8-device CPU mesh with ``dp=-1,sp=2,tp=2``
(dp=2) at the same global batch: llama-tiny on ``--mesh sp=2,tp=2``
with the ring, the zigzag ring and Ulysses (bert-tiny:
``tests/test_torch_world_sp_tp_bert.py``). Each tp rank's attention runs
on its local heads (2 q heads and 1 kv head of 4 and 2), the ring's hops
and Ulysses' all-to-alls over the sp group of the ranks that share its
tp coordinate (Ulysses repeats the one local kv head to 2 so that sp
divides it), as JAX's ``bshd_sp_specs`` put the heads on tp under the
ring. From the JAX init, the first and third global-batch loss on every
rank at rtol 1e-5, one gang for the three arms. The spawn helper is
``tests/test_torch_world.py``'s.
"""

import pytest

from tests.test_torch_world import assert_matches_jax, compare_to_jax
from tests.test_torch_world_sp import ARMS

pytestmark = pytest.mark.kernel

TP_ARMS = {f"llama-tiny {arm}": flags for arm, flags in ARMS.items()}


@pytest.fixture(scope="module")
def sp2tp2(tmp_path_factory):
    return compare_to_jax(tmp_path_factory.mktemp("sp2tp2"), "sp=2,tp=2",
                          "dp=-1,sp=2,tp=2", 4, models=TP_ARMS)


@pytest.mark.parametrize("arm", sorted(TP_ARMS))
def test_sp2_tp2_matches_the_jax_trainer(sp2tp2, arm):
    assert_matches_jax(*sp2tp2[arm], 4)
