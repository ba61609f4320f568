"""BERT on tensor x sequence parallelism, on four processes on the CPU over
gloo: bert-tiny (``mask`` layout) on ``--mesh sp=2,tp=2`` with the ring
(the non-causal ring on one of the 2 heads a rank), against the JAX
trainer on the 8-device CPU mesh with ``dp=-1,sp=2,tp=2``, from the JAX
init: the first and third global-batch loss on every rank at rtol 1e-5.
The spawn helper is ``tests/test_torch_world.py``'s.
"""

import pytest

from tests.test_torch_world import MODELS, assert_matches_jax, compare_to_jax

pytestmark = pytest.mark.kernel


def test_bert_on_sp2_tp2_matches_the_jax_trainer(tmp_path):
    models = {"bert-tiny": MODELS["bert-tiny"]}
    want, lines = compare_to_jax(tmp_path, "sp=2,tp=2", "dp=-1,sp=2,tp=2", 4,
                                 models=models)["bert-tiny"]
    assert_matches_jax(want, lines, 4)
