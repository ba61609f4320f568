"""BERT on tensor x sequence parallelism, on four processes on the CPU over
gloo: bert-tiny on ``--mesh sp=2,tp=2`` with the ring (the non-causal
ring on one of the 2 heads a rank), with ``--mlm-layout mask`` and with
``--mlm-layout positions`` (each sp rank gathers the slots in its
columns; the MLM head and the token table it reads are whole on every tp
rank), against the JAX trainer on the 8-device CPU mesh with
``dp=-1,sp=2,tp=2``, from the JAX init: the first and third global-batch
loss on every rank at rtol 1e-5, one gang for both layouts. The spawn
helper is ``tests/test_torch_world.py``'s.
"""

import pytest

from tests.test_torch_world import MODELS, assert_matches_jax, compare_to_jax

pytestmark = pytest.mark.kernel


@pytest.fixture(scope="module")
def sp2tp2(tmp_path_factory):
    models = {"mask": MODELS["bert-tiny"],
              "positions": ["--model", "bert-tiny", "--mlm-layout",
                            "positions"]}
    return compare_to_jax(tmp_path_factory.mktemp("sp2tp2"), "sp=2,tp=2",
                          "dp=-1,sp=2,tp=2", 4, models=models)


def test_bert_on_sp2_tp2_matches_the_jax_trainer(sp2tp2):
    assert_matches_jax(*sp2tp2["mask"], 4)


def test_bert_positions_on_sp2_tp2_match_the_jax_trainer(sp2tp2):
    assert_matches_jax(*sp2tp2["positions"], 4)
