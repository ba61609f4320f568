"""Tensor parallelism for ViT and seq2seq, on two processes with
``--mesh tp=2`` on the CPU over gloo, against the JAX trainer on the
8-device CPU mesh with ``dp=-1,tp=2`` (dp=4) at the same global batch,
from the JAX init, in one gang: vit-tiny (2 heads, biased Dense layers:
q/k/v and ffn_in column-parallel with their biases split, wo and ffn_out
row-parallel with each bias added once) and seq2seq-tiny (encoder
self-attention, decoder self- and cross-attention and every MLP on the
plan): the first and third global-batch loss at rtol 1e-5 (f32 both
sides, only the order of the sums differs). ResNet's replicated layout
is ``tests/test_torch_world_tp_resnet.py``. The spawn helper is
``tests/test_torch_world.py``'s.
"""

import pytest

from tests.test_torch_world import assert_matches_jax, compare_to_jax

pytestmark = pytest.mark.kernel

FLAT = {"vit-tiny": ["--model", "vit-tiny"],
        "seq2seq-tiny": ["--model", "seq2seq-tiny"]}


@pytest.fixture(scope="module")
def tp2(tmp_path_factory):
    return compare_to_jax(tmp_path_factory.mktemp("tp2"), "tp=2",
                          "dp=-1,tp=2", 2, models=FLAT)


@pytest.mark.parametrize("model", sorted(FLAT))
def test_tp2_matches_the_jax_trainer(tp2, model):
    want, lines = tp2[model]
    assert_matches_jax(want, lines, 2)

