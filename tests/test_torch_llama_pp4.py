"""The port's pipelined Llama against the JAX package's, as
``tests/test_torch_llama_pp.py`` holds it, on ``pp=4``: four gloo
processes, one layer a stage, the middle stages holding neither the
embedding nor the head, plain and with tied embeddings (the middle
stages add zeros to the first and last stage's sum). Loss rtol 1e-5,
gradients atol 2e-5.
"""

import pytest

from tests.test_torch_llama_pp import assert_matches_jax, pp_gang

pytestmark = pytest.mark.kernel

RUNS = [(4, "flash"), (4, "tied")]


@pytest.fixture(scope="module")
def gang(tmp_path_factory):
    return pp_gang(tmp_path_factory.mktemp("pp4"), 4,
                   [name for _, name in RUNS])


@pytest.mark.parametrize("n,case", RUNS)
def test_pp_loss_and_gradients_match_jax(gang, n, case):
    assert_matches_jax(*gang[case], f"{case} pp={n}")
