"""Sequence parallelism composed with the batch axes, on the CPU over
gloo: llama-tiny (the ring) on four processes with ``--mesh dp=2,sp=2``
against JAX's ``dp=-1,sp=2`` and with ``fsdp=2,sp=2`` (FSDP2 over dp x
fsdp, the gradients averaged over sp beside it) against JAX's
``dp=-1,fsdp=2,sp=2``: the first and third global-batch losses at rtol
1e-5, as ``test_torch_world_sp.py`` holds ``sp=2`` alone."""

import pytest

from tests.test_torch_world import MODELS, assert_matches_jax, compare_to_jax

pytestmark = pytest.mark.kernel


@pytest.mark.parametrize("mesh,jax_mesh", [
    ("dp=2,sp=2", "dp=-1,sp=2"),
    ("fsdp=2,sp=2", "dp=-1,fsdp=2,sp=2"),
])
def test_sp_composes_with_the_batch_axes(tmp_path, mesh, jax_mesh):
    models = {"llama-tiny": MODELS["llama-tiny"]}
    want, lines = compare_to_jax(tmp_path, mesh, jax_mesh, 4,
                                 models=models)["llama-tiny"]
    assert_matches_jax(want, lines, 4)
