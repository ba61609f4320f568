"""The port's pipelined Llama against the JAX package's, as
``tests/test_torch_llama_pp.py`` holds it, on its other pp=2 cases: tied
embeddings (the first and last stage add their gradients of the shared
table), the ``flash-bhsd`` route and llama-moe-tiny with its router loss
through the pipeline's aux; then the one-stage schedule's router loss
against JAX's sequential fallback. Loss rtol 1e-5, gradients atol 2e-5.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpi_operator_tpu.models import llama as jllama
from mpi_operator_tpu.models import llama_pp as jpp
from mpi_operator_tpu.ops import attention as jattn
from mpi_operator_tpu.parallel import create_mesh as jax_mesh
from mpi_operator_tpu_torch import interop
from mpi_operator_tpu_torch.models import llama as tllama
from mpi_operator_tpu_torch.models import llama_pp as tpp
from mpi_operator_tpu_torch.parallel import mesh as tmesh
from tests.test_torch_llama_pp import (
    B,
    CASES,
    MB,
    _jax_cfg,
    _jax_params,
    _tokens,
    assert_matches_jax,
    pp_gang,
)

pytestmark = pytest.mark.kernel

RUNS = [(2, "tied"), (2, "flash-bhsd"), (2, "moe")]


@pytest.fixture(autouse=True)
def _reference_flat_path(monkeypatch):
    monkeypatch.setattr(jattn, "os", os, raising=False)


@pytest.fixture(scope="module")
def gang(tmp_path_factory):
    return pp_gang(tmp_path_factory.mktemp("pp2v"), 2,
                   [name for _, name in RUNS])


@pytest.mark.parametrize("n,case", RUNS)
def test_pp_loss_and_gradients_match_jax(gang, n, case):
    assert_matches_jax(*gang[case], f"{case} pp={n}")


def test_moe_one_stage_normalizes_aux_as_the_jax_fallback():
    """On a mesh without pp the JAX loss runs its stages in turn over
    the M microbatches and divides the router loss by M; the port's
    one-stage schedule does the same."""
    kw = CASES["moe"]
    cfg = _jax_cfg(kw)
    params = _jax_params(cfg)
    loss_fn = jpp.make_pp_loss_fn(cfg, jax_mesh(dp=-1), microbatch_size=MB)
    want = float(jax.jit(loss_fn)(jpp.pp_params_from_init(params, cfg, 2),
                                  jnp.asarray(_tokens())))
    plain = float(jllama.loss_fn(jllama.Llama(cfg), params,
                                 jnp.asarray(_tokens())))
    np.testing.assert_allclose(want, plain, rtol=1e-5)
    stage = tpp.LlamaStage(tllama.tiny(n_layers=4, **kw), 0, 1)
    stage.load_state_dict(interop.llama_params_from_jax(
        jax.tree_util.tree_map(np.asarray, params)))
    got = tpp.forward_backward(stage, tmesh.create_mesh(device="cpu"),
                               torch.from_numpy(_tokens()), B // MB)
    np.testing.assert_allclose(float(got), want, rtol=1e-5)
