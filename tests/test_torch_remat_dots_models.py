"""The ``dots`` remat policy on BERT and ViT, f32 on the CPU: bert-tiny
(the ``mask`` layout) and vit-tiny with ``remat=True,
remat_policy="dots"`` through the flash route, the loss and every
gradient against JAX's ``dots`` (its flash kernels in interpret mode), at
``tests/test_torch_remat_dots.py``'s tolerances. The pipeline stages and
the sp paths are ``test_torch_remat_dots_world.py``'s.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpi_operator_tpu.models import bert as jbert
from mpi_operator_tpu.models import vit as jvit
from mpi_operator_tpu.ops import attention as jattn
from mpi_operator_tpu_torch import interop
from mpi_operator_tpu_torch.models import bert as tbert
from mpi_operator_tpu_torch.models import vit as tvit
from tests.test_torch_remat_dots import DOTS, RTOL, _assert_grads, _leaves

pytestmark = pytest.mark.kernel
torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _reference_flat_path(monkeypatch):
    # The reference's _flat_pack reads os.environ; its module never
    # imports os (tests/test_torch_llama.py).
    monkeypatch.setattr(jattn, "os", os, raising=False)


def _bert():
    from tests.test_torch_bert import _batch, _jax_model, _port_grads, \
        _port_model

    jmodel, params = _jax_model(attention_impl="flash", **DOTS)
    tmodel = _port_model(params, attention_impl="flash", **DOTS)
    tokens, mask, targets = _batch()[:3]
    loss, grads = jax.value_and_grad(lambda p: jbert.mlm_loss(
        jmodel, p, jnp.asarray(tokens), jnp.asarray(mask),
        jnp.asarray(targets)))(params)
    got = tbert.mlm_loss(tmodel, *(torch.tensor(x)
                                   for x in (tokens, mask, targets)))
    got.backward()
    return float(loss), _leaves(grads), float(got.detach()), _port_grads(
        tmodel)


def _vit():
    from tests.test_torch_vit import _batch, _jax_model, _port_model

    jmodel, params = _jax_model(attention_impl="flash", **DOTS)
    tmodel = _port_model(params, attention_impl="flash", **DOTS)
    images, labels = _batch()
    loss, grads = jax.value_and_grad(lambda p: jvit.loss_fn(
        jmodel, p, jnp.asarray(images), jnp.asarray(labels)))(params)
    got = tvit.loss_fn(tmodel, torch.tensor(images), torch.tensor(labels))
    got.backward()
    return float(loss), _leaves(grads), float(got.detach()), _leaves(
        interop.vit_params_to_jax({n: p.grad for n, p in
                                   tmodel.named_parameters()}))


@pytest.mark.parametrize("name", ["bert-tiny", "vit-tiny"])
def test_dots_gradients_match_jax_dots(name):
    run = {"bert-tiny": _bert, "vit-tiny": _vit}[name]
    want_loss, want, got_loss, got = run()
    np.testing.assert_allclose(got_loss, want_loss, rtol=RTOL)
    _assert_grads(got, want)
