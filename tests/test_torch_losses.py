"""The port's chunked LM loss and f32 logits against the JAX package's.

Same numpy inputs through ``mpi_operator_tpu.ops.losses`` and
``mpi_operator_tpu_torch.ops.losses``. Tolerances: f32 loss rtol 1e-5,
gradients atol 1e-6 (sums of a few dozen terms in another order); f32
logits from bf16 operands rtol 1e-6 (the products are exact in f32 on
both sides, only the summation order differs).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpi_operator_tpu.ops import losses as jlosses
from mpi_operator_tpu_torch.ops import losses as tlosses

pytestmark = pytest.mark.kernel
torch.set_num_threads(2)


def _setup(b=2, s=24, d=16, v=64, seed=0):
    rng = np.random.RandomState(seed)
    h = rng.standard_normal((b, s, d)).astype(np.float32)
    w = (rng.standard_normal((d, v)) * 0.1).astype(np.float32)
    t = rng.randint(0, v, (b, s)).astype(np.int32)
    return h, w, t


@pytest.mark.parametrize("chunk", [4, 8, 24, 100])
def test_chunked_loss_matches_jax(chunk):
    h, w, t = _setup()
    want = jlosses.lm_xent_chunked(
        jnp.asarray(h), jnp.asarray(w), jnp.asarray(t), chunk=chunk
    )
    got = tlosses.lm_xent_chunked(
        torch.tensor(h), torch.tensor(w), torch.tensor(t), chunk=chunk
    )
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


def test_tail_padding_weights_and_gradients_match_jax():
    """S=23 over chunk 8: the last chunk is padded with weight-0 rows;
    a user mask rides along. Gradients with respect to h and w."""
    h, w, t = _setup(s=23, seed=1)
    mask = (np.random.RandomState(2).rand(2, 23) < 0.7).astype(np.float32)

    def jloss(h, w):
        return jlosses.lm_xent_chunked(h, w, jnp.asarray(t),
                                       jnp.asarray(mask), chunk=8)

    want, (want_dh, want_dw) = jax.value_and_grad(jloss, argnums=(0, 1))(
        jnp.asarray(h), jnp.asarray(w)
    )
    ht = torch.tensor(h, requires_grad=True)
    wt = torch.tensor(w, requires_grad=True)
    got = tlosses.lm_xent_chunked(ht, wt, torch.tensor(t), torch.tensor(mask),
                                  chunk=8)
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    np.testing.assert_allclose(ht.grad.numpy(), np.asarray(want_dh),
                               atol=1e-6, rtol=0)
    np.testing.assert_allclose(wt.grad.numpy(), np.asarray(want_dw),
                               atol=1e-6, rtol=0)


def test_chunked_equals_full_logits_mean():
    h, w, t = _setup(s=20, seed=4)
    ht, wt, tt = torch.tensor(h), torch.tensor(w), torch.tensor(t).long()
    full = torch.nn.functional.cross_entropy(
        tlosses.f32_logits(ht, wt).reshape(-1, w.shape[1]), tt.reshape(-1)
    )
    chunked = tlosses.lm_xent_chunked(ht, wt, tt, chunk=6)
    np.testing.assert_allclose(float(chunked), float(full), rtol=1e-6)


def test_f32_logits_from_bf16_matches_jax():
    h, w, _ = _setup(s=8, d=32, v=48, seed=5)
    want = jlosses.f32_logits(jnp.asarray(h, jnp.bfloat16), jnp.asarray(w))
    got = tlosses.f32_logits(torch.tensor(h).to(torch.bfloat16),
                             torch.tensor(w))
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
