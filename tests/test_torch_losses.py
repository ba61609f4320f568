"""The port's chunked LM loss and f32 logits against the JAX package's,
and the Llama and BERT models in bf16 against JAX's.

Same numpy inputs through ``mpi_operator_tpu.ops.losses`` and
``mpi_operator_tpu_torch.ops.losses``. Tolerances: f32 loss rtol 1e-5,
gradients atol 1e-6 (sums of a few dozen terms in another order); f32
logits from bf16 operands rtol 1e-6 (the products are exact in f32 on
both sides, only the summation order differs).

bf16 head gradients (``HeadProduct``): dh and every chunk's dw are f32
products rounded to bf16 once, and the chunks' dw are summed in bf16, as
in JAX's VJP; the two sides then differ only where an f32 sum in another
order lands on the other side of a bf16 rounding boundary, so dh and dw
are held at 5e-4 of their norm. A chunk sum in f32 rounded once (the
head before it took the reference's dtypes) lies ~4e-3 from JAX's dw.

bf16 models (``llama-tiny`` with a 3-chunk head, ``bert-tiny``): the two
sides round activations to bf16 at other points, which leaves each
gradient leaf 1-3% (of its norm) from JAX's, about as far as JAX's own
bf16 gradients lie from its f32 ones. Loss rtol 2e-3; each leaf within
5e-2 of its norm and all leaves together within 2e-2, except the key
biases, whose exact gradient is 0 (a softmax row is shift-invariant), so
that both sides' values are rounding noise.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mpi_operator_tpu.models import bert as jbert
from mpi_operator_tpu.models import llama as jllama
from mpi_operator_tpu.ops import attention as jattn
from mpi_operator_tpu.ops import losses as jlosses
from mpi_operator_tpu_torch import interop
from mpi_operator_tpu_torch.models import bert as tbert
from mpi_operator_tpu_torch.models import llama as tllama
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


def _norm_rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


@pytest.mark.parametrize("chunk", [0, 5, 8, 13])
def test_bf16_head_gradients_have_the_reference_dtypes(chunk):
    """bf16 h, f32 w: dh is bf16 and dh and the f32 dw match
    ``jax.grad``, through ``lm_xent_chunked`` in 3-8 chunks (S=40) and,
    for ``chunk`` 0, through ``f32_logits`` and a plain mean
    cross-entropy."""
    h, w, t = _setup(s=40, d=32, v=96, seed=6)
    w = w * 3.0
    hb = jnp.asarray(h, jnp.bfloat16)

    def jloss(h, w):
        if chunk:
            return jlosses.lm_xent_chunked(h, w, jnp.asarray(t), chunk=chunk)
        return jnp.mean(optax.softmax_cross_entropy_with_integer_labels(
            jlosses.f32_logits(h, w), jnp.asarray(t)))

    want_dh, want_dw = jax.grad(jloss, argnums=(0, 1))(hb, jnp.asarray(w))
    ht = torch.tensor(np.asarray(hb.astype(jnp.float32))).to(
        torch.bfloat16).requires_grad_()
    wt = torch.tensor(w, requires_grad=True)
    if chunk:
        loss = tlosses.lm_xent_chunked(ht, wt, torch.tensor(t), chunk=chunk)
    else:
        logits = tlosses.f32_logits(ht, wt)
        assert logits.dtype == torch.float32
        loss = torch.nn.functional.cross_entropy(
            logits.reshape(-1, 96), torch.tensor(t).long().reshape(-1))
    loss.backward()
    assert ht.grad.dtype == torch.bfloat16 and want_dh.dtype == jnp.bfloat16
    assert wt.grad.dtype == torch.float32 and want_dw.dtype == jnp.float32
    assert _norm_rel(ht.grad.float().numpy(),
                     np.asarray(want_dh, np.float32)) <= 5e-4
    assert _norm_rel(wt.grad.numpy(), np.asarray(want_dw)) <= 5e-4


def test_head_product_plain_grads_round_once():
    """The plain backward: f32 products of the f32 cotangent and the bf16
    operands, each rounded to bf16 once."""
    rng = np.random.RandomState(7)
    h = torch.tensor(rng.standard_normal((12, 16)), dtype=torch.bfloat16)
    w = torch.tensor(rng.standard_normal((16, 24)), dtype=torch.bfloat16)
    g = torch.tensor(rng.standard_normal((12, 24)), dtype=torch.float32)
    dh, dw = tlosses.head_grads_plain(h, w, g)
    assert dh.dtype == dw.dtype == torch.bfloat16
    assert torch.equal(dh, (g.double() @ w.double().t()).float().to(
        torch.bfloat16))
    assert torch.equal(dw, (h.double().t() @ g.double()).float().to(
        torch.bfloat16))
    hg, wg = h.clone().requires_grad_(), w.clone().requires_grad_()
    out = tlosses.HeadProduct.apply(hg, wg)
    assert out.dtype == torch.float32
    assert torch.equal(out, tlosses.head_logits_plain(h, w))
    out.backward(g)
    assert torch.equal(hg.grad, dh) and torch.equal(wg.grad, dw)
    with pytest.raises(TypeError, match="bf16 operands"):
        tlosses.HeadProduct.apply(h.float(), w)


def _leaves(tree):
    return {
        "/".join(str(getattr(k, "key", k)) for k in path):
            np.asarray(leaf, np.float32)
        for path, leaf in jax.tree_util.tree_leaves_with_path(tree)
    }


def _hold_bf16_grads(got, want):
    assert sorted(got) == sorted(want)
    diff = norm = 0.0
    for name, w in want.items():
        if name.endswith("wk/bias"):
            continue
        assert _norm_rel(got[name], w) <= 5e-2, name
        diff += float(np.sum((got[name] - w) ** 2))
        norm += float(np.sum(w ** 2))
    assert (diff / norm) ** 0.5 <= 2e-2


@pytest.fixture
def _reference_flat_path(monkeypatch):
    """The reference's ``_flat_pack`` reads ``os.environ`` but its module
    never imports ``os``, so its flat path raises NameError. Supply the
    missing module global for the duration of a test."""
    monkeypatch.setattr(jattn, "os", os, raising=False)


def test_bf16_llama_tiny_matches_jax(_reference_flat_path):
    """llama-tiny in bf16 on the flash route with the chunked head (15
    positions in 3 chunks): loss and every gradient leaf against JAX's."""
    impl = "flash"
    tokens = np.random.RandomState(0).randint(0, 256, (2, 16)).astype(np.int32)
    jmodel = jllama.Llama(jllama.tiny(attention_impl=impl,
                                      dtype=jnp.bfloat16, xent_chunk=5))
    params = jllama.init_params(jllama.Llama(jllama.tiny()),
                                jax.random.PRNGKey(0))
    want_loss, want_grads = jax.value_and_grad(
        lambda p: jllama.loss_fn(jmodel, p, jnp.asarray(tokens)))(params)
    tmodel = tllama.Llama(tllama.tiny(attention_impl=impl,
                                      dtype=torch.bfloat16, xent_chunk=5),
                          device="cpu")
    tmodel.load_state_dict(interop.llama_params_from_jax(
        jax.tree_util.tree_map(np.asarray, params)))
    got_loss = tllama.loss_fn(tmodel, torch.tensor(tokens))
    got_loss.backward()
    np.testing.assert_allclose(float(got_loss.detach()), float(want_loss),
                               rtol=2e-3)
    _hold_bf16_grads(
        _leaves(interop.llama_params_to_jax(
            {n: p.grad for n, p in tmodel.named_parameters()})),
        _leaves(want_grads))


def test_bf16_bert_tiny_matches_jax(_reference_flat_path):
    """bert-tiny in bf16 on the flash route (mask layout, the full
    [B, S, V] head on the tied table): loss and every gradient leaf
    against JAX's."""
    impl = "flash"
    rng = np.random.RandomState(0)
    targets = rng.randint(0, 128, (2, 16)).astype(np.int32)
    mask = (rng.rand(2, 16) < 0.25).astype(np.float32)
    tokens = np.where(mask > 0, 0, targets).astype(np.int32)
    jmodel = jbert.Bert(jbert.tiny(attention_impl=impl, dtype=jnp.bfloat16))
    params = jbert.Bert(jbert.tiny()).init(
        jax.random.PRNGKey(0), jnp.zeros((2, 16), jnp.int32))["params"]
    want_loss, want_grads = jax.value_and_grad(
        lambda p: jbert.mlm_loss(jmodel, p, jnp.asarray(tokens),
                                 jnp.asarray(mask), jnp.asarray(targets)))(
        params)
    tmodel = tbert.Bert(tbert.tiny(attention_impl=impl, dtype=torch.bfloat16),
                        device="cpu")
    tmodel.load_state_dict(interop.bert_params_from_jax(
        jax.tree_util.tree_map(np.asarray, params)), strict=False)
    got_loss = tbert.mlm_loss(tmodel, *(torch.tensor(x)
                                        for x in (tokens, mask, targets)))
    got_loss.backward()
    np.testing.assert_allclose(float(got_loss.detach()), float(want_loss),
                               rtol=2e-3)
    _hold_bf16_grads(
        _leaves(interop.bert_params_to_jax(
            {n: p.grad for n, p in tmodel.named_parameters()
             if p.grad is not None})),
        _leaves(want_grads))
