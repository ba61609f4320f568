"""The port's seq2seq encoder-decoder against the JAX package's, on
carried-across weights.

``tiny`` on both sides, through each attention route: ``flash`` (the
flat Pallas kernels in interpret mode on the JAX side; the port's plain
versions on the CPU) and ``dense``. The shared ``embed`` table's gradient
sums three uses (the encoder's and the decoder's lookups and the tied
head), so it is held leaf by leaf like every other parameter. The JAX
weights come across through ``interop`` as numpy arrays. Tolerances, f32:
logits atol 2e-5, loss rtol 1e-5, per-leaf gradients atol 2e-5 (the two
sides sum in another order); the 3-step AdamW loss curve rtol 1e-4.
bf16 (dense route): the two sides round to bf16 at other points (the
port rounds the table once, JAX once per use, and their bf16 products
round in another order), which leaves every leaf 0.7-3% (of its norm)
from JAX's, about as far as JAX's own bf16 gradients lie from its f32
ones; so loss rtol 2e-3, each gradient leaf within 5e-2 of its norm and
all leaves together within 2e-2.
"""

import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mpi_operator_tpu.models import seq2seq as js2s
from mpi_operator_tpu.ops import attention as jattn
from mpi_operator_tpu_torch import interop
from mpi_operator_tpu_torch.models import seq2seq as ts2s

pytestmark = pytest.mark.kernel
torch.set_num_threads(2)

IMPLS = ("flash", "dense")


@pytest.fixture(autouse=True)
def _reference_flat_path(monkeypatch):
    """The reference's ``_flat_pack`` reads ``os.environ`` but its module
    never imports ``os``, so its flat path raises NameError. Supply the
    missing module global for the duration of a test."""
    monkeypatch.setattr(jattn, "os", os, raising=False)


def _batch(b=2, src=24, dec=12, seed=0):
    """(src tokens, targets), numpy; the targets avoid bos (0) so that
    the shift is visible."""
    rng = np.random.RandomState(seed)
    return (rng.randint(0, 128, (b, src)).astype(np.int32),
            rng.randint(1, 128, (b, dec)).astype(np.int32))


@functools.lru_cache(maxsize=1)
def _jax_params():
    """The tiny model's Flax parameters (the same for every attention
    route and compute dtype), made once."""
    return js2s.init_params(js2s.Seq2Seq(js2s.tiny()), jax.random.PRNGKey(0))


def _jax_model(**kw):
    return js2s.Seq2Seq(js2s.tiny(**kw)), _jax_params()


def _jax_loss(model, params, src, tgt):
    """js2s.loss_fn with the logits as aux, so that one traced pass
    gives both (the flash route's interpret-mode kernels trace slowly)."""
    logits = model.apply({"params": params}, src, jnp.asarray(_shifted(tgt)))
    loss = jnp.mean(optax.softmax_cross_entropy_with_integer_labels(
        logits, jnp.asarray(tgt)))
    return loss, logits


def _port_model(params, **kw):
    model = ts2s.Seq2Seq(ts2s.tiny(**kw), device="cpu")
    model.load_state_dict(  # strict: every name and shape
        interop.seq2seq_params_from_jax(
            jax.tree_util.tree_map(np.asarray, params)))
    return model


def _leaves(tree):
    return {
        "/".join(str(getattr(k, "key", k)) for k in path): np.asarray(leaf)
        for path, leaf in jax.tree_util.tree_leaves_with_path(tree)
    }


def _port_grads(model):
    return _leaves(interop.seq2seq_params_to_jax(
        {n: p.grad for n, p in model.named_parameters()}))


def _shifted(targets):
    return np.concatenate([np.zeros_like(targets[:, :1]), targets[:, :-1]], 1)


def test_interop_round_trip_is_bit_for_bit():
    _, params = _jax_model()
    model = _port_model(params)
    back = _leaves(interop.seq2seq_params_to_jax(model.state_dict()))
    want = _leaves(params)
    assert sorted(back) == sorted(want)
    for name, arr in want.items():
        assert back[name].dtype == arr.dtype, name
        np.testing.assert_array_equal(back[name], arr, err_msg=name)
    wq = params["dec_0"]["cross_attn"]["wq"]["kernel"]
    assert model.dec_0.cross_attn.wq.weight.shape == wq.shape[::-1]
    assert model.embed.weight.shape == params["embed"]["embedding"].shape


def test_configs_match_jax_field_for_field():
    for jcfg, tcfg in ((js2s.t5_small_shape(), ts2s.t5_small_shape()),
                       (js2s.tiny(), ts2s.tiny())):
        want, got = dataclasses.asdict(jcfg), dataclasses.asdict(tcfg)
        for tpu_only in ("flash_block_q", "flash_block_k"):
            del want[tpu_only]
        assert sorted(got) == sorted(want)
        for name, value in want.items():
            if name == "dtype":
                assert (str(got[name]).removeprefix("torch.")
                        == jnp.dtype(value).name)
            else:
                assert got[name] == value, name
        assert tcfg.head_dim == jcfg.head_dim


@pytest.mark.parametrize("impl", IMPLS)
def test_logits_loss_and_gradients_match_jax(impl):
    jmodel, params = _jax_model(attention_impl=impl)
    tmodel = _port_model(params, attention_impl=impl)
    src, tgt = _batch()

    (want_loss, want_logits), want_grads = jax.value_and_grad(
        _jax_loss, argnums=1, has_aux=True)(jmodel, params, jnp.asarray(src),
                                            tgt)
    # The aux path is the reference's own loss.
    np.testing.assert_allclose(float(want_loss), float(js2s.loss_fn(
        js2s.Seq2Seq(js2s.tiny()), params, jnp.asarray(src),
        jnp.asarray(tgt))), rtol=1e-6)

    with torch.no_grad():
        got_logits = tmodel(torch.tensor(src), torch.tensor(_shifted(tgt)))
    got_loss = ts2s.loss_fn(tmodel, torch.tensor(src), torch.tensor(tgt))
    got_loss.backward()

    assert got_logits.dtype == torch.float32
    assert got_logits.shape == (2, 12, 128)
    np.testing.assert_allclose(got_logits.numpy(), np.asarray(want_logits),
                               atol=2e-5, rtol=0)
    np.testing.assert_allclose(float(got_loss.detach()), float(want_loss),
                               rtol=1e-5)
    got_grads, want_grads = _port_grads(tmodel), _leaves(want_grads)
    assert sorted(got_grads) == sorted(want_grads)
    for name, want in want_grads.items():
        np.testing.assert_allclose(got_grads[name], want, atol=2e-5, rtol=0,
                                   err_msg=name)


def test_bf16_loss_and_gradients_match_jax():
    """bf16 compute: the tied head runs the bf16 head product, and the
    table's gradient sums its bf16 dw with both lookups' gradients."""
    jmodel, params = _jax_model(dtype=jnp.bfloat16)
    tmodel = _port_model(params, dtype=torch.bfloat16)
    src, tgt = _batch(seed=3)
    want_loss, want_grads = jax.value_and_grad(
        lambda p: js2s.loss_fn(jmodel, p, jnp.asarray(src),
                               jnp.asarray(tgt)))(params)
    got_loss = ts2s.loss_fn(tmodel, torch.tensor(src), torch.tensor(tgt))
    got_loss.backward()
    np.testing.assert_allclose(float(got_loss.detach()), float(want_loss),
                               rtol=2e-3)
    got_grads, want_grads = _port_grads(tmodel), _leaves(want_grads)
    diff = norm = 0.0
    for name, want in want_grads.items():
        got = got_grads[name]
        assert got.dtype == np.float32, name
        err = np.linalg.norm(got - want) / np.linalg.norm(want)
        assert err <= 5e-2, (name, err)
        diff += float(np.sum((got - want) ** 2))
        norm += float(np.sum(want ** 2))
    assert (diff / norm) ** 0.5 <= 2e-2


def test_three_adamw_steps_match_jax():
    """The train step the trainer builds, against optax's adamw on the
    same weights and batch (dense route: the flash route's gradients are
    held above, and its interpret-mode kernels would take most of this
    file's time under jit)."""
    lr = 1e-2
    jmodel, params = _jax_model()
    tmodel = _port_model(params)
    src, tgt = _batch(seed=1)

    optimizer = optax.adamw(lr)
    step = jax.jit(js2s.make_train_step(jmodel, optimizer))
    opt_state = optimizer.init(params)
    want = []
    for _ in range(3):
        params, opt_state, loss = step(params, opt_state, jnp.asarray(src),
                                       jnp.asarray(tgt))
        want.append(float(loss))

    topt = torch.optim.AdamW(tmodel.parameters(), lr=lr, betas=(0.9, 0.999),
                             eps=1e-8, weight_decay=1e-4)
    tstep = ts2s.make_train_step(tmodel, topt)
    got = [float(tstep(torch.tensor(src), torch.tensor(tgt)))
           for _ in range(3)]
    assert want[2] < want[0]
    np.testing.assert_allclose(got, want, rtol=1e-4)


def _logits(model, src, dec):
    with torch.no_grad():
        return model(torch.tensor(src), torch.tensor(dec))


@pytest.mark.parametrize("impl", IMPLS)
def test_decoder_is_causal(impl):
    """A later decoder input changes no earlier position's logits (the
    scenario of tests/test_seq2seq.py)."""
    _, params = _jax_model()
    model = _port_model(params, attention_impl=impl)
    src, tgt = _batch(b=1)
    base = _logits(model, src, tgt)
    tgt2 = tgt.copy()
    tgt2[0, -1] = (tgt2[0, -1] + 1) % 128
    pert = _logits(model, src, tgt2)
    np.testing.assert_allclose(base[:, :-1].numpy(), pert[:, :-1].numpy(),
                               atol=1e-6, rtol=1e-6)
    assert float((base[:, -1] - pert[:, -1]).abs().max()) > 0.0


@pytest.mark.parametrize("impl", IMPLS)
def test_encoder_is_not_causal(impl):
    """A late source token reaches the first decoder position's logits,
    through cross attention over the bidirectional encoder."""
    _, params = _jax_model()
    model = _port_model(params, attention_impl=impl)
    src, tgt = _batch(b=1)
    src2 = src.copy()
    src2[0, -1] = (src2[0, -1] + 1) % 128
    base, pert = _logits(model, src, tgt), _logits(model, src2, tgt)
    assert float((base[:, 0] - pert[:, 0]).abs().max()) > 0.0


def test_unknown_attention_impl_and_long_sequences_raise():
    src, tgt = (torch.tensor(x) for x in _batch(b=1))
    with pytest.raises(ValueError, match="seq2seq attention_impl must be "
                                         "'flash' or 'dense', got 'bogus'"):
        ts2s.Seq2Seq(ts2s.tiny(attention_impl="bogus"), device="cpu")(src, tgt)
    # JAX's position lookup clamps an index past the table; the port
    # refuses the sequence.
    model = ts2s.Seq2Seq(ts2s.tiny(), device="cpu")
    with pytest.raises(ValueError, match="sequence length 65 exceeds "
                                         "max_seq_len 64"):
        model(torch.zeros(1, 65, dtype=torch.long), tgt)


def test_init_params_follows_flax_distributions_and_seed():
    cfg = ts2s.tiny(dim=128, ffn_dim=256, vocab_size=512)

    def init(seed):
        return ts2s.init_params(ts2s.Seq2Seq(cfg, device="cpu"),
                                torch.Generator().manual_seed(seed))

    a, b, c = init(0), init(0), init(1)
    for (name, pa), pb, pc in zip(a.named_parameters(), b.parameters(),
                                  c.parameters()):
        assert torch.equal(pa, pb), name
        if name.endswith(("scale", "bias")):
            assert torch.all(pa == (1.0 if name.endswith("scale") else 0.0))
            continue
        assert not torch.equal(pa, pc), name
        np.testing.assert_allclose(float(pa.detach().std()),
                                   pa.shape[1] ** -0.5, rtol=0.15,
                                   err_msg=name)
