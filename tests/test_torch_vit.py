"""The port's ViT against the JAX package's, on carried-across weights.

``tiny`` in f32 on both sides, through each attention route: ``flash``
(the flat Pallas kernels in interpret mode on the JAX side; the port's
plain versions on the CPU) and ``dense``. The JAX weights come across
through ``interop`` as numpy arrays. Tolerances, f32: logits atol 2e-5,
loss rtol 1e-5, per-leaf gradients atol 2e-5 (the two sides sum in
another order); the 3-step AdamW loss curve rtol 1e-4.
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

from mpi_operator_tpu.models import vit as jvit
from mpi_operator_tpu.ops import attention as jattn
from mpi_operator_tpu_torch import interop
from mpi_operator_tpu_torch.models import vit as tvit

pytestmark = pytest.mark.kernel
torch.set_num_threads(2)

IMPLS = ("flash", "dense")


@pytest.fixture(autouse=True)
def _reference_flat_path(monkeypatch):
    """The reference's ``_flat_pack`` reads ``os.environ`` but its module
    never imports ``os``, so its flat path raises NameError. Supply the
    missing module global for the duration of a test."""
    monkeypatch.setattr(jattn, "os", os, raising=False)


def _batch(n=3, seed=0, image_size=32, classes=16):
    rng = np.random.RandomState(seed)
    images = rng.standard_normal((n, image_size, image_size, 3)).astype(
        np.float32)
    return images, rng.randint(0, classes, (n,)).astype(np.int32)


@functools.lru_cache(maxsize=1)
def _jax_params():
    """The tiny model's Flax parameters (the same for every attention
    route), made once."""
    return jvit.init_params(jvit.ViT(jvit.tiny()), jax.random.PRNGKey(0))


def _jax_model(**kw):
    return jvit.ViT(jvit.tiny(**kw)), _jax_params()


def _port_model(params, **kw):
    model = tvit.ViT(tvit.tiny(**kw), device="cpu")
    model.load_state_dict(  # strict: every name and shape
        interop.vit_params_from_jax(jax.tree_util.tree_map(np.asarray, params)))
    return model


def _leaves(tree):
    return {
        "/".join(str(getattr(k, "key", k)) for k in path): np.asarray(leaf)
        for path, leaf in jax.tree_util.tree_leaves_with_path(tree)
    }


def test_interop_round_trip_is_bit_for_bit():
    _, params = _jax_model()
    model = _port_model(params)
    back = _leaves(interop.vit_params_to_jax(model.state_dict()))
    want = _leaves(params)
    assert sorted(back) == sorted(want)
    for name, arr in want.items():
        assert back[name].dtype == arr.dtype, name
        np.testing.assert_array_equal(back[name], arr, err_msg=name)
    # Dense kernel [in, out] -> weight [out, in]; cls, pos_embed and the
    # head stay as Flax stores them.
    assert model.embed.weight.shape == params["embed"]["kernel"].shape[::-1]
    for name in ("cls", "pos_embed", "head"):
        assert tuple(getattr(model, name).shape) == params[name].shape


def test_configs_match_jax_field_for_field():
    for jcfg, tcfg in ((jvit.vit_base(), tvit.vit_base()),
                       (jvit.tiny(), tvit.tiny())):
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
        assert (tcfg.n_patches, tcfg.head_dim) == (jcfg.n_patches,
                                                    jcfg.head_dim)
    assert tvit.flops_per_image(tvit.vit_base()) == jvit.flops_per_image(
        jvit.vit_base())


@pytest.mark.parametrize("impl", IMPLS)
def test_logits_loss_and_gradients_match_jax(impl):
    jmodel, params = _jax_model(attention_impl=impl)
    tmodel = _port_model(params, attention_impl=impl)
    images, labels = _batch()

    want_logits = jmodel.apply({"params": params}, jnp.asarray(images))
    want_loss, want_grads = jax.value_and_grad(
        lambda p: jvit.loss_fn(jmodel, p, jnp.asarray(images),
                               jnp.asarray(labels)))(params)

    with torch.no_grad():
        got_logits = tmodel(torch.tensor(images))
    got_loss = tvit.loss_fn(tmodel, torch.tensor(images), torch.tensor(labels))
    got_loss.backward()

    assert got_logits.dtype == torch.float32 and got_logits.shape == (3, 16)
    np.testing.assert_allclose(got_logits.numpy(), np.asarray(want_logits),
                               atol=2e-5, rtol=0)
    np.testing.assert_allclose(float(got_loss.detach()), float(want_loss),
                               rtol=1e-5)
    got_grads = _leaves(interop.vit_params_to_jax(
        {n: p.grad for n, p in tmodel.named_parameters()}))
    want_grads = _leaves(want_grads)
    assert sorted(got_grads) == sorted(want_grads)
    for name, want in want_grads.items():
        np.testing.assert_allclose(got_grads[name], want, atol=2e-5, rtol=0,
                                   err_msg=name)


def test_three_adamw_steps_match_jax():
    """The train step the trainer builds (flash route), against optax's
    adamw on the same weights and batch."""
    lr = 1e-2
    jmodel, params = _jax_model(attention_impl="flash")
    tmodel = _port_model(params, attention_impl="flash")
    images, labels = _batch(seed=1)

    optimizer = optax.adamw(lr)
    step = jax.jit(jvit.make_train_step(jmodel, optimizer))
    opt_state = optimizer.init(params)
    want = []
    for _ in range(3):
        params, opt_state, loss = step(params, opt_state, jnp.asarray(images),
                                       jnp.asarray(labels))
        want.append(float(loss))

    topt = torch.optim.AdamW(tmodel.parameters(), lr=lr, betas=(0.9, 0.999),
                             eps=1e-8, weight_decay=1e-4)
    tstep = tvit.make_train_step(tmodel, topt)
    got = [float(tstep(torch.tensor(images), torch.tensor(labels)))
           for _ in range(3)]
    assert want[2] < want[0]
    np.testing.assert_allclose(got, want, rtol=1e-4)


def test_unknown_attention_impl_and_indivisible_patches_raise():
    images = torch.zeros(1, 32, 32, 3)
    with pytest.raises(ValueError, match="vit attention_impl must be 'flash' "
                                         "or 'dense', got 'bogus'"):
        tvit.ViT(tvit.tiny(attention_impl="bogus"), device="cpu")(images)
    with pytest.raises(ValueError, match="image 30x30 not divisible by patch "
                                         "size 8"):
        tvit.ViT(tvit.tiny(image_size=30), device="cpu")(
            torch.zeros(1, 30, 30, 3))


def test_remat_full_changes_nothing_and_dots_is_refused():
    _, params = _jax_model()
    images, labels = (torch.tensor(x) for x in _batch(seed=2))
    runs = []
    for remat in (False, True):
        model = _port_model(params, remat=remat, remat_policy="full")
        loss = tvit.loss_fn(model, images, labels)
        loss.backward()
        runs.append((float(loss.detach()), [p.grad for p in model.parameters()]))
    assert runs[0][0] == runs[1][0]
    for g0, g1 in zip(runs[0][1], runs[1][1]):
        torch.testing.assert_close(g0, g1, rtol=0, atol=1e-7)
    # 'dots' (the config's default policy) is ported: the model builds
    # and its checkpointed step equals the plain one.
    model = _port_model(params, remat=True, remat_policy="dots")
    loss = tvit.loss_fn(model, images, labels)
    loss.backward()
    assert float(loss.detach()) == runs[0][0]
    for g0, g1 in zip(runs[0][1], [p.grad for p in model.parameters()]):
        torch.testing.assert_close(g0, g1, rtol=0, atol=1e-7)


def test_init_params_follows_the_flax_initializers_and_seed():
    cfg = tvit.tiny(dim=128, ffn_dim=256)

    def init(seed):
        return tvit.init_params(tvit.ViT(cfg, device="cpu"),
                                torch.Generator().manual_seed(seed))

    a, b, c = init(0), init(0), init(1)
    for (name, pa), pb, pc in zip(a.named_parameters(), b.parameters(),
                                  c.parameters()):
        assert torch.equal(pa, pb), name
        if name == "cls" or name.endswith(("scale", "bias")):
            want = 1.0 if name.endswith("scale") else 0.0
            assert torch.all(pa == want), name
            continue
        assert not torch.equal(pa, pc), name
        std = float(pa.detach().std())
        if name in ("pos_embed", "head"):
            np.testing.assert_allclose(std, 0.02, rtol=0.15, err_msg=name)
        else:  # lecun normal, truncated at two standard deviations
            fan_in = pa.shape[1]
            np.testing.assert_allclose(std, fan_in ** -0.5, rtol=0.15,
                                       err_msg=name)
            limit = 2 * fan_in ** -0.5 / 0.87962566103423978
            assert float(pa.detach().abs().max()) <= limit + 1e-6, name
