"""The port's Llama against the JAX package's, on carried-across weights.

``llama-tiny`` in f32 with ``attention_impl="flash"`` on both sides (the
JAX kernels in interpret mode; the port's plain versions on the CPU).
The JAX weights come across through ``interop`` as numpy arrays.
Tolerances, f32: logits atol 2e-5, loss rtol 1e-5, per-leaf gradients
atol 2e-5; the 3-step AdamW loss curve rtol 1e-4.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mpi_operator_tpu.models import llama as jllama
from mpi_operator_tpu.ops import attention as jattn
from mpi_operator_tpu_torch import interop
from mpi_operator_tpu_torch.models import llama as tllama

pytestmark = pytest.mark.kernel
torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _reference_flat_path(monkeypatch):
    """The reference's ``_flat_pack`` reads ``os.environ`` but its module
    never imports ``os``, so its flat path raises NameError. Supply the
    missing module global for the duration of a test."""
    monkeypatch.setattr(jattn, "os", os, raising=False)


def _tokens(b=2, s=16, seed=0):
    return np.random.RandomState(seed).randint(0, 256, (b, s)).astype(np.int32)


def _jax_model(**kw):
    model = jllama.Llama(jllama.tiny(attention_impl="flash", **kw))
    params = jllama.init_params(model, jax.random.PRNGKey(0))
    return model, params


def _port_model(params, **kw):
    model = tllama.Llama(tllama.tiny(attention_impl="flash", **kw),
                         device="cpu")
    model.load_state_dict(
        interop.llama_params_from_jax(jax.tree_util.tree_map(np.asarray, params))
    )
    return model


def _leaves(tree):
    return {
        "/".join(str(getattr(k, "key", k)) for k in path): np.asarray(leaf)
        for path, leaf in jax.tree_util.tree_leaves_with_path(tree)
    }


def test_interop_round_trip_is_bit_for_bit():
    _, params = _jax_model()
    model = _port_model(params)  # load_state_dict is strict: names, shapes
    back = _leaves(interop.llama_params_to_jax(model.state_dict()))
    want = _leaves(params)
    assert sorted(back) == sorted(want)
    for name, arr in want.items():
        assert back[name].dtype == arr.dtype, name
        np.testing.assert_array_equal(back[name], arr, err_msg=name)
    # kernel [in, out] -> weight [out, in]
    wq = params["layer_0"]["attn"]["wq"]["kernel"]
    assert model.layer_0.attn.wq.weight.shape == wq.shape[::-1]


@pytest.mark.parametrize("xent_chunk", [0, 6])
def test_logits_loss_and_gradients_match_jax(xent_chunk):
    jmodel, params = _jax_model(xent_chunk=xent_chunk)
    tmodel = _port_model(params, xent_chunk=xent_chunk)
    tokens = _tokens()

    want_logits = jmodel.apply({"params": params}, jnp.asarray(tokens))
    want_loss, want_grads = jax.value_and_grad(
        lambda p: jllama.loss_fn(jmodel, p, jnp.asarray(tokens))
    )(params)

    tt = torch.tensor(tokens)
    with torch.no_grad():
        got_logits = tmodel(tt)
    got_loss = tllama.loss_fn(tmodel, tt)
    got_loss.backward()
    got_grads = _leaves(interop.llama_params_to_jax(
        {n: p.grad for n, p in tmodel.named_parameters()}
    ))

    np.testing.assert_allclose(got_logits.numpy(), np.asarray(want_logits),
                               atol=2e-5, rtol=0)
    np.testing.assert_allclose(float(got_loss.detach()), float(want_loss),
                               rtol=1e-5)
    want_grads = _leaves(want_grads)
    assert sorted(got_grads) == sorted(want_grads)
    for name, want in want_grads.items():
        np.testing.assert_allclose(got_grads[name], want, atol=2e-5, rtol=0,
                                   err_msg=name)


def test_three_adamw_steps_match_jax():
    lr = 1e-2
    jmodel, params = _jax_model()
    tmodel = _port_model(params)
    tokens = _tokens(seed=1)

    optimizer = optax.adamw(lr)
    step = jax.jit(jllama.make_train_step(jmodel, optimizer))
    opt_state = optimizer.init(params)
    want = []
    for _ in range(3):
        params, opt_state, loss = step(params, opt_state, jnp.asarray(tokens))
        want.append(float(loss))

    topt = torch.optim.AdamW(tmodel.parameters(), lr=lr, betas=(0.9, 0.999),
                             eps=1e-8, weight_decay=1e-4)
    tstep = tllama.make_train_step(tmodel, topt)
    got = [float(tstep(torch.tensor(tokens))) for _ in range(3)]
    assert want[2] < want[0]
    np.testing.assert_allclose(got, want, rtol=1e-4)


def test_init_params_follows_flax_distributions_and_seed():
    cfg = tllama.tiny(dim=128, ffn_dim=256, vocab_size=512)

    def init(seed):
        model = tllama.Llama(cfg, device="cpu")
        return tllama.init_params(model, torch.Generator().manual_seed(seed))

    a, b, c = init(0), init(0), init(1)
    for (name, pa), pb, pc in zip(a.named_parameters(), b.parameters(),
                                  c.parameters()):
        assert torch.equal(pa, pb), name
        if name.endswith("scale"):
            assert torch.all(pa == 1.0)
            continue
        assert not torch.equal(pa, pc), name
        fan_in = pa.shape[1]
        std = float(pa.detach().std())
        np.testing.assert_allclose(std, fan_in ** -0.5, rtol=0.1, err_msg=name)
        if name != "embed.weight":  # lecun normal: truncated at 2 stds
            limit = 2 * fan_in ** -0.5 / 0.87962566103423978
            assert float(pa.abs().max()) <= limit + 1e-6, name


def test_unported_configs_raise():
    # MoE configs build since models/moe.py came (tests/test_torch_moe.py);
    # their tensor-parallel plan is the attention's (the experts split
    # outside it), and tp must divide the heads.
    moe = tllama.Llama(tllama.config_for("llama-moe-tiny"), device="cpu")
    plan = tllama.tensor_parallel_plan(moe, 2)
    assert sorted(plan) == sorted(
        f"layer_{i}.attn.{w}" for i in range(2)
        for w in ("wq", "wk", "wv", "wo"))
    with pytest.raises(SystemExit, match="must divide n_kv_heads=2"):
        tllama.tensor_parallel_plan(moe, 4)
    # remat_policy="dots" is ported (tests/test_torch_remat_dots.py): the
    # model builds, and its checkpointed step equals the plain one.
    dots = tllama.init_params(
        tllama.Llama(tllama.tiny(remat=True, remat_policy="dots"),
                     device="cpu"), torch.Generator().manual_seed(0))
    plain = tllama.Llama(tllama.tiny(), device="cpu")
    plain.load_state_dict(dots.state_dict())
    tokens = torch.tensor(_tokens())
    for model in (dots, plain):
        tllama.loss_fn(model, tokens).backward()
    for (name, a), b in zip(dots.named_parameters(), plain.parameters()):
        torch.testing.assert_close(a.grad, b.grad, rtol=0, atol=1e-7,
                                   msg=name)
    with pytest.raises(KeyError, match="unknown llama model"):
        tllama.config_for("mixtral-8x22b")


def test_remat_changes_nothing():
    _, params = _jax_model()
    tokens = torch.tensor(_tokens(seed=2))
    grads = []
    for remat in (False, True):
        model = _port_model(params, remat=remat)
        loss = tllama.loss_fn(model, tokens)
        loss.backward()
        grads.append((float(loss.detach()), [p.grad.clone() for p in model.parameters()]))
    assert grads[0][0] == grads[1][0]
    for g0, g1 in zip(grads[0][1], grads[1][1]):
        torch.testing.assert_close(g0, g1, rtol=0, atol=1e-7)
