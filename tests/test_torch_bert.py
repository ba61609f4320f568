"""The port's BERT against the JAX package's, on carried-across weights.

``tiny`` in f32 on both sides, through each attention route: ``flash``
(the flat Pallas kernels in interpret mode on the JAX side), ``flash-bhsd``
(the [B*H, S, D] Pallas kernels) and ``dense``; the port's kernels take
their plain versions on the CPU. The JAX weights come across through
``interop`` as numpy arrays. Tolerances, f32: logits atol 2e-5, losses
rtol 1e-5, per-leaf gradients atol 2e-5; the 3-step AdamW loss curve
rtol 1e-4.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mpi_operator_tpu.models import bert as jbert
from mpi_operator_tpu.ops import attention as jattn
from mpi_operator_tpu_torch import interop
from mpi_operator_tpu_torch.models import bert as tbert

pytestmark = pytest.mark.kernel
torch.set_num_threads(2)

IMPLS = ("flash", "flash-bhsd", "dense")


@pytest.fixture(autouse=True)
def _reference_flat_path(monkeypatch):
    """The reference's ``_flat_pack`` reads ``os.environ`` but its module
    never imports ``os``, so its flat path raises NameError. Supply the
    missing module global for the duration of a test."""
    monkeypatch.setattr(jattn, "os", os, raising=False)


def _batch(b=2, s=16, n_pred=3, seed=0):
    """(tokens, mask, targets, positions, pos_targets, weights), numpy."""
    rng = np.random.RandomState(seed)
    targets = rng.randint(0, 128, (b, s)).astype(np.int32)
    mask = (rng.rand(b, s) < 0.25).astype(np.float32)
    tokens = np.where(mask > 0, 0, targets).astype(np.int32)
    positions = np.sort(rng.rand(b, s).argsort(1)[:, :n_pred], 1).astype(
        np.int32)
    weights = np.ones((b, n_pred), np.float32)
    weights[0, -1] = 0.0  # a padding slot
    pos_targets = np.take_along_axis(targets, positions, 1)
    return tokens, mask, targets, positions, pos_targets, weights


def _jax_model(with_types=False, **kw):
    model = jbert.Bert(jbert.tiny(**kw))
    tokens = jnp.zeros((2, 16), jnp.int32)
    extra = {"token_types": jnp.zeros_like(tokens)} if with_types else {}
    params = model.init(jax.random.PRNGKey(0), tokens, **extra)["params"]
    return model, params


def _port_model(params, **kw):
    model = tbert.Bert(tbert.tiny(**kw), device="cpu")
    missing, unexpected = model.load_state_dict(
        interop.bert_params_from_jax(jax.tree_util.tree_map(np.asarray, params)),
        strict=False,
    )
    assert not unexpected
    assert set(missing) <= {"type_embed.weight"}
    return model


def _leaves(tree):
    return {
        "/".join(str(getattr(k, "key", k)) for k in path): np.asarray(leaf)
        for path, leaf in jax.tree_util.tree_leaves_with_path(tree)
    }


def _port_grads(model):
    return _leaves(interop.bert_params_to_jax(
        {n: p.grad for n, p in model.named_parameters() if p.grad is not None}
    ))


@pytest.mark.parametrize("with_types", [False, True])
def test_interop_round_trip_is_bit_for_bit(with_types):
    _, params = _jax_model(with_types)
    model = _port_model(params)
    state = model.state_dict()
    if not with_types:
        del state["type_embed.weight"]
    back = _leaves(interop.bert_params_to_jax(state))
    want = _leaves(params)
    assert sorted(back) == sorted(want)
    assert any("type_embed" in k for k in want) == with_types
    for name, arr in want.items():
        assert back[name].dtype == arr.dtype, name
        np.testing.assert_array_equal(back[name], arr, err_msg=name)
    # kernel [in, out] -> weight [out, in]; biases and norms as they are
    wi = params["layer_0"]["ffn_in"]["kernel"]
    assert model.layer_0.ffn_in.weight.shape == wi.shape[::-1]
    assert model.mlm_norm.bias.shape == params["mlm_norm"]["bias"].shape


def test_bert_base_config_matches_jax_field_for_field():
    want = dataclasses.asdict(jbert.bert_base())
    got = dataclasses.asdict(tbert.bert_base())
    for tpu_only in ("flash_block_q", "flash_block_k"):
        del want[tpu_only]
    assert sorted(got) == sorted(want)
    for name, value in want.items():
        if name == "dtype":
            assert str(got[name]).removeprefix("torch.") == jnp.dtype(value).name
        else:
            assert got[name] == value, name
    tiny_j, tiny_t = dataclasses.asdict(jbert.tiny()), dataclasses.asdict(tbert.tiny())
    assert all(tiny_t[k] == tiny_j[k] for k in tiny_t if k != "dtype")


@pytest.mark.parametrize("layout", ["mask", "positions"])
@pytest.mark.parametrize("impl", IMPLS)
def test_logits_losses_and_gradients_match_jax(impl, layout):
    jmodel, params = _jax_model(attention_impl=impl)
    tmodel = _port_model(params, attention_impl=impl)
    tokens, mask, targets, positions, pos_targets, weights = _batch()
    if layout == "mask":
        jargs, targs = (tokens, mask, targets), (tokens, mask, targets)
        jloss, tloss = jbert.mlm_loss, tbert.mlm_loss
        apply_kw = {}
    else:
        jargs = targs = (tokens, positions, pos_targets, weights)
        jloss, tloss = jbert.mlm_loss_positions, tbert.mlm_loss_positions
        apply_kw = {"mlm_positions": positions}

    want_logits = jmodel.apply(
        {"params": params}, jnp.asarray(tokens),
        **{k: jnp.asarray(v) for k, v in apply_kw.items()})
    want_loss, want_grads = jax.value_and_grad(
        lambda p: jloss(jmodel, p, *(jnp.asarray(x) for x in jargs)))(params)

    with torch.no_grad():
        got_logits = tmodel(torch.tensor(tokens),
                            **{k: torch.tensor(v) for k, v in apply_kw.items()})
    got_loss = tloss(tmodel, *(torch.tensor(x) for x in targs))
    got_loss.backward()
    assert tmodel.type_embed.weight.grad is None  # no token types passed

    np.testing.assert_allclose(got_logits.numpy(), np.asarray(want_logits),
                               atol=2e-5, rtol=0)
    np.testing.assert_allclose(float(got_loss.detach()), float(want_loss),
                               rtol=1e-5)
    got_grads, want_grads = _port_grads(tmodel), _leaves(want_grads)
    assert sorted(got_grads) == sorted(want_grads)
    for name, want in want_grads.items():
        np.testing.assert_allclose(got_grads[name], want, atol=2e-5, rtol=0,
                                   err_msg=name)


def test_token_types_reach_the_type_embedding():
    jmodel, params = _jax_model(with_types=True)
    tmodel = _port_model(params)
    tokens = _batch()[0]
    types = (np.arange(16)[None, :] >= 8).astype(np.int32).repeat(2, 0)
    want = jmodel.apply({"params": params}, jnp.asarray(tokens),
                        jnp.asarray(types))
    got = tmodel(torch.tensor(tokens), torch.tensor(types))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=2e-5, rtol=0)


def test_three_adamw_steps_match_jax():
    """The positions train step with the flash-bhsd route, as the trainer
    builds it; the parameter that gets no gradient (type_embed) does not
    move."""
    lr = 1e-2
    jmodel, params = _jax_model(attention_impl="flash-bhsd")
    tmodel = _port_model(params, attention_impl="flash-bhsd")
    batch = _batch(seed=1)
    args = (batch[0], batch[3], batch[4], batch[5])

    optimizer = optax.adamw(lr)
    step = jax.jit(jbert.make_train_step_positions(jmodel, optimizer))
    opt_state = optimizer.init(params)
    want = []
    for _ in range(3):
        params, opt_state, loss = step(params, opt_state,
                                       *(jnp.asarray(x) for x in args))
        want.append(float(loss))

    type_embed = tmodel.type_embed.weight.detach().clone()
    topt = torch.optim.AdamW(tmodel.parameters(), lr=lr, betas=(0.9, 0.999),
                             eps=1e-8, weight_decay=1e-4)
    tstep = tbert.make_train_step_positions(tmodel, topt)
    got = [float(tstep(*(torch.tensor(x) for x in args))) for _ in range(3)]
    assert want[2] < want[0]
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert torch.equal(tmodel.type_embed.weight, type_embed)


def test_init_params_follows_flax_distributions_and_seed():
    cfg = tbert.tiny(dim=128, ffn_dim=256, vocab_size=512)

    def init(seed):
        model = tbert.Bert(cfg, device="cpu")
        return tbert.init_params(model, torch.Generator().manual_seed(seed))

    a, b, c = init(0), init(0), init(1)
    for (name, pa), pb, pc in zip(a.named_parameters(), b.parameters(),
                                  c.parameters()):
        assert torch.equal(pa, pb), name
        if name.endswith(("scale", "bias")):
            assert torch.all(pa == (1.0 if name.endswith("scale") else 0.0))
            continue
        assert not torch.equal(pa, pc), name
        fan_in = pa.shape[1]
        std = float(pa.detach().std())
        np.testing.assert_allclose(std, fan_in ** -0.5, rtol=0.15, err_msg=name)
        if not name.split(".")[-2].endswith("_embed"):
            limit = 2 * fan_in ** -0.5 / 0.87962566103423978
            assert float(pa.detach().abs().max()) <= limit + 1e-6, name


def test_remat_full_changes_nothing_and_dots_is_refused():
    _, params = _jax_model()
    tokens, mask, targets = (torch.tensor(x) for x in _batch(seed=2)[:3])
    runs = []
    for remat in (False, True):
        model = _port_model(params, remat=remat, remat_policy="full")
        loss = tbert.mlm_loss(model, tokens, mask, targets)
        loss.backward()
        runs.append((float(loss.detach()),
                     [p.grad for p in model.parameters() if p.grad is not None]))
    assert runs[0][0] == runs[1][0]
    for g0, g1 in zip(runs[0][1], runs[1][1]):
        torch.testing.assert_close(g0, g1, rtol=0, atol=1e-7)
    # 'dots' (the config's default policy) is ported: the model builds
    # and its checkpointed step equals the plain one.
    model = _port_model(params, remat=True, remat_policy="dots")
    loss = tbert.mlm_loss(model, tokens, mask, targets)
    loss.backward()
    assert float(loss.detach()) == runs[0][0]
    for g0, g1 in zip(runs[0][1], [p.grad for p in model.parameters()
                                   if p.grad is not None]):
        torch.testing.assert_close(g0, g1, rtol=0, atol=1e-7)


def test_unported_attention_impls_raise():
    """The sequence-parallel impls need an sp group, which a model built
    without one has not; the JAX pipeline's in-stage names
    (``ring-shard``, ``ulysses-shard``) are the same ring and Ulysses."""
    tokens = torch.zeros(1, 8, dtype=torch.long)
    for impl in ("ring", "ulysses", "ring-shard", "ulysses-shard"):
        model = tbert.Bert(tbert.tiny(attention_impl=impl), device="cpu")
        with pytest.raises(ValueError, match="needs a mesh with an sp axis"):
            model(tokens)
