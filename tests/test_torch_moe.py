"""The port's sparse MoE (``models/moe.py``) and MoE Llama against the JAX
package's, on the same inputs and carried-across weights.

Routing on the same f32 probabilities (``tests/test_moe.py``'s cases):
``dispatch`` exactly equal, ``combine`` and the aux loss at atol 1e-6.
``MoEMLP`` in f32: output and every gradient at rtol 1e-5 of the
tensor's largest magnitude (the order of f32 sums differs);
with bf16 combine weights the router gradient stays within 2e-2 of the
f32-combine one (the JAX test's bound). ``llama-moe-tiny`` loss at rtol
1e-5 and gradients at atol 2e-5 against JAX's ``loss_fn`` with and
without the aux term, and ``cmd.train --model llama-moe-tiny``'s first
and third global loss against the JAX trainer's at rtol 1e-5.
"""

import contextlib
import io
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpi_operator_tpu.models import llama as jllama
from mpi_operator_tpu.models import moe as jmoe
from mpi_operator_tpu_torch import interop
from mpi_operator_tpu_torch.models import llama as tllama
from mpi_operator_tpu_torch.models import moe as tmoe

pytestmark = pytest.mark.kernel
torch.set_num_threads(2)


def _probs(shape, seed):
    return np.asarray(jax.nn.softmax(
        jnp.asarray(np.random.RandomState(seed).randn(*shape), jnp.float32),
        axis=-1))


def _first_choices_probs():
    return np.asarray([[[0.6, 0.4], [0.4, 0.6]]], np.float32)


def _overflow_probs():
    return np.tile(np.asarray([[0.7, 0.3]], np.float32), (8, 1))[None]


# name -> (probs, top_k, capacity)
ROUTING_CASES = {
    "slots": (lambda: _probs((2, 16, 4), 0), 2, 10),
    "no-drops": (lambda: _probs((1, 32, 4), 1), 2, 64),
    "tight": (lambda: _probs((3, 24, 4), 2), 2, 5),
    "top1-overflow": (_overflow_probs, 1, 2),
    "first-choices-first": (_first_choices_probs, 2, 1),
}


@pytest.mark.parametrize("case", sorted(ROUTING_CASES))
def test_routing_matches_jax(case):
    make, top_k, cap = ROUTING_CASES[case]
    probs = make()
    want = jmoe.routing(jnp.asarray(probs), top_k=top_k, capacity=cap)
    got = tmoe.routing(torch.tensor(probs), top_k, cap)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6,
                                   rtol=0)
    if case == "first-choices-first":
        # Expert 1's one slot goes to token 1's first choice.
        assert float(got[0][0, 1, 1, 0]) == 1.0
        assert float(got[0][0, 0, 1].sum()) == 0.0
    if case == "top1-overflow":
        assert float(got[0].sum()) == 2.0


def test_topk_gates_and_capacity_match_jax():
    probs = _probs((2, 5, 8), 3)
    for normalize in (True, False):
        want = jmoe.topk_gates(jnp.asarray(probs), 2, normalize=normalize)
        got = tmoe.topk_gates(torch.tensor(probs), 2, normalize=normalize)
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
        for g, w in zip((got[0], got[2]), (want[0], want[2])):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-7)
    for args in ((16, 4, 2, 1.25), (2048, 8, 2, 1.25), (3, 8, 1, 1.0)):
        assert tmoe.expert_capacity(*args) == jmoe.expert_capacity(*args)


def test_perfectly_balanced_aux_is_one():
    g, s, e = 2, 16, 4
    tilt = torch.nn.functional.one_hot(torch.arange(s) % e, e) * 1e-4
    probs = torch.full((g, s, e), 1.0 / e) + tilt[None]
    _, _, aux = tmoe.routing(probs, 1, 8)
    assert abs(float(aux.detach()) - 1.0) < 0.01


def _mlp_pair(d, f, e, cf, x, **kw):
    jm = jmoe.MoEMLP(dim=d, ffn_dim=f, n_experts=e, top_k=2,
                     capacity_factor=cf, dtype=jnp.float32, **kw)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    tm = tmoe.MoEMLP(d, f, e, top_k=2, capacity_factor=cf,
                     dtype=torch.float32)
    tm.load_state_dict({k: torch.tensor(np.asarray(v))
                        for k, v in params.items()})
    return jm, params, tm


@pytest.mark.parametrize("cf", [1.0, 4.0])
def test_moe_mlp_forward_and_gradients_match_jax(cf):
    d, f, e = 16, 32, 4
    x = np.random.RandomState(0).randn(2, 12, d).astype(np.float32)
    jm, params, tm = _mlp_pair(d, f, e, cf, x)

    def jloss(p, xx):
        out, aux = jm.apply({"params": p}, xx)
        return jnp.sum(out ** 2) + 0.01 * aux, (out, aux)

    (jl, (jout, jaux)), (jg, jgx) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(params, jnp.asarray(x))
    xt = torch.tensor(x, requires_grad=True)
    out, aux = tm(xt)
    loss = (out ** 2).sum() + 0.01 * aux
    loss.backward()
    np.testing.assert_allclose(float(aux.detach()), float(jaux), rtol=1e-5)
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
    pairs = {"out": (out.detach(), jout), "x": (xt.grad, jgx),
             **{name: (p.grad, jg[name]) for name, p in tm.named_parameters()}}
    for name, (got, want) in pairs.items():
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-5 * np.abs(want).max(),
                                   err_msg=name)
        assert float(got.abs().max()) > 0, name


def test_identical_experts_equal_dense_swiglu():
    """Equal experts, nothing dropped: top-k routing with normalized
    gates is the dense SwiGLU."""
    d, f, e = 16, 32, 4
    tm = tmoe.MoEMLP(d, f, e, top_k=2, capacity_factor=float(e),
                     dtype=torch.float32)
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for p in tm.parameters():
            p.normal_(0, 0.3, generator=gen)
        for name in tmoe.EXPERT_PARAMS:
            w = getattr(tm, name)
            w.copy_(w[:1].expand_as(w))
    x = torch.randn(2, 8, d, generator=gen)
    out, aux = tm(x)
    wg, wu, wd = (getattr(tm, n)[0] for n in tmoe.EXPERT_PARAMS)
    dense = (torch.nn.functional.silu(x @ wg) * (x @ wu)) @ wd
    torch.testing.assert_close(out, dense, atol=1e-5, rtol=1e-5)
    assert float(aux.detach()) > 0


def test_router_gradient_with_bf16_combine():
    """bf16 combine weights do not bias the router's gradient: within
    2e-2 of the f32-combine gradient, and of JAX's bf16-combine one."""
    d, f, e = 16, 32, 4
    x = np.random.RandomState(0).randn(2, 16, d).astype(np.float32)
    jm = jmoe.MoEMLP(dim=d, ffn_dim=f, n_experts=e, top_k=2,
                     capacity_factor=2.0, dtype=jnp.bfloat16)
    xb = jnp.asarray(x, jnp.bfloat16)
    params = jm.init(jax.random.PRNGKey(0), xb)["params"]

    def jloss(p):
        out, aux = jm.apply({"params": p}, xb)
        return jnp.sum(out.astype(jnp.float32) ** 2) + 0.01 * aux

    jgrad = np.asarray(jax.grad(jloss)(params)["router"])
    grads = {}
    for combine in (None, torch.float32):
        tm = tmoe.MoEMLP(d, f, e, top_k=2, capacity_factor=2.0,
                         dtype=torch.bfloat16, combine_dtype=combine)
        tm.load_state_dict({k: torch.tensor(np.asarray(v))
                            for k, v in params.items()})
        out, aux = tm(torch.tensor(x).to(torch.bfloat16))
        ((out.float() ** 2).sum() + 0.01 * aux).backward()
        grads[combine] = tm.router.grad.numpy()
    scale = np.abs(grads[torch.float32]).max()
    assert np.abs(grads[None] - grads[torch.float32]).max() / scale < 2e-2
    assert np.abs(grads[None] - jgrad).max() / np.abs(jgrad).max() < 2e-2


def _llama_pair(**kw):
    cfg = jllama.tiny_moe(**kw)
    jmodel = jllama.Llama(cfg)
    params = jllama.init_params(jmodel, jax.random.PRNGKey(0))
    tmodel = tllama.Llama(tllama.tiny_moe(**kw), device="cpu")
    tmodel.load_state_dict(interop.llama_params_from_jax(
        jax.tree_util.tree_map(np.asarray, params)))
    return jmodel, params, tmodel


def _leaves(tree):
    return {
        "/".join(str(getattr(k, "key", k)) for k in path): np.asarray(leaf)
        for path, leaf in jax.tree_util.tree_leaves_with_path(tree)
    }


def test_interop_round_trip_is_bit_for_bit():
    _, params, tmodel = _llama_pair()
    back = _leaves(interop.llama_params_to_jax(tmodel.state_dict()))
    want = _leaves(params)
    assert sorted(back) == sorted(want)
    assert "layer_0/moe/expert_wg" in want
    for name, arr in want.items():
        np.testing.assert_array_equal(back[name], arr, err_msg=name)
    assert tmodel.layer_0.moe.expert_wd.shape == (4, 128, 64)
    assert tmodel.layer_0.moe.router.shape == (64, 4)


@pytest.mark.parametrize("include_aux", [True, False])
@pytest.mark.parametrize("xent_chunk", [0, 6])
def test_llama_moe_loss_and_gradients_match_jax(include_aux, xent_chunk):
    jmodel, params, tmodel = _llama_pair(xent_chunk=xent_chunk)
    tokens = np.random.RandomState(0).randint(0, 256, (2, 16)).astype(
        np.int32)
    want_loss, want_grads = jax.value_and_grad(
        lambda p: jllama.loss_fn(jmodel, p, jnp.asarray(tokens),
                                 include_aux=include_aux))(params)
    loss = tllama.loss_fn(tmodel, torch.tensor(tokens),
                          include_aux=include_aux)
    loss.backward()
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-5)
    got = _leaves(interop.llama_params_to_jax(
        {k: p.grad for k, p in tmodel.named_parameters()}))
    for name, arr in _leaves(want_grads).items():
        np.testing.assert_allclose(got[name], arr, atol=2e-5, rtol=1e-5,
                                   err_msg=name)


def test_moe_forward_returns_logits_and_aux():
    jmodel, params, tmodel = _llama_pair()
    tokens = np.zeros((2, 16), np.int32)
    jlogits, jaux = jmodel.apply({"params": params}, jnp.asarray(tokens))
    logits, aux = tmodel(torch.tensor(tokens))
    assert logits.shape == (2, 16, 256) and aux.shape == ()
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits),
                               atol=2e-5)
    np.testing.assert_allclose(float(aux.detach()), float(jaux), rtol=1e-5)
    dense = tllama.Llama(tllama.tiny(), device="cpu")
    assert dense(torch.tensor(tokens)).shape == (2, 16, 256)  # no tuple
    assert tllama.config_for("mixtral-8x7b") == tllama.mixtral_8x7b()
    assert tllama.config_for("mixtral-8x7b").n_experts == 8


@pytest.mark.parametrize("data", [False, True])
def test_mixtral_takes_the_llama_workload(monkeypatch, tmp_path, data):
    """``--model mixtral-8x7b`` (too large to build here) reaches the
    Llama arm of the trainer, with or without ``--data``, and its mesh
    checks run before any model is built."""
    from mpi_operator_tpu_torch.cmd import train

    seen = []
    monkeypatch.setattr(train, "_lm_workload",
                        lambda args, mesh, n: seen.append(args.model))
    argv = ["--model", "mixtral-8x7b"] + (
        ["--data", str(tmp_path / "c.u32")] if data else [])
    train.build_workload(train.build_parser().parse_args(argv), None, 1)
    assert seen == ["mixtral-8x7b"]
    for mesh, match in (("ep=3", "8 experts not divisible by ep=3"),
                        ("tp=2", "require 2 devices, have 1")):
        with pytest.raises(SystemExit, match=match):
            train.main(["--device", "cpu", "--model", "mixtral-8x7b",
                        "--mesh", mesh])
    with pytest.raises(SystemExit, match="needs an MoE model"):
        train.main(["--device", "cpu", "--model", "llama-tiny", "--mesh",
                    "ep=2"])


def test_train_cli_curve_matches_the_jax_trainer(tmp_path):
    """``cmd.train --model llama-moe-tiny`` from the JAX init: the first
    and third global loss of the JAX trainer's run (one process here,
    JAX's dp=-1 over 8 devices, one global batch)."""
    from mpi_operator_tpu_torch.cmd import train
    from tests.test_torch_world import BASE, _init_from, jax_reference

    argv = ["--model", "llama-moe-tiny", *BASE]
    want, init = jax_reference(argv, "dp=-1")
    path = str(tmp_path / "init.pt")
    torch.save(init, path)
    buf = io.StringIO()
    with _init_from(path), contextlib.redirect_stdout(buf):
        assert train.main(["--device", "cpu", *argv]) == 0
    line = json.loads(buf.getvalue().strip().splitlines()[-1])
    assert line["final_step"] == 3 and line["model"] == "llama-moe-tiny"
    np.testing.assert_allclose(line["first_loss"], want[0], rtol=1e-5)
    np.testing.assert_allclose(line["loss"], want[-1], rtol=1e-5)
    assert want[-1] < want[0]

