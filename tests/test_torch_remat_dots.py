"""The ``dots`` remat policy (``models/llama.py:remat_policy_for``)
against the JAX package's, on carried-across weights, f32.

Under ``remat=True, remat_policy="dots"`` the loss and every parameter's
gradient of llama-tiny and llama-moe-tiny equal JAX's under its ``dots``
policy (``dots_with_no_batch_dims_saveable`` and the flash residuals by
name; the JAX flash kernels in interpret mode, the port's plain versions
on the CPU). What the policy keeps shows in the plain flash forward's
calls in one training step (forward and backward) of every model that
takes it: once a layer under ``dots``, as without remat, twice under
``full``. ``cmd.train --remat-policy dots`` (llama-tiny with remat on,
in both packages) against the JAX trainer's curve.
``test_torch_remat_dots_models.py`` holds BERT, ViT, the pipeline stages
and the sp paths.
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpi_operator_tpu.models import llama as jllama
from mpi_operator_tpu.ops import attention as jattn
from mpi_operator_tpu_torch import interop
from mpi_operator_tpu_torch.models import bert as tbert
from mpi_operator_tpu_torch.models import llama as tllama
from mpi_operator_tpu_torch.models import vit as tvit
from mpi_operator_tpu_torch.ops import attention as tattn

pytestmark = pytest.mark.kernel
torch.set_num_threads(2)

DOTS = dict(remat=True, remat_policy="dots")
RTOL = 1e-5


@pytest.fixture(autouse=True)
def _reference_flat_path(monkeypatch):
    # The reference's _flat_pack reads os.environ; its module never
    # imports os (tests/test_torch_llama.py).
    monkeypatch.setattr(jattn, "os", os, raising=False)


def _leaves(tree):
    return {"/".join(str(getattr(k, "key", k)) for k in path):
            np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_leaves_with_path(tree)}


def _tokens(b=2, s=16, seed=0):
    return np.random.RandomState(seed).randint(0, 256, (b, s)).astype(
        np.int32)


def _assert_grads(got: dict, want: dict):
    """The whole gradient within RTOL of JAX's, relative to its norm, and
    every element within the parity tests' atol 2e-5: f32 on both sides,
    only the order of the sums differs. (Per leaf, a relative bound is
    no bound: the key bias's gradient is 0 but for rounding.)"""
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        np.testing.assert_allclose(got[name], w, atol=2e-5, rtol=0,
                                   err_msg=name)
    diff = np.sqrt(sum(np.sum((got[n] - w) ** 2) for n, w in want.items()))
    norm = np.sqrt(sum(np.sum(w ** 2) for w in want.values()))
    assert diff <= RTOL * norm, diff / norm


# name -> (the JAX side's loss and gradients, the port's), each a
# function of the JAX parameters. llama-tiny and llama-moe-tiny at
# capacity 1.25 (tokens drop: the recompute routes them alike).
def _llama(moe: bool):
    jcfg = (jllama.tiny_moe if moe else jllama.tiny)(attention_impl="flash",
                                                     **DOTS)
    tcfg = (tllama.tiny_moe if moe else tllama.tiny)(attention_impl="flash",
                                                     **DOTS)
    jmodel = jllama.Llama(jcfg)
    params = jllama.init_params(jmodel, jax.random.PRNGKey(0))
    tokens = _tokens()
    loss, grads = jax.value_and_grad(
        lambda p: jllama.loss_fn(jmodel, p, jnp.asarray(tokens)))(params)
    tmodel = tllama.Llama(tcfg, device="cpu")
    tmodel.load_state_dict(interop.llama_params_from_jax(
        jax.tree_util.tree_map(np.asarray, params)))
    got = tllama.loss_fn(tmodel, torch.tensor(tokens))
    got.backward()
    return (float(loss), _leaves(grads), float(got.detach()), _leaves(
        interop.llama_params_to_jax({n: p.grad for n, p in
                                     tmodel.named_parameters()})))


MODELS = {"llama-tiny": functools.partial(_llama, False),
          "llama-moe-tiny": functools.partial(_llama, True)}


@pytest.mark.parametrize("name", sorted(MODELS))
def test_dots_gradients_match_jax_dots(name):
    want_loss, want, got_loss, got = MODELS[name]()
    np.testing.assert_allclose(got_loss, want_loss, rtol=RTOL)
    _assert_grads(got, want)


@pytest.fixture
def forward_calls(monkeypatch):
    """The plain flash forwards' calls (both layouts) from now on."""
    calls = {"flat": 0, "bhsd": 0}
    for layout, name in (("flat", "flash_fwd_plain"),
                         ("bhsd", "flash_bhsd_fwd_plain")):
        real = getattr(tattn, name)

        def counted(*a, _real=real, _layout=layout, **kw):
            calls[_layout] += 1
            return _real(*a, **kw)

        monkeypatch.setattr(tattn, name, counted)
    return calls


def _step(name: str, remat: dict):
    """One forward and backward of ``name`` (2 layers) with ``remat``."""
    gen = torch.Generator().manual_seed(0)
    if name.startswith("llama"):
        lib = tllama.tiny_moe if name == "llama-moe-tiny" else tllama.tiny
        model = tllama.Llama(lib(attention_impl="flash", **remat),
                             device="cpu")
        tllama.init_params(model, gen)
        loss = tllama.loss_fn(model, torch.tensor(_tokens()))
    elif name.startswith("bert"):
        impl = name.split(":")[1]
        model = tbert.Bert(tbert.tiny(attention_impl=impl, **remat),
                           device="cpu")
        tbert.init_params(model, gen)
        tokens = torch.tensor(_tokens() % 128)
        loss = tbert.mlm_loss(model, tokens, torch.ones(tokens.shape),
                              tokens)
    else:
        model = tvit.ViT(tvit.tiny(attention_impl="flash", **remat),
                         device="cpu")
        tvit.init_params(model, gen)
        images = torch.randn((2, 32, 32, 3), generator=gen)
        loss = tvit.loss_fn(model, images, torch.tensor([1, 2]))
    loss.backward()
    return model.config.n_layers


# model -> the layout its flash route counts in.
COUNTED = {"llama-tiny": "flat", "llama-moe-tiny": "flat",
           "bert-tiny:flash": "flat", "bert-tiny:flash-bhsd": "bhsd",
           "vit-tiny": "flat"}
POLICIES = {"none": ({"remat": False}, 1), "full": ({"remat": True}, 2),
            "dots": (DOTS, 1)}


@pytest.mark.parametrize("policy", sorted(POLICIES))
@pytest.mark.parametrize("name", sorted(COUNTED))
def test_flash_forward_runs_once_a_layer_under_dots(forward_calls, name,
                                                    policy):
    remat, per_layer = POLICIES[policy]
    if remat["remat"]:
        remat = {"remat_policy": "full", **remat}
    layers = _step(name, remat)
    assert forward_calls[COUNTED[name]] == per_layer * layers
    assert sum(forward_calls.values()) == per_layer * layers


def test_unknown_policies_are_refused():
    with pytest.raises(ValueError, match="'full' or 'dots'"):
        tllama.Llama(tllama.tiny(remat_policy="offload"), device="cpu")


def test_cmd_train_dots_matches_the_jax_trainer(monkeypatch, tmp_path,
                                                forward_calls):
    """llama-tiny with remat on in both packages (a config the CLI does
    not offer: every CLI-scale config has remat off), 3 AdamW steps of
    ``--remat-policy dots`` from the JAX init, the port's summary against
    the JAX trainer's curve at the world tests' rtol 1e-5; the flash
    forward ran once a layer a step."""
    from mpi_operator_tpu_torch.cmd import train
    from tests.test_torch_world import BASE, RTOL, _run_job, jax_reference

    for lib in (jllama, tllama):
        monkeypatch.setitem(lib.CONFIGS, "llama-tiny",
                            functools.partial(lib.tiny, remat=True))
    argv = ["--model", "llama-tiny", *BASE, "--remat-policy", "dots"]
    want, init = jax_reference(argv, "dp=1")
    path = str(tmp_path / "init.pt")
    torch.save(init, path)
    built = []
    real = train.llama_config_from_args
    monkeypatch.setattr(train, "llama_config_from_args",
                        lambda *a: built.append(real(*a)) or built[-1])
    line = _run_job({"argv": ["--device", "cpu", *argv],
                     "weights": path})["line"]
    assert [(c.remat, c.remat_policy) for c in built] == [(True, "dots")]
    np.testing.assert_allclose(line["first_loss"], want[0], rtol=RTOL)
    np.testing.assert_allclose(line["loss"], want[-1], rtol=RTOL)
    assert want[-1] < want[0]
    assert forward_calls == {"flat": 2 * 3, "bhsd": 0}
