"""The port's pipelined Llama (``models/llama_pp.py``) against the JAX
package's, on carried-across weights.

llama-tiny with 4 layers in f32 (JAX's kernels in interpret mode, the
port's plain versions on the CPU): the stage-stacking functions on the
same parameters; the pipelined loss and every parameter's gradient on
``pp=2`` and ``pp=4`` gloo processes (``run_gang``, one op job a case)
against JAX's ``make_pp_loss_fn`` on as many CPU devices, with remat,
tied embeddings (a tiny config built so: none ships tied) and the
``flash-bhsd`` route; llama-moe-tiny's router loss through the pipeline
and through the one-stage schedule, normalized as JAX's sequential
fallback normalizes it; the JAX refusals. Loss rtol 1e-5, gradients atol
2e-5 (``tests/test_torch_llama.py``'s).
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
from tests.test_torch_world import run_gang

pytestmark = pytest.mark.kernel

B, S, MB = 8, 16, 2
GRAD_ATOL = 2e-5
# name -> config overrides; the pp sizes each runs on are its file's:
# this one pp=2 flash and remat, ``test_torch_llama_pp_variants.py``
# tied, flash-bhsd and MoE, ``test_torch_llama_pp4.py`` pp=4.
CASES = {
    "flash": dict(attention_impl="flash"),
    "remat": dict(attention_impl="flash", remat=True),
    "tied": dict(attention_impl="flash", tie_embeddings=True),
    "flash-bhsd": dict(attention_impl="flash-bhsd"),
    "moe": dict(attention_impl="flash", n_experts=4, moe_top_k=2),
}
RUNS = [(2, "flash"), (2, "remat")]


@pytest.fixture(autouse=True)
def _reference_flat_path(monkeypatch):
    # The reference's _flat_pack reads os.environ; its module never
    # imports os (tests/test_torch_llama.py).
    monkeypatch.setattr(jattn, "os", os, raising=False)


def _tokens():
    return np.random.RandomState(0).randint(0, 256, (B, S)).astype(np.int32)


def _jax_params(cfg):
    return jllama.init_params(jllama.Llama(cfg), jax.random.PRNGKey(0))


def _jax_cfg(kw):
    return jllama.tiny(n_layers=4, **kw)


def port_stage(n: int, kw: dict, weights: str) -> dict:
    """One rank's stage (an op job): its loss and every parameter's
    gradient, by the plain model's names."""
    mesh = tmesh.create_mesh(device="cpu", pp=n)
    cfg = tllama.tiny(n_layers=4, **kw)
    stage = tpp.LlamaStage(cfg, mesh.coordinate("pp"), n, device="cpu")
    state = torch.load(weights)
    stage.load_state_dict({k: state[k] for k in stage.state_dict()})
    loss = tpp.forward_backward(stage, mesh, torch.from_numpy(_tokens()),
                                B // MB)
    return {"loss": float(loss),
            "grads": {k: p.grad.tolist() for k, p in stage.named_parameters()}}


def pp_gang(tmp, n: int, names: list) -> dict:
    """case -> (JAX loss, JAX grads by port name, every rank's result):
    the cases ``names`` on ``n`` ranks, one gang."""
    jobs, want = [], {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jattn, "os", os, raising=False)
        for name in names:
            cfg = _jax_cfg(CASES[name])
            params = _jax_params(cfg)
            path = str(tmp / f"{name}.pt")
            torch.save(interop.llama_params_from_jax(
                jax.tree_util.tree_map(np.asarray, params)), path)
            mesh = jax_mesh(devices=jax.devices()[:n], pp=n)
            loss_fn = jpp.make_pp_loss_fn(cfg, mesh, microbatch_size=MB)
            with mesh:
                loss, grads = jax.jit(jax.value_and_grad(loss_fn))(
                    jpp.pp_params_from_init(params, cfg, n),
                    jnp.asarray(_tokens()))
            want[name] = (float(loss), interop.llama_pp_params_from_jax(
                jax.tree_util.tree_map(np.asarray, grads)))
            jobs.append({"cmd": "op",
                         "fn": "tests.test_torch_llama_pp:port_stage",
                         "args": {"n": n, "kw": CASES[name],
                                  "weights": path}})
    ranks = run_gang(n, jobs)
    return {name: (*want[name], [r[i]["line"] for r in ranks])
            for i, name in enumerate(names)}


def assert_matches_jax(loss, grads, ranks, label: str) -> None:
    seen = set()
    for r in ranks:
        # Every rank reads the global loss.
        np.testing.assert_allclose(r["loss"], loss, rtol=1e-5)
        for name, g in r["grads"].items():
            np.testing.assert_allclose(np.asarray(g), grads[name].numpy(),
                                       atol=GRAD_ATOL, rtol=1e-4,
                                       err_msg=f"{label} {name}")
            seen.add(name)
    # The stages hold every parameter between them.
    assert seen == set(grads)


@pytest.fixture(scope="module")
def gang(tmp_path_factory):
    return pp_gang(tmp_path_factory.mktemp("pp2"), 2,
                   [name for _, name in RUNS])


@pytest.mark.parametrize("n,case", RUNS)
def test_pp_loss_and_gradients_match_jax(gang, n, case):
    assert_matches_jax(*gang[case], f"{case} pp={n}")


def test_stacking_matches_jax():
    cfg = _jax_cfg(dict(attention_impl="dense"))
    params = jax.tree_util.tree_map(np.asarray, _jax_params(cfg))
    state = interop.llama_params_from_jax(params)
    for n in (1, 2, 4):
        got = tpp.pp_params_from_init(state, tllama.tiny(n_layers=4), n)
        want = jpp.pp_params_from_init(params, cfg, n)
        # The JAX stacked blocks, carried across leaf by leaf.
        assert tpp.unstack_block_params(got["blocks"]).keys() == {
            k for k in state if k.startswith("layer_")}
        carried = interop.llama_pp_params_from_jax(
            jax.tree_util.tree_map(np.asarray, want))
        for k, v in tpp.unstack_block_params(got["blocks"]).items():
            torch.testing.assert_close(v, carried[k], rtol=0, atol=0)
        wq = got["blocks"]["attn.wq.weight"]
        assert wq.shape == (n, 4 // n, 64, 64)
        np.testing.assert_array_equal(
            wq.numpy(), np.swapaxes(np.asarray(
                want["blocks"]["attn"]["wq"]["kernel"]), -1, -2))
        # Restacking onto another pp size is JAX's reshape.
        for m in (1, 2, 4):
            re = tpp.restack_block_params(got["blocks"], m)
            jre = jpp.restack_block_params(want["blocks"], m)
            np.testing.assert_array_equal(
                re["mlp.w_up.weight"].numpy(), np.swapaxes(np.asarray(
                    jre["mlp"]["w_up"]["kernel"]), -1, -2))
    with pytest.raises(ValueError, match="not divisible"):
        tpp.restack_block_params(got["blocks"], 3)
    with pytest.raises(ValueError, match="not divisible"):
        tpp.stack_block_params({}, 5, 4)


def test_init_pp_params_is_the_plain_init():
    cfg = tllama.tiny(n_layers=4)
    got = tpp.init_pp_params(cfg, 2, torch.Generator().manual_seed(3))
    plain = tllama.init_params(tllama.Llama(cfg),
                               torch.Generator().manual_seed(3)).state_dict()
    for k, v in tpp.unstack_block_params(got.pop("blocks")).items():
        torch.testing.assert_close(v, plain[k], rtol=0, atol=0)
    for k, v in got.items():
        torch.testing.assert_close(v, plain[k], rtol=0, atol=0)


@pytest.mark.parametrize("n", [1, 2, 4])
def test_each_stage_draws_its_part_of_the_plain_init(n):
    cfg = tllama.tiny(n_layers=4, tie_embeddings=n == 4)
    plain = tllama.init_params(tllama.Llama(cfg),
                               torch.Generator().manual_seed(5)).state_dict()
    held = set()
    for i in range(n):
        stage = tpp.init_stage_params(tpp.LlamaStage(cfg, i, n),
                                      torch.Generator().manual_seed(5))
        for k, v in stage.state_dict().items():
            torch.testing.assert_close(v, plain[k], rtol=0, atol=0)
            held.add(k)
    assert held == set(plain)


def _refusal(fn, cfg, mesh):
    with pytest.raises(ValueError) as e:
        fn(cfg, mesh)
    return str(e.value)


PP_MESHES = {
    "moe-fsdp": (dict(n_experts=4), dict(fsdp=2, ep=2, pp=2)),
    "moe-sp": (dict(n_experts=4, attention_impl="ring"), dict(sp=2, ep=2,
                                                              pp=2)),
    "sp-local": (dict(attention_impl="flash"), dict(dp=2, sp=2, pp=2)),
    "impl": (dict(attention_impl="splash"), dict(pp=2)),
    "ring-no-sp": (dict(attention_impl="ring"), dict(pp=2)),
    "zigzag": (dict(attention_impl="ring", zigzag_ring=True,
                    max_seq_len=20), dict(sp=4, pp=2)),
}


@pytest.mark.parametrize("name", sorted(PP_MESHES))
def test_refusals_are_the_jax_messages(name):
    kw, sizes = PP_MESHES[name]
    n = int(np.prod(list(sizes.values())))
    want = _refusal(lambda c, m: jpp.make_pp_loss_fn(c, m, MB),
                    jllama.tiny(n_layers=4, **kw),
                    jax_mesh(devices=jax.devices()[:n], **sizes))
    mesh = tmesh.Mesh(tuple(sizes), tuple(sizes.values()),
                      torch.device("cpu"))
    got = _refusal(tpp.check_pp_config, tllama.tiny(n_layers=4, **kw), mesh)
    assert got == want
