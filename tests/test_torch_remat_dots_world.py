"""The ``dots`` remat policy across processes, f32 on the CPU over gloo.

llama-tiny / 4 layers on ``pp=2`` with remat and ``dots`` in every stage:
the loss and every gradient against JAX's ``make_pp_loss_fn`` under its
policy (``tests/test_torch_llama_pp.py``'s gang; the parity tests'
tolerances and ``tests/test_torch_remat_dots.py``'s). The ring and
Ulysses on an sp=2 gang: ``dots`` gives the no-remat run's loss and
gradients with its count of flash forwards (the ring's once a hop a
layer), where ``full`` runs them twice.
"""

import os

import numpy as np
import pytest
import torch

from mpi_operator_tpu.ops import attention as jattn
from tests.test_torch_remat_dots import DOTS, _assert_grads
from tests.test_torch_world import run_gang

pytestmark = pytest.mark.kernel
torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _reference_flat_path(monkeypatch):
    # The reference's _flat_pack reads os.environ; its module never
    # imports os (tests/test_torch_llama.py).
    monkeypatch.setattr(jattn, "os", os, raising=False)


def test_pipeline_stages_under_dots_match_jax(tmp_path, monkeypatch):
    from tests import test_torch_llama_pp as pp

    monkeypatch.setitem(pp.CASES, "dots",
                        dict(attention_impl="flash", **DOTS))
    loss, grads, ranks = pp.pp_gang(tmp_path, 2, ["dots"])["dots"]
    pp.assert_matches_jax(loss, grads, ranks, "dots pp=2")
    got = {k: np.asarray(v) for r in ranks for k, v in r["grads"].items()}
    _assert_grads(got, {k: v.numpy() for k, v in grads.items()})


def sp_step(impl: str, policy: str) -> dict:
    """Op job: one forward and backward of llama-tiny on this rank's
    positions of an sp=2 mesh with ``impl`` ('ring' or 'ulysses') and
    ``policy`` ('none': no remat): the loss, the gradients and the plain
    flash forward's calls."""
    from mpi_operator_tpu_torch.models import llama as tllama
    from mpi_operator_tpu_torch.ops import attention as tattn
    from mpi_operator_tpu_torch.parallel.mesh import create_mesh
    from mpi_operator_tpu_torch.parallel.sharding import local_positions

    mesh = create_mesh(device="cpu", sp=2)
    remat = ({"remat": False} if policy == "none"
             else {"remat": True, "remat_policy": policy})
    model = tllama.Llama(tllama.tiny(attention_impl=impl, **remat),
                         device="cpu", sp_group=mesh.submesh("sp").get_group())
    tllama.init_params(model, torch.Generator().manual_seed(0))
    tokens = torch.from_numpy(np.random.RandomState(1).randint(
        0, 256, (2, 16)))
    positions = torch.from_numpy(local_positions(16, mesh))
    calls, real = [0], tattn.flash_fwd_plain

    def counted(*a, **kw):
        calls[0] += 1
        return real(*a, **kw)

    tattn.flash_fwd_plain = counted
    try:
        logits = model(tokens[:, positions], positions=positions)
        loss = logits.square().mean()
        loss.backward()
    finally:
        tattn.flash_fwd_plain = real
    return {"loss": float(loss), "calls": calls[0],
            "grads": {n: p.grad.tolist() for n, p in model.named_parameters()}}


SP_POLICIES = ("none", "full", "dots")


@pytest.mark.parametrize("impl", ["ring", "ulysses"])
def test_sp_paths_under_dots_keep_the_flash_forward(impl):
    ranks = run_gang(2, [{"cmd": "op",
                          "fn": "tests.test_torch_remat_dots_world:sp_step",
                          "args": {"impl": impl, "policy": policy}}
                         for policy in SP_POLICIES])
    hops = 2 if impl == "ring" else 1  # a layer's flash calls
    for rank in ranks:
        none, full, dots = (r["line"] for r in rank)
        assert none["calls"] == dots["calls"] == 2 * hops
        assert full["calls"] == 2 * none["calls"]
        assert dots["loss"] == none["loss"]
        for name, g in none["grads"].items():
            np.testing.assert_allclose(dots["grads"][name], g, rtol=0,
                                       atol=1e-7, err_msg=name)
