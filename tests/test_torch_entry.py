"""The port's compute entry points (``mpi_operator_tpu_torch/entry.py``)
against the JAX package's (``__graft_entry__.py``), on the CPU.

- ``utils/env.py:cpu_subprocess_env`` scrubs every world variable on its
  list, hides the card and pins one thread.
- ``entry(device="cpu")``: its inputs are the JAX entry's (shapes, dtypes,
  zeros), and its ``forward`` matches JAX's halves at the same inputs,
  drawn from numpy seeds: the ResNet half on ResNet-18 at 32x32 in f32
  (JAX's own compile check, ``tests/test_models.py``) with the JAX
  parameters carried over through ``interop``, against ``apply(train=
  False)`` at rtol 2e-5; the attention half on bf16 inputs of the entry's
  shapes against JAX's ``flash_attention_bshd`` in Pallas interpret mode
  at norm-relative 1e-2, the bf16 tolerance ``chip_smoke.py`` holds the
  kernels to (``tests/test_torch_attention_bf16.py``).
- ``dryrun_multichip(4, device="cpu")``: each composition's global
  first-step loss equals the JAX model's loss on the same global batch
  (the dryrun's numpy draws) and the port's initial parameters carried to
  JAX, on JAX's mesh of 4 CPU devices with the composition's axes. The
  tolerance is rtol 1e-5 (``tests/test_torch_world.py``'s, every Llama
  and MoE composition: f32 on both sides, only the order of the sums
  differs). ResNet-18 computes in bf16, which the two frameworks round at
  different points, so its loss is held three ways: to the port's own
  one-process loss at rtol 1e-5 (the sharded step is the unsharded one),
  the same two models in f32 to each other at rtol 1e-5 (the structure
  is JAX's), and the bf16 loss to JAX's bf16 model on one device at the
  first-step 2e-4 of ``tests/test_torch_world_resnet.py``. JAX's own bf16
  loss moves 3.9e-4 between one device and its 4-device mesh (4.262578
  against 4.260921 here), more than that tolerance, so the mesh's bf16
  value is not the one held.
- The sharding receipt raises, naming the rank, when a parameter the plan
  shards is left whole on purpose (a two-process world).
- ``dryrun_multichip(8, device="cpu")``, every composition including the
  ``n % 8 == 0`` ones, as an ``e2e`` test (JAX's is
  ``tests/test_models.py``'s).
"""

import os

import numpy as np
import pytest
import torch

from mpi_operator_tpu_torch import entry
from mpi_operator_tpu_torch.utils import env as env_lib
from tests.test_torch_world import run_gang

pytestmark = pytest.mark.kernel
torch.set_num_threads(2)

RTOL = 1e-5
RESNET_RTOL = 2e-4
ATT_NORM_REL_TOL = 1e-2


@pytest.fixture
def reference_os(monkeypatch):
    """The reference's flat attention path reads ``os.environ`` without
    importing ``os`` (ROADMAP (c), "Not port faults"): supply the module
    global for the duration of a test."""
    from mpi_operator_tpu.ops import attention as jattn

    monkeypatch.setattr(jattn, "os", os, raising=False)


# -- utils/env.py -----------------------------------------------------------

def test_cpu_subprocess_env_scrubs_every_world_variable(monkeypatch):
    for var in env_lib.WORLD_ENV_VARS:
        monkeypatch.setenv(var, "7")
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "0")
    monkeypatch.setenv("OMP_NUM_THREADS", "16")
    monkeypatch.setenv("DRYRUN_KEEP_ME", "kept")
    env = env_lib.cpu_subprocess_env()
    assert not set(env_lib.WORLD_ENV_VARS) & set(env)
    assert env["CUDA_VISIBLE_DEVICES"] == "" and env["OMP_NUM_THREADS"] == "1"
    assert env["DRYRUN_KEEP_ME"] == "kept"
    # A copy: the caller's environment keeps its world.
    assert os.environ["TPUJOB_PROCESS_ID"] == "7"
    assert {"TPUJOB_COORDINATOR_ADDRESS", "TPUJOB_NUM_PROCESSES",
            "TPUJOB_PROCESS_ID", "TPU_WORKER_ID", "MASTER_ADDR",
            "MASTER_PORT", "RANK", "WORLD_SIZE",
            "LOCAL_RANK"} <= set(env_lib.WORLD_ENV_VARS)


# -- entry() ----------------------------------------------------------------

@pytest.fixture(scope="module")
def cpu_entry():
    return entry.entry(device="cpu")


def test_entry_inputs_are_the_jax_entrys(cpu_entry):
    fn, (model, images, q, k, v) = cpu_entry
    assert fn is entry.forward and not model.training
    assert images.shape == (8, 3, 224, 224) and images.dtype == torch.float32
    assert images.is_contiguous(memory_format=torch.channels_last)
    assert q.shape == (2, 512, 8, 128) and k.shape == v.shape == (
        2, 512, 4, 128)
    assert {t.dtype for t in (q, k, v)} == {torch.bfloat16}
    assert all(t.device.type == "cpu" and not t.any()
               for t in (images, q, k, v))
    assert model.head.weight.shape == (1000, 2048)
    assert sum(p.numel() for p in model.parameters()) == 44_549_160


def test_entry_asks_for_the_card_unless_told_otherwise():
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the refusal needs a machine without")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry.entry()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry.dryrun_multichip(2)


def test_entry_resnet_half_matches_jax_apply(cpu_entry):
    import jax
    import jax.numpy as jnp

    from mpi_operator_tpu.models import resnet as jresnet
    from mpi_operator_tpu_torch import interop
    from mpi_operator_tpu_torch.models import resnet as tresnet

    jmodel = jresnet.resnet(18, num_classes=8, dtype=jnp.float32)
    params, stats = jresnet.create_train_state(
        jmodel, jax.random.PRNGKey(0), image_size=32, batch=1)
    # Running statistics away from their init, so eval mode reads them.
    stats = jax.tree_util.tree_map(
        lambda x: x + 0.1 * np.random.RandomState(x.size).rand(*x.shape)
        .astype(np.float32), stats)
    images = np.random.RandomState(0).standard_normal(
        (2, 32, 32, 3)).astype(np.float32)
    want = np.asarray(jmodel.apply({"params": params, "batch_stats": stats},
                                   jnp.asarray(images), train=False))

    model = tresnet.resnet(18, num_classes=8, dtype=torch.float32)
    model.load_state_dict(interop.resnet_params_from_jax(
        jax.tree_util.tree_map(np.asarray, params),
        jax.tree_util.tree_map(np.asarray, stats)))
    model.to(memory_format=torch.channels_last).eval()
    _, (_, _, q, k, v) = cpu_entry
    x = torch.tensor(images).permute(0, 3, 1, 2)
    logits, att = entry.forward(model, x, q[:, :16], k[:, :16], v[:, :16])
    np.testing.assert_allclose(logits.numpy(), want, rtol=2e-5, atol=1e-6)
    assert att.shape == (2, 16, 8, 128) and not att.any()


def test_entry_attention_half_matches_jax_interpret(cpu_entry, reference_os):
    import jax.numpy as jnp

    from mpi_operator_tpu.ops import attention as jattn

    _, (_, images, q0, k0, v0) = cpu_entry
    rng = np.random.RandomState(1)
    q, k, v = (torch.tensor(rng.standard_normal(t.shape).astype(np.float32))
               .to(torch.bfloat16) for t in (q0, k0, v0))

    class NoModel(torch.nn.Module):
        def forward(self, x):
            return x

    _, att = entry.forward(NoModel(), images[:1], q, k, v)
    want = np.asarray(jattn.flash_attention_bshd(
        *(jnp.asarray(t.float().numpy(), dtype=jnp.bfloat16)
          for t in (q, k, v)), causal=True)).astype(np.float64)
    got = att.float().numpy().astype(np.float64)
    assert att.dtype == torch.bfloat16 and att.shape == q.shape
    assert np.linalg.norm(got - want) / np.linalg.norm(want) \
        <= ATT_NORM_REL_TOL


# -- dryrun_multichip(4) against JAX ------------------------------------------

@pytest.fixture(scope="module")
def dryrun4():
    return {r["name"]: r for r in entry.dryrun_multichip(4, device="cpu")}


def test_dryrun_runs_every_composition_of_the_jax_dryrun(dryrun4):
    assert list(dryrun4) == [
        "llama dp x fsdp x tp x sp (ring)", "llama ulysses",
        "moe dp x ep x tp", "pipeline dp x fsdp x pp",
        "cross-slice dp x fsdp", "resnet dp x fsdp"]
    meshes = {name: r["mesh"] for name, r in dryrun4.items()}
    assert meshes["llama ulysses"] == {"dp": 1, "fsdp": 1, "tp": 2, "sp": 2}
    assert meshes["moe dp x ep x tp"] == {"dp": 1, "ep": 2, "tp": 2}
    assert meshes["pipeline dp x fsdp x pp"] == {"dp": 1, "pp": 2, "fsdp": 2}
    assert meshes["cross-slice dp x fsdp"] == {"dp": 2, "fsdp": 2}
    for r in dryrun4.values():
        assert np.isfinite(r["loss"]) and len(r["launches"]) == 4
        # Every rank holds parameters its plan shards; none whole.
        assert min(r["sharded"]) > 0, r["name"]
        # On the CPU the wrappers take the plain versions: no launch.
        assert not any(sum(c.values()) for c in r["launches"])


def _jax_loss(comp: entry.Composition, state: dict, arrays: tuple) -> float:
    """The JAX model's first loss for ``comp``: the port's initial
    parameters carried to JAX, the global batch, on JAX's mesh of the
    composition's axes over the first 4 CPU devices."""
    import dataclasses

    import jax
    import jax.numpy as jnp

    from mpi_operator_tpu.models import llama as jllama
    from mpi_operator_tpu.models import llama_pp as jpp
    from mpi_operator_tpu.parallel import create_mesh, shard_batch, shard_params
    from mpi_operator_tpu_torch import interop

    sizes = comp.sizes
    mesh = create_mesh(devices=jax.devices()[:int(np.prod(
        list(sizes.values())))], **sizes)
    make = jllama.tiny_moe if comp.moe else jllama.tiny
    cfg = make(**dict(comp.config))
    if comp.name == "moe x pp":
        # The JAX dryrun's own config: tiny_moe's default dense attention.
        cfg = dataclasses.replace(cfg, attention_impl="dense")
    tree = interop.llama_params_to_jax(state)
    seq_axis = 1 if sizes.get("sp", 1) > 1 else None
    tokens = shard_batch(jnp.asarray(arrays[0], jnp.int32), mesh,
                         sequence_axis=seq_axis)
    if comp.model == "llama_pp":
        pp = sizes["pp"]
        params = jpp.shard_pp_params(
            jpp.pp_params_from_init(tree, cfg, pp), mesh)
        fn = jpp.make_pp_loss_fn(cfg, mesh, comp.batch // comp.microbatches)
    else:
        model = jllama.Llama(cfg, mesh=mesh)
        params = shard_params(tree, mesh,
                              rules=jllama.param_sharding_rules(mesh))

        def fn(params, tokens):
            return jllama.loss_fn(model, params, tokens)

    with mesh:
        return float(jax.jit(fn)(params, tokens))


@pytest.mark.parametrize("index", range(5))
def test_dryrun_first_loss_equals_the_jax_models(dryrun4, reference_os,
                                                 index):
    comp = entry.compositions(4)[index]
    assert comp.model != "resnet"
    want = _jax_loss(comp, entry.initial_state(comp),
                     entry.global_batch(comp))
    np.testing.assert_allclose(dryrun4[comp.name]["loss"], want, rtol=RTOL)


def _resnet_losses(comp, dtype) -> tuple:
    """(the port's, JAX's) train-mode first loss of ResNet-18 in ``dtype``
    on one process / device, from the dryrun's initial parameters and
    global batch."""
    import jax
    import jax.numpy as jnp

    from mpi_operator_tpu.models import resnet as jresnet
    from mpi_operator_tpu_torch import interop
    from mpi_operator_tpu_torch.models import resnet as tresnet

    state = entry.initial_state(comp)
    images, labels = entry.global_batch(comp)
    model = tresnet.resnet(18, num_classes=64, dtype=dtype)
    model.load_state_dict(state)
    model.to(memory_format=torch.channels_last).train()
    with torch.no_grad():
        ours = float(tresnet.loss_fn(
            model, torch.tensor(images).permute(0, 3, 1, 2),
            torch.tensor(labels)))
    jmodel = jresnet.resnet(18, num_classes=64, dtype={
        torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}[dtype])
    params, stats = interop.resnet_params_to_jax(state)
    logits, _ = jmodel.apply({"params": params, "batch_stats": stats},
                             jnp.asarray(images), train=True,
                             mutable=["batch_stats"])
    one_hot = jax.nn.one_hot(labels, 64)
    theirs = float(-jnp.mean(jnp.sum(one_hot * jax.nn.log_softmax(logits),
                                     axis=-1)))
    return ours, theirs


def test_dryrun_resnet_loss_is_the_one_process_loss_and_jaxs(dryrun4):
    comp = entry.compositions(4)[5]
    assert comp.model == "resnet"
    got = dryrun4[comp.name]["loss"]
    ours, theirs = _resnet_losses(comp, torch.bfloat16)
    np.testing.assert_allclose(got, ours, rtol=RTOL)
    np.testing.assert_allclose(got, theirs, rtol=RESNET_RTOL)
    ours32, theirs32 = _resnet_losses(comp, torch.float32)
    np.testing.assert_allclose(ours32, theirs32, rtol=RTOL)


# -- the sharding receipt ---------------------------------------------------

def left_whole(broken_rank: int) -> dict:
    """An op job in a world of two: the Llama of the cross-slice
    composition laid out on ``fsdp=2`` and the pipeline's stages on
    ``pp=2``, each held to its plan; then on ``broken_rank`` one parameter
    FSDP2 shards is put back whole and its stage given the other stage's
    first layer. This rank's receipt problems, before and after."""
    from mpi_operator_tpu_torch.models import llama
    from mpi_operator_tpu_torch.parallel.mesh import MeshConfig, create_mesh

    out = {}
    for comp in (
            entry.Composition("fsdp", (("fsdp", 2),), "llama",
                              (("attention_impl", "flash"),), batch=4),
            entry.Composition("pp", (("pp", 2),), "llama_pp",
                              (("attention_impl", "flash"),), batch=4,
                              microbatches=2)):
        state = entry.initial_state(comp)
        mesh = create_mesh("cpu", MeshConfig(comp.mesh))
        model, _, _, whole, names = entry._build(comp, mesh, state)
        placements = entry.planned_placements(model, mesh, whole)
        shapes = {k: v.shape for k, v in state.items()}
        out[f"{comp.name} before"] = entry.sharding_receipt(
            model, mesh, shapes, placements, names)
        if int(os.environ["TPUJOB_PROCESS_ID"]) == broken_rank:
            if comp.name == "fsdp":
                model.final_norm.register_parameter("scale", torch.nn.Parameter(
                    state["final_norm.scale"].clone()))
            else:
                other = 1 - mesh.coordinate("pp")
                model.add_module(f"layer_{other}",
                                 llama.Block(comp.llama_config()))
        out[f"{comp.name} after"] = entry.sharding_receipt(
            model, mesh, shapes, placements, names)
    return out


def test_the_receipt_raises_on_a_parameter_left_whole():
    ranks = [r[0]["line"] for r in run_gang(
        2, [{"cmd": "op", "fn": "tests.test_torch_entry:left_whole",
             "args": {"broken_rank": 1}}])]
    for got in ranks:
        assert got["fsdp before"] == got["pp before"] == []
    assert ranks[0]["fsdp after"] == ranks[0]["pp after"] == []
    assert ranks[1]["fsdp after"] == [
        "final_norm.scale whole [64] where the plan keeps [32]"]
    assert ranks[1]["pp after"][0] == "layer_0.attn.wk.weight held outside " \
        "its stage"
    with pytest.raises(RuntimeError) as err:
        entry.check_receipts([[{"name": "fsdp", "receipt": r["fsdp after"]}]
                              for r in ranks])
    assert str(err.value) == (
        "dryrun_multichip: sharding receipt failed on rank 1 in 'fsdp': "
        "final_norm.scale whole [64] where the plan keeps [32]")


# -- dryrun_multichip(8) ------------------------------------------------------

@pytest.mark.e2e
def test_dryrun_multichip_8():
    results = entry.dryrun_multichip(8, device="cpu")
    assert [r["name"] for r in results] == [
        c.name for c in entry.compositions(8)]
    assert {"sp x tp x pp ring", "moe x pp"} <= {r["name"] for r in results}
    by = {r["name"]: r for r in results}
    assert by["sp x tp x pp ring"]["mesh"] == {"dp": 1, "pp": 2, "tp": 2,
                                                "sp": 2}
    assert by["cross-slice dp x fsdp"]["mesh"] == {"dp": 2, "fsdp": 4}
    for r in results:
        assert np.isfinite(r["loss"]) and len(r["launches"]) == 8
        assert min(r["sharded"]) > 0, r["name"]
