"""How far ``tp=2`` departs from one device in bf16, in each package: the
measurement behind ROADMAP (c) 8, on the CPU.

llama-moe-tiny in bf16 on the dense attention route, one layer, 5 AdamW
steps at lr 3e-4 on a batch of 8 x 16 tokens, from the JAX init. JAX:
its model and train step jitted on one CPU device and on ``tp=2`` (its
sharding rules on two of its 8 devices, GSPMD's all-reduces). The port:
its trainer on one process and on a gang of two over gloo (attention by
DTensor's plan, whose partial outputs it sums in the compute dtype; the
experts' in f32), the config set in its table (the CLI offers no bf16
tiny model). Each package's departure is the last step's
``|loss(tp=2) - loss(one)| / loss(one)``; the port's may not exceed
twice JAX's plus 4e-3 (PERF.md §7 records the numbers).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mpi_operator_tpu.models import llama as jllama
from mpi_operator_tpu.parallel import create_mesh as jax_mesh
from mpi_operator_tpu.parallel import shard_params
from mpi_operator_tpu.parallel.accum import make_update_step
from mpi_operator_tpu_torch import interop
from mpi_operator_tpu_torch.models import llama as tllama
from tests.test_torch_world import _run_job, run_gang

pytestmark = pytest.mark.kernel

STEPS = 5
ARGV = ["--model", "llama-moe-tiny", "--global-batch", "8", "--seq-len",
        "16", "--steps", str(STEPS), "--warmup", "1", "--lr", "3e-4",
        "--seed", "3", "--log-every", "0", "--telemetry-every", "0",
        "--n-layers", "1"]
CONFIG = dict(attention_impl="dense", n_layers=1)


def _bf16_table() -> None:
    """``llama-moe-tiny`` in the port's config table as the bf16 config
    on the dense route (the trainer's own overrides kept but those)."""
    def tiny(**kw):
        return tllama.tiny_moe(**{**kw, **CONFIG, "dtype": torch.bfloat16})

    tllama.CONFIGS["llama-moe-tiny"] = tiny


def train_bf16(argv: list, weights: str) -> dict:
    """Op job: the port's ``cmd.train`` on the bf16 config, from the JAX
    init at ``weights``; its summary line."""
    _bf16_table()
    return _run_job({"argv": argv, "weights": weights})["line"]


def _jax_losses(params, n: int) -> list:
    """JAX's 5 steps on ``n`` CPU devices (tp=n)."""
    model = jllama.Llama(jllama.tiny_moe(dtype=jnp.bfloat16, **CONFIG))
    tokens = jnp.asarray(np.random.RandomState(3).randint(0, 256, (8, 16)))
    mesh = jax_mesh(devices=jax.devices()[:n], tp=n)
    params = shard_params(params, mesh,
                          rules=jllama.param_sharding_rules(mesh))
    optimizer = optax.adamw(3e-4)
    step = jax.jit(make_update_step(
        lambda p, t: jllama.loss_fn(model, p, t), optimizer))
    state, losses = optimizer.init(params), []
    with mesh:
        for _ in range(STEPS):
            params, state, loss = step(params, state, tokens)
            losses.append(float(loss))
    return losses


def test_tp2_departs_in_bf16_as_the_jax_model_does(monkeypatch, tmp_path):
    params = jax.tree_util.tree_map(np.asarray, jllama.init_params(
        jllama.Llama(jllama.tiny_moe(**CONFIG)), jax.random.PRNGKey(0)))
    jax_one, jax_tp = _jax_losses(params, 1), _jax_losses(params, 2)
    path = str(tmp_path / "init.pt")
    torch.save(interop.llama_params_from_jax(params), path)
    argv = ["--device", "cpu", *ARGV]
    monkeypatch.setitem(tllama.CONFIGS, "llama-moe-tiny",
                        tllama.CONFIGS["llama-moe-tiny"])
    one = train_bf16(argv, path)
    ranks = run_gang(2, [{"cmd": "op",
                          "fn": "tests.test_torch_tp_bf16:train_bf16",
                          "args": {"argv": [*argv, "--mesh", "tp=2"],
                                   "weights": path}}])
    tp = ranks[0][0]["line"]
    jax_dep = abs(jax_tp[-1] - jax_one[-1]) / jax_one[-1]
    port_dep = abs(tp["loss"] - one["loss"]) / one["loss"]
    print(f"bf16 llama-moe-tiny / 1 layer, {STEPS} steps at 3e-4: JAX one "
          f"{jax_one[-1]:.6f} tp=2 {jax_tp[-1]:.6f} ({jax_dep:.3e}); port "
          f"one {one['loss']:.6f} tp=2 {tp['loss']:.6f} ({port_dep:.3e})")
    assert jax_one[-1] < jax_one[0] and one["loss"] < one["first_loss"]
    assert port_dep <= 2 * jax_dep + 4e-3
