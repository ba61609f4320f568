"""``cmd.generate --mesh`` on llama-tiny across processes, on the CPU over
gloo, against the JAX package's ``cmd.generate``.

One set of f32 parameters (the JAX init, carried across by ``interop``),
saved by each package's own checkpoint manager. The port decodes on
gangs of two processes (``dp=2``, ``tp=2``, ``fsdp=2``, and a batch of
three prompts that ``dp=2`` does not split) and of four (``tp=2,fsdp=2``
and ``tp=4``, whose tp does not divide the two kv heads: attention stays
whole on every tp rank). Every gang's lines equal JAX's one-device
command's and JAX's on its 8-device CPU mesh (the port's axes, dp filling
the rest), list for list; process 0 alone prints. The JAX command's
refusals of a decode mesh fire in its words, in both packages. The MoE
meshes are ``test_torch_generate_mesh_moe.py``'s; sampling and the
checkpoints of pp and ep runs ``test_torch_generate_mesh_ckpt.py``'s. The
spawn helper is ``tests/test_torch_world.py``'s.
"""

import json

import jax
import numpy as np
import pytest

from mpi_operator_tpu.cmd import generate as jgen_cmd
from mpi_operator_tpu.models import llama as jllama
from mpi_operator_tpu.utils.checkpoint import (
    CheckpointManager as OrbaxCheckpointManager,
)
from mpi_operator_tpu_torch import interop
from mpi_operator_tpu_torch.cmd import generate as gen_cmd
from mpi_operator_tpu_torch.utils.checkpoint import CheckpointManager
from tests.test_torch_world import run_gang

pytestmark = pytest.mark.kernel

PROMPTS = ["--prompt", "12,7,42", "--prompt", "3,9,27"]
THREE = [*PROMPTS, "--prompt", "200,1,5"]


def save_both(root, name: str, cfg, step: int = 3) -> tuple:
    """The JAX init (seed 0) of ``cfg`` saved by each package's manager:
    (JAX directory, the port's directory)."""
    params = jax.tree_util.tree_map(
        np.asarray, jllama.init_params(jllama.Llama(cfg),
                                       jax.random.PRNGKey(0)))
    jdir, tdir = str(root / f"jax-{name}"), str(root / f"torch-{name}")
    mgr = OrbaxCheckpointManager(jdir)
    mgr.save(step, {"params": params}, force=True)
    mgr.close()
    CheckpointManager(tdir).save(
        step, {"params": interop.llama_params_from_jax(params)}, force=True)
    return jdir, tdir


def jax_mesh(mesh: str) -> str:
    """The port's mesh on JAX's 8 CPU devices: dp takes what is left."""
    axes = [a for a in mesh.split(",") if not a.startswith("dp=")]
    return ",".join(["dp=-1", *axes])


def jax_lines(capsys, ckpt: str, name: str, extra: list,
              mesh: str = "") -> list:
    capsys.readouterr()
    argv = ["--checkpoint-dir", ckpt, "--model", name, "--max-new", "6",
            *extra, *(["--mesh", mesh] if mesh else [])]
    assert jgen_cmd.main(argv) == 0
    return [json.loads(line) for line in capsys.readouterr().out.splitlines()
            if line.startswith("{")]


def port_lines(capsys, ckpt: str, name: str, extra: list) -> list:
    """The port's command on one process, in this one."""
    capsys.readouterr()
    assert gen_cmd.main(["--device", "cpu", "--checkpoint-dir", ckpt,
                         "--model", name, "--max-new", "6", *extra]) == 0
    return [json.loads(line) for line in capsys.readouterr().out.splitlines()
            if line.startswith("{")]


def job(ckpt: str, name: str, mesh: str, extra: list) -> dict:
    return {"cmd": "generate", "argv": [
        "--device", "cpu", "--checkpoint-dir", ckpt, "--model", name,
        "--max-new", "6", "--mesh", mesh, *extra]}


def held(ranks: list, i: int) -> list:
    """Job ``i``'s lines from process 0, after checking that no other
    process printed."""
    assert all(rank[i]["lines"] == [] for rank in ranks[1:])
    return ranks[0][i]["lines"]


@pytest.fixture(scope="module")
def dense(tmp_path_factory):
    return save_both(tmp_path_factory.mktemp("mesh-dense"), "llama-tiny",
                     jllama.tiny())


# (mesh, prompts): the gangs of two processes.
TWO = [("dp=2", PROMPTS), ("tp=2", PROMPTS), ("fsdp=2", PROMPTS),
       ("dp=2", THREE)]
FOUR = [("tp=2,fsdp=2", PROMPTS), ("tp=4", PROMPTS)]


@pytest.mark.parametrize("n, arms", [(2, TWO), (4, FOUR)],
                         ids=["two-processes", "four-processes"])
def test_greedy_tokens_equal_jax_on_every_mesh(capsys, dense, n, arms):
    jdir, tdir = dense
    ranks = run_gang(n, [job(tdir, "llama-tiny", mesh, extra)
                         for mesh, extra in arms])
    one = {len(PROMPTS): jax_lines(capsys, jdir, "llama-tiny", PROMPTS),
           len(THREE): jax_lines(capsys, jdir, "llama-tiny", THREE)}
    for i, (mesh, extra) in enumerate(arms):
        got = held(ranks, i)
        assert got == one[len(extra)], mesh  # every key: step, tokens...
        assert got == jax_lines(capsys, jdir, "llama-tiny", extra,
                                jax_mesh(mesh)), mesh
        assert [line["prompt"] for line in got] == [
            [int(t) for t in p.split(",")] for p in extra[1::2]]


# The JAX command's refusals: (mesh, model, its words).
REFUSALS = {
    "pp": ("pp=2", "llama-tiny", "no decode-time meaning"),
    "tp-divides": ("tp=3", "llama-tiny", "must divide the sharded dims"),
    "ep-dense": ("ep=2", "llama-tiny", "needs an MoE model"),
    "ep-experts": ("ep=3", "llama-moe-tiny",
                   "4 experts not divisible by ep=3"),
}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_refuses_what_jax_refuses_in_its_words(tmp_path, dense, case):
    """Before the checkpoint is read (the port's directory does not
    exist) and before any world forms; JAX refuses on its 8 devices."""
    mesh, name, words = REFUSALS[case]
    jdir, _ = dense
    argv = ["--model", name, "--prompt", "1,2", "--mesh", mesh]
    with pytest.raises(SystemExit, match=words):
        gen_cmd.main(["--device", "cpu", "--checkpoint-dir",
                      str(tmp_path / "none"), *argv])
    if name == "llama-tiny":  # JAX reads the checkpoint first
        with pytest.raises(SystemExit, match=words):
            jgen_cmd.main(["--checkpoint-dir", jdir, *argv])


def test_help_offers_the_mesh(capsys):
    with pytest.raises(SystemExit):
        gen_cmd.main(["--help"])
    text = capsys.readouterr().out
    assert "dp, fsdp, tp and (MoE) ep" in text and "not ported" not in text
