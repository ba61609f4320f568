"""``cmd.eval`` on the MoE Llama across processes, on the CPU over gloo,
against the JAX package's ``cmd.eval``: one set of llama-moe-tiny f32
parameters (the JAX init, carried across by ``interop``), saved by each
package's own checkpoint manager and evaluated on one token file; the
port on two processes with ``--mesh tp=2`` (attention by head, each rank
half of every expert's hidden dim) and ``--mesh fsdp=2`` (FSDP2, the
batch split), JAX on its 8-device CPU mesh with ``dp=-1,tp=2``. Process
0 alone prints; loss and perplexity at rtol 1e-5 (the eval tests'
tolerance), tokens, batches and step exactly. The spawn helper is
``tests/test_torch_world.py``'s.
"""

import json
import os

import jax
import numpy as np
import pytest

from mpi_operator_tpu.cmd import eval as jeval
from mpi_operator_tpu.models import llama as jllama
from mpi_operator_tpu.ops import attention as jattn
from mpi_operator_tpu.utils.checkpoint import (
    CheckpointManager as OrbaxCheckpointManager,
)
from mpi_operator_tpu_torch import interop
from mpi_operator_tpu_torch.data import write_token_file
from mpi_operator_tpu_torch.utils.checkpoint import CheckpointManager
from tests.test_torch_world import run_gang

pytestmark = pytest.mark.kernel

EVAL_ARGS = ["--model", "llama-moe-tiny", "--batch", "4", "--batches", "3",
             "--seq-len", "16"]


def test_moe_eval_on_tp_and_fsdp_matches_the_jax_command(
        tmp_path, capsys, monkeypatch):
    # The reference's _flat_pack reads os.environ, but its module never
    # imports os (tests/test_torch_llama.py): supply the global.
    monkeypatch.setattr(jattn, "os", os, raising=False)
    corpus = str(tmp_path / "corpus.u32")
    write_token_file(corpus, np.random.RandomState(0).randint(0, 256, 4096))
    model = jllama.Llama(jllama.tiny_moe())
    params = jax.tree_util.tree_map(
        np.asarray, jllama.init_params(model, jax.random.PRNGKey(0)))
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "torch")
    mgr = OrbaxCheckpointManager(jdir)
    mgr.save(5, {"params": params}, force=True)
    mgr.close()
    CheckpointManager(tdir).save(
        5, {"params": interop.llama_params_from_jax(params)}, force=True)

    argv = ["--data", corpus, *EVAL_ARGS]
    assert jeval.main(["--checkpoint-dir", jdir, *argv, "--mesh",
                       "dp=-1,tp=2"]) == 0
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    meshes = ("tp=2", "fsdp=2")
    ranks = run_gang(2, [{"cmd": "eval", "argv": [
        "--device", "cpu", "--checkpoint-dir", tdir, *argv, "--mesh", mesh]}
        for mesh in meshes])
    for i, mesh in enumerate(meshes):
        assert ranks[1][i]["line"] is None  # process 0 alone prints
        got = ranks[0][i]["line"]
        assert got.keys() == want.keys()
        assert (got["step"], got["model"], got["batches"], got["tokens"]) == (
            want["step"], want["model"], want["batches"], want["tokens"])
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5,
                                   err_msg=mesh)
        np.testing.assert_allclose(got["perplexity"], want["perplexity"],
                                   rtol=1e-5, err_msg=mesh)
