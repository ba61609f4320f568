"""The port's ``cmd.eval`` against the JAX package's: one set of llama-tiny
f32 parameters (the JAX init, carried across by ``interop``), saved by
each package's own checkpoint manager, evaluated by each command on one
token file. Loss at rtol 1e-5 (the loss tolerance of
``tests/test_torch_llama.py``), perplexity at the same, and tokens and
batches exactly. Then determinism, and the refusals: bad arguments, a
missing checkpoint, an id outside the vocabulary, an sp mesh (JAX's
message), a mesh wider than the world, and ``cuda`` without a GPU.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

from mpi_operator_tpu.cmd import eval as jeval
from mpi_operator_tpu.models import llama as jllama
from mpi_operator_tpu.ops import attention as jattn
from mpi_operator_tpu.utils.checkpoint import (
    CheckpointManager as OrbaxCheckpointManager,
)
from mpi_operator_tpu_torch import interop
from mpi_operator_tpu_torch.cmd import eval as teval
from mpi_operator_tpu_torch.data import TokenDataset, write_token_file
from mpi_operator_tpu_torch.models import llama as tllama
from mpi_operator_tpu_torch.utils.checkpoint import CheckpointManager

pytestmark = pytest.mark.kernel
torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _reference_flat_path(monkeypatch):
    """The reference's ``_flat_pack`` reads ``os.environ`` but its module
    never imports ``os`` (see tests/test_torch_llama.py)."""
    monkeypatch.setattr(jattn, "os", os, raising=False)


@pytest.fixture
def corpus(tmp_path):
    path = tmp_path / "corpus.u32"
    write_token_file(path, np.random.RandomState(0).randint(0, 256, 4096))
    return str(path)


@pytest.fixture
def checkpoints(tmp_path):
    """(JAX dir, port dir): one llama-tiny parameter set at step 5."""
    model = jllama.Llama(jllama.tiny())
    params = jax.tree_util.tree_map(
        np.asarray, jllama.init_params(model, jax.random.PRNGKey(0)))
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "torch")
    mgr = OrbaxCheckpointManager(jdir)
    mgr.save(5, {"params": params}, force=True)
    mgr.close()
    CheckpointManager(tdir).save(
        5, {"params": interop.llama_params_from_jax(params)}, force=True)
    return jdir, tdir


def _line(capsys) -> dict:
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


EVAL_ARGS = ["--model", "llama-tiny", "--batch", "4", "--seq-len", "16"]


@pytest.mark.parametrize("extra", [["--batches", "3"], ["--batches", "2",
                                                         "--seed", "7"],
                                    ["--seq-len", "32"]])
def test_eval_matches_the_jax_command(capsys, corpus, checkpoints, extra):
    jdir, tdir = checkpoints
    argv = ["--data", corpus, *EVAL_ARGS, *extra]
    assert jeval.main(["--checkpoint-dir", jdir, *argv]) == 0
    want = _line(capsys)
    assert teval.main(["--checkpoint-dir", tdir, "--device", "cpu",
                       *argv]) == 0
    got = _line(capsys)
    assert got.keys() == want.keys()
    assert (got["step"], got["model"], got["batches"], got["tokens"]) == (
        want["step"], want["model"], want["batches"], want["tokens"])
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
    np.testing.assert_allclose(got["perplexity"], want["perplexity"],
                               rtol=1e-5)


def test_default_batches_are_one_epoch(capsys, corpus, checkpoints):
    _, tdir = checkpoints
    teval.main(["--checkpoint-dir", tdir, "--device", "cpu", "--data",
                corpus, *EVAL_ARGS])
    got = _line(capsys)
    assert got["batches"] == 4096 // 16 // 4
    assert got["tokens"] == got["batches"] * 4 * 15


def test_eval_is_deterministic_for_a_fixed_seed(capsys, corpus,
                                                checkpoints):
    _, tdir = checkpoints
    vals = []
    for _ in range(2):
        teval.main(["--checkpoint-dir", tdir, "--device", "cpu", "--data",
                    corpus, *EVAL_ARGS, "--batches", "2", "--seed", "7"])
        vals.append(_line(capsys))
    assert vals[0] == vals[1]


def test_evaluate_is_the_token_weighted_mean(corpus):
    """``evaluate`` against the per-batch losses weighted by their
    token counts, with no autograd graph left behind."""
    model = tllama.Llama(tllama.tiny(attention_impl="flash"), device="cpu")
    tllama.init_params(model, torch.Generator().manual_seed(0))
    ds = TokenDataset(corpus, 16)
    mean, tokens = teval.evaluate(model, ds, 4, 3, torch.device("cpu"))
    losses = [float(tllama.loss_fn(model, torch.as_tensor(
        ds.rows(b, 4, 0, 4).astype(np.int64)))) for b in range(3)]
    assert tokens == 3 * 4 * 15
    np.testing.assert_allclose(mean, np.mean(losses), rtol=1e-6)
    assert all(p.grad is None for p in model.parameters())


def test_refusals(tmp_path, corpus, checkpoints):
    _, tdir = checkpoints
    base = ["--device", "cpu", "--data", corpus, "--model", "llama-tiny"]
    cases = [
        (["--checkpoint-dir", tdir, "--batch", "0"], "--batch must be"),
        (["--checkpoint-dir", tdir, "--batches", "-1"], "--batches must be"),
        (["--checkpoint-dir", str(tmp_path / "none")], "no checkpoint"),
        (["--checkpoint-dir", tdir, "--model", "nope"], "unknown --model"),
        (["--checkpoint-dir", tdir, "--model", "llama-moe-tiny"],
         "does not fit --model llama-moe-tiny"),
        (["--checkpoint-dir", tdir, "--model", "llama-moe-tiny", "--mesh",
          "tp=2"], r"queue \(a\) item 13"),
        (["--checkpoint-dir", tdir, "--seq-len", "4096"],
         "exceeds the model context"),
        (["--checkpoint-dir", tdir, "--mesh", "sp=2"],
         "eval meshes take dp/fsdp/tp"),
        (["--checkpoint-dir", tdir, "--mesh", "dp=2"],
         "require 2 devices, have 1"),
    ]
    for extra, match in cases:
        with pytest.raises(SystemExit, match=match):
            teval.main([*base, *extra])


def test_ids_outside_the_vocabulary_refuse(tmp_path, checkpoints):
    _, tdir = checkpoints
    path = tmp_path / "wide.u32"
    write_token_file(path, np.full(4 * 16, 300))  # vocab is 256
    with pytest.raises(SystemExit, match="token id 300, outside the "
                                         "256-token vocabulary"):
        teval.main(["--device", "cpu", "--checkpoint-dir", tdir, "--data",
                    str(path), *EVAL_ARGS, "--batches", "1"])


def test_a_checkpoint_of_another_model_refuses(tmp_path, corpus):
    CheckpointManager(str(tmp_path / "c")).save(
        1, {"params": {"embed.weight": torch.zeros(8, 4)}}, force=True)
    with pytest.raises(SystemExit, match="does not fit --model llama-tiny"):
        teval.main(["--device", "cpu", "--checkpoint-dir",
                    str(tmp_path / "c"), "--data", corpus, *EVAL_ARGS])


def test_cuda_without_a_gpu_raises(corpus, checkpoints):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: cuda is not refused here")
    _, tdir = checkpoints
    assert teval.build_parser().parse_args(
        ["--checkpoint-dir", tdir, "--data", corpus]).device == "cuda"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        teval.main(["--checkpoint-dir", tdir, "--data", corpus, *EVAL_ARGS])
