"""Pipelined checkpoints, ``--data`` and the readers on a ``pp`` mesh, on
the CPU over gloo.

- **``--data``**: llama-tiny on ``pp=2`` from a token file against the
  JAX trainer on the same mesh (each rank its rows of each microbatch of
  the Feistel stream), first and third losses at rtol 1e-5.
- **Resume on any pp size**: llama-tiny with 4 layers saved on ``pp=2``
  at step 3 and resumed to 6 by one process and by ``pp=4``; saved by one
  process and resumed on ``pp=2``. Each equals a straight one-process run
  to 6: the loss at rtol 1e-5, every parameter at rtol 1e-5, atol 1e-6
  (the resume tests' tolerance) plus twice the distance between straight
  runs on one process and on ``pp=2`` (the pipeline sums a gradient over
  its microbatches in another order, and AdamW's first steps carry the
  sign of a near-zero gradient). A stage writes its layers under their
  global names, and a stage of another pp size reads the layers it now
  holds, with their AdamW moments.
- **The readers**: ``cmd.eval`` on a ``pp=2`` checkpoint gives the loss
  of the same training on one process (rtol 1e-5), and ``cmd.generate``
  decodes it to the greedy tokens of JAX's ``generate`` on the
  checkpoint's parameters.
"""

import contextlib
import io
import json
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mpi_operator_tpu.models import generate as jgen
from mpi_operator_tpu.models import llama as jllama
from mpi_operator_tpu_torch import interop
from mpi_operator_tpu_torch.cmd import generate as gen_cmd
from mpi_operator_tpu_torch.utils.checkpoint import read_llama_params
from tests.test_torch_world import (
    MODELS,
    _run_job,
    assert_matches_jax,
    compare_to_jax,
    run_gang,
)
from tests.test_torch_world_resume import ATOL, QUIET, RTOL, _corpus, _params

pytestmark = pytest.mark.kernel

LLAMA = [*QUIET, "--model", "llama-tiny", "--global-batch", "8",
         "--seq-len", "16", "--lr", "1e-2", "--save-every", "1"]
LLAMA4 = [*LLAMA, "--n-layers", "4"]


def test_pp_trains_from_a_token_file(tmp_path):
    # One global batch of sequences: each step an epoch of the same rows,
    # so the curve falls as on the synthetic batch.
    data = _corpus(tmp_path / "corpus.u32", 8, 16)
    got = compare_to_jax(tmp_path, "pp=2", "pp=2", 2,
                         models={"llama-tiny": MODELS["llama-tiny"]},
                         extra=["--data", data])
    assert_matches_jax(*got["llama-tiny"], 2)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The checkpoint directories, each run's summary line by name."""
    tmp = tmp_path_factory.mktemp("pp_resume")
    d = {k: str(tmp / k) for k in ("straight", "straight_pp2", "pp2",
                                   "pp1", "pp2to4", "straight2", "eval2")}
    lines = {
        "straight": _run_job({"argv": [*LLAMA4, "--steps", "6",
                                       "--checkpoint-dir", d["straight"]]}),
        "pp1": _run_job({"argv": [*LLAMA4, "--steps", "3",
                                  "--checkpoint-dir", d["pp1"]]}),
        "straight2": _run_job({"argv": [*LLAMA, "--steps", "3",
                                        "--checkpoint-dir",
                                        d["straight2"]]}),
    }
    pp2 = ["--mesh", "pp=2"]
    ranks = run_gang(2, [
        {"argv": [*LLAMA4, *pp2, "--steps", "3", "--checkpoint-dir",
                  d["pp2"]]},
        {"argv": [*LLAMA4, *pp2, "--steps", "6", "--checkpoint-dir",
                  d["pp1"]]},
        {"argv": [*LLAMA, *pp2, "--steps", "3", "--checkpoint-dir",
                  d["eval2"]]},
        {"argv": [*LLAMA4, *pp2, "--steps", "6", "--checkpoint-dir",
                  d["straight_pp2"]]},
    ])
    lines["pp1->pp2"] = [r[1]["line"] for r in ranks]
    shutil.copytree(d["pp2"], d["pp2to4"])
    lines["pp2->pp1"] = _run_job({"argv": [*LLAMA4, "--steps", "6",
                                           "--checkpoint-dir", d["pp2"]]})
    ranks = run_gang(4, [{"argv": [*LLAMA4, "--mesh", "pp=4", "--steps",
                                   "6", "--checkpoint-dir", d["pp2to4"]]}])
    lines["pp2->pp4"] = [r[0]["line"] for r in ranks]
    return d, lines


@pytest.mark.parametrize("move,directory", [
    ("pp2->pp1", "pp2"), ("pp1->pp2", "pp1"), ("pp2->pp4", "pp2to4")])
def test_pp_checkpoints_resume_on_any_pp_size(runs, move, directory):
    d, lines = runs
    want = lines["straight"]["line"]
    got = lines[move]
    for line in (got if isinstance(got, list) else [got["line"]]):
        assert (line["final_step"], line["steps"]) == (6, 3)
        np.testing.assert_allclose(line["loss"], want["loss"], rtol=RTOL)
    straight, moved = _params(d["straight"], 6), _params(d[directory], 6)
    other = _params(d["straight_pp2"], 6)
    assert moved.keys() == straight.keys() == other.keys()
    for k in straight:
        want = straight[k].numpy()
        spread = np.abs(other[k].numpy() - want)
        err = np.abs(moved[k].numpy() - want)
        assert np.all(err <= ATOL + RTOL * np.abs(want) + 2 * spread), k


def test_eval_reads_a_pp_checkpoint(runs, tmp_path):
    d, _ = runs
    data = _corpus(tmp_path / "corpus.u32", 12, 16)
    evals = ["--device", "cpu", "--data", data, "--model", "llama-tiny",
             "--batch", "4", "--batches", "3", "--seq-len", "16"]
    got = _run_job({"cmd": "eval", "argv": [*evals, "--checkpoint-dir",
                                            d["eval2"]]})["line"]
    want = _run_job({"cmd": "eval", "argv": [*evals, "--checkpoint-dir",
                                             d["straight2"]]})["line"]
    assert got["step"] == want["step"] == 3
    assert got["tokens"] == want["tokens"]
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=RTOL)


def test_generate_decodes_a_pp_checkpoint_as_jax(runs):
    d, _ = runs
    prompts = [[12, 7, 42], [3, 9, 27]]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert gen_cmd.main(["--device", "cpu", "--checkpoint-dir",
                             d["eval2"], "--model", "llama-tiny",
                             "--max-new", "6", "--prompt", "12,7,42",
                             "--prompt", "3,9,27"]) == 0
    lines = [json.loads(x) for x in buf.getvalue().splitlines()]
    _, params = read_llama_params(d["eval2"], "llama-tiny")
    tree = jax.tree_util.tree_map(
        jnp.asarray, interop.llama_params_to_jax(params))
    want = jgen.generate(tree, jnp.asarray(prompts, jnp.int32),
                         jllama.tiny(attention_impl="flash"), max_new=6)
    assert [line["tokens"] for line in lines] == np.asarray(want).tolist()
    assert all(line["step"] == 3 for line in lines)
