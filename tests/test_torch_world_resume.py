"""Checkpoints and eval across processes, on the CPU over gloo.

- **SIGTERM on one rank.** Two processes, ``--mesh dp=2``, llama-tiny on
  a token file under a cosine schedule: rank 1 alone is preempted after
  its second step. Both ranks stop at step 2, one committed step is
  published (by the async manager's writers, drained by the final save),
  ``main`` returns 0 on both with ``preempted`` true; the rerun resumes
  to the absolute ``--steps 6`` and equals a straight run (sync manager)
  to 6 (loss and every parameter at rtol 1e-5, atol 1e-6: the JAX resume
  test's tolerance, as in ``tests/test_torch_resume.py``).
- **Resume onto another mesh** (``tests/test_train.py``
  ``test_resume_onto_different_mesh``): bert-tiny saved sharded by two
  processes with ``--mesh fsdp=2`` at step 2, resumed by one process to
  step 4, and by two ``fsdp=2`` processes again to step 6: the same loss
  as a straight one-process run to 6 at rtol 1e-5.
- **Eval** (``tests/test_eval.py`` ``TestEvalMultiProcess``): ``cmd.eval``
  on two processes with ``--mesh dp=2``, ``fsdp=2`` and ``tp=2`` on the
  checkpoint the pair wrote: one JSON line (process 0's), the
  one-process loss at rtol 1e-5 and the same token count.

The spawn helper is ``tests/test_torch_world.py``'s.
"""

import numpy as np
import pytest
import torch

from tests.test_torch_world import _run_job, run_gang

pytestmark = pytest.mark.kernel
torch.set_num_threads(2)

QUIET = ["--device", "cpu", "--warmup", "1", "--log-every", "0",
         "--telemetry-every", "0"]
RTOL, ATOL = 1e-5, 1e-6


def _corpus(path, n_seq: int, seq_len: int) -> str:
    from mpi_operator_tpu_torch.data import write_token_file

    write_token_file(path, np.random.RandomState(0).randint(
        0, 256, n_seq * seq_len))
    return str(path)


def _params(directory: str, step: int) -> dict:
    from mpi_operator_tpu_torch.utils.checkpoint import (
        CheckpointManager,
        committed_steps,
    )

    assert step in committed_steps(directory)
    got, state = CheckpointManager(directory).read_latest()
    assert got == step
    return state["params"]


def test_sigterm_on_one_rank_resume_and_eval(tmp_path):
    data = _corpus(tmp_path / "corpus.u32", 12, 16)
    llama = [*QUIET, "--model", "llama-tiny", "--mesh", "dp=2",
             "--global-batch", "4", "--seq-len", "16", "--data", data,
             "--lr", "1e-2", "--lr-schedule", "cosine", "--warmup-steps",
             "2", "--save-every", "100"]
    straight, preempted = str(tmp_path / "straight"), str(tmp_path / "pre")
    evals = ["--data", data, "--model", "llama-tiny", "--batch", "4",
             "--batches", "3", "--seq-len", "16", "--checkpoint-dir",
             preempted]
    jobs = [
        {"argv": [*llama, "--steps", "6", "--checkpoint-dir", straight]},
        {"argv": [*llama, "--steps", "6", "--checkpoint-dir", preempted,
                  "--async-checkpoint"], "sigterm": [1, 2]},
        {"argv": [*llama, "--steps", "6", "--checkpoint-dir", preempted,
                  "--async-checkpoint"]},
        *({"cmd": "eval", "argv": ["--device", "cpu", *evals, "--mesh", m]}
          for m in ("dp=2", "fsdp=2", "tp=2")),
    ]
    ranks = run_gang(2, jobs)
    (s0, s1), (p0, p1), (r0, r1) = ([r[i]["line"] for r in ranks]
                                    for i in range(3))
    # Rank 1 alone got SIGTERM; both stopped at its step, saved it once.
    for line in (p0, p1):
        assert line["preempted"] is True and line["final_step"] == 2
    from mpi_operator_tpu_torch.utils.checkpoint import committed_steps

    for line in (r0, r1):
        assert (line["final_step"], line["steps"]) == (6, 4)
        assert line["preempted"] is False
        np.testing.assert_allclose(line["loss"], s0["loss"], rtol=RTOL)
    assert s0["loss"] == s1["loss"] and r0["loss"] == r1["loss"]
    # The sync manager's orbax decision saves the first step (no
    # checkpoint yet) and the last; the async writer, drained by the
    # final save, the preempted step 2 once and the last.
    assert committed_steps(straight) == {1, 6}
    assert committed_steps(preempted) == {2, 6}
    want, got = _params(straight, 6), _params(preempted, 6)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   rtol=RTOL, atol=ATOL, err_msg=k)

    one = _run_job({"cmd": "eval", "argv": ["--device", "cpu", *evals]})
    for i in range(3, 6):
        assert ranks[1][i]["line"] is None  # process 0 alone prints
        line = ranks[0][i]["line"]
        assert line["tokens"] == one["line"]["tokens"] == 3 * 4 * 15
        assert line["step"] == 6
        np.testing.assert_allclose(line["loss"], one["line"]["loss"],
                                   rtol=RTOL)


def test_resume_onto_another_mesh(tmp_path):
    bert = [*QUIET, "--model", "bert-tiny", "--mlm-layout", "positions",
            "--global-batch", "8", "--seq-len", "16", "--lr", "1e-2",
            "--save-every", "1"]
    moved, straight = str(tmp_path / "moved"), str(tmp_path / "straight")
    sharded = [*bert, "--mesh", "fsdp=2", "--checkpoint-dir", moved]
    first = run_gang(2, [{"argv": [*sharded, "--steps", "2"]}])
    assert all(r[0]["line"]["final_step"] == 2 for r in first)
    middle = _run_job({"argv": [*bert, "--checkpoint-dir", moved,
                                "--steps", "4"]})["line"]
    assert (middle["final_step"], middle["steps"]) == (4, 2)
    last = run_gang(2, [{"argv": [*sharded, "--steps", "6"]}])
    want = _run_job({"argv": [*bert, "--checkpoint-dir", straight,
                              "--steps", "6"]})["line"]
    for rank in last:
        line = rank[0]["line"]
        assert (line["final_step"], line["steps"]) == (6, 2)
        np.testing.assert_allclose(line["loss"], want["loss"], rtol=RTOL)
