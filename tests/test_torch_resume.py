"""The port's trainer resuming from ``--checkpoint-dir`` on the CPU: an
absolute ``--steps`` target (3, then 3 again as a no-op, then 6); a run
preempted at step 3 and resumed to 6 equal to a straight run to 6 under
a cosine schedule on a token file (llama-tiny and bert-tiny, each with
the sync and the async manager; parameters at rtol 1e-5, atol 1e-6, the
JAX package's resume tolerance) -- the check that the schedule's count
survives a checkpoint; a ResNet-18 ``--bn-kernel pallas`` resume with its
running statistics; a cold start that leaves the optimizer fresh; and a
real SIGTERM to a trainer process. (Split from ``test_torch_train.py`` to
keep each file well under a minute.)
"""

import json

import numpy as np
import pytest
import torch

from mpi_operator_tpu_torch.cmd import train
from mpi_operator_tpu_torch.parallel.mesh import create_mesh

pytestmark = pytest.mark.kernel
torch.set_num_threads(2)

RESNET_ARGS = ["--device", "cpu", "--model", "resnet18", "--image-size",
               "32", "--global-batch", "4"]
# The keys of the JAX trainer's "nothing to do" line.
JAX_NOOP_KEYS = {"model", "steps", "final_step", "loss", "examples_per_sec",
                 "step_ms", "goodput", "devices", "preempted"}


def _summary(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def _corpus(tmp_path, n_seq: int, seq_len: int, high: int, seed: int = 0):
    from mpi_operator_tpu_torch.data import write_token_file

    path = tmp_path / "corpus.u32"
    write_token_file(path, np.random.RandomState(seed).randint(
        0, high, n_seq * seq_len))
    return str(path)


def _run(capsys, *argv) -> dict:
    assert train.main(["--device", "cpu", "--warmup", "1", "--log-every",
                       "0", "--telemetry-every", "0", *argv]) == 0
    return _summary(capsys)


def test_resume_continues_to_the_absolute_target(capsys, tmp_path):
    base = ["--model", "llama-tiny", "--global-batch", "4", "--seq-len",
            "16", "--checkpoint-dir", str(tmp_path / "ckpt"),
            "--save-every", "1"]
    first = _run(capsys, *base, "--steps", "3")
    assert first["final_step"] == 3 and first["steps"] == 3
    second = _run(capsys, *base, "--steps", "3")  # already there: no-op
    assert second["final_step"] == 3 and second["steps"] == 0
    assert second["loss"] is None
    assert JAX_NOOP_KEYS <= set(second)
    third = _run(capsys, *base, "--steps", "6")
    assert third["final_step"] == 6 and third["steps"] == 3


def _preempt_after(monkeypatch, n_steps: int):
    """SIGTERM this process after the run's ``n_steps``-th step, as the
    kubelet does to a preempted pod: the trainer stops at that step
    boundary and force-saves it."""
    import signal

    real = train.build_workload

    def build(*a, **kw):
        work = real(*a, **kw)
        step_fn, calls = work.step_fn, [0]

        def step(*batch):
            loss = step_fn(*batch)
            calls[0] += 1
            if calls[0] == n_steps:
                signal.raise_signal(signal.SIGTERM)
            return loss

        work.step_fn = step
        return work

    monkeypatch.setattr(train, "build_workload", build)


def _final_params(ckpt_dir: str, step: int) -> dict:
    from mpi_operator_tpu_torch.utils.checkpoint import CheckpointManager

    got, state = CheckpointManager(ckpt_dir).read_latest()
    assert got == step
    return state["params"]


def _assert_params_close(resumed: dict, straight: dict):
    assert resumed.keys() == straight.keys()
    for k in straight:
        np.testing.assert_allclose(
            resumed[k].numpy(), straight[k].numpy(), rtol=1e-5, atol=1e-6,
            err_msg=f"{k} diverged between the straight and resumed runs")


RESUME_ARMS = {
    "llama-tiny": ["--model", "llama-tiny", "--global-batch", "4",
                   "--seq-len", "16"],
    "bert-tiny": ["--model", "bert-tiny", "--global-batch", "4",
                  "--seq-len", "16", "--mlm-layout", "positions"],
}


@pytest.mark.parametrize("manager", ["sync", "async"])
@pytest.mark.parametrize("arm", sorted(RESUME_ARMS))
def test_preempted_and_resumed_run_equals_a_straight_one(
        capsys, monkeypatch, tmp_path, arm, manager):
    """Straight to step 6 against SIGTERM at step 3, then resume to 6,
    under a cosine schedule (warmup 2, decay to 0 at --steps 6) on a
    token file: the schedule count, AdamW's moments and step, and the
    data order must all carry across the checkpoint."""
    data = _corpus(tmp_path, 6, 16, 300)
    argv = [*RESUME_ARMS[arm], "--steps", "6", "--lr", "1e-2",
            "--lr-schedule", "cosine", "--warmup-steps", "2",
            "--data", data, "--save-every", "2"]
    if manager == "async":
        argv.append("--async-checkpoint")
    straight_dir, resumed_dir = str(tmp_path / "a"), str(tmp_path / "b")
    straight = _run(capsys, *argv, "--checkpoint-dir", straight_dir)
    assert straight["final_step"] == 6 and straight["steps"] == 6

    with monkeypatch.context() as m:
        _preempt_after(m, 3)
        first = _run(capsys, *argv, "--checkpoint-dir", resumed_dir)
    assert first["preempted"] is True and first["final_step"] == 3
    second = _run(capsys, *argv, "--checkpoint-dir", resumed_dir)
    assert second["final_step"] == 6 and second["steps"] == 3
    assert second["loss"] == pytest.approx(straight["loss"], rel=1e-5)
    _assert_params_close(_final_params(resumed_dir, 6),
                         _final_params(straight_dir, 6))


def test_resnet_resume_restores_parameters_and_bn_statistics(capsys,
                                                             tmp_path):
    argv = [*RESNET_ARGS, "--bn-kernel", "pallas",
            "--lr", "0.01", "--save-every", "1"]
    straight = _run(capsys, *argv, "--steps", "2", "--checkpoint-dir",
                    str(tmp_path / "a"))
    _run(capsys, *argv, "--steps", "1", "--checkpoint-dir",
         str(tmp_path / "b"))
    resumed = _run(capsys, *argv, "--steps", "2", "--checkpoint-dir",
                   str(tmp_path / "b"))
    assert resumed["steps"] == 1
    assert resumed["loss"] == pytest.approx(straight["loss"], rel=1e-5)
    params = _final_params(str(tmp_path / "a"), 2)
    assert "bn_init.var" in params  # the running statistics
    _assert_params_close(_final_params(str(tmp_path / "b"), 2), params)


def test_cold_start_optimizer_is_a_fresh_one(tmp_path):
    """Building the restore template gives AdamW a state (one zero-lr
    step); a cold start must clear it, so a run with --checkpoint-dir
    trains exactly as one without."""
    from mpi_operator_tpu_torch.utils.checkpoint import CheckpointManager

    args = train.build_parser().parse_args(
        ["--device", "cpu", "--model", "llama-tiny"])
    work = train.build_workload(args, create_mesh(device="cpu", dp=-1), 1)
    params = [p.detach().clone() for p in work.model.parameters()]
    assert train.restore_train_state(
        CheckpointManager(str(tmp_path)), work) == 0
    assert not work.optimizer.state
    assert all(p.grad is None for p in work.model.parameters())
    for p, q in zip(work.model.parameters(), params):
        assert torch.equal(p, q)


def test_sigterm_checkpoints_and_resume_completes(tmp_path):
    """SIGTERM a real trainer process mid-run: it finishes the step,
    commits that step's checkpoint, exits 0 with preempted=true and one
    final telemetry record; a rerun resumes from that step and completes
    the absolute --steps target."""
    import os
    import pathlib
    import signal
    import subprocess
    import sys
    import time

    from mpi_operator_tpu_torch.utils.checkpoint import committed_steps

    ckpt = str(tmp_path / "ckpt")
    telemetry_path = tmp_path / "telemetry.jsonl"
    argv = [
        sys.executable, "-m", "mpi_operator_tpu_torch.cmd.train",
        "--device", "cpu", "--model", "llama-tiny", "--steps", "500",
        "--warmup", "1", "--global-batch", "4", "--seq-len", "32",
        "--log-every", "0", "--checkpoint-dir", ckpt, "--save-every", "1",
        "--telemetry-path", str(telemetry_path), "--telemetry-every",
        "100000",
    ]
    repo = str(pathlib.Path(__file__).resolve().parent.parent)
    env = {**os.environ, "OMP_NUM_THREADS": "2"}
    proc = subprocess.Popen(argv, env=env, cwd=repo, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    try:
        deadline = time.time() + 120
        while time.time() < deadline:
            if len(committed_steps(ckpt) or ()) >= 2:
                break
            if proc.poll() is not None:
                pytest.fail(f"trainer exited early:\n{proc.stdout.read()}")
            time.sleep(0.2)
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, out[-2000:]
    first = json.loads(out.strip().splitlines()[-1])
    assert first["preempted"] is True
    assert 0 < first["final_step"] < 500
    assert first["final_step"] in committed_steps(ckpt)

    telem = [json.loads(ln) for ln in
             telemetry_path.read_text().strip().splitlines()]
    assert len(telem) == 1 and telem[0]["final"] is True
    assert telem[0]["step"] == first["final_step"]
    assert telem[0]["checkpoint_s"] > 0

    target = first["final_step"] + 2
    argv[argv.index("500")] = str(target)
    second = subprocess.run(argv, env=env, cwd=repo, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True,
                            timeout=240)
    assert second.returncode == 0, second.stdout[-2000:]
    summary = json.loads(second.stdout.strip().splitlines()[-1])
    assert summary["final_step"] == target and summary["steps"] == 2
    assert summary["preempted"] is False
