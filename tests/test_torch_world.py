"""The port's trainer across processes, on the CPU over gloo, against the
JAX trainer on the 8-device CPU mesh at the same ``--global-batch``.

Two processes with ``--mesh dp=2`` against JAX's ``dp=-1`` (dp=8),
llama-tiny and bert-tiny (the ``mask`` layout, whose MLM weight count
differs between the ranks' rows: the loss divides by the global count).
Both start from the JAX init, carried across with ``interop``; each
process draws the JAX trainer's global batch and keeps its rows. The
summary's ``first_loss`` (the first step's) and ``loss`` (the third's)
are the global batch's, on every rank, at rtol 1e-5 (the resume tests'
tolerance): f32 both sides, only the order of the sums differs.

This file also holds the spawn helper the other ``test_torch_world_*``
files use: ``run_gang`` starts ``n`` processes of one world (a free port
pair, ``torch.set_num_threads(1)``, a timeout of its own so that a hung
rank fails the test and never stalls the run) and runs a list of jobs,
each a ``cmd.train``, ``cmd.eval`` or ``cmd.generate`` call (or an op
job: a function of a test module called in the world, ``_run_op``), in
every process in turn.
"""

import contextlib
import io
import json
import os
import pathlib
import subprocess
import sys
import tempfile
import time

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.kernel

REPO = str(pathlib.Path(__file__).resolve().parent.parent)
# The flags every compared run shares: 3 AdamW steps at 1e-2 on a
# global batch of 8 (JAX's dp=8 takes one row a device).
BASE = ["--global-batch", "8", "--seq-len", "16", "--steps", "3",
        "--warmup", "1", "--lr", "1e-2", "--seed", "3", "--log-every", "0",
        "--telemetry-every", "0"]
MODELS = {
    "llama-tiny": ["--model", "llama-tiny"],
    "bert-tiny": ["--model", "bert-tiny", "--mlm-layout", "mask"],
}
RTOL = 1e-5


# -- the spawn helper ---------------------------------------------------

def run_gang(n: int, jobs: list, *, timeout: float = 180.0,
             env: dict = None) -> list:
    """Run ``jobs`` in each of ``n`` processes of one gloo world on the
    CPU; returns, per rank, each job's record: ``{"line": the last JSON
    line the command printed (or None), "lines": all of them, "exit": the
    SystemExit message (or absent)}``. A rank that exits non-zero or
    outlives ``timeout`` fails the test, naming the rank; every process
    is gone on return."""
    from mpi_operator_tpu_torch.utils.net import free_port_pair

    port = free_port_pair()
    spec = json.dumps(jobs)
    procs, logs = [], []
    for rank in range(n):
        penv = {**os.environ, **(env or {}),
                "TPUJOB_COORDINATOR_ADDRESS": f"127.0.0.1:{port}",
                "TPUJOB_NUM_PROCESSES": str(n),
                "TPUJOB_PROCESS_ID": str(rank), "TPU_WORKER_ID": str(rank),
                "OMP_NUM_THREADS": "1"}
        # Files, not pipes: a rank blocked on a full pipe the parent is
        # not reading yet would stall its peers' collectives.
        out, err = tempfile.TemporaryFile("w+"), tempfile.TemporaryFile("w+")
        logs.append((out, err))
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "tests.test_torch_world", spec], env=penv,
            cwd=REPO, stdout=out, stderr=err, text=True))
    deadline = time.monotonic() + timeout
    try:
        for rank, p in enumerate(procs):
            try:
                p.wait(timeout=max(deadline - time.monotonic(), 0.1))
            except subprocess.TimeoutExpired:
                pytest.fail(f"rank {rank} of {n} still running after "
                            f"{timeout:.0f} s")
    finally:
        for p in procs:  # a wedged rank must not outlive the test
            if p.poll() is None:
                p.kill()
                p.wait()
    results = []
    for rank, (p, (out, err)) in enumerate(zip(procs, logs)):
        out.seek(0)
        err.seek(0)
        out, err = out.read(), err.read()
        assert p.returncode == 0, (
            f"rank {rank} of {n} exited {p.returncode}:\n{err[-4000:]}")
        results.append([json.loads(line)["result"]
                        for line in out.splitlines()
                        if line.startswith('{"result"')])
        assert len(results[-1]) == len(jobs), err[-4000:]
    return results


@contextlib.contextmanager
def _init_from(weights: str):
    """Start every model from the state dict saved at ``weights`` (the
    JAX init): after the model's own init, so that a parameter the JAX
    tree lacks (BERT's type_embed, which gets no gradient) is seeded as
    usual."""
    from mpi_operator_tpu_torch.models import (
        bert,
        llama,
        llama_pp,
        resnet,
        seq2seq,
        vit,
    )

    state = torch.load(weights)
    own = {(lib, "init_params"): lib.init_params
           for lib in (bert, llama, resnet, seq2seq, vit)}
    # A pipeline stage loads its part of the whole model's state.
    own[llama_pp, "init_stage_params"] = llama_pp.init_stage_params
    for (lib, name), real in own.items():
        def init(model, generator, _real=real, _stage=lib is llama_pp):
            _real(model, generator)
            mine = {k: v for k, v in state.items()
                    if not _stage or k in model.state_dict()}
            missing, unexpected = model.load_state_dict(mine, strict=False)
            assert not unexpected and set(missing) <= {"type_embed.weight"}
            return model

        setattr(lib, name, init)
    try:
        yield
    finally:
        for (lib, name), real in own.items():
            setattr(lib, name, real)


def _preempt_after(rank: int, n_steps: int) -> None:
    """SIGTERM this process after its ``n_steps``-th step when it is
    ``rank`` (one rank of the gang, as a kubelet preempting one pod)."""
    import signal

    from mpi_operator_tpu_torch.cmd import train

    if int(os.environ["TPUJOB_PROCESS_ID"]) != rank:
        return
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

    train.build_workload = build


def _run_op(job: dict) -> dict:
    """An op job: ``fn`` ("module:function") called with ``args`` in this
    process's world (formed here when no command formed it yet); what it
    returns is the record's line."""
    import importlib

    from mpi_operator_tpu_torch.launcher import bootstrap

    bootstrap.initialize(device_type="cpu")
    module, name = job["fn"].split(":")
    return {"line": getattr(importlib.import_module(module), name)(
        **job["args"])}


def _run_job(job: dict) -> dict:
    from mpi_operator_tpu_torch.cmd import eval as eval_cmd
    from mpi_operator_tpu_torch.cmd import train

    if job.get("cmd") == "op":
        return _run_op(job)

    real_build = train.build_workload
    if job.get("sigterm"):
        _preempt_after(*job["sigterm"])
    from mpi_operator_tpu_torch.cmd import generate as gen_cmd

    entry = {"eval": eval_cmd.main, "generate": gen_cmd.main}.get(
        job.get("cmd"), train.main)
    init = (_init_from(job["weights"]) if job.get("weights")
            else contextlib.nullcontext())
    buf, record = io.StringIO(), {}
    try:
        with init, contextlib.redirect_stdout(buf):
            assert entry(job["argv"]) == 0
    except SystemExit as e:
        record["exit"] = str(e)
    finally:
        train.build_workload = real_build
    lines = [json.loads(line) for line in buf.getvalue().splitlines()
             if line.startswith("{")]
    record["line"] = lines[-1] if lines else None
    record["lines"] = lines
    return record


def _child(spec: str) -> None:
    torch.set_num_threads(1)
    for job in json.loads(spec):
        print(json.dumps({"result": _run_job(job)}), flush=True)


# -- the JAX side -------------------------------------------------------

def jax_reference(argv: list, mesh_spec: str, steps: int = 3):
    """The JAX trainer's workload for ``argv`` on the 8-device CPU mesh
    ``mesh_spec``: its first ``steps`` losses and its initial parameters
    as the port's state dict."""
    import jax

    from mpi_operator_tpu.cmd import train as jtrain
    from mpi_operator_tpu.ops import attention as jattn
    from mpi_operator_tpu.parallel import create_mesh as jax_mesh
    from mpi_operator_tpu_torch import interop

    args = jtrain.build_parser().parse_args(argv)
    sizes = jtrain.parse_mesh_spec(mesh_spec)
    # A spec without -1 takes as many devices as it names.
    n = np.prod(list(sizes.values())) if -1 not in sizes.values() else None
    mesh = jax_mesh(devices=jax.devices()[:n] if n else None, **sizes)
    with pytest.MonkeyPatch.context() as mp:
        # The reference's _flat_pack reads os.environ, but its module
        # never imports os (tests/test_torch_llama.py): supply the global.
        mp.setattr(jattn, "os", os, raising=False)
        work = jtrain.build_workload(args, mesh, len(jax.devices()))
        # Before the steps: they donate the state's buffers.
        host = jax.tree_util.tree_map(np.asarray, work.state)
        losses, state = [], work.state
        with mesh:
            for step in range(steps):
                # --data: the step's batch of the token stream.
                batch = (work.batch_fn(step) if work.batch_fn is not None
                         else work.batch)
                state, loss = work.step_fn(state, batch)
                losses.append(float(loss))
    if args.model.startswith("resnet"):
        init = interop.resnet_params_from_jax(host["params"],
                                              host["batch_stats"])
    elif args.model.startswith("bert"):
        init = interop.bert_params_from_jax(host["params"])
    elif args.model.startswith("vit"):
        init = interop.vit_params_from_jax(host["params"])
    elif args.model.startswith("seq2seq"):
        init = interop.seq2seq_params_from_jax(host["params"])
    elif "blocks" in host["params"]:
        init = interop.llama_pp_params_from_jax(host["params"])
    else:
        init = interop.llama_params_from_jax(host["params"])
    return losses, init


def compare_to_jax(tmp_path, mesh: str, jax_mesh: str, n: int,
                   models=MODELS, extra=()) -> dict:
    """Each of ``models`` through the port's trainer on ``n`` processes
    with ``--mesh mesh`` (one gang, one job a model) and through the JAX
    trainer on ``jax_mesh``. Returns model -> (JAX losses, every rank's
    summary line)."""
    jobs, want = [], {}
    for name, flags in models.items():
        argv = [*flags, *BASE, *extra]
        want[name], init = jax_reference(argv, jax_mesh)
        path = str(tmp_path / f"{name}.pt")
        torch.save(init, path)
        jobs.append({"argv": ["--device", "cpu", "--mesh", mesh, *argv],
                     "weights": path})
    ranks = run_gang(n, jobs)
    return {name: (want[name], [r[i]["line"] for r in ranks])
            for i, name in enumerate(models)}


def assert_matches_jax(want: list, lines: list, n: int) -> None:
    for line in lines:
        assert line["devices"] == n and line["final_step"] == 3
        np.testing.assert_allclose(line["first_loss"], want[0], rtol=RTOL)
        np.testing.assert_allclose(line["loss"], want[-1], rtol=RTOL)
    # Every rank reports the same global-batch loss.
    assert len({line["loss"] for line in lines}) == 1
    assert want[-1] < want[0]


@pytest.fixture(scope="module")
def dp2(tmp_path_factory):
    return compare_to_jax(tmp_path_factory.mktemp("dp2"), "dp=2", "dp=-1", 2)


@pytest.mark.parametrize("model", sorted(MODELS))
def test_dp2_matches_the_jax_trainer(dp2, model):
    want, lines = dp2[model]
    assert_matches_jax(want, lines, 2)


if __name__ == "__main__":
    _child(sys.argv[1])
