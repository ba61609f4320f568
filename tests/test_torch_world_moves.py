"""Checkpoints of the tp and fsdp layouts moved onto other meshes, on the
CPU over gloo.

- llama-moe-tiny saved at step 2 by two processes with ``--mesh fsdp=2``
  (FSDP2 shards every parameter and AdamW moment on dim 0, the experts
  among them) is restored by two processes with ``--mesh ep=2`` (experts
  split on E) and with ``--mesh tp=2`` (attention by head, experts on
  their hidden dim);
- vit-tiny saved at step 2 by two processes with ``--mesh tp=2`` is
  restored by two with ``--mesh dp=2``.

Each restore goes through the trainer's own ``restore_train_state`` on
the new mesh and is held bit for bit: every parameter and every
optimizer-state tensor, gathered whole, equals the checkpoint's. Then
each resumes to the absolute ``--steps 3`` (one step, from its own copy
of the checkpoint) and its loss equals a straight one-process run to 3
at rtol 1e-5: the meshes sum in another order, so the step after the
restore cannot be bit for bit. The spawn helper is
``tests/test_torch_world.py``'s.
"""

import shutil

import numpy as np
import pytest
import torch

from tests.test_torch_world import BASE, RTOL, _run_job, run_gang

pytestmark = pytest.mark.kernel

SAVED = {"llama-moe-tiny": ("fsdp=2", ("ep=2", "tp=2")),
         "vit-tiny": ("tp=2", ("dp=2",))}


def _flat(tree, prefix: str = "") -> dict:
    """The tensors of a nested state dict under DCP's dotted keys."""
    out = {}
    for key, value in tree.items():
        name = f"{prefix}{key}"
        if isinstance(value, dict):
            out.update(_flat(value, f"{name}."))
        elif torch.is_tensor(value):
            out[name] = value
    return out


def restored_state(argv: list) -> dict:
    """An op job: the trainer's workload for ``argv`` on its mesh, its
    checkpoint restored as the trainer restores it; every restored tensor
    gathered whole against the checkpoint read whole. Returns the step
    and the names that differ in a bit or are missing."""
    from torch.distributed.tensor import DTensor

    from mpi_operator_tpu_torch.cmd import train
    from mpi_operator_tpu_torch.launcher import bootstrap
    from mpi_operator_tpu_torch.parallel.mesh import create_mesh
    from mpi_operator_tpu_torch.utils.checkpoint import CheckpointManager

    args = train.build_parser().parse_args(argv)
    mesh = create_mesh(device="cpu", **train.parse_mesh_spec(args.mesh))
    work = train.build_workload(args, mesh, mesh.size)
    ckpt = CheckpointManager(args.checkpoint_dir,
                             process_group=bootstrap.checkpoint_group())
    step = train.restore_train_state(ckpt, work)
    got = _flat(train.train_state(work))
    _, stored = ckpt.read_latest()
    want = _flat(stored)
    differ = sorted(set(want) ^ set(got))
    for name in sorted(set(want) & set(got)):
        t = got[name]
        whole = t.full_tensor() if isinstance(t, DTensor) else t
        if not torch.equal(whole, want[name]):
            differ.append(name)
    sharded = sum(isinstance(t, DTensor) for t in got.values())
    return {"step": step, "differ": differ, "tensors": len(got),
            "sharded": sharded}


def test_checkpoints_move_between_meshes(tmp_path):
    def argv(model, mesh, steps, directory):
        return ["--device", "cpu", "--model", model, *BASE, "--steps",
                str(steps), "--save-every", "2", "--mesh", mesh,
                "--checkpoint-dir", str(directory)]

    saves = [{"argv": argv(model, mesh, 2, tmp_path / model)}
             for model, (mesh, _) in SAVED.items()]
    for rank in run_gang(2, saves):
        assert [r["line"]["final_step"] for r in rank] == [2, 2]

    checks, resumes, moves = [], [], []
    for model, (_, targets) in SAVED.items():
        for mesh in targets:
            copy = tmp_path / f"{model}-{mesh}"
            shutil.copytree(tmp_path / model, copy)
            moves.append((model, mesh))
            checks.append({"cmd": "op",
                           "fn": "tests.test_torch_world_moves:"
                                 "restored_state",
                           "args": {"argv": argv(model, mesh, 2,
                                                 tmp_path / model)}})
            resumes.append({"argv": argv(model, mesh, 3, copy)})
    ranks = run_gang(2, checks + resumes)
    straight = {model: _run_job({"argv": ["--device", "cpu", "--model",
                                          model, *BASE]})["line"]
                for model in SAVED}
    for i, (model, mesh) in enumerate(moves):
        for rank in ranks:
            check, resumed = rank[i]["line"], rank[len(checks) + i]["line"]
            assert check["step"] == 2, (model, mesh)
            assert check["differ"] == [], (model, mesh, check["differ"])
            # dp keeps every tensor whole; ep and tp shard some.
            assert (check["sharded"] > 0) == (mesh != "dp=2")
            assert check["tensors"] > 10
            assert (resumed["final_step"], resumed["steps"]) == (3, 1)
            np.testing.assert_allclose(resumed["loss"],
                                       straight[model]["loss"], rtol=RTOL,
                                       err_msg=f"{model} onto {mesh}")
