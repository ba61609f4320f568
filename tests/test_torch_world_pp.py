"""The port's trainer on a ``pp`` mesh, on the CPU over gloo, against the
JAX trainer on the same mesh of CPU devices at the same flags: llama-tiny
with 4 layers on ``pp=2`` (two processes, two layers a stage) and
``pp=4`` (four, one layer a stage), the microbatch count derived as
JAX's derives it (M = 4 at a global batch of 8), from the JAX init
(``interop``). The first and third global-batch losses on every rank at
rtol 1e-5, as ``tests/test_torch_world.py`` holds dp. Then the trainer's
``--pp-microbatch`` derivation and its refusals, in the JAX trainer's
words.
"""

import pytest

from mpi_operator_tpu_torch.cmd import train
from tests.test_torch_world import MODELS, assert_matches_jax, compare_to_jax

pytestmark = pytest.mark.kernel

LLAMA4 = {"llama-tiny": [*MODELS["llama-tiny"], "--n-layers", "4"]}


@pytest.mark.parametrize("pp", [2, 4])
def test_pp_matches_the_jax_trainer(tmp_path, pp):
    got = compare_to_jax(tmp_path, f"pp={pp}", f"pp={pp}", pp,
                         models=LLAMA4)
    assert_matches_jax(*got["llama-tiny"], pp)


class _Args:
    def __init__(self, mb=0):
        self.pp_microbatch = mb


@pytest.mark.parametrize("sizes,batch,mb,want", [
    # 2*pp microbatches of the largest multiple of dp*fsdp that fits.
    ({"pp": 2}, 8, 0, 4),
    ({"pp": 4}, 8, 0, 8),
    # 20 on dp=4: 20/(2*2) = 5 divides but is no multiple of 4; 4 rows
    # give 5 microbatches.
    ({"dp": 4, "pp": 2}, 20, 0, 5),
    # No multiple of dp=4 gives 2*pp: pp microbatches.
    ({"dp": 4, "pp": 2}, 8, 0, 2),
    ({"pp": 2}, 8, 2, 4),
])
def test_pp_microbatch_derivation(sizes, batch, mb, want):
    assert train._pp_microbatches(_Args(mb), sizes, batch) == want


@pytest.mark.parametrize("sizes,batch,mb,match", [
    ({"dp": 4, "pp": 2}, 8, 8, "cannot fill"),
    ({"pp": 2}, 8, 3, "not divisible by pipeline microbatch 3"),
    ({"dp": 4, "pp": 2}, 8, 2, "not divisible by dp\\*fsdp=4"),
    ({"dp": 4, "pp": 4}, 12, 0, "cannot form 4 pipeline microbatches"),
])
def test_pp_microbatch_refusals(sizes, batch, mb, match):
    with pytest.raises(SystemExit, match=match):
        train._pp_microbatches(_Args(mb), sizes, batch)


REFUSED = {
    # The JAX trainer's refusals of a pp mesh, each before any world.
    "bert": (["--model", "bert-tiny", "--mesh", "dp=2,pp=4"], "dense llama"),
    "dense-ep": (["--mesh", "ep=4,pp=2"], "needs an MoE model"),
    "experts": (["--model", "llama-moe-tiny", "--mesh", "pp=2,ep=3"],
                "4 experts not divisible by ep=3"),
    "zigzag": (["--mesh", "pp=2,sp=4", "--seq-len", "20", "--zigzag-ring"],
               "--zigzag-ring needs --seq-len divisible by 2\\*sp=8"),
    "seq-len": (["--mesh", "pp=2,sp=4", "--seq-len", "18"],
                "--seq-len 18 not divisible by sp=4"),
}


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_pp_refusals_before_the_world(case):
    extra, match = REFUSED[case]
    argv = ["--device", "cpu", "--model", "llama-tiny", "--steps", "1",
            *(["--seq-len", "16"] if "--seq-len" not in extra else []),
            *extra]
    with pytest.raises(SystemExit, match=match):
        train.main(argv)


def _mesh(sizes: dict):
    """A mesh of these sizes without a world: the workload's checks come
    before any collective."""
    import torch

    from mpi_operator_tpu_torch.parallel.mesh import Mesh

    return Mesh(tuple(sizes), tuple(sizes.values()), torch.device("cpu"))


WORKLOAD_REFUSED = {
    "axes": ([], {"pp": 2, "xp": 2}, "pp meshes compose with dp, fsdp"),
    "grad-accum": (["--grad-accum", "2"], {"pp": 2},
                   "--grad-accum with a pp mesh is redundant"),
    "layers": (["--n-layers", "3"], {"pp": 2},
               "model has 3 layers, not divisible by pp=2"),
    "fsdp": ([], {"pp": 2, "fsdp": 3}, "must both divide by fsdp=3"),
    "tp": ([], {"pp": 2, "tp": 4}, "must all divide by tp=4"),
    "moe-fsdp": (["--model", "llama-moe-tiny"], {"pp": 2, "fsdp": 2},
                 "pipelined MoE composes with dp/tp/ep"),
    "moe-sp": (["--model", "llama-moe-tiny"], {"pp": 2, "sp": 2},
               "routing capacity is per sequence\\) do not apply"),
}


@pytest.mark.parametrize("case", sorted(WORKLOAD_REFUSED))
def test_pp_workload_refusals(case):
    import numpy as np

    extra, sizes, match = WORKLOAD_REFUSED[case]
    args = train.build_parser().parse_args(
        ["--device", "cpu", "--model", "llama-tiny", "--seq-len", "16",
         *extra])
    with pytest.raises(SystemExit, match=match):
        train._llama_pp_workload(args, _mesh(sizes), 8,
                                 np.random.RandomState(0))
