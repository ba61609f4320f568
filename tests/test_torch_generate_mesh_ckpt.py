"""``cmd.generate --mesh`` on the checkpoints of sharded training runs and
with sampling, on the CPU over gloo.

One gang of two processes trains llama-tiny on ``--mesh pp=2`` and
llama-moe-tiny on ``--mesh ep=2`` (2 steps each, the port's trainer),
then decodes the pipelined checkpoint on ``tp=2`` and the ep one on
``ep=2``: the tokens equal JAX's ``generate`` on the parameters read
back (``interop``), and the one-process command's. The same gang samples
(``--temperature 1.0``) on ``dp=2``, ``tp=2`` and ``fsdp=2``: one uniform
a row of the whole batch a step, so every mesh gives the one-process
tokens at one seed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mpi_operator_tpu.models import generate as jgen
from mpi_operator_tpu.models import llama as jllama
from mpi_operator_tpu_torch import interop
from mpi_operator_tpu_torch.utils.checkpoint import read_llama_params
from tests.test_torch_generate_mesh import THREE, held, job, port_lines
from tests.test_torch_world import run_gang

pytestmark = pytest.mark.kernel

TRAIN = ["--device", "cpu", "--steps", "2", "--warmup", "1",
         "--global-batch", "8", "--seq-len", "16", "--log-every", "0",
         "--telemetry-every", "0", "--save-every", "1"]
SAMPLE = ["--temperature", "1.0", "--seed", "4"]
SAMPLED_ON = ("dp=2", "tp=2", "fsdp=2")
# (model, trained on, decoded on, the JAX config)
RUNS = {"pp": ("llama-tiny", "pp=2", "tp=2", jllama.tiny()),
        "ep": ("llama-moe-tiny", "ep=2", "ep=2", jllama.tiny_moe())}


@pytest.fixture(scope="module")
def gang(tmp_path_factory):
    root = tmp_path_factory.mktemp("mesh-ckpt")
    dirs = {run: str(root / run) for run in RUNS}
    jobs = [{"argv": [*TRAIN, "--model", name, "--mesh", trained,
                      "--checkpoint-dir", dirs[run]]}
            for run, (name, trained, _, _) in RUNS.items()]
    jobs += [job(dirs[run], name, decoded, THREE)
             for run, (name, _, decoded, _) in RUNS.items()]
    jobs += [job(dirs["pp"], "llama-tiny", mesh, [*THREE, *SAMPLE])
             for mesh in SAMPLED_ON]
    return dirs, run_gang(2, jobs)


@pytest.mark.parametrize("run", sorted(RUNS))
def test_a_sharded_runs_checkpoint_decodes_on_a_mesh_as_jax(capsys, gang,
                                                            run):
    dirs, ranks = gang
    name, _, mesh, jcfg = RUNS[run]
    got = held(ranks, len(RUNS) + list(RUNS).index(run))
    assert got == port_lines(capsys, dirs[run], name, THREE), mesh
    _, params = read_llama_params(dirs[run], name)
    tree = jax.tree_util.tree_map(jnp.asarray,
                                  interop.llama_params_to_jax(params))
    prompts = [line["prompt"] for line in got]
    want = jgen.generate(tree, jnp.asarray(prompts, jnp.int32), jcfg,
                         max_new=6)
    assert [line["tokens"] for line in got] == np.asarray(want).tolist()
    assert all(line["step"] == 2 for line in got)


def test_sampling_gives_the_one_process_tokens_on_every_mesh(capsys, gang):
    dirs, ranks = gang
    want = port_lines(capsys, dirs["pp"], "llama-tiny", [*THREE, *SAMPLE])
    assert want != port_lines(capsys, dirs["pp"], "llama-tiny", THREE)
    for i, mesh in enumerate(SAMPLED_ON):
        assert held(ranks, 2 * len(RUNS) + i) == want, mesh
