"""``cmd.generate --mesh`` on llama-moe-tiny across processes, on the CPU
over gloo, against the JAX package's ``cmd.generate``: the f32 JAX init
saved by each package's manager, the port on ``ep=2`` (two processes),
``ep=2,tp=2`` and ``ep=2,fsdp=2`` (four); each gang's lines equal JAX's
one-device command's and JAX's on its 8-device CPU mesh, and process 0
alone prints. Each rank holds the slices the JAX rules give it
(``models/llama.py`` and ``models/moe.py:param_sharding_rules``), shown
by an op job on the same meshes: its expert block, its kv heads in the
cache and, under fsdp, half the model dim of every matrix, gathered one
layer at a time.
"""

import pytest

from mpi_operator_tpu.models import llama as jllama
from tests.test_torch_generate_mesh import (
    PROMPTS,
    held,
    jax_lines,
    jax_mesh,
    job,
    save_both,
)
from tests.test_torch_world import run_gang

pytestmark = pytest.mark.kernel

NAME = "llama-moe-tiny"


def local_shapes(checkpoint_dir: str, mesh: str) -> dict:
    """Op job: this process's decode weights of layer 0 and its cache for
    a batch of two, by shape, on ``mesh``."""
    from mpi_operator_tpu_torch.cmd.train import parse_mesh_spec
    from mpi_operator_tpu_torch.models import generate as gen
    from mpi_operator_tpu_torch.models import llama as lib
    from mpi_operator_tpu_torch.parallel.mesh import create_mesh
    from mpi_operator_tpu_torch.utils.checkpoint import read_llama_params

    cfg = lib.config_for(NAME)
    shards = gen.DecodeShards.of(
        create_mesh(device="cpu", **parse_mesh_spec(mesh)), cfg)
    _, params = read_llama_params(checkpoint_dir, NAME)
    weights = gen.shard_decode_weights(cfg, params.items(), shards, "cpu")
    lo, hi = shards.rows(2)  # of a two-prompt batch
    dec = gen.Decoder(cfg, hi - lo, 8, weights, shards)
    out = {k: list(v.shape) for k, v in dec.layers[0].items()}
    out["cache"] = list(dec.caches[0][0].shape)
    out["embed.weight"] = list(weights["embed.weight"].shape)
    out["gathers"] = dec.gathers
    return out


# llama-moe-tiny: dim 64, 4 heads / 2 kv heads of 16, 4 experts of ffn
# 128, vocab 256 (torch Linear layouts [out, in], experts [E, in, out]).
WANT = {
    "ep=2": {"attn.wq.weight": [64, 64], "attn.wk.weight": [32, 64],
             "attn.wo.weight": [64, 64], "moe.expert_wg": [2, 64, 128],
             "moe.expert_wd": [2, 128, 64], "moe.router": [64, 4],
             "cache": [2, 2, 8, 16], "gathers": {}},
    "ep=2,tp=2": {"attn.wq.weight": [32, 64], "attn.wk.weight": [16, 64],
                  "attn.wo.weight": [64, 32], "moe.expert_wg": [2, 64, 64],
                  "moe.expert_wd": [2, 64, 64], "moe.router": [64, 4],
                  "cache": [2, 1, 8, 16], "gathers": {}},
    "ep=2,fsdp=2": {"attn.wq.weight": [64, 32], "attn.wk.weight": [32, 32],
                    "attn.wo.weight": [32, 64], "moe.expert_wg": [2, 32, 128],
                    "moe.expert_wd": [2, 128, 32], "moe.router": [64, 4],
                    "cache": [1, 2, 8, 16],
                    "gathers": {"attn.wq.weight": 1, "attn.wk.weight": 1,
                                "attn.wv.weight": 1, "attn.wo.weight": 0,
                                "moe.expert_wg": 1, "moe.expert_wu": 1,
                                "moe.expert_wd": 2}},
}


@pytest.fixture(scope="module")
def moe(tmp_path_factory):
    return save_both(tmp_path_factory.mktemp("mesh-moe"), NAME,
                     jllama.tiny_moe())


@pytest.mark.parametrize("n, meshes", [(2, ["ep=2"]),
                                       (4, ["ep=2,tp=2", "ep=2,fsdp=2"])],
                         ids=["two-processes", "four-processes"])
def test_moe_greedy_tokens_equal_jax_on_every_mesh(capsys, moe, n, meshes):
    jdir, tdir = moe
    jobs = [job(tdir, NAME, mesh, PROMPTS) for mesh in meshes]
    jobs += [{"cmd": "op",
              "fn": "tests.test_torch_generate_mesh_moe:local_shapes",
              "args": {"checkpoint_dir": tdir, "mesh": mesh}}
             for mesh in meshes]
    ranks = run_gang(n, jobs)
    one = jax_lines(capsys, jdir, NAME, PROMPTS)
    for i, mesh in enumerate(meshes):
        got = held(ranks, i)
        assert got == one, mesh
        assert got == jax_lines(capsys, jdir, NAME, PROMPTS,
                                jax_mesh(mesh)), mesh
        shapes = ranks[0][len(meshes) + i]["line"]
        for key, want in WANT[mesh].items():
            assert shapes[key] == want, (mesh, key)
        assert shapes["embed.weight"] == [256, 64]  # whole on every rank
