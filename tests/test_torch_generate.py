"""The port's KV-cache decoding (``models/generate.py``, ``cmd.generate``)
against the JAX package's, on carried-across weights, f32.

Teacher-forced decode logits at every prompt position against JAX's
``_decode_step`` and against the port's own training forward, dense and
MoE (capacity raised so the training MoE drops nothing: then decode is
the same function), at atol 1e-5 rtol 1e-5 (``tests/test_generate.py``'s
bound). Greedy tokens equal JAX's ``generate`` list for list. Sampling
draws from a ``torch.Generator`` (not ``jax.random``'s draws): the same
seed gives the same tokens, another seed others, and no generator is
refused. The CLI decodes a checkpoint the port's trainer wrote.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpi_operator_tpu.models import generate as jgen
from mpi_operator_tpu.models import llama as jllama
from mpi_operator_tpu_torch import interop
from mpi_operator_tpu_torch.cmd import generate as gen_cmd
from mpi_operator_tpu_torch.models import generate as tgen
from mpi_operator_tpu_torch.models import llama as tllama

pytestmark = pytest.mark.kernel
torch.set_num_threads(2)

CONFIGS = {
    "llama-tiny": {},
    "llama-moe-tiny": {"n_experts": 4, "capacity_factor": 8.0},
    "tied": {"tie_embeddings": True},
}


def _pair(name, seed=0):
    kw = CONFIGS[name]
    jcfg = jllama.tiny(**kw)
    jmodel = jllama.Llama(jcfg)
    params = jllama.init_params(jmodel, jax.random.PRNGKey(seed))
    tmodel = tllama.Llama(tllama.tiny(**kw), device="cpu")
    tmodel.load_state_dict(interop.llama_params_from_jax(
        jax.tree_util.tree_map(np.asarray, params)))
    return jcfg, params, tmodel


def _prompt(b=2, s=5, seed=0):
    return np.random.RandomState(seed).randint(1, 256, (b, s)).astype(
        np.int32)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_teacher_forced_logits_match_jax_and_the_forward(name):
    jcfg, params, tmodel = _pair(name, seed=3)
    prompt = _prompt(seed=1)
    got = tgen.decode_logits_teacher_forced(tmodel, torch.tensor(prompt))
    caches = jgen.init_cache(jcfg, *prompt.shape)
    for t in range(prompt.shape[1]):
        want, caches = jgen._decode_step(params, jcfg, caches,
                                         jnp.asarray(prompt[:, t]), t)
        np.testing.assert_allclose(got[:, t].numpy(), np.asarray(want),
                                   atol=1e-5, rtol=1e-5)
    with torch.no_grad():
        fwd = tmodel(torch.tensor(prompt))
    fwd = fwd[0] if tmodel.config.is_moe else fwd
    np.testing.assert_allclose(got.numpy(), fwd.numpy(), atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("name", sorted(CONFIGS))
@pytest.mark.parametrize("shape", [(2, 5), (2, 1)])
def test_greedy_tokens_equal_jax(name, shape):
    jcfg, params, tmodel = _pair(name)
    prompt = _prompt(*shape, seed=2)
    want = jgen.generate(params, jnp.asarray(prompt), jcfg, max_new=6)
    got = tgen.generate(tmodel, torch.tensor(prompt), max_new=6)
    assert got.tolist() == np.asarray(want).tolist()
    assert got[:, :shape[1]].tolist() == prompt.tolist()  # prompt kept


def test_gqa_cache_shape():
    cfg = tllama.tiny()
    caches = tgen.init_cache(cfg, batch=3, max_len=10)
    assert len(caches) == cfg.n_layers
    k, v = caches[0]
    assert k.shape == v.shape == (3, cfg.n_kv_heads, 10, cfg.head_dim)
    assert cfg.n_kv_heads < cfg.n_heads and k.dtype == cfg.dtype


def test_decode_weights_cast_once():
    model = tllama.Llama(tllama.tiny_moe(dtype=torch.bfloat16),
                         device="cpu")
    w = tgen.decode_weights(model)
    assert w["layer_0.attn.wq.weight"].dtype == torch.bfloat16
    assert w["layer_0.moe.expert_wg"].dtype == torch.bfloat16
    assert w["layer_0.moe.router"].dtype == torch.float32
    assert w["final_norm.scale"].dtype == torch.float32


def test_sampling_is_seeded_and_needs_a_generator():
    _, _, tmodel = _pair("llama-tiny")
    prompt = torch.tensor(_prompt())

    def sample(seed):
        gen = torch.Generator().manual_seed(seed)
        return tgen.generate(tmodel, prompt, max_new=8, temperature=1.0,
                             generator=gen)

    a, again, b = sample(1), sample(1), sample(2)
    assert a.shape == (2, 13)
    assert torch.equal(a, again)
    assert not torch.equal(a, b)
    assert torch.equal(a[:, :5], prompt.long())
    with pytest.raises(ValueError, match="torch.Generator"):
        tgen.generate(tmodel, prompt, max_new=2, temperature=0.5)


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    """llama-tiny and llama-moe-tiny checkpoints the port's trainer wrote
    (2 steps)."""
    from mpi_operator_tpu_torch.cmd import train

    root = tmp_path_factory.mktemp("gen")
    out = {}
    for name in ("llama-tiny", "llama-moe-tiny"):
        ck = str(root / name)
        assert train.main([
            "--device", "cpu", "--model", name, "--steps", "2", "--warmup",
            "1", "--global-batch", "4", "--seq-len", "16", "--log-every",
            "0", "--telemetry-every", "0", "--checkpoint-dir", ck,
            "--save-every", "1"]) == 0
        out[name] = ck
    return out


def _lines(capsys):
    return [json.loads(line) for line in
            capsys.readouterr().out.strip().splitlines()
            if line.startswith('{"step"')]


@pytest.mark.parametrize("name", ["llama-tiny", "llama-moe-tiny"])
def test_cli_decodes_a_port_checkpoint(capsys, checkpoints, name):
    """Each prompt of a batch prints its own line, in order, equal to its
    run alone and to ``generate`` on the checkpoint's parameters."""
    from mpi_operator_tpu_torch.utils.checkpoint import read_llama_params

    capsys.readouterr()
    base = ["--device", "cpu", "--checkpoint-dir", checkpoints[name],
            "--model", name, "--max-new", "5"]
    singles = []
    for p in ("12,7,42", "3,9,27"):
        assert gen_cmd.main([*base, "--prompt", p]) == 0
        singles += _lines(capsys)
    assert gen_cmd.main([*base, "--prompt", "12,7,42", "--prompt",
                         "3,9,27"]) == 0
    batch = _lines(capsys)
    assert [line["tokens"] for line in batch] == [
        line["tokens"] for line in singles]
    step, params = read_llama_params(checkpoints[name], name)
    model = tllama.Llama(tllama.config_for(name), device="cpu")
    model.load_state_dict(params)
    want = tgen.generate(model, torch.tensor([[12, 7, 42], [3, 9, 27]]),
                         max_new=5)
    for line, row, p in zip(batch, want.tolist(), ([12, 7, 42], [3, 9, 27])):
        assert line["step"] == step == 2
        assert line["prompt"] == p and line["tokens"] == row
        assert line["tokens"][:3] == p and line["new"] == row[3:]
        assert len(line["new"]) == 5


def test_cli_sampling_is_seeded(capsys, checkpoints):
    base = ["--device", "cpu", "--checkpoint-dir", checkpoints["llama-tiny"],
            "--model", "llama-tiny", "--prompt", "5,6", "--max-new", "12",
            "--temperature", "1.0"]
    capsys.readouterr()
    runs = []
    for seed in ("1", "1", "2"):
        assert gen_cmd.main([*base, "--seed", seed]) == 0
        runs.append(_lines(capsys)[0]["tokens"])
    assert runs[0] == runs[1] != runs[2]


REFUSALS = {
    "prompt": (["--prompt", "a,b"], "integer token ids"),
    "empty": (["--prompt", ","], "at least one token"),
    "vocab": (["--prompt", "99999"], "vocab"),
    "lengths": (["--prompt", "3,9", "--prompt", "7"], "share a length"),
    "max-new": (["--prompt", "1,2", "--max-new", "0"], "max-new"),
    "context": (["--prompt", "1,2", "--max-new", "128"],
                "exceeds the model context"),
    "mesh": (["--prompt", "1", "--mesh", "tp=2"],
             r"ROADMAP.md queue \(a\) item 14"),
    "model": (["--prompt", "1", "--model", "llama-9b"], "unknown --model"),
    "missing": (["--prompt", "1,2", "--checkpoint-dir", "/nonexistent/ck"],
                "no checkpoint"),
    "wrong-model": (["--prompt", "1,2", "--model", "llama-moe-tiny"],
                    "does not fit --model llama-moe-tiny"),
}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_cli_refusals(checkpoints, case):
    extra, match = REFUSALS[case]
    argv = ["--device", "cpu", "--checkpoint-dir", checkpoints["llama-tiny"],
            "--model", "llama-tiny", *extra]
    with pytest.raises(SystemExit, match=match):
        gen_cmd.main(argv)


def test_cli_refuses_a_multi_process_world(monkeypatch, checkpoints):
    monkeypatch.setenv("TPUJOB_NUM_PROCESSES", "2")
    with pytest.raises(SystemExit, match=r"queue \(a\) item 14"):
        gen_cmd.main(["--device", "cpu", "--checkpoint-dir",
                      checkpoints["llama-tiny"], "--prompt", "1"])
