"""The port's trainer entry point (``mpi_operator_tpu_torch.cmd.train``)
on the CPU: the summary line of every arm (ResNet, Llama, BERT, ViT,
seq2seq), each arm's synthetic batch against the JAX trainer's, the loud
refusal of every flag a later slice brings, and no quiet move to the CPU
when ``cuda`` is asked for; the ``--data`` batches against the JAX
trainer's ``batch_fn``. Checkpoint resume is ``test_torch_resume.py``.
"""

import json
import math

import numpy as np
import pytest
import torch

from mpi_operator_tpu_torch.cmd import train
from mpi_operator_tpu_torch.models import llama as tllama
from mpi_operator_tpu_torch.parallel.mesh import create_mesh

pytestmark = pytest.mark.kernel
torch.set_num_threads(2)

# The keys of the JAX trainer's summary line (mpi_operator_tpu/cmd/train.py
# main, for a token model without jaxtrace).
JAX_SUMMARY_KEYS = {
    "model", "steps", "final_step", "loss", "examples_per_sec", "step_ms",
    "goodput", "devices", "preempted", "tokens_per_sec",
}
# A vision model's line has no tokens_per_sec.
JAX_VISION_SUMMARY_KEYS = JAX_SUMMARY_KEYS - {"tokens_per_sec"}
RESNET_ARGS = ["--device", "cpu", "--model", "resnet18", "--image-size",
               "32", "--global-batch", "4"]


def _summary(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_cpu_run_prints_the_jax_summary_keys(capsys):
    rc = train.main(["--device", "cpu", "--model", "llama-tiny", "--steps",
                     "3", "--warmup", "1"])
    assert rc == 0
    summary = _summary(capsys)
    assert JAX_SUMMARY_KEYS <= set(summary)
    assert summary["model"] == "llama-tiny"
    assert summary["steps"] == summary["final_step"] == 3
    assert summary["device"] == "cpu" and summary["devices"] == 1
    assert math.isfinite(summary["loss"]) and math.isfinite(summary["first_loss"])
    assert summary["preempted"] is False
    assert summary["tokens_per_sec"] > 0 and summary["step_ms"] > 0


def test_loss_falls_with_grad_accum_and_cosine_schedule(capsys):
    rc = train.main(["--device", "cpu", "--model", "llama-tiny", "--steps",
                     "6", "--warmup", "1", "--seq-len", "32",
                     "--global-batch", "4", "--grad-accum", "2", "--lr",
                     "1e-2", "--lr-schedule", "cosine", "--warmup-steps", "2",
                     "--xent-chunk", "8", "--telemetry-every", "0"])
    assert rc == 0
    summary = _summary(capsys)
    assert summary["loss"] < summary["first_loss"]


REFUSED = {
    # sp trains since ring and Ulysses came, with tp too, and BERT's
    # gathered positions on it: past the checks, one process stops only
    # at the mesh's device count.
    "mesh-sp-positions": (["--model", "bert-tiny", "--mlm-layout",
                           "positions", "--mesh", "sp=2"],
                          "require 2 devices, have 1"),
    # pp is ported: past the checks, one process stops only at the
    # mesh's device count.
    "mesh-pp": (["--mesh", "dp=1,pp=2"], "require 2 devices, have 1"),
}


@pytest.mark.parametrize("flag", sorted(REFUSED))
def test_unported_flags_refuse_loudly(flag):
    extra, match = REFUSED[flag]
    argv = ["--device", "cpu", "--model", "llama-tiny", "--steps", "1", *extra]
    with pytest.raises(SystemExit, match=match):
        train.main(argv)


PORTED_MESHES = {
    # MoE on tp and fsdp, with ep or not, and tp x sp: past the mesh
    # checks, one process stops only at the mesh's device count.
    "moe": (["--model", "mixtral-8x7b", "--mesh", "tp=2"], 2),
    "moe-tiny": (["--model", "llama-moe-tiny", "--mesh", "fsdp=2"], 2),
    "mesh": (["--mesh", "sp=2,tp=2"], 4),
    "mesh-ep": (["--model", "llama-moe-tiny", "--mesh", "ep=2,tp=2"], 4),
}


@pytest.mark.parametrize("flag", sorted(PORTED_MESHES))
def test_ported_meshes_pass_the_checks(flag):
    extra, n = PORTED_MESHES[flag]
    argv = ["--device", "cpu", "--model", "llama-tiny", "--steps", "1", *extra]
    with pytest.raises(SystemExit, match=f"require {n} devices, have 1"):
        train.main(argv)


SP_REFUSED = {
    # The JAX trainer's reasons.
    "moe": (["--model", "llama-moe-tiny", "--mesh", "sp=2"],
            "routing capacity is per sequence"),
    "seq-len": (["--mesh", "sp=2", "--seq-len", "15"],
                "--seq-len 15 not divisible by sp=2"),
    "zigzag": (["--mesh", "sp=2", "--seq-len", "18", "--zigzag-ring"],
               "--zigzag-ring needs --seq-len divisible by 2\\*sp=4"),
    "no-sequence": (["--model", "resnet18", "--mesh", "sp=2"],
                    "shards the sequence of the token models"),
    # Ulysses splits a tp rank's heads (4 / tp=2) over sp.
    "ulysses-tp": (["--mesh", "sp=4,tp=2", "--seq-len", "16",
                    "--sequence-parallel", "ulysses"],
                   "needs sp=4 to divide the 2 heads a tp=2 rank holds"),
}


@pytest.mark.parametrize("case", sorted(SP_REFUSED))
def test_sp_mesh_refuses_what_it_cannot_shard(case):
    extra, match = SP_REFUSED[case]
    argv = ["--device", "cpu", "--model", "llama-tiny", "--steps", "1", *extra]
    with pytest.raises(SystemExit, match=match):
        train.main(argv)


def test_sp_batch_targets_cross_the_ranks_edges():
    """An sp rank's Llama batch: the next-token target of its last
    position is the next rank's first token, the last global position is
    weighted 0, and the zigzag ranks' columns together are the whole
    sequence's targets."""
    tokens = np.arange(24).reshape(2, 12)
    positions = np.array([0, 1, 2, 9, 10, 11])  # zigzag rank 0 of 2
    toks, targets, weights = train._sequence_batch(tokens, positions)
    np.testing.assert_array_equal(toks, tokens[:, positions])
    np.testing.assert_array_equal(targets[0], [1, 2, 3, 10, 11, 0])
    np.testing.assert_array_equal(weights[0], [1, 1, 1, 1, 1, 0])
    args = train.build_parser().parse_args(["--zigzag-ring",
                                            "--model", "llama-tiny"])
    assert train.llama_config_from_args(args, 2).zigzag_ring
    assert not train.llama_config_from_args(args, 1).zigzag_ring
    args.sequence_parallel = "ulysses"  # ulysses ignores --zigzag-ring
    cfg = train.llama_config_from_args(args, 2)
    assert cfg.attention_impl == "ulysses" and not cfg.zigzag_ring


@pytest.mark.parametrize("bn_kernel", ["xla", "pallas"])
def test_resnet_cpu_run_prints_the_jax_vision_summary_keys(capsys, bn_kernel):
    rc = train.main([*RESNET_ARGS, "--steps", "3", "--warmup", "1",
                     "--bn-kernel", bn_kernel, "--telemetry-every", "0"])
    assert rc == 0
    summary = _summary(capsys)
    assert set(summary) >= JAX_VISION_SUMMARY_KEYS
    assert "tokens_per_sec" not in summary
    assert summary["model"] == "resnet18" and summary["steps"] == 3
    assert math.isfinite(summary["loss"]) and summary["examples_per_sec"] > 0


def test_resnet_grad_accum_is_refused_with_the_jax_message():
    with pytest.raises(SystemExit, match="--grad-accum applies to LM models "
                                         "only \\(BatchNorm statistics"):
        train.main([*RESNET_ARGS, "--steps", "1", "--grad-accum", "2"])


def test_default_model_is_resnet101_and_ported():
    args = train.build_parser().parse_args([])
    assert args.model == "resnet101" and args.bn_kernel == "xla"
    assert args.device == "cuda" and args.image_size == 224
    train.check_moe_mesh(args)  # no SystemExit
    train.check_sp_mesh(args)


def test_resnet_workload_is_the_jax_trainers():
    """Batch 64 a device by default, SGD with nesterov momentum 0.9, the
    BN route --bn-kernel names, and the JAX trainer's numpy draw: images
    first, then labels, from RandomState(seed)."""
    from mpi_operator_tpu_torch.ops import bn as tbn

    mesh = create_mesh(device="cpu", dp=-1)
    args = train.build_parser().parse_args(
        ["--device", "cpu", "--model", "resnet18", "--image-size", "8",
         "--seed", "7", "--bn-kernel", "pallas"])
    work = train.build_workload(args, mesh, 1)
    images, labels = work.batch
    assert images.shape == (64, 3, 8, 8) and work.examples_per_step == 64
    assert images.is_contiguous(memory_format=torch.channels_last)
    rng = np.random.RandomState(7)
    want = rng.standard_normal((64, 8, 8, 3)).astype(np.float32)
    np.testing.assert_array_equal(images.permute(0, 2, 3, 1).numpy(), want)
    np.testing.assert_array_equal(labels.numpy(), rng.randint(0, 1000, (64,)))
    group = work.optimizer.param_groups[0]
    assert isinstance(work.optimizer, torch.optim.SGD)
    assert (group["momentum"], group["nesterov"], group["dampening"],
            group["weight_decay"]) == (0.9, True, 0, 0)
    assert work.model.training
    assert all(isinstance(m, tbn.TpuBatchNorm)
               for m in work.model.modules() if isinstance(m, tbn._BatchNormBase))


@pytest.mark.parametrize("layout", ["mask", "positions"])
def test_bert_tiny_batch_is_the_jax_trainers_and_the_loss_falls(capsys,
                                                                layout):
    """The first batch equals the JAX trainer's ``_lm_workload`` draw for
    the same seed and flags; six AdamW steps on it lower the loss."""
    import jax

    from mpi_operator_tpu.cmd import train as jtrain
    from mpi_operator_tpu.parallel import create_mesh as jax_mesh

    argv = ["--model", "bert-tiny", "--seq-len", "32", "--global-batch", "4",
            "--seed", "5", "--mlm-layout", layout]
    want = jtrain._lm_workload(jtrain.build_parser().parse_args(argv),
                               jax_mesh(devices=jax.devices()[:1], dp=1), 1)
    args = train.build_parser().parse_args(["--device", "cpu", *argv])
    got = train._lm_workload(args, create_mesh(device="cpu", dp=-1), 1)
    assert len(got.batch) == len(want.batch) == (4 if layout == "positions"
                                                  else 3)
    for g, w in zip(got.batch, want.batch):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got.tokens_per_step == want.tokens_per_step == 4 * 32

    rc = train.main(["--device", "cpu", *argv, "--steps", "6", "--warmup",
                     "1", "--lr", "1e-2", "--telemetry-every", "0"])
    assert rc == 0
    summary = _summary(capsys)
    assert summary["model"] == "bert-tiny" and summary["steps"] == 6
    assert JAX_SUMMARY_KEYS <= set(summary)
    assert summary["loss"] < summary["first_loss"]


def _jax_workload(argv):
    import jax

    from mpi_operator_tpu.cmd import train as jtrain
    from mpi_operator_tpu.parallel import create_mesh as jax_mesh

    return jtrain.build_workload(jtrain.build_parser().parse_args(argv),
                                 jax_mesh(devices=jax.devices()[:1], dp=1), 1)


ARMS = {
    "vit": ["--model", "vit-tiny", "--global-batch", "4", "--seed", "5"],
    "seq2seq": ["--model", "seq2seq-tiny", "--global-batch", "4",
                "--seq-len", "40", "--seed", "5"],
}


@pytest.mark.parametrize("arm", sorted(ARMS))
def test_vit_and_seq2seq_batches_are_the_jax_trainers(arm):
    """Each arm's synthetic batch equals the JAX trainer's for one seed
    (ViT: NHWC images, then labels; seq2seq: the copy task, src_len =
    min(--seq-len, max_seq_len), targets = the source's first half), with
    the JAX trainer's examples and tokens per step."""
    argv = ARMS[arm]
    want = _jax_workload(argv)
    args = train.build_parser().parse_args(["--device", "cpu", *argv])
    got = train.build_workload(args, create_mesh(device="cpu", dp=-1), 1)
    assert len(got.batch) == len(want.batch) == 2
    for g, w in zip(got.batch, want.batch):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got.examples_per_step == want.examples_per_step == 4
    assert got.tokens_per_step == want.tokens_per_step
    if arm == "seq2seq":
        assert got.batch[0].shape == (4, 40) and got.batch[1].shape == (4, 20)
        assert got.tokens_per_step == 4 * (40 + 20)
    assert isinstance(got.optimizer, torch.optim.AdamW)
    assert got.optimizer.param_groups[0]["weight_decay"] == 1e-4


@pytest.mark.parametrize("model", ["vit-tiny", "seq2seq-tiny"])
def test_vit_and_seq2seq_cpu_runs_print_the_jax_keys_and_learn(capsys,
                                                                model):
    rc = train.main(["--device", "cpu", "--model", model, "--global-batch",
                     "4", "--seq-len", "32", "--steps", "6", "--warmup", "1",
                     "--lr", "1e-2", "--grad-accum", "2",
                     "--telemetry-every", "0"])
    assert rc == 0
    summary = _summary(capsys)
    want_keys = (JAX_SUMMARY_KEYS if model.startswith("seq2seq")
                 else JAX_VISION_SUMMARY_KEYS)
    assert want_keys <= set(summary)
    assert ("tokens_per_sec" in summary) == model.startswith("seq2seq")
    assert summary["model"] == model and summary["steps"] == 6
    assert math.isfinite(summary["loss"])
    assert summary["loss"] < summary["first_loss"]


def test_default_batches_and_unknown_names():
    """ViT trains 64 images a device and seq2seq 16 pairs by default, as
    in the JAX trainer; an unknown name of either family exits."""
    mesh = create_mesh(device="cpu", dp=-1)
    for model, want in (("vit-tiny", 64), ("seq2seq-tiny", 16)):
        args = train.build_parser().parse_args(
            ["--device", "cpu", "--model", model])
        work = train.build_workload(args, mesh, 1)
        assert work.examples_per_step == want
    # --seq-len past the table: seq2seq clamps src_len to max_seq_len.
    assert work.batch[0].shape == (16, 64) and work.batch[1].shape == (16, 32)
    for name in ("vit-large", "seq2seq-base"):
        with pytest.raises(SystemExit, match=f"unknown --model '{name}'"):
            train.main(["--device", "cpu", "--model", name, "--steps", "1"])


def test_unknown_bert_names_exit_with_the_jax_message():
    with pytest.raises(SystemExit, match="bert models are bert-base or "
                                         "bert-tiny"):
        train.main(["--device", "cpu", "--model", "bert-large", "--steps",
                    "1"])


def test_bert_sequences_longer_than_the_table_grow_it():
    args = train.build_parser().parse_args(
        ["--device", "cpu", "--model", "bert-tiny", "--seq-len", "80",
         "--global-batch", "2"])
    work = train._lm_workload(args, create_mesh(device="cpu", dp=-1), 1)
    assert work.model.config.max_seq_len == 80
    assert work.model.pos_embed.weight.shape == (80, 32)


def test_cuda_without_a_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: cuda is not refused here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--model", "llama-tiny", "--steps", "1"])


def test_synthetic_batch_is_the_jax_trainers():
    args = train.build_parser().parse_args(
        ["--device", "cpu", "--model", "llama-tiny", "--seq-len", "24",
         "--global-batch", "3", "--seed", "7"])
    work = train._lm_workload(args, create_mesh(device="cpu", dp=-1), 1)
    # mpi_operator_tpu/cmd/train.py draws the llama tokens as the first
    # use of RandomState(seed): randint(0, vocab, (batch, seq)).
    want = np.random.RandomState(7).randint(0, 256, (3, 24))
    np.testing.assert_array_equal(work.batch[0].numpy(), want)


def test_cosine_schedule_matches_optax():
    import optax

    args = train.build_parser().parse_args(
        ["--lr", "0.5", "--lr-schedule", "cosine", "--warmup-steps", "3",
         "--steps", "10"])
    got = train._make_learning_rate(args)
    want = optax.warmup_cosine_decay_schedule(
        init_value=0.0, peak_value=0.5, warmup_steps=3, decay_steps=10)
    np.testing.assert_allclose([got(i) for i in range(12)],
                               [float(want(i)) for i in range(12)],
                               rtol=1e-6, atol=1e-7)


def test_grad_accum_matches_the_full_batch_step():
    tokens = torch.tensor(np.random.RandomState(3).randint(0, 256, (4, 12)))
    results = []
    for accum in (1, 2):
        torch.manual_seed(0)
        model = tllama.Llama(tllama.tiny(attention_impl="flash"), device="cpu")
        tllama.init_params(model, torch.Generator().manual_seed(0))
        opt = torch.optim.AdamW(model.parameters(), lr=1e-2, weight_decay=1e-4)
        step = tllama.make_train_step(model, opt, accum_steps=accum)
        loss = float(step(tokens))
        results.append((loss, [p.detach().clone() for p in model.parameters()]))
    np.testing.assert_allclose(results[1][0], results[0][0], rtol=1e-6)
    for p1, p2 in zip(results[0][1], results[1][1]):
        torch.testing.assert_close(p2, p1, rtol=0, atol=1e-5)


def test_metrics_expose_like_the_jax_packages_copy():
    from mpi_operator_tpu.utils import metrics as jmetrics
    from mpi_operator_tpu_torch.utils import metrics as tmetrics

    texts = []
    for lib in (jmetrics, tmetrics):
        reg = lib.Registry()
        c = lib.new_counter("tpu_operator_x_total", 'help \\ "q"\nnl',
                            ("phase",), reg)
        c.inc(1, "warmup")
        c.inc(2.5, 'tr"ain')
        lib.new_gauge("tpu_operator_g", "g", registry=reg).set(0.5)
        h = lib.new_histogram("tpu_operator_h_seconds", "h", registry=reg,
                              buckets=(0.1, 1.0))
        for v in (0.05, 0.5, 5.0):
            h.observe(v)
        texts.append(reg.expose())
    assert texts[1] == texts[0]


def test_telemetry_records_and_one_final_record(tmp_path):
    from mpi_operator_tpu_torch.utils import metrics, telemetry

    path = tmp_path / "telemetry.jsonl"
    telem = telemetry.TrainingTelemetry(
        tokens_per_step=8, examples_per_step=2, registry=metrics.Registry(),
        interval=2, jsonl_path=str(path))
    telem.start()
    for step in range(1, 5):
        telem.record_step(step, 0.01, warmup=step == 1)
    telem.close(4, final=True)
    telem.close(4, final=True)  # a second SIGTERM emits nothing more
    recs = [json.loads(line) for line in path.read_text().splitlines()]
    assert [r["step"] for r in recs] == [2, 4, 4]
    assert [r.get("final", False) for r in recs] == [False, False, True]
    assert all(r["event"] == "train_telemetry" and "tokens_per_sec" in r
               for r in recs)
    assert 0 < telem.goodput_ratio() <= 1


def test_adopted_trace_id_reaches_log_lines(capsys):
    from mpi_operator_tpu_torch.utils import trace
    from mpi_operator_tpu_torch.utils.logging import get_logger

    prev = trace.adopt_context(None)
    try:
        assert trace.adopt_from_environ({"TPU_TRACE_CONTEXT": "bad"}) is None
        ctx = trace.adopt_from_environ({"TPU_TRACE_CONTEXT": "t0ab-00c1"})
        assert (ctx.trace_id, ctx.span_id) == ("t0ab", "00c1")
        get_logger("train").info("step %d", 3, loss=1.5)
    finally:
        trace.adopt_context(prev)
    line = capsys.readouterr().err.strip().splitlines()[-1]
    assert line.endswith('train] step 3 loss=1.5 trace_id="t0ab"')


def test_mesh_is_one_device():
    """A world of one process keeps the one-device mesh; a wider axis
    needs that many processes (ep, sp and pp too, now ported;
    ``tests/test_torch_mesh.py`` holds the rest)."""
    mesh = create_mesh(device="cpu", dp=-1, tp=1)
    assert mesh.sizes == {"dp": 1, "tp": 1} and mesh.device_mesh is None
    for axis in ("fsdp", "ep", "sp", "pp"):
        with pytest.raises(ValueError, match="require 2 devices, have 1"):
            create_mesh(device="cpu", **{axis: 2})


# -- --data: the token stream -------------------------------------------

def _corpus(tmp_path, n_seq: int, seq_len: int, high: int, seed: int = 0):
    from mpi_operator_tpu_torch.data import write_token_file

    path = tmp_path / "corpus.u32"
    write_token_file(path, np.random.RandomState(seed).randint(
        0, high, n_seq * seq_len))
    return str(path)


DATA_ARMS = {
    "llama": ["--model", "llama-tiny"],
    "bert-mask": ["--model", "bert-tiny", "--mlm-layout", "mask"],
    "bert-positions": ["--model", "bert-tiny", "--mlm-layout", "positions"],
}


@pytest.mark.parametrize("arm", sorted(DATA_ARMS))
def test_data_batches_are_the_jax_trainers(monkeypatch, tmp_path, arm):
    """10 sequences, B=4: step 2 takes positions 8..11, two from epoch 0
    and two from epoch 1, and steps 0-4 walk into epoch 2. Ids up to
    1000 exercise the ``% vocab`` of both trainers."""
    import os

    from mpi_operator_tpu.ops import attention as jattn

    # The reference's _flat_pack reads os.environ, but its module never
    # imports os (tests/test_torch_llama.py): supply the module global.
    monkeypatch.setattr(jattn, "os", os, raising=False)
    data = _corpus(tmp_path, 10, 16, 1000)
    argv = [*DATA_ARMS[arm], "--seq-len", "16", "--global-batch", "4",
            "--seed", "3", "--data", data]
    want = _jax_workload(argv)
    args = train.build_parser().parse_args(["--device", "cpu", *argv])
    got = train.build_workload(args, create_mesh(device="cpu", dp=-1), 1)
    assert got.batch_fn is not None
    for step in range(5):
        ours, theirs = got.batch_fn(step), want.batch_fn(step)
        assert len(ours) == len(theirs) == len(got.batch)
        for g, w, synthetic in zip(ours, theirs, got.batch):
            assert g.device.type == "cpu" and g.dtype == synthetic.dtype
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("model", ["resnet18", "vit-tiny", "seq2seq-tiny"])
def test_data_is_refused_where_the_jax_trainer_ignores_it(model):
    with pytest.raises(SystemExit, match="only the token models"):
        train.main(["--device", "cpu", "--model", model, "--steps", "1",
                    "--data", "corpus.u32"])


def test_llama_trains_from_a_token_file(capsys, tmp_path):
    data = _corpus(tmp_path, 5, 32, 256)
    rc = train.main(["--device", "cpu", "--model", "llama-tiny", "--steps",
                     "6", "--warmup", "1", "--seq-len", "32",
                     "--global-batch", "2", "--lr", "1e-2", "--data", data,
                     "--telemetry-every", "0"])
    assert rc == 0
    summary = _summary(capsys)
    assert summary["final_step"] == 6 and math.isfinite(summary["loss"])
    assert summary["loss"] < summary["first_loss"]
