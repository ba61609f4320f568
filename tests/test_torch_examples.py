"""The port's example jobs (``mpi_operator_tpu_torch/examples/``).

Each JAX example under ``examples/v2beta1/`` but pi has a counterpart in
the port (the map below), and each of the port's TPUJobs is held as
``tests/test_manifests.py`` holds the JAX package's, on the port's own
terms: the port's CRD schema, defaulting and admission; the mesh against
the GPU count; the command's own parser and mesh checks
(``cmd.train``'s ``check_moe_mesh``, ``check_sp_mesh`` and
``check_pp_mesh``, ``cmd.generate``'s ``check_decode_mesh``); the flags
against the JAX file's; and the worker pods the port's controller
renders from it, one a GPU. The elastic job's resize, the queueing
tenants' quotas in GPUs and the images every example names are held
too.
"""

from __future__ import annotations

import math
import pathlib
import re

import pytest
import yaml

from mpi_operator_tpu_torch.api import topology
from mpi_operator_tpu_torch.api.schema import validate_schema
from mpi_operator_tpu_torch.api.v2beta1 import constants
from mpi_operator_tpu_torch.api.v2beta1.defaults import set_defaults_tpujob
from mpi_operator_tpu_torch.api.v2beta1.queue_types import (
    ClusterQueue, LocalQueue)
from mpi_operator_tpu_torch.api.v2beta1.types import TPUJob
from mpi_operator_tpu_torch.api.validation import validate_tpujob
from mpi_operator_tpu_torch.cmd import gen_manifests
from mpi_operator_tpu_torch.queue.quota import QueueQuota, QuotaLedger
from tests.test_torch_builders import GPU_DROPPED_ENV, GPU_ENV_KEYS, PORT
from tests.test_torch_controller import Fixture

pytestmark = pytest.mark.kernel

ROOT = pathlib.Path(__file__).resolve().parent.parent
JAX_EXAMPLES = ROOT / "examples" / "v2beta1"
PORT_PKG = ROOT / "mpi_operator_tpu_torch"
EXAMPLES = PORT_PKG / "examples"

# Every file of the JAX package's examples but pi's, and its counterpart
# here. A JAX example added without one fails the first test.
COUNTERPARTS = {
    "jax-llama/jax-llama-fsdp.yaml": "llama/llama-fsdp.yaml",
    "jax-llama/jax-llama-multislice.yaml": "llama/llama-multinode.yaml",
    "jax-llama-pp/jax-llama-pp-3d.yaml": "llama-pp/llama-pp-3d.yaml",
    "jax-longcontext/jax-llama-ring-32k.yaml":
        "longcontext/llama-ring-32k.yaml",
    "jax-moe/jax-mixtral-ep.yaml": "moe/mixtral-ep.yaml",
    "jax-bert/jax-bert.yaml": "bert/bert.yaml",
    "jax-seq2seq/jax-seq2seq.yaml": "seq2seq/seq2seq.yaml",
    "jax-vit/jax-vit.yaml": "vit/vit.yaml",
    "jax-resnet/jax-resnet.yaml": "resnet/resnet.yaml",
    "jax-llama-infer/jax-llama-infer.yaml": "llama-infer/llama-infer.yaml",
    "elastic/jax-elastic.yaml": "elastic/elastic.yaml",
    "queueing/queues.yaml": "queueing/queues.yaml",
    "queueing/two-tenants.yaml": "queueing/two-tenants.yaml",
    "queueing/README.md": "queueing/README.md",
}

# Every image an example names, and the Dockerfile that builds it.
DOCKERFILES = {
    "tpu-job-operator/gpu-worker:latest": "build/worker/Dockerfile",
    "tpu-job-operator/examples:pi-torch": "build/pi/Dockerfile",
    gen_manifests.IMAGE: "build/operator/Dockerfile",
}

# The one flag the port's files add to the JAX files': an AdamW rate for
# the models the JAX files train at the trainer's default --lr, 0.1,
# ResNet's SGD rate, at which AdamW diverges (the examples' headers).
ADAMW_LR = {"llama3-8b": "3e-4", "mixtral-8x7b": "3e-4", "bert-base": "1e-4",
            "seq2seq-small": "3e-4", "vit-base": "3e-4"}

# The port's trainer in place of the JAX jobs' bench.py line: the bench's
# per-chip batch flag and the model its suite flags name.
BENCH_BATCH = {"--vit-batch": "vit-base", "--batch-per-chip": "resnet"}


def load_all(path: pathlib.Path) -> list[dict]:
    return [d for d in yaml.safe_load_all(path.read_text()) if d]


def port_jobs() -> list[tuple[str, int]]:
    """(path under examples/, document index) of every TPUJob here."""
    out = []
    for path in sorted(EXAMPLES.rglob("*.yaml")):
        for i, doc in enumerate(load_all(path)):
            if doc.get("kind") == "TPUJob":
                out.append((str(path.relative_to(EXAMPLES)), i))
    return out


JOBS = port_jobs()
JOB_IDS = [f"{rel}[{i}]" for rel, i in JOBS]


def job_doc(rel: str, index: int) -> dict:
    return load_all(EXAMPLES / rel)[index]


def jax_doc(rel: str, index: int):
    """The JAX file's document that ``rel[index]`` counts for (None for
    pi, whose counterpart the JAX package keeps as its own smoke job)."""
    jax_rel = {v: k for k, v in COUNTERPARTS.items()}.get(rel)
    return load_all(JAX_EXAMPLES / jax_rel)[index] if jax_rel else None


def container(doc: dict) -> dict:
    (main,) = doc["spec"]["tpuReplicaSpecs"]["Worker"]["template"]["spec"][
        "containers"]
    return main


def gpus(doc: dict) -> int:
    tpu = doc["spec"]["tpu"]
    return topology.resolve(tpu["acceleratorType"], tpu.get("topology") or "").chips


def flags(argv: list) -> dict:
    """``--name=value`` flags by name; a bare ``--name`` is True and a
    repeated flag a list of its values."""
    out: dict = {}
    for arg in argv:
        name, eq, value = arg.partition("=")
        value = value if eq else True
        if name in out:
            prev = out[name]
            out[name] = [*(prev if isinstance(prev, list) else [prev]), value]
        else:
            out[name] = value
    return out


def command(doc: dict) -> tuple[str, dict]:
    """(the module ``python -m`` runs, its flags)."""
    argv = container(doc)["command"]
    assert argv[:2] == ["python", "-m"], argv
    return argv[2], flags(argv[3:])


def mesh_sizes(spec) -> dict:
    from mpi_operator_tpu_torch.cmd.train import parse_mesh_spec

    return parse_mesh_spec(spec or "")


def test_every_jax_example_has_a_counterpart():
    jax_files = {str(p.relative_to(JAX_EXAMPLES))
                 for p in JAX_EXAMPLES.glob("*/*") if p.parent.name != "pi"}
    assert jax_files == set(COUNTERPARTS)
    for rel in COUNTERPARTS.values():
        assert (EXAMPLES / rel).is_file(), rel
    # Each JAX file's TPUJobs have counterparts one for one.
    for jax_rel, rel in COUNTERPARTS.items():
        if jax_rel.endswith(".yaml"):
            kinds = [d["kind"] for d in load_all(JAX_EXAMPLES / jax_rel)]
            assert [d["kind"] for d in load_all(EXAMPLES / rel)] == kinds


@pytest.mark.parametrize("rel,index", JOBS, ids=JOB_IDS)
def test_example_validates_against_the_crd_schema(rel, index):
    (crd,) = load_all(PORT_PKG / "deploy" / "crd.yaml")
    (version,) = crd["spec"]["versions"]
    schema = version["schema"]["openAPIV3Schema"]
    assert validate_schema(job_doc(rel, index), schema) == []


@pytest.mark.parametrize("rel,index", JOBS, ids=JOB_IDS)
def test_example_passes_defaulting_and_admission(rel, index):
    doc = job_doc(rel, index)
    job = TPUJob.from_dict(doc)
    set_defaults_tpujob(job)
    assert validate_tpujob(job) == []
    # One worker pod a GPU, on one h100-<gpus> type (no slices).
    assert job.spec.replica_specs["Worker"].replicas == gpus(doc)
    assert job.spec.tpu.num_slices == 1
    assert "google.com/tpu" not in yaml.safe_dump(doc)
    assert "MEGASCALE" not in yaml.safe_dump(doc)


@pytest.mark.parametrize("rel,index", JOBS, ids=JOB_IDS)
def test_example_mesh_is_the_gpu_count(rel, index):
    doc = job_doc(rel, index)
    _, args = command(doc)
    sizes = mesh_sizes(args.get("--mesh"))
    if "--mesh" not in args:
        # dp=-1: the trainer's default mesh, dp over every process.
        assert sizes == {"dp": -1}
        return
    assert math.prod(sizes.values()) == gpus(doc), (args["--mesh"], gpus(doc))
    jax = jax_doc(rel, index)
    if jax is not None and "--mesh" in flags(container(jax)["command"]):
        assert args["--mesh"] == flags(container(jax)["command"])["--mesh"]


def _check_train(argv: list) -> None:
    from mpi_operator_tpu_torch.cmd import train

    args = train.build_parser().parse_args(argv)
    assert args.model in train.PORTED_MODELS
    sizes = train.parse_mesh_spec(args.mesh)
    train.check_moe_mesh(args)
    train.check_sp_mesh(args)
    if sizes.get("pp", 1) > 1:
        _, microbatches = train.check_pp_mesh(args, sizes, args.global_batch)
        assert microbatches >= sizes["pp"]
    if args.global_batch:
        shards = sizes.get("dp", 1) * sizes.get("fsdp", 1)
        assert args.global_batch % args.grad_accum == 0
        assert (args.global_batch // args.grad_accum) % shards == 0


def _check_eval(argv: list) -> None:
    from mpi_operator_tpu_torch.cmd import eval as eval_cmd
    from mpi_operator_tpu_torch.models import llama

    args = eval_cmd.build_parser().parse_args(argv)
    assert args.model in llama.CONFIGS
    sizes = mesh_sizes(args.mesh)
    # cmd.eval's own refusal: dp, fsdp and tp only.
    assert set(sizes) <= {"dp", "fsdp", "tp"}
    assert args.batch % (sizes.get("dp", 1) * sizes.get("fsdp", 1)) == 0


def _check_generate(argv: list) -> None:
    from mpi_operator_tpu_torch.cmd import generate
    from mpi_operator_tpu_torch.models import llama

    args = generate.build_parser().parse_args(argv)
    cfg = llama.config_for(args.model)
    generate.check_decode_mesh(mesh_sizes(args.mesh), cfg, args.model)
    prompts = [[int(t) for t in p.split(",")] for p in args.prompt]
    assert len({len(p) for p in prompts}) == 1
    assert all(0 <= t < cfg.vocab_size for p in prompts for t in p)
    assert len(prompts[0]) + args.max_new <= cfg.max_seq_len


CHECKS = {
    "mpi_operator_tpu_torch.cmd.train": _check_train,
    "mpi_operator_tpu_torch.cmd.eval": _check_eval,
    "mpi_operator_tpu_torch.cmd.generate": _check_generate,
    "mpi_operator_tpu_torch.examples.pi": lambda argv: None,
}


@pytest.mark.parametrize("rel,index", JOBS, ids=JOB_IDS)
def test_example_command_passes_its_parser_and_checks(rel, index):
    doc = job_doc(rel, index)
    argv = container(doc)["command"]
    assert argv[:2] == ["python", "-m"], argv
    CHECKS[argv[2]](argv[3:])


def _from_bench(jax_args: dict, n_gpus: int) -> dict:
    """The trainer's flags for a JAX job's ``bench.py`` line: the suite's
    model, the per-chip batch times the GPUs, the same steps, dp over
    every GPU."""
    (batch_flag,) = set(BENCH_BATCH) & set(jax_args)
    model = ("vit-base" if jax_args.get("--suite") == "vit"
             else f"resnet{jax_args['--depth']}")
    assert model.startswith(BENCH_BATCH[batch_flag])
    return {"--model": model, "--mesh": f"dp={n_gpus}",
            "--global-batch": str(int(jax_args[batch_flag]) * n_gpus),
            "--steps": jax_args["--steps"]}


@pytest.mark.parametrize("rel,index", JOBS, ids=JOB_IDS)
def test_example_flags_are_the_jax_files(rel, index):
    doc, jax = job_doc(rel, index), jax_doc(rel, index)
    argv = container(doc)["command"]
    jax_argv = container(jax)["command"] if jax is not None else None
    if jax_argv is None or jax_argv[:2] != ["python", "-m"] and (
            jax_argv[1] != "bench.py"):
        # pi and the queueing tenants run the port's pi, as the JAX
        # package's run its own pi script.
        assert argv == ["python", "-m", "mpi_operator_tpu_torch.examples.pi"]
        return
    module, got = command(doc)
    if jax_argv[1] == "bench.py":
        assert module == "mpi_operator_tpu_torch.cmd.train"
        want = _from_bench(flags(jax_argv[2:]), gpus(doc))
    else:
        want = flags(jax_argv[3:])
        # The elastic job's image runs "python -m train": here the port's.
        jax_module = jax_argv[2]
        assert module == (
            "mpi_operator_tpu_torch.cmd.train" if jax_module == "train"
            else jax_module.replace("mpi_operator_tpu.", f"{PORT}."))
    # Checkpoints are the port's own (DCP, not orbax): the directory is
    # there where the JAX job has one, under the port's own name.
    assert ("--checkpoint-dir" in got) == ("--checkpoint-dir" in want)
    got.pop("--checkpoint-dir", None)
    want.pop("--checkpoint-dir", None)
    if (module == "mpi_operator_tpu_torch.cmd.train" and "--lr" not in want
            and got.get("--model") in ADAMW_LR):
        assert got.pop("--lr") == ADAMW_LR[got["--model"]]
    assert got == want
    if container(jax).get("volumeMounts"):
        # (The elastic job's JAX file checkpoints to gs://, which the
        # port's checkpoints do not write: it mounts a volume instead.)
        assert container(doc)["volumeMounts"] == container(jax)[
            "volumeMounts"]


@pytest.mark.parametrize("rel,index", JOBS, ids=JOB_IDS)
def test_controller_renders_one_gpu_pod_per_gpu(rel, index):
    doc = job_doc(rel, index)
    n = gpus(doc)
    f = Fixture(PORT, doc["spec"]["tpu"]["acceleratorType"], n)
    doc["metadata"].update(name="test-job", namespace="default")
    f.controller.start()
    f.create(TPUJob.from_dict(doc))
    f.sync()
    pods = sorted(f.api.list("pods", "default"),
                  key=lambda p: int(p["metadata"]["name"].rsplit("-", 1)[1]))
    assert [p["metadata"]["name"] for p in pods] == [
        f"test-job-worker-{i}" for i in range(n)]
    main = container(doc)
    for i, pod in enumerate(pods):
        (c,) = pod["spec"]["containers"]
        assert c["resources"]["limits"] == {constants.GPU_RESOURCE_NAME: 1}
        assert c["command"] == main["command"] and c["image"] == main["image"]
        env = {e["name"]: e["value"] for e in c["env"]}
        assert set(env) >= GPU_ENV_KEYS and not set(env) & set(GPU_DROPPED_ENV)
        assert env[constants.ENV_NUM_PROCESSES] == str(n)
        assert env[constants.ENV_PROCESS_ID] == str(i)
        assert env[constants.ENV_COORDINATOR_ADDRESS].startswith(
            "test-job-worker-0.")
        assert env[constants.ENV_TPU_ACCELERATOR_TYPE] == (
            doc["spec"]["tpu"]["acceleratorType"])
        assert pod["metadata"]["annotations"][
            constants.WORLD_SIZE_ANNOTATION] == str(n)


@pytest.mark.parametrize("accel", ["h100-32", "h100-8"])
def test_elastic_resize_restarts_the_workers_with_the_new_world(accel):
    """The elastic example's scaling: acceleratorType and replicas patched
    together; every surviving pod's world-size stamp is stale, so the
    controller replaces it with the new TPUJOB_NUM_PROCESSES, and the
    job says it is restarting."""
    (doc,) = load_all(EXAMPLES / "elastic" / "elastic.yaml")
    before, after = gpus(doc), topology.resolve(accel, "").chips
    f = Fixture(PORT, doc["spec"]["tpu"]["acceleratorType"], before)
    doc["metadata"].update(name="test-job", namespace="default")
    f.controller.start()
    f.create(TPUJob.from_dict(doc))
    f.sync()
    uids = {p["metadata"]["name"]: p["metadata"]["uid"]
            for p in f.api.list("pods", "default")}
    assert len(uids) == before

    def resize(jd):
        jd["spec"]["tpu"]["acceleratorType"] = accel
        jd["spec"]["tpuReplicaSpecs"]["Worker"]["replicas"] = after

    f.patch_job(resize)
    f.sync()
    pods = f.api.list("pods", "default")
    assert len(pods) == after
    for pod in pods:
        name = pod["metadata"]["name"]
        assert pod["metadata"]["uid"] != uids.get(name)
        env = {e["name"]: e["value"]
               for e in pod["spec"]["containers"][0]["env"]}
        assert env[constants.ENV_NUM_PROCESSES] == str(after)
        assert env[constants.ENV_TPU_ACCELERATOR_TYPE] == accel
        assert pod["metadata"]["annotations"][
            constants.WORLD_SIZE_ANNOTATION] == str(after)
    assert f.s.status.has_condition(f.get_job().status, "Restarting")


def _queues() -> tuple[dict, dict]:
    docs = load_all(EXAMPLES / "queueing" / "queues.yaml")
    cqs = {d["metadata"]["name"]: ClusterQueue.from_dict(d)
           for d in docs if d["kind"] == "ClusterQueue"}
    lqs = {d["metadata"]["name"]: LocalQueue.from_dict(d)
           for d in docs if d["kind"] == "LocalQueue"}
    return cqs, lqs


def test_queues_load_into_the_gpu_ledger():
    """queues.yaml's ClusterQueues in GPUs, as the QueueManager loads
    them: 16 h100 each, one cohort, team-b's borrowing capped at 16; the
    two tenant jobs fit together and a third 16-GPU job fits neither
    queue (the README's waiting job)."""
    from mpi_operator_tpu_torch.runtime.apiserver import InMemoryAPIServer

    api = InMemoryAPIServer()
    for doc in load_all(EXAMPLES / "queueing" / "queues.yaml"):
        api.create({"ClusterQueue": "clusterqueues",
                    "LocalQueue": "localqueues"}[doc["kind"]], doc)
    cqs, _ = _queues()
    ledger = QuotaLedger()
    for name, cq in cqs.items():
        ledger.set_queue(name, cohort=cq.spec.cohort, quotas={
            q.generation: QueueQuota(q.nominal_quota, q.borrowing_limit)
            for q in cq.spec.quotas})
    assert {n: ledger.nominal(n, "h100") for n in cqs} == {
        "team-a": 16, "team-b": 16}
    assert {n: ledger.cohort_of(n) for n in cqs} == {
        "team-a": "research", "team-b": "research"}
    assert ledger.fits("team-b", "h100", 32)[0]
    assert not ledger.fits("team-b", "h100", 33)[0]
    jobs = load_all(EXAMPLES / "queueing" / "two-tenants.yaml")
    for doc in jobs:
        queue = doc["spec"]["runPolicy"]["schedulingPolicy"]["queue"]
        n = gpus(doc)
        assert ledger.fits(queue, "h100", n)[0]
        ledger.reserve(("default", doc["metadata"]["name"]), queue, "h100", n)
    for queue in cqs:
        assert not ledger.fits(queue, "h100", 16)[0]


def test_tenant_jobs_name_the_local_queues():
    cqs, lqs = _queues()
    for lq in lqs.values():
        assert lq.namespace == "default" and lq.spec.cluster_queue in cqs
    for doc in load_all(EXAMPLES / "queueing" / "two-tenants.yaml"):
        job = TPUJob.from_dict(doc)
        set_defaults_tpujob(job)
        assert validate_tpujob(job) == []
        assert job.spec.run_policy.scheduling_policy.queue in lqs
        assert gpus(doc) == 16


def test_every_image_an_example_names_has_a_dockerfile():
    images = {container(job_doc(rel, i))["image"] for rel, i in JOBS}
    assert images <= set(DOCKERFILES), images - set(DOCKERFILES)
    for image, dockerfile in DOCKERFILES.items():
        text = (PORT_PKG / dockerfile).read_text()
        built = re.search(r"docker build -t (\S+)", text)
        assert built and built[1] == image, dockerfile
        assert f"-f mpi_operator_tpu_torch/{dockerfile} ." in text
