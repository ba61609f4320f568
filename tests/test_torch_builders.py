"""The port's object builders against the JAX package's, on twin jobs.

A twin is one manifest rendered twice: once for the JAX package with a
TPU ``acceleratorType`` and once for the port with the ``h100-<gpus>``
type of the same worker count (``h100-2`` / ``v5p-8``: 2 workers;
``h100-4`` / ``v5e-16``: 4). Every object the builders render (Services,
ConfigMap, worker pods, launcher Job, PodGroups, spares) must be equal
after :func:`normalize`, which masks exactly the keys the GPU design
changes and nothing else:

- ``GPU_DROPPED_ENV``: worker/spare env the port does not render;
- ``ACCELERATOR_ENV``: env whose value names the accelerator;
- ``ACCELERATOR_RESOURCES``: ``google.com/tpu`` (the host's chips) vs
  ``nvidia.com/gpu`` (1), checked on their own below;
- ``LAUNCHER_MODULES``: the default and spare commands name each
  package's own launcher module;
- the accelerator type and topology strings themselves;
- ``TPU_TRACE_CONTEXT``'s value and object uids, which hold process-wide
  counters and random ids on either side (their presence still counts).

The helpers here are shared by the controller and scheduler parity tests.
"""

from __future__ import annotations

import importlib
from types import SimpleNamespace

import pytest

pytestmark = pytest.mark.kernel

JAX, PORT = "mpi_operator_tpu", "mpi_operator_tpu_torch"

# (JAX acceleratorType, port acceleratorType, workers on either side).
TWINS = [("v5p-8", "h100-2", 2), ("v5e-16", "h100-4", 4)]
# The same, for a resize to a larger twin (v5e-32: 8 hosts; h100-8).
LARGE_TWIN = ("v5e-32", "h100-8", 8)

GPU_DROPPED_ENV = (
    "TPU_WORKER_ID",
    "TPU_WORKER_HOSTNAMES",
    "TPU_CHIPS_PER_HOST",
    "TPUJOB_NUM_SLICES",
    "TPUJOB_SLICE_ID",
    "MEGASCALE_COORDINATOR_ADDRESS",
    "MEGASCALE_NUM_SLICES",
    "MEGASCALE_SLICE_ID",
    "MEGASCALE_PORT",
)
ACCELERATOR_ENV = ("TPU_ACCELERATOR_TYPE", "TPU_TOPOLOGY")
ACCELERATOR_RESOURCES = ("google.com/tpu", "nvidia.com/gpu")
LAUNCHER_MODULES = {
    f"{pkg}.launcher.{mod}": f"<{mod}>"
    for pkg in (JAX, PORT) for mod in ("healthcheck", "park")
}
# The GPU worker env, exactly (the builders open a span, so the trace
# context is always there).
GPU_ENV_KEYS = {
    "TPUJOB_COORDINATOR_ADDRESS", "TPUJOB_NUM_PROCESSES", "TPUJOB_PROCESS_ID",
    "TPUJOB_NAME", "TPUJOB_NAMESPACE", "TPU_ACCELERATOR_TYPE", "TPU_TOPOLOGY",
    "TPU_TRACE_CONTEXT",
}
TEMPLATE = {"spec": {"containers": [{"name": "main", "image": "img"}]}}


def side(pkg: str) -> SimpleNamespace:
    """The modules of one package's control plane."""
    mod = lambda name: importlib.import_module(f"{pkg}.{name}")  # noqa: E731
    return SimpleNamespace(
        pkg=pkg,
        api=mod("api.v2beta1"),
        constants=mod("api.v2beta1.constants"),
        topology=mod("api.topology"),
        validation=mod("api.validation"),
        schema=mod("api.schema"),
        builders=mod("controller.builders"),
        status=mod("controller.status"),
        controller=mod("controller.tpu_job_controller"),
        apiserver=mod("runtime.apiserver"),
        scheduler=mod("scheduler"),
        trace=mod("utils.trace"),
    )


def accel_names(accel: str, pkg_side: SimpleNamespace) -> dict:
    """Accelerator type and topology strings of one side -> placeholders."""
    shape = pkg_side.topology.resolve(accel)
    return {accel: "<accel>", shape.topology: "<topology>"}


def normalize(obj, names: dict, uids: dict):
    """``obj`` with the GPU design's keys masked (module docstring)."""
    if isinstance(obj, dict):
        out = {}
        for k, v in obj.items():
            if k in ACCELERATOR_RESOURCES:
                out["<accelerator resource>"] = "<count>"
            elif k == "uid" and isinstance(v, str):
                out[k] = uids.setdefault(v, f"<uid {len(uids)}>")
            elif k == "env" and isinstance(v, list):
                out[k] = [normalize(e, names, uids) for e in _env(v)]
            else:
                out[k] = normalize(v, names, uids)
        return out
    if isinstance(obj, (list, tuple)):
        return [normalize(v, names, uids) for v in obj]
    if isinstance(obj, str):
        if obj in LAUNCHER_MODULES:
            return LAUNCHER_MODULES[obj]
        if obj in names:
            return names[obj]
        for raw, mask in names.items():
            if mask == "<accel>":
                obj = obj.replace(raw, mask)
        return obj
    return obj


def _env(items: list) -> list:
    out = []
    for item in items:
        name = item.get("name")
        if name in GPU_DROPPED_ENV:
            continue
        if name in ACCELERATOR_ENV:
            item = {**item, "value": f"<{name}>"}
        elif name == "TPU_TRACE_CONTEXT":
            item = {**item, "value": "<trace>"}
        out.append(item)
    return out


def new_job(s: SimpleNamespace, accel: str, workers: int, *, launcher=False,
            name="twin", spares=0, **run_policy):
    api = s.api
    job = api.TPUJob()
    job.metadata.name = name
    job.metadata.namespace = "default"
    job.metadata.uid = "uid-of-" + name
    job.spec = api.TPUJobSpec(
        tpu=api.TPUSpec(accelerator_type=accel, hot_spares=spares),
        replica_specs={api.REPLICA_TYPE_WORKER: api.ReplicaSpec(
            replicas=workers, template=dict(TEMPLATE))},
    )
    for k, v in run_policy.items():
        setattr(job.spec.run_policy, k, v)
    if launcher:
        job.spec.replica_specs[api.REPLICA_TYPE_LAUNCHER] = api.ReplicaSpec(
            template={"spec": {"containers": [{"name": "l", "image": "img"}]}})
    api.set_defaults_tpujob(job)
    return job


def render_all(s: SimpleNamespace, job, gang: str = "") -> dict:
    """Every object the builders render for ``job``, as dicts."""
    b = s.builders
    n = b.worker_replicas(job)
    out = {
        "service": b.new_workers_service(job),
        "config": b.new_config_map(job, n),
        "pod_group": b.new_pod_group(job, n + 1),
        "spare_group": b.new_spare_group(job),
        "launcher": b.new_launcher_job(job, gang),
    }
    for i in range(n):
        out[f"worker-{i}"] = b.new_worker(job, i, gang)
    for i in range(2):
        out[f"spare-{i}"] = b.new_spare(job, i, gang)
    cm = out["config"]
    b.update_discover_hosts(cm, job, [
        out["worker-1"].to_dict(), out["worker-0"].to_dict()])
    return {k: v.to_dict() for k, v in out.items()}


def env_of(pod: dict) -> dict:
    return {e["name"]: e["value"] for e in pod["spec"]["containers"][0]["env"]}


TWIN_IDS = [f"{t}~{g}" for t, g, _ in TWINS]


@pytest.mark.parametrize("gang", ["", "tpu-gang-scheduler"])
@pytest.mark.parametrize("tpu,gpu,workers", TWINS, ids=TWIN_IDS)
def test_every_rendered_object_equals_the_jax_packages(tpu, gpu, workers, gang):
    jside, pside = side(JAX), side(PORT)
    jobs = {}
    for s, accel in ((jside, tpu), (pside, gpu)):
        job = new_job(s, accel, workers, launcher=True, spares=2,
                      backoff_limit=3, active_deadline_seconds=60)
        jobs[s.pkg] = normalize(render_all(s, job, gang),
                                accel_names(accel, s), {})
    assert jobs[PORT] == jobs[JAX]


@pytest.mark.parametrize("tpu,gpu,workers", TWINS, ids=TWIN_IDS)
def test_gpu_worker_env_and_resources(tpu, gpu, workers):
    s = side(PORT)
    job = new_job(s, gpu, workers)
    shape = s.topology.resolve(gpu)
    for i in range(workers):
        pod = s.builders.new_worker(job, i).to_dict()
        env = env_of(pod)
        assert set(env) == GPU_ENV_KEYS
        assert env["TPUJOB_PROCESS_ID"] == str(i)
        assert env["TPUJOB_NUM_PROCESSES"] == str(workers)
        assert env["TPUJOB_COORDINATOR_ADDRESS"] == (
            "twin-worker-0.twin-worker.default.svc:8476")
        assert (env["TPUJOB_NAME"], env["TPUJOB_NAMESPACE"]) == (
            "twin", "default")
        assert (env["TPU_ACCELERATOR_TYPE"], env["TPU_TOPOLOGY"]) == (
            gpu, shape.topology)
        res = pod["spec"]["containers"][0]["resources"]
        assert res == {"limits": {"nvidia.com/gpu": 1},
                       "requests": {"nvidia.com/gpu": 1}}
        assert pod["spec"]["containers"][0]["command"] == [
            "python", "-m", "mpi_operator_tpu_torch.launcher.healthcheck"]
    # The JAX twin's resource is its host's chips, where the port's is 1.
    j = side(JAX)
    jpod = j.builders.new_worker(new_job(j, tpu, workers), 0).to_dict()
    chips = j.topology.resolve(tpu).chips_per_host
    assert jpod["spec"]["containers"][0]["resources"]["limits"] == {
        "google.com/tpu": chips}


def test_trace_context_rides_the_gpu_env():
    s = side(PORT)
    job = new_job(s, "h100-2", 2)
    with s.trace.span("reconcile") as sp:
        env = env_of(s.builders.new_worker(job, 1).to_dict())
    ctx = s.trace.TraceContext.parse(env["TPU_TRACE_CONTEXT"])
    assert ctx is not None and ctx.trace_id == sp.trace_id


def test_spare_env_and_command():
    s = side(PORT)
    job = new_job(s, "h100-4", 4, spares=1)
    pod = s.builders.new_spare(job, 0).to_dict()
    c = pod["spec"]["containers"][0]
    assert c["command"] == ["python", "-m", "mpi_operator_tpu_torch.launcher.park"]
    assert set(env_of(pod)) == {"TPU_ACCELERATOR_TYPE", "TPU_TOPOLOGY",
                                "TPUJOB_NAME", "TPUJOB_NAMESPACE"}
    assert env_of(pod)["TPU_ACCELERATOR_TYPE"] == "h100-4"
    assert c["resources"]["limits"] == {"nvidia.com/gpu": 1}


def test_user_command_and_resources_respected():
    s = side(PORT)
    job = new_job(s, "h100-1", 1)
    job.spec.replica_specs["Worker"].template = {"spec": {"containers": [{
        "name": "main", "image": "img", "command": ["python", "train.py"],
        "resources": {"limits": {"nvidia.com/gpu": 1, "cpu": "8"}}}]}}
    c = s.builders.new_worker(job, 0).to_dict()["spec"]["containers"][0]
    assert c["command"] == ["python", "train.py"]
    assert c["resources"]["limits"] == {"nvidia.com/gpu": 1, "cpu": "8"}


@pytest.mark.parametrize("gpu,workers", [("h100-8", 8), ("h100-16", 16)])
def test_multi_node_job_is_one_world_of_one_pod_a_gpu(gpu, workers):
    s = side(PORT)
    job = new_job(s, gpu, None)
    assert s.builders.worker_replicas(job) == workers
    ids = {env_of(s.builders.new_worker(job, i).to_dict())["TPUJOB_PROCESS_ID"]
           for i in range(workers)}
    assert ids == {str(i) for i in range(workers)}
