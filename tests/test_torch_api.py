"""The port's API layer: the ``h100`` topology table, and admission
(defaults + validation + schema) against the JAX package's on twin jobs.

Shared rules (names, replica specs, restart policy, runPolicy, launcher)
must give the same ``FieldError`` list on both sides, path, value and
message. Two messages differ by design and are masked by name:

- ``WORKER_COUNT``: the replica-count rule counts GPUs ("one per GPU")
  where the JAX package counts TPU hosts x slices ("one per TPU host");
- ``RENDEZVOUS``: the coordinator port is for ``torch.distributed``, not
  ``jax.distributed``.

The flipped rules are held on their own: ``nvidia.com/gpu`` accepted and
``google.com/tpu`` refused, TPU generations refused, ``numSlices > 1``
refused.
"""

from __future__ import annotations

import re

import pytest

from tests.test_torch_builders import JAX, PORT, TWINS, TWIN_IDS, new_job, normalize, side

pytestmark = pytest.mark.kernel

WORKER_COUNT = re.compile(
    r"^(slice )?<accel> \(topology [0-9x]+\)( x \d+ slice\(s\))? "
    r"needs exactly (\d+) worker\(s\), one per (TPU host|GPU)$")
RENDEZVOUS = re.compile(r"(jax|torch)\.distributed")


def _masked(err, names) -> tuple:
    detail = normalize(err.detail, names, {})
    detail = WORKER_COUNT.sub(r"<one worker each: \3>", detail)
    detail = RENDEZVOUS.sub("<rendezvous>", detail)
    return (err.type, err.field, normalize(err.value, names, {}), detail)


def _errors(s, accel, workers, mutate):
    job = new_job(s, accel, workers, name="test")
    mutate(job, s.api)
    names = {accel: "<accel>", s.topology.resolve(accel).topology: "<topology>"}
    return [_masked(e, names) for e in s.validation.validate_tpujob(job)]


def _launcher(api, replicas=1):
    return api.ReplicaSpec(replicas=replicas, restart_policy="OnFailure",
                           template={"spec": {"containers": [
                               {"name": "l", "image": "img"}]}})


def _set(path, value):
    def mutate(job, api):
        obj = job
        *head, last = path.split(".")
        for part in head:
            obj = getattr(obj, part)
        setattr(obj, last, value)
    return mutate


def _no_worker(job, api):
    job.spec.replica_specs[api.REPLICA_TYPE_LAUNCHER] = _launcher(api)
    del job.spec.replica_specs[api.REPLICA_TYPE_WORKER]


def _worker(attr, value):
    def mutate(job, api):
        setattr(job.spec.replica_specs[api.REPLICA_TYPE_WORKER], attr, value)
    return mutate


def _pod_failure_policy(job, api):
    from_dict = type(job.spec.run_policy).from_dict
    job.spec.run_policy = from_dict({
        "cleanPodPolicy": "None",
        "podFailurePolicy": {"rules": [
            {"action": "Explode"},
            {"action": "FailJob", "onExitCodes": {"operator": "In",
                                                  "values": [0]}},
            {"action": "Ignore", "onPodConditions": [{"status": "Maybe",
                                                      "type": "X"}]},
        ]},
    })


def _queue(job, api):
    job.spec.run_policy.scheduling_policy = type(
        job.spec.run_policy).from_dict(
            {"schedulingPolicy": {"queue": "Not_A_Label"}}).scheduling_policy


SHARED_RULES = {
    "valid": lambda job, api: None,
    "with_launcher": lambda job, api: job.spec.replica_specs.__setitem__(
        api.REPLICA_TYPE_LAUNCHER, _launcher(api)),
    "missing_replica_specs": _set("spec.replica_specs", {}),
    "missing_worker": _no_worker,
    "unknown_replica_type": lambda job, api: job.spec.replica_specs.__setitem__(
        "Chief", api.ReplicaSpec(replicas=1, template={"spec": {
            "containers": [{"name": "c", "image": "img"}]}})),
    "worker_replicas_zero": _worker("replicas", 0),
    "worker_replicas_mismatch": _worker("replicas", 3),
    "launcher_replicas_two": lambda job, api: job.spec.replica_specs.__setitem__(
        api.REPLICA_TYPE_LAUNCHER, _launcher(api, 2)),
    "bad_restart_policy": _worker("restart_policy", "Always"),
    "no_containers": _worker("template", {"spec": {"containers": []}}),
    "bad_clean_pod_policy": _set("spec.run_policy.clean_pod_policy", "Sometimes"),
    "missing_clean_pod_policy": _set("spec.run_policy.clean_pod_policy", None),
    "negative_ttl": _set("spec.run_policy.ttl_seconds_after_finished", -1),
    "negative_deadline": _set("spec.run_policy.active_deadline_seconds", -1),
    "negative_backoff": _set("spec.run_policy.backoff_limit", -1),
    "pod_failure_policy": _pod_failure_policy,
    "bad_queue_name": _queue,
    "bad_coordinator_port": _set(
        "spec.jax_distribution.coordinator_port", 99999),
    "missing_coordinator_port": _set("spec.jax_distribution.coordinator_port", 0),
    "missing_accelerator_type": _set("spec.tpu.accelerator_type", ""),
    "name_too_long": _set("metadata.name", "a" * 60),
    "name_invalid_characters": _set("metadata.name", "Not_A_Label"),
    "hot_spares": _set("spec.tpu.hot_spares", 2),
    "negative_hot_spares": _set("spec.tpu.hot_spares", -1),
}


@pytest.mark.parametrize("rule", sorted(SHARED_RULES))
@pytest.mark.parametrize("tpu,gpu,workers", TWINS, ids=TWIN_IDS)
def test_shared_rules_match_the_jax_packages(tpu, gpu, workers, rule):
    mutate = SHARED_RULES[rule]
    want = _errors(side(JAX), tpu, workers, mutate)
    got = _errors(side(PORT), gpu, workers, mutate)
    if rule == "missing_accelerator_type":
        # The one message that names the accelerator kind.
        assert [e[:3] for e in got] == [e[:3] for e in want]
        assert "h100-<gpus>" in got[0][3]
        return
    assert got == want
    assert bool(got) == (rule not in ("valid", "with_launcher", "hot_spares"))


@pytest.mark.parametrize("tpu,gpu,workers", TWINS, ids=TWIN_IDS)
def test_defaults_match_the_jax_packages(tpu, gpu, workers):
    got = {}
    for s, accel in ((side(JAX), tpu), (side(PORT), gpu)):
        job = new_job(s, accel, None, launcher=True, name="test")
        names = {accel: "<accel>",
                 s.topology.resolve(accel).topology: "<topology>"}
        got[s.pkg] = normalize(job.to_dict(), names, {})
    assert got[PORT] == got[JAX]
    assert got[PORT]["spec"]["tpuReplicaSpecs"]["Worker"]["replicas"] == workers


# -- the h100 topology table ---------------------------------------------

H100_TABLE = [(n, f"1x{n}", 1, n) for n in range(1, 9)] + [
    (16, "2x8", 2, 8), (24, "3x8", 3, 8), (32, "4x8", 4, 8),
    (48, "6x8", 6, 8), (64, "8x8", 8, 8)]


@pytest.mark.parametrize("gpus,topo,nodes,per_node", H100_TABLE)
def test_h100_topology_table(gpus, topo, nodes, per_node):
    t = side(PORT).topology
    shape = t.resolve(f"h100-{gpus}")
    assert (shape.topology, shape.num_hosts, shape.chips_per_host) == (
        topo, nodes, per_node)
    assert shape.accelerator_type == f"h100-{gpus}"
    assert t.resolve(f"h100-{gpus}", topo) == shape
    assert t.host_grid(shape) == [(i, 0) for i in range(nodes)]


@pytest.mark.parametrize("accel,topo,match", [
    ("h100-12", "", "multiple of 8"),
    ("h100-20", "", "multiple of 8"),
    ("h100-0", "", "positive"),
    ("h100-x", "", "not an integer"),
    ("a100-8", "", "generation"),
    ("h100", "", "generation"),
    ("h100-16", "1x16", "does not match"),
    ("h100-16", "4x4", "does not match"),
    ("h100-2", "2x1", "does not match"),
    ("h100-8", "2x2", "has 4 GPUs"),
    ("h100-16", "2x8x1", "nodes"),
    ("h100-8", "8", "nodes"),
])
def test_h100_bad_counts_and_topologies_refused(accel, topo, match):
    t = side(PORT).topology
    with pytest.raises(t.TopologyError, match=match):
        t.resolve(accel, topo)


# -- the flipped rules ---------------------------------------------------

def _port_errors(mutate, accel="h100-4", workers=4):
    s = side(PORT)
    job = new_job(s, accel, workers, name="test")
    mutate(job, s.api)
    return s.validation.validate_tpujob(job)


@pytest.mark.parametrize("kind", ["containers", "initContainers"])
@pytest.mark.parametrize("bound", ["limits", "requests"])
def test_gpu_resource_accepted_tpu_resource_refused(kind, bound):
    def template(resource):
        spec = {"containers": [{"name": "main", "image": "img"}]}
        spec.setdefault(kind, [{"name": "x", "image": "img"}])
        spec[kind][0]["resources"] = {bound: {resource: 1}}
        return {"spec": spec}

    assert _port_errors(_worker("template", template("nvidia.com/gpu"))) == []
    errs = _port_errors(_worker("template", template("google.com/tpu")))
    assert [(e.field, e.value) for e in errs] == [(
        f"spec.tpuReplicaSpecs[Worker].template.spec.{kind}[0].resources.{bound}",
        "google.com/tpu")]


@pytest.mark.parametrize("accel", ["v4-8", "v5e-16", "v5p-8", "v6e-8"])
def test_tpu_generations_refused_naming_the_gpu_form(accel):
    errs = _port_errors(_set("spec.tpu.accelerator_type", accel))
    assert [e.field for e in errs] == ["spec.tpu.acceleratorType"]
    assert "h100-<gpus>" in errs[0].detail and accel in errs[0].detail


def test_num_slices_above_one_refused():
    errs = _port_errors(_set("spec.tpu.num_slices", 2))
    assert [e.field for e in errs] == ["spec.tpu.numSlices"]
    assert "must be 1" in errs[0].detail


def test_worker_count_is_the_gpu_count():
    errs = _port_errors(_worker("replicas", 2), accel="h100-16", workers=16)
    assert [e.field for e in errs] == ["spec.tpuReplicaSpecs[Worker].replicas"]
    assert errs[0].detail == (
        "h100-16 (topology 2x8) needs exactly 16 worker(s), one per GPU")


@pytest.mark.parametrize("gpus", [1, 8, 16, 32])
def test_worker_replicas_default_to_the_gpu_count(gpus):
    s = side(PORT)
    job = new_job(s, f"h100-{gpus}", None, name="test")
    assert job.spec.replica_specs["Worker"].replicas == gpus
    assert job.spec.tpu.topology == s.topology.resolve(f"h100-{gpus}").topology
    assert s.validation.validate_tpujob(job) == []


def _manifest(accel: str) -> dict:
    return {
        "apiVersion": "kubeflow.org/v2beta1", "kind": "TPUJob",
        "metadata": {"name": "j", "namespace": "default"},
        "spec": {"tpu": {"acceleratorType": accel}, "tpuReplicaSpecs": {
            "Worker": {"template": {"spec": {"containers": [{
                "name": "main", "image": "img",
                "resources": {"limits": {"nvidia.com/gpu": 1}}}]}}}}},
    }


def test_schema_admits_h100_8():
    s = side(PORT)
    assert s.schema.validate_tpujob_object(_manifest("h100-8")) == []
    api = s.apiserver.InMemoryAPIServer()
    created = api.create("tpujobs", _manifest("h100-8"))
    assert created["spec"]["tpu"]["acceleratorType"] == "h100-8"


@pytest.mark.parametrize("pkg,accel", [(PORT, "v5e-16"), (JAX, "h100-8")])
def test_schema_refuses_the_other_packages_accelerator(pkg, accel):
    s = side(pkg)
    errs = s.schema.validate_tpujob_object(_manifest(accel))
    assert any("acceleratorType" in str(e) for e in errs)
    with pytest.raises(s.apiserver.InvalidError):
        s.apiserver.InMemoryAPIServer().create("tpujobs", _manifest(accel))
