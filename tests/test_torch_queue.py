"""The port's admission queue against the JAX package's, on twin jobs.

Each scenario of ``tests/test_queue.py`` runs on both packages' control
planes (``InMemoryAPIServer`` + ``TPUJobController`` + ``QueueManager``,
driven synchronously on one fake clock): the JAX package with ``v5e``
jobs and quotas in chips, the port with ``h100`` jobs of the same worker
count and quotas in GPUs. A ``v5e-16`` job is 4 hosts of 4 chips, its
twin ``h100-4`` 4 GPUs, so every quota and count on the port's side is a
quarter of the JAX side's. After :func:`gpu_to_tpu` translates the
port's units back (``N nvidia.com/gpu (h100)`` -> ``4N google.com/tpu
(v5e)``), the admission order, suspend flags, conditions, events, queue
gauges, ClusterQueue status and flight-recorder timeline must be equal.

Also here: fault (c) 6 of the port (a ClusterQueue with ``generation:
h100`` was refused by the schema), the ledger's arithmetic on random
interleavings against the JAX ledger's, the ``--cluster-queue`` parser,
and ``cmd.operator --enable-queue`` as a process.
"""

from __future__ import annotations

import importlib
import random
import re
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest
import yaml

pytestmark = pytest.mark.kernel

JAX, PORT = "mpi_operator_tpu", "mpi_operator_tpu_torch"
REPO_ROOT = Path(__file__).resolve().parent.parent
NOW = 1000.0
# Chips of a v5e host per GPU of its twin (v5e-16: 4 hosts x 4 chips;
# h100-4: 4 GPUs, one worker pod each on both sides).
CHIPS_PER_GPU = 4
GEN = {JAX: "v5e", PORT: "h100"}
TEMPLATE = {"spec": {"containers": [{"name": "main", "image": "img"}]}}
QUEUE_GAUGES = ("tpu_operator_queue_pending_workloads",
                "tpu_operator_queue_admitted_workloads",
                "tpu_operator_queue_evictions_total")


def side(pkg: str) -> SimpleNamespace:
    mod = lambda name: importlib.import_module(f"{pkg}.{name}")  # noqa: E731
    return SimpleNamespace(
        pkg=pkg, api=mod("api.v2beta1"), types=mod("api.v2beta1.types"),
        status=mod("controller.status"),
        controller=mod("controller.tpu_job_controller"),
        apiserver=mod("runtime.apiserver"), queue=mod("queue"),
        quota=mod("queue.quota"), flightrecorder=mod("utils.flightrecorder"),
        metrics=mod("utils.metrics"), builders=mod("controller.builders"))


def accel(pkg: str, gpus: int) -> str:
    """The twin acceleratorType of a ``gpus``-worker job."""
    return f"h100-{gpus}" if pkg == PORT else f"v5e-{gpus * CHIPS_PER_GPU}"


def quota(pkg: str, gpus: int) -> int:
    return gpus if pkg == PORT else gpus * CHIPS_PER_GPU


def gpu_to_tpu(obj):
    """The port's units in the JAX package's: GPU counts x4 with their
    resource and generation names, ``h100`` usage keys as ``v5e``."""
    if isinstance(obj, dict):
        return {("v5e" if k == "h100" else k):
                (v * CHIPS_PER_GPU if k == "h100" else gpu_to_tpu(v))
                for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(gpu_to_tpu(v) for v in obj)
    if isinstance(obj, str):
        obj = re.sub(r"(\d+) (borrowed )?nvidia\.com/gpu \(h100\)",
                     lambda m: f"{int(m[1]) * CHIPS_PER_GPU} {m[2] or ''}"
                               "google.com/tpu (v5e)", obj)
        obj = re.sub(r"(google\.com/tpu \(v5e\)), (\d+) free",
                     lambda m: f"{m[1]}, {int(m[2]) * CHIPS_PER_GPU} free",
                     obj)
        return obj.replace("h100-", "v5e-")
    return obj


class Fixture:
    """``tests/test_queue.py``'s fixture, for either package."""

    def __init__(self, pkg: str):
        self.s = s = side(pkg)
        self.pkg = pkg
        self.time = [NOW]
        clock = lambda: self.time[0]  # noqa: E731
        self.api = s.apiserver.InMemoryAPIServer(clock=clock)
        self.registry = s.metrics.Registry()
        self.flight = s.flightrecorder.FlightRecorder(clock=clock)
        self.controller = s.controller.TPUJobController(
            self.api, registry=self.registry, flight_recorder=self.flight,
            clock=clock)
        self.manager = s.queue.QueueManager(
            self.api, registry=self.registry, flight_recorder=self.flight,
            clock=clock)
        self.controller.start()
        self.manager.start()
        self.jobs: list[str] = []

    def settle(self, rounds: int = 4):
        for _ in range(rounds):
            self.manager.sync_pending()
            self.controller.sync_pending()

    def cluster_queue(self, name, gpus, cohort="", reclaim="Never",
                      borrowing_gpus=None):
        entry = {"generation": GEN[self.pkg],
                 "nominalQuota": quota(self.pkg, gpus)}
        if borrowing_gpus is not None:
            entry["borrowingLimit"] = quota(self.pkg, borrowing_gpus)
        spec = {"quotas": [entry],
                "preemption": {"reclaimWithinCohort": reclaim}}
        if cohort:
            spec["cohort"] = cohort
        self.api.create("clusterqueues",
                        {"metadata": {"name": name}, "spec": spec})

    def local_queue(self, name, cluster_queue):
        self.api.create("localqueues", {
            "metadata": {"name": name, "namespace": "default"},
            "spec": {"clusterQueue": cluster_queue}})

    def job(self, name, queue, gpus=4, priority_class=""):
        a, t = self.s.api, self.s.types
        job = a.TPUJob()
        job.metadata.name = name
        job.metadata.namespace = "default"
        job.spec = a.TPUJobSpec(
            tpu=a.TPUSpec(accelerator_type=accel(self.pkg, gpus)),
            replica_specs={a.REPLICA_TYPE_WORKER: a.ReplicaSpec(
                replicas=gpus, template=dict(TEMPLATE))})
        job.spec.run_policy.clean_pod_policy = "None"
        job.spec.run_policy.scheduling_policy = t.SchedulingPolicy(
            queue=queue, priority_class=priority_class)
        self.controller.tpujobs.tpujobs("default").create(job)
        self.jobs.append(name)

    def get(self, name):
        return self.controller.tpujobs.tpujobs("default").get(name)

    def finish(self, name):
        job = self.get(name)
        for i in range(self.s.builders.worker_replicas(job)):
            pod = self.api.get("pods", "default",
                               self.s.builders.worker_name(job, i))
            pod["status"] = {"phase": "Succeeded"}
            self.api.update_status("pods", pod)

    def gauges(self) -> dict:
        out = {}
        for line in self.registry.expose().splitlines():
            if line.startswith(QUEUE_GAUGES):
                key, value = line.rsplit(" ", 1)
                out[key] = float(value)
        return out

    def snapshot(self) -> dict:
        """What the comparison holds, in the JAX package's units."""
        jobs = {}
        for name in self.jobs:
            job = self.get(name)
            pods = [p["metadata"]["name"] for p in self.api.list("pods")
                    if p["metadata"]["name"].startswith(f"{name}-worker-")]
            jobs[name] = {
                "suspend": job.spec.run_policy.suspend,
                "conditions": [
                    (c.type, c.status, c.reason, c.message,
                     c.last_transition_time)
                    for c in job.status.conditions],
                "pods": sorted(pods),
                "timeline": [
                    (e["kind"], e.get("reason"), e.get("message"))
                    for e in self.flight.timeline("default", name)],
            }
        snap = {
            "jobs": jobs,
            "manager_events": [(e.type, e.reason, e.involved_name, e.message)
                               for e in self.manager.recorder.events],
            "controller_events": [
                (e.type, e.reason, e.involved_name, e.message)
                for e in self.controller.recorder.events],
            "gauges": self.gauges(),
            "queues": {cq["metadata"]["name"]: cq.get("status") or {}
                       for cq in self.api.list("clusterqueues")},
        }
        return gpu_to_tpu(snap) if self.pkg == PORT else snap


# -- scenarios (tests/test_queue.py) ---------------------------------------

def two_jobs_one_slot(f):
    f.cluster_queue("team-a", 4)
    f.local_queue("team-a", "team-a")
    f.job("job-1", "team-a")
    f.time[0] += 1
    f.job("job-2", "team-a")
    f.settle()
    yield
    f.time[0] += 10
    f.finish("job-1")
    f.settle()


def status_mirror(f):
    f.cluster_queue("team-a", 8)
    f.local_queue("team-a", "team-a")
    f.job("job-1", "team-a")
    f.settle()
    yield


def priority_beats_fifo(f):
    f.cluster_queue("team-a", 4)
    f.local_queue("team-a", "team-a")
    f.job("first-low", "team-a", priority_class="low-priority")
    f.time[0] += 1
    f.job("later-high", "team-a", priority_class="high-priority")
    f.settle()
    yield


def strict_fifo(f):
    f.cluster_queue("team-a", 4)
    f.local_queue("team-a", "team-a")
    f.job("big", "team-a", gpus=8)
    f.time[0] += 1
    f.job("small", "team-a")
    f.settle()
    yield


def queue_not_found(f):
    f.job("orphan", "no-such-queue")
    f.settle()
    yield
    f.local_queue("no-such-queue", "ghost-cq")
    f.settle()
    yield
    f.cluster_queue("ghost-cq", 4)
    f.settle()


def borrow_then_reclaim(f):
    f.cluster_queue("team-a", 4, cohort="research", reclaim="Any")
    f.cluster_queue("team-b", 4, cohort="research", reclaim="Any")
    f.local_queue("team-a", "team-a")
    f.local_queue("team-b", "team-b")
    f.job("b-nominal", "team-b")
    f.settle()
    f.time[0] += 1
    f.job("b-borrow", "team-b")
    f.settle()
    yield
    f.time[0] += 1
    f.job("a-owner", "team-a")
    f.settle()
    yield
    f.time[0] += 10
    f.finish("b-nominal")
    f.settle()


def reclaim_never(f):
    f.cluster_queue("team-a", 4, cohort="research", reclaim="Never")
    f.cluster_queue("team-b", 4, cohort="research", reclaim="Any")
    f.local_queue("team-a", "team-a")
    f.local_queue("team-b", "team-b")
    f.job("b-borrow", "team-b")
    f.settle()
    f.time[0] += 1
    f.job("b-borrow-2", "team-b")
    f.settle()
    f.time[0] += 1
    f.job("a-owner", "team-a")
    f.settle()
    yield


def borrowing_limit(f):
    f.cluster_queue("team-a", 4, cohort="research")
    f.cluster_queue("team-b", 0, cohort="research", borrowing_gpus=2)
    f.local_queue("team-b", "team-b")
    f.job("b-wants-4", "team-b")
    f.settle()
    yield


SCENARIOS = {fn.__name__: fn for fn in (
    two_jobs_one_slot, status_mirror, priority_beats_fifo, strict_fifo,
    queue_not_found, borrow_then_reclaim, reclaim_never, borrowing_limit)}


def _run(pkg: str, scenario) -> list:
    f = Fixture(pkg)
    snaps = [f.snapshot() for _ in scenario(f)]
    return snaps + [f.snapshot()]


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_port_queue_admits_as_the_jax_packages(name):
    port = _run(PORT, SCENARIOS[name])
    jax = _run(JAX, SCENARIOS[name])
    assert port == jax
    # Something was decided: a condition on a job, in every scenario.
    assert any(j["conditions"] for j in port[-1]["jobs"].values())


def test_two_jobs_one_slot_reads_in_gpus():
    """The acceptance scenario in the port's own units: the second job
    waits with a message naming nvidia.com/gpu, and is admitted when the
    first finishes."""
    f = Fixture(PORT)
    scenario = two_jobs_one_slot(f)
    next(scenario)
    st, types = f.s.status, f.s.types
    second = f.get("job-2")
    assert second.spec.run_policy.suspend is True
    cond = st.get_condition(second.status, types.JOB_QUOTA_RESERVED)
    assert cond.message == (
        "insufficient quota in ClusterQueue team-a: needs 4 nvidia.com/gpu "
        "(h100), 0 free")
    assert len([p for p in f.api.list("pods")
                if p["metadata"]["name"].startswith("job-1-")]) == 4
    next(scenario, None)
    second = f.get("job-2")
    assert second.spec.run_policy.suspend is False
    cond = st.get_condition(second.status, types.JOB_QUOTA_RESERVED)
    assert cond.message == (
        "Admitted by ClusterQueue team-a: reserved 4 nvidia.com/gpu (h100)")
    assert f.api.get("clusterqueues", "", "team-a")["status"]["usage"] == {
        "h100": 4}


# -- fault (c) 6: the GPU ClusterQueue ---------------------------------------

def test_gpu_cluster_queue_is_created_and_admits():
    """The port's schema held a quota's generation to the JAX package's
    ^v[0-9]+[a-z]*$, so ``generation: h100`` raised InvalidError at
    create. Now it is created and a job is admitted against it."""
    f = Fixture(PORT)
    f.api.create("clusterqueues", {"metadata": {"name": "gpus"}, "spec": {
        "quotas": [{"generation": "h100", "nominalQuota": 8}]}})
    f.local_queue("gpus", "gpus")
    f.job("train", "gpus", gpus=8)
    f.settle()
    job = f.get("train")
    assert job.spec.run_policy.suspend is False
    cond = f.s.status.get_condition(job.status, f.s.types.JOB_QUOTA_RESERVED)
    assert cond.status == "True"
    assert "reserved 8 nvidia.com/gpu (h100)" in cond.message


@pytest.mark.parametrize("generation", ["v5e", "v4", "a100", "H100", ""])
def test_gpu_cluster_queue_refuses_other_generations(generation):
    s = side(PORT)
    with pytest.raises(s.apiserver.InvalidError, match="generation"):
        s.apiserver.InMemoryAPIServer().create("clusterqueues", {
            "metadata": {"name": "q"},
            "spec": {"quotas": [{"generation": generation,
                                 "nominalQuota": 8}]}})


def test_quota_schema_names_gpus():
    from mpi_operator_tpu_torch.api.v2beta1 import openapi

    entry = openapi.clusterqueue_schema()["properties"]["spec"][
        "properties"]["quotas"]["items"]["properties"]
    assert entry["generation"]["pattern"] == "^(h100)$"
    assert "h100" in entry["generation"]["description"]
    assert "GPU" in entry["nominalQuota"]["description"]
    assert "TPU" not in str(entry) and "chip" not in str(entry).lower()


# -- the ledger's arithmetic against the JAX ledger's -------------------------

@pytest.mark.parametrize("seed", range(8))
def test_ledger_arithmetic_equals_the_jax_ledgers(seed):
    """Random reserve/release/reclaim interleavings over a cohort of three
    queues give both ledgers the same answers at every step (the port's
    in GPUs, the JAX one's in chips: x4)."""
    ledgers = {}
    for pkg in (JAX, PORT):
        q = side(pkg).quota
        ledger = q.QuotaLedger()
        for name, nominal, limit in (("a", 4, None), ("b", 2, 1),
                                     ("c", 0, None)):
            ledger.set_queue(name, cohort="co", quotas={GEN[pkg]: q.QueueQuota(
                quota(pkg, nominal),
                None if limit is None else quota(pkg, limit))})
        ledgers[pkg] = (q, ledger)
    rng = random.Random(seed)
    for i in range(120):
        op = rng.choice(["reserve", "reserve", "release", "reclaim", "free"])
        queue = rng.choice("abc")
        gpus = rng.randint(1, 4)
        key = ("default", f"j{rng.randint(0, 9)}")
        out = {}
        for pkg, (q, ledger) in ledgers.items():
            gen, n = GEN[pkg], quota(pkg, gpus)
            try:
                if op == "reserve":
                    ledger.reserve(key, queue, gen, n, admitted_at=float(i))
                    res = "ok"
                elif op == "release":
                    ledger.release(key)
                    res = "ok"
                elif op == "reclaim":
                    res = ledger.reclaim_candidates(queue, gen, n)
                else:
                    res = ledger.fits(queue, gen, n)
                    res = (res[0], res[1] // quota(pkg, 1))
            except RuntimeError as e:
                res = str(e)
            usage = {name: ledger.usage(name, gen) // quota(pkg, 1)
                     for name in "abc"}
            out[pkg] = (res if pkg == JAX else gpu_to_tpu(res), usage)
        assert out[PORT] == out[JAX], (i, op, queue, gpus, key)


# -- bootstrap ---------------------------------------------------------------

def test_parse_cluster_queue_in_gpus():
    from mpi_operator_tpu_torch.queue import parse_cluster_queue_spec

    cq = parse_cluster_queue_spec("team-a@research:h100=16")
    assert (cq.name, cq.spec.cohort) == ("team-a", "research")
    assert [(q.generation, q.nominal_quota) for q in cq.spec.quotas] == [
        ("h100", 16)]
    assert cq.spec.preemption.reclaim_within_cohort == "Any"


@pytest.mark.parametrize("bad,match", [
    ("noquota", "expected name"), ("name:", "expected name"),
    (":h100=8", "queue name is empty"), ("q:h100", "bad quota entry"),
    ("q:h100=lots", "GPU count 'lots' is not an integer"),
    ("q:v5e=16", "'v5e' is not a GPU generation"),
])
def test_parse_cluster_queue_refuses(bad, match):
    from mpi_operator_tpu_torch.queue import parse_cluster_queue_spec

    with pytest.raises(ValueError, match=match):
        parse_cluster_queue_spec(bad)


def test_bootstrap_creates_the_queue_pair_once():
    from mpi_operator_tpu_torch.queue import bootstrap_queues
    from mpi_operator_tpu_torch.runtime.apiserver import InMemoryAPIServer

    api = InMemoryAPIServer()
    bootstrap_queues(api, ["gpus:h100=2"], namespace="training")
    bootstrap_queues(api, ["gpus:h100=2"])
    assert [cq["spec"]["quotas"] for cq in api.list("clusterqueues")] == [
        [{"generation": "h100", "nominalQuota": 2}]]
    assert api.get("localqueues", "training", "gpus")["spec"] == {
        "clusterQueue": "gpus"}


# -- cmd.operator --enable-queue as a process ---------------------------------

def _queued_pi(name: str, queue: str) -> dict:
    from mpi_operator_tpu_torch.utils.net import free_port_pair

    doc = yaml.safe_load(
        (REPO_ROOT / "mpi_operator_tpu_torch/examples/pi.yaml").read_text())
    doc["metadata"].update(name=name, namespace="default")
    doc["spec"]["jaxDistribution"] = {"coordinatorPort": free_port_pair()}
    doc["spec"]["runPolicy"]["schedulingPolicy"] = {"queue": queue}
    container = doc["spec"]["tpuReplicaSpecs"]["Worker"]["template"]["spec"][
        "containers"][0]
    container["command"] = container["command"] + ["--device", "cpu"]
    return doc


@pytest.mark.e2e
def test_cmd_operator_queues_the_second_gpu_job(tmp_path):
    """``--enable-queue --cluster-queue gpus:h100=2 --enable-scheduler``:
    two h100-2 jobs, quota for one; the second is admitted after the
    first finishes, and both succeed."""
    paths = []
    for name in ("first", "second"):
        path = tmp_path / f"{name}.yaml"
        path.write_text(yaml.safe_dump(_queued_pi(name, "gpus")))
        paths += ["--apply", str(path)]
    out = subprocess.run(
        [sys.executable, "-m", "mpi_operator_tpu_torch.cmd.operator",
         "--backend", "memory", "--enable-queue", "--cluster-queue",
         "gpus:h100=2", "--enable-scheduler", *paths,
         "--exit-on-completion"],
        cwd=REPO_ROOT, capture_output=True, text=True, timeout=150,
        env={**__import__("os").environ, "OMP_NUM_THREADS": "1"})
    assert out.returncode == 0, out.stderr[-3000:]
    assert "queue: bootstrapped ClusterQueue 'gpus'" in out.stdout
    assert "TPUJob default/first: Succeeded" in out.stdout
    assert "TPUJob default/second: Succeeded" in out.stdout
    log = out.stderr
    assert "admitted default/first: 2 GPUs (h100) in ClusterQueue gpus" in log
    assert "admitted default/second: 2 GPUs (h100)" in log
    # The second job was admitted only after the first's pods were bound
    # and ran: its admission comes after the first job's gang bind.
    assert log.index("admitted default/second") > log.index(
        "bound gang default/first")


@pytest.mark.parametrize("flags,message", [
    (["--cluster-queue", "q:h100=8"], "--cluster-queue requires --enable-queue"),
    (["--enable-queue", "--cluster-queue", "q:v5e=16"],
     "'v5e' is not a GPU generation"),
])
def test_cmd_operator_queue_flag_errors(flags, message):
    out = subprocess.run(
        [sys.executable, "-m", "mpi_operator_tpu_torch.cmd.operator",
         "--backend", "memory", *flags, "--exit-on-completion"],
        cwd=REPO_ROOT, capture_output=True, text=True, timeout=60)
    assert out.returncode == 1
    assert message in out.stderr
