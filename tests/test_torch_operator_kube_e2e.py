"""The port's operator against an apiserver over REST, end to end.

``python -m mpi_operator_tpu_torch.cmd.operator --backend kube
--kubeconfig <file>`` runs as a process against ``APIServerFrontend``
(the envtest analog) over a fresh ``InMemoryAPIServer``, with a bearer
token. A real cluster's kubelet runs the pods; here a ``LocalPodRunner``
over its own ``KubeAPIServer`` client plays the node, so every status
write of the pods crosses HTTP too, and every pod command says
``--device cpu``.

The pi job on ``h100-2`` is held through the faults a real apiserver
shows: a compacted watch history (the runner's pod watch resumes from a
compacted resourceVersion, gets 410 and relists) and a 429 burst (the
operator retries and ``/metrics`` counts it). Then two operator replicas
with ``--leader-elect`` share one Lease: when the leader dies, the other
takes the Lease and finishes a job.
"""

from __future__ import annotations

import json
import os
import pathlib
import secrets
import signal
import socket
import subprocess
import sys
import time
import urllib.request

import pytest
import yaml

from mpi_operator_tpu_torch.runtime.apiserver import InMemoryAPIServer
from mpi_operator_tpu_torch.runtime.httpserver import APIServerFrontend
from mpi_operator_tpu_torch.runtime.kube import KubeAPIServer, RestConfig
from mpi_operator_tpu_torch.runtime.podrunner import LocalPodRunner
from mpi_operator_tpu_torch.utils.net import free_port_pair
from tests.test_torch_kube_backend import hold_stream

pytestmark = pytest.mark.kernel

REPO_ROOT = pathlib.Path(__file__).resolve().parent.parent
PI_YAML = "mpi_operator_tpu_torch/examples/pi.yaml"
JOB_TIMEOUT = 60


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def pi_doc(name="pi") -> dict:
    doc = yaml.safe_load((REPO_ROOT / PI_YAML).read_text())
    doc["metadata"].update(name=name, namespace="default")
    doc["spec"]["jaxDistribution"] = {"coordinatorPort": free_port_pair()}
    container = doc["spec"]["tpuReplicaSpecs"]["Worker"]["template"]["spec"][
        "containers"][0]
    container["command"] = container["command"] + ["--device", "cpu"]
    return doc


class RestCluster:
    """The frontend, a kubeconfig naming it, the node's runner over REST
    and a client for the test; operators are started as processes."""

    def __init__(self, tmp_path: pathlib.Path):
        self.tmp_path = tmp_path
        self.token = secrets.token_hex(16)
        self.frontend = APIServerFrontend(InMemoryAPIServer(),
                                          token=self.token).start()
        self.kubeconfig = tmp_path / "kubeconfig"
        self.kubeconfig.write_text(json.dumps({
            "apiVersion": "v1", "kind": "Config", "current-context": "envtest",
            "clusters": [{"name": "envtest",
                          "cluster": {"server": self.frontend.url}}],
            "contexts": [{"name": "envtest", "context": {
                "cluster": "envtest", "user": "operator"}}],
            "users": [{"name": "operator", "user": {"token": self.token}}],
        }))
        self.client = KubeAPIServer(RestConfig(host=self.frontend.url,
                                               token=self.token))
        self.runner_client = KubeAPIServer(RestConfig(
            host=self.frontend.url, token=self.token))
        self.runner = LocalPodRunner(
            self.runner_client, workdir=str(REPO_ROOT),
            base_env={"OMP_NUM_THREADS": "1"}, cuda_devices=0)
        self.runner.start()
        self.operators: list[subprocess.Popen] = []

    def start_operator(self, *flags: str) -> tuple[subprocess.Popen, int]:
        port = free_port()
        # A file, not a pipe nobody reads: a full pipe would stall it.
        log = self.tmp_path / f"operator-{len(self.operators)}.log"
        with open(log, "w") as out:
            proc = subprocess.Popen(
                [sys.executable, "-m", "mpi_operator_tpu_torch.cmd.operator",
                 "--backend", "kube", "--kubeconfig", str(self.kubeconfig),
                 "--monitoring-port", str(port), *flags],
                cwd=REPO_ROOT, stdout=out, stderr=subprocess.STDOUT,
                env={**os.environ, "OMP_NUM_THREADS": "1"})
        self.operators.append(proc)
        wait_until(lambda: metric(port, "tpu_operator_is_leader") is not None,
                   "operator /metrics up")
        return proc, port

    def stop(self) -> None:
        for proc in self.operators:
            if proc.poll() is None:
                proc.send_signal(signal.SIGINT)
        for proc in self.operators:
            try:
                proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
        self.runner.stop()
        self.runner_client.close()
        self.client.close()
        self.frontend.stop()

    def condition(self, name: str):
        job = self.client.get("tpujobs", "default", name)
        for c in (job.get("status") or {}).get("conditions") or []:
            if c["status"] == "True" and c["type"] in ("Succeeded", "Failed"):
                return c
        return None


def wait_until(predicate, what: str, timeout: float = JOB_TIMEOUT):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        got = predicate()
        if got:
            return got
        time.sleep(0.1)
    raise AssertionError(f"timed out waiting for {what}")


def metric(port: int, name: str):
    """One sample of the operator's /metrics, or None if unreachable."""
    try:
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/metrics", timeout=5) as resp:
            text = resp.read().decode()
    except OSError:
        return None
    for line in text.splitlines():
        if line.startswith(name + " "):
            return float(line.split()[1])
    return None


@pytest.fixture
def rest(tmp_path):
    cluster = RestCluster(tmp_path)
    yield cluster
    cluster.stop()


@pytest.mark.e2e
def test_pi_over_rest_survives_compaction_and_429s(rest):
    proc, port = rest.start_operator()
    api, fe = rest.frontend.api, rest.frontend
    # The node's pod watch goes down: the job's pods are created while it
    # is blind, so nothing runs until it resumes.
    pod_watch = rest.runner._pod_watch
    gate = hold_stream(pod_watch)
    rest.client.create("tpujobs", pi_doc())
    wait_until(lambda: len(api.list("pods", "default")) == 2, "2 worker pods")
    # A 429 burst the operator must absorb: with the runner blind and this
    # client idle, the operator's own calls meet it — here its re-create
    # of the job's headless Service, deleted behind its back.
    fe.throttle_429 = 3
    api.delete("services", "default", "pi-worker")
    wait_until(lambda: fe.throttle_429 == 0
               and api.list("services", "default"), "Service re-created")
    # Compact while the node is blind: its resume rv is gone, so it must
    # relist and learn of the pods from the diff.
    wait_until(lambda: any(e.object["metadata"]["name"] == "pi-worker-1"
                           for _, e in fe._history["pods"]), "pods recorded")
    fe.compact()
    gate.set()
    final = wait_until(lambda: rest.condition("pi"), "pi to finish")
    assert final["type"] == "Succeeded", final
    assert pod_watch.relist_count >= 1
    assert fe.throttle_hits == 3
    assert metric(port, "tpu_operator_rest_client_retries_total") >= 1
    assert "pi is approximately" in rest.runner.pod_log("default",
                                                        "pi-worker-0")
    for pod in api.list("pods", "default"):
        assert pod["status"]["phase"] == "Succeeded"
    assert proc.poll() is None  # the operator keeps serving


@pytest.mark.e2e
def test_leader_elect_replica_takes_over_and_finishes_a_job(rest):
    ops = [rest.start_operator("--leader-elect", "--lock-namespace",
                               "default") for _ in range(2)]
    leaders = wait_until(
        lambda: [i for i, (_, port) in enumerate(ops)
                 if metric(port, "tpu_operator_is_leader") == 1] or None,
        "a leader")
    assert len(leaders) == 1
    lease = rest.client.get("leases", "default", "tpu-operator")
    holder = lease["spec"]["holderIdentity"]
    leader, follower = ops[leaders[0]], ops[1 - leaders[0]]
    assert metric(follower[1], "tpu_operator_is_leader") == 0
    # The leader dies without releasing the Lease.
    leader[0].kill()
    leader[0].wait()
    rest.client.create("tpujobs", pi_doc("pi-ha"))
    wait_until(lambda: metric(follower[1], "tpu_operator_is_leader") == 1,
               "the follower to take the Lease", timeout=45)
    assert rest.client.get("leases", "default", "tpu-operator")["spec"][
        "holderIdentity"] != holder
    final = wait_until(lambda: rest.condition("pi-ha"), "pi-ha to finish")
    assert final["type"] == "Succeeded", final
