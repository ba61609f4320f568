"""The port's operator end to end: controller + pod runner + real worker
processes over torch.distributed (gloo on the CPU).

Every pod command here says ``--device cpu``: the port's runner pins
nothing, so a worker without it would ask for the card. The runner's
base env sets ``OMP_NUM_THREADS=1`` so two workers do not thrash a
shared machine. Also held here, without processes: when the runner sets
``TPUJOB_DIST_BACKEND=gloo`` (one world's pods outnumber the machine's
CUDA devices, and only then).
"""

from __future__ import annotations

import os
import pathlib
import subprocess
import sys
import threading
import time

import pytest
import yaml

from mpi_operator_tpu_torch.controller.tpu_job_controller import TPUJobController
from mpi_operator_tpu_torch.runtime.apiserver import InMemoryAPIServer
from mpi_operator_tpu_torch.runtime.podrunner import LocalPodRunner
from mpi_operator_tpu_torch.utils.net import free_port_pair

pytestmark = pytest.mark.kernel

REPO_ROOT = pathlib.Path(__file__).resolve().parent.parent
PI_YAML = "mpi_operator_tpu_torch/examples/pi.yaml"
JOB_TIMEOUT = 60
CPU = ["--device", "cpu"]


@pytest.fixture
def cluster():
    api = InMemoryAPIServer()
    controller = TPUJobController(api)
    runner = LocalPodRunner(api, workdir=str(REPO_ROOT),
                            base_env={"OMP_NUM_THREADS": "1"}, cuda_devices=0)
    stop = threading.Event()
    thread = threading.Thread(
        target=lambda: controller.run(threadiness=2, stop=stop), daemon=True)
    thread.start()
    runner.start()
    yield api, runner
    stop.set()
    thread.join(timeout=10)
    runner.stop()


def wait_for(api, name, cond_type, timeout=JOB_TIMEOUT):
    terminal = {"Succeeded", "Failed"} - {cond_type}
    deadline = time.time() + timeout
    while time.time() < deadline:
        job = api.get("tpujobs", "default", name)
        conds = (job.get("status") or {}).get("conditions") or []
        for c in conds:
            if c["status"] == "True" and c["type"] == cond_type:
                return job
            if c["status"] == "True" and c["type"] in terminal:
                raise AssertionError(
                    f"{name} reached {c['type']}: {c.get('message', '')[-800:]}")
        time.sleep(0.1)
    raise AssertionError(f"timed out waiting for {name} to reach {cond_type}")


def pi_doc(name="pi", command=None) -> dict:
    doc = yaml.safe_load((REPO_ROOT / PI_YAML).read_text())
    doc["metadata"].update(name=name, namespace="default")
    doc["spec"]["jaxDistribution"] = {"coordinatorPort": free_port_pair()}
    container = doc["spec"]["tpuReplicaSpecs"]["Worker"]["template"]["spec"][
        "containers"][0]
    container["command"] = command or container["command"] + CPU
    return doc


@pytest.mark.e2e
def test_gpu_pi_manifest_succeeds(cluster):
    api, runner = cluster
    doc = pi_doc()
    assert doc["spec"]["tpu"]["acceleratorType"] == "h100-2"
    api.create("tpujobs", doc)
    job = wait_for(api, "pi", "Succeeded")
    assert job["status"]["replicaStatuses"]["Worker"]["succeeded"] == 2
    pods = api.list("pods", "default")
    assert len(pods) == 2
    for pod in pods:
        c = pod["spec"]["containers"][0]
        assert c["resources"]["limits"] == {"nvidia.com/gpu": 1}
        assert pod["status"]["phase"] == "Succeeded"
    # The runner keeps a finished pod's log; rank 0 prints the estimate.
    assert "pi is approximately" in runner.pod_log("default", "pi-worker-0")


@pytest.mark.e2e
def test_malformed_command_fails_naming_the_pod(cluster):
    api, runner = cluster
    api.create("tpujobs", pi_doc(
        "pi-broken", ["python", "-c", "raise SystemExit(3)"]))
    job = wait_for(api, "pi-broken", "Failed")
    (cond,) = [c for c in job["status"]["conditions"] if c["type"] == "Failed"]
    assert "pi-broken-worker" in cond["message"]
    codes = {p["status"]["containerStatuses"][0]["state"]["terminated"]["exitCode"]
             for p in api.list("pods", "default")
             if p["status"].get("phase") == "Failed"}
    assert codes == {3}


@pytest.mark.e2e
def test_two_worker_llama_tiny_trainer_job_succeeds(cluster):
    api, runner = cluster
    api.create("tpujobs", pi_doc("train", [
        "python", "-m", "mpi_operator_tpu_torch.cmd.train", *CPU,
        "--model", "llama-tiny", "--steps", "2", "--warmup", "1",
        "--global-batch", "8", "--seq-len", "16", "--log-every", "0",
        "--telemetry-every", "0"]))
    job = wait_for(api, "train", "Succeeded", timeout=90)
    assert job["status"]["replicaStatuses"]["Worker"]["succeeded"] == 2


# The healthcheck's startup exit codes (12: coordinator does not resolve,
# 13: nothing listens on the barrier port yet), restarted by the job's
# podFailurePolicy as the healthcheck's contract asks.
STARTUP_RESTART = {"backoffLimit": 6, "podFailurePolicy": {"rules": [
    {"action": "Restart", "onExitCodes": {"operator": "In",
                                          "values": [12, 13]}}]}}


@pytest.mark.e2e
def test_healthcheck_startup_race_restarts_the_early_worker(cluster):
    """Worker 0 waits before it hosts the barrier, so worker 1's preflight
    dial is refused (exit 13); the policy replaces worker 1 alone and the
    gang then forms and the collective probe passes."""
    api, runner = cluster
    late_rank0 = (
        "import os, runpy, sys, time\n"
        "if os.environ['TPUJOB_PROCESS_ID'] == '0': time.sleep(3)\n"
        "sys.argv = ['healthcheck', '--device', 'cpu']\n"
        "runpy.run_module('mpi_operator_tpu_torch.launcher.healthcheck', "
        "run_name='__main__')\n")
    doc = pi_doc("hc", ["python", "-c", late_rank0])
    doc["spec"]["runPolicy"].update(STARTUP_RESTART)
    api.create("tpujobs", doc)
    job = wait_for(api, "hc", "Succeeded")
    worker = job["status"]["replicaStatuses"]["Worker"]
    assert worker["succeeded"] == 2
    assert worker["restarts"] >= 1
    line = runner.pod_log("default", "hc-worker-0").strip().splitlines()[-1]
    assert '"ok": true' in line and '"num_processes": 2' in line


def _operator(*args, timeout=JOB_TIMEOUT):
    return subprocess.run(
        [sys.executable, "-m", "mpi_operator_tpu_torch.cmd.operator", *args],
        cwd=REPO_ROOT, capture_output=True, text=True, timeout=timeout,
        env={**os.environ, "OMP_NUM_THREADS": "1"})


@pytest.mark.e2e
@pytest.mark.parametrize("flags", [[], ["--enable-scheduler"]])
def test_cmd_operator_applies_pi_and_exits_zero(tmp_path, flags):
    manifest = tmp_path / "pi.yaml"
    manifest.write_text(yaml.safe_dump(pi_doc()))
    out = _operator("--backend", "memory", *flags, "--apply", str(manifest),
                    "--exit-on-completion")
    assert out.returncode == 0, out.stderr[-2000:]
    assert "TPUJob default/pi: Succeeded" in out.stdout
    if flags:
        # The gang scheduler bound both pods onto one 8-GPU node of the
        # default inventory before the runner started them.
        assert "registered 2 GPU node(s)" in out.stdout
        assert 'bound gang default/pi (2 pods) nodes="gpu-h100-8-s0-h0"' in (
            out.stderr)


@pytest.mark.e2e
@pytest.mark.parametrize("flags,item", [
    (["--backend", "kube", "--enable-scheduler"],
     "--enable-scheduler requires --backend memory"),
    (["--backend", "kube", "--enable-queue"],
     "--enable-queue requires --backend memory"),
])
def test_unported_flags_refuse_naming_their_items(flags, item):
    """Every flag of the JAX package's operator is ported now (``--backend
    kube`` was the last); what still refuses is what the JAX operator
    refuses too: the in-process scheduler and queue against a real
    cluster, which brings its own."""
    out = _operator(*flags, "--exit-on-completion")
    assert out.returncode == 1
    assert item in out.stderr
    assert "ROADMAP" not in out.stderr


# -- the runner's device honesty, without processes ------------------------

def _pod(world: int, extra_env=()) -> dict:
    env = [{"name": "TPUJOB_NUM_PROCESSES", "value": str(world)},
           {"name": "TPUJOB_COORDINATOR_ADDRESS",
            "value": "j-worker-0.j-worker.default.svc:8476"}, *extra_env]
    return {"metadata": {"name": "j-worker-0", "namespace": "default"},
            "spec": {"containers": [{"command": ["python", "x.py"],
                                     "env": env}]}}


@pytest.mark.parametrize("world,devices,gloo", [
    (2, 1, True), (2, 2, False), (8, 8, False), (16, 8, True), (1, 1, False),
    (2, 0, True)])
def test_gloo_only_when_a_worlds_pods_outnumber_the_cuda_devices(
        world, devices, gloo, monkeypatch, capsys):
    monkeypatch.delenv("TPUJOB_DIST_BACKEND", raising=False)
    runner = LocalPodRunner(InMemoryAPIServer(), cuda_devices=devices)
    env = runner._child_env(_pod(world))
    assert ("TPUJOB_DIST_BACKEND" in env) == gloo
    logged = "TPUJOB_DIST_BACKEND=gloo" in capsys.readouterr().err
    assert logged == gloo
    if gloo:
        assert env["TPUJOB_DIST_BACKEND"] == "gloo"
    # Nothing is pinned: no platform, no device list is forced.
    for key in ("CUDA_VISIBLE_DEVICES", "JAX_PLATFORMS"):
        assert env.get(key) == os.environ.get(key)
    assert env["TPUJOB_COORDINATOR_ADDRESS"] == "127.0.0.1:8476"


def test_pods_own_backend_choice_wins(monkeypatch):
    monkeypatch.delenv("TPUJOB_DIST_BACKEND", raising=False)
    runner = LocalPodRunner(InMemoryAPIServer(), cuda_devices=1)
    env = runner._child_env(_pod(2, [{"name": "TPUJOB_DIST_BACKEND",
                                      "value": "nccl"}]))
    assert env["TPUJOB_DIST_BACKEND"] == "nccl"


def test_cuda_devices_counted_without_torch(monkeypatch):
    from mpi_operator_tpu_torch.runtime import podrunner

    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "0,1,2")
    assert podrunner.count_cuda_devices() == 3
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "")
    assert podrunner.count_cuda_devices() == 0
    monkeypatch.delenv("CUDA_VISIBLE_DEVICES")
    monkeypatch.setattr(podrunner.shutil, "which", lambda name: None)
    assert podrunner.count_cuda_devices() == 0
    assert LocalPodRunner(InMemoryAPIServer()).cuda_devices == 0


def test_monitoring_serves_metrics_healthz_and_a_jobs_timeline():
    """``--monitoring-port``'s server on the port's controller: /healthz,
    /metrics with the controller's counters, a job's timeline."""
    import json
    import urllib.request

    from mpi_operator_tpu_torch.cmd import operator
    from mpi_operator_tpu_torch.utils import flightrecorder, metrics

    api = InMemoryAPIServer()
    registry = metrics.Registry()
    recorder = flightrecorder.FlightRecorder()
    controller = TPUJobController(api, registry=registry,
                                  flight_recorder=recorder)
    controller.start()
    doc = pi_doc()
    doc["spec"]["tpuReplicaSpecs"]["Worker"]["replicas"] = 2
    api.create("tpujobs", doc)
    controller.factory.pump_until_quiet()
    controller.sync_handler("default/pi")
    server = operator.start_monitoring(0, registry, lambda: True,
                                       flight_recorder=recorder)
    try:
        base = f"http://127.0.0.1:{server.server_address[1]}"

        def get(path):
            with urllib.request.urlopen(base + path, timeout=10) as r:
                return r.status, r.read().decode()

        assert get("/healthz") == (200, "ok")
        status, text = get("/metrics")
        assert status == 200 and "tpu_operator_jobs_created_total 1" in text
        status, body = get("/debug/jobs/default/pi/timeline")
        kinds = {e["kind"] for e in json.loads(body)["entries"]}
        assert status == 200 and "condition" in kinds
    finally:
        server.shutdown()
        server.server_close()
