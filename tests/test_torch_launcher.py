"""The port's launcher (``mpi_operator_tpu_torch/launcher``) against the JAX
package's: ``RendezvousConfig.from_env`` and ``check_multislice`` on the
env dicts of ``tests/test_launcher.py`` (every field, and the same error
or none); the gang barrier's wire protocol, the port's client against
the JAX server and the reverse; the healthcheck's exit codes and JSON
line; and a two-process world formed by ``initialize`` with the
healthcheck's collective probe over gloo.
"""

import dataclasses
import json
import os
import socket
import subprocess
import sys
import threading

import pytest

from mpi_operator_tpu.launcher import barrier as jbarrier
from mpi_operator_tpu.launcher import bootstrap as jboot
from mpi_operator_tpu_torch.launcher import barrier as tbarrier
from mpi_operator_tpu_torch.launcher import bootstrap as tboot
from mpi_operator_tpu_torch.launcher import healthcheck
from mpi_operator_tpu_torch.utils.net import free_port_pair

pytestmark = pytest.mark.kernel

ENV = {
    "TPUJOB_COORDINATOR_ADDRESS": "j-worker-0.j-worker.ns.svc:8476",
    "TPUJOB_NUM_PROCESSES": "4",
    "TPUJOB_PROCESS_ID": "2",
    "TPU_WORKER_ID": "2",
    "TPU_WORKER_HOSTNAMES": "a.svc,b.svc,c.svc,d.svc",
    "TPU_ACCELERATOR_TYPE": "v5e-16",
    "TPU_TOPOLOGY": "4x4",
    "TPU_CHIPS_PER_HOST": "4",
    "TPUJOB_NAME": "j",
    "TPUJOB_NAMESPACE": "ns",
}
MULTISLICE = {
    **ENV,
    "TPUJOB_NUM_PROCESSES": "8", "TPUJOB_PROCESS_ID": "5",
    "TPU_WORKER_ID": "1", "TPU_WORKER_HOSTNAMES": "e.svc,f.svc,g.svc,h.svc",
    "TPUJOB_NUM_SLICES": "2", "TPUJOB_SLICE_ID": "1",
    "MEGASCALE_COORDINATOR_ADDRESS": "j-worker-0.j-worker.ns.svc:8080",
    "MEGASCALE_NUM_SLICES": "2", "MEGASCALE_SLICE_ID": "1",
    "MEGASCALE_PORT": "8080",
}
ENVS = {
    "four-hosts": ENV,
    "empty": {},
    "garbage-int": {"TPUJOB_NUM_PROCESSES": "banana"},
    "multislice": MULTISLICE,
    "no-dcn-coordinator": {**MULTISLICE, "MEGASCALE_COORDINATOR_ADDRESS": ""},
    "indivisible-world": {**MULTISLICE, "TPUJOB_NUM_PROCESSES": "7"},
    "wrong-process-id": {**MULTISLICE, "TPUJOB_PROCESS_ID": "6"},
    "short-hostnames": {**MULTISLICE, "TPU_WORKER_HOSTNAMES": "e.svc,f.svc"},
    "megascale-slice": {**MULTISLICE, "MEGASCALE_SLICE_ID": "0"},
    "megascale-slices": {**MULTISLICE, "MEGASCALE_NUM_SLICES": "4"},
    "megascale-port": {**MULTISLICE, "MEGASCALE_PORT": "9999"},
}


def _check(cfg):
    try:
        cfg.check_multislice()
    except RuntimeError as e:
        return str(e)
    return None


@pytest.mark.parametrize("name", sorted(ENVS))
def test_rendezvous_config_is_the_jax_packages(name):
    got = tboot.RendezvousConfig.from_env(ENVS[name])
    want = jboot.RendezvousConfig.from_env(ENVS[name])
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    for prop in ("is_distributed", "is_coordinator", "is_multislice",
                 "hosts_per_slice"):
        assert getattr(got, prop) == getattr(want, prop), prop
    assert _check(got) == _check(want)


def _gang(serve, wait, world: int, port: int) -> dict:
    results = {}

    def client(rank):
        results[rank] = wait("127.0.0.1", port, rank, 10_000)

    def server_run():
        results["serve"] = serve(port, world, 10_000)

    server = threading.Thread(target=server_run)
    server.start()
    clients = [threading.Thread(target=client, args=(r,))
               for r in range(world)]
    for t in clients:
        t.start()
    for t in [server, *clients]:
        t.join(30)
    return results


@pytest.mark.parametrize("server,clients", [
    ("jax", "port"), ("port", "jax"), ("port", "port")])
def test_barrier_speaks_the_jax_wire_protocol(server, clients):
    engines = {"jax": jbarrier, "port": tbarrier}
    results = _gang(engines[server]._py_serve, engines[clients]._py_wait, 3,
                    free_port_pair())
    assert results == {"serve": 0, 0: 0, 1: 0, 2: 0}


def test_gang_barrier_times_out_naming_the_rank():
    with pytest.raises(TimeoutError, match="barrier server on rank 0 failed"):
        tbarrier.gang_barrier(coordinator_host="127.0.0.1",
                              port=free_port_pair(), rank=0, world_size=2,
                              timeout_s=1.0)


def test_healthcheck_exit_codes(monkeypatch):
    cfg = tboot.RendezvousConfig(coordinator_address="w-0.svc:8476",
                                 num_processes=2, process_id=1)

    def no_dns(*a, **kw):
        raise socket.gaierror("not resolvable yet")

    with monkeypatch.context() as m:
        m.setattr(socket, "getaddrinfo", no_dns)
        with pytest.raises(healthcheck.ProbeFailure) as exc:
            healthcheck.probe_rendezvous(cfg, timeout_s=2.0)
    assert exc.value.exit_code == healthcheck.EXIT_DNS_NOT_READY == 12

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]  # closed on exit: port refuses
    refused = dataclasses.replace(cfg, coordinator_address=f"127.0.0.1:"
                                                           f"{port - 1}")
    with pytest.raises(healthcheck.ProbeFailure) as exc:
        healthcheck.probe_rendezvous(refused, timeout_s=2.0)
    assert exc.value.exit_code == healthcheck.EXIT_CONNECTION_REFUSED == 13
    # Rank 0 hosts the barrier: it never dials it.
    healthcheck.probe_rendezvous(
        dataclasses.replace(refused, process_id=0), timeout_s=2.0)

    lonely = tboot.RendezvousConfig(
        coordinator_address=f"127.0.0.1:{free_port_pair()}", num_processes=2)
    with pytest.raises(healthcheck.ProbeFailure) as exc:
        healthcheck.run_healthcheck(lonely, device_type="cpu",
                                    barrier_timeout_s=1.0)
    assert exc.value.exit_code == healthcheck.EXIT_BARRIER_TIMEOUT == 14


def test_healthcheck_main_prints_one_json_line(monkeypatch, capsys):
    for key in ("TPUJOB_NUM_PROCESSES", "TPUJOB_PROCESS_ID",
                "TPUJOB_COORDINATOR_ADDRESS"):
        monkeypatch.delenv(key, raising=False)
    assert healthcheck.main(["--device", "cpu"]) == healthcheck.EXIT_OK
    line = json.loads(capsys.readouterr().out.strip())
    assert line["ok"] is True and line["num_processes"] == 1

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    monkeypatch.setenv("TPUJOB_COORDINATOR_ADDRESS", f"127.0.0.1:{port - 1}")
    monkeypatch.setenv("TPUJOB_NUM_PROCESSES", "2")
    monkeypatch.setenv("TPUJOB_PROCESS_ID", "1")
    assert healthcheck.main(["--device", "cpu"]) == 13
    line = json.loads(capsys.readouterr().out.strip())
    assert line["ok"] is False and line["exit_code"] == 13


def test_two_process_world_passes_the_collective_probe():
    """``python -m ...launcher.healthcheck`` as two ranks of one job: the
    gang barrier, ``init_process_group`` over gloo and the gather of the
    process ids; each prints its JSON line and exits 0. Rank 1 starts
    once rank 0's barrier accepts: its preflight dials the barrier once
    and exits 13 on a refusal, for the pod to be restarted."""
    import time

    port = free_port_pair()
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

    def start(rank):
        return subprocess.Popen(
            [sys.executable, "-m",
             "mpi_operator_tpu_torch.launcher.healthcheck", "--device", "cpu"],
            env={**os.environ,
                 "TPUJOB_COORDINATOR_ADDRESS": f"127.0.0.1:{port}",
                 "TPUJOB_NUM_PROCESSES": "2", "TPUJOB_PROCESS_ID": str(rank),
                 "OMP_NUM_THREADS": "1"},
            cwd=repo, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True)

    procs = [start(0)]
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline:
        try:
            socket.create_connection(("127.0.0.1", port + 1), 1).close()
            break
        except OSError:
            time.sleep(0.1)
    procs.append(start(1))
    try:
        outs = [p.communicate(timeout=60) for p in procs]
    finally:
        for p in procs:  # a wedged rank must not outlive the test
            if p.poll() is None:
                p.kill()
                p.communicate()
    for rank, (p, (out, err)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {rank}: {err[-3000:]}"
        line = json.loads(out.strip().splitlines()[-1])
        assert line == {"ok": True, "process_id": rank, "num_processes": 2,
                        "device": "cpu", "device_count": 2,
                        "local_device_count": 1}
