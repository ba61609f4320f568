"""Local pod runner: a kubelet + batch-Job-controller simulator (the
port's ``mpi_operator_tpu/runtime/podrunner.py``).

Reference analog: the kind cluster in the reference's e2e tier
(/root/reference/v2/test/e2e/e2e_suite_test.go) — real containers running
real MPI traffic.  Here, worker pods become real *subprocesses* running
real ``torch.distributed`` traffic over localhost, which exercises the
identical rendezvous path the operator wires up on a cluster.

The port's runner is honest about the device. The JAX package's runner
pins its children to the JAX CPU backend; this one pins nothing: a worker
runs on the card unless its own command says ``--device cpu`` (as the CPU
tests' commands do). It is told how many CUDA devices the machine has
(``cuda_devices``; by default counted with ``nvidia-smi``, so the operator
process never imports torch). Every node of the simulator is this one
machine, so when one world's pods outnumber those devices it sets
``TPUJOB_DIST_BACKEND=gloo`` in the child env, and logs it: NCCL refuses
two ranks on one GPU. It never moves a worker to the CPU and never
catches a worker's failure: a pod that exits non-zero fails, as in the
JAX package.

- pods created on the API server are "scheduled" and executed:
  Pending → Running → Succeeded/Failed by exit code;
- the pod env is taken verbatim from the pod spec, with worker-FQDN
  coordinator addresses rewritten to 127.0.0.1 (the simulator's cluster
  DNS);
- ``restartPolicy: OnFailure`` restarts the process (bounded);
- pod logs are tailed LIVE (a reader thread per process, not a read at
  reap) and kept after the process exits (``pod_log``), and
  ``step_heartbeat``/``device_memory`` JSONL lines the trainer emits
  are patched onto the pod as the step-heartbeat and device-memory
  annotations — the kubelet half of the step-skew and
  device-memory observatories (the pod informer watch carries the
  patches to utils/stepstats.py and utils/devstats.py with no new
  transport);
- batch/v1 Jobs get a pod created from their template and their status
  mirrored to Complete/Failed with backoffLimit retries — the part of the
  reference flow that the kube Job controller owns
  (mpi_job_controller.go:573 hands control to it);
- deleting a pod kills its process.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import threading
import time
from dataclasses import dataclass, field
from typing import TYPE_CHECKING, Optional, Union

from ..api.v2beta1 import constants
from ..utils import flightrecorder
from ..utils.logging import get_logger
from . import locktrace, retry
from .apiserver import (
    ADDED,
    DELETED,
    MODIFIED,
    ApiError,
    ConflictError,
    InMemoryAPIServer,
    NotFoundError,
)

if TYPE_CHECKING:
    from .kube import KubeAPIServer

MAX_RESTARTS = 3

# The nodeName auto-bind mode stamps when no scheduler is running: the
# simulator's single implicit machine.
DEFAULT_NODE_NAME = "local-node"


def count_cuda_devices() -> int:
    """CUDA devices a child process of this machine will see, without
    importing torch: ``CUDA_VISIBLE_DEVICES`` when it is set, else the
    GPUs ``nvidia-smi -L`` lists, else 0."""
    visible = os.environ.get("CUDA_VISIBLE_DEVICES")
    if visible is not None:
        return len([d for d in visible.split(",") if d.strip()])
    smi = shutil.which("nvidia-smi")
    if smi is None:
        return 0
    try:
        out = subprocess.run([smi, "-L"], capture_output=True, text=True,
                             timeout=30, check=False).stdout
    except (OSError, subprocess.SubprocessError):
        return 0
    return sum(1 for line in out.splitlines() if line.startswith("GPU "))


@dataclass
class RunningPod:
    process: subprocess.Popen
    restarts: int = 0
    log: str = ""
    # Live stdout tail (one daemon thread per process); log appends are
    # serialized by log_lock so pod_log() reads a consistent prefix.
    reader: Optional[threading.Thread] = None
    log_lock: threading.Lock = field(default_factory=threading.Lock)


class LocalPodRunner:
    def __init__(
        self,
        api: Union[InMemoryAPIServer, KubeAPIServer],
        *,
        base_env: Optional[dict[str, str]] = None,
        workdir: Optional[str] = None,
        auto_bind: bool = True,
        node_name: str = DEFAULT_NODE_NAME,
        flight_recorder: Optional[flightrecorder.FlightRecorder] = None,
        cuda_devices: Optional[int] = None,
    ):
        self.api = api
        self.log = get_logger("podrunner")
        # The machine's CUDA devices, which every pod of every node here
        # shares (see the module docstring).
        self.cuda_devices = (
            count_cuda_devices() if cuda_devices is None else cuda_devices
        )
        # Shared with the controller when the operator wires one through:
        # pod phase flips land on the owning job's timeline.
        self.flight_recorder = flight_recorder
        self.base_env = base_env or {}
        self.workdir = workdir or os.getcwd()
        # A kubelet only runs pods bound to its node.  With no scheduler in
        # the process (the default), the runner plays scheduler too and
        # auto-binds unbound pods to its own node; with ``auto_bind=False``
        # it strictly waits for ``spec.nodeName`` (gang-scheduler mode).
        self.auto_bind = auto_bind
        self.node_name = node_name
        self._pods: dict[tuple[str, str], RunningPod] = {}
        # Chaos SlowWorker registrations: pod key -> slowdown factor,
        # injected into the child env (ENV_STEP_SLOWDOWN) so the
        # trainer's step clock stretches; a factor registered against a
        # live process takes effect at its next (re)start — the runner
        # cannot retroactively slow a running subprocess.
        self._slow: dict[tuple[str, str], float] = {}
        # Chaos MemoryLeak registrations: pod key -> bytes per window,
        # injected into the child env (ENV_MEM_LEAK_BYTES) so the
        # worker's devstats sampler inflates its reported HBM; same
        # next-(re)start semantics as _slow.
        self._leak: dict[tuple[str, str], int] = {}
        # Chaos TornWrite registrations: pod key -> True, injected ONCE
        # into the child env (ENV_TORN_WRITE) so the checkpoint writer
        # tears its next commit (step data written, marker withheld);
        # one-shot — the entry is popped at injection, so a restarted pod
        # writes clean checkpoints again.
        self._torn: dict[tuple[str, str], bool] = {}
        self._job_pods: dict[tuple[str, str], int] = {}  # job -> failures so far
        # The log of each pod whose process exited, as a kubelet keeps a
        # finished container's log: ``pod_log`` still reads it.
        self._finished_logs: dict[tuple[str, str], str] = {}
        self._lock = locktrace.rlock("podrunner")
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._pod_watch = None
        self._job_watch = None

    # -- lifecycle -------------------------------------------------------

    def start(self) -> None:
        self._pod_watch = self.api.watch("pods")
        self._job_watch = self.api.watch("jobs")
        # Pick up anything that already exists.
        for pod in self.api.list("pods"):
            self._maybe_start_pod(pod)
        for job in self.api.list("jobs"):
            self._maybe_start_job_pod(job)
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=10)
        with self._lock:
            for running in self._pods.values():
                if running.process.poll() is None:
                    running.process.kill()
            self._pods.clear()
        if self._pod_watch:
            self._pod_watch.stop()
        if self._job_watch:
            self._job_watch.stop()

    def _loop(self) -> None:
        while not self._stop.is_set():
            try:
                progressed = self._step()
            except ApiError as exc:
                # Over REST a call can still fail once its retries are
                # spent; a kubelet keeps serving its node all the same.
                self.log.warning("pod runner step failed: %s", exc)
                progressed = False
            if not progressed:
                time.sleep(0.02)

    def _step(self) -> bool:
        progressed = False
        for event in self._pod_watch.drain():
            progressed = True
            key = self._event_key(event.object)
            if event.type in (ADDED, MODIFIED):
                # MODIFIED matters in scheduler mode: the bind that
                # stamps spec.nodeName arrives as an update, not a
                # create. _maybe_start_pod is idempotent per pod.
                self._maybe_start_pod(event.object)
            elif event.type == DELETED:
                self._kill(key)
        for event in self._job_watch.drain():
            progressed = True
            if event.type == ADDED:
                self._maybe_start_job_pod(event.object)
        if self._reap():
            progressed = True
        return progressed

    @staticmethod
    def _event_key(obj: dict) -> tuple[str, str]:
        meta = obj["metadata"]
        return meta.get("namespace", ""), meta["name"]

    # -- pod execution ---------------------------------------------------

    def _child_env(self, pod: dict) -> dict[str, str]:
        env = dict(os.environ)
        # The "image" of our simulated containers is the repo itself.
        env["PYTHONPATH"] = self.workdir + (
            os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else ""
        )
        env.update(self.base_env)
        factor = self._slow.get(self._event_key(pod))
        if factor is not None and factor > 1.0:
            env[constants.ENV_STEP_SLOWDOWN] = str(factor)
        leak = self._leak.get(self._event_key(pod))
        if leak is not None and leak > 0:
            env[constants.ENV_MEM_LEAK_BYTES] = str(leak)
        if self._torn.pop(self._event_key(pod), None):
            env[constants.ENV_TORN_WRITE] = "1"
        container = (pod["spec"].get("containers") or [{}])[0]
        world = self._world_size(container)
        if world > self.cuda_devices:
            # NCCL refuses two ranks of one world on one GPU; gloo stages
            # the collectives through the host. The pod's own env, applied
            # below, still wins.
            env[constants.ENV_DIST_BACKEND] = "gloo"
            key = self._event_key(pod)
            self.log.info(
                "pod %s/%s: %d ranks of one world on %d CUDA device(s); "
                "%s=gloo", key[0], key[1], world, self.cuda_devices,
                constants.ENV_DIST_BACKEND,
            )
        for item in container.get("env") or []:
            value = str(item.get("value", ""))
            if item.get("name") == "TPUJOB_COORDINATOR_ADDRESS" and ":" in value:
                # Cluster DNS of the simulator: every "node" is localhost.
                value = "127.0.0.1:" + value.rsplit(":", 1)[1]
            env[item["name"]] = value
        return env

    @staticmethod
    def _world_size(container: dict) -> int:
        """The pod's world size (``TPUJOB_NUM_PROCESSES`` in its env; 0
        for a pod outside any world, such as a launcher)."""
        for item in container.get("env") or []:
            if item.get("name") == constants.ENV_NUM_PROCESSES:
                try:
                    return int(item.get("value", 0))
                except (TypeError, ValueError):
                    return 0
        return 0

    def _command(self, pod: dict) -> list[str]:
        container = (pod["spec"].get("containers") or [{}])[0]
        cmd = list(container.get("command") or [])
        cmd += [str(a) for a in container.get("args") or []]
        if cmd and cmd[0] == "python":
            cmd[0] = sys.executable
        return cmd

    def _ensure_bound(self, pod: dict) -> Optional[dict]:
        """Return a pod bound to a node, auto-binding if this runner plays
        scheduler; None if the pod must keep waiting for a bind."""
        if pod["spec"].get("nodeName"):
            return pod
        if not self.auto_bind:
            return None
        key = self._event_key(pod)

        def bind():
            fresh = self.api.get("pods", key[0], key[1])
            if fresh["spec"].get("nodeName"):
                return fresh
            fresh["spec"]["nodeName"] = self.node_name
            return self.api.update("pods", fresh)

        try:
            return retry.retry_on_conflict(bind, retry.Backoff(steps=2, duration=0.005))
        except NotFoundError:
            return None
        except ConflictError:
            return None  # give up until the next watch event

    def _maybe_start_pod(self, pod: dict) -> None:
        key = self._event_key(pod)
        with self._lock:
            if key in self._pods:
                return
        # A pod we are not tracking but whose phase already progressed is
        # one we (or a previous runner) finished or are mid-reaping —
        # MODIFIED events from our own status writes must not relaunch it.
        if (pod.get("status") or {}).get("phase") in ("Running", "Succeeded", "Failed"):
            return
        bound = self._ensure_bound(pod)
        if bound is None:
            return
        pod = bound
        with self._lock:
            if key in self._pods:
                return
            cmd = self._command(pod)
            if not cmd:
                self._set_phase(key, "Failed", reason="NoCommand")
                return
            running = self._launch(key, pod)
            self._pods[key] = running
        self.log.info("started pod %s/%s", key[0], key[1],
                      pid=running.process.pid)
        self._set_phase(key, "Running")

    def _launch(
        self, key: tuple[str, str], pod: dict, restarts: int = 0, log: str = ""
    ) -> RunningPod:
        """Spawn the pod's process plus its log-tail thread.  The tail is
        the kubelet-sim's live log stream: it accumulates the pod log as
        lines arrive (pod_log() sees a running pod's output, not just a
        dead one's) and bridges ``step_heartbeat`` JSONL lines onto the
        pod as annotation patches."""
        process = subprocess.Popen(
            self._command(pod),
            env=self._child_env(pod),
            cwd=self.workdir,
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
            text=True,
        )
        running = RunningPod(process=process, restarts=restarts, log=log)
        running.reader = threading.Thread(
            target=self._tail, args=(key, running), daemon=True,
            name=f"podrunner-tail-{key[1]}",
        )
        running.reader.start()
        return running

    def _tail(self, key: tuple[str, str], running: RunningPod) -> None:
        stdout = running.process.stdout
        if stdout is None:  # pragma: no cover - Popen always pipes here
            return
        for line in stdout:
            with running.log_lock:
                running.log += line
            stripped = line.strip()
            if not stripped.startswith('{"'):
                continue
            try:
                record = json.loads(stripped)
            except ValueError:
                continue
            if not isinstance(record, dict):
                continue
            event = record.get("event")
            if event == "step_heartbeat":
                self._publish_annotation(
                    key, constants.STEP_HEARTBEAT_ANNOTATION, record
                )
            elif event == "device_memory":
                self._publish_annotation(
                    key, constants.DEVICE_MEMORY_ANNOTATION, record
                )

    def _publish_annotation(
        self, key: tuple[str, str], annotation: str, record: dict
    ) -> None:
        """Patch a telemetry record onto one of the pod's observatory
        annotations — step heartbeats and device-memory samples share
        this bridge (get+mutate+update with conflict retry — the memory
        apiserver has no patch verb).  The resulting MODIFIED watch event
        is how the controller-side matrices learn about the window."""

        def apply():
            pod = self.api.get("pods", key[0], key[1])
            meta = pod.setdefault("metadata", {})
            annotations = dict(meta.get("annotations") or {})
            annotations[annotation] = json.dumps(record, sort_keys=True)
            meta["annotations"] = annotations
            return self.api.update("pods", pod)

        try:
            retry.retry_on_conflict(
                apply, retry.Backoff(steps=3, duration=0.005)
            )
        except NotFoundError:
            pass  # pod deleted mid-run; nothing to annotate
        except ConflictError:
            pass  # next window's record will carry fresher numbers
        except Exception:
            self.log.debug(
                "annotation patch %s failed for %s/%s",
                annotation, key[0], key[1],
            )

    def _kill(self, key: tuple[str, str]) -> None:
        with self._lock:
            running = self._pods.pop(key, None)
        if running and running.process.poll() is None:
            running.process.kill()

    def _reap(self) -> bool:
        """Collect exited processes, apply restart policy, flip phases."""
        progressed = False
        with self._lock:
            items = list(self._pods.items())
        for key, running in items:
            rc = running.process.poll()
            if rc is None:
                continue
            progressed = True
            # The tail thread owns stdout: wait for it to drain the last
            # buffered lines so the failure message below sees them.
            if running.reader is not None:
                running.reader.join(timeout=5)
            try:
                pod = self.api.get("pods", key[0], key[1])
            except NotFoundError:
                with self._lock:
                    self._pods.pop(key, None)
                continue
            restart_policy = pod["spec"].get("restartPolicy", "Never")
            with running.log_lock:
                self._finished_logs[key] = running.log
            # Container exit code convention: a signal death reports
            # 128+signal (SIGKILL → 137), the code preemptions show.
            exit_code = rc if rc >= 0 else 128 - rc
            if rc == 0:
                self._set_phase(key, "Succeeded", exit_code=0)
                with self._lock:
                    self._pods.pop(key, None)
            elif restart_policy == "OnFailure" and running.restarts < MAX_RESTARTS:
                running.restarts += 1
                self.log.warning(
                    "pod %s/%s exited rc=%d; restarting (%d/%d)",
                    key[0], key[1], rc, running.restarts, MAX_RESTARTS,
                )
                with running.log_lock:
                    carried_log = running.log
                with self._lock:
                    self._pods[key] = self._launch(
                        key, pod, restarts=running.restarts, log=carried_log
                    )
            else:
                with running.log_lock:
                    tail = running.log[-1024:]
                self._set_phase(
                    key, "Failed", reason="Error", message=tail,
                    exit_code=exit_code,
                )
                with self._lock:
                    self._pods.pop(key, None)
                self._mirror_job_failure(pod)
        return progressed

    # -- chaos hooks -----------------------------------------------------

    def kill_pod(self, namespace: str, name: str) -> bool:
        """Chaos hook: SIGKILL the pod's process.  The reaper classifies
        the exit through the normal failure path (rc -9 → exitCode 137,
        the code a TPU preemption reports)."""
        with self._lock:
            running = self._pods.get((namespace, name))
        if running is None or running.process.poll() is not None:
            return False
        running.process.kill()
        return True

    def slow_worker(
        self, namespace: str, name: str, factor: float
    ) -> bool:
        """Chaos hook: mark the pod's host slow by ``factor``.  The
        factor reaches the trainer's step clock via ENV_STEP_SLOWDOWN at
        the pod's next (re)start — a live subprocess cannot be slowed
        retroactively, matching a real straggler that appears after a
        reschedule onto a degraded host.  Returns False for pods this
        runner does not know."""
        if factor < 1.0:
            return False
        return self._register_chaos(self._slow, namespace, name, factor)

    def leak_worker(
        self, namespace: str, name: str, bytes_per_window: int
    ) -> bool:
        """Chaos hook: mark the pod's worker as leaking HBM by
        ``bytes_per_window``.  The increment reaches the devstats
        sampler via ENV_MEM_LEAK_BYTES at the pod's next (re)start —
        same semantics as slow_worker.  Returns False for pods this
        runner does not know."""
        if bytes_per_window <= 0:
            return False
        return self._register_chaos(
            self._leak, namespace, name, int(bytes_per_window)
        )

    def heal_worker(self, namespace: str, name: str) -> bool:
        """Chaos hook: the pod's host is repaired — drop its slowdown and
        leak registrations so its next (re)start runs clean (the running
        process keeps its fault, as with slow_worker).  Returns False
        when the pod carried neither."""
        key = (namespace, name)
        with self._lock:
            slow = self._slow.pop(key, None)
            leak = self._leak.pop(key, None)
        return slow is not None or leak is not None

    def tear_write(self, namespace: str, name: str) -> bool:
        """Chaos hook: arm a one-shot torn checkpoint commit for the
        pod's *next* (re)start — the writer persists the step data but
        withholds the commit marker (ENV_TORN_WRITE), modelling a death
        between the fsync of the data and the rename of the marker.
        Same next-(re)start semantics as slow_worker; the registration
        is consumed at injection (one torn commit per arm)."""
        return self._register_chaos(self._torn, namespace, name, True)

    def _register_chaos(
        self, table: dict, namespace: str, name: str, value
    ) -> bool:
        """Shared registration for next-(re)start chaos env injection:
        the pod must be running here or at least exist in the apiserver."""
        key = (namespace, name)
        with self._lock:
            if key not in self._pods:
                try:
                    self.api.get("pods", namespace, name)
                except NotFoundError:
                    return False
            table[key] = value
        return True

    def fail_node(self, namespace: str, name: str) -> bool:
        """Chaos hook: the pod's node dies — the process is killed and the
        pod flips straight to Failed/NodeLost with no exit code (a dead
        kubelet never reports one), exercising condition/reason matching
        in podFailurePolicy rather than exit-code matching."""
        key = (namespace, name)
        with self._lock:
            running = self._pods.pop(key, None)
        if running is None:
            return False
        if running.process.poll() is None:
            running.process.kill()
        self._set_phase(key, "Failed", reason="NodeLost", message="node died")
        return True

    def _set_phase(
        self,
        key: tuple[str, str],
        phase: str,
        reason: str = "",
        message: str = "",
        exit_code: Optional[int] = None,
    ) -> None:
        built: dict = {}

        def flip() -> None:
            pod = self.api.get("pods", key[0], key[1])
            # Merge, don't replace: the scheduler's PodScheduled condition
            # must survive the phase flip.
            status = dict(pod.get("status") or {})
            status["phase"] = phase
            if reason:
                status["reason"] = reason
            if message:
                status["message"] = message
            if exit_code is not None:
                # Surface the container exit code the way a kubelet would,
                # so podFailurePolicy onExitCodes rules have something to
                # match.
                container = (pod["spec"].get("containers") or [{}])[0]
                status["containerStatuses"] = [
                    {
                        "name": container.get("name", "main"),
                        "state": {"terminated": {"exitCode": exit_code}},
                    }
                ]
            pod["status"] = status
            built["pod"] = pod
            self.api.update_status("pods", pod)

        # The log-tail thread's annotation patches race this write (and,
        # over REST, every round trip widens the window): a lost flip to
        # Succeeded or Failed would leave the job waiting forever, so a
        # conflict re-reads the pod and writes again.
        try:
            retry.retry_on_conflict(flip)
        except NotFoundError:
            return
        except ApiError as exc:
            self.log.warning("pod %s/%s: phase %s not written: %s",
                             key[0], key[1], phase, exc)
        pod = built.get("pod")
        if pod is None:
            return
        if reason:
            self.log.debug("pod %s/%s -> %s", key[0], key[1], phase,
                           reason=reason)
        else:
            self.log.debug("pod %s/%s -> %s", key[0], key[1], phase)
        self._record_pod_flip(pod, phase, reason, message, exit_code)
        if phase == "Succeeded":
            self._mirror_job_success(pod)

    def _record_pod_flip(
        self, pod: dict, phase: str, reason: str, message: str,
        exit_code: Optional[int] = None,
    ) -> None:
        """Put the phase flip on the owning TPUJob's flight-recorder
        timeline.  Worker pods carry the job-name label directly; launcher
        pods are owned by a batch Job whose template carries it too.
        The exit code rides along when the kubelet reported one, so the
        goodput ledger can tell a preemption (137) from a crash without
        re-reading the pod."""
        if self.flight_recorder is None:
            return
        labels = pod["metadata"].get("labels") or {}
        job_name = labels.get(constants.JOB_NAME_LABEL)
        if not job_name:
            return
        attrs = {}
        if exit_code is not None:
            attrs["exit_code"] = exit_code
        self.flight_recorder.record(
            pod["metadata"].get("namespace", ""),
            job_name,
            flightrecorder.POD,
            reason=reason or phase,
            message=message[-256:] if message else "",
            pod=pod["metadata"]["name"],
            phase=phase,
            **attrs,
        )

    def pod_log(self, namespace: str, name: str) -> str:
        """The pod's log: live while it runs, kept after its process
        exits."""
        with self._lock:
            running = self._pods.get((namespace, name))
        if running is None:
            return self._finished_logs.get((namespace, name), "")
        with running.log_lock:
            return running.log

    # -- batch Job mirroring --------------------------------------------

    def _maybe_start_job_pod(self, job: dict) -> None:
        ns, name = self._event_key(job)
        template = (job.get("spec") or {}).get("template") or {}
        pod = {
            "apiVersion": "v1",
            "kind": "Pod",
            "metadata": {
                "name": f"{name}-0",
                "namespace": ns,
                "labels": dict((template.get("metadata") or {}).get("labels") or {}),
                "ownerReferences": [
                    {
                        "apiVersion": "batch/v1",
                        "kind": "Job",
                        "name": name,
                        "uid": job["metadata"].get("uid", ""),
                        "controller": True,
                    }
                ],
            },
            "spec": dict(template.get("spec") or {}),
        }
        pod["metadata"]["labels"].setdefault("job-name", name)
        try:
            self.api.create("pods", pod)
        except Exception:
            pass  # already exists

    def _owning_job(self, pod: dict) -> Optional[tuple[str, str]]:
        for ref in pod["metadata"].get("ownerReferences") or []:
            if ref.get("kind") == "Job" and ref.get("controller"):
                return pod["metadata"].get("namespace", ""), ref["name"]
        return None

    def _mirror_job_success(self, pod: dict) -> None:
        owner = self._owning_job(pod)
        if owner is None:
            return
        try:
            job = self.api.get("jobs", owner[0], owner[1])
        except NotFoundError:
            return
        job["status"] = {
            "succeeded": 1,
            "completionTime": time.time(),
            "conditions": [{"type": "Complete", "status": "True"}],
        }
        try:
            self.api.update_status("jobs", job)
        except Exception:
            pass

    def _mirror_job_failure(self, pod: dict) -> None:
        owner = self._owning_job(pod)
        if owner is None:
            return
        try:
            job = self.api.get("jobs", owner[0], owner[1])
        except NotFoundError:
            return
        failures = self._job_pods.get(owner, 0) + 1
        self._job_pods[owner] = failures
        backoff = (job.get("spec") or {}).get("backoffLimit", 0)
        status = dict(job.get("status") or {})
        status["failed"] = failures
        if failures > backoff:
            status["conditions"] = [
                {
                    "type": "Failed",
                    "status": "True",
                    "reason": "BackoffLimitExceeded",
                    "message": "Job has reached the specified backoff limit",
                }
            ]
        job["status"] = status
        try:
            self.api.update_status("jobs", job)
        except Exception:
            pass
        if failures <= backoff:
            # Retry: new pod (the kube Job controller would do this).
            try:
                self.api.delete("pods", pod["metadata"]["namespace"], pod["metadata"]["name"])
            except NotFoundError:
                pass
            self._maybe_start_job_pod(job)
