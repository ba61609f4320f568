"""The port's controller against the JAX package's, on twin jobs.

Each scenario of ``tests/test_controller.py`` is driven the same way on
both packages' ``InMemoryAPIServer`` + ``TPUJobController`` (pod phases
set by hand, no processes, one fake clock), once with the TPU twin and
once with its ``h100-<gpus>`` twin of the same worker count. Then every
object on the API server, the job's status, the controller's events and
its job counters must be equal after ``test_torch_builders.normalize``,
which masks exactly the GPU design's keys (named there).
"""

from __future__ import annotations

import copy

import pytest

from tests.test_torch_builders import (
    JAX, LARGE_TWIN, PORT, TWINS, TWIN_IDS, new_job, normalize, side)

pytestmark = pytest.mark.kernel

NOW = 1000.0
RESOURCES = ("tpujobs", "pods", "services", "configmaps", "jobs",
             "podgroups", "secrets")
COUNTERS = ("jobs_created", "jobs_successful", "jobs_failed",
            "spare_promotions")


class Fixture:
    """``tests/test_controller.py``'s fixture, for either package."""

    def __init__(self, pkg: str, accel: str, workers: int, gang: str = ""):
        self.s = side(pkg)
        self.accel, self.workers = accel, workers
        self.time = [NOW]
        self.api = self.s.apiserver.InMemoryAPIServer(clock=lambda: self.time[0])
        self.controller = self.s.controller.TPUJobController(
            self.api, gang_scheduler_name=gang, clock=lambda: self.time[0])
        self.b = self.s.builders
        self.extra: list = []  # what a scenario observed along the way

    def new_job(self, launcher=False, spares=0, **run_policy):
        job = new_job(self.s, self.accel, self.workers, launcher=launcher,
                      name="test-job", spares=spares, **run_policy)
        job.metadata.uid = ""
        return job

    def synced(self, **kw):
        self.controller.start()
        job = self.create(self.new_job(**kw))
        self.sync(job)
        return self.get_job()

    def create(self, job):
        return self.controller.tpujobs.tpujobs("default").create(job)

    def sync(self, job=None):
        self.controller.factory.pump_until_quiet()
        self.controller.sync_handler("default/test-job")
        self.controller.factory.pump_until_quiet()

    def get_job(self):
        return self.controller.tpujobs.tpujobs("default").get("test-job")

    def set_phase(self, name, phase, reason=""):
        pod = self.api.get("pods", "default", name)
        pod["status"] = {"phase": phase}
        if reason:
            pod["status"]["reason"] = reason
        self.api.update_status("pods", pod)

    def set_workers(self, phase, indices=None):
        for i in indices if indices is not None else range(self.workers):
            self.set_phase(f"test-job-worker-{i}", phase)

    def mark_launcher(self, cond, reason="", message=""):
        launcher = self.api.get("jobs", "default", "test-job-launcher")
        launcher["status"] = {"conditions": [{
            "type": cond, "status": "True", "reason": reason,
            "message": message}]}
        if cond == "Complete":
            launcher["status"]["completionTime"] = self.time[0]
        self.api.update_status("jobs", launcher)

    def patch_job(self, fn):
        jd = self.api.get("tpujobs", "default", "test-job")
        fn(jd)
        self.api.update("tpujobs", jd)

    def patch_status(self, conditions):
        jd = self.api.get("tpujobs", "default", "test-job")
        jd["status"]["conditions"] = conditions
        jd["status"]["completionTime"] = NOW
        self.api.update_status("tpujobs", jd)

    def sync_error(self):
        """Sync, returning the error message a refused sync raises."""
        self.controller.factory.pump_until_quiet()
        try:
            self.controller.sync_handler("default/test-job")
        except RuntimeError as e:
            return str(e)
        return None

    def snapshot(self) -> dict:
        c = self.controller
        return {
            "objects": {r: sorted((o["metadata"]["name"], o)
                                  for o in self.api.list(r)) for r in RESOURCES},
            "events": [(e.type, e.reason, e.message) for e in c.recorder.events],
            "counters": {n: getattr(c, n).value() for n in COUNTERS},
            "extra": self.extra,
        }


def _run(pkg, accel, workers, scenario, gang):
    f = Fixture(pkg, accel, workers, gang)
    scenario(f)
    names = {accel: "<accel>",
             f.s.topology.resolve(accel).topology: "<topology>"}
    return normalize(f.snapshot(), names, {})


# -- scenarios (tests/test_controller.py) --------------------------------

def launcherless(f):
    f.synced()
    f.sync()
    f.extra.append([a for a in f.api.actions if a[0] != "get"][-3:])


def with_launcher(f):
    f.synced(launcher=True)


def launcher_succeeded(f):
    f.synced(launcher=True)
    f.mark_launcher("Complete")
    f.sync()


def launcher_failed_with_backoff_enrichment(f):
    f.synced(launcher=True)
    f.api.create("pods", {
        "metadata": {"name": "test-job-launcher-x1", "namespace": "default",
                     "labels": {"job-name": "test-job-launcher"}},
        "status": {"phase": "Failed", "reason": "OOMKilled",
                   "message": "container exceeded memory limit"}})
    f.mark_launcher("Failed", reason="BackoffLimitExceeded", message="Job has failed")
    f.sync()


def running_requires_launcher_and_workers(f):
    f.synced(launcher=True)
    f.set_workers("Running")
    f.sync()
    f.api.create("pods", {
        "metadata": {"name": "test-job-launcher-abc", "namespace": "default",
                     "labels": {"job-name": "test-job-launcher"}},
        "status": {"phase": "Running"}})
    f.sync()


def workers_running_then_succeeded(f):
    f.synced()
    f.set_workers("Running")
    f.sync()
    f.time[0] = NOW + 30
    f.set_workers("Succeeded")
    f.sync()


def worker_failed_job_fails(f):
    f.synced()
    f.set_workers("Running")
    f.sync()
    f.set_phase("test-job-worker-1", "Failed")
    f.sync()


def evicted_worker(f):
    f.synced()
    f.set_phase("test-job-worker-1", "Failed", reason="Evicted")
    f.sync()


def active_deadline_exceeded(f):
    f.synced(active_deadline_seconds=60)
    f.set_workers("Running")
    f.time[0] = NOW + 120
    f.sync()


def backoff_restarts_then_fails(f):
    job = f.new_job(backoff_limit=1)
    job.spec.replica_specs["Worker"].restart_policy = "OnFailure"
    f.controller.start()
    f.sync(f.create(job))
    for _ in range(3):
        f.set_workers("Running")
        f.sync()
        f.set_phase("test-job-worker-0", "Failed")
        f.sync()
        f.sync()


def _cleanup(policy):
    def scenario(f):
        f.synced(clean_pod_policy=policy)
        half = f.workers // 2
        f.set_workers("Succeeded", range(half))
        f.set_workers("Running", range(half, f.workers))
        f.patch_status([{"type": "Succeeded", "status": "True",
                         "reason": "TPUJobSucceeded"}])
        f.sync()
    return scenario


def scale_down(f):
    f.synced()
    small = {LARGE_TWIN[0]: TWINS[1][0], LARGE_TWIN[1]: TWINS[1][1]}[f.accel]

    def shrink(jd):
        jd["spec"]["tpu"] = {"acceleratorType": small}
        jd["spec"]["tpuReplicaSpecs"]["Worker"]["replicas"] = TWINS[1][2]
    f.patch_job(shrink)
    f.sync()


def elastic_stale_world_size(f):
    # Resize to the larger twin while the pod cache misses worker-0: the
    # create -> AlreadyExists read-through restarts the stale pod.
    f.synced()
    large = {TWINS[1][0]: LARGE_TWIN[0], TWINS[1][1]: LARGE_TWIN[1]}[f.accel]

    def grow(jd):
        jd["spec"]["tpu"] = {"acceleratorType": large}
        jd["spec"]["tpuReplicaSpecs"]["Worker"]["replicas"] = LARGE_TWIN[2]
    f.patch_job(grow)
    f.controller.factory.pump_until_quiet()
    del f.controller.pod_informer._cache["default/test-job-worker-0"]
    f.controller.sync_handler("default/test-job")
    f.sync()


def foreign_service_flagged(f):
    f.controller.start()
    f.api.create("services", {"metadata": {"name": "test-job-worker",
                                           "namespace": "default"}})
    f.create(f.new_job())
    f.extra.append(f.sync_error())


def foreign_launcher_flagged(f):
    f.controller.start()
    f.api.create("jobs", {"metadata": {"name": "test-job-launcher",
                                       "namespace": "default"}})
    f.create(f.new_job(launcher=True))
    f.extra.append(f.sync_error())


def suspend_and_resume(f):
    f.synced(launcher=True)
    for suspend, t in ((True, NOW), (True, NOW), (False, NOW + 50)):
        f.time[0] = t
        f.patch_job(lambda jd: jd["spec"].__setitem__(
            "runPolicy", {"suspend": suspend, "cleanPodPolicy": "None"}))
        f.sync()


def gang_podgroup_and_cleanup(f):
    f.synced(launcher=True, clean_pod_policy="All")
    f.patch_status([{"type": "Succeeded", "status": "True",
                     "reason": "TPUJobSucceeded"}])
    f.sync()


def discover_hosts_tracks_running_workers(f):
    f.synced()
    f.set_workers("Running", [0, f.workers - 1])
    f.sync()


def eviction_with_failed_launcher(f):
    f.synced(launcher=True)
    f.set_phase("test-job-worker-1", "Failed", reason="Evicted")
    f.mark_launcher("Failed", reason="BackoffLimitExceeded")
    f.sync()


def succeeded_launcher_with_evicted_worker(f):
    f.synced(launcher=True)
    f.set_phase("test-job-worker-1", "Failed", reason="Evicted")
    f.mark_launcher("Complete")
    f.sync()


def stale_cache_adoption(f):
    # The service and worker-0 exist on the server but not in the cache:
    # adopted mid-sync; a foreign worker-1 is still refused.
    f.controller.start()
    f.create(f.new_job())
    f.controller.factory.pump_until_quiet()
    job = f.get_job()
    f.api.create("services", f.b.new_workers_service(job).to_dict())
    f.api.create("pods", f.b.new_worker(job, 0, "").to_dict())
    f.api.create("pods", {"metadata": {"name": "test-job-worker-1",
                                       "namespace": "default"}})
    try:
        f.controller.sync_handler("default/test-job")
    except RuntimeError as e:
        f.extra.append(str(e))


def configmap_conflict_reads_through(f):
    f.synced()
    stale = copy.deepcopy(f.api.get("configmaps", "default", "test-job-config"))
    f.set_workers("Running")
    cm = f.api.get("configmaps", "default", "test-job-config")
    cm["metadata"]["labels"] = {"touched": "yes"}
    f.api.update("configmaps", cm)
    f.controller.factory.pump_until_quiet()
    f.controller.configmap_informer._cache["default/test-job-config"] = stale
    f.controller.sync_handler("default/test-job")


def validation_rejected(f):
    f.controller.start()
    job = f.new_job()
    job.spec.replica_specs["Worker"].replicas = f.workers + 1
    f.sync(f.create(job))


def _spare_job(f, spares=1):
    job = f.new_job(spares=spares, backoff_limit=2)
    job.spec.replica_specs["Worker"].restart_policy = "OnFailure"
    f.controller.start()
    f.sync(f.create(job))


def _park(f, name, node):
    pod = f.api.get("pods", "default", name)
    pod["spec"]["nodeName"] = node
    f.api.update("pods", pod)
    f.set_phase(name, "Running")
    f.controller.factory.pump_until_quiet()


def spares_promotion_and_backfill(f):
    _spare_job(f, spares=2)
    _park(f, "test-job-spare-0", "node-7")
    f.set_phase("test-job-worker-0", "Failed")
    f.sync()
    f.sync()
    f.extra.append(f.controller.flight_recorder.timeline("default", "test-job"))


def spare_not_ready_and_failed_spare(f):
    _spare_job(f)
    f.set_phase("test-job-worker-1", "Failed")
    f.sync()
    f.set_phase("test-job-spare-0", "Failed")
    f.sync()


def spares_scale_down_and_terminal(f):
    _spare_job(f, spares=2)
    f.patch_job(lambda jd: jd["spec"]["tpu"].__setitem__("hotSpares", 1))
    f.sync()
    f.set_workers("Succeeded")
    f.sync()
    f.sync()


def spares_suspend(f):
    _spare_job(f)
    f.patch_job(lambda jd: jd["spec"].__setitem__(
        "runPolicy", {"suspend": True, "cleanPodPolicy": "None"}))
    f.sync()


SCENARIOS = {
    "launcherless": (launcherless, ""),
    "with_launcher": (with_launcher, ""),
    "launcher_succeeded": (launcher_succeeded, ""),
    "launcher_failed_with_backoff_enrichment": (
        launcher_failed_with_backoff_enrichment, ""),
    "running_requires_launcher_and_workers": (
        running_requires_launcher_and_workers, ""),
    "workers_running_then_succeeded": (workers_running_then_succeeded, ""),
    "worker_failed_job_fails": (worker_failed_job_fails, ""),
    "evicted_worker": (evicted_worker, ""),
    "active_deadline_exceeded": (active_deadline_exceeded, ""),
    "backoff_restarts_then_fails": (backoff_restarts_then_fails, ""),
    "cleanup_all": (_cleanup("All"), ""),
    "cleanup_running": (_cleanup("Running"), ""),
    "cleanup_none": (_cleanup("None"), ""),
    "foreign_service_flagged": (foreign_service_flagged, ""),
    "foreign_launcher_flagged": (foreign_launcher_flagged, ""),
    "suspend_and_resume": (suspend_and_resume, ""),
    "gang_podgroup_and_cleanup": (gang_podgroup_and_cleanup, "volcano"),
    "discover_hosts_tracks_running_workers": (
        discover_hosts_tracks_running_workers, ""),
    "eviction_with_failed_launcher": (eviction_with_failed_launcher, ""),
    "succeeded_launcher_with_evicted_worker": (
        succeeded_launcher_with_evicted_worker, ""),
    "stale_cache_adoption": (stale_cache_adoption, ""),
    "configmap_conflict_reads_through": (configmap_conflict_reads_through, ""),
    "validation_rejected": (validation_rejected, ""),
    "spares_promotion_and_backfill": (spares_promotion_and_backfill, ""),
    "spare_not_ready_and_failed_spare": (spare_not_ready_and_failed_spare, ""),
    "spares_scale_down_and_terminal": (spares_scale_down_and_terminal, ""),
    "spares_suspend": (spares_suspend, "volcano"),
}
# Scenarios that resize need the 4-worker twin (it has a larger twin).
RESIZE = {"scale_down": scale_down, "elastic_stale_world_size": elastic_stale_world_size}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
@pytest.mark.parametrize("tpu,gpu,workers", TWINS, ids=TWIN_IDS)
def test_scenario_matches_the_jax_controller(tpu, gpu, workers, name):
    scenario, gang = SCENARIOS[name]
    want = _run(JAX, tpu, workers, scenario, gang)
    got = _run(PORT, gpu, workers, scenario, gang)
    if name == "validation_rejected":
        # The replica-count message counts GPUs (test_torch_api.py).
        for snap in (want, got):
            snap["events"] = [e[:2] for e in snap["events"]]
    assert got == want
    assert got["objects"]["tpujobs"], "the job must still exist"


@pytest.mark.parametrize("name", sorted(RESIZE))
def test_resize_matches_the_jax_controller(name):
    (tpu, gpu, workers) = TWINS[1]
    big = name == "scale_down"
    if big:
        tpu, gpu, workers = LARGE_TWIN
    want = _run(JAX, tpu, workers, RESIZE[name], "")
    got = _run(PORT, gpu, workers, RESIZE[name], "")
    # The resized job names the other twin's accelerator: mask it too.
    other = {True: TWINS[1][:2], False: LARGE_TWIN[:2]}[big]
    want = normalize(want, {other[0]: "<accel>"}, {})
    got = normalize(got, {other[1]: "<accel>"}, {})
    assert got == want
    pods = {n for n, _ in got["objects"]["pods"]}
    assert len(pods) == (TWINS[1][2] if big else LARGE_TWIN[2])


def test_gpu_job_end_to_end_by_hand():
    """The port alone: an h100-2 job's pods carry the GPU env and
    resource, and all-Succeeded pods give a Succeeded job."""
    f = Fixture(PORT, "h100-2", 2)
    job = f.synced()
    pods = f.api.list("pods")
    assert [p["spec"]["containers"][0]["resources"]["limits"] for p in pods] == [
        {"nvidia.com/gpu": 1}] * 2
    f.set_workers("Running")
    f.sync()
    assert f.s.status.has_condition(f.get_job().status, "Running")
    f.set_workers("Succeeded")
    f.sync()
    job = f.get_job()
    assert f.s.status.is_succeeded(job.status)
    assert job.status.replica_statuses["Worker"].succeeded == 2
