"""The port's gang scheduler: 8-GPU nodes, all-or-nothing gangs of
one-GPU pods, whole-gang preemption, packing onto the fewest nodes, and
bind decisions equal to the JAX scheduler's on twin clusters.

A twin cluster gives each slice the same worker capacity on both sides:
``v5e-16:2`` (2 slices of 4 four-chip hosts) against ``h100-4:2`` (2
slices of one 4-GPU node), ``v5p-8:2`` against ``h100-2:2``. Node names
and counts differ by design (one Node per TPU host, one per GPU server),
so a bind decision is compared as the slice it landed on; and the
``FailedScheduling`` message, which counts nodes and names the resource,
is masked (``NODES_AVAILABLE``) and checked on the port alone.
"""

from __future__ import annotations

import re

import pytest

from tests.test_torch_builders import JAX, PORT, TWINS, TWIN_IDS, new_job, normalize, side

pytestmark = pytest.mark.kernel

NOW = 1000.0
NODES_AVAILABLE = re.compile(r"\d+/\d+ nodes are available: [^\n]*")


class Cluster:
    """API server + controller + scheduler on one clock, no pod runner
    (``tests/test_scheduler.py``'s fixture, for either package)."""

    def __init__(self, pkg: str, inventory: str, accel: str, workers: int):
        self.s = side(pkg)
        self.accel, self.workers = accel, workers
        self.time = [NOW]
        clock = lambda: self.time[0]  # noqa: E731
        self.api = self.s.apiserver.InMemoryAPIServer(clock=clock)
        sched = self.s.scheduler
        self.nodes = sched.register_nodes(self.api, inventory)
        self.controller = self.s.controller.TPUJobController(
            self.api, gang_scheduler_name=sched.DEFAULT_SCHEDULER_NAME,
            clock=clock)
        self.scheduler = sched.GangScheduler(self.api, clock=clock)
        self.controller.start()
        self.outs: list = []

    def submit(self, name, priority_class="", accel=None, workers=None):
        job = new_job(self.s, accel or self.accel, workers or self.workers,
                      name=name)
        job.metadata.uid = ""
        if priority_class:
            job.spec.run_policy.scheduling_policy = self.s.api.SchedulingPolicy(
                priority_class=priority_class)
        self.controller.tpujobs.tpujobs("default").create(job)
        self.sync(name)

    def sync(self, name):
        self.controller.factory.pump_until_quiet()
        self.controller.sync_handler(f"default/{name}")
        self.controller.factory.pump_until_quiet()

    def schedule(self):
        out = self.scheduler.schedule_once()
        self.outs.append(out)
        return out

    def pods(self, job):
        return sorted((p for p in self.api.list("pods", "default")
                       if p["metadata"]["name"].startswith(job + "-worker-")),
                      key=lambda p: p["metadata"]["name"])

    def finish(self, job):
        for pod in self.pods(job):
            pod["status"]["phase"] = "Succeeded"
            self.api.update_status("pods", pod)

    def slice_of(self, node_name):
        labels = {n["metadata"]["name"]: n["metadata"]["labels"]
                  for n in self.nodes}[node_name]
        return labels[self.s.scheduler.inventory.LABEL_SLICE]

    def decisions(self, jobs) -> dict:
        """Per pod: the slice it is bound to and its scheduling condition;
        per job: its Scheduled condition; the events; the pass results."""
        out = {"pods": {}, "jobs": {}, "outs": self.outs,
               "preemptions": self.scheduler.preemptions_total.value()}
        for job in jobs:
            for pod in self.pods(job):
                node = pod["spec"].get("nodeName")
                conds = [(c["type"], c["status"], c.get("reason", ""),
                          NODES_AVAILABLE.sub("<nodes available>",
                                              c.get("message", "")))
                         for c in (pod.get("status") or {}).get("conditions") or []]
                out["pods"][pod["metadata"]["name"]] = (
                    self.slice_of(node) if node else None, conds)
            self.sync(job)
            try:
                status = self.controller.tpujobs.tpujobs("default").get(job).status
            except self.s.apiserver.NotFoundError:
                continue
            cond = self.s.status.get_condition(status, "Scheduled")
            out["jobs"][job] = cond and (cond.status, cond.reason,
                                         NODES_AVAILABLE.sub("<nodes available>",
                                                             cond.message))
        out["events"] = sorted(
            (e.type, e.reason, getattr(e, "involved_name", ""))
            for rec in (self.controller.recorder, self.scheduler.recorder)
            for e in rec.events)
        return normalize(out, {self.accel: "<accel>"}, {})


def queue_behind_a_full_cluster(c):
    for name in ("a", "b", "c"):
        c.submit(name)
        c.schedule()
    c.finish("a")
    c.schedule()
    return ["a", "b", "c"]


def whole_gang_preemption(c):
    c.submit("low1", "low-priority")
    c.submit("low2", "low-priority")
    c.schedule()
    c.submit("high", "high-priority")
    c.schedule()
    return ["low1", "low2", "high"]


def equal_priority_never_preempts(c):
    c.submit("a", "high-priority")
    c.submit("b", "high-priority")
    c.schedule()
    c.submit("c", "high-priority")
    c.schedule()
    return ["a", "b", "c"]


SCENARIOS = {
    "queue_behind_a_full_cluster": queue_behind_a_full_cluster,
    "whole_gang_preemption": whole_gang_preemption,
    "equal_priority_never_preempts": equal_priority_never_preempts,
}
TWIN_CLUSTERS = {"v5e-16": ("v5e-16:2", "h100-4:2"),
                 "v5p-8": ("v5p-8:2", "h100-2:2")}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
@pytest.mark.parametrize("tpu,gpu,workers", TWINS, ids=TWIN_IDS)
def test_bind_decisions_match_the_jax_scheduler(tpu, gpu, workers, name):
    jinv, ginv = TWIN_CLUSTERS[tpu]
    got = {}
    for pkg, inv, accel in ((JAX, jinv, tpu), (PORT, ginv, gpu)):
        c = Cluster(pkg, inv, accel, workers)
        jobs = SCENARIOS[name](c)
        got[pkg] = c.decisions(jobs)
    assert got[PORT] == got[JAX]
    assert any(slice_ for slice_, _ in got[PORT]["pods"].values())


def test_h100_8_inventory_makes_two_8_gpu_nodes():
    sched = side(PORT).scheduler
    nodes = sched.build_nodes("h100-8:2")
    assert [n["metadata"]["name"] for n in nodes] == [
        "gpu-h100-8-s0-h0", "gpu-h100-8-s1-h0"]
    for i, n in enumerate(nodes):
        assert n["status"]["capacity"] == {"nvidia.com/gpu": 8}
        labels = n["metadata"]["labels"]
        assert labels[sched.inventory.LABEL_GENERATION] == "h100"
        assert labels[sched.inventory.LABEL_SLICE] == f"h100-8-{i}"
    assert [n["metadata"]["name"] for n in sched.build_nodes("h100-16")] == [
        "gpu-h100-16-s0-h0", "gpu-h100-16-s0-h1"]
    with pytest.raises(sched.InventoryError):
        sched.parse_inventory("v5e-16:2")


def _bound_nodes(c, job):
    return [p["spec"].get("nodeName") for p in c.pods(job)]


def test_16_pod_gang_packs_8_and_8_all_or_nothing():
    c = Cluster(PORT, "h100-8:2", "h100-16", 16)
    c.submit("big")
    assert c.schedule()["bound"] == 16
    nodes = _bound_nodes(c, "big")
    assert sorted(nodes.count(n) for n in set(nodes)) == [8, 8]
    cache = c.scheduler.cache
    assert (cache.total_allocated(), cache.total_reserved(),
            cache.total_free()) == (16, 0, 0)


def test_17_pod_gang_stays_pending_with_insufficient_gpu():
    s = side(PORT)
    api = s.apiserver.InMemoryAPIServer()
    s.scheduler.register_nodes(api, "h100-8:2")
    api.create("podgroups", {
        "apiVersion": "scheduling.x-k8s.io/v1alpha1", "kind": "PodGroup",
        "metadata": {"name": "g", "namespace": "default"},
        "spec": {"minMember": 17}})
    for i in range(17):
        api.create("pods", {
            "apiVersion": "v1", "kind": "Pod",
            "metadata": {"name": f"w-{i}", "namespace": "default",
                         "annotations": {s.scheduler.GROUP_ANNOTATION: "g"}},
            "spec": {"schedulerName": s.scheduler.DEFAULT_SCHEDULER_NAME,
                     "containers": [{
                         "resources": {"requests": {"nvidia.com/gpu": 1}},
                         "env": [{"name": "TPU_ACCELERATOR_TYPE",
                                  "value": "h100-16"}]}]}})
    sched = s.scheduler.GangScheduler(api)
    assert sched.schedule_once() == {"bound": 0, "pending_gangs": 1}
    for i in range(17):
        pod = api.get("pods", "default", f"w-{i}")
        assert "nodeName" not in pod["spec"]
        (cond,) = pod["status"]["conditions"]
        assert cond["reason"] == "Unschedulable"
        assert "Insufficient nvidia.com/gpu" in cond["message"]
    assert sched.cache.total_reserved() == 0
    assert sched.cache.total_allocated() == 0


def test_whole_gang_preemption_on_gpu_nodes():
    c = Cluster(PORT, "h100-8:2", "h100-16", 16)
    c.submit("low", "low-priority")
    assert c.schedule()["bound"] == 16
    c.submit("high", "high-priority", accel="h100-8", workers=8)
    assert c.schedule()["bound"] == 8
    assert c.pods("low") == []
    assert len(set(_bound_nodes(c, "high"))) == 1
    preempted = sorted(e.involved_name for e in c.scheduler.recorder.events
                       if e.reason == "Preempted")
    assert preempted == sorted(f"low-worker-{i}" for i in range(16))
    assert c.scheduler.preemptions_total.value() == 1


@pytest.mark.parametrize("inventory,first_node", [
    ("h100-8:2", "gpu-h100-8-s0-h0"), ("h100-16", "gpu-h100-16-s0-h0")])
def test_topology_pack_uses_the_fewest_8_gpu_nodes(inventory, first_node):
    c = Cluster(PORT, inventory, "h100-8", 8)
    c.submit("a")
    c.schedule()
    assert set(_bound_nodes(c, "a")) == {first_node}
    # A second gang of 2 then 6 more GPUs fill the other node whole.
    c.submit("b", accel="h100-2", workers=2)
    c.submit("c", accel="h100-4", workers=4)
    c.schedule()
    b, cc = set(_bound_nodes(c, "b")), set(_bound_nodes(c, "c"))
    assert len(b) == 1 and b == cc and first_node not in b


def test_topology_pack_plugin_scores_by_node_index():
    s = side(PORT).scheduler
    ctx = s.SchedulingContext(gang_name="g", remaining_chips=8,
                              slice_free={"h100-16-0": 16})
    n0 = s.NodeInfo(name="n0", capacity=8, slice_name="h100-16-0", host_index=0)
    n1 = s.NodeInfo(name="n1", capacity=8, slice_name="h100-16-0", host_index=1)
    plugin = s.TopologyPackPlugin()
    assert plugin.score(ctx, {}, n0) > plugin.score(ctx, {}, n1)
    cap = s.GPUCapacityPlugin()
    pod = {"spec": {"containers": [{
        "resources": {"requests": {"nvidia.com/gpu": 1}},
        "env": [{"name": "TPU_ACCELERATOR_TYPE", "value": "h100-8"}]}]}}
    full = s.NodeInfo(name="f", capacity=8, allocated=8, generation="h100")
    assert cap.filter(ctx, pod, full) == "Insufficient nvidia.com/gpu"
    assert cap.filter(ctx, pod, n0) is None
    other = s.NodeInfo(name="o", capacity=8, generation="b200")
    assert cap.filter(ctx, pod, other) == "node(s) had mismatched GPU generation"
