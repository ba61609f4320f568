"""GangScheduler: the in-process kube-scheduler analog.

One scheduling pass (``schedule_once``) runs the classic pipeline per
*gang*, not per pod — a torch.distributed world forms only when every
rank joins, so admission is all-or-nothing:

1. snapshot  — refresh the node cache from the API server and reconcile
   the chip ledger against live pods (leak-proof even across missed
   watch events);
2. group     — pending pods form gangs by their PodGroup annotation;
   a gang is admissible only once ``minMember`` pods exist;
3. filter/score — every member is placed through the plugin pipeline
   against reserved-aware capacity; any infeasible member rolls the
   whole gang's reservations back;
4. preempt   — if placement failed, whole lower-priority gangs are
   tentatively evicted (never individual workers) until the gang fits
   or candidates run out;
5. bind      — reservations commit one pod at a time through the
   ``Binder``; a bind failure releases every uncommitted reservation.

Incomplete gangs wait on a waitlist holding best-effort reservations;
a gang that stays incomplete past ``gang_wait_timeout`` releases its
hold (and re-queues when the missing members appear).
"""

from __future__ import annotations

import threading
import time
from collections import Counter as TallyCounter
from typing import Optional

from ..api.v2beta1 import constants
from ..utils import events as ev
from ..utils import flightrecorder, metrics, profiling
from ..utils.logging import get_logger
from ..runtime import locktrace
from .binder import Binder, BindError
from .cache import NodeInfo, PodKey, SchedulerCache, is_standby_pod, pod_chips
from .plugins import (
    DEFAULT_PLUGINS,
    Plugin,
    SchedulingContext,
    run_filters,
    run_scores,
)

DEFAULT_SCHEDULER_NAME = "tpu-gang-scheduler"
GROUP_ANNOTATION = "scheduling.k8s.io/group-name"

# Priority classes the scheduler understands out of the box; jobs map a
# class onto a gang via their PodGroup's ``priorityClassName``.  Unknown
# classes score 0 (between the built-in low and high bands).
DEFAULT_PRIORITIES: dict[str, int] = {
    "system-critical": 2000,
    "high-priority": 1000,
    "low-priority": -100,
}

def pod_key(pod: dict) -> PodKey:
    meta = pod.get("metadata") or {}
    return (meta.get("namespace", ""), meta.get("name", ""))


def gang_of(pod: dict) -> tuple[str, str]:
    """Gang identity: the PodGroup annotation, else a singleton per pod
    (an unannotated pod is its own gang of one — kube's default-scheduler
    behaviour falls out of the gang machinery for free)."""
    meta = pod.get("metadata") or {}
    group = (meta.get("annotations") or {}).get(GROUP_ANNOTATION, "")
    if group:
        return (meta.get("namespace", ""), group)
    return (meta.get("namespace", ""), f"pod/{meta.get('name', '')}")


class GangScheduler:
    def __init__(
        self,
        api,
        binder=None,
        recorder: Optional[ev.EventRecorder] = None,
        plugins: tuple[Plugin, ...] = DEFAULT_PLUGINS,
        scheduler_name: str = DEFAULT_SCHEDULER_NAME,
        gang_wait_timeout: float = 30.0,
        priorities: Optional[dict[str, int]] = None,
        clock=time.time,
        interval: float = 0.2,
        registry: Optional[metrics.Registry] = None,
        flight_recorder: Optional[flightrecorder.FlightRecorder] = None,
    ):
        self.api = api
        self.log = get_logger("scheduler")
        # Shared with the controller when the operator wires one through:
        # scheduling decisions land on the owning job's timeline.
        self.flight_recorder = flight_recorder
        registry = registry or metrics.Registry()
        self.registry = registry
        self.scheduling_duration = metrics.new_histogram(
            "tpu_operator_scheduler_scheduling_duration_seconds",
            "Time from first sighting of a gang to its last member binding.",
            ("result",),
            registry,
        )
        self.pending_gangs = metrics.new_gauge(
            "tpu_operator_scheduler_pending_gangs",
            "Gangs with pending pods that are not fully bound.",
            (),
            registry,
        )
        self.binds_total = metrics.new_counter(
            "tpu_operator_scheduler_binds_total",
            "Pods bound to nodes by the gang scheduler.",
            (),
            registry,
        )
        self.preemptions_total = metrics.new_counter(
            "tpu_operator_scheduler_preemptions_total",
            "Whole-gang evictions performed to admit a higher-priority gang.",
            (),
            registry,
        )
        self.chips = metrics.new_gauge(
            "tpu_operator_scheduler_chips",
            "GPUs in the scheduler cache by accounting state "
            "(capacity, allocated, reserved, free, standby; standby is a "
            "subset of allocated held by parked hot-spare pods).",
            ("state",),
            registry,
        )
        # Shared with whatever else feeds this registry (the operator
        # wires one registry through controller/manager/scheduler).
        self.profiler = profiling.profiler_for(registry)
        self.binder = (
            binder
            if binder is not None
            else Binder(api, clock=clock, profiler=self.profiler)
        )
        self.recorder = recorder or ev.EventRecorder(
            api, source=scheduler_name, clock=clock
        )
        self.plugins = plugins
        self.scheduler_name = scheduler_name
        self.gang_wait_timeout = gang_wait_timeout
        self.priorities = dict(DEFAULT_PRIORITIES if priorities is None else priorities)
        self.cache = SchedulerCache()
        self._clock = clock
        self._interval = interval
        self._lock = locktrace.rlock("scheduler.core")
        self._first_seen: dict[tuple[str, str], float] = {}
        self._wait_expired: set[tuple[str, str]] = set()
        self._last_failure_msg: dict[tuple[str, str], str] = {}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # The cache is only safe under the scheduling lock; scrapes happen
        # on the metrics server's thread, so the pull-model hook takes the
        # lock for one consistent cut of the chip ledger.
        registry.on_scrape(self._update_chip_gauges)

    def _update_chip_gauges(self) -> None:
        with self._lock:
            totals = {
                "capacity": self.cache.total_capacity(),
                "allocated": self.cache.total_allocated(),
                "reserved": self.cache.total_reserved(),
                "free": self.cache.total_free(),
                "standby": self.cache.total_standby(),
            }
        for state, value in totals.items():
            self.chips.set(value, state)

    # -- lifecycle --------------------------------------------------------

    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, name="gang-scheduler", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    def _loop(self) -> None:
        while not self._stop.is_set():
            try:
                self.schedule_once()
            except Exception as exc:  # the loop must survive transient API races
                self.log.warning(
                    "scheduling pass failed: %s", exc, error=type(exc).__name__
                )
            self._stop.wait(self._interval)

    # -- one pass ---------------------------------------------------------

    def schedule_once(self) -> dict:
        """Run one full scheduling pass; returns a summary for tests."""
        with self._lock:
            return self._schedule_once_locked()

    def _schedule_once_locked(self) -> dict:
        now = self._clock()
        with self.profiler.phase(profiling.PHASE_SCHED_SNAPSHOT):
            self._refresh_nodes()
            all_pods = self.api.list("pods", None)
            self.cache.reconcile(all_pods)
        # Every pass walks the full pod store (the cost the sharded-pass
        # ROADMAP item will attack); make it visible.
        self.profiler.record_scan("scheduler_pods", len(all_pods))

        gangs = self._pending_gangs(all_pods)
        members = self._gang_sizes(all_pods)
        bound_pods = 0
        still_pending = 0
        # Standby (hot-spare) gangs sort behind every live gang of the same
        # priority: spares warm capacity, they must never delay real work.
        order = sorted(
            gangs,
            key=lambda g: (
                -self._gang_priority(g),
                1 if self._is_standby_gang(gangs[g]) else 0,
                self._first_seen.get(g, now),
                g,
            ),
        )
        for gang_key in order:
            pods = gangs[gang_key]
            self._first_seen.setdefault(gang_key, now)
            min_member = self._min_member(gang_key, pods)
            # Completeness counts every live member, bound ones included —
            # a gang mid-recovery from a partial bind is still complete.
            if members.get(gang_key, len(pods)) < min_member:
                self._handle_incomplete(gang_key, pods, min_member, now)
                still_pending += 1
                continue

            assignments, reasons = self._assign(pods)
            if assignments is None:
                assignments = self._preempt(gang_key, pods, all_pods)
            if assignments is None:
                self._mark_unschedulable(gang_key, pods, reasons)
                still_pending += 1
                continue

            if self._bind_gang(gang_key, pods, assignments, now):
                bound_pods += len(assignments)
            else:
                still_pending += 1

        self.pending_gangs.set(still_pending)
        return {"bound": bound_pods, "pending_gangs": still_pending}

    # -- snapshot ---------------------------------------------------------

    def _refresh_nodes(self) -> None:
        live = {
            (n.get("metadata") or {}).get("name", ""): n
            for n in self.api.list("nodes", None)
        }
        self.profiler.record_scan("scheduler_nodes", len(live))
        for name in [n for n in self.cache.nodes if n not in live]:
            self.cache.remove_node(name)
        for name, node in live.items():
            self.cache.add_node(NodeInfo.from_node_object(node))

    def _wants(self, pod: dict) -> bool:
        spec = pod.get("spec") or {}
        if spec.get("nodeName"):
            return False
        if (pod.get("status") or {}).get("phase") in ("Succeeded", "Failed"):
            return False
        if (pod.get("metadata") or {}).get("deletionTimestamp"):
            return False
        return spec.get("schedulerName", "") in ("", self.scheduler_name)

    @staticmethod
    def _is_standby_gang(pods: list[dict]) -> bool:
        """A gang made entirely of parked hot-spare pods (the controller
        puts spares in their own PodGroup, so mixed gangs don't occur)."""
        return bool(pods) and all(is_standby_pod(p) for p in pods)

    def _gang_sizes(self, all_pods: list[dict]) -> dict[tuple[str, str], int]:
        """Live member count per gang, bound members included."""
        sizes: dict[tuple[str, str], int] = {}
        for pod in all_pods:
            spec = pod.get("spec") or {}
            if (pod.get("status") or {}).get("phase") in ("Succeeded", "Failed"):
                continue
            if (pod.get("metadata") or {}).get("deletionTimestamp"):
                continue
            if spec.get("schedulerName", "") not in ("", self.scheduler_name):
                continue
            key = gang_of(pod)
            sizes[key] = sizes.get(key, 0) + 1
        return sizes

    def _pending_gangs(self, all_pods: list[dict]) -> dict[tuple[str, str], list[dict]]:
        gangs: dict[tuple[str, str], list[dict]] = {}
        for pod in all_pods:
            if self._wants(pod):
                gangs.setdefault(gang_of(pod), []).append(pod)
        for pods in gangs.values():
            pods.sort(key=lambda p: (p.get("metadata") or {}).get("name", ""))
        # Drop bookkeeping for gangs that vanished or fully bound.
        for table in (self._first_seen, self._last_failure_msg):
            for key in [k for k in table if k not in gangs]:
                del table[key]
        self._wait_expired &= set(gangs)
        return gangs

    def _podgroup(self, gang_key: tuple[str, str]) -> Optional[dict]:
        from ..runtime.apiserver import NotFoundError

        namespace, name = gang_key
        if name.startswith("pod/"):
            return None
        try:
            return self.api.get("podgroups", namespace, name)
        except NotFoundError:
            return None

    def _min_member(self, gang_key: tuple[str, str], pods: list[dict]) -> int:
        group = self._podgroup(gang_key)
        if group is None:
            return len(pods)
        try:
            return int((group.get("spec") or {}).get("minMember", len(pods)))
        except (TypeError, ValueError):
            return len(pods)

    def _gang_priority(self, gang_key: tuple[str, str]) -> int:
        group = self._podgroup(gang_key)
        if group is None:
            return 0
        cls = (group.get("spec") or {}).get("priorityClassName", "")
        return self.priorities.get(cls, 0)

    def _record_scheduling(
        self, pods: list[dict], reason: str, message: str = "", **attrs
    ) -> None:
        """Flight-recorder hook: one SCHEDULING entry per owning TPUJob
        (gang members all carry the same job-name label)."""
        if self.flight_recorder is None:
            return
        seen: set[tuple[str, str]] = set()
        for pod in pods:
            meta = pod.get("metadata") or {}
            job = (meta.get("labels") or {}).get(constants.JOB_NAME_LABEL)
            if not job:
                continue
            key = (meta.get("namespace", ""), job)
            if key in seen:
                continue
            seen.add(key)
            self.flight_recorder.record(
                key[0],
                key[1],
                flightrecorder.SCHEDULING,
                reason=reason,
                message=message,
                **attrs,
            )

    # -- placement --------------------------------------------------------

    def _assign(
        self, pods: list[dict]
    ) -> tuple[Optional[dict[PodKey, str]], TallyCounter]:
        """Reserve a node for every member, or roll back and report why
        the first unplaceable member failed on each node."""
        with self.profiler.phase(profiling.PHASE_SCHED_RESERVE):
            return self._assign_locked(pods)

    def _assign_locked(
        self, pods: list[dict]
    ) -> tuple[Optional[dict[PodKey, str]], TallyCounter]:
        gang_key = gang_of(pods[0])
        ctx = SchedulingContext(
            gang_name=gang_key[1],
            remaining_chips=sum(pod_chips(p) for p in pods),
        )
        slice_names = {n.slice_name for n in self.cache.nodes.values() if n.slice_name}
        ctx.slice_free = {s: self.cache.slice_free(s) for s in slice_names}

        assignments: dict[PodKey, str] = {}
        for pod in pods:
            reasons: TallyCounter = TallyCounter()
            feasible: list[NodeInfo] = []
            for node in sorted(self.cache.nodes.values(), key=lambda n: n.name):
                reason = run_filters(self.plugins, ctx, pod, node)
                if reason is None:
                    feasible.append(node)
                else:
                    reasons[reason] += 1
            if not feasible:
                for key in assignments:
                    self.cache.release(key)
                return None, reasons
            # max() keeps the first maximum, so the name sort above makes
            # ties deterministic.
            best = max(feasible, key=lambda n: run_scores(self.plugins, ctx, pod, n))
            key = pod_key(pod)
            chips = pod_chips(pod)
            self.cache.reserve(key, best.name, chips)
            assignments[key] = best.name
            ctx.remaining_chips -= chips
            if best.slice_name:
                ctx.slice_free[best.slice_name] -= chips
                if not ctx.chosen_slice:
                    ctx.chosen_slice = best.slice_name
        return assignments, TallyCounter()

    # -- preemption -------------------------------------------------------

    def _preempt(
        self,
        gang_key: tuple[str, str],
        pods: list[dict],
        all_pods: list[dict],
    ) -> Optional[dict[PodKey, str]]:
        """Evict whole lower-priority gangs (cheapest first) until this
        gang fits; never evicts individual workers — a decapitated TPU
        gang is pure waste."""
        my_priority = self._gang_priority(gang_key)
        victims: dict[tuple[str, str], list[dict]] = {}
        for pod in all_pods:
            if not (pod.get("spec") or {}).get("nodeName"):
                continue
            if (pod.get("status") or {}).get("phase") in ("Succeeded", "Failed"):
                continue
            vkey = gang_of(pod)
            if vkey != gang_key:
                victims.setdefault(vkey, []).append(pod)
        # Victim order: cheapest priority first, and within a priority band
        # standby gangs go before live gangs — evicting parked spares costs
        # zero training progress.
        candidates = sorted(
            (
                (self._gang_priority(vk), vk, vpods)
                for vk, vpods in victims.items()
                if self._gang_priority(vk) < my_priority
            ),
            key=lambda t: (t[0], 0 if self._is_standby_gang(t[2]) else 1, t[1]),
        )
        if not candidates:
            return None

        released: list[tuple[PodKey, tuple[str, int]]] = []
        evicting: list[tuple[tuple[str, str], list[dict]]] = []
        assignments: Optional[dict[PodKey, str]] = None
        for _, vkey, vpods in candidates:
            for vpod in vpods:
                token = self.cache.release_bound(pod_key(vpod))
                if token is not None:
                    released.append((pod_key(vpod), token))
            evicting.append((vkey, vpods))
            assignments, _ = self._assign(pods)
            if assignments is not None:
                break
        if assignments is None:
            for key, (node_name, chips) in released:
                self.cache.charge_bound(key, node_name, chips)
            return None

        from ..runtime.apiserver import NotFoundError

        for vkey, vpods in evicting:
            for vpod in vpods:
                ns, name = pod_key(vpod)
                self.recorder.eventf(
                    vpod,
                    ev.EVENT_TYPE_WARNING,
                    ev.PREEMPTED_REASON,
                    "Preempted by %s/%s (gang priority %d)",
                    gang_key[0],
                    gang_key[1],
                    my_priority,
                )
                try:
                    self.api.delete("pods", ns, name)
                except NotFoundError:
                    pass
            self.preemptions_total.inc()
            self.log.warning(
                "preempted gang %s/%s for %s/%s", vkey[0], vkey[1],
                gang_key[0], gang_key[1],
            )
            self._record_scheduling(
                vpods,
                ev.PREEMPTED_REASON,
                f"preempted by {gang_key[0]}/{gang_key[1]}",
                by=f"{gang_key[0]}/{gang_key[1]}",
            )
        return assignments

    # -- outcomes ---------------------------------------------------------

    def _bind_gang(
        self,
        gang_key: tuple[str, str],
        pods: list[dict],
        assignments: dict[PodKey, str],
        now: float,
    ) -> bool:
        committed: set[PodKey] = set()
        for key, node_name in assignments.items():
            namespace, name = key
            try:
                bound = self.binder.bind(namespace, name, node_name)
            except BindError as exc:
                # All-or-nothing rollback: every uncommitted reservation is
                # released immediately.  Members already bound stay bound
                # (they hold real API state); the next pass re-admits the
                # gang and binds only the remainder.
                for other in assignments:
                    if other not in committed:
                        self.cache.release(other)
                self.recorder.eventf(
                    {"kind": "Pod", "metadata": {"name": name, "namespace": namespace}},
                    ev.EVENT_TYPE_WARNING,
                    ev.FAILED_SCHEDULING_REASON,
                    "binding rejected: %s",
                    exc,
                )
                return False
            self.cache.commit(key)
            committed.add(key)
            self.binds_total.inc()
            self.recorder.eventf(
                bound,
                ev.EVENT_TYPE_NORMAL,
                ev.SCHEDULED_REASON,
                "Successfully assigned %s/%s to %s",
                namespace,
                name,
                node_name,
            )
        first_seen = self._first_seen.pop(gang_key, now)
        self._wait_expired.discard(gang_key)
        self._last_failure_msg.pop(gang_key, None)
        self.scheduling_duration.observe(max(0.0, now - first_seen), "scheduled")
        nodes = sorted(set(assignments.values()))
        self.log.info(
            "bound gang %s/%s (%d pods)", gang_key[0], gang_key[1],
            len(assignments), nodes=",".join(nodes),
        )
        self._record_scheduling(
            pods,
            ev.SCHEDULED_REASON,
            f"gang {gang_key[1]} bound to {', '.join(nodes)}",
            pod_count=len(assignments),
            wait_seconds=round(max(0.0, now - first_seen), 6),
        )
        return True

    def _handle_incomplete(
        self,
        gang_key: tuple[str, str],
        pods: list[dict],
        min_member: int,
        now: float,
    ) -> None:
        """Waitlist: hold best-effort reservations for the members that
        exist, release them when the wait times out."""
        deadline = self._first_seen[gang_key] + self.gang_wait_timeout
        if now >= deadline:
            if gang_key not in self._wait_expired:
                self._wait_expired.add(gang_key)
                for pod in pods:
                    self.cache.release(pod_key(pod))
                    self.recorder.eventf(
                        pod,
                        ev.EVENT_TYPE_WARNING,
                        ev.FAILED_SCHEDULING_REASON,
                        "gang %s waited %.0fs with %d/%d members; releasing "
                        "reserved capacity",
                        gang_key[1],
                        self.gang_wait_timeout,
                        len(pods),
                        min_member,
                    )
            return
        # Best-effort hold (reservations survive passes via reconcile).
        self._assign(pods)

    def _mark_unschedulable(
        self,
        gang_key: tuple[str, str],
        pods: list[dict],
        reasons: TallyCounter,
    ) -> None:
        message = ev.format_failed_scheduling(len(self.cache.nodes), reasons)
        first_report = self._last_failure_msg.get(gang_key) != message
        self._last_failure_msg[gang_key] = message
        for pod in pods:
            namespace, name = pod_key(pod)
            self.binder.mark_unschedulable(namespace, name, message)
            if first_report:
                self.recorder.event(
                    pod, ev.EVENT_TYPE_WARNING, ev.FAILED_SCHEDULING_REASON, message
                )
        if first_report:
            self.log.warning(
                "gang %s/%s unschedulable: %s", gang_key[0], gang_key[1], message
            )
            self._record_scheduling(pods, ev.FAILED_SCHEDULING_REASON, message)
