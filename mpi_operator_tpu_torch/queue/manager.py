"""The QueueManager: suspend-based admission of TPUJobs against
ClusterQueue GPU quotas (the port's copy of
``mpi_operator_tpu/queue/manager.py``). A job's footprint is read from
the port's topology, ``(generation, gpus)`` of its ``h100-<gpus>``
acceleratorType, and every admit, pending and evict message names
``nvidia.com/gpu``; the decisions, conditions, events and the
``tpu_operator_queue_*`` metric names are the JAX package's.

In-process Kueue analog.  The reference operator's production story gates
MPIJobs behind sigs.k8s.io/kueue: jobs are created suspended, Kueue
reserves quota in a ClusterQueue and unsuspends them, and evicts (re-
suspends) borrowers when a lender reclaims.  This controller runs the
same handshake against the in-memory apiserver:

- A TPUJob opts in by naming a LocalQueue in
  ``spec.runPolicy.schedulingPolicy.queue``.  The LocalQueue (in the
  job's namespace) binds to a ClusterQueue, whose per-generation GPU
  quota the job's footprint (api/topology.py GPUs x numSlices) is
  charged against.
- While enabled, the QueueManager is the **single writer** of
  ``runPolicy.suspend`` (lint-enforced): queue-targeted jobs are forced
  suspended until admitted, admitted by flipping ``suspend=false`` plus
  a ``QuotaReserved=True`` condition, and evicted by re-suspending.
- Admission order is priority-then-FIFO per ClusterQueue, strict: the
  first workload that does not fit blocks the ones behind it (no
  out-of-order admission), and is requeued with backoff carrying the
  kube-style "insufficient quota in ClusterQueue x: ..." message.
- Cohort borrowing: a queue may exceed its nominal quota using cohort
  peers' unused GPUs (capped by ``borrowingLimit``).  When a lender's
  pending workload fits within its *nominal* quota but not in current
  free GPUs, and the lender declares
  ``preemption.reclaimWithinCohort: Any``, the youngest borrowing
  workloads are evicted until it fits.

Every sync runs a **global admission pass** rebuilt from apiserver truth
(not informer caches — the manager's own synchronous writes make the
API the only non-stale source); the informers merely trigger the
workqueue, mirroring the gang scheduler's fresh-list discipline
(scheduler/core.py).
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

from ..api import topology
from ..api.v2beta1.queue_types import (
    RECLAIM_ANY,
    ClusterQueue,
    LocalQueue,
)
from ..api.v2beta1.types import (
    JOB_QUEUE_NOT_FOUND,
    JOB_QUOTA_RESERVED,
    TPUJob,
)
from ..controller import status as st
from ..runtime import locktrace, retry
from ..runtime.apiserver import (
    AlreadyExistsError,
    ConflictError,
    InMemoryAPIServer,
    NotFoundError,
)
from ..runtime.client import TPUJobClient
from ..runtime.informer import EventHandler, InformerFactory, meta_namespace_key
from ..runtime.workqueue import RateLimitingQueue
from ..scheduler.core import DEFAULT_PRIORITIES
from ..utils import flightrecorder, metrics, profiling
from ..utils import logging as logutil
from ..utils.events import EVENT_TYPE_NORMAL, EVENT_TYPE_WARNING, EventRecorder
from .quota import (
    GPU_RESOURCE,
    Charge,
    JobKey,
    QueueQuota,
    QuotaLedger,
    insufficient_quota_message,
)

# Condition reasons (Kueue Workload-condition vocabulary).
ADMITTED_REASON = "Admitted"
PENDING_REASON = "Pending"
EVICTED_REASON = "Evicted"
QUOTA_RELEASED_REASON = "QuotaReleased"
QUEUE_NOT_FOUND_REASON = "QueueNotFound"
QUEUE_FOUND_REASON = "QueueFound"
SUSPENDED_BY_QUEUE_REASON = "SuspendedByQueue"

# Workqueue sentinel for "run a pass, no specific job" (queue events,
# the periodic resync ticker).
PERIODIC_KEY = "@queue-resync"


def job_queue_name(job: TPUJob) -> str:
    sp = job.spec.run_policy.scheduling_policy
    return sp.queue if sp is not None else ""


def is_admitted(job: TPUJob) -> bool:
    """QuotaReserved=True — the job holds GPUs until finished/evicted."""
    return st.has_condition(job.status, JOB_QUOTA_RESERVED)


class QueueManager:
    """Admits queue-targeted TPUJobs by flipping ``suspend`` (Kueue's
    scheduler + workload controller collapsed into one sync loop)."""

    def __init__(
        self,
        api: InMemoryAPIServer,
        *,
        recorder: Optional[EventRecorder] = None,
        registry: Optional[metrics.Registry] = None,
        flight_recorder: Optional[flightrecorder.FlightRecorder] = None,
        priorities: Optional[Dict[str, int]] = None,
        clock: Callable[[], float] = time.time,
        resync_interval: float = 1.0,
    ):
        self.api = api
        self.tpujobs = TPUJobClient(api)
        self.clock = clock
        self.log = logutil.get_logger("queue-manager")
        self._lock = locktrace.rlock("queue.manager")
        self._resync_interval = resync_interval
        self._priorities = dict(DEFAULT_PRIORITIES if priorities is None else priorities)

        registry = registry or metrics.Registry()
        self.registry = registry
        # "is None", not "or": an empty FlightRecorder is falsy (__len__).
        self.flight_recorder = (
            flightrecorder.FlightRecorder(clock=clock)
            if flight_recorder is None
            else flight_recorder
        )
        if recorder is None:
            recorder = EventRecorder(api, source="tpu-queue-manager", clock=clock)
            # A shared recorder is usually already feeding the flight
            # recorder (controller wiring); only a private one needs it.
            recorder.subscribe(self.flight_recorder.observe_event)
        self.recorder = recorder

        self.pending_workloads = metrics.new_gauge(
            "tpu_operator_queue_pending_workloads",
            "Queue-targeted TPUJobs waiting for quota, per ClusterQueue",
            ("cluster_queue",),
            registry,
        )
        self.admitted_workloads = metrics.new_gauge(
            "tpu_operator_queue_admitted_workloads",
            "TPUJobs currently holding quota, per ClusterQueue",
            ("cluster_queue",),
            registry,
        )
        self.admission_duration = metrics.new_histogram(
            "tpu_operator_queue_admission_duration_seconds",
            "Time from TPUJob creation to quota reservation",
            ("cluster_queue",),
            registry,
        )
        self.evictions = metrics.new_counter(
            "tpu_operator_queue_evictions_total",
            "Workloads evicted so a lender could reclaim cohort quota",
            ("cluster_queue",),
            registry,
        )
        registry.on_scrape(self._refresh_gauges)

        # Shared per-registry profiler (profiler_for dedups with the
        # controller when both run against one registry): the admission
        # pass is one timed phase, and its three full-store lists are
        # scan-accounted under the "queue_admit" scope.
        self.profiler = profiling.profiler_for(registry)

        self.ledger = QuotaLedger()
        # Last-pass snapshots behind _lock: gauge values per queue and the
        # set of still-pending job keys (drives backoff requeues).
        self._pending_counts: Dict[str, int] = {}
        self._admitted_counts: Dict[str, int] = {}
        self._pending_keys: set[str] = set()
        # Failure-message dedup (scheduler _last_failure_msg pattern): an
        # unchanged "insufficient quota" verdict on resync is not news.
        self._last_failure_msg: Dict[str, str] = {}

        # Informers are *triggers* only — the pass lists from the API.
        self.factory = InformerFactory(api, namespace="", profiler=self.profiler)
        self.tpujob_informer = self.factory.informer("tpujobs")
        self.clusterqueue_informer = self.factory.informer("clusterqueues")
        self.localqueue_informer = self.factory.informer("localqueues")

        self.queue = RateLimitingQueue(name="QueueManager", registry=registry)

        self.tpujob_informer.add_event_handler(
            EventHandler(
                on_add=self._enqueue_job,
                on_update=lambda old, new: self._enqueue_job(new),
                on_delete=self._enqueue_job,
            )
        )
        queues_changed = EventHandler(
            on_add=lambda obj: self.queue.add(PERIODIC_KEY),
            on_update=lambda old, new: self.queue.add(PERIODIC_KEY),
            on_delete=lambda obj: self.queue.add(PERIODIC_KEY),
        )
        self.clusterqueue_informer.add_event_handler(queues_changed)
        self.localqueue_informer.add_event_handler(queues_changed)

    # ------------------------------------------------------------------
    # Queue plumbing
    # ------------------------------------------------------------------

    def _enqueue_job(self, obj: dict) -> None:
        sp = (((obj.get("spec") or {}).get("runPolicy") or {})
              .get("schedulingPolicy") or {})
        if not sp.get("queue"):
            return  # not queue-managed; the plain controller owns it
        self.queue.add(meta_namespace_key(obj))

    def start(self) -> None:
        self.factory.start_all()

    def run(self, threadiness: int = 1, stop: Optional[threading.Event] = None) -> None:
        """Blocking run loop (controller.run analog) plus a resync ticker
        so reclaim opportunities surface even without watch events."""
        stop = stop or threading.Event()
        if self.queue.is_shutdown:
            self.queue.reset()
        self.start()

        def pump_loop():
            while not stop.is_set():
                if self.factory.pump_all() == 0:
                    retry.sleep(0.005)

        def tick_loop():
            while not stop.is_set():
                self.queue.add(PERIODIC_KEY)
                stop.wait(self._resync_interval)

        threads = [
            threading.Thread(target=pump_loop, daemon=True),
            threading.Thread(target=tick_loop, daemon=True),
        ]
        for _ in range(threadiness):
            threads.append(
                threading.Thread(target=self._worker_loop, args=(stop,), daemon=True)
            )
        for t in threads:
            t.start()
        stop.wait()
        self.queue.shutdown()
        for t in threads[2:]:
            t.join(timeout=5)
        self.factory.stop_all()

    def _worker_loop(self, stop: threading.Event) -> None:
        while not stop.is_set() and self.process_next_work_item():
            pass

    def process_next_work_item(self) -> bool:
        key, shutdown = self.queue.get()
        if shutdown:
            return False
        try:
            still_pending = self.sync_handler(key)
        except Exception as e:
            self.queue.add_rate_limited(key)
            self.log.warning(
                "error in admission pass for %r: %s", key, e,
                error=type(e).__name__,
            )
        else:
            if still_pending:
                # Inadmissible: back off, but keep retrying — quota frees
                # up without necessarily producing an event for *this* key.
                self.queue.add_rate_limited(key)
            else:
                self.queue.forget(key)
        finally:
            self.queue.done(key)
        return True

    def sync_pending(self, max_rounds: int = 50) -> None:
        """Test/synchronous convenience: pump informers and drain the
        *immediate* queue.  Unlike the controller's version this does NOT
        wait out delayed (backed-off) items — a permanently inadmissible
        job would never quiesce; transitions re-enqueue via watch events."""
        for _ in range(max_rounds):
            self.factory.pump_until_quiet()
            key, _ = self.queue.get(timeout=0.05)
            if key is None:
                return
            try:
                if self.sync_handler(key):
                    self.queue.add_rate_limited(key)
                else:
                    self.queue.forget(key)
            finally:
                self.queue.done(key)
        raise RuntimeError("queue manager did not quiesce")

    def sync_handler(self, key: str) -> bool:
        """Run the global admission pass; returns whether ``key`` names a
        workload still waiting for quota (requeue-with-backoff signal)."""
        self._admit_pass()
        if key == PERIODIC_KEY:
            return False
        with self._lock:
            return key in self._pending_keys

    # ------------------------------------------------------------------
    # The admission pass
    # ------------------------------------------------------------------

    def _admit_pass(self) -> None:
        with self.profiler.phase(profiling.PHASE_QUEUE_ADMISSION):
            self._admit_pass_locked()

    def _admit_pass_locked(self) -> None:
        with self._lock:
            now = self.clock()
            cq_objs = self.api.list("clusterqueues")
            lq_objs = self.api.list("localqueues")
            cluster_queues = {
                cq.name: cq
                for cq in (ClusterQueue.from_dict(o) for o in cq_objs)
                if cq.name
            }
            local_queues = {
                (lq.namespace, lq.name): lq
                for lq in (LocalQueue.from_dict(o) for o in lq_objs)
            }
            for name, cq in cluster_queues.items():
                self.ledger.set_queue(
                    name,
                    cohort=cq.spec.cohort,
                    quotas={
                        q.generation: QueueQuota(q.nominal_quota, q.borrowing_limit)
                        for q in cq.spec.quotas
                    },
                )
            for stale in set(self.ledger.queues()) - set(cluster_queues):
                self.ledger.remove_queue(stale)

            job_objs = self.api.list("tpujobs")
            # Every pass re-reads all three stores from apiserver truth —
            # that is the point (fresh-list discipline) and the cost the
            # scan counter makes visible.
            self.profiler.record_scan(
                "queue_admit", len(cq_objs) + len(lq_objs) + len(job_objs)
            )
            jobs = [TPUJob.from_dict(o) for o in job_objs]
            queued = [j for j in jobs if job_queue_name(j)]

            # Rebuild the ledger from admitted truth (cache.reconcile
            # analog): one charge per unfinished QuotaReserved=True job.
            charges: List[Tuple[JobKey, Charge]] = []
            admitted: List[TPUJob] = []
            waiting: List[TPUJob] = []
            for job in queued:
                if st.is_finished(job.status):
                    continue
                if is_admitted(job):
                    admitted.append(job)
                else:
                    waiting.append(job)
            for job in admitted:
                placement = self._resolve(job, cluster_queues, local_queues)
                footprint = self._footprint(job)
                if placement is None or footprint is None:
                    continue  # queue vanished; charge drops with it
                generation, chips = footprint
                cond = st.get_condition(job.status, JOB_QUOTA_RESERVED)
                charges.append((
                    (job.namespace, job.name),
                    Charge(placement, generation, chips,
                           cond.last_transition_time if cond else 0.0),
                ))
            self.ledger.reconcile(charges)

            # Pending workloads, bucketed per ClusterQueue.
            pending_by_cq: Dict[str, List[Tuple[TPUJob, str, int]]] = {}
            self._pending_keys = set()
            for job in waiting:
                key = f"{job.namespace}/{job.name}"
                # Single-writer gate: a queue-targeted job runs only after
                # admission; anything unadmitted is forced suspended first —
                # even one naming a queue that does not (yet) exist.
                if not job.spec.run_policy.suspend:
                    self._gate(job, now)
                placement = self._resolve(job, cluster_queues, local_queues)
                if placement is None:
                    self._pending_keys.add(key)
                    self._mark_queue_not_found(job, local_queues, now)
                    continue
                if st.has_condition(job.status, JOB_QUEUE_NOT_FOUND):
                    self._set_job_condition(
                        job, JOB_QUEUE_NOT_FOUND, QUEUE_FOUND_REASON,
                        f"queue {job_queue_name(job)} resolved to "
                        f"ClusterQueue {placement}",
                        status=st.CONDITION_FALSE, now=now, write=True,
                    )
                footprint = self._footprint(job)
                if footprint is None:
                    self._pending_keys.add(key)
                    self._mark_pending(
                        job,
                        "cannot compute GPU footprint: invalid "
                        f"tpu.acceleratorType "
                        f"{job.spec.tpu.accelerator_type!r}",
                        now,
                    )
                    continue
                generation, chips = footprint
                pending_by_cq.setdefault(placement, []).append(
                    (job, generation, chips)
                )

            for cq_name in sorted(pending_by_cq):
                self._admit_queue(
                    cluster_queues[cq_name], pending_by_cq[cq_name], now
                )

            # Gauges + ClusterQueue status mirror, from this pass's truth.
            self._pending_counts = {name: 0 for name in cluster_queues}
            self._admitted_counts = {name: 0 for name in cluster_queues}
            for key, charge in self.ledger.charges().items():
                self._admitted_counts[charge.queue] = (
                    self._admitted_counts.get(charge.queue, 0) + 1
                )
            for cq_name, entries in pending_by_cq.items():
                still = [
                    1 for job, _, _ in entries
                    if f"{job.namespace}/{job.name}" in self._pending_keys
                ]
                self._pending_counts[cq_name] = len(still)
            self._refresh_gauges()
            self._mirror_queue_status(cluster_queues)

    def _admit_queue(
        self,
        cq: ClusterQueue,
        entries: List[Tuple[TPUJob, str, int]],
        now: float,
    ) -> None:
        """Priority-then-FIFO admission for one ClusterQueue, strict: the
        first workload that cannot fit (even after reclaim) blocks the
        rest, so high-priority large jobs are not starved by small ones
        slipping past them."""
        entries.sort(
            key=lambda e: (
                -self._job_priority(e[0]),
                e[0].metadata.creation_timestamp or 0.0,
                f"{e[0].namespace}/{e[0].name}",
            )
        )
        ahead = 0
        for job, generation, chips in entries:
            key = f"{job.namespace}/{job.name}"
            if ahead:
                self._pending_keys.add(key)
                self._mark_pending(
                    job,
                    f"waiting for {ahead} workload(s) ahead in "
                    f"ClusterQueue {cq.name}",
                    now,
                )
                ahead += 1
                continue
            ok, free = self.ledger.fits(cq.name, generation, chips)
            if not ok and cq.spec.preemption.reclaim_within_cohort == RECLAIM_ANY:
                victims = self.ledger.reclaim_candidates(
                    cq.name, generation, chips
                )
                if victims:
                    for victim_key in victims:
                        self._evict(victim_key, cq.name, job, now)
                    ok, free = self.ledger.fits(cq.name, generation, chips)
            if not ok:
                self._pending_keys.add(key)
                self._mark_pending(
                    job,
                    insufficient_quota_message(cq.name, generation, chips, free),
                    now,
                )
                ahead = 1
                continue
            self._admit(job, cq.name, generation, chips, now)

    # ------------------------------------------------------------------
    # Decisions
    # ------------------------------------------------------------------

    def _admit(self, job: TPUJob, cq_name: str, generation: str, chips: int,
               now: float) -> None:
        self.ledger.reserve(
            (job.namespace, job.name), cq_name, generation, chips,
            admitted_at=now,
        )
        live = self._patch_suspend(job, False)
        if live is None:  # deleted underneath us: give the GPUs back
            self.ledger.release((job.namespace, job.name))
            return
        msg = (
            f"Admitted by ClusterQueue {cq_name}: reserved {chips} "
            f"{GPU_RESOURCE} ({generation})"
        )
        self._set_job_condition(
            live, JOB_QUOTA_RESERVED, ADMITTED_REASON, msg,
            status=st.CONDITION_TRUE, now=now, write=True,
            queue=cq_name, chips=chips,
        )
        self.recorder.event(live, EVENT_TYPE_NORMAL, ADMITTED_REASON, msg)
        self._last_failure_msg.pop(f"{job.namespace}/{job.name}", None)
        created = live.metadata.creation_timestamp
        if created is not None:
            self.admission_duration.observe(max(0.0, now - created), cq_name)
        self.log.info(
            "admitted %s/%s: %d GPUs (%s) in ClusterQueue %s",
            job.namespace, job.name, chips, generation, cq_name,
            cluster_queue=cq_name,
        )

    def _evict(self, victim_key: JobKey, lender: str, claimant: TPUJob,
               now: float) -> None:
        """Re-suspend a borrowing workload and return its GPUs (Kueue
        reclaimWithinCohort eviction).  The controller observes the
        suspend flip and tears the workers down."""
        charge = self.ledger.charge_of(victim_key)
        if charge is None:
            return
        self.ledger.release(victim_key)
        namespace, name = victim_key
        try:
            victim = self.tpujobs.tpujobs(namespace).get(name)
        except NotFoundError:
            return
        self._patch_suspend(victim, True)
        msg = (
            f"Evicted from ClusterQueue {charge.queue}: ClusterQueue "
            f"{lender} reclaimed {charge.chips} borrowed {GPU_RESOURCE} "
            f"({charge.generation}) for {claimant.namespace}/{claimant.name}"
        )
        self._set_job_condition(
            victim, JOB_QUOTA_RESERVED, EVICTED_REASON, msg,
            status=st.CONDITION_FALSE, now=now, write=True,
            queue=charge.queue, chips=charge.chips,
        )
        self.recorder.event(victim, EVENT_TYPE_WARNING, EVICTED_REASON, msg)
        self.evictions.inc(1, charge.queue)
        self.log.info(
            "evicted %s/%s from ClusterQueue %s (reclaim by %s)",
            namespace, name, charge.queue, lender, cluster_queue=charge.queue,
        )

    def _gate(self, job: TPUJob, now: float) -> None:
        """Force an unadmitted queue-targeted job suspended (the webhook
        role Kueue plays at creation time)."""
        live = self._patch_suspend(job, True)
        if live is None:
            return
        msg = (
            f"Suspended until admitted by LocalQueue "
            f"{job.namespace}/{job_queue_name(job)}"
        )
        self.recorder.event(live, EVENT_TYPE_NORMAL, SUSPENDED_BY_QUEUE_REASON, msg)
        self.log.info(
            "gated %s/%s: queue-targeted jobs start suspended",
            job.namespace, job.name,
        )

    def _mark_pending(self, job: TPUJob, message: str, now: float) -> None:
        key = f"{job.namespace}/{job.name}"
        first_report = self._last_failure_msg.get(key) != message
        self._last_failure_msg[key] = message
        changed = self._set_job_condition(
            job, JOB_QUOTA_RESERVED, PENDING_REASON, message,
            status=st.CONDITION_FALSE, now=now, write=True,
        )
        if first_report or changed:
            self.recorder.event(job, EVENT_TYPE_WARNING, PENDING_REASON, message)

    def _mark_queue_not_found(self, job: TPUJob, local_queues, now: float) -> None:
        queue = job_queue_name(job)
        lq = local_queues.get((job.namespace, queue))
        if lq is None:
            msg = f"LocalQueue {job.namespace}/{queue} not found"
        else:
            msg = (
                f"ClusterQueue {lq.spec.cluster_queue} referenced by "
                f"LocalQueue {job.namespace}/{queue} not found"
            )
        first_report = self._last_failure_msg.get(f"{job.namespace}/{job.name}") != msg
        self._last_failure_msg[f"{job.namespace}/{job.name}"] = msg
        changed = self._set_job_condition(
            job, JOB_QUEUE_NOT_FOUND, QUEUE_NOT_FOUND_REASON, msg,
            status=st.CONDITION_TRUE, now=now, write=True,
        )
        if first_report or changed:
            self.recorder.event(
                job, EVENT_TYPE_WARNING, QUEUE_NOT_FOUND_REASON, msg
            )

    # ------------------------------------------------------------------
    # Helpers
    # ------------------------------------------------------------------

    def _job_priority(self, job: TPUJob) -> int:
        sp = job.spec.run_policy.scheduling_policy
        if sp is None or not sp.priority_class:
            return 0
        return self._priorities.get(sp.priority_class, 0)

    def _footprint(self, job: TPUJob) -> Optional[Tuple[str, int]]:
        """(generation, total GPUs) for a job: its h100-<gpus> shape x
        numSlices (the port's validation holds numSlices to 1)."""
        shape = topology.resolve_shape_or_none(
            job.spec.tpu.accelerator_type, job.spec.tpu.topology
        )
        if shape is None:
            return None
        return shape.generation, shape.chips * max(1, job.spec.tpu.num_slices)

    def _resolve(self, job: TPUJob, cluster_queues, local_queues) -> Optional[str]:
        """LocalQueue-in-namespace -> ClusterQueue name, or None."""
        lq = local_queues.get((job.namespace, job_queue_name(job)))
        if lq is None:
            return None
        cq_name = lq.spec.cluster_queue
        return cq_name if cq_name in cluster_queues else None

    def _patch_suspend(self, job: TPUJob, value: bool) -> Optional[TPUJob]:
        """Flip ``runPolicy.suspend`` on the live object (the one
        spec-write this package is allowed; see tests/test_lint.py)."""
        client = self.tpujobs.tpujobs(job.namespace)

        def flip():
            live = client.get(job.name)
            if bool(live.spec.run_policy.suspend) == value:
                return live
            live.spec.run_policy.suspend = value
            return client.update(live)

        try:
            return retry.retry_on_conflict(flip, retry.DEFAULT_RETRY)
        except NotFoundError:
            return None

    def _set_job_condition(
        self, job: TPUJob, type_: str, reason: str, message: str, *,
        status: str, now: float, write: bool, **attrs,
    ) -> bool:
        """Extra ``attrs`` ride the flight-recorder entry so the goodput
        ledger can attribute queue-wait time to a specific ClusterQueue
        without parsing the human-readable message."""
        if not st.update_job_conditions(
            job, type_, reason, message, status=status, now=now
        ):
            return False
        self.flight_recorder.record(
            job.namespace, job.name, flightrecorder.CONDITION,
            reason=reason, message=message, type=type_, status=status,
            **attrs,
        )
        if write:
            self._write_status(job)
        return True

    def _write_status(self, job: TPUJob) -> None:
        client = self.tpujobs.tpujobs(job.namespace)

        def attempt():
            try:
                client.update_status(job)
            except ConflictError:
                live = client.get(job.name)
                live.status = job.status
                client.update_status(live)

        try:
            retry.retry_on_conflict(attempt, retry.DEFAULT_RETRY)
        except NotFoundError:
            pass

    def _refresh_gauges(self) -> None:
        with self._lock:
            self.pending_workloads.remove_matching()
            self.admitted_workloads.remove_matching()
            for name, count in self._pending_counts.items():
                self.pending_workloads.set(float(count), name)
            for name, count in self._admitted_counts.items():
                self.admitted_workloads.set(float(count), name)

    def _mirror_queue_status(self, cluster_queues: Dict[str, ClusterQueue]) -> None:
        """kube-style status mirror on each ClusterQueue, written only on
        change (the controller's changed-status discipline)."""
        for name, cq in cluster_queues.items():
            want = {
                "pendingWorkloads": self._pending_counts.get(name, 0),
                "admittedWorkloads": self._admitted_counts.get(name, 0),
                "usage": self.ledger.usage_by_generation(name),
            }
            have = cq.status.to_dict()
            want_trim = {k: v for k, v in want.items() if v}
            if want_trim == have:
                continue
            obj = cq.to_dict()
            obj["status"] = want
            try:
                self.api.update_status("clusterqueues", obj)
            except (ConflictError, NotFoundError):
                pass  # next pass re-mirrors from fresh truth


# ----------------------------------------------------------------------
# Bootstrap (cmd/operator.py --cluster-queue)
# ----------------------------------------------------------------------


def parse_cluster_queue_spec(spec: str) -> ClusterQueue:
    """Parse a ``--cluster-queue`` flag value into a ClusterQueue.

    Syntax: ``name[@cohort]:gen=gpus[,gen=gpus...]`` — e.g.
    ``team-a@research:h100=16``.  Bootstrap queues borrow without
    limit and reclaim within their cohort (the permissive defaults;
    declarative manifests can say otherwise).
    """
    head, sep, quota_part = spec.partition(":")
    if not sep or not quota_part:
        raise ValueError(
            f"--cluster-queue {spec!r}: expected name[@cohort]:gen=gpus[,...]"
        )
    name, _, cohort = head.partition("@")
    if not name:
        raise ValueError(f"--cluster-queue {spec!r}: queue name is empty")
    quotas = []
    for entry in quota_part.split(","):
        generation, eq, chips = entry.partition("=")
        if not eq or not generation:
            raise ValueError(
                f"--cluster-queue {spec!r}: bad quota entry {entry!r}"
            )
        if generation not in topology.GENERATIONS:
            # Said here, by the flag, rather than as the schema's
            # InvalidError at create.
            raise ValueError(
                f"--cluster-queue {spec!r}: {generation!r} is not a GPU "
                f"generation; want one of {sorted(topology.GENERATIONS)}, "
                f"e.g. {name}:h100=8"
            )
        try:
            nominal = int(chips)
        except ValueError:
            raise ValueError(
                f"--cluster-queue {spec!r}: GPU count {chips!r} is not an integer"
            )
        quotas.append({"generation": generation, "nominalQuota": nominal})
    return ClusterQueue.from_dict({
        "metadata": {"name": name},
        "spec": {
            "cohort": cohort,
            "quotas": quotas,
            "preemption": {"reclaimWithinCohort": RECLAIM_ANY},
        },
    })


def bootstrap_queues(api: InMemoryAPIServer, specs: List[str],
                     namespace: str = "") -> None:
    """Create the ``--cluster-queue`` ClusterQueues plus a same-named
    LocalQueue each in ``namespace`` (default "default"), skipping any
    that already exist (declarative manifests win)."""
    namespace = namespace or "default"
    for spec in specs:
        cq = parse_cluster_queue_spec(spec)
        try:
            api.create("clusterqueues", cq.to_dict())
        except AlreadyExistsError:
            pass
        lq = LocalQueue.from_dict({
            "metadata": {"name": cq.name, "namespace": namespace},
            "spec": {"clusterQueue": cq.name},
        })
        try:
            api.create("localqueues", lq.to_dict())
        except AlreadyExistsError:
            pass
