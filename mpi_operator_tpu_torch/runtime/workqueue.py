"""Rate-limited workqueue.

Reference analog: k8s.io/client-go/util/workqueue as used by the controller
(/root/reference/v2/pkg/controller/mpi_job_controller.go:237, :294,
:389-446): deduplicating delay-capable queue + per-item exponential backoff
rate limiter, so a failing TPUJob retries with backoff while a hot TPUJob
only ever occupies one queue slot.

Semantics kept from client-go:
- an item added while queued is deduplicated;
- an item added while *being processed* is remembered (dirty set) and
  re-queued when ``done()`` is called;
- ``add_rate_limited`` delays re-adds exponentially per item until
  ``forget()`` resets the failure count;
- ``shutdown()`` unblocks all getters.

Passing a ``registry`` arms the client-go workqueue metric set
(``workqueue_depth``, ``adds_total``, ``queue_duration_seconds``,
``work_duration_seconds``, ``retries_total``, ``unfinished_work_seconds``,
``longest_running_processor_seconds`` analogs), every series labeled by
queue ``name``.
"""

from __future__ import annotations

import heapq
import time
from typing import Any, Hashable, Optional

from ..utils import metrics
from . import locktrace

# Queue/work latencies span informer-event microseconds up to multi-second
# syncs against a real apiserver: wider-than-default buckets at both ends
# (client-go uses 1e-8..~10s exponential buckets for the same reason).
_LATENCY_BUCKETS = (
    1e-6, 1e-5, 1e-4, 1e-3, 0.01, 0.1, 0.5, 1.0, 5.0, 10.0, 30.0, 60.0,
)


class WorkqueueMetrics:
    """The client-go workqueue metric set, bound to one registry.

    One instance can serve many queues (series split by the ``name``
    label), matching client-go's MetricsProvider shape. All clock reads
    come from the owning queue so tests can drive time.
    """

    def __init__(self, registry: metrics.Registry):
        self.depth = metrics.new_gauge(
            "tpu_operator_workqueue_depth",
            "Current depth of the workqueue",
            ("name",),
            registry,
        )
        self.adds = metrics.new_counter(
            "tpu_operator_workqueue_adds_total",
            "Total number of adds handled by the workqueue",
            ("name",),
            registry,
        )
        self.queue_duration = metrics.new_histogram(
            "tpu_operator_workqueue_queue_duration_seconds",
            "How long an item stays in the workqueue before being requested",
            ("name",),
            registry,
            buckets=_LATENCY_BUCKETS,
        )
        self.work_duration = metrics.new_histogram(
            "tpu_operator_workqueue_work_duration_seconds",
            "How long processing an item from the workqueue takes",
            ("name",),
            registry,
            buckets=_LATENCY_BUCKETS,
        )
        self.retries = metrics.new_counter(
            "tpu_operator_workqueue_retries_total",
            "Total number of rate-limited re-adds (retries)",
            ("name",),
            registry,
        )
        self.unfinished_work = metrics.new_gauge(
            "tpu_operator_workqueue_unfinished_work_seconds",
            "Seconds of work in progress that has not been observed by "
            "work_duration yet (large values indicate stuck threads)",
            ("name",),
            registry,
        )
        self.longest_running = metrics.new_gauge(
            "tpu_operator_workqueue_longest_running_processor_seconds",
            "Seconds the single longest-running processor has held its "
            "item (unfinished_work aggregates; this isolates one stuck "
            "worker from many busy ones)",
            ("name",),
            registry,
        )


class ItemExponentialFailureRateLimiter:
    """Per-item exponential backoff (client-go default: 5ms base, 1000s cap)."""

    def __init__(self, base_delay: float = 0.005, max_delay: float = 1000.0):
        self.base_delay = base_delay
        self.max_delay = max_delay
        self._failures: dict[Hashable, int] = {}
        self._lock = locktrace.lock("workqueue.ratelimiter")

    def when(self, item: Hashable) -> float:
        with self._lock:
            failures = self._failures.get(item, 0)
            self._failures[item] = failures + 1
            delay = self.base_delay * (2**failures)
            return min(delay, self.max_delay)

    def forget(self, item: Hashable) -> None:
        with self._lock:
            self._failures.pop(item, None)

    def num_requeues(self, item: Hashable) -> int:
        with self._lock:
            return self._failures.get(item, 0)


class RateLimitingQueue:
    def __init__(
        self,
        rate_limiter: Optional[ItemExponentialFailureRateLimiter] = None,
        name: str = "",
        clock=time.monotonic,
        registry: Optional[metrics.Registry] = None,
        queue_metrics: Optional[WorkqueueMetrics] = None,
    ):
        self.name = name
        self._rate_limiter = rate_limiter or ItemExponentialFailureRateLimiter()
        self._clock = clock
        self._cond = locktrace.condition(f"workqueue.{name or 'default'}")
        self._queue: list[Any] = []  # FIFO of ready items
        self._queued: set[Hashable] = set()  # dedup: in _queue or delayed
        self._processing: set[Hashable] = set()
        self._dirty: set[Hashable] = set()  # re-add requested while processing
        self._delayed: list[tuple[float, int, Any]] = []  # heap (ready_at, seq, item)
        self._seq = 0
        self._shutdown = False
        # Instrumentation (client-go workqueue metrics analog). A shared
        # WorkqueueMetrics wins over a bare registry; both absent = no-op.
        self._metrics = queue_metrics
        if self._metrics is None and registry is not None:
            self._metrics = WorkqueueMetrics(registry)
        self._add_times: dict[Hashable, float] = {}  # queued-at, per item
        self._start_times: dict[Hashable, float] = {}  # processing-start
        if self._metrics is not None and registry is not None:
            # unfinished_work is a pull-model value: freshest at scrape.
            registry.on_scrape(self._update_unfinished_work)

    @property
    def metrics(self) -> Optional[WorkqueueMetrics]:
        """The bound WorkqueueMetrics, or None when unmetered."""
        return self._metrics

    # -- instrumentation hooks (no-ops when unmetered) -------------------

    def _on_enqueued(self, item: Hashable) -> None:
        """Item landed in the ready FIFO (fresh add, delayed promotion, or
        dirty re-queue). Caller holds self._cond."""
        if self._metrics is None:
            return
        self._metrics.adds.inc(1, self.name)
        self._add_times.setdefault(item, self._clock())
        self._metrics.depth.set(len(self._queue), self.name)

    def _on_get(self, item: Hashable) -> None:
        if self._metrics is None:
            return
        now = self._clock()
        added_at = self._add_times.pop(item, None)
        if added_at is not None:
            self._metrics.queue_duration.observe(now - added_at, self.name)
        self._start_times[item] = now
        self._metrics.depth.set(len(self._queue), self.name)

    def _on_done(self, item: Hashable) -> None:
        if self._metrics is None:
            return
        started_at = self._start_times.pop(item, None)
        if started_at is not None:
            self._metrics.work_duration.observe(
                self._clock() - started_at, self.name
            )

    def _update_unfinished_work(self) -> None:
        with self._cond:
            now = self._clock()
            running = [now - t for t in self._start_times.values()]
            self._metrics.unfinished_work.set(round(sum(running), 9), self.name)
            self._metrics.longest_running.set(
                round(max(running, default=0.0), 9), self.name
            )

    # -- core queue ------------------------------------------------------

    def add(self, item: Hashable) -> None:
        with self._cond:
            if self._shutdown:
                return
            if item in self._processing:
                self._dirty.add(item)
                return
            if item in self._queued:
                return
            self._queued.add(item)
            self._queue.append(item)
            self._on_enqueued(item)
            self._cond.notify()

    def add_after(self, item: Hashable, delay: float) -> None:
        if delay <= 0:
            self.add(item)
            return
        with self._cond:
            if self._shutdown:
                return
            self._seq += 1
            heapq.heappush(self._delayed, (self._clock() + delay, self._seq, item))
            self._cond.notify()

    def add_rate_limited(self, item: Hashable) -> None:
        if self._metrics is not None:
            self._metrics.retries.inc(1, self.name)
        self.add_after(item, self._rate_limiter.when(item))

    def forget(self, item: Hashable) -> None:
        self._rate_limiter.forget(item)

    def num_requeues(self, item: Hashable) -> int:
        return self._rate_limiter.num_requeues(item)

    def _promote_ready(self) -> Optional[float]:
        """Move due delayed items into the FIFO; return next wake-up delay."""
        now = self._clock()
        while self._delayed and self._delayed[0][0] <= now:
            _, _, item = heapq.heappop(self._delayed)
            if item in self._processing:
                self._dirty.add(item)
            elif item not in self._queued:
                self._queued.add(item)
                self._queue.append(item)
                self._on_enqueued(item)
        if self._delayed:
            return self._delayed[0][0] - now
        return None

    def get(self, timeout: Optional[float] = None) -> tuple[Any, bool]:
        """Return (item, shutdown). Blocks until an item is ready."""
        deadline = None if timeout is None else self._clock() + timeout
        with self._cond:
            while True:
                next_delay = self._promote_ready()
                if self._queue:
                    item = self._queue.pop(0)
                    self._queued.discard(item)
                    self._processing.add(item)
                    self._on_get(item)
                    return item, False
                if self._shutdown:
                    return None, True
                wait = next_delay
                if deadline is not None:
                    remaining = deadline - self._clock()
                    if remaining <= 0:
                        return None, False
                    wait = remaining if wait is None else min(wait, remaining)
                self._cond.wait(wait)

    def done(self, item: Hashable) -> None:
        with self._cond:
            self._processing.discard(item)
            self._on_done(item)
            if item in self._dirty:
                self._dirty.discard(item)
                if item not in self._queued:
                    self._queued.add(item)
                    self._queue.append(item)
                    self._on_enqueued(item)
                    self._cond.notify()

    def shutdown(self) -> None:
        with self._cond:
            self._shutdown = True
            self._cond.notify_all()

    def reset(self) -> None:
        """Re-arm a shut-down queue (leadership regained after step-down)."""
        with self._cond:
            self._shutdown = False

    @property
    def is_shutdown(self) -> bool:
        with self._cond:
            return self._shutdown

    def __len__(self) -> int:
        with self._cond:
            return len(self._queue)

    def pending_delayed(self) -> int:
        with self._cond:
            return len(self._delayed)

    def stats(self) -> dict:
        """Point-in-time queue health snapshot (the /debug/profile
        payload): depth, in-flight work, and how long the slowest
        processor has been holding its item.  Live values, not gauge
        reads, so it works on unmetered queues too (durations need
        metering — start times are only tracked then).

        All mutable state is copied in ONE critical section — a single
        consistent cut of the queue — and the derived math plus the
        metric-counter reads (which take the metrics' own locks) happen
        after release, keeping the condition's hold time flat no matter
        how many processors are in flight.
        """
        with self._cond:
            now = self._clock()
            depth = len(self._queue)
            delayed = len(self._delayed)
            processing = len(self._processing)
            start_times = list(self._start_times.values())
        running = [now - t for t in start_times]
        out = {
            "depth": depth,
            "delayed": delayed,
            "processing": processing,
            "unfinished_work_seconds": round(sum(running), 9),
            "longest_running_processor_seconds": round(
                max(running, default=0.0), 9
            ),
        }
        if self._metrics is not None:
            out["adds_total"] = self._metrics.adds.value(self.name)
            out["retries_total"] = self._metrics.retries.value(self.name)
        return out
