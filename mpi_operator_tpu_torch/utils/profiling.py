"""Phase-level profiling for the control plane.

PR 1/3 gave the operator whole-reconcile histograms (how long did
``sync_handler`` take) but nothing below that granularity: a slow
reconcile could be cache scans, desired-state rendering, apiserver
writes, or status-update conflict retries and the metrics could not say
which.  This module is the attribution layer:

- ``PhaseProfiler.phase(name)``: a context manager (and ``profiled``
  decorator) that times a named phase of work.  Timing is *exclusive*:
  entering a nested phase pauses the parent, so phases tile the pass
  they belong to and their shares sum to ~100% (the remainder is
  reported as ``unattributed`` glue code, never double-counted).
- cache-scan accounting (``record_scan``): objects touched per pass.
  ``utils/statemetrics.py`` and ``queue/manager.py`` rescan full caches
  today; these counters make that visible (and let tests assert when an
  index removes a scan).
- watch-to-reconcile propagation latency: the apiserver stamps every
  ``WatchEvent`` at emission (``WatchEvent.emitted_at``); the informer
  pump observes the ``delivered`` stage and the controller observes the
  ``reconcile`` stage when it dequeues the key the event produced.

Phase names are a closed vocabulary: ``PHASES`` below is the canonical
enum and ``tests/test_lint.py`` rejects any ``.phase("...")`` call site
using a string not registered here (and any non-literal argument), so
the taxonomy cannot drift into free-form labels.

Clock discipline: every stamp and observation goes through the
module-level ``clock`` chokepoint (the ``retry.sleep`` idiom) so
deterministic tests can monkeypatch ``profiling.clock`` and inject
exact latencies with no wall-clock waits.

One profiler per registry: components that share a ``metrics.Registry``
(controller + queue manager in the operator process) must also share a
profiler, or the second one would re-register the same metric names.
``profiler_for(registry)`` memoizes on the registry identity.
"""

from __future__ import annotations

import functools
import threading
import time
import weakref
from typing import Callable, Optional

from ..runtime import locktrace
from . import metrics

# ----------------------------------------------------------------------
# Canonical phase taxonomy (the closed vocabulary tests/test_lint.py
# enforces at every .phase(...) call site).
# ----------------------------------------------------------------------

PHASE_CACHE_READ = "cache_read"          # informer cache get/list
PHASE_RENDER = "render"                  # desired-state object building
PHASE_APISERVER_WRITE = "apiserver_write"  # create/update/delete calls
PHASE_STATUS_UPDATE = "status_update"    # job status diff + write (retries)
PHASE_SCHED_SNAPSHOT = "sched_snapshot"  # scheduler cluster snapshot/reconcile
PHASE_SCHED_RESERVE = "sched_reserve"    # gang fit + chip reservation
PHASE_SCHED_BIND = "sched_bind"          # pod binding writes
PHASE_QUEUE_ADMISSION = "queue_admission"  # quota admission pass

# Phases that tile a controller reconcile pass: their exclusive times
# plus ``unattributed`` sum to the whole-pass duration.
RECONCILE_PHASES = (
    PHASE_CACHE_READ,
    PHASE_RENDER,
    PHASE_APISERVER_WRITE,
    PHASE_STATUS_UPDATE,
)
SCHEDULER_PHASES = (PHASE_SCHED_SNAPSHOT, PHASE_SCHED_RESERVE, PHASE_SCHED_BIND)
QUEUE_PHASES = (PHASE_QUEUE_ADMISSION,)

PHASES = RECONCILE_PHASES + SCHEDULER_PHASES + QUEUE_PHASES

# Derived label for reconcile time outside any phase; not a phase name
# (passing it to .phase() is rejected).
UNATTRIBUTED = "unattributed"

# Watch propagation stages.
STAGE_DELIVERED = "delivered"   # apiserver emission -> informer handler
STAGE_RECONCILE = "reconcile"   # apiserver emission -> controller dequeue
PROPAGATION_STAGES = (STAGE_DELIVERED, STAGE_RECONCILE)

# Propagation/phase latencies span from microseconds (in-process pump)
# to tens of seconds (chaos-delayed watches), wider than DEFAULT_BUCKETS.
LATENCY_BUCKETS = (
    1e-6, 1e-5, 1e-4, 1e-3, 0.01, 0.1, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0,
)

# Module-level clock chokepoint (the ``retry.sleep`` idiom): every stamp
# and every observation reads this, so tests monkeypatch
# ``profiling.clock`` once and emission/delivery/dequeue all agree.
clock: Callable[[], float] = time.monotonic

# Thread-local stamp of the watch event currently being dispatched by an
# informer pump: set around handler dispatch, read by the controller's
# enqueue hook so the emitted_at timestamp survives the object->key
# mapping (pod event -> owner job key) without threading it through
# every handler signature.
_tls = threading.local()


def set_current_event_stamp(emitted_at: Optional[float]) -> None:
    _tls.event_stamp = emitted_at


def current_event_stamp() -> Optional[float]:
    return getattr(_tls, "event_stamp", None)


def clear_current_event_stamp() -> None:
    _tls.event_stamp = None


def histogram_quantile(
    hist: metrics.Histogram, q: float, *labels: str,
    counts: Optional[list[int]] = None,
) -> float:
    """PromQL ``histogram_quantile`` analog: linear interpolation within
    the bucket containing the rank.  Observations in the +Inf bucket
    report the largest finite bound (same clamping Prometheus applies).

    Pass ``counts`` (a ``cumulative_counts`` result) to compute several
    quantiles from one atomic read of the histogram instead of a fresh
    — possibly shifted — read per quantile.
    """
    if counts is None:
        counts = hist.cumulative_counts(*labels)
    total = counts[-1] if counts else 0
    if total == 0:
        return 0.0
    rank = q * total
    bounds = hist.buckets
    prev_count, prev_bound = 0, 0.0
    for bound, count in zip(bounds, counts):
        if count >= rank:
            if count == prev_count:
                return bound
            return prev_bound + (bound - prev_bound) * (
                (rank - prev_count) / (count - prev_count)
            )
        prev_count, prev_bound = count, bound
    return bounds[-1]


class _PhaseSpan:
    """One active phase on the thread's stack.  Exclusive timing: when a
    child phase enters it pauses this span (accumulating elapsed time up
    to the child's start); when the child exits this span resumes."""

    __slots__ = ("_profiler", "name", "_elapsed", "_resumed_at")

    def __init__(self, profiler: "PhaseProfiler", name: str):
        self._profiler = profiler
        self.name = name
        self._elapsed = 0.0
        self._resumed_at = 0.0

    def __enter__(self) -> "_PhaseSpan":
        now = clock()
        stack = self._profiler._stack()
        if stack:
            stack[-1]._pause(now)
        self._resumed_at = now
        stack.append(self)
        return self

    def __exit__(self, *exc) -> None:
        now = clock()
        stack = self._profiler._stack()
        stack.pop()
        self._elapsed += now - self._resumed_at
        self._profiler._observe_phase(self.name, self._elapsed)
        if stack:
            stack[-1]._resumed_at = now

    def _pause(self, now: float) -> None:
        self._elapsed += now - self._resumed_at
        self._resumed_at = now


class PhaseProfiler:
    """Phase timers, scan accounting, and watch-propagation latency,
    all feeding one ``metrics.Registry``.  Construct via
    ``profiler_for(registry)`` so components sharing a registry share
    the profiler (duplicate registration would corrupt /metrics)."""

    def __init__(self, registry: metrics.Registry):
        self.phase_duration = metrics.new_histogram(
            "tpu_operator_profile_phase_duration_seconds",
            "Exclusive time spent per named control-plane phase",
            ("phase",),
            registry,
            buckets=LATENCY_BUCKETS,
        )
        self.scan_objects = metrics.new_counter(
            "tpu_operator_profile_cache_scan_objects_total",
            "Objects touched by full cache/store scans, by scan scope",
            ("scope",),
            registry,
        )
        self.scan_passes = metrics.new_counter(
            "tpu_operator_profile_cache_scan_passes_total",
            "Full cache/store scan passes, by scan scope",
            ("scope",),
            registry,
        )
        self.watch_propagation = metrics.new_histogram(
            "tpu_operator_profile_watch_propagation_seconds",
            "Latency from apiserver event emission to each pipeline stage",
            ("stage",),
            registry,
            buckets=LATENCY_BUCKETS,
        )
        self._lock = locktrace.lock("profiler")
        self._local = threading.local()
        self._pass_count = 0
        self._pass_seconds = 0.0
        self._scan_scopes: set[str] = set()
        # key -> earliest emitted_at of the events that dirtied it, popped
        # when the controller dequeues the key.
        self._pending_events: dict[str, float] = {}

    # -- phase timing ---------------------------------------------------

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def phase(self, name: str) -> _PhaseSpan:
        """``with profiler.phase(profiling.PHASE_RENDER): ...``"""
        if name not in PHASES:
            raise ValueError(
                f"unknown profiling phase {name!r}; register it in "
                "profiling.PHASES"
            )
        return _PhaseSpan(self, name)

    def profiled(self, name: str) -> Callable:
        """Decorator form of ``phase``."""

        def decorate(fn: Callable) -> Callable:
            @functools.wraps(fn)
            def wrapper(*args, **kwargs):
                with self.phase(name):
                    return fn(*args, **kwargs)

            return wrapper

        return decorate

    def _observe_phase(self, name: str, seconds: float) -> None:
        self.phase_duration.observe(max(seconds, 0.0), name)

    def observe_pass(self, seconds: float) -> None:
        """Record one whole reconcile pass; the denominator for phase
        shares in ``snapshot()``."""
        with self._lock:
            self._pass_count += 1
            self._pass_seconds += max(seconds, 0.0)

    # -- cache scan accounting ------------------------------------------

    def record_scan(self, scope: str, objects: int) -> None:
        """One full scan over ``objects`` objects under ``scope`` (a
        resource or component name, not a phase)."""
        self.scan_passes.inc(1.0, scope)
        self.scan_objects.inc(float(objects), scope)
        with self._lock:
            self._scan_scopes.add(scope)

    # -- watch-to-reconcile latency -------------------------------------

    def observe_delivery(self, emitted_at: Optional[float]) -> None:
        """Informer pump delivered an event stamped at ``emitted_at``."""
        if emitted_at is None:
            return
        self.watch_propagation.observe(
            max(clock() - emitted_at, 0.0), STAGE_DELIVERED
        )

    def note_event(self, key: str, emitted_at: Optional[float]) -> None:
        """An event stamped at ``emitted_at`` enqueued ``key``.  Keeps
        the earliest stamp per key: a burst of events coalesced by the
        workqueue is attributed to the first event that went unserved."""
        if emitted_at is None:
            return
        with self._lock:
            prior = self._pending_events.get(key)
            if prior is None or emitted_at < prior:
                self._pending_events[key] = emitted_at

    def observe_dequeue(self, key: str) -> None:
        """The controller dequeued ``key``; close out the propagation
        measurement for the event(s) that produced it."""
        with self._lock:
            emitted_at = self._pending_events.pop(key, None)
        if emitted_at is not None:
            self.watch_propagation.observe(
                max(clock() - emitted_at, 0.0), STAGE_RECONCILE
            )

    # -- snapshot (the /debug/profile payload) --------------------------

    def snapshot(self) -> dict:
        """JSON-friendly summary: per-phase exclusive seconds and counts,
        reconcile-phase shares (summing to ~1.0 with ``unattributed``),
        watch-propagation quantiles, and per-scope scan accounting."""
        with self._lock:
            pass_count = self._pass_count
            pass_seconds = self._pass_seconds
            scopes = sorted(self._scan_scopes)

        phases: dict[str, dict] = {}
        for name in PHASES:
            # One atomic (count, sum) pair per phase: separate accessor
            # calls can tear under concurrent observes (count from after
            # an observe paired with the sum from before it).
            count, seconds = self.phase_duration.sample_stats(name)
            if count == 0:
                continue
            phases[name] = {"count": count, "seconds": seconds}

        reconcile_attributed = sum(
            phases[name]["seconds"]
            for name in RECONCILE_PHASES
            if name in phases
        )
        shares: dict[str, float] = {}
        if pass_seconds > 0:
            for name in RECONCILE_PHASES:
                if name in phases:
                    shares[name] = phases[name]["seconds"] / pass_seconds
            shares[UNATTRIBUTED] = (
                max(pass_seconds - reconcile_attributed, 0.0) / pass_seconds
            )

        propagation: dict[str, dict] = {}
        for stage in PROPAGATION_STAGES:
            # One cumulative read per stage; count and both quantiles
            # derive from the same cut of the histogram.
            counts = self.watch_propagation.cumulative_counts(stage)
            count = counts[-1] if counts else 0
            if count == 0:
                continue
            propagation[stage] = {
                "count": count,
                "p50_seconds": histogram_quantile(
                    self.watch_propagation, 0.50, stage, counts=counts
                ),
                "p99_seconds": histogram_quantile(
                    self.watch_propagation, 0.99, stage, counts=counts
                ),
            }

        scans: dict[str, dict] = {}
        for scope in scopes:
            passes = self.scan_passes.value(scope)
            objects = self.scan_objects.value(scope)
            scans[scope] = {
                "passes": int(passes),
                "objects": int(objects),
                "objects_per_pass": (objects / passes) if passes else 0.0,
            }

        return {
            "reconcile": {"passes": pass_count, "seconds": pass_seconds},
            "phases": phases,
            "reconcile_phase_shares": shares,
            "watch_propagation": propagation,
            "cache_scans": scans,
        }


# ----------------------------------------------------------------------
# One profiler per registry.
# ----------------------------------------------------------------------

_profilers: "weakref.WeakKeyDictionary[metrics.Registry, PhaseProfiler]" = (
    weakref.WeakKeyDictionary()
)
_profilers_lock = threading.Lock()


def profiler_for(registry: metrics.Registry) -> PhaseProfiler:
    """The profiler bound to ``registry``, created on first use.  Callers
    sharing a registry get the same profiler, so metric names register
    exactly once per registry."""
    with _profilers_lock:
        profiler = _profilers.get(registry)
        if profiler is None:
            profiler = PhaseProfiler(registry)
            _profilers[registry] = profiler
        return profiler
