"""Runtime lock-order race detector (Go ``-race`` / kernel lockdep analog).

The control plane is genuinely concurrent: informer pumps, workqueue
workers, the gang scheduler's reservation pass, the queue manager, and
scrape-time metric hooks all take locks in ~20 threaded modules.  The
static checker (``mpi_operator_tpu/analysis/lockcheck.py``) proves
discipline at the AST level; this module proves it at *runtime*: every
control-plane lock is created through the factories below, and when
tracing is armed each acquisition records

- the set of locks the acquiring thread already holds (the lockdep
  held-set), building a global lock-*order* graph keyed by lock name;
- an **inversion** whenever the graph gains an edge A->B while the
  reverse edge B->A was already observed on any thread — the classic
  deadlock precondition, caught even when the timing never actually
  deadlocks (single-threaded drives like the chaos soak still surface
  ordering bugs this way);
- **long holds**: a lock held longer than ``long_hold_seconds`` of wall
  clock (a stalled scrape hook or an apiserver write made under a hot
  lock).

Zero cost when off: the factories return plain ``threading`` primitives
unless tracing was enabled *before* the lock was created, so production
paths pay only one module-attribute read at construction time and
nothing per acquisition.  Arm it with the ``TPU_LOCK_TRACE=1``
environment variable, the operator's ``--lock-trace`` flag, the bench
harness's ``--lock-trace``, or ``locktrace.enable()`` in tests.

Identity is the lock *name*, not the instance (lockdep's lock-class
idiom): every informer's cache lock shares the ``informer.<resource>``
class, so an ordering violation between two instances of the same
subsystem is still a violation.  Self-edges (A->A) are skipped — a
reentrant RLock re-acquisition is legal and must not read as an
inversion.
"""

from __future__ import annotations

import os
import threading
import time
import traceback
from typing import Callable, Optional

ENV_FLAG = "TPU_LOCK_TRACE"
DEFAULT_LONG_HOLD_SECONDS = 1.0

# How many stack frames to keep per edge/inversion sample (enough to see
# the call path, small enough to keep reports readable).
_STACK_DEPTH = 12


class LockOrderError(AssertionError):
    """Raised by ``LockTracer.assert_no_inversions`` with the full
    inversion report in the message."""


def _capture_stack() -> list[str]:
    # Drop the tracer's own frames; keep the caller's path.
    return [
        f"{frame.filename}:{frame.lineno}:{frame.name}"
        for frame in traceback.extract_stack()[-_STACK_DEPTH - 3:-3]
    ]


class LockTracer:
    """Per-thread held-lock sets and the global lock-order graph.

    One tracer serves every traced lock in the process.  Its own state
    is guarded by an *untraced* ``threading.Lock`` (the tracer cannot
    trace itself), and per-thread held stacks live in a
    ``threading.local`` so the hot path takes the internal lock only
    when the held-set is non-empty (nested acquisition) or on release
    of a long-held lock.
    """

    def __init__(
        self,
        clock: Callable[[], float] = time.monotonic,
        long_hold_seconds: float = DEFAULT_LONG_HOLD_SECONDS,
        capture_stacks: bool = True,
    ):
        self.clock = clock
        self.long_hold_seconds = long_hold_seconds
        self.capture_stacks = capture_stacks
        self._mu = threading.Lock()  # internal; never a traced lock
        self._local = threading.local()
        # name -> {name -> sample stack of the first A-held->B acquire}
        self._edges: dict[str, dict[str, list[str]]] = {}
        self._inversions: list[dict] = []
        self._seen_pairs: set[frozenset] = set()
        self._long_holds: list[dict] = []
        self._max_held: dict[str, float] = {}
        self._acquisitions = 0

    # -- per-thread held stack ------------------------------------------

    def _held(self) -> list:
        held = getattr(self._local, "held", None)
        if held is None:
            held = self._local.held = []
        return held

    def held_names(self) -> tuple[str, ...]:
        """Locks the calling thread currently holds, outermost first."""
        return tuple(name for name, _ in self._held())

    # -- acquisition hooks ----------------------------------------------

    def on_acquired(self, name: str) -> None:
        held = self._held()
        now = self.clock()
        if held:
            stack = _capture_stack() if self.capture_stacks else []
            with self._mu:
                self._acquisitions += 1
                for outer, _ in held:
                    if outer == name:
                        continue  # same lock class: reentrancy, not order
                    self._edges.setdefault(outer, {}).setdefault(name, stack)
                    reverse = self._edges.get(name, {}).get(outer)
                    if reverse is not None:
                        pair = frozenset((outer, name))
                        if pair not in self._seen_pairs:
                            self._seen_pairs.add(pair)
                            self._inversions.append({
                                "locks": sorted(pair),
                                "forward": f"{outer} -> {name}",
                                "forward_stack": stack,
                                "reverse": f"{name} -> {outer}",
                                "reverse_stack": reverse,
                            })
        else:
            with self._mu:
                self._acquisitions += 1
        held.append((name, now))

    def on_released(self, name: str) -> None:
        held = self._held()
        for i in range(len(held) - 1, -1, -1):
            if held[i][0] == name:
                _, acquired_at = held.pop(i)
                duration = self.clock() - acquired_at
                with self._mu:
                    if duration > self._max_held.get(name, 0.0):
                        self._max_held[name] = duration
                    if duration >= self.long_hold_seconds:
                        self._long_holds.append({
                            "lock": name,
                            "held_seconds": round(duration, 6),
                            "stack": (
                                _capture_stack() if self.capture_stacks else []
                            ),
                        })
                return

    # -- reporting -------------------------------------------------------

    def report(self) -> dict:
        """JSON-friendly summary: inversions, long holds, the order
        graph, and per-lock max hold times."""
        with self._mu:
            return {
                "acquisitions": self._acquisitions,
                "locks": sorted(self._max_held),
                "inversions": [dict(inv) for inv in self._inversions],
                "long_holds": [dict(h) for h in self._long_holds],
                "edges": {
                    outer: sorted(inners)
                    for outer, inners in sorted(self._edges.items())
                },
                "max_held_seconds": {
                    name: round(secs, 6)
                    for name, secs in sorted(self._max_held.items())
                },
            }

    def assert_no_inversions(self) -> None:
        with self._mu:
            inversions = list(self._inversions)
        if inversions:
            lines = ["lock-order inversions detected:"]
            for inv in inversions:
                lines.append(f"  {inv['forward']}  vs  {inv['reverse']}")
                for label in ("forward_stack", "reverse_stack"):
                    for frame in inv[label][-4:]:
                        lines.append(f"    [{label}] {frame}")
            raise LockOrderError("\n".join(lines))


# ----------------------------------------------------------------------
# Traced primitives
# ----------------------------------------------------------------------


class TracedLock:
    """A non-reentrant ``threading.Lock`` that reports acquisition order
    to a :class:`LockTracer`.  Usable as a ``threading.Condition`` inner
    lock (acquire/release protocol only; no ``_release_save`` — the
    Condition falls back to plain release/acquire, which keeps the
    tracer's held-set honest across ``wait()``)."""

    def __init__(self, name: str, tracer: LockTracer):
        self._inner = threading.Lock()
        self.name = name
        self._tracer = tracer

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        ok = self._inner.acquire(blocking, timeout)
        if ok:
            self._tracer.on_acquired(self.name)
        return ok

    def release(self) -> None:
        self._tracer.on_released(self.name)
        self._inner.release()

    def locked(self) -> bool:
        return self._inner.locked()

    def __enter__(self) -> bool:
        return self.acquire()

    def __exit__(self, *exc) -> None:
        self.release()


class TracedRLock:
    """A reentrant lock wrapper.  Only the outermost acquisition (per
    thread) reports to the tracer — re-acquisition by the owning thread
    is legal and must not create order edges (the reentrant-RLock
    non-finding).  Implements the private Condition protocol
    (``_release_save``/``_acquire_restore``/``_is_owned``) so
    ``threading.Condition(TracedRLock(...))`` keeps exact RLock
    semantics while the tracer sees ``wait()`` drop and re-take the
    lock."""

    def __init__(self, name: str, tracer: LockTracer):
        self._inner = threading.RLock()
        self.name = name
        self._tracer = tracer
        self._local = threading.local()

    def _depth(self) -> int:
        return getattr(self._local, "depth", 0)

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        ok = self._inner.acquire(blocking, timeout)
        if ok:
            depth = self._depth()
            if depth == 0:
                self._tracer.on_acquired(self.name)
            self._local.depth = depth + 1
        return ok

    def release(self) -> None:
        depth = self._depth()
        if depth == 1:
            self._tracer.on_released(self.name)
        self._local.depth = max(depth - 1, 0)
        self._inner.release()

    def __enter__(self) -> bool:
        return self.acquire()

    def __exit__(self, *exc) -> None:
        self.release()

    # -- Condition protocol ---------------------------------------------

    def _release_save(self):
        depth = self._depth()
        if depth:
            self._tracer.on_released(self.name)
        self._local.depth = 0
        return (self._inner._release_save(), depth)

    def _acquire_restore(self, state) -> None:
        inner_state, depth = state
        self._inner._acquire_restore(inner_state)
        if depth:
            self._tracer.on_acquired(self.name)
        self._local.depth = depth

    def _is_owned(self) -> bool:
        return self._inner._is_owned()


# ----------------------------------------------------------------------
# Process-global switch + factories
# ----------------------------------------------------------------------

_tracer: Optional[LockTracer] = None


def enabled() -> bool:
    return _tracer is not None


def tracer() -> Optional[LockTracer]:
    """The active tracer, or None when tracing is off."""
    return _tracer


def enable(active: Optional[LockTracer] = None) -> LockTracer:
    """Arm tracing for locks created from now on; returns the tracer.
    Call *before* constructing the stack under test — locks created
    while tracing was off stay plain forever."""
    global _tracer
    _tracer = active if active is not None else LockTracer()
    return _tracer


def disable() -> None:
    global _tracer
    _tracer = None


def _env_enabled() -> bool:
    return os.environ.get(ENV_FLAG, "").strip().lower() not in (
        "", "0", "false", "off", "no",
    )


if _env_enabled():  # pragma: no cover - exercised via subprocess tests
    enable()


def lock(name: str):
    """A mutex for control-plane state: plain ``threading.Lock`` when
    tracing is off, a :class:`TracedLock` when armed."""
    if _tracer is None:
        return threading.Lock()
    return TracedLock(name, _tracer)


def rlock(name: str):
    if _tracer is None:
        return threading.RLock()
    return TracedRLock(name, _tracer)


def condition(name: str):
    """A ``threading.Condition`` whose (reentrant) inner lock is traced
    when armed — the workqueue idiom."""
    if _tracer is None:
        return threading.Condition()
    return threading.Condition(TracedRLock(name, _tracer))
