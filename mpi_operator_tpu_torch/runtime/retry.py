"""Client-go-style retry helpers with injectable time.

Analog of k8s.io/client-go/util/retry (RetryOnConflict / OnError over a
wait.Backoff).  Every control-plane writer in the operator — controller
status updates, scheduler binds, queue suspend/status patches, the pod
runner's node binding — goes through these helpers instead of hand-rolled
``for attempt in (1, 2)`` loops, so conflict storms (real or injected by
the chaos engine) degrade into bounded, jittered backoff instead of
immediate give-up.

All sleeping funnels through the module-level :func:`sleep`, which tests
and the chaos harness may monkeypatch (or callers may inject per call);
the jitter draws from an injectable ``random.Random`` so chaos runs stay
replayable from their seed.
"""

from __future__ import annotations

import random
import time
from dataclasses import dataclass
from typing import Callable, Iterator, Optional

from .apiserver import ConflictError

# Module-level injectable sleep: the single chokepoint for every pause in
# controller/scheduler/queue code (tests/test_lint.py bans bare
# ``time.sleep`` there).  Reassign or monkeypatch to accelerate tests.
sleep: Callable[[float], None] = time.sleep


@dataclass(frozen=True)
class Backoff:
    """wait.Backoff analog: capped, jittered exponential backoff.

    ``steps`` is the number of *attempts* (not retries); ``duration`` the
    base delay before the second attempt; each subsequent delay multiplies
    by ``factor`` up to ``cap``; ``jitter`` adds up to that fraction of
    the delay, drawn from ``rng``.
    """

    steps: int = 4
    duration: float = 0.01
    factor: float = 5.0
    jitter: float = 0.1
    cap: float = 1.0

    def delays(self, rng: Optional[random.Random] = None) -> Iterator[float]:
        """Yield the delay to sleep before each retry (steps - 1 values)."""
        duration = self.duration
        for _ in range(max(0, self.steps - 1)):
            delay = min(duration, self.cap)
            if self.jitter > 0:
                r = rng.random() if rng is not None else random.random()
                delay += delay * self.jitter * r
            yield delay
            duration = min(duration * self.factor, self.cap)


# client-go's retry.DefaultRetry / retry.DefaultBackoff values.
DEFAULT_RETRY = Backoff(steps=5, duration=0.01, factor=1.0, jitter=0.1)
DEFAULT_BACKOFF = Backoff(steps=4, duration=0.01, factor=5.0, jitter=0.1)


def on_error(
    backoff: Backoff,
    retriable: Callable[[BaseException], bool],
    fn: Callable[[], object],
    *,
    sleep: Optional[Callable[[float], None]] = None,
    rng: Optional[random.Random] = None,
):
    """Run ``fn`` up to ``backoff.steps`` times, sleeping between attempts.

    Exceptions for which ``retriable`` returns False propagate
    immediately; the last retriable exception propagates once attempts
    are exhausted.  Returns ``fn``'s result on success.
    """
    do_sleep = globals()["sleep"] if sleep is None else sleep
    delays = backoff.delays(rng)
    while True:
        try:
            return fn()
        except Exception as exc:
            if not retriable(exc):
                raise
            delay = next(delays, None)
            if delay is None:
                raise
            do_sleep(delay)


def retry_on_conflict(
    fn: Callable[[], object],
    backoff: Backoff = DEFAULT_RETRY,
    *,
    sleep: Optional[Callable[[float], None]] = None,
    rng: Optional[random.Random] = None,
):
    """RetryOnConflict analog: re-run ``fn`` while it raises ConflictError.

    ``fn`` must re-read the object each attempt — retrying a write of a
    stale resourceVersion just conflicts again.
    """
    return on_error(
        backoff, lambda exc: isinstance(exc, ConflictError), fn, sleep=sleep, rng=rng
    )
