"""Pod binding: the scheduler's only write path to the API server.

kube-scheduler analog: the bind phase (``pods/binding`` subresource).
The in-memory backend has no binding subresource, so the binder writes
the assignment in two steps ordered for crash-safety against the pod
runner's watch:

1. status first — ``PodScheduled=True`` condition while the phase is
   still ``Pending`` (nobody acts on conditions alone);
2. then ``spec.nodeName`` — the MODIFIED event this write emits is what
   wakes the runner, which flips the phase to Running.  Because the
   condition landed first, the runner's status write can never race a
   half-bound pod.

``FlakyBinder`` wraps a real binder for the fault-injection tier: it
fails chosen bind calls (conflict) and can sabotage the cluster
mid-gang (node loss) via a callback, so tests can prove the gang
reserve rollback never leaks chips.
"""

from __future__ import annotations

import time
from typing import Callable, Optional

from ..runtime import retry
from ..runtime.apiserver import ConflictError, NotFoundError
from ..utils import profiling
from ..utils.logging import get_logger


class BindError(RuntimeError):
    """A bind attempt failed; the caller must roll the gang back."""


def scheduled_condition(
    status: str, reason: str = "", message: str = "",
    now: Optional[float] = None,
) -> dict:
    cond = {"type": "PodScheduled", "status": status}
    if reason:
        cond["reason"] = reason
    if message:
        cond["message"] = message
    if now is not None:
        # Real pod conditions carry lastTransitionTime; downstream
        # consumers (goodput attribution, kubectl-style describes) read
        # scheduling latency straight off the condition.
        cond["lastTransitionTime"] = round(now, 6)
    return cond


def set_pod_condition(pod: dict, cond: dict) -> None:
    status = pod.setdefault("status", {})
    conds = [c for c in status.get("conditions") or [] if c.get("type") != cond["type"]]
    conds.append(cond)
    status["conditions"] = conds


class Binder:
    """Writes assignments to the API server under conflict-retry backoff
    (runtime/retry.retry_on_conflict)."""

    def __init__(self, api, clock=time.time, profiler=None):
        self._api = api
        self._clock = clock
        self._profiler = profiler
        self._log = get_logger("scheduler.binder")

    def bind(self, namespace: str, name: str, node_name: str) -> dict:
        if self._profiler is not None:
            with self._profiler.phase(profiling.PHASE_SCHED_BIND):
                return self._bind(namespace, name, node_name)
        return self._bind(namespace, name, node_name)

    def _bind(self, namespace: str, name: str, node_name: str) -> dict:
        def attempt() -> dict:
            # Each attempt re-reads the pod: a conflict means someone else
            # wrote it, so retrying the stale copy would conflict forever.
            try:
                pod = self._api.get("pods", namespace, name)
            except NotFoundError:
                raise BindError(f"pod {namespace}/{name} vanished before bind")
            if pod.get("spec", {}).get("nodeName"):
                if pod["spec"]["nodeName"] == node_name:
                    return pod  # already bound here (idempotent retry)
                raise BindError(
                    f"pod {namespace}/{name} already bound to "
                    f"{pod['spec']['nodeName']!r}"
                )
            set_pod_condition(
                pod, scheduled_condition("True", now=self._clock())
            )
            pod["status"].setdefault("phase", "Pending")
            pod = self._api.update_status("pods", pod)
            pod["spec"]["nodeName"] = node_name
            return self._api.update("pods", pod)

        try:
            bound = retry.retry_on_conflict(attempt, retry.DEFAULT_RETRY)
        except ConflictError:
            raise BindError(f"conflict binding {namespace}/{name}")
        self._log.debug("bound pod %s/%s to %s", namespace, name, node_name)
        return bound

    def mark_unschedulable(self, namespace: str, name: str, message: str) -> None:
        """Surface ``PodScheduled=False/Unschedulable`` on the pod, the
        condition the controller folds into the job's ``Scheduled``
        condition.  Best-effort: an unschedulable pod is untouched state,
        a write race just means another pass will repeat the verdict."""
        if self._profiler is not None:
            with self._profiler.phase(profiling.PHASE_SCHED_BIND):
                return self._mark_unschedulable(namespace, name, message)
        return self._mark_unschedulable(namespace, name, message)

    def _mark_unschedulable(self, namespace: str, name: str, message: str) -> None:
        try:
            pod = self._api.get("pods", namespace, name)
        except NotFoundError:
            return
        existing = {
            (c.get("type"), c.get("status"), c.get("message"))
            for c in (pod.get("status") or {}).get("conditions") or []
        }
        if ("PodScheduled", "False", message) in existing:
            return  # no-op write would still bump resourceVersion
        set_pod_condition(
            pod, scheduled_condition(
                "False", reason="Unschedulable", message=message,
                now=self._clock(),
            )
        )
        pod["status"].setdefault("phase", "Pending")
        try:
            self._api.update_status("pods", pod)
        except ConflictError:
            return
        self._log.debug("marked pod %s/%s unschedulable", namespace, name)


class FlakyBinder:
    """Fault-injection wrapper: fails selected bind calls, optionally
    running a sabotage callback first (e.g. delete the target node to
    model node loss mid-reserve)."""

    def __init__(
        self,
        inner: Binder,
        fail_calls: Optional[set[int]] = None,
        on_fail: Optional[Callable[[int, str, str, str], None]] = None,
    ):
        self._inner = inner
        self.fail_calls = fail_calls or set()
        self.on_fail = on_fail
        self.calls = 0

    def bind(self, namespace: str, name: str, node_name: str) -> dict:
        self.calls += 1
        if self.calls in self.fail_calls:
            if self.on_fail is not None:
                self.on_fail(self.calls, namespace, name, node_name)
            raise BindError(
                f"injected bind conflict for {namespace}/{name} (call #{self.calls})"
            )
        return self._inner.bind(namespace, name, node_name)

    def mark_unschedulable(self, namespace: str, name: str, message: str) -> None:
        self._inner.mark_unschedulable(namespace, name, message)
