"""Leader election over coordination Leases.

Reference analog: client-go leaderelection with an EndpointsLock as wired
in /root/reference/v2/cmd/mpi-operator/app/server.go:210-257 (timings
:60-71: 15s lease, 10s renew deadline, 5s retry).  Only the leader runs
the controller; a replica that loses its lease steps down so HA
deployments never double-reconcile.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import TYPE_CHECKING, Callable, Optional, Union

from .apiserver import (
    AlreadyExistsError,
    ConflictError,
    InMemoryAPIServer,
    NotFoundError,
)

if TYPE_CHECKING:
    from .kube import KubeAPIServer

DEFAULT_LEASE_DURATION = 15.0
DEFAULT_RENEW_DEADLINE = 10.0
DEFAULT_RETRY_PERIOD = 5.0


@dataclass
class LeaderElectionConfig:
    lock_namespace: str = "default"
    lock_name: str = "tpu-operator"
    identity: str = ""
    lease_duration: float = DEFAULT_LEASE_DURATION
    renew_deadline: float = DEFAULT_RENEW_DEADLINE
    retry_period: float = DEFAULT_RETRY_PERIOD


class LeaderElector:
    def __init__(
        self,
        api: Union[InMemoryAPIServer, KubeAPIServer],
        config: LeaderElectionConfig,
        *,
        on_started_leading: Callable[[threading.Event], None],
        on_stopped_leading: Optional[Callable[[], None]] = None,
        clock: Callable[[], float] = time.time,
        sleep: Callable[[float], None] = time.sleep,
    ):
        self.api = api
        self.config = config
        self.on_started_leading = on_started_leading
        self.on_stopped_leading = on_stopped_leading
        self.clock = clock
        self.sleep = sleep
        self.is_leader = False

    # -- lease plumbing --------------------------------------------------

    def _lease(self) -> Optional[dict]:
        try:
            return self.api.get(
                "leases", self.config.lock_namespace, self.config.lock_name
            )
        except NotFoundError:
            return None

    def _try_acquire_or_renew(self) -> bool:
        now = self.clock()
        lease = self._lease()
        if lease is None:
            try:
                self.api.create(
                    "leases",
                    {
                        "metadata": {
                            "name": self.config.lock_name,
                            "namespace": self.config.lock_namespace,
                        },
                        "spec": {
                            "holderIdentity": self.config.identity,
                            "leaseDurationSeconds": self.config.lease_duration,
                            "acquireTime": now,
                            "renewTime": now,
                        },
                    },
                )
                return True
            except (AlreadyExistsError, ConflictError):
                return False  # lost the creation race; retry next period
        spec = lease.get("spec") or {}
        holder = spec.get("holderIdentity", "")
        renew = float(spec.get("renewTime", 0) or 0)
        duration = float(spec.get("leaseDurationSeconds", self.config.lease_duration))
        if holder != self.config.identity and now < renew + duration:
            return False  # someone else holds a live lease
        spec = dict(spec)
        spec["holderIdentity"] = self.config.identity
        spec["renewTime"] = now
        if holder != self.config.identity:
            spec["acquireTime"] = now
        lease["spec"] = spec
        try:
            self.api.update("leases", lease)
            return True
        except ConflictError:
            return False

    # -- run loop --------------------------------------------------------

    def run(self, stop: threading.Event) -> None:
        """Block until ``stop``; leads whenever the lease is held.

        on_started_leading(stop_leading) runs in a worker thread with an
        event that fires when leadership is lost or stop is set.
        """
        while not stop.is_set():
            if not self._try_acquire_or_renew():
                self.sleep(self.config.retry_period)
                continue
            # Acquired.
            self.is_leader = True
            lost = threading.Event()
            worker = threading.Thread(
                target=self.on_started_leading, args=(lost,), daemon=True
            )
            worker.start()
            deadline = self.clock() + self.config.renew_deadline
            while not stop.is_set():
                if self._try_acquire_or_renew():
                    deadline = self.clock() + self.config.renew_deadline
                elif self.clock() > deadline:
                    break  # failed to renew inside the deadline: step down
                self.sleep(self.config.retry_period)
            self.is_leader = False
            lost.set()
            # Let the previous term's worker finish before any re-acquire,
            # otherwise two terms could reconcile concurrently.
            worker.join(timeout=30)
            if self.on_stopped_leading:
                self.on_stopped_leading()
            if not stop.is_set():
                self.sleep(self.config.retry_period)

    def healthy(self) -> bool:
        """healthz adaptor (server.go:192-208 analog): healthy when not
        leading, or when leading with a fresh-enough lease."""
        if not self.is_leader:
            return True
        lease = self._lease()
        if lease is None:
            return False
        spec = lease.get("spec") or {}
        if spec.get("holderIdentity") != self.config.identity:
            return False
        renew = float(spec.get("renewTime", 0) or 0)
        return self.clock() - renew < self.config.lease_duration
