"""GPU-denominated quota ledger for ClusterQueues (the port's copy of
``mpi_operator_tpu/queue/quota.py``).

Kueue's cache/quota bookkeeping (sigs.k8s.io/kueue ClusterQueue usage,
flavor borrowing) collapsed to the one dimension GPU fleets ration:
``nvidia.com/gpu``, partitioned by GPU generation (``h100``). The
arithmetic is the JAX package's unchanged; only the unit differs, so a
``chips`` count below is a count of GPUs.  One Charge per
admitted workload; the ledger answers "does this workload fit" under
cohort borrowing rules and names the youngest borrowers to evict when a
lender wants its nominal quota back.

Discipline mirrors scheduler/cache.py: ``reserve`` releases any prior
charge for the same key first (re-reserve replaces, never stacks),
``release`` is idempotent, and ``reconcile`` rebuilds the whole ledger
from observed truth.  The invariant — usage always equals the sum of
live charges, never negative, never double-freed — is property-tested in
tests/test_queue.py and held against the JAX package's ledger in
tests/test_torch_queue.py.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ..runtime import locktrace
from typing import Dict, Iterable, List, Optional, Tuple

# (namespace, name) of the admitted TPUJob.
JobKey = Tuple[str, str]

# The extended resource a quota counts (one per worker pod,
# controller/builders.py).
GPU_RESOURCE = "nvidia.com/gpu"


def insufficient_quota_message(queue: str, generation: str, chips: int,
                               free: int) -> str:
    """The kube-style admission failure message (Kueue wording), in GPUs."""
    return (
        f"insufficient quota in ClusterQueue {queue}: needs {chips} "
        f"{GPU_RESOURCE} ({generation}), {free} free"
    )


@dataclass(frozen=True)
class QueueQuota:
    """One ClusterQueue's quota for one generation."""

    nominal: int = 0
    borrowing_limit: Optional[int] = None  # None = unbounded borrowing


@dataclass(frozen=True)
class Charge:
    """GPUs one admitted workload holds against one ClusterQueue."""

    queue: str
    generation: str
    chips: int
    admitted_at: float = 0.0


@dataclass
class _QueueEntry:
    cohort: str = ""
    quotas: Dict[str, QueueQuota] = field(default_factory=dict)


class QuotaLedger:
    """Usage accounting for a set of ClusterQueues, cohort-aware."""

    def __init__(self):
        self._lock = locktrace.rlock("queue.quota")
        self._queues: Dict[str, _QueueEntry] = {}
        self._charges: Dict[JobKey, Charge] = {}
        # (queue, generation) -> admitted GPUs, kept incrementally.
        self._usage: Dict[Tuple[str, str], int] = {}

    # -- queue topology --------------------------------------------------

    def set_queue(self, name: str, cohort: str = "",
                  quotas: Optional[Dict[str, QueueQuota]] = None) -> None:
        with self._lock:
            self._queues[name] = _QueueEntry(cohort=cohort,
                                             quotas=dict(quotas or {}))

    def remove_queue(self, name: str) -> None:
        """Drop a queue and every charge held against it (cache.remove_node
        analog: charges leave with their queue, usage never dangles)."""
        with self._lock:
            self._queues.pop(name, None)
            for key in [k for k, c in self._charges.items()
                        if c.queue == name]:
                self.release(key)

    def queues(self) -> List[str]:
        with self._lock:
            return sorted(self._queues)

    def cohort_of(self, queue: str) -> str:
        with self._lock:
            entry = self._queues.get(queue)
            return entry.cohort if entry else ""

    def _cohort_members(self, queue: str) -> List[str]:
        entry = self._queues.get(queue)
        if entry is None or not entry.cohort:
            return [queue]
        return [n for n, e in self._queues.items() if e.cohort == entry.cohort]

    # -- accounting ------------------------------------------------------

    def nominal(self, queue: str, generation: str) -> int:
        with self._lock:
            entry = self._queues.get(queue)
            if entry is None:
                return 0
            quota = entry.quotas.get(generation)
            return quota.nominal if quota else 0

    def usage(self, queue: str, generation: str) -> int:
        with self._lock:
            return self._usage.get((queue, generation), 0)

    def usage_by_generation(self, queue: str) -> Dict[str, int]:
        with self._lock:
            return {
                gen: chips
                for (q, gen), chips in sorted(self._usage.items())
                if q == queue and chips
            }

    def borrowed(self, queue: str, generation: str) -> int:
        """GPUs this queue holds beyond its nominal quota."""
        with self._lock:
            return max(
                0, self.usage(queue, generation) - self.nominal(queue, generation)
            )

    def charge_of(self, key: JobKey) -> Optional[Charge]:
        with self._lock:
            return self._charges.get(key)

    def charges(self) -> Dict[JobKey, Charge]:
        with self._lock:
            return dict(self._charges)

    # -- admission arithmetic --------------------------------------------

    def free(self, queue: str, generation: str) -> int:
        """GPUs this queue could still admit for ``generation``: its own
        nominal headroom plus whatever the cohort has left to lend,
        capped by the queue's borrowingLimit."""
        with self._lock:
            entry = self._queues.get(queue)
            if entry is None:
                return 0
            quota = entry.quotas.get(generation)
            if quota is None:
                return 0
            used = self.usage(queue, generation)
            if not entry.cohort:
                return max(0, quota.nominal - used)
            members = self._cohort_members(queue)
            cohort_nominal = sum(self.nominal(m, generation) for m in members)
            cohort_used = sum(self.usage(m, generation) for m in members)
            slack = max(0, cohort_nominal - cohort_used)
            # A borrowingLimit caps total usage at nominal + limit.
            if quota.borrowing_limit is not None:
                cap = quota.nominal + quota.borrowing_limit - used
                slack = min(slack, max(0, cap))
            return slack

    def fits(self, queue: str, generation: str, chips: int) -> Tuple[bool, int]:
        """(does a ``chips``-GPU workload fit now, free GPUs)."""
        with self._lock:
            free = self.free(queue, generation)
            return chips <= free, free

    def reserve(self, key: JobKey, queue: str, generation: str, chips: int,
                admitted_at: float = 0.0) -> None:
        """Charge ``chips`` against ``queue``. Releases any prior charge
        for ``key`` first (re-reserve replaces, never stacks); raises
        RuntimeError with the admission-failure message when the
        workload does not fit."""
        with self._lock:
            self.release(key)
            ok, free = self.fits(queue, generation, chips)
            if not ok:
                raise RuntimeError(
                    insufficient_quota_message(queue, generation, chips, free)
                )
            self._charges[key] = Charge(queue, generation, chips, admitted_at)
            slot = (queue, generation)
            self._usage[slot] = self._usage.get(slot, 0) + chips

    def release(self, key: JobKey) -> None:
        """Return ``key``'s GPUs. Idempotent — releasing an uncharged key
        is a no-op, so completion + eviction racing never double-frees."""
        with self._lock:
            charge = self._charges.pop(key, None)
            if charge is None:
                return
            slot = (charge.queue, charge.generation)
            remaining = self._usage.get(slot, 0) - charge.chips
            if remaining > 0:
                self._usage[slot] = remaining
            else:
                self._usage.pop(slot, None)

    # -- reclaim ---------------------------------------------------------

    def reclaim_candidates(self, lender: str, generation: str,
                           chips: int) -> Optional[List[JobKey]]:
        """Which borrowers to evict so a ``chips``-sized workload fits in
        ``lender`` — Kueue's reclaimWithinCohort move.  Victims are the
        globally youngest charges (largest admitted_at) in cohort queues
        that are over their nominal quota; each simulated eviction stops
        charging its queue once that queue is back under nominal.
        Returns None when even evicting every borrower cannot make the
        workload fit (so callers evict nobody for nothing)."""
        with self._lock:
            entry = self._queues.get(lender)
            if entry is None or not entry.cohort:
                return None
            # Reclaim serves the lender's *nominal* entitlement only: a
            # workload that itself needs to borrow cannot evict others.
            if self.usage(lender, generation) + chips > self.nominal(
                lender, generation
            ):
                return None
            members = set(self._cohort_members(lender))
            sim_usage = {
                m: self.usage(m, generation) for m in members
            }
            borrowers = sorted(
                (
                    (key, charge)
                    for key, charge in self._charges.items()
                    if charge.queue in members and charge.queue != lender
                    and charge.generation == generation
                ),
                key=lambda kv: (-kv[1].admitted_at, kv[0]),
            )
            victims: List[JobKey] = []
            for key, charge in borrowers:
                free = self.free(lender, generation)
                if chips <= free:
                    break
                # Only charges keeping their queue over nominal are
                # borrowed quota; evicting within nominal reclaims nothing.
                if sim_usage[charge.queue] <= self.nominal(
                    charge.queue, generation
                ):
                    continue
                victims.append(key)
                sim_usage[charge.queue] -= charge.chips
                # free() sees live usage; model the eviction by charging
                # the simulated release against the real ledger copy.
                self._usage[(charge.queue, generation)] = max(
                    0, self._usage.get((charge.queue, generation), 0)
                    - charge.chips
                )
            fits_now = chips <= self.free(lender, generation)
            # Undo the simulation.
            for key in victims:
                charge = self._charges[key]
                slot = (charge.queue, generation)
                self._usage[slot] = self._usage.get(slot, 0) + charge.chips
            if not fits_now:
                return None
            return victims

    # -- rebuild ---------------------------------------------------------

    def reconcile(self, charges: Iterable[Tuple[JobKey, Charge]]) -> None:
        """Full rebuild from observed truth (cache.reconcile analog):
        every pass starts from what the API server actually admits, so
        drift between manager restarts cannot leak chips."""
        with self._lock:
            self._charges = {}
            self._usage = {}
            for key, charge in charges:
                if charge.queue not in self._queues:
                    continue
                self._charges[key] = charge
                slot = (charge.queue, charge.generation)
                self._usage[slot] = self._usage.get(slot, 0) + charge.chips
