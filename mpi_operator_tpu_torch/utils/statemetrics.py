"""kube-state-metrics-style gauges computed at scrape time.

Push-model metrics (the controller's counters) say what the operator
*did*; state metrics say what the world currently *looks like*.  In the
kube-state-metrics idiom every series is derived from watched object
state — ``_info`` gauges carry identity as labels with a constant value
of 1, ``by_phase`` gauges count objects per lifecycle phase — and here
they are recomputed on every scrape from the informer caches via
``Registry.on_scrape``: no bookkeeping on the reconcile path, no stale
series after deletes, never ahead of (or behind) what the informers have
actually observed.
"""

from __future__ import annotations

from ..api.v2beta1 import constants
from . import metrics

# TPUJob lifecycle phases, derived from status conditions with terminal
# states taking precedence (kube-state-metrics derives Job/Pod phase the
# same way: latest decisive condition wins).
JOB_PHASES = (
    "Pending",
    "Created",
    "Running",
    "Restarting",
    "Suspended",
    "Succeeded",
    "Failed",
)

POD_PHASES = ("Pending", "Running", "Succeeded", "Failed", "Unknown")

# Condition precedence for phase derivation, most decisive first.
_PHASE_PRECEDENCE = (
    ("Succeeded", "Succeeded"),
    ("Failed", "Failed"),
    ("Suspended", "Suspended"),
    ("Restarting", "Restarting"),
    ("Running", "Running"),
    ("Created", "Created"),
)


def job_phase(job: dict) -> str:
    """One phase per job: the most decisive condition with status True.
    A job with no conditions yet (created but not reconciled) is
    Pending."""
    held = {
        c.get("type"): c.get("status")
        for c in ((job.get("status") or {}).get("conditions") or [])
    }
    for cond_type, phase in _PHASE_PRECEDENCE:
        if held.get(cond_type) == "True":
            return phase
    return "Pending"


class StateMetrics:
    """Registers the state-metric family and recomputes it per scrape.

    ``job_lister``/``pod_lister`` are informer listers (deep-copied cache
    reads), so a scrape observes exactly the informer's view — the same
    view the reconciler acts on.
    """

    def __init__(self, registry, job_lister, pod_lister):
        self._job_lister = job_lister
        self._pod_lister = pod_lister
        self.job_info = metrics.new_gauge(
            "tpu_operator_job_info",
            "Identity of each TPUJob known to the informer cache (value 1)",
            ("namespace", "tpujob", "launcher", "accelerator_type",
             "num_slices", "queue"),
            registry,
        )
        self.jobs_by_phase = metrics.new_gauge(
            "tpu_operator_jobs_by_phase",
            "TPUJobs in the informer cache by derived lifecycle phase",
            ("phase",),
            registry,
        )
        self.pods_by_phase = metrics.new_gauge(
            "tpu_operator_pods_by_phase",
            "Pods in the informer cache by status phase",
            ("phase",),
            registry,
        )
        self.job_condition = metrics.new_gauge(
            "tpu_operator_job_condition",
            "TPUJob status conditions (1 = True, 0 = False/Unknown)",
            ("namespace", "tpujob", "type"),
            registry,
        )
        registry.on_scrape(self.collect)

    def collect(self) -> None:
        """Full recompute: drop every series, then re-derive from the
        caches.  remove_matching() with an empty prefix clears all label
        sets, so deleted objects can never leave stale series behind."""
        jobs = self._job_lister.list()

        self.job_info.remove_matching()
        self.job_condition.remove_matching()
        job_counts = {phase: 0 for phase in JOB_PHASES}
        for job in jobs:
            meta = job.get("metadata") or {}
            ns = meta.get("namespace", "")
            name = meta.get("name", "")
            spec = job.get("spec") or {}
            tpu = spec.get("tpu") or {}
            has_launcher = "Launcher" in (spec.get("tpuReplicaSpecs") or {})
            scheduling = (
                (spec.get("runPolicy") or {}).get("schedulingPolicy") or {}
            )
            self.job_info.set(
                1.0,
                ns,
                name,
                (name + constants.LAUNCHER_SUFFIX) if has_launcher else "",
                tpu.get("acceleratorType", ""),
                str(tpu.get("numSlices", 1)),
                scheduling.get("queue", ""),
            )
            phase = job_phase(job)
            job_counts[phase] = job_counts.get(phase, 0) + 1
            for cond in (job.get("status") or {}).get("conditions") or []:
                self.job_condition.set(
                    1.0 if cond.get("status") == "True" else 0.0,
                    ns,
                    name,
                    cond.get("type", ""),
                )
        for phase in JOB_PHASES:
            self.jobs_by_phase.set(float(job_counts.get(phase, 0)), phase)

        pod_counts = {phase: 0 for phase in POD_PHASES}
        for phase, count in self._pod_phase_counts().items():
            if phase not in pod_counts:
                phase = "Unknown"
            pod_counts[phase] += count
        for phase in POD_PHASES:
            self.pods_by_phase.set(float(pod_counts.get(phase, 0)), phase)

    def _pod_phase_counts(self) -> dict[str, int]:
        """Phase counts via the informer's phase index when the lister
        has one (O(phases), no copies); full-scan fallback keeps plain
        list-backed listers (kube backend REST lister) working."""
        if hasattr(self._pod_lister, "index_counts"):
            return self._pod_lister.index_counts("phase")
        counts: dict[str, int] = {}
        for pod in self._pod_lister.list():
            phase = (pod.get("status") or {}).get("phase") or "Pending"
            counts[phase] = counts.get(phase, 0) + 1
        return counts
