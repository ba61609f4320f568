"""In-process Kueue analog: multi-tenant GPU quota and admission queueing
(the port's copy of ``mpi_operator_tpu/queue/``).

TPUJobs that name a LocalQueue (``spec.runPolicy.schedulingPolicy.queue``)
are created suspended and admitted by the QueueManager flipping
``runPolicy.suspend`` once GPU quota is reserved in their ClusterQueue —
the same suspend-based handshake the reference operator delegates to
sigs.k8s.io/kueue.

- quota.py   — GPU-denominated usage ledger (``nvidia.com/gpu`` per
               generation, ``h100``) with cohort borrowing and reclaim
               accounting (release-then-reserve discipline, like
               scheduler/cache.py).
- manager.py — the QueueManager controller: watches TPUJobs + queues,
               admits priority-then-FIFO, evicts borrowers on reclaim.

``bootstrap_queues`` takes ``cmd.operator``'s ``--cluster-queue`` values,
``name[@cohort]:h100=<gpus>``. The QueueManager is the single writer of
``suspend`` while enabled.
"""

from .manager import QueueManager, bootstrap_queues, parse_cluster_queue_spec  # noqa: F401
from .quota import QuotaLedger, insufficient_quota_message  # noqa: F401
