"""Static analysis for the port: its control plane and its training steps.

The port's copy of the JAX package's analyzer (families TPU0–TPU4) and
the torch counterpart of its perf-correctness family (TPU5xx), pure
``ast``: it imports neither torch nor JAX. Four layers, one rule
registry:

- :mod:`framework` — ``Finding``/``Rule``/``RepoView`` plumbing, the
  ``# noqa`` contract (rule IDs plus the legacy flake8 aliases), the
  committed-baseline workflow (``analysis/baseline.json``), and the
  per-module call graph (``module_graph``) the TPU5xx rules walk.
- :mod:`rules` — the style tier (TPU001–TPU005), Prometheus naming
  conventions (TPU1xx), control-plane hygiene (TPU2xx), and the
  sole-writer invariants (TPU3xx).
- :mod:`lockcheck` — the lock-discipline checker (TPU4xx): inferred
  attribute guards and the cross-module lock-ordering graph.
- :mod:`torchcheck` — the torch perf-correctness rules (TPU5xx):
  recompiles and re-captures, host syncs on the step path and in the
  loops that drive it, CUDA graphs' static buffers, a second
  params-sized buffer carried through a step, and kernel tile hygiene.

Run it all via ``python -m mpi_operator_tpu_torch.cmd.analyze``; the
runtime counterparts are :mod:`mpi_operator_tpu_torch.runtime.locktrace`
(lock order) and :mod:`mpi_operator_tpu_torch.utils.torchtrace` (builds
and host syncs).
"""
