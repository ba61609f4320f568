"""Static analysis for the port's operator control plane.

The port's copy of the JAX package's analyzer (families TPU0–TPU4),
pure ``ast``: it imports neither torch nor JAX. Three layers, one rule
registry:

- :mod:`framework` — ``Finding``/``Rule``/``RepoView`` plumbing, the
  ``# noqa`` contract (rule IDs plus the legacy flake8 aliases), and
  the committed-baseline workflow (``analysis/baseline.json``).
- :mod:`rules` — the style tier (TPU001–TPU005), Prometheus naming
  conventions (TPU1xx), control-plane hygiene (TPU2xx), and the
  sole-writer invariants (TPU3xx).
- :mod:`lockcheck` — the lock-discipline checker (TPU4xx): inferred
  attribute guards and the cross-module lock-ordering graph.

Run it all via ``python -m mpi_operator_tpu_torch.cmd.analyze``; the
runtime counterpart is :mod:`mpi_operator_tpu_torch.runtime.locktrace`.
"""
