"""PyTorch/CUDA port of the TPU-job trainer (``mpi_operator_tpu``).

The JAX package stays the reference; this package mirrors its layout
(``ops/``, ``models/``, ``parallel/``, ``launcher/``, ``cmd/``,
``utils/``, ``api/``) so each module's counterpart is easy to find. It
imports ``torch`` and never ``jax`` or anything of the JAX package: what
it needs from there it keeps as its own copy.

The attention kernels are CUDA C++ for Hopper (``csrc/``), built with
``nvcc`` at first use into the git-ignored ``_build/`` directory. Entry
points run on ``cuda`` unless the caller asks for the CPU, where every
kernel wrapper takes its plain PyTorch version instead.
"""
