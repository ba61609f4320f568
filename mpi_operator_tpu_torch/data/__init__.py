"""Input pipeline of the port's trainer (the port's copy of
``mpi_operator_tpu/data``): the stateless Feistel-permutation shuffle
(any step's rows in O(1); resume = a step number), the mmap'd token
dataset with its optional native batch assembler, and a prefetcher that
assembles host batches ahead of the device step.
"""

from .loader import Prefetcher, TokenDataset, write_token_file  # noqa: F401
from .permutation import feistel_permute  # noqa: F401
