"""The benchmark's tests: ``card`` marks those that need a CUDA device;
they skip inside the ``card`` fixture, never while a module is imported.

    python -m pytest perfbench/tests -q                    # CPU: the rest
    python3 -m pytest perfbench/tests -q -m card --confcutdir=perfbench

(on the chip, whose machine has no JAX: ``--confcutdir`` keeps the
repository's root conftest, which imports JAX, from loading).
"""

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA device (the H100); skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the check at a cell's own size "
                    "runs only on the chip")
    return torch.device("cuda", 0)
