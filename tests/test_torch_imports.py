"""The port imports nothing of JAX and nothing of the JAX package.

An AST walk over every module of ``mpi_operator_tpu_torch`` and over
``chip_smoke.py``: no ``import``/``from`` of ``jax``, ``flax``,
``optax``, ``orbax`` or ``mpi_operator_tpu`` (the port keeps its own
copies of what it needs), at any depth of the file.
"""

import ast
from pathlib import Path

import pytest

pytestmark = pytest.mark.kernel

ROOT = Path(__file__).resolve().parent.parent
BANNED = {"jax", "jaxlib", "flax", "optax", "orbax", "mpi_operator_tpu"}
FILES = sorted(
    str(p.relative_to(ROOT))
    for p in (ROOT / "mpi_operator_tpu_torch").rglob("*.py")
    if "__pycache__" not in p.parts
) + ["chip_smoke.py"]


def _imported_roots(tree: ast.AST):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, (node.module or "").split(".")[0]


def test_port_has_modules():
    assert len(FILES) > 10
    assert "mpi_operator_tpu_torch/ops/attention.py" in FILES


@pytest.mark.parametrize("rel", FILES)
def test_no_jax_imports(rel):
    tree = ast.parse((ROOT / rel).read_text(), filename=rel)
    bad = [(line, mod) for line, mod in _imported_roots(tree)
           if mod in BANNED]
    assert not bad, f"{rel} imports {bad}"
