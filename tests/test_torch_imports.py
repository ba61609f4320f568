"""The port imports nothing of JAX and nothing of the JAX package.

An AST walk over every module of ``mpi_operator_tpu_torch`` and over
``chip_smoke.py``: no ``import``/``from`` of ``jax``, ``flax``,
``optax``, ``orbax`` or ``mpi_operator_tpu`` (the port keeps its own
copies of what it needs), at any depth of the file. And a subprocess
check that the port's control plane imports no ``torch`` either.
"""

import ast
import subprocess
import sys
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
    assert "mpi_operator_tpu_torch/ops/ulysses.py" in FILES
    assert "mpi_operator_tpu_torch/parallel/pipeline.py" in FILES
    assert "mpi_operator_tpu_torch/models/llama_pp.py" in FILES
    assert "mpi_operator_tpu_torch/entry.py" in FILES


def test_the_pipeline_modules_import_and_nothing_waits_for_item_16():
    """The pipeline is ported: its modules import, and no refusal of the
    port names the ROADMAP.md item that brought it."""
    from mpi_operator_tpu_torch.models import llama_pp
    from mpi_operator_tpu_torch.parallel import pipeline

    assert callable(pipeline.pipeline) and callable(llama_pp.forward_backward)
    for rel in FILES:
        assert "item 16" not in (ROOT / rel).read_text(), rel


@pytest.mark.parametrize("item", ["4", "14"])
def test_nothing_waits_for_sharded_decoding_or_dots(item):
    """Sharded decoding (item 14) and ``--remat-policy dots`` (item 4) are
    ported: no refusal of the port names either item."""
    import re

    from mpi_operator_tpu_torch.models import generate
    from mpi_operator_tpu_torch.models import llama

    assert callable(generate.DecodeShards.of)
    assert callable(llama.remat_policy_for("dots"))
    for rel in FILES:
        text = (ROOT / rel).read_text()
        assert not re.search(rf"item {item}\b", text), rel


@pytest.mark.parametrize("rel", FILES)
def test_no_jax_imports(rel):
    tree = ast.parse((ROOT / rel).read_text(), filename=rel)
    bad = [(line, mod) for line, mod in _imported_roots(tree)
           if mod in BANNED]
    assert not bad, f"{rel} imports {bad}"


CONTROL_PLANE = (
    "mpi_operator_tpu_torch.controller.tpu_job_controller",
    "mpi_operator_tpu_torch.scheduler.core",
    "mpi_operator_tpu_torch.runtime.podrunner",
    "mpi_operator_tpu_torch.cmd.operator",
    "mpi_operator_tpu_torch.queue.manager",
    "mpi_operator_tpu_torch.chaos.engine",
    "mpi_operator_tpu_torch.chaos.podchaos",
    "mpi_operator_tpu_torch.utils.devstats",
    "mpi_operator_tpu_torch.runtime.kube",
    "mpi_operator_tpu_torch.runtime.httpserver",
    "mpi_operator_tpu_torch.cmd.gen_manifests",
    "mpi_operator_tpu_torch.cmd.bench_straggler",
    "mpi_operator_tpu_torch.cmd.bench_memory",
    "mpi_operator_tpu_torch.cmd.bench_controlplane",
    "mpi_operator_tpu_torch.cmd.bench_goodput",
    "mpi_operator_tpu_torch.analysis.framework",
    "mpi_operator_tpu_torch.analysis.rules",
    "mpi_operator_tpu_torch.analysis.lockcheck",
    "mpi_operator_tpu_torch.analysis.torchcheck",
    "mpi_operator_tpu_torch.cmd.analyze",
    "mpi_operator_tpu_torch.utils.env",
)


def test_control_plane_leaves_torch_and_jax_unloaded():
    """The operator process pays for no torch import (only its worker
    processes do), as the JAX package's control plane imports no JAX."""
    code = (
        "import sys\n"
        + "".join(f"import {m}\n" for m in CONTROL_PLANE)
        + "print(sorted({m.split('.')[0] for m in sys.modules} & "
        "{'torch', 'jax', 'jaxlib', 'mpi_operator_tpu'}))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "[]"
