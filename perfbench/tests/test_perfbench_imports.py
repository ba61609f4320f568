"""Nothing the harness runs loads JAX, flax or the JAX package (top-level
names compared whole: the port's name begins with the JAX package's),
and the reference, the check and the yardstick load nothing of the
port."""

import subprocess
import sys

from perfbench import spec

RUN = """
import time, torch
from perfbench import run
from perfbench.tests import tiny
r = run.execute(tiny.cell("mixtral"), 5, 0.2, True, torch.device("cpu"),
                t0=time.perf_counter())
assert r["correct"], r
print(run.forbidden_modules())
"""

PLAIN = """
import sys
import perfbench.check, perfbench.weights, perfbench.tokens, perfbench.spec
import perfbench.reference.common, perfbench.reference.train
import perfbench.reference.mixtral, perfbench.reference.bert
import perfbench.flops.mixtral, perfbench.flops.bert, perfbench.flops.attention
print(sorted({m.split(".")[0] for m in sys.modules}
             & {"jax", "jaxlib", "flax", "mpi_operator_tpu",
                "mpi_operator_tpu_torch"}))
"""


def _python(code):
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=spec.ROOT.parent, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    return out.stdout.strip().splitlines()[-1]


def test_run_loads_no_jax():
    assert _python(RUN) == "[]"


def test_reference_loads_nothing_of_the_program():
    assert _python(PLAIN) == "[]"


def test_forbidden_names_compared_whole(monkeypatch):
    from perfbench import run

    for name in [m for m in sys.modules if m.split(".")[0] in run.FORBIDDEN]:
        monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "mpi_operator_tpu_torch.x", sys)
    monkeypatch.setitem(sys.modules, "jaxtyping", sys)
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "mpi_operator_tpu.models", sys)
    assert run.forbidden_modules() == ["mpi_operator_tpu"]
