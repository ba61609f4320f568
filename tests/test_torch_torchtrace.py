"""The port's build/sync tracer (``utils/torchtrace.py``), the counterpart
of ``tests/test_jaxtrace.py``: zero cost when off, arming by
``TPU_JAX_TRACE`` in a subprocess, kernel builds and loads counted at the
warmup boundary, device-to-host syncs counted with their bytes and
attributed to the calling line, the JAX tracer's report schema, and the
trainer's summary carrying the report under the JAX key.

There is no card here, so a CUDA tensor is stood in for by a subclass
whose ``is_cuda`` is true: the tracer counts by that flag, and the real
count is checked against ``torch.cuda.set_sync_debug_mode`` on the card
(``chip_smoke.py``'s observe phase).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from mpi_operator_tpu_torch.ops import _build
from mpi_operator_tpu_torch.utils import torchtrace

pytestmark = pytest.mark.kernel

REPO_ROOT = Path(__file__).resolve().parents[1]


class OnCard(torch.Tensor):
    """A CPU tensor that reports itself as a CUDA one."""

    @property
    def is_cuda(self):
        return True


def on_card(t: torch.Tensor) -> torch.Tensor:
    return torch.Tensor._make_subclass(OnCard, t)


@pytest.fixture
def tracer():
    t = torchtrace.enable()
    try:
        yield t
    finally:
        torchtrace.disable()


def _probe(env: dict) -> dict:
    code = (
        "import json, torch\n"
        "from mpi_operator_tpu_torch.utils import torchtrace\n"
        "from mpi_operator_tpu_torch.ops import _build\n"
        "print(json.dumps({'enabled': torchtrace.enabled(),\n"
        "  'hook': _build.load_hook is not None,\n"
        "  'item': type(torch.Tensor.item).__name__}))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO_ROOT,
                          capture_output=True, text=True, env=env,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_env_arms_the_tracer_in_a_subprocess():
    base = {k: v for k, v in os.environ.items() if k != torchtrace.ENV_FLAG}
    armed = _probe({**base, torchtrace.ENV_FLAG: "1"})
    assert armed == {"enabled": True, "hook": True, "item": "function"}
    for off in ("", "0", "off"):
        assert _probe({**base, torchtrace.ENV_FLAG: off}) == {
            "enabled": False, "hook": False, "item": "method_descriptor"}


def test_off_by_default_and_module_notes_are_noops():
    assert not torchtrace.enabled() and torchtrace.tracer() is None
    torchtrace.note_step()
    torchtrace.note_warmup_complete()
    _build._report("load", "flash_fwd", 0.1)  # no tracer: nothing to do


def test_a_disabled_tracer_counts_nothing():
    t = torchtrace.enable()
    torchtrace.disable()
    on_card(torch.ones(3)).sum().item()
    _build._report("build", "flash_fwd", 1.0)
    assert t.report()["transfers"]["count"] == 0
    assert t.report()["compiles"]["total"] == 0


def test_builds_and_loads_split_at_the_warmup_boundary(tracer):
    _build._report("build", "flash_fwd", 9.5)
    _build._report("load", "flash_fwd", 0.25)
    tracer.note_warmup_complete()
    for _ in range(3):
        tracer.note_step()
    r = tracer.report()
    assert r["compiles"] == {"total": 2, "seconds": 9.75, "after_warmup": 0,
                             "sites": []}
    assert r["steps_after_warmup"] == 3
    # A kernel first loaded mid-run is the regression the tracer names,
    # with the stack that asked for it.
    _build._report("load", "bn_stats", 0.5)
    r = tracer.report()
    assert r["compiles"]["after_warmup"] == 1
    (site,) = r["compiles"]["sites"]
    assert site["kernel"] == "load bn_stats" and site["seconds"] == 0.5
    assert any("test_torch_torchtrace.py" in f for f in site["stack"])


def test_syncs_count_bytes_and_the_calling_line(tracer):
    x = on_card(torch.arange(16, dtype=torch.float32))
    x[0].item()                     # before warmup: 4 bytes
    tracer.note_warmup_complete()
    tracer.note_step()
    float(x[1])                     # 4 bytes
    x.tolist()                      # 64 bytes
    x.cpu()                         # 64 bytes
    bool(x[2] > 0)                  # 1 byte
    int(x[3])                       # 4 bytes
    torch.ones(4).sum().item()      # a CPU tensor moves nothing
    r = tracer.report()["transfers"]
    assert r["count"] == 6 and r["bytes"] == 4 + 4 + 64 + 64 + 1 + 4
    assert r["after_warmup_count"] == 5
    assert r["after_warmup_bytes"] == 137
    sites = r["top_sites"]
    assert sum(sites.values()) == 6
    assert all("test_torch_torchtrace.py:" in site for site in sites)
    assert tracer.report()["transfer_bytes_per_step"] == 137.0


def test_report_schema_is_the_jax_tracers():
    from mpi_operator_tpu.utils import jaxtrace

    want = jaxtrace.JaxTracer().report()
    got = torchtrace.TorchTracer().report()
    assert set(got) == set(want)
    for key in ("compiles", "transfers"):
        assert set(got[key]) == set(want[key])
    assert torchtrace.ENV_FLAG == jaxtrace.ENV_FLAG


def test_trainer_summary_carries_the_report(tracer, capsys):
    from mpi_operator_tpu_torch.cmd import train

    rc = train.main(["--device", "cpu", "--model", "llama-tiny", "--steps",
                     "4", "--warmup", "1", "--seq-len", "16",
                     "--global-batch", "4", "--telemetry-every", "0",
                     "--log-every", "0"])
    assert rc == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    report = summary["jax_trace"]
    assert report["steps_after_warmup"] == 3
    # The CPU path loads no kernel and syncs nothing from a card.
    assert report["compiles"]["after_warmup"] == 0
    assert report["transfers"]["count"] == 0
