"""The readers of the program's own ranges and counters (``spans.py``)
and the idle diagnostic (``idle.py``): parts charged to their ranges
with the remat recompute moved out of the backward parts around it, the
step phases taken from any thread, idle gaps charged where the host
launched the operation that ended them, readings against a program
without the ranges, and a traced tiny cell through ``run.py``."""

import json
import subprocess
import sys

import pytest

from perfbench import idle, spans, spec

MAIN, AUTOGRAD = 1, 2

# (name, parent, thread, start_ns, host_s, device_s): the main thread
# runs a forward (a cast inside a norm) and waits in the backward while
# autograd's thread runs norm.bwd, with a remat recompute of the cast and
# the cast's own backward inside it; then a wait for data, and the next
# step's forward with a cast still open.
RECORDS = [
    ("step.forward", -1, MAIN, 0, 100e-9, 10.0),
    ("norm", 0, MAIN, 10, 50e-9, 5.0),
    ("cast", 1, MAIN, 20, 10e-9, 2.0),
    ("step.backward", -1, MAIN, 100, 200e-9, 30.0),
    ("norm.bwd", -1, AUTOGRAD, 150, 100e-9, 12.0),
    ("cast", 4, AUTOGRAD, 205, 10e-9, 3.0),
    ("cast.bwd", 4, AUTOGRAD, 220, 10e-9, 1.0),
    ("data.wait", -1, MAIN, 310, 20e-9, 0.5),
    ("step.forward", -1, MAIN, 340, 10e-9, 4.0),
    ("cast", 8, MAIN, 345, None, None),
]


def test_parts_are_charged_to_their_ranges():
    ranges, host, paths = spans.reduce_spans(RECORDS)
    # norm.bwd less the recompute inside it; cast.bwd is not recompute.
    assert ranges == {"step.forward": 14.0, "norm": 14.0, "cast": 6.0,
                      "step.backward": 30.0, "data.wait": 0.5}
    assert host["data.wait"] == pytest.approx(20e-9)
    assert dict(paths) == {
        ("step.forward",): 9.0,
        ("step.forward", "norm"): 3.0,
        ("step.forward", "norm", "cast"): 2.0,
        ("step.backward",): 18.0,  # autograd's thread's parts inside it
        ("step.backward", "norm.bwd"): 8.0,
        ("step.backward", "norm.bwd", "cast"): 3.0,
        ("step.backward", "norm.bwd", "cast.bwd"): 1.0,
        ("data.wait",): 0.5,
        ("step.forward", "cast"): 0.0,
    }
    assert paths[0] == (("step.backward",), 18.0)


def test_host_time_stands_in_without_device_events():
    host_only = [r[:5] + (None,) for r in RECORDS]
    ranges, _, _ = spans.reduce_spans(host_only)
    assert ranges["step.forward"] == pytest.approx(110e-9)
    assert ranges["norm"] == pytest.approx(50e-9 + 100e-9 - 10e-9)


class _Run:
    steps = 4


NEW = ["forward_ms", "backward_ms", "cast_ms", "norm_ms", "head_ms",
       "moe_route_ms", "moe_dispatch_ms", "moe_expert_ms",
       "moe_dropped_share", "prefetch_wait_ms", "host_syncs_per_step"]


@pytest.mark.parametrize("metric", NEW)
def test_readers_read_nothing_of_a_program_without_ranges(monkeypatch,
                                                          metric):
    from mpi_operator_tpu_torch.utils import torchtrace

    monkeypatch.delattr(torchtrace, "spans")
    monkeypatch.setattr(spans, "_read", {})
    assert spec.reader(metric).read(_Run()) is None


def test_range_ms_per_step(monkeypatch):
    p = spans.Program(*spans.reduce_spans(RECORDS), {}, 0, [])
    run = _Run()
    monkeypatch.setattr(spans, "_read", {id(run): p})
    assert spans.range_ms(run, "cast", "norm") == pytest.approx(1e3 * 20 / 4)
    assert spans.range_ms(run, "moe.route") is None


# Times in ns. The same step as RECORDS, as the profiler sees it: the
# ranges on their threads, the launches, the device's operations.
ANN = {
    MAIN: [(0, 100, "step.forward"), (10, 60, "norm"), (20, 30, "cast"),
           (100, 300, "step.backward"), (300, 320, "data.wait"),
           (340, 350, "step.forward")],
    AUTOGRAD: [(150, 250, "norm.bwd"), (205, 215, "cast")],
}
LAUNCHES = {1: (MAIN, 25), 2: (MAIN, 50), 3: (MAIN, 80), 4: (AUTOGRAD, 160),
            8: (AUTOGRAD, 210), 5: (AUTOGRAD, 260), 6: (MAIN, 330),
            9: (MAIN, 400)}
DEVICE = [  # (start, end, correlation)
    (30, 40, 1),     # idle before it: none
    (60, 70, 2),     # idle 40-60: launched inside norm
    (90, 100, 3),    # idle 70-90: step.forward alone
    (170, 200, 4),   # idle 100-170: norm.bwd
    (200, 205, 8),   # no idle
    (270, 280, 5),   # idle 205-270: step.backward, from autograd's thread
    (400, 410, 6),   # idle 280-400: launched between the steps
    (410, 420, 7),   # no launch recorded; no idle
    (500, 510, 9),   # launched after the last step: the harness's own
]


def test_idle_gaps_are_charged_where_the_host_launched():
    out = idle.idle_by_range(ANN, LAUNCHES, DEVICE)
    assert dict(out["idle_by_range"]) == {
        "norm": pytest.approx(20e-9), "step.forward": pytest.approx(20e-9),
        "norm.bwd": pytest.approx(70e-9),
        "step.backward": pytest.approx(65e-9),
        "outside": pytest.approx(120e-9)}
    assert out["idle_by_range"][0][0] == "outside"
    assert out["idle_s"] == pytest.approx(295e-9)
    assert out["busy_s"] == pytest.approx(105e-9)


TRACED = """
import json, torch
from perfbench import run
from perfbench.tests import tiny
for traced in (True, False):
    r = run.execute(tiny.cell("mixtral"), 2**31 + 5, 0.3, traced,
                    torch.device("cpu"))
    print(json.dumps(r["metrics"]))
"""


def test_a_traced_tiny_cell_reads_the_program():
    out = subprocess.run([sys.executable, "-c", TRACED], capture_output=True,
                         text=True, cwd=spec.ROOT.parent, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    traced, untraced = (json.loads(line) for line in
                        out.stdout.strip().splitlines()[-2:])
    for name in NEW:
        assert traced[name]["value"] >= 0, name
    assert traced["host_syncs_per_step"]["value"] == 0
    assert 0 < traced["moe_dropped_share"]["value"] < 100
    assert traced["backward_ms"]["value"] > traced["moe_expert_ms"]["value"]
    assert not set(NEW) & set(untraced)
    assert "spans: kernel builds or loads in the window: 0" in out.stderr
