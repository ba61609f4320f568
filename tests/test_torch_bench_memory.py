"""The port's device-memory bench (``cmd/bench_memory.py``) against the
JAX package's (the root ``bench_memory.py``).

The port's ``h100-4`` gang (four worker pods, one GPU each) mirrors the
JAX ``v5e-16`` slice's four hosts and both run on a simulated clock from
one seed, so the same arguments write the same document byte for byte.
Then the port's copies of the JAX bench's tier-1 checks
(``tests/test_devstats.py::TestBenchMemorySmoke``) and its
``--lock-trace`` gate.
"""

import copy
import json

import pytest

import bench_memory as jax_bench
from mpi_operator_tpu.utils import logging as jax_logutil
from mpi_operator_tpu_torch.cmd import bench_memory as bench
from mpi_operator_tpu_torch.runtime import locktrace
from mpi_operator_tpu_torch.utils import devstats
from mpi_operator_tpu_torch.utils import logging as logutil

pytestmark = pytest.mark.kernel


@pytest.fixture(autouse=True)
def quiet_logs():
    """Each bench's main() sets its package's log level to warning: hold
    both there for the test and put them back after."""
    prev = (logutil.configure(level="warning"),
            jax_logutil.configure(level="warning"))
    yield
    logutil.configure(**prev[0])
    jax_logutil.configure(**prev[1])


def test_document_equals_the_jax_bench(tmp_path):
    """``--jobs 8 --seed 42`` (the Makefile's setting): the two benches'
    files are the same bytes."""
    argv = ["--jobs", "8", "--seed", "42"]
    ours, theirs = tmp_path / "torch.json", tmp_path / "jax.json"
    assert bench.main([*argv, "--out", str(ours)]) == 0
    assert jax_bench.main([*argv, "--out", str(theirs)]) == 0
    assert ours.read_bytes() == theirs.read_bytes()
    leak = json.loads(ours.read_text())["results"][-1]
    assert leak["leak_bytes_per_window"] == 503316480
    assert leak["detection_lead_min"] == 6
    assert leak["false_positive_jobs"] == 0


def test_leak_arm_detects_with_full_horizon_lead():
    result = bench.run_arm(bench.LEAK_BYTES, jobs=2, seed=42, windows=28)
    assert result["false_positive_jobs"] == 0
    assert result["detected_jobs"] == result["leaked_jobs"]
    if result["leaked_jobs"]:
        assert result["exhausted_jobs"] == result["leaked_jobs"]
        assert (result["detection_lead_min"]
                >= devstats.DEFAULT_PRESSURE_HORIZON_WINDOWS)


def test_control_arm_never_fires():
    result = bench.run_arm(0, jobs=2, seed=42, windows=12)
    assert result["leaked_workers"] == 0
    assert result["detected_jobs"] == 0
    assert result["false_positive_jobs"] == 0
    assert result["exhausted_jobs"] == 0


@pytest.fixture(scope="module")
def small_doc():
    return bench.build_doc(bench.LEAK_BYTES, jobs=2, seed=3, windows=28)


def test_same_seed_bit_identical_document(small_doc):
    again = bench.build_doc(bench.LEAK_BYTES, jobs=2, seed=3, windows=28)
    assert (json.dumps(small_doc, sort_keys=True)
            == json.dumps(again, sort_keys=True))
    bench.check_schema(again)


def _drop_detection_lead_min(doc):
    del doc["results"][1]["detection_lead_min"]


def _control_arm_detects(doc):
    doc["results"][0]["detected_jobs"] = 1


def _lead_short_of_horizon(doc):
    doc["results"][1]["detection_lead_min"] = 0


def _false_positives(doc):
    doc["results"][1]["false_positive_jobs"] = 2


@pytest.mark.parametrize("breaks, match", [
    (_drop_detection_lead_min, "detection_lead_min"),
    (_control_arm_detects, "control arm"),
    (_lead_short_of_horizon, "detection_lead_min"),
    (_false_positives, "false_positive"),
])
def test_schema_check_rejects(small_doc, breaks, match):
    bench.check_schema(small_doc)
    assert small_doc["results"][1]["leaked_jobs"] > 0
    broken = copy.deepcopy(small_doc)
    breaks(broken)
    with pytest.raises(ValueError, match=match):
        bench.check_schema(broken)


def test_lock_trace_reports_zero_inversions(tmp_path, capsys):
    """``--lock-trace`` arms the port's tracer for the whole run; the
    bench fails on any inversion. The test disarms it after."""
    try:
        rc = bench.main(["--jobs", "2", "--seed", "42", "--lock-trace",
                         "--out", str(tmp_path / "m.json")])
        report = locktrace.tracer().report()
    finally:
        locktrace.disable()
    assert rc == 0
    assert report["acquisitions"] > 1000
    assert report["inversions"] == []
    assert "0 inversions" in capsys.readouterr().err
