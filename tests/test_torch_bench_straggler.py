"""The port's straggler bench (``cmd/bench_straggler.py``) against the
JAX package's (the root ``bench_straggler.py``).

Both run their control planes on a simulated clock from one seed, and
the port's ``h100-4`` gang (four worker pods, one GPU each) mirrors the
JAX ``v5e-16`` slice's four hosts, so the same arguments write the same
document byte for byte. Then the port's copies of the JAX bench's tier-1
checks (``tests/test_stepstats.py::TestBenchStragglerSmoke``) and its
``--lock-trace`` gate.
"""

import copy
import json

import pytest

import bench_straggler as jax_bench
from mpi_operator_tpu.utils import logging as jax_logutil
from mpi_operator_tpu_torch.cmd import bench_straggler as bench
from mpi_operator_tpu_torch.runtime import locktrace
from mpi_operator_tpu_torch.utils import goodput
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
    doc = json.loads(ours.read_text())
    degraded = doc["results"][-1]
    assert degraded["factor"] == 2.0
    assert degraded["detection_windows_max"] == 3
    assert degraded["skew_abs_error_mean"] == 0.025336
    assert sum(r["false_positive_jobs"] for r in doc["results"]) == 0


def test_detects_within_budget_with_zero_false_positives():
    result = bench.run_factor(2.0, jobs=4, seed=42, windows=8)
    assert result["false_positive_jobs"] == 0
    assert result["detected_jobs"] == result["straggler_jobs"]
    if result["straggler_jobs"]:
        assert result["detection_windows_max"] <= (
            bench.stepstats.DEFAULT_CONSECUTIVE_WINDOWS
        )
        assert result["skew_wait_seconds_total"] > 0
        assert result["skew_wait_only_in_straggler_jobs"] is True
    assert result["phase_tiling_violations"] == 0


def test_control_arm_carves_no_skew_wait():
    result = bench.run_factor(1.0, jobs=4, seed=42, windows=6)
    assert result["false_positive_jobs"] == 0
    assert result["detected_jobs"] == 0
    assert result["skew_wait_seconds_total"] == 0.0
    assert result["phase_seconds"][goodput.PHASE_SKEW_WAIT] == 0.0


def test_same_seed_bit_identical_document():
    a = bench.build_doc([1.0, 2.0], jobs=3, seed=11, windows=6)
    b = bench.build_doc([1.0, 2.0], jobs=3, seed=11, windows=6)
    assert json.dumps(a, sort_keys=True) == json.dumps(b, sort_keys=True)
    bench.check_schema(a)


def _drop_detection_windows_max(doc):
    del doc["results"][0]["detection_windows_max"]


def _open_vocabulary(doc):
    doc["results"][0]["phase_seconds"]["coffee_break"] = 1.0


def _control_arm_skew_wait(doc):
    doc["results"][0]["skew_wait_seconds_total"] = 5.0


@pytest.fixture(scope="module")
def small_doc():
    return bench.build_doc([1.0], jobs=2, seed=3, windows=4)


@pytest.mark.parametrize("breaks, match", [
    (_drop_detection_windows_max, "detection_windows_max"),
    (_open_vocabulary, "vocabulary"),
    (_control_arm_skew_wait, "control arm"),
])
def test_schema_check_rejects(small_doc, breaks, match):
    bench.check_schema(small_doc)
    broken = copy.deepcopy(small_doc)
    breaks(broken)
    with pytest.raises(ValueError, match=match):
        bench.check_schema(broken)


def test_expected_ratio_ground_truth():
    assert bench._expected_ratio(1, 4, 2.0) == pytest.approx(2.0)
    assert bench._expected_ratio(2, 4, 2.0) == pytest.approx(2.0 / 1.5)
    assert bench._expected_ratio(0, 4, 2.0) == pytest.approx(1.0)


def test_lock_trace_reports_zero_inversions(tmp_path, capsys):
    """``--lock-trace`` arms the port's tracer for the whole run; the
    bench fails on any inversion. The test disarms it after."""
    try:
        rc = bench.main(["--jobs", "4", "--seed", "42", "--lock-trace",
                         "--out", str(tmp_path / "s.json")])
        report = locktrace.tracer().report()
    finally:
        locktrace.disable()
    assert rc == 0
    assert report["acquisitions"] > 1000
    assert report["inversions"] == []
    assert "0 inversions" in capsys.readouterr().err
