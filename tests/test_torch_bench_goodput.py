"""The port's goodput-under-preemption bench (``cmd/bench_goodput.py``)
against the JAX package's (the root ``bench_goodput.py``).

The port's ``h100-4`` gang (four worker pods, one GPU each, and one
4-GPU node a job plus the spares' nodes) mirrors the JAX ``v5e-16``
slices' hosts, and both run on a simulated clock from one seed, so the
same arguments write the same document byte for byte. Then the port's
copies of the JAX bench's tier-1 checks (``tests/test_bench_goodput.py``:
the curve's shape, the schema's rejects, the ``--baseline`` gate).
"""

import copy

import pytest

import bench_goodput as jax_bench
from mpi_operator_tpu.utils import logging as jax_logutil
from mpi_operator_tpu_torch.cmd import bench_goodput as bench
from mpi_operator_tpu_torch.utils import goodput
from mpi_operator_tpu_torch.utils import logging as logutil

pytestmark = pytest.mark.kernel

RATES = [0.0, 0.3]


@pytest.fixture(autouse=True)
def quiet_logs():
    """Each bench's main() sets its package's log level to warning: hold
    both there for the test and put them back after."""
    prev = (logutil.configure(level="warning"),
            jax_logutil.configure(level="warning"))
    yield
    logutil.configure(**prev[0])
    jax_logutil.configure(**prev[1])


@pytest.fixture(scope="module")
def doc8():
    """The port's curve at ``--jobs 8 --rates 0,0.3 --seed 42``, shared
    by the shape checks below (the sims dominate this file's time)."""
    prev = logutil.configure(level="warning")
    try:
        return bench.build_doc(RATES, jobs=8, seed=42)
    finally:
        logutil.configure(**prev)


def test_document_equals_the_jax_bench(doc8):
    theirs = jax_bench.build_doc(RATES, jobs=8, seed=42)
    assert bench.canonical_bytes(doc8) == jax_bench.canonical_bytes(theirs)


def test_curve_converges_and_schema_checks(doc8):
    bench.check_schema(doc8)
    assert [(p["arm"], p["kill_rate"]) for p in doc8["curve"]] == [
        ("sync", 0.0), ("sync", 0.3), ("resilient", 0.0), ("resilient", 0.3),
    ]
    for result in doc8["results"]:
        assert result["converged"] is True
        assert result["outcomes"].get("Succeeded", 0) == 8
        assert sum(result["phase_seconds"].values()) == pytest.approx(
            result["wall_seconds_total"], rel=0.01)
        assert result["attribution_residual_ratio"] <= 0.01
    for arm in doc8["arms"]:
        ratios = [p["goodput_ratio"] for p in doc8["curve"] if p["arm"] == arm]
        assert ratios[0] >= ratios[-1]


def test_chaos_fired_and_the_resilient_arm_promotes_spares(doc8):
    by_arm = {(r["arm"], r["kill_rate"]): r for r in doc8["results"]}
    for arm in doc8["arms"]:
        chaotic = by_arm[(arm, 0.3)]
        assert chaotic["kills"] > 0 and chaotic["restarts_total"] > 0
        assert chaotic["phase_seconds"][goodput.PHASE_RESTART_DOWNTIME] > 0
    assert by_arm[("resilient", 0.3)]["spare_promotions"] > 0
    assert by_arm[("resilient", 0.3)]["hot_spares"] == bench.HOT_SPARES
    assert by_arm[("sync", 0.3)]["spare_promotions"] == 0
    assert by_arm[("resilient", 0.0)]["spare_promotions"] == 0
    sync_tax = by_arm[("sync", 0.0)]["checkpoint_seconds_per_job"]
    async_tax = by_arm[("resilient", 0.0)]["checkpoint_seconds_per_job"]
    assert async_tax < 0.2 * sync_tax
    scaling = doc8["checkpoint_scaling"]
    assert scaling["sync"]["scaling_ratio"] == pytest.approx(2.0, rel=0.1)
    assert scaling["async"]["scaling_ratio"] == pytest.approx(1.0, rel=0.2)


def _drop_phase_shares(doc):
    del doc["results"][0]["phase_shares"]


def _open_vocabulary(doc):
    doc["results"][0]["phase_seconds"]["coffee_break"] = 1.0


def _attribution_gap(doc):
    res = doc["results"][0]
    res["phase_seconds"][goodput.PHASE_QUEUE_WAIT] += (
        0.5 * res["wall_seconds_total"])


def _unknown_arm(doc):
    doc["results"][0]["arm"] = "yolo"


def _drop_scaling_block(doc):
    del doc["checkpoint_scaling"]["async"]


@pytest.mark.parametrize("breaks, match", [
    (_drop_phase_shares, "phase_shares"),
    (_open_vocabulary, "vocabulary"),
    (_attribution_gap, "deviates"),
    (_unknown_arm, "arm"),
    (_drop_scaling_block, "checkpoint_scaling.async"),
])
def test_schema_check_rejects(doc8, breaks, match):
    broken = copy.deepcopy(doc8)
    breaks(broken)
    with pytest.raises(ValueError, match=match):
        bench.check_schema(broken)


def test_mismatched_baseline_fails_without_clobbering(tmp_path):
    out = tmp_path / "fresh.json"
    stale = tmp_path / "stale.json"
    stale.write_bytes(b'{"benchmark": "goodput", "stale": true}\n')
    rc = bench.main(["--jobs", "8", "--seed", "3", "--rates", "0",
                     "--out", str(out), "--baseline", str(stale)])
    assert rc == 1
    # A mismatch leaves both files as they were, so the diff stays.
    assert not out.exists()
    assert stale.read_bytes().endswith(b'"stale": true}\n')


def test_matching_baseline_passes_and_same_seed_same_bytes(tmp_path):
    first = tmp_path / "artifact.json"
    argv = ["--jobs", "8", "--seed", "3", "--rates", "0",
            "--out", str(first), "--baseline", str(first)]
    assert bench.main(argv) == 0 and first.exists()  # no baseline: write
    written = first.read_bytes()
    assert bench.main(argv) == 0  # the same seed reproduces the bytes
    assert first.read_bytes() == written
