"""The port's control-plane bench (``cmd/bench_controlplane.py``) against
the JAX package's (the root ``bench_controlplane.py``).

Its documents carry wall-clock timings, so only the fields the seed
decides are held to JAX's: outcomes, rounds, the workqueues' depth
curves, the cache scans and, under ``--chaos``, the fault counts. The
one difference is the node inventory: the port's ``h100-4`` job is one
4-GPU node where JAX's ``v5e-16`` slice is four hosts. Then the port's
copies of the JAX bench's tier-1 checks (``tests/test_bench_controlplane.py``).
"""

import pytest

import bench_controlplane as jax_bench
from mpi_operator_tpu.utils import logging as jax_logutil
from mpi_operator_tpu_torch.cmd import bench_controlplane as bench
from mpi_operator_tpu_torch.runtime import locktrace
from mpi_operator_tpu_torch.utils import logging as logutil

pytestmark = pytest.mark.kernel


@pytest.fixture(autouse=True)
def quiet_logs():
    """An info-level storm logs a line a condition flip: hold both
    packages at warning for the test and put them back after."""
    prev = (logutil.configure(level="warning"),
            jax_logutil.configure(level="warning"))
    yield
    logutil.configure(**prev[0])
    jax_logutil.configure(**prev[1])


@pytest.fixture(scope="module")
def pair60():
    """``run_scale(60, seed=7)`` on each package."""
    prev = (logutil.configure(level="warning"),
            jax_logutil.configure(level="warning"))
    try:
        return bench.run_scale(60, seed=7), jax_bench.run_scale(60, seed=7)
    finally:
        logutil.configure(**prev[0])
        jax_logutil.configure(**prev[1])


def test_seeded_fields_equal_the_jax_bench(pair60):
    ours, theirs = pair60
    assert ours["converged"] and theirs["converged"]
    assert ours["outcomes"] == theirs["outcomes"] == {"Succeeded": 60}
    assert ours["rounds"] == theirs["rounds"]
    assert ours["concurrency"] == theirs["concurrency"]
    assert ours["workqueue"] == theirs["workqueue"]
    scans, their_scans = ours["cache_scans"], theirs["cache_scans"]
    nodes, their_nodes = (scans.pop("scheduler_nodes"),
                          their_scans.pop("scheduler_nodes"))
    assert scans == their_scans
    # One node a job against four hosts a slice.
    assert nodes["passes"] == their_nodes["passes"]
    assert 4 * nodes["objects"] == their_nodes["objects"]
    fanout, their_fanout = ours["watch_fanout"], theirs["watch_fanout"]
    assert fanout["events_delivered"] == their_fanout["events_delivered"]
    assert (their_fanout["apiserver_writes"] - fanout["apiserver_writes"]
            == 3 * ours["concurrency"])


def test_same_seed_same_outcomes(pair60):
    again = bench.run_scale(60, seed=7)
    first = pair60[0]
    assert again["converged"]
    assert again["outcomes"] == first["outcomes"]
    assert again["rounds"] == first["rounds"]
    assert (again["workqueue"]["controller"]["depth_curve"]
            == first["workqueue"]["controller"]["depth_curve"])


def test_chaos_fault_counts_equal_the_jax_bench():
    ours = bench.run_scale(40, seed=11, with_chaos=True)
    theirs = jax_bench.run_scale(40, seed=11, with_chaos=True)
    assert ours["converged"] is True
    assert sum(ours["outcomes"].values()) == 40
    assert ours["fault_counts"]  # the chaos layer fired
    assert ours["fault_counts"] == theirs["fault_counts"]
    assert ours["rounds"] == theirs["rounds"]
    assert ours["outcomes"] == theirs["outcomes"]


def test_100_jobs_converge_and_schema_checks():
    doc = bench.build_doc([100], seed=42, with_chaos=False, max_rounds=0)
    bench.check_schema(doc)
    (result,) = doc["results"]
    assert result["converged"] is True
    assert result["outcomes"].get("Succeeded", 0) == 100
    assert result["jobs_per_second_to_converged"] > 0
    shares = result["reconcile_phase_shares"]
    assert sum(shares.values()) == pytest.approx(1.0, abs=0.05)
    assert (result["reconcile"]["p99_seconds"]
            >= result["reconcile"]["p50_seconds"])
    assert result["watch_propagation"]["reconcile"]["count"] > 0
    assert result["workqueue"]["controller"]["peak_depth"] > 0


def test_schema_check_rejects_missing_keys():
    doc = bench.build_doc([30], seed=3, with_chaos=False, max_rounds=0)
    bench.check_schema(doc)
    del doc["results"][0]["reconcile_phase_shares"]
    with pytest.raises(ValueError, match="reconcile_phase_shares"):
        bench.check_schema(doc)


def test_lock_trace_run_reports_zero_inversions():
    """The port's tracer armed over the whole stack: the run converges,
    its report passes the schema gate, and the lock-order graph of the
    port's controller, queue, scheduler and runtime has no inversion."""
    result = bench.run_scale(40, seed=5, lock_trace=True)
    assert not locktrace.enabled()  # the harness disarms on exit
    assert result["converged"] is True
    trace = result["lock_trace"]
    assert trace["acquisitions"] > 1000
    assert len(trace["locks"]) >= 5
    assert trace["inversions"] == []
    bench.check_schema({"benchmark": "controlplane",
                        "schema_version": bench.SCHEMA_VERSION,
                        "results": [result]})
