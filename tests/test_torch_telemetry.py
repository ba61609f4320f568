"""The port's worker-side telemetry against the JAX package's.

The same injected step durations (and wait slices) on a fake clock give
both packages' ``TrainingTelemetry`` the same ``step_heartbeat``,
``train_telemetry`` and ``device_memory`` records, byte for byte, and
the same publisher calls; the same ``FakeMemoryBackend`` and chaos leak
env give both ``DeviceMemorySampler`` the same samples; the SIGTERM
path's final records come out once. Then the port's sampler on its own:
the CUDA mapping (``torch.cuda.memory_stats`` read through a stand-in),
no CPU fallback on a CUDA device, and the CPU's held-tensor sum.
"""

from __future__ import annotations

import importlib
import io
import json

import pytest
import torch

pytestmark = pytest.mark.kernel

JAX, PORT = "mpi_operator_tpu", "mpi_operator_tpu_torch"
GiB = 1024 ** 3
# (duration_s, warmup, wait_s) per step: two warmup steps, then a ragged
# run with an outlier and a partial last window.
STEPS = [(2.5, True, 0.0), (0.9, True, 0.0)] + [
    (0.100 + 0.001 * (i % 3), False, 0.01 * (i % 2)) for i in range(8)
] + [(0.250, False, 0.2), (0.101, False, 0.0), (0.099, False, 0.0)]


def mod(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


@pytest.fixture(autouse=True)
def worker_identity(monkeypatch):
    monkeypatch.setenv("HOSTNAME", "train-worker-3")
    monkeypatch.setenv("TPU_WORKER_ID", "3")
    monkeypatch.delenv("TPU_MEM_LEAK_BYTES", raising=False)


def run_telemetry(pkg: str, *, final: bool, leak: int = 0,
                  heartbeat: int = 3, interval: int = 4) -> tuple:
    telemetry, devstats = mod(pkg, "utils.telemetry"), mod(pkg, "utils.devstats")
    metrics = mod(pkg, "utils.metrics")
    now = [100.0]
    stream, published = io.StringIO(), []
    sampler = devstats.DeviceMemorySampler(
        backend=devstats.FakeMemoryBackend(ripple_bytes=1 << 20),
        leak_bytes_per_window=leak, compile_cache_fn=lambda: 3)
    telem = telemetry.TrainingTelemetry(
        tokens_per_step=4096, examples_per_step=8,
        registry=metrics.Registry(), interval=interval, stream=stream,
        clock=lambda: now[0], heartbeat_interval=heartbeat,
        heartbeat_publisher=published.append,
        devstats_sampler=sampler.sample)
    telem.start()
    for step, (duration, warmup, wait) in enumerate(STEPS, start=1):
        now[0] += duration
        telem.record_step(step, duration, warmup=warmup, wait_s=wait)
    telem.record_checkpoint(0.5)
    telem.close(len(STEPS), final=final)
    if final:  # a second SIGTERM delivery
        telem.close(len(STEPS), final=True)
    records = [json.loads(line) for line in stream.getvalue().splitlines()]
    return records, published, round(telem.goodput_ratio(), 9)


@pytest.mark.parametrize("final", [False, True])
@pytest.mark.parametrize("heartbeat", [2, 3])
def test_records_equal_the_jax_packages(final, heartbeat):
    port = run_telemetry(PORT, final=final, heartbeat=heartbeat)
    jax = run_telemetry(JAX, final=final, heartbeat=heartbeat)
    assert port == jax
    records, published, _ = port
    beats = [r for r in records if r["event"] == "step_heartbeat"]
    mems = [r for r in records if r["event"] == "device_memory"]
    # Post-warmup steps only, windows of `heartbeat`, the partial window
    # flushed at close.
    assert [b["window"] for b in beats] == list(range(len(beats)))
    assert sum(b["steps"] for b in beats) == 11
    assert beats == published
    assert {b["worker_id"] for b in beats} == {3}
    assert {b["hostname"] for b in records} == {"train-worker-3"}
    # One device-memory sample a closed window, plus the final one.
    assert [m["window"] for m in mems if not m.get("final")] == [
        b["window"] for b in beats]
    assert sum(1 for r in records if r.get("final")) == (2 if final else 0)


def test_heartbeat_numbers():
    records, _, _ = run_telemetry(PORT, final=False, heartbeat=3)
    first = [r for r in records if r["event"] == "step_heartbeat"][0]
    # Steps 3-5: 0.100, 0.101, 0.102 s; waits 0.00, 0.01, 0.00.
    assert first == {
        "event": "step_heartbeat", "window": 0, "step": 5, "steps": 3,
        "step_wall_p50_ms": 101.0, "step_wall_max_ms": 102.0,
        "wait_share": round(0.01 / 0.303, 4), "window_s": 0.303,
        "worker_id": 3, "hostname": "train-worker-3"}


@pytest.mark.parametrize("leak", [0, 2 * GiB])
def test_device_memory_samples_equal_the_jax_packages(leak, monkeypatch):
    monkeypatch.setenv("TPU_MEM_LEAK_BYTES", str(leak))
    out = {}
    for pkg in (PORT, JAX):
        devstats = mod(pkg, "utils.devstats")
        sampler = devstats.DeviceMemorySampler(
            backend=devstats.FakeMemoryBackend(ripple_bytes=1 << 20),
            compile_cache_fn=lambda: 5)
        assert sampler.leak_bytes_per_window == leak
        out[pkg] = [sampler.sample(w) for w in range(6)]
    assert out[PORT] == out[JAX]
    in_use = [r["hbm_bytes_in_use"] for r in out[PORT]]
    base = [mod(PORT, "utils.devstats").FakeMemoryBackend(
        ripple_bytes=1 << 20).stats(w)["bytes_in_use"] for w in range(6)]
    assert [u - b for u, b in zip(in_use, base)] == [
        leak * (w + 1) for w in range(6)]


def test_final_flush_happens_once_with_the_last_sample():
    records, _, _ = run_telemetry(PORT, final=True, heartbeat=3)
    finals = [r for r in records if r.get("final")]
    assert [r["event"] for r in finals] == ["device_memory", "train_telemetry"]
    beats = [r for r in records if r["event"] == "step_heartbeat"]
    # The final sample is the window after the flushed partial one.
    assert finals[0]["window"] == beats[-1]["window"] + 1


# -- the port's sampler on the device --------------------------------------

class _FakeCuda:
    """``torch.cuda`` memory reads of one 80 GB card."""

    def __init__(self):
        self.calls = []

    def memory_stats(self, device):
        self.calls.append(("memory_stats", str(device)))
        return {"allocated_bytes.all.current": 12 * GiB,
                "allocated_bytes.all.peak": 20 * GiB,
                "reserved_bytes.all.current": 30 * GiB}

    def mem_get_info(self, device):
        self.calls.append(("mem_get_info", str(device)))
        return (40 * GiB, 80 * GiB)


def test_cuda_device_maps_the_allocator_statistics(monkeypatch):
    from mpi_operator_tpu_torch.utils import devstats

    fake = _FakeCuda()
    monkeypatch.setattr(torch.cuda, "memory_stats", fake.memory_stats)
    monkeypatch.setattr(torch.cuda, "mem_get_info", fake.mem_get_info)
    held = [torch.ones(1000)]
    sampler = devstats.DeviceMemorySampler(
        device=torch.device("cuda", 1), live_tensors=lambda: held,
        leak_bytes_per_window=GiB, compile_cache_fn=lambda: 3)
    rec = sampler.sample(1)
    assert rec == {"event": "device_memory", "window": 1,
                   "hbm_bytes_in_use": 14 * GiB, "hbm_peak_bytes": 20 * GiB,
                   "hbm_limit_bytes": 80 * GiB, "compile_cache_entries": 3}
    assert set(fake.calls) == {("memory_stats", "cuda:1"),
                               ("mem_get_info", "cuda:1")}


def test_cuda_device_never_reports_the_cpu_sum():
    """Without a card the CUDA read fails: the sampler raises, and the
    telemetry that drives it emits no device_memory record for the
    window rather than a CPU number."""
    from mpi_operator_tpu_torch.utils import devstats, metrics, telemetry

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    sampler = devstats.DeviceMemorySampler(
        device="cuda", live_tensors=lambda: [torch.ones(10)])
    with pytest.raises(Exception):
        sampler.sample(0)
    stream = io.StringIO()
    telem = telemetry.TrainingTelemetry(
        registry=metrics.Registry(), stream=stream, heartbeat_interval=1,
        devstats_sampler=sampler.sample)
    telem.record_step(1, 0.1)
    events = [json.loads(line)["event"]
              for line in stream.getvalue().splitlines()]
    assert events == ["step_heartbeat"]


def test_cpu_sums_the_held_tensors_with_no_limit():
    from mpi_operator_tpu_torch.utils import devstats

    model = torch.nn.Linear(64, 32)
    model(torch.ones(2, 64)).sum().backward()
    opt = torch.optim.AdamW(model.parameters())
    opt.step()
    held = lambda: (list(model.parameters())  # noqa: E731
                    + [p.grad for p in model.parameters()]
                    + [v for s in opt.state.values() for v in s.values()])
    rec = devstats.DeviceMemorySampler(live_tensors=held).sample(0)
    weights = (64 * 32 + 32) * 4
    # parameters + gradients + exp_avg + exp_avg_sq, and AdamW's step
    # counts (one f32 scalar each).
    assert rec["hbm_bytes_in_use"] == 4 * weights + 2 * 4
    assert rec["hbm_limit_bytes"] == 0
    assert rec["hbm_peak_bytes"] == rec["hbm_bytes_in_use"]


def test_compile_cache_counts_loaded_kernels(monkeypatch):
    from mpi_operator_tpu_torch.ops import _build
    from mpi_operator_tpu_torch.utils import devstats

    monkeypatch.setitem(_build._entry_points, "flash_fwd", object())
    monkeypatch.setitem(_build._entry_points, "flash_bwd_dq", object())
    assert _build.loaded_kernels() == ["flash_bwd_dq", "flash_fwd"]
    assert devstats._compile_cache_entries() == 2
