"""The train step's named ranges and counters (``utils/torchtrace.py``:
``arm_ranges``, ``timed_range``, ``add_count``, ``spans``) at test sizes
on the CPU: armed steps equal disarmed ones bit for bit, disarming
leaves no node in the autograd graph, the ranges and their backward
parts nest as the step runs them (the remat recompute inside the
backward), a running profiler arms them and each part times itself, the
MoE layer's dropped-choice counter, the Prefetcher's waits, and
the trainer's ``--profile-dir`` trace carrying the ranges."""

from __future__ import annotations

import json
import time

import pytest
import torch

from mpi_operator_tpu_torch.models import bert, llama
from mpi_operator_tpu_torch.models.moe import routing
from mpi_operator_tpu_torch.utils import torchtrace

pytestmark = pytest.mark.kernel

BF16 = torch.bfloat16


@pytest.fixture(autouse=True)
def _disarm():
    torch.set_num_threads(2)
    yield
    torchtrace.arm_ranges(False)


def _mixtral():
    # 2 experts, grad-accum 2, remat full; bf16 products, so every
    # parameter cast is a real one.
    cfg = llama.tiny_moe(n_experts=2, remat=True, remat_policy="full",
                         dtype=BF16, xent_chunk=8)
    model = llama.init_params(llama.Llama(cfg),
                              torch.Generator().manual_seed(0))
    tokens = torch.randint(0, cfg.vocab_size, (4, 16),
                           generator=torch.Generator().manual_seed(1))
    return model, (lambda opt: llama.make_train_step(model, opt, 2)), (
        tokens,)


def _llama():
    cfg = llama.tiny(remat=True, remat_policy="dots", dtype=BF16)
    model = llama.init_params(llama.Llama(cfg),
                              torch.Generator().manual_seed(0))
    tokens = torch.randint(0, cfg.vocab_size, (2, 16),
                           generator=torch.Generator().manual_seed(1))
    return model, (lambda opt: llama.make_train_step(model, opt)), (tokens,)


def _bert():
    cfg = bert.tiny(dtype=BF16)
    model = bert.init_params(bert.Bert(cfg),
                             torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (4, 16), generator=g)
    positions = torch.randint(0, 16, (4, 3), generator=g)
    targets = torch.randint(0, cfg.vocab_size, (4, 3), generator=g)
    weights = torch.ones(4, 3)
    return model, (lambda opt: bert.make_train_step_positions(model, opt)), (
        tokens, positions, targets, weights)


BUILDERS = {"mixtral": _mixtral, "llama": _llama, "bert": _bert}


def _train(builder, armed: bool, steps: int = 2):
    """Losses, final gradients and parameters of ``steps`` steps."""
    model, make, batch = builder()
    opt = torch.optim.AdamW(model.parameters(), lr=1e-2, weight_decay=1e-4)
    step = make(opt)
    torchtrace.arm_ranges(armed)
    losses = [step(*batch) for _ in range(steps)]
    torchtrace.arm_ranges(False)
    return (losses, [p.grad.clone() for p in model.parameters()
                     if p.grad is not None],
            [p.detach().clone() for p in model.parameters()])


@pytest.mark.parametrize("family", sorted(BUILDERS))
def test_armed_steps_equal_disarmed_ones_bit_for_bit(family):
    want = _train(BUILDERS[family], armed=False)
    got = _train(BUILDERS[family], armed=True)
    for a, b in zip(want, got):
        assert len(a) == len(b) > 0
        for x, y in zip(a, b):
            assert torch.equal(x, y)


def _nodes(loss) -> int:
    seen, todo = set(), [loss.grad_fn]
    while todo:
        fn = todo.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        todo.extend(f for f, _ in fn.next_functions)
    return len(seen)


@pytest.mark.parametrize("family", ["mixtral", "bert"])
def test_disarming_leaves_no_node_in_the_graph(family):
    model, _, batch = BUILDERS[family]()
    if family == "mixtral":
        def loss():
            return llama.loss_fn(model, *batch)
    else:
        def loss():
            return bert.mlm_loss_positions(model, *batch)
    before = _nodes(loss())
    torchtrace.arm_ranges(True)
    armed = _nodes(loss())
    torchtrace.arm_ranges(False)
    assert armed != before  # markers in, per-call casts merged per block
    assert _nodes(loss()) == before


def _annotations(prof) -> list:
    """(name, start, end) of the program's ranges in a CPU trace."""
    names = set(torchtrace.RANGES)
    names |= {n + torchtrace.BACKWARD for n in torchtrace.RANGES}
    return [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
            for e in prof.profiler.kineto_results.events()
            if e.is_user_annotation() and e.name() in names]


def _inside(spans, outer) -> list:
    """The spans that lie inside some span of ``outer``."""
    return [(a, b) for a, b in spans
            if any(s <= a and b <= e for s, e in outer)]


def test_ranges_nest_as_the_step_runs_them():
    from torch.profiler import ProfilerActivity, profile

    model, make, batch = _mixtral()
    step = make(torch.optim.AdamW(model.parameters(), lr=1e-3))
    step(*batch)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        torchtrace.arm_ranges(True)
        step(*batch)
        torchtrace.arm_ranges(False)
    by = {}
    for name, a, b in _annotations(prof):
        by.setdefault(name, []).append((a, b))
    layers, micro = 2, 2
    assert len(by["step.forward"]) == len(by["step.backward"]) == micro
    assert len(by["step.optimizer"]) == 1
    fwd, bwd = by["step.forward"], by["step.backward"]
    for name in ("cast", "norm", "head", "moe", "moe.route",
                 "moe.dispatch", "moe.experts", "moe.combine"):
        back = by[name + torchtrace.BACKWARD]
        # Every backward part runs inside a step's backward.
        assert _inside(back, bwd) == back, name
        assert not _inside(back, fwd), name
        if name != "head":
            # The blocks' forward ranges run in the forward and again in
            # the remat recompute, inside the backward; the final norm,
            # outside the blocks, runs once.
            once = micro if name == "norm" else 0
            assert len(_inside(by[name], fwd)) == len(
                _inside(by[name], bwd)) + once > once, name
    per_block = layers * micro
    assert len(_inside(by["moe.route"], fwd)) == per_block
    assert len(by["moe.experts.bwd"]) == per_block
    # The layer's parts nest in the whole layer, each way.
    for part in ("moe.route", "moe.dispatch", "moe.experts", "moe.combine"):
        assert _inside(by[part], by["moe"]) == by[part]
        assert (_inside(by[part + ".bwd"], by["moe.bwd"])
                == by[part + ".bwd"])
    # The head's chunked loss recomputes its chunks inside head.bwd; the
    # optimizer range holds no other.
    assert len(by["head.bwd"]) == micro
    opt = by["step.optimizer"]
    assert not any(_inside([s], opt) for n, spans in by.items()
                   if n != "step.optimizer" for s in spans)


def test_a_profiler_arms_the_ranges_and_they_time_themselves():
    from torch.profiler import ProfilerActivity, profile

    model, make, batch = _mixtral()
    step = make(torch.optim.AdamW(model.parameters(), lr=1e-3))
    step(*batch)
    torchtrace.arm_ranges(True)  # arming clears what was recorded
    torchtrace.arm_ranges(False)
    assert not torchtrace.ranges_armed() and torchtrace.spans() == []
    with profile(activities=[ProfilerActivity.CPU]):
        assert torchtrace.ranges_armed()
        step(*batch)
    assert not torchtrace.ranges_armed()
    records = torchtrace.spans()
    step(*batch)  # disarmed again: nothing more is recorded
    assert torchtrace.spans() == records
    names = [r[0] for r in records]
    assert names.count("step.forward") == names.count("step.backward") == 2
    assert names.count("step.optimizer") == 1
    for name, parent, thread, start, host, dev in records:
        assert host >= 0 and dev is None  # no CUDA: host edges alone
        if parent >= 0:
            assert records[parent][2] == thread
            assert records[parent][3] <= start
    # The remat recompute: forward parts opened inside a backward part.
    roots = {r[0] for r in records if r[1] >= 0 and not r[0].endswith(
        torchtrace.BACKWARD) and records[r[1]][0].endswith(
        torchtrace.BACKWARD)}
    assert {"cast", "norm", "moe"} <= roots


def test_dropped_choices_counter_equals_routing_keep():
    g, s, e, k, capacity = 2, 16, 4, 2, 3
    logits = torch.randn(g, s, e, generator=torch.Generator().manual_seed(3))
    logits[..., 0] += 4.0  # most first choices on expert 0: it overflows
    probs = torch.softmax(logits, dim=-1)
    torchtrace.arm_ranges(True)  # arming clears the counters
    torchtrace.arm_ranges(False)
    routing(probs, k, capacity)
    assert torchtrace.counts() == {}  # disarmed: nothing counted
    torchtrace.arm_ranges(True)
    dispatch, _, _ = routing(probs, k, capacity)
    routing(probs, k, capacity)
    counts = torchtrace.counts()
    kept = int(dispatch.sum())  # one slot a kept choice
    assert kept < g * k * s
    assert int(counts["moe.choices"]) == 2 * g * k * s
    assert int(counts["moe.dropped"]) == 2 * (g * k * s - kept)
    torchtrace.arm_ranges(False)  # the counters stay to be read
    assert torchtrace.counts() == counts


def test_prefetcher_times_one_wait_a_batch():
    from mpi_operator_tpu_torch.data import Prefetcher

    def slow(step):
        time.sleep(0.01)
        return step

    torchtrace.arm_ranges(True)
    p = Prefetcher(slow, 0, 5, depth=1)
    try:
        assert [step for step, _ in p] == list(range(5))
    finally:
        p.close()
    waits = [r for r in torchtrace.spans() if r[0] == "data.wait"]
    # One a batch, and the last one that found the end of the steps.
    assert len(waits) == 6
    assert 0.0 < sum(r[4] for r in waits) < 5.0


def test_profile_dir_trace_holds_the_step_ranges(tmp_path):
    from mpi_operator_tpu_torch.cmd import train

    out = tmp_path / "prof"
    assert train.main([
        "--device", "cpu", "--model", "llama-tiny", "--steps", "15",
        "--warmup", "1", "--global-batch", "4", "--seq-len", "16",
        "--log-every", "0", "--telemetry-every", "0",
        "--profile-dir", str(out)]) == 0
    assert not torchtrace.ranges_armed()
    (path,) = out.glob("*.json")
    with open(path) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"step.forward", "step.backward", "step.optimizer", "norm",
            "cast", "head", "norm.bwd"} <= names
