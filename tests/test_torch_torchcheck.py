"""The port's torch perf-correctness rules (TPU5xx,
``mpi_operator_tpu_torch/analysis/torchcheck.py``) against the JAX
package's (``analysis/jaxcheck.py``), case by case with
``tests/test_jaxcheck.py``.

- Every JAX case is mirrored (``MIRRORED``): its JAX fixture runs through
  the JAX analyzer, which must still find what the JAX test expects, and
  its PyTorch spelling through the port's, which must find the same rule
  ids on the lines of the same role (the lines where the two fixtures
  line up, else the line stated beside the case). Clean cases stay
  clean in both.
- TPU503, TPU506 and TPU507 fixtures without a JAX call (``SHARED``) go
  through both analyzers unchanged and give the same (line, rule) pairs.
- The gates: ``# noqa``, the baseline, ``--select TPU5`` clean on the
  port tree, the ``github`` format, the stale-baseline prune and the
  missing-family gate, through ``python -m
  mpi_operator_tpu_torch.cmd.analyze``.
- ``utils/torchtrace.py:host_read``, the sanctioned step-boundary read.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import textwrap
from pathlib import Path
from typing import Optional

import pytest

from mpi_operator_tpu.analysis import framework as jax_framework
from mpi_operator_tpu_torch.analysis import framework

pytestmark = pytest.mark.kernel

REPO_ROOT = Path(__file__).resolve().parents[1]


def _findings(fw, tmp_path: Path, source: str, name: str, select: str):
    path = tmp_path / name
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(textwrap.dedent(source))
    repo = fw.RepoView(tmp_path, roots=[name])
    return fw.run(repo, select=[select])


def _torch_path(name: str) -> str:
    return name.replace("mpi_operator_tpu/", "mpi_operator_tpu_torch/")


@dataclasses.dataclass
class Case:
    rule: str
    jax: str                         # the JAX test's fixture
    torch: str                       # its PyTorch spelling
    lines: Optional[list] = None     # where the two fixtures do not line up
    name: str = "mod.py"
    message: str = ""                # a word the torch finding names


# Each entry mirrors the test of tests/test_jaxcheck.py of its name.
MIRRORED = {
    # -- TPU501 ------------------------------------------------------------
    "int_annotated_param_without_static_flags": Case("TPU501", """
        import jax

        @jax.jit
        def embed(x, vocab_size: int):
            return x * vocab_size
    """, """
        import torch

        @torch.compile
        def embed(x, vocab_size: int):
            return x * vocab_size
    """, message="vocab_size"),
    "static_argnames_param_is_clean": Case("TPU501", """
        from functools import partial

        import jax

        @partial(jax.jit, static_argnames=("vocab_size",))
        def embed(x, vocab_size: int):
            return x * vocab_size
    """, """
        from functools import partial

        import torch

        @partial(torch.compile, dynamic=True)
        def embed(x, vocab_size: int):
            return x * vocab_size
    """),
    "static_argnums_position_is_clean": Case("TPU501", """
        from functools import partial

        import jax

        @partial(jax.jit, static_argnums=(1,))
        def embed(x, vocab_size: int):
            return x * vocab_size
    """, """
        from functools import partial

        import torch

        @torch.compile(dynamic=True)
        def embed(x, vocab_size: int):
            return x * vocab_size
    """),
    "literal_default_flags_and_call_form_resolves": Case("TPU501", """
        import jax

        def pad(x, multiple=128):
            return x

        padded = jax.jit(pad)
    """, """
        import torch

        def pad(x, multiple=128):
            return x

        padded = torch.compile(pad)
    """, message="multiple"),
    "unresolvable_static_set_is_skipped": Case("TPU501", """
        from functools import partial

        import jax

        NUMS = (1,) + ()

        @partial(jax.jit, static_argnums=NUMS)
        def embed(x, vocab_size: int):
            return x * vocab_size
    """, """
        from functools import partial

        import torch

        DYNAMIC = bool(1)

        @partial(torch.compile, dynamic=DYNAMIC)
        def embed(x, vocab_size: int):
            return x * vocab_size
    """),
    # -- TPU502 ------------------------------------------------------------
    "jit_call_in_loop_flags": Case("TPU502", """
        import jax

        def sweep(fns, x):
            for fn in fns:
                x = jax.jit(fn)(x)
            return x
    """, """
        import torch

        def sweep(fns, x):
            for fn in fns:
                x = torch.compile(fn)(x)
            return x
    """),
    "jit_in_step_closure_flags": Case("TPU502", """
        import jax

        def train_step(state, batch):
            f = jax.jit(lambda s: s)
            return f(state)
    """, """
        import torch

        def train_step(state, batch):
            f = torch.compile(lambda s: s)
            return f(state)
    """, message="train_step"),
    "jit_hoisted_outside_loop_is_clean": Case("TPU502", """
        import jax

        def sweep(fn, xs):
            jfn = jax.jit(fn)
            out = []
            for x in xs:
                out.append(jfn(x))
            return out
    """, """
        import torch

        def sweep(fn, xs):
            jfn = torch.compile(fn)
            out = []
            for x in xs:
                out.append(jfn(x))
            return out
    """),
    # -- TPU503 ------------------------------------------------------------
    "device_get_wrapped_read_is_clean": Case("TPU503", """
        import jax

        def train_step(state, batch):
            loss = state + batch
            host = jax.device_get(loss)
            record(float(host))
            return state
    """, """
        from mpi_operator_tpu_torch.utils.torchtrace import host_read

        def train_step(state, batch):
            loss = state + batch
            host = host_read(loss)
            record(float(host))
            return state
    """),
    "traversal_stops_at_jitted_boundary": Case("TPU503", """
        import jax

        @jax.jit
        def inner(x):
            return helper(x)

        def helper(x):
            return float(shape_of(x))

        def train_step(state, batch):
            return inner(state)
    """, """
        import torch

        @torch.compile
        def inner(x):
            return helper(x)

        def helper(x):
            return float(shape_of(x))

        def train_step(state, batch):
            return inner(state)
    """),
    "param_conversion_inside_jitted_step_flags": Case("TPU503", """
        import jax

        @jax.jit
        def train_step(state, batch):
            print(state)
            return state
    """, """
        import torch

        @torch.compile
        def train_step(state, batch):
            print(state)
            return state
    """),
    # -- TPU504: a donated buffer read again / a graph's static buffers ---
    "read_after_donation_flags": Case("TPU504", """
        import jax

        step = jax.jit(_step, donate_argnums=(0,))

        def run(state, batch):
            new_state = step(state, batch)
            return state  # donated buffer read again
    """, """
        import torch

        def run(model, x):
            g = torch.cuda.CUDAGraph()
            with torch.cuda.graph(g):
                out = model(x)
            g.replay()
            first = out
            g.replay()
            return first  # static output read after a later replay
    """, lines=[11], message="'first'"),
    "rebinding_from_result_is_clean": Case("TPU504", """
        import jax

        step = jax.jit(_step, donate_argnums=(0,))

        def run(state, batches):
            for batch in batches:
                state = step(state, batch)
            return state
    """, """
        import torch

        def run(model, static_x, batches):
            g = torch.cuda.CUDAGraph()
            with torch.cuda.graph(g):
                out = model(static_x)
            for batch in batches:
                static_x.copy_(batch)
                g.replay()
            return out
    """),
    "loop_without_rebinding_flags": Case("TPU504", """
        import jax

        step = jax.jit(_step, donate_argnums=(0,))

        def run(state, batches):
            for batch in batches:
                loss = step(state, batch)
    """, """
        import torch

        def run(model, static_x, batches):
            g = torch.cuda.CUDAGraph()
            with torch.cuda.graph(g):
                out = model(static_x)
            for batch in batches:
                static_x = batch
                g.replay()
    """, lines=[9], message="rebound"),
    # -- TPU505: step without donation / a second params-sized buffer -----
    "undonated_train_step_flags": Case("TPU505", """
        import jax

        step = jax.jit(make_train_step(model, opt))
    """, """
        def train_step(model, opt, batch):
            opt.zero_grad(set_to_none=False)
    """, lines=[3], message="set_to_none=False"),
    "donated_train_step_is_clean": Case("TPU505", """
        import jax

        step = jax.jit(make_train_step(model, opt),
                       donate_argnums=(0, 1, 2))
    """, """
        def train_step(model, opt, batch):
            opt.zero_grad(set_to_none=True)
    """),
    "eval_helper_jit_is_not_a_step": Case("TPU505", """
        import jax

        stats = jax.jit(batch_stats)
    """, """
        import copy

        stats = copy.deepcopy(batch_stats)
    """),
    # -- TPU506 ------------------------------------------------------------
    "float_in_loop_driving_jitted_callable_flags": Case("TPU506", """
        import jax

        stats = jax.jit(batch_stats)

        def evaluate(params, batches):
            total = 0.0
            for b in batches:
                loss = stats(params, b)
                total += float(loss)
            return total
    """, """
        import torch

        stats = torch.compile(batch_stats)

        def evaluate(params, batches):
            total = 0.0
            for b in batches:
                loss = stats(params, b)
                total += float(loss)
            return total
    """),
    "device_accumulation_is_clean": Case("TPU506", """
        import jax

        stats = jax.jit(batch_stats)

        def evaluate(params, batches):
            total = 0.0
            for b in batches:
                total = total + stats(params, b)
            return float(jax.device_get(total))
    """, """
        import torch

        stats = torch.compile(batch_stats)

        def evaluate(params, batches):
            total = 0.0
            for b in batches:
                total = total + stats(params, b)
            return float(host_read(total))
    """),
    # -- noqa (TestSuppressionAndBaseline) --------------------------------
    "noqa_suppresses_a_tpu5_finding": Case("TPU501", """
        import jax

        @jax.jit
        def embed(x, vocab_size: int):  # noqa: TPU501
            return x * vocab_size
    """, """
        import torch

        @torch.compile
        def embed(x, vocab_size: int):  # noqa: TPU501
            return x * vocab_size
    """),
}


@pytest.mark.parametrize("name", sorted(MIRRORED))
def test_mirrored_case(tmp_path, name):
    case = MIRRORED[name]
    jax_found = [(f.rule_id, f.line) for f in _findings(
        jax_framework, tmp_path / "jax", case.jax, case.name, case.rule)]
    found = _findings(framework, tmp_path / "torch", case.torch,
                      _torch_path(case.name), case.rule)
    lines = case.lines if case.lines is not None else [
        line for _, line in jax_found]
    assert len(lines) == len(jax_found)
    assert [(f.rule_id, f.line) for f in found] == [
        (case.rule, line) for line in lines]
    assert all(rule == case.rule for rule, _ in jax_found)
    if case.message:
        assert case.message in found[0].message


# TPU503/506/507 fixtures with no JAX call: the same text, the same
# findings from both analyzers. (path, rule, source, ids expected)
SHARED = {
    # tests/test_jaxcheck.py's own texts
    "item_in_unjitted_helper_reachable_from_step": ("mod.py", "TPU503", """
        def log_loss(loss):
            return loss.item()

        def train_step(state, batch):
            loss = state + batch
            log_loss(loss)
            return state
    """, ["TPU503"]),
    "helper_not_reachable_from_step_is_clean": ("mod.py", "TPU503", """
        def init_report(metrics):
            return float(metrics.total())

        def train_step(state, batch):
            return state + batch
    """, []),
    "cold_loop_conversions_are_clean": ("mod.py", "TPU506", """
        def parse(rows):
            out = []
            for r in rows:
                out.append(float(r))
            return out
    """, []),
    "literal_tile_default_in_ops_flags": (
        "mpi_operator_tpu/ops/custom.py", "TPU507", """
        def my_kernel(x, block_q: int = 128):
            return x
    """, ["TPU507"]),
    "shared_constant_default_is_clean": (
        "mpi_operator_tpu/ops/custom.py", "TPU507", """
        from ._common import DEFAULT_BLOCK_Q

        def my_kernel(x, block_q: int = DEFAULT_BLOCK_Q):
            return x
    """, []),
    "module_level_tile_constant_flags": (
        "mpi_operator_tpu/ops/custom.py", "TPU507", """
        TILE_M = 512
    """, ["TPU507"]),
    "common_py_itself_is_exempt": (
        "mpi_operator_tpu/ops/_common.py", "TPU507", """
        DEFAULT_BLOCK_Q = 128
    """, []),
    "outside_ops_is_out_of_scope": (
        "mpi_operator_tpu/models/custom.py", "TPU507", """
        def helper(x, block_q: int = 128):
            return x
    """, []),
    # more of each, in the port's idiom
    "tolist_and_np_asarray_in_a_step": ("mod.py", "TPU503", """
        import numpy as np

        def step(batch):
            out = model(batch)
            rows = out.tolist()
            return np.asarray(out), rows
    """, ["TPU503", "TPU503"]),
    "item_in_a_loop_driving_step_fn": ("mod.py", "TPU506", """
        def drive(work, batches):
            losses = []
            for b in batches:
                loss = work.step_fn(*b)
                losses.append(loss.item())
            return losses
    """, ["TPU506"]),
}


@pytest.mark.parametrize("name", sorted(SHARED))
def test_shared_fixture_agrees_with_the_jax_analyzer(tmp_path, name):
    path, rule, source, want = SHARED[name]
    theirs = _findings(jax_framework, tmp_path / "jax", source, path, rule)
    ours = _findings(framework, tmp_path / "torch", source,
                     _torch_path(path), rule)
    assert [(f.line, f.rule_id) for f in ours] == [
        (f.line, f.rule_id) for f in theirs]
    assert [f.rule_id for f in ours] == want


# Rules the JAX family has no spelling for: the port's own cases.
TORCH_ONLY = {
    "cuda_graph_captured_in_a_loop": ("TPU502", """
        import torch

        def capture_each(fns):
            graphs = []
            for fn in fns:
                g = torch.cuda.CUDAGraph()
                with torch.cuda.graph(g):
                    fn()
                graphs.append(g)
            return graphs
    """, [(7, "TPU502"), (8, "TPU502")]),
    "synchronize_in_a_step": ("TPU503", """
        import torch

        def train_step(model, batch):
            loss = model(batch)
            torch.cuda.synchronize()
            return loss
    """, [(6, "TPU503")]),
    "static_output_appended_each_replay": ("TPU504", """
        import torch

        def replay_all(model, x, n):
            g = torch.cuda.CUDAGraph()
            with torch.cuda.graph(g):
                out = model(x)
            outs = []
            for _ in range(n):
                g.replay()
                outs.append(out)
            return outs
    """, [(11, "TPU504")]),
    "cloned_outputs_are_clean": ("TPU504", """
        import torch

        def replay_all(model, x, n):
            g = torch.cuda.CUDAGraph()
            with torch.cuda.graph(g):
                out = model(x)
            outs = []
            for _ in range(n):
                g.replay()
                outs.append(out.clone())
            return outs
    """, []),
    "cloned_state_dict_in_a_training_loop": ("TPU505", """
        def train(model, work, batches):
            for b in batches:
                snapshot = {k: v.clone() for k, v in model.state_dict().items()}
                work.step_fn(*b)
    """, [(4, "TPU505")]),
    "deepcopy_in_an_update_step": ("TPU505", """
        import copy

        def update_step(model, batch):
            ema = copy.deepcopy(model)
            return ema(batch)
    """, [(5, "TPU505")]),
    "replay_loop_reading_a_scalar": ("TPU506", """
        def time_graph(g, out, n):
            seen = []
            for _ in range(n):
                g.replay()
                seen.append(int(out))
            return seen
    """, [(6, "TPU506")]),
    "host_read_in_a_hot_loop_is_clean": ("TPU506", """
        from mpi_operator_tpu_torch.utils.torchtrace import host_read

        def drive(step, batches):
            return [host_read(step(b)) for b in batches]

        def drive_loop(step, batches):
            out = []
            for b in batches:
                out.append(host_read(step(b)))
            return out
    """, []),
}


@pytest.mark.parametrize("name", sorted(TORCH_ONLY))
def test_torch_only_case(tmp_path, name):
    rule, source, want = TORCH_ONLY[name]
    found = _findings(framework, tmp_path, source, "mod.py", rule)
    assert [(f.line, f.rule_id) for f in found] == want


def test_baselined_tpu5_finding_is_not_new(tmp_path):
    found = _findings(framework, tmp_path, MIRRORED[
        "int_annotated_param_without_static_flags"].torch, "mod.py",
        "TPU501")
    assert len(found) == 1
    baseline = {found[0].baseline_key: 1}
    assert framework.new_findings(found, baseline) == []
    assert framework.new_findings(found, {}) == found


def test_rule_ids_and_families_are_jaxs():
    ours = [r.id for r in framework.all_rules() if r.id.startswith("TPU5")]
    theirs = [r.id for r in jax_framework.all_rules()
              if r.id.startswith("TPU5")]
    assert ours == theirs == [f"TPU50{i}" for i in range(1, 8)]
    names = {r.id: r.name for r in framework.all_rules()}
    jax_names = {r.id: r.name for r in jax_framework.all_rules()}
    # The names stay where the semantics carry over.
    assert [i for i in ours if names[i] == jax_names[i]] == [
        "TPU503", "TPU506"]
    assert framework.REQUIRED_RULE_FAMILIES["TPU5"] == "torch perf-correctness"


def test_host_read_is_the_value_and_a_counted_sync():
    import torch

    from mpi_operator_tpu_torch.utils import torchtrace

    t = torch.tensor(2.5, dtype=torch.float32)
    assert torchtrace.host_read(t) == float(t) == 2.5
    assert torchtrace.host_read(torch.arange(3)) == [0, 1, 2]
    assert "tolist" in torchtrace.SYNC_METHODS


# -- the command line ---------------------------------------------------------

def _analyze(*argv, cwd=REPO_ROOT):
    return subprocess.run(
        [sys.executable, "-m", "mpi_operator_tpu_torch.cmd.analyze", *argv],
        cwd=cwd, capture_output=True, text=True, timeout=300,
    )


EMBED = """
    import torch

    @torch.compile
    def embed(x, vocab_size: int):
        return x * vocab_size
"""


def test_select_tpu5_is_clean_on_the_port():
    proc = _analyze("--select", "TPU5", "--fail-on-new")
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.splitlines()[-1].endswith("0 finding(s), 0 new vs "
                                                 "baseline")


def test_github_format_emits_workflow_annotations(tmp_path):
    root = tmp_path / "r"
    (root / "mpi_operator_tpu_torch").mkdir(parents=True)
    (root / "mpi_operator_tpu_torch" / "mod.py").write_text(
        textwrap.dedent(EMBED))
    proc = _analyze("--root", str(root), "--select", "TPU501",
                    "--baseline", str(tmp_path / "empty.json"),
                    "--format", "github")
    lines = [line for line in proc.stdout.splitlines()
             if line.startswith("::")]
    assert len(lines) == 1
    assert lines[0].startswith(
        "::error file=mpi_operator_tpu_torch/mod.py,line=5,")
    assert "title=TPU501::" in lines[0]


def test_update_baseline_prunes_stale_and_reports_drift(tmp_path):
    root = tmp_path / "r"
    (root / "mpi_operator_tpu_torch").mkdir(parents=True)
    (root / "mpi_operator_tpu_torch" / "mod.py").write_text(
        textwrap.dedent(EMBED))
    baseline = tmp_path / "b.json"
    baseline.write_text(json.dumps({
        "version": 1, "findings": {"TPU501|gone.py|old message": 1}}))
    proc = _analyze("--root", str(root), "--baseline", str(baseline),
                    "--update-baseline")
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "-1 stale" in proc.stdout
    assert "- TPU501|gone.py|old message" in proc.stdout
    keys = list(json.loads(baseline.read_text())["findings"])
    assert "TPU501|gone.py|old message" not in keys
    assert any(k.startswith("TPU501|mpi_operator_tpu_torch/mod.py|")
               for k in keys)


def test_missing_family_gate(monkeypatch):
    assert framework.missing_rule_families() == []
    monkeypatch.setattr(
        framework, "REQUIRED_RULE_FAMILIES",
        dict(framework.REQUIRED_RULE_FAMILIES, TPU9="imaginary"),
    )
    assert framework.missing_rule_families() == ["TPU9"]
    from mpi_operator_tpu_torch.cmd import analyze

    assert analyze.main(["--select", "TPU5"]) == 2
