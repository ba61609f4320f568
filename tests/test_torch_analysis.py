"""The port's static analyzer (``mpi_operator_tpu_torch/analysis``, rule
families TPU0–TPU5) and its gate; the TPU5 family's own cases are in
``tests/test_torch_torchcheck.py``.

- The gate: the port package and ``chip_smoke.py`` have no finding
  beyond ``analysis/baseline.json``, the baseline holds nothing stale,
  and ``python -m mpi_operator_tpu_torch.cmd.analyze --format json
  --fail-on-new`` exits 0.
- Parity with the JAX package's analyzer: a copy of the port renamed
  ``mpi_operator_tpu/`` gives the JAX analyzer's TPU0–TPU4 the port
  analyzer's findings, prefix for prefix; and the JAX analyzer tests'
  fixtures (``tests/test_analysis.py``) give both the same findings.
"""

import json
import shutil
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

from mpi_operator_tpu.analysis import framework as jax_framework
from mpi_operator_tpu_torch.analysis import framework, lockcheck
from tests.test_analysis import (
    GUARDED_VIA_PRIVATE_HELPER,
    INVERSION,
    REENTRANT,
    UNGUARDED,
)

pytestmark = pytest.mark.kernel

REPO_ROOT = Path(__file__).resolve().parents[1]
BASELINE = REPO_ROOT / "mpi_operator_tpu_torch" / "analysis" / "baseline.json"
FAMILIES = ["TPU0", "TPU1", "TPU2", "TPU3", "TPU4"]


@pytest.fixture(scope="module")
def port_findings():
    return framework.run(framework.RepoView(REPO_ROOT))


def _jax_paths(text: str) -> str:
    return text.replace("mpi_operator_tpu_torch/", "mpi_operator_tpu/")


def _counts(findings) -> dict:
    out: dict = {}
    for f in findings:
        out[f.baseline_key] = out.get(f.baseline_key, 0) + 1
    return out


def test_port_has_no_new_findings(port_findings):
    fresh = framework.new_findings(
        port_findings, framework.load_baseline(BASELINE))
    assert fresh == [], "\n".join(
        ["new analyzer findings (fix, # noqa, or --update-baseline):"]
        + [f.render() for f in fresh])


def test_baseline_is_exactly_the_legacy_nodename_bind(port_findings):
    """Every baselined item still exists, and the only one is the
    runner's legacy ``nodeName`` bind, which the JAX baseline tracks
    for its own runner."""
    baseline = framework.load_baseline(BASELINE)
    assert baseline == _counts(port_findings)
    assert [key.split("|")[:2] for key in baseline] == [
        ["TPU303", "mpi_operator_tpu_torch/runtime/podrunner.py"]]
    assert [f for f in port_findings if f.rule_id == "TPU000"] == []


def test_lock_discipline_is_clean_on_the_port(port_findings):
    assert [f for f in port_findings if f.rule_id.startswith("TPU4")] == []


def test_the_view_is_the_port_and_its_smoke():
    rels = [sf.rel for sf in framework.RepoView(REPO_ROOT).files]
    assert "chip_smoke.py" in rels
    assert "mpi_operator_tpu_torch/runtime/kube.py" in rels
    assert all(r == "chip_smoke.py" or r.startswith("mpi_operator_tpu_torch/")
               for r in rels)


def test_analyze_cli_json_is_clean():
    proc = subprocess.run(
        [sys.executable, "-m", "mpi_operator_tpu_torch.cmd.analyze",
         "--format", "json", "--fail-on-new"],
        cwd=REPO_ROOT, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    doc = json.loads(proc.stdout)
    assert doc["new"] == []
    assert doc["baselined"] == 1
    assert doc["files"] > 100
    assert "TPU402" in doc["rules"]
    assert [r for r in doc["rules"] if r.startswith("TPU5")] == [
        f"TPU50{i}" for i in range(1, 8)]


def test_rule_catalog_is_the_jax_catalog_without_tpu5():
    """TPU0-TPU4: the same IDs, names and descriptions, the package paths
    renamed. TPU5 (``analysis/torchcheck.py``): JAX's IDs, with their
    torch descriptions. Five required families."""
    ours = [(r.id, r.name, _jax_paths(r.description))
            for r in framework.all_rules()
            if r.id.startswith(tuple(FAMILIES))]
    theirs = [(r.id, r.name, r.description)
              for r in jax_framework.all_rules()
              if r.id.startswith(tuple(FAMILIES))]
    assert ours == theirs
    tpu5 = [r for r in framework.all_rules() if r.id.startswith("TPU5")]
    jax5 = [r for r in jax_framework.all_rules() if r.id.startswith("TPU5")]
    assert [r.id for r in tpu5] == [r.id for r in jax5]
    for r in tpu5:
        assert "jax" not in r.description.lower() and "pallas" not in (
            r.description.lower()), r.id
    assert framework.missing_rule_families() == []
    assert sorted(framework.REQUIRED_RULE_FAMILIES) == [*FAMILIES, "TPU5"]
    assert framework.LEGACY_ALIASES == jax_framework.LEGACY_ALIASES


def _renamed(findings) -> list:
    return sorted((_jax_paths(f.file), f.line, f.rule_id,
                   _jax_paths(f.message)) for f in findings)


def test_jax_analyzer_over_a_renamed_copy_agrees(tmp_path, port_findings):
    """The port package copied as ``mpi_operator_tpu/`` beside
    ``chip_smoke.py``: the JAX analyzer's TPU0–TPU4 find what the port's
    analyzer finds in the real tree."""
    src = REPO_ROOT / "mpi_operator_tpu_torch"
    for path in src.rglob("*.py"):
        if "__pycache__" in path.parts:
            continue
        dest = tmp_path / "mpi_operator_tpu" / path.relative_to(src)
        dest.parent.mkdir(parents=True, exist_ok=True)
        shutil.copyfile(path, dest)
    shutil.copyfile(REPO_ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    view = jax_framework.RepoView(
        tmp_path, roots=["mpi_operator_tpu", "chip_smoke.py"])
    theirs = jax_framework.run(view, select=FAMILIES)
    assert sorted((f.file, f.line, f.rule_id, f.message)
                  for f in theirs) == _renamed(port_findings)


# The JAX analyzer tests' fixtures, and a few more of their cases.
FIXTURES = {
    "unguarded": UNGUARDED,
    "guarded-via-helper": GUARDED_VIA_PRIVATE_HELPER,
    "reentrant": REENTRANT,
    "inversion": INVERSION,
    "coded-noqa-and-alias": (
        "import os  # noqa: F401\nimport sys  # noqa: TPU001\n"
        "import json  # noqa: E722\n"),
    "blanket-noqa": "import os  # noqa\n",
    "syntax-error": "def broken(:\n",
    "print-and-import": "import os\nprint('hi')\n",
    "locktrace-factories": """
        from mpi_operator_tpu.runtime import locktrace

        class C:
            def __init__(self):
                self._lock = locktrace.lock("c")
                self._items = []

            def add(self, x):
                with self._lock:
                    self._items.append(x)

            def clear(self):
                self._items = []
    """,
    "goodput-squatter": """
        from mpi_operator_tpu.utils import metrics

        dup = metrics.new_gauge(
            "tpu_operator_job_goodput_ratio", "duplicate writer",
            ("namespace", "tpujob"),
        )
        phase = metrics.new_counter(
            "tpu_operator_job_phase_events_total", "prefix squatter",
        )
        fine = metrics.new_gauge("tpu_operator_other_gauge", "ok")
    """,
}


def _fixture_findings(fw, tmp_path: Path, source: str) -> list:
    (tmp_path / "mod.py").write_text(textwrap.dedent(source))
    repo = fw.RepoView(tmp_path, roots=["mod.py"])
    return [(f.file, f.line, f.rule_id, _jax_paths(f.message))
            for f in fw.run(repo, select=FAMILIES)]


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_fixture_findings_equal_the_jax_analyzer(tmp_path, name):
    ours = _fixture_findings(framework, tmp_path, FIXTURES[name])
    theirs = _fixture_findings(jax_framework, tmp_path, FIXTURES[name])
    assert ours == theirs
    expected = {
        "unguarded": ["TPU401"], "inversion": ["TPU402"],
        "coded-noqa-and-alias": ["TPU001"], "syntax-error": ["TPU000"],
        "print-and-import": ["TPU001", "TPU201"],
        "locktrace-factories": ["TPU401"],
        "goodput-squatter": ["TPU111", "TPU111"],
    }.get(name, [])
    assert sorted(f[2] for f in ours) == expected


def test_lockcheck_models_agree_on_the_inversion(tmp_path):
    from mpi_operator_tpu.analysis import lockcheck as jax_lockcheck

    (tmp_path / "mod.py").write_text(textwrap.dedent(INVERSION))
    ours = lockcheck.inversion_findings(lockcheck.build_model(
        framework.RepoView(tmp_path, roots=["mod.py"])))
    theirs = jax_lockcheck.inversion_findings(jax_lockcheck.build_model(
        jax_framework.RepoView(tmp_path, roots=["mod.py"])))
    assert [f.to_dict() for f in ours] == [f.to_dict() for f in theirs]
    assert "deadlock" in ours[0].message


def test_baseline_excess_is_new_in_both():
    def three(fw):
        return [fw.Finding("m.py", i, "TPU201", "print") for i in (1, 2, 3)]

    ours, theirs = three(framework), three(jax_framework)
    baseline = {ours[0].baseline_key: 2}
    assert ours[0].baseline_key == theirs[0].baseline_key
    assert ([f.line for f in framework.new_findings(ours, baseline)]
            == [f.line for f in jax_framework.new_findings(theirs, baseline)]
            == [3])
    assert framework.new_findings(ours[:1], baseline) == []


def test_baseline_roundtrip_matches_the_jax_format(tmp_path):
    findings = [framework.Finding("m.py", 1, "TPU201", "print")] * 2
    ours, theirs = tmp_path / "ours.json", tmp_path / "theirs.json"
    framework.write_baseline(ours, findings)
    jax_framework.write_baseline(
        theirs, [jax_framework.Finding("m.py", 1, "TPU201", "print")] * 2)
    assert ours.read_bytes() == theirs.read_bytes()
    assert framework.load_baseline(ours) == {findings[0].baseline_key: 2}
