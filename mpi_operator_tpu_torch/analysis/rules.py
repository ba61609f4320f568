"""The registered rule catalog (style, metrics, hygiene, sole-writer).

The port's copy of the JAX package's catalog: the same rule IDs,
messages and noqa aliases, with every package path under
``mpi_operator_tpu_torch/``. The pytest gate is
``tests/test_torch_analysis.py``; the CLI is ``python -m
mpi_operator_tpu_torch.cmd.analyze``.

Families:

- TPU001–TPU005 — style tier (legacy aliases F401/B006/E722/F541/F811)
- TPU101–TPU114 — Prometheus metric naming, required families,
  and sole-writer metric prefixes
- TPU201–TPU207 — control-plane hygiene (logging, sleep, swallowed
  exceptions, profiling phase vocabulary)
- TPU301–TPU303 — sole-writer invariants (``runPolicy.suspend``,
  pod ``status.phase``, ``spec.nodeName``)

The lock-discipline family (TPU401/TPU402) lives in ``lockcheck.py``.
"""

from __future__ import annotations

import ast
import re
from typing import Iterable, Iterator

from .framework import Finding, RepoView, SourceFile, rule

MUTABLE_NODES = (ast.List, ast.Dict, ast.Set, ast.ListComp, ast.DictComp,
                 ast.SetComp)

# Control-plane packages: writers that must stay responsive and honest
# under fault injection (the chaos tier exercises exactly these paths).
CONTROL_PLANE_PREFIXES = (
    "mpi_operator_tpu_torch/controller/",
    "mpi_operator_tpu_torch/scheduler/",
    "mpi_operator_tpu_torch/queue/",
)


def _is_operator_view(repo: RepoView) -> bool:
    """True when the view contains the operator package itself.  The
    presence rules (required metric families, logger adoption, phase
    emitters) assert that named modules keep doing something; on a
    fixture or subset view those modules are legitimately absent."""
    return any(
        sf.rel.startswith("mpi_operator_tpu_torch/") for sf in repo.files
    )


def _callee_name(node: ast.Call) -> str:
    fn = node.func
    if isinstance(fn, ast.Name):
        return fn.id
    if isinstance(fn, ast.Attribute):
        return fn.attr
    return ""


def _calls(sf: SourceFile) -> Iterator[tuple[int, str, ast.Call]]:
    if sf.tree is None:
        return
    for node in ast.walk(sf.tree):
        if isinstance(node, ast.Call):
            yield node.lineno, _callee_name(node), node


# ----------------------------------------------------------------------
# TPU001–TPU005: style tier (flake8 heritage)
# ----------------------------------------------------------------------


def _names_loaded(tree: ast.AST) -> set[str]:
    """Every identifier the module reads (attribute roots included;
    names inside string annotations are out of scope — rare cases are
    exempted by # noqa)."""
    used: set[str] = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Name) and isinstance(node.ctx, ast.Load):
            used.add(node.id)
        elif isinstance(node, ast.Attribute):
            root = node
            while isinstance(root, ast.Attribute):
                root = root.value
            if isinstance(root, ast.Name):
                used.add(root.id)
    return used


def _exported(tree: ast.AST) -> set[str]:
    out: set[str] = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign):
            for t in node.targets:
                if isinstance(t, ast.Name) and t.id == "__all__":
                    if isinstance(node.value, (ast.List, ast.Tuple)):
                        for elt in node.value.elts:
                            if isinstance(elt, ast.Constant) and isinstance(
                                    elt.value, str):
                                out.add(elt.value)
    return out


def style_findings(sf: SourceFile) -> list[Finding]:
    """The TPU001–TPU005 findings for one file (noqa NOT applied here —
    the framework filters)."""
    cached = getattr(sf, "_style_findings", None)
    if cached is not None:
        return cached
    findings: list[Finding] = []
    tree = sf.tree
    if tree is None:
        sf._style_findings = findings
        return findings

    # --- TPU001 (F401) unused imports ---------------------------------
    is_init = sf.path.name == "__init__.py"
    used = _names_loaded(tree)
    exported = _exported(tree)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                bound = (a.asname or a.name).split(".")[0]
                if not is_init and bound not in used and bound not in exported:
                    findings.append(Finding(
                        sf.rel, node.lineno, "TPU001",
                        f"'{a.name}' imported but unused",
                    ))
        elif isinstance(node, ast.ImportFrom):
            if node.module == "__future__":
                continue
            for a in node.names:
                if a.name == "*":
                    continue
                bound = a.asname or a.name
                # In __init__.py an import IS the export surface; an
                # explicit ``x as x`` alias is the PEP-484 re-export
                # idiom elsewhere.
                reexport = is_init or (a.asname is not None
                                       and a.asname == a.name)
                if bound not in used and bound not in exported and not reexport:
                    findings.append(Finding(
                        sf.rel, node.lineno, "TPU001",
                        f"'{a.name}' imported but unused",
                    ))

    # Format specs ({x:.1f}) parse as nested JoinedStr nodes with no
    # FormattedValue of their own — they are not f-strings to flag.
    spec_ids = {
        id(n.format_spec)
        for n in ast.walk(tree)
        if isinstance(n, ast.FormattedValue) and n.format_spec is not None
    }

    for node in ast.walk(tree):
        # --- TPU002 (B006) mutable defaults ---------------------------
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            defaults = list(node.args.defaults) + [
                d for d in node.args.kw_defaults if d is not None
            ]
            for d in defaults:
                if isinstance(d, MUTABLE_NODES):
                    findings.append(Finding(
                        sf.rel, d.lineno, "TPU002",
                        f"mutable default argument in {node.name}()",
                    ))
        # --- TPU003 (E722) bare except --------------------------------
        if isinstance(node, ast.ExceptHandler) and node.type is None:
            findings.append(Finding(
                sf.rel, node.lineno, "TPU003", "bare 'except:'",
            ))
        # --- TPU004 (F541) f-string without placeholders --------------
        if isinstance(node, ast.JoinedStr) and id(node) not in spec_ids:
            if not any(isinstance(v, ast.FormattedValue)
                       for v in node.values):
                findings.append(Finding(
                    sf.rel, node.lineno, "TPU004",
                    "f-string without any placeholders",
                ))

    # --- TPU005 (F811) redefinition in the same scope -----------------
    def scope_check(body: list, where: str) -> None:
        seen: dict[str, tuple[int, set]] = {}
        for stmt in body:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
                decos = {
                    d.id if isinstance(d, ast.Name)
                    else d.attr if isinstance(d, ast.Attribute) else ""
                    for d in getattr(stmt, "decorator_list", [])
                }
                legit = decos & {"overload", "setter", "deleter", "getter",
                                 "register", "property"}
                prev = seen.get(stmt.name)
                # The undecorated implementation after @overload stubs is
                # the pattern working as intended (pyflakes exempts it by
                # remembering the PRIOR binding's decorators).
                prev_overload = prev is not None and "overload" in prev[1]
                if prev is not None and not legit and not prev_overload:
                    findings.append(Finding(
                        sf.rel, stmt.lineno, "TPU005",
                        f"redefinition of '{stmt.name}' (first defined at "
                        f"line {prev[0]}) in {where}",
                    ))
                seen[stmt.name] = (stmt.lineno, decos)
                scope_check(stmt.body, f"'{stmt.name}'")

    scope_check(tree.body, "module scope")
    sf._style_findings = findings
    return findings


def _style_rule(rule_id: str):
    def check(repo: RepoView) -> Iterable[Finding]:
        for sf in repo.files:
            for f in style_findings(sf):
                if f.rule_id == rule_id:
                    yield f
    return check


rule("TPU001", "unused-import",
     "Import is never used (F401); __init__.py re-exports, __all__ "
     "entries, and explicit `x as x` aliases are exempt.")(
    _style_rule("TPU001"))
rule("TPU002", "mutable-default",
     "Mutable default argument shared across calls (B006).")(
    _style_rule("TPU002"))
rule("TPU003", "bare-except",
     "Bare `except:` catches SystemExit/KeyboardInterrupt (E722).")(
    _style_rule("TPU003"))
rule("TPU004", "pointless-fstring",
     "f-string without placeholders (F541).")(
    _style_rule("TPU004"))
rule("TPU005", "redefinition",
     "def/class redefines a name already bound in the same scope "
     "(F811); @overload/@property setters are legitimate.")(
    _style_rule("TPU005"))


# ----------------------------------------------------------------------
# TPU101–TPU114: Prometheus metric conventions
# ----------------------------------------------------------------------

_METRIC_CTORS = ("new_counter", "new_gauge", "new_histogram")


def _metric_registrations(repo: RepoView):
    """(sf, lineno, kind, name, node) for every literal metric
    registration in the package source."""
    for sf in repo.package_files():
        for lineno, callee, node in _calls(sf):
            if callee not in _METRIC_CTORS:
                continue
            if not (node.args and isinstance(node.args[0], ast.Constant)
                    and isinstance(node.args[0].value, str)):
                continue
            yield sf, lineno, callee, node.args[0].value, node


@rule("TPU101", "metric-namespace",
      "Every metric carries the tpu_operator_ namespace prefix.")
def check_metric_namespace(repo: RepoView) -> Iterable[Finding]:
    for sf, line, kind, name, _ in _metric_registrations(repo):
        if not name.startswith("tpu_operator_"):
            yield Finding(sf.rel, line, "TPU101",
                          f"{kind}({name!r}): missing tpu_operator_ prefix")


@rule("TPU102", "counter-suffix",
      "Counters end in _total (Prometheus convention).")
def check_counter_suffix(repo: RepoView) -> Iterable[Finding]:
    for sf, line, kind, name, _ in _metric_registrations(repo):
        if kind == "new_counter" and not name.endswith("_total"):
            yield Finding(sf.rel, line, "TPU102",
                          f"{kind}({name!r}): counter must end in _total")


@rule("TPU103", "histogram-suffix",
      "Histograms use seconds as the base unit and end in _seconds.")
def check_histogram_suffix(repo: RepoView) -> Iterable[Finding]:
    for sf, line, kind, name, _ in _metric_registrations(repo):
        if kind == "new_histogram" and not name.endswith("_seconds"):
            yield Finding(sf.rel, line, "TPU103",
                          f"{kind}({name!r}): histogram must end in _seconds")


_SUBSYSTEM_PREFIXES = [
    ("TPU104", "mpi_operator_tpu_torch/scheduler/", "tpu_operator_scheduler_"),
    ("TPU105", "mpi_operator_tpu_torch/queue/", "tpu_operator_queue_"),
    ("TPU106", "mpi_operator_tpu_torch/chaos/", "tpu_operator_chaos_"),
]


def _subsystem_rule(rule_id: str, pkg_prefix: str, metric_prefix: str):
    def check(repo: RepoView) -> Iterable[Finding]:
        for sf, line, kind, name, _ in _metric_registrations(repo):
            if sf.rel.startswith(pkg_prefix) and not name.startswith(
                    metric_prefix):
                yield Finding(
                    sf.rel, line, rule_id,
                    f"{kind}({name!r}): missing {metric_prefix} prefix",
                )
    return check


for _rid, _pkg, _metric in _SUBSYSTEM_PREFIXES:
    rule(_rid, f"{_pkg.split('/')[1]}-metric-prefix",
         f"Metrics registered under {_pkg} carry the {_metric} subsystem "
         "prefix so dashboards select the subsystem with one matcher.")(
        _subsystem_rule(_rid, _pkg, _metric))


def _gauges_with_labels(repo: RepoView):
    """(sf, lineno, name, label-names-or-None) for every literal
    new_gauge registration; labels is None when not a literal tuple."""
    for sf, line, kind, name, node in _metric_registrations(repo):
        if kind != "new_gauge":
            continue
        labels_node = node.args[2] if len(node.args) > 2 else None
        if labels_node is None:
            for kw in node.keywords:
                if kw.arg == "label_names":
                    labels_node = kw.value
        labels = None
        if labels_node is None:
            labels = ()
        elif isinstance(labels_node, (ast.Tuple, ast.List)) and all(
            isinstance(e, ast.Constant) and isinstance(e.value, str)
            for e in labels_node.elts
        ):
            labels = tuple(e.value for e in labels_node.elts)
        yield sf, line, name, labels


@rule("TPU107", "gauge-not-total",
      "Gauges never end in _total — that suffix promises a counter.")
def check_gauge_not_total(repo: RepoView) -> Iterable[Finding]:
    for sf, line, name, _ in _gauges_with_labels(repo):
        if name.endswith("_total"):
            yield Finding(sf.rel, line, "TPU107",
                          f"new_gauge({name!r}): _total suffix promises "
                          "a counter")


@rule("TPU108", "info-gauge-labels",
      "_info gauges carry identity as labels (constant value 1 means "
      "the labels ARE the payload).")
def check_info_gauge_labels(repo: RepoView) -> Iterable[Finding]:
    for sf, line, name, labels in _gauges_with_labels(repo):
        if name.endswith("_info") and labels is not None and not labels:
            yield Finding(sf.rel, line, "TPU108",
                          f"new_gauge({name!r}): _info gauge needs "
                          "identity labels")


@rule("TPU109", "by-phase-gauge-label",
      "by_phase gauges declare the phase label they enumerate.")
def check_by_phase_gauge_label(repo: RepoView) -> Iterable[Finding]:
    for sf, line, name, labels in _gauges_with_labels(repo):
        if "by_phase" in name and labels is not None and "phase" not in labels:
            yield Finding(sf.rel, line, "TPU109",
                          f"new_gauge({name!r}): by_phase gauge must "
                          "declare a phase label")


# Advertised metric families: their registrations must not silently
# vanish in a refactor.  Findings anchor at the owning module's head.
_REQUIRED_FAMILIES = [
    ("mpi_operator_tpu_torch/scheduler/core.py", {
        "tpu_operator_scheduler_scheduling_duration_seconds",
        "tpu_operator_scheduler_pending_gangs",
        "tpu_operator_scheduler_binds_total",
        "tpu_operator_scheduler_preemptions_total",
    }),
    ("mpi_operator_tpu_torch/queue/manager.py", {
        "tpu_operator_queue_pending_workloads",
        "tpu_operator_queue_admitted_workloads",
        "tpu_operator_queue_admission_duration_seconds",
        "tpu_operator_queue_evictions_total",
    }),
    ("mpi_operator_tpu_torch/chaos/engine.py", {
        "tpu_operator_chaos_faults_injected_total",
        "tpu_operator_chaos_pod_kills_total",
    }),
    ("mpi_operator_tpu_torch/utils/statemetrics.py", {
        "tpu_operator_job_info",
        "tpu_operator_jobs_by_phase",
        "tpu_operator_pods_by_phase",
        "tpu_operator_job_condition",
    }),
    ("mpi_operator_tpu_torch/utils/goodput.py", {
        "tpu_operator_job_goodput_ratio",
        "tpu_operator_job_phase_seconds",
        "tpu_operator_job_goodput_fleet_ratio",
        "tpu_operator_job_phase_fleet_seconds",
    }),
    ("mpi_operator_tpu_torch/utils/stepstats.py", {
        "tpu_operator_job_step_skew",
        "tpu_operator_job_stragglers",
    }),
    ("mpi_operator_tpu_torch/utils/devstats.py", {
        "tpu_operator_job_hbm_peak_bytes",
        "tpu_operator_job_hbm_headroom_ratio",
    }),
    ("mpi_operator_tpu_torch/utils/checkpoint.py", {
        "tpu_operator_job_checkpoint_snapshot_seconds",
        "tpu_operator_job_checkpoint_write_seconds",
        "tpu_operator_job_checkpoint_commits_total",
    }),
]


@rule("TPU110", "required-metric-families",
      "The advertised metric families (scheduler/queue/chaos quartets, "
      "the kube-state family) stay registered.")
def check_required_metric_families(repo: RepoView) -> Iterable[Finding]:
    if not _is_operator_view(repo):
        return
    registered = {name for _, _, _, name, _ in _metric_registrations(repo)}
    if len(registered) < 10:
        yield Finding("mpi_operator_tpu_torch/utils/metrics.py", 1, "TPU110",
                      "metric registrations went missing (<10 literal "
                      "registrations in the package)")
    for anchor, required in _REQUIRED_FAMILIES:
        for name in sorted(required - registered):
            yield Finding(anchor, 1, "TPU110",
                          f"required metric {name!r} is not registered")


# The goodput ledger's families are an *attribution*: a second writer
# under these prefixes would double-count phases or split the series
# across owners, and dashboards keyed on the prefix could not tell.
_GOODPUT_PREFIXES = ("tpu_operator_job_goodput", "tpu_operator_job_phase")
_GOODPUT_OWNER = "mpi_operator_tpu_torch/utils/goodput.py"


@rule("TPU111", "goodput-metric-sole-writer",
      "The tpu_operator_job_goodput*/tpu_operator_job_phase* metric "
      "prefixes are reserved for utils/goodput.py, the goodput ledger.")
def check_goodput_sole_writer(repo: RepoView) -> Iterable[Finding]:
    for sf, line, kind, name, _ in _metric_registrations(repo):
        if not name.startswith(_GOODPUT_PREFIXES):
            continue
        if sf.rel != _GOODPUT_OWNER:
            yield Finding(
                sf.rel, line, "TPU111",
                f"{kind}({name!r}): goodput/phase metric prefixes are "
                f"reserved for {_GOODPUT_OWNER}",
            )


# The step-skew families are a cross-worker *join*: a second writer
# would split the straggler verdicts across owners and decouple the
# skew histogram from the skew_wait carve it explains.
_STEPSTATS_PREFIXES = (
    "tpu_operator_job_step", "tpu_operator_job_stragglers",
)
_STEPSTATS_OWNER = "mpi_operator_tpu_torch/utils/stepstats.py"


@rule("TPU112", "stepstats-metric-sole-writer",
      "The tpu_operator_job_step*/tpu_operator_job_stragglers metric "
      "prefixes are reserved for utils/stepstats.py, the step-skew "
      "observatory.")
def check_stepstats_sole_writer(repo: RepoView) -> Iterable[Finding]:
    for sf, line, kind, name, _ in _metric_registrations(repo):
        if not name.startswith(_STEPSTATS_PREFIXES):
            continue
        if sf.rel != _STEPSTATS_OWNER:
            yield Finding(
                sf.rel, line, "TPU112",
                f"{kind}({name!r}): step-skew metric prefixes are "
                f"reserved for {_STEPSTATS_OWNER}",
            )


# The device-memory families are the same kind of cross-worker join:
# a second writer would split the watermark/headroom series across
# owners and decouple them from the MemoryPressure verdicts they
# explain.
_DEVSTATS_PREFIXES = ("tpu_operator_job_hbm",)
_DEVSTATS_OWNER = "mpi_operator_tpu_torch/utils/devstats.py"


@rule("TPU113", "devstats-metric-sole-writer",
      "The tpu_operator_job_hbm* metric prefixes are reserved for "
      "utils/devstats.py, the device-memory observatory.")
def check_devstats_sole_writer(repo: RepoView) -> Iterable[Finding]:
    for sf, line, kind, name, _ in _metric_registrations(repo):
        if not name.startswith(_DEVSTATS_PREFIXES):
            continue
        if sf.rel != _DEVSTATS_OWNER:
            yield Finding(
                sf.rel, line, "TPU113",
                f"{kind}({name!r}): device-memory metric prefixes are "
                f"reserved for {_DEVSTATS_OWNER}",
            )


# The checkpoint families narrate one durability pipeline (snapshot ->
# background write -> commit marker): a second writer would interleave
# foreign samples into the write/commit ratio that the torn-write
# forensics read, and make "commits != saves" undiagnosable.
_CHECKPOINT_PREFIXES = ("tpu_operator_job_checkpoint",)
_CHECKPOINT_OWNER = "mpi_operator_tpu_torch/utils/checkpoint.py"


@rule("TPU114", "checkpoint-metric-sole-writer",
      "The tpu_operator_job_checkpoint* metric prefix is reserved for "
      "utils/checkpoint.py, the checkpoint durability pipeline.")
def check_checkpoint_sole_writer(repo: RepoView) -> Iterable[Finding]:
    for sf, line, kind, name, _ in _metric_registrations(repo):
        if not name.startswith(_CHECKPOINT_PREFIXES):
            continue
        if sf.rel != _CHECKPOINT_OWNER:
            yield Finding(
                sf.rel, line, "TPU114",
                f"{kind}({name!r}): checkpoint metric prefixes are "
                f"reserved for {_CHECKPOINT_OWNER}",
            )


# ----------------------------------------------------------------------
# TPU201–TPU207: control-plane hygiene
# ----------------------------------------------------------------------


@rule("TPU201", "no-print-outside-cmd",
      "Operator/runtime/scheduler code logs through the structured "
      "logger; bare print() is only legitimate in cmd/ entrypoints.")
def check_no_print(repo: RepoView) -> Iterable[Finding]:
    for sf in repo.package_files():
        if sf.rel.startswith("mpi_operator_tpu_torch/cmd/"):
            continue
        for line, callee, _ in _calls(sf):
            if callee == "print":
                yield Finding(sf.rel, line, "TPU201", "print() outside cmd/")


@rule("TPU202", "structured-logging-only",
      "Logger handles come from utils/logging.get_logger; stdlib "
      "logging.getLogger bypasses the process-global sink.")
def check_get_logger(repo: RepoView) -> Iterable[Finding]:
    for sf in repo.package_files():
        if sf.rel == "mpi_operator_tpu_torch/utils/logging.py":
            continue
        for line, callee, _ in _calls(sf):
            if callee == "getLogger":
                yield Finding(sf.rel, line, "TPU202",
                              "logging.getLogger() bypasses utils/logging")


@rule("TPU203", "no-bare-sleep",
      "Control-plane code pauses through runtime/retry.sleep, the "
      "single monkeypatchable chokepoint the chaos soak collapses.")
def check_no_bare_sleep(repo: RepoView) -> Iterable[Finding]:
    for sf in repo.package_files():
        if not sf.rel.startswith(CONTROL_PLANE_PREFIXES):
            continue
        for line, callee, node in _calls(sf):
            if callee != "sleep":
                continue
            fn = node.func
            bare_name = isinstance(fn, ast.Name)  # `from time import sleep`
            time_attr = (
                isinstance(fn, ast.Attribute)
                and isinstance(fn.value, ast.Name)
                and fn.value.id == "time"
            )
            if bare_name or time_attr:
                yield Finding(sf.rel, line, "TPU203",
                              "bare sleep() — use runtime/retry.sleep")


@rule("TPU204", "no-swallowed-exceptions",
      "`except Exception: pass` in controller/scheduler/queue silently "
      "eats the faults the chaos tier injects.")
def check_no_swallowed(repo: RepoView) -> Iterable[Finding]:
    for sf in repo.package_files():
        if not sf.rel.startswith(CONTROL_PLANE_PREFIXES) or sf.tree is None:
            continue
        for node in ast.walk(sf.tree):
            if not isinstance(node, ast.ExceptHandler):
                continue
            broad = node.type is None or (
                isinstance(node.type, ast.Name)
                and node.type.id in ("Exception", "BaseException")
            )
            silent = all(isinstance(stmt, ast.Pass) for stmt in node.body)
            if broad and silent:
                yield Finding(sf.rel, node.lineno, "TPU204",
                              "except Exception: pass swallows injected "
                              "faults")


@rule("TPU205", "canonical-phase-names",
      "Every .phase(...) call site passes a PHASE_* constant or a "
      "literal registered in profiling.PHASES (closed vocabulary).")
def check_phase_vocabulary(repo: RepoView) -> Iterable[Finding]:
    from mpi_operator_tpu_torch.utils import profiling

    if not _is_operator_view(repo):
        return
    profiling_rel = "mpi_operator_tpu_torch/utils/profiling.py"
    if not profiling.PHASES:
        yield Finding(profiling_rel, 1, "TPU205", "phase enum went missing")
        return
    for name in profiling.PHASES:
        if not re.fullmatch(r"[a-z_]+", name):
            yield Finding(profiling_rel, 1, "TPU205",
                          f"profiling phase {name!r} must match ^[a-z_]+$")
    if len(set(profiling.PHASES)) != len(profiling.PHASES):
        yield Finding(profiling_rel, 1, "TPU205",
                      "duplicate names in profiling.PHASES")
    if profiling.UNATTRIBUTED in profiling.PHASES:
        yield Finding(profiling_rel, 1, "TPU205",
                      "UNATTRIBUTED is a derived share label, never a "
                      "phase name")

    for sf in repo.package_files():
        # The enum's home defines phase() itself (the validating
        # constructor and the `profiled` decorator's pass-through).
        if sf.rel == profiling_rel:
            continue
        for line, callee, node in _calls(sf):
            if callee != "phase" or not isinstance(node.func, ast.Attribute):
                continue
            if not node.args:
                yield Finding(sf.rel, line, "TPU205",
                              ".phase() with no name")
            elif not (isinstance(node.args[0], ast.Constant)
                      and isinstance(node.args[0].value, str)):
                # Attribute references to the canonical constants are
                # the sanctioned spelling (profiling.PHASE_RENDER,
                # never a name computed at runtime).
                arg = node.args[0]
                is_const_ref = (
                    isinstance(arg, ast.Attribute)
                    and arg.attr.startswith("PHASE_")
                ) or (isinstance(arg, ast.Name)
                      and arg.id.startswith("PHASE_"))
                if not is_const_ref:
                    yield Finding(
                        sf.rel, line, "TPU205",
                        ".phase() argument must be a PHASE_* constant or "
                        "a literal registered in profiling.PHASES",
                    )
            elif node.args[0].value not in profiling.PHASES:
                yield Finding(
                    sf.rel, line, "TPU205",
                    f"phase {node.args[0].value!r} not registered in "
                    "profiling.PHASES",
                )


_REQUIRED_LOGGER_USERS = (
    "mpi_operator_tpu_torch/controller/tpu_job_controller.py",
    "mpi_operator_tpu_torch/scheduler/core.py",
    "mpi_operator_tpu_torch/runtime/podrunner.py",
    "mpi_operator_tpu_torch/launcher/bootstrap.py",
)


@rule("TPU206", "logger-adoption",
      "The sanctioned get_logger constructor stays in use across the "
      "controller, scheduler, podrunner, and launcher layers.")
def check_logger_adoption(repo: RepoView) -> Iterable[Finding]:
    if not _is_operator_view(repo):
        return
    users = {
        sf.rel for sf in repo.package_files()
        for _, callee, _ in _calls(sf) if callee == "get_logger"
    }
    for expected in _REQUIRED_LOGGER_USERS:
        if expected not in users:
            yield Finding(expected, 1, "TPU206",
                          "must use utils/logging.get_logger")


_REQUIRED_PHASE_EMITTERS = (
    "mpi_operator_tpu_torch/controller/tpu_job_controller.py",
    "mpi_operator_tpu_torch/scheduler/core.py",
    "mpi_operator_tpu_torch/scheduler/binder.py",
    "mpi_operator_tpu_torch/queue/manager.py",
)


@rule("TPU207", "phase-attribution-coverage",
      "The hot control-plane paths keep emitting phase timings (the "
      "/debug/profile attribution layer stays wired).")
def check_phase_emitters(repo: RepoView) -> Iterable[Finding]:
    if not _is_operator_view(repo):
        return
    users = {
        sf.rel for sf in repo.package_files()
        for _, callee, node in _calls(sf)
        if callee == "phase" and isinstance(node.func, ast.Attribute)
        and sf.rel != "mpi_operator_tpu_torch/utils/profiling.py"
    }
    for expected in _REQUIRED_PHASE_EMITTERS:
        if expected not in users:
            yield Finding(expected, 1, "TPU207", "must emit phase timings")


# ----------------------------------------------------------------------
# TPU301–TPU303: sole-writer invariants
# ----------------------------------------------------------------------


def _assignment_targets(node: ast.AST) -> list:
    if isinstance(node, ast.Assign):
        return list(node.targets)
    if isinstance(node, (ast.AugAssign, ast.AnnAssign)):
        return [node.target]
    return []


def _writes_key(target, key: str) -> bool:
    """Does this assignment target write attribute/item ``key``?"""
    if isinstance(target, ast.Attribute) and target.attr == key:
        return True
    if (isinstance(target, ast.Subscript)
            and isinstance(target.slice, ast.Constant)
            and target.slice.value == key):
        return True
    if isinstance(target, (ast.Tuple, ast.List)):
        return any(_writes_key(e, key) for e in target.elts)
    return False


def _sole_writer_rule(rule_id: str, key: str, allowed, message: str):
    allowed_prefixes = tuple(a for a in allowed if a.endswith("/"))
    allowed_files = {a for a in allowed if not a.endswith("/")}

    def check(repo: RepoView) -> Iterable[Finding]:
        for sf in repo.package_files():
            if sf.rel.startswith(allowed_prefixes) or sf.rel in allowed_files:
                continue
            if sf.tree is None:
                continue
            for node in ast.walk(sf.tree):
                for target in _assignment_targets(node):
                    if _writes_key(target, key):
                        yield Finding(sf.rel, node.lineno, rule_id, message)
    return check


rule("TPU301", "suspend-sole-writer",
     "While the admission queue is enabled the QueueManager is the "
     "single writer of runPolicy.suspend — a second writer would fight "
     "it (admit/evict flapping).  The API types' own (de)serialization "
     "is exempt.")(
    _sole_writer_rule(
        "TPU301", "suspend",
        ["mpi_operator_tpu_torch/queue/",
         "mpi_operator_tpu_torch/api/v2beta1/types.py"],
        "suspend write outside queue/ (QueueManager is the sole writer)",
    ))

# The kubelet analog owns pod lifecycle: in this codebase the
# controller never writes pod status.phase — runtime/podrunner.py is
# the node agent that flips Pending/Running/Succeeded/Failed, and the
# API types (de)serialize their own field.
rule("TPU302", "pod-phase-sole-writer",
     "Pod status.phase transitions are the kubelet analog's to make: "
     "only runtime/podrunner.py (and the API types' own round-trip) "
     "may assign the phase field.")(
    _sole_writer_rule(
        "TPU302", "phase",
        ["mpi_operator_tpu_torch/runtime/podrunner.py",
         "mpi_operator_tpu_torch/api/v2beta1/types.py"],
        "status.phase write outside runtime/podrunner.py (the kubelet "
        "analog is the sole writer)",
    ))

rule("TPU303", "nodename-sole-writer",
     "spec.nodeName binds are the scheduler's decision: only "
     "scheduler/binder.py may assign it.  The legacy auto-bind path in "
     "podrunner is tracked in the committed baseline, not silenced.")(
    _sole_writer_rule(
        "TPU303", "nodeName",
        ["mpi_operator_tpu_torch/scheduler/binder.py"],
        "spec.nodeName bind outside scheduler/binder.py (the scheduler "
        "is the sole writer)",
    ))
