"""Rule framework: findings, the rule registry, noqa, and baselines.

The golangci-lint shape without golangci-lint: every check is a
registered :class:`Rule` with a stable ``TPUxxx`` ID, checks run over a
:class:`RepoView` (one parse per file, shared by every rule), findings
carry ``file:line`` locations, and a committed baseline file lets new
violations fail CI while legacy ones stay tracked instead of silenced.

Suppression contract (flake8 semantics, extended):

- a bare ``# noqa`` on the offending line suppresses every rule there;
- ``# noqa: TPU101,TPU203`` suppresses only the listed rule IDs;
- the five style rules also honour their legacy flake8 aliases
  (``# noqa: F401`` still silences TPU001), as the JAX package's
  analyzer does, so a suppression comment means the same in both trees.

Baseline contract: keys are ``rule_id|file|message`` — deliberately
line-independent so unrelated edits shifting a legacy finding by a few
lines do not resurrect it — with an occurrence count per key.  "New"
findings are occurrences in excess of the baselined count; a shrunk
count is progress, not drift (regenerate with ``--update-baseline``).

Beside the registry it keeps the shared passes the rule modules walk:
the call-graph fixpoints of lockcheck (TPU4xx) and the per-module call
graph (:class:`ModuleGraph`, :func:`module_graph`) whose reachability the
torch perf-correctness rules (TPU5xx, ``torchcheck``) follow from a step
root; :data:`REQUIRED_RULE_FAMILIES` names the five families TPU0-TPU5.
"""

from __future__ import annotations

import ast
import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Iterable, Optional

# What the port's analyzer lints: the port package and its card smoke.
# ``tests/`` stays with the JAX package's analyzer, which already lints
# the port's test files, so no file is gated under two baselines.
REPO_ROOTS = ["mpi_operator_tpu_torch", "chip_smoke.py"]

# The style rules keep honouring their original flake8 codes in noqa
# comments.
LEGACY_ALIASES = {
    "TPU001": "F401",
    "TPU002": "B006",
    "TPU003": "E722",
    "TPU004": "F541",
    "TPU005": "F811",
}

SYNTAX_RULE_ID = "TPU000"


@dataclass(frozen=True, order=True)
class Finding:
    file: str  # repo-relative, forward slashes
    line: int
    rule_id: str
    message: str

    @property
    def baseline_key(self) -> str:
        return f"{self.rule_id}|{self.file}|{self.message}"

    def render(self) -> str:
        return f"{self.file}:{self.line}: {self.rule_id} {self.message}"

    def to_dict(self) -> dict:
        return {
            "rule": self.rule_id,
            "file": self.file,
            "line": self.line,
            "message": self.message,
        }


class SourceFile:
    """One parsed source file: lazy AST, line access, noqa lookup."""

    def __init__(self, path: Path, rel: str):
        self.path = path
        self.rel = rel.replace("\\", "/")
        self.text = path.read_text()
        self.lines = self.text.splitlines()
        self._tree: Optional[ast.AST] = None
        self._parsed = False
        self.syntax_error: Optional[SyntaxError] = None

    @property
    def tree(self) -> Optional[ast.AST]:
        if not self._parsed:
            self._parsed = True
            try:
                self._tree = ast.parse(self.text, filename=str(self.path))
            except SyntaxError as e:
                self.syntax_error = e
        return self._tree

    def noqa(self, lineno: int, rule_id: str) -> bool:
        if not 0 < lineno <= len(self.lines):
            return False
        line = self.lines[lineno - 1]
        idx = line.find("# noqa")
        if idx < 0:
            return False
        rest = line[idx + len("# noqa"):]
        if not rest.lstrip().startswith(":"):
            return True  # blanket suppression
        listed = {c.strip() for c in rest.lstrip()[1:].split(",")}
        accepted = {rule_id}
        alias = LEGACY_ALIASES.get(rule_id)
        if alias:
            accepted.add(alias)
        return bool(accepted & listed)


class RepoView:
    """The file set every rule runs over (one parse per file)."""

    def __init__(self, root: Path, roots: Optional[list[str]] = None):
        self.root = Path(root).resolve()
        self.files: list[SourceFile] = []
        self._by_rel: dict[str, SourceFile] = {}
        for entry in (roots if roots is not None else REPO_ROOTS):
            p = self.root / entry
            if not p.exists():
                continue
            paths = [p] if p.suffix == ".py" else sorted(p.rglob("*.py"))
            for f in paths:
                if "__pycache__" in f.parts:
                    continue
                rel = str(f.relative_to(self.root)).replace("\\", "/")
                if rel in self._by_rel:
                    continue
                sf = SourceFile(f, rel)
                self.files.append(sf)
                self._by_rel[rel] = sf

    def file(self, rel: str) -> Optional[SourceFile]:
        return self._by_rel.get(rel)

    def package_files(self) -> list[SourceFile]:
        """The operator package itself — where the semantic invariants
        (metric naming, sole writers, lock discipline) apply.  A view
        with no package tree (a test fixture, or ``--root`` pointed at a
        subset) applies them to every file instead."""
        pkg = [
            sf for sf in self.files
            if sf.rel.startswith("mpi_operator_tpu_torch/")
        ]
        return pkg or self.files


# ----------------------------------------------------------------------
# Call-graph fixpoints (lockcheck's may-acquire and held-on-entry sets)
# ----------------------------------------------------------------------


def union_fixpoint(
    seed: dict, edges: dict
) -> dict:
    """Least fixpoint of ``acc[k] = seed[k] | U(acc[d] for d in
    edges[k])`` — transitive accumulation along call edges (lockcheck's
    may-acquire sets; generic transitive closure)."""
    acc = {k: frozenset(v) for k, v in seed.items()}
    changed = True
    while changed:
        changed = False
        for k in acc:
            v = acc[k]
            for dep in edges.get(k, ()):
                v = v | acc.get(dep, frozenset())
            if v != acc[k]:
                acc[k] = v
                changed = True
    return acc


def intersect_fixpoint(entry: dict, call_sites: dict) -> dict:
    """Greatest fixpoint of ``entry[k] = &((entry[caller] | extra) for
    (caller, extra) in call_sites[k])`` — "provably true on EVERY
    entry" inference (lockcheck's held-on-entry sets).  Keys whose
    entry set is already empty are external entry points and never
    shrink further."""
    entry = dict(entry)
    changed = True
    while changed:
        changed = False
        for name, sites in call_sites.items():
            if not entry.get(name):
                continue
            acc = entry[name]
            for caller, extra in sites:
                acc = acc & (entry.get(caller, frozenset()) | extra)
            if acc != entry[name]:
                entry[name] = acc
                changed = True
    return entry


@dataclass
class FunctionNode:
    """One function/method/closure definition in a module call graph."""

    name: str            # simple name
    qualname: str        # dotted lexical path ("Cls.m", "make.step")
    node: ast.AST        # the FunctionDef / AsyncFunctionDef
    lineno: int
    parent: Optional[str] = None   # enclosing def's qualname
    in_loop: bool = False          # defined lexically inside for/while
    calls: list = field(default_factory=list)  # (callee simple name, line)


class ModuleGraph:
    """Module-level call graph: every def (including closures and
    methods) plus simple-name call edges.  Resolution is by simple name
    — a heuristic vet, not a prover, matching lockcheck's contract."""

    def __init__(self, sf: SourceFile):
        self.sf = sf
        self.functions: list[FunctionNode] = []
        self.by_name: dict[str, list[FunctionNode]] = {}
        if sf.tree is not None:
            self._collect(sf.tree, parent=None, in_loop=False)

    def _collect(self, node: ast.AST, parent: Optional[str],
                 in_loop: bool) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                qual = (f"{parent}.{child.name}" if parent else child.name)
                fn = FunctionNode(
                    child.name, qual, child, child.lineno, parent, in_loop)
                fn.calls = self._direct_calls(child)
                self.functions.append(fn)
                self.by_name.setdefault(child.name, []).append(fn)
                self._collect(child, parent=qual, in_loop=in_loop)
            elif isinstance(child, ast.ClassDef):
                self._collect(child, parent=child.name, in_loop=in_loop)
            else:
                looped = in_loop or isinstance(
                    child, (ast.For, ast.AsyncFor, ast.While))
                self._collect(child, parent=parent, in_loop=looped)

    @staticmethod
    def _direct_calls(fn_node: ast.AST) -> list:
        """(simple callee name, lineno) pairs in this def's own body —
        nested defs keep their calls (they are their own nodes)."""
        out = []
        stack = [c for c in ast.iter_child_nodes(fn_node)]
        while stack:
            node = stack.pop()
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            if isinstance(node, ast.Call):
                f = node.func
                callee = (
                    f.id if isinstance(f, ast.Name)
                    else f.attr if isinstance(f, ast.Attribute) else None
                )
                if callee:
                    out.append((callee, node.lineno))
            stack.extend(ast.iter_child_nodes(node))
        return out

    def reachable(self, roots: Iterable[FunctionNode],
                  stop: Optional[Callable[[FunctionNode], bool]] = None,
                  ) -> list[FunctionNode]:
        """Defs reachable from ``roots`` via simple-name call edges.
        ``stop`` prunes traversal *through* a node (it is still
        returned) — torchcheck stops at compiled boundaries, where implicit
        host transfers cannot hide."""
        seen: dict[str, FunctionNode] = {}
        frontier = list(roots)
        while frontier:
            fn = frontier.pop()
            if fn.qualname in seen:
                continue
            seen[fn.qualname] = fn
            if stop is not None and stop(fn):
                continue
            for callee, _ in fn.calls:
                frontier.extend(self.by_name.get(callee, ()))
        return sorted(seen.values(), key=lambda f: f.lineno)


def module_graph(sf: SourceFile) -> ModuleGraph:
    """The (cached) call graph of one source file."""
    cached = getattr(sf, "_module_graph", None)
    if cached is None:
        cached = sf._module_graph = ModuleGraph(sf)
    return cached


@dataclass(frozen=True)
class Rule:
    id: str
    name: str
    description: str
    check: Callable[[RepoView], Iterable[Finding]]


_RULES: dict[str, Rule] = {}


def rule(rule_id: str, name: str, description: str):
    """Register a check under a stable rule ID."""
    def register(fn: Callable[[RepoView], Iterable[Finding]]):
        if rule_id in _RULES:
            raise ValueError(f"duplicate rule id {rule_id}")
        _RULES[rule_id] = Rule(rule_id, name, description, fn)
        return fn
    return register


# Every rule family the analyzer ships.  A refactor that drops a rule
# module import would silently lose a whole family; the test gate and
# cmd/analyze.py both assert this registry is fully populated.
REQUIRED_RULE_FAMILIES = {
    "TPU0": "style (flake8 heritage)",
    "TPU1": "metrics discipline",
    "TPU2": "hygiene",
    "TPU3": "sole-writer",
    "TPU4": "lock discipline",
    "TPU5": "torch perf-correctness",
}


def all_rules() -> list[Rule]:
    """Every registered rule, importing the rule modules on first use."""
    # Importing the rule modules registers their rules.
    from . import lockcheck, rules, torchcheck  # noqa: F401
    return [_RULES[k] for k in sorted(_RULES)]


def missing_rule_families() -> list[str]:
    """Required family prefixes with no registered rule (should be
    empty; non-empty means a rule module stopped being imported)."""
    present = {r.id[:4] for r in all_rules()}
    return sorted(p for p in REQUIRED_RULE_FAMILIES if p not in present)


def run(repo: RepoView, select: Optional[Iterable[str]] = None) -> list[Finding]:
    """Run (selected) rules over the repo; noqa-filtered and sorted.

    ``select`` entries are rule-ID prefixes: ``TPU4`` runs the whole
    lock-discipline family, ``TPU101`` exactly one rule.  Syntax errors
    surface as TPU000 findings (and suppress the AST rules for that
    file rather than crashing them).
    """
    prefixes = tuple(select) if select else None
    findings: list[Finding] = []
    for sf in repo.files:
        if sf.tree is None and sf.syntax_error is not None:
            findings.append(Finding(
                sf.rel, sf.syntax_error.lineno or 1, SYNTAX_RULE_ID,
                f"syntax error: {sf.syntax_error.msg}",
            ))
    for r in all_rules():
        if prefixes and not r.id.startswith(prefixes):
            continue
        findings.extend(r.check(repo))
    kept = []
    for f in findings:
        sf = repo.file(f.file)
        if sf is not None and sf.noqa(f.line, f.rule_id):
            continue
        kept.append(f)
    return sorted(set(kept))


# ----------------------------------------------------------------------
# Baseline workflow
# ----------------------------------------------------------------------

BASELINE_VERSION = 1


def load_baseline(path: Path) -> dict[str, int]:
    if not Path(path).exists():
        return {}
    data = json.loads(Path(path).read_text())
    return {str(k): int(v) for k, v in data.get("findings", {}).items()}


def baseline_payload(findings: Iterable[Finding]) -> dict:
    counts: dict[str, int] = {}
    for f in findings:
        counts[f.baseline_key] = counts.get(f.baseline_key, 0) + 1
    return {
        "version": BASELINE_VERSION,
        "findings": {k: counts[k] for k in sorted(counts)},
    }


def write_baseline(path: Path, findings: Iterable[Finding]) -> None:
    Path(path).write_text(
        json.dumps(baseline_payload(findings), indent=2) + "\n"
    )


def new_findings(
    findings: Iterable[Finding], baseline: dict[str, int]
) -> list[Finding]:
    """Occurrences in excess of the baselined count per key."""
    seen: dict[str, int] = {}
    fresh = []
    for f in sorted(findings):
        seen[f.baseline_key] = seen.get(f.baseline_key, 0) + 1
        if seen[f.baseline_key] > baseline.get(f.baseline_key, 0):
            fresh.append(f)
    return fresh
