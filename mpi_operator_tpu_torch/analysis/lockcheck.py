"""Static lock-discipline checker: inferred guards + lock-order graph.

The port's copy of the JAX package's checker, rule for rule.

What Go gets from ``go vet`` plus a slice of what ``-race`` and kernel
lockdep prove dynamically, recovered from the AST:

**TPU401 — guarded-attribute discipline.**  For every class that owns a
lock (``self._lock = threading.Lock()/RLock()/Condition()`` or the
``locktrace`` factories), infer which ``self._*`` attributes that lock
guards: an attribute is *guarded* when it is mutated inside a
``with self._lock:`` body (directly, or in a private method only ever
called while the lock is held — a fixpoint over the intra-class call
graph).  An attribute mutated BOTH under its inferred guard AND outside
any lock is a race: the unguarded site is the finding.  ``__init__``
is exempt (no concurrent access before construction completes).

**TPU402 — lock-order inversions.**  Build a graph whose nodes are lock
identities (``Class.attr``) and whose edges mean "acquired while
holding": syntactic ``with`` nesting, private-method fixpoint ("called
only under A, takes B"), and cross-class edges resolved through
``self.x = SomeClass(...)`` constructor assignments and annotated
``__init__`` parameters (``Optional[SomeClass]`` unwraps).  Any cycle —
A→B somewhere, B→A somewhere else — is the classic deadlock
precondition.  Self-edges are skipped: re-acquiring the same RLock is
reentrancy, not an ordering bug (the reentrant non-finding).

Both rules are heuristic by design — this is a vet, not a prover — so
false positives are first-class citizens of the baseline workflow
rather than reasons to silence the rule.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass, field
from typing import Iterable, Optional

from .framework import (
    Finding,
    RepoView,
    SourceFile,
    intersect_fixpoint,
    rule,
    union_fixpoint,
)

# Calls that create a lock object when assigned to a self attribute.
_LOCK_CTORS = {"Lock", "RLock", "Condition"}
_LOCKTRACE_CTORS = {"lock", "rlock", "condition"}

# Methods that mutate their receiver in place (dict/list/set/deque).
_MUTATOR_METHODS = {
    "append", "appendleft", "add", "insert", "extend", "update",
    "setdefault", "pop", "popitem", "popleft", "remove", "discard",
    "clear", "__setitem__", "__delitem__",
}


def _call_name(node: ast.Call) -> tuple[str, str]:
    """(root, attr) of the callee: ``threading.Lock`` -> ("threading",
    "Lock"); bare ``Lock()`` -> ("", "Lock")."""
    fn = node.func
    if isinstance(fn, ast.Attribute):
        root = fn.value
        return (root.id if isinstance(root, ast.Name) else "", fn.attr)
    if isinstance(fn, ast.Name):
        return ("", fn.id)
    return ("", "")


def _is_lock_ctor(node: ast.AST) -> bool:
    if not isinstance(node, ast.Call):
        return False
    root, attr = _call_name(node)
    if attr in _LOCK_CTORS and root in ("threading", ""):
        return True
    if attr in _LOCKTRACE_CTORS and root == "locktrace":
        return True
    return False


def _self_attr(node: ast.AST) -> Optional[str]:
    """'x' when node is ``self.x``, else None."""
    if (isinstance(node, ast.Attribute)
            and isinstance(node.value, ast.Name)
            and node.value.id == "self"):
        return node.attr
    return None


def _annotation_class(node: Optional[ast.AST]) -> Optional[str]:
    """Final class-name segment of a parameter annotation, unwrapping
    Optional[...] and string ("future") annotations."""
    if node is None:
        return None
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        try:
            node = ast.parse(node.value, mode="eval").body
        except SyntaxError:
            return None
    if isinstance(node, ast.Subscript):
        base = node.value
        base_name = (
            base.id if isinstance(base, ast.Name)
            else base.attr if isinstance(base, ast.Attribute) else ""
        )
        if base_name == "Optional":
            return _annotation_class(node.slice)
        return None
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        return node.attr
    return None


@dataclass
class MutationSite:
    attr: str
    line: int
    method: str
    held: frozenset  # syntactic held set at the site (lock ids)
    in_nested_def: bool = False


@dataclass
class AcquireSite:
    lock: str  # lock id "Class.attr"
    line: int
    held: frozenset  # what was already held syntactically


@dataclass
class CallSite:
    callee_class: str  # "" for intra-class self calls
    callee: str
    line: int
    held: frozenset


@dataclass
class MethodInfo:
    name: str
    lineno: int
    mutations: list = field(default_factory=list)
    acquires: list = field(default_factory=list)
    calls: list = field(default_factory=list)


@dataclass
class ClassInfo:
    name: str
    sf: SourceFile
    lineno: int
    lock_attrs: set = field(default_factory=set)
    methods: dict = field(default_factory=dict)  # name -> MethodInfo
    attr_types: dict = field(default_factory=dict)  # attr -> class name
    value_referenced: set = field(default_factory=set)  # method names

    def lock_ids(self) -> frozenset:
        return frozenset(f"{self.name}.{a}" for a in self.lock_attrs)


class _MethodWalker:
    """Walks one method body tracking the syntactic held-lock stack."""

    def __init__(self, cls: ClassInfo, method: MethodInfo, classes: dict):
        self.cls = cls
        self.method = method
        self.classes = classes

    def walk(self, body: list) -> None:
        self._visit_block(body, held=(), nested=False)

    # -- helpers --------------------------------------------------------

    def _lock_id_of(self, expr: ast.AST) -> Optional[str]:
        attr = _self_attr(expr)
        if attr is not None and attr in self.cls.lock_attrs:
            return f"{self.cls.name}.{attr}"
        # ``with self.x.lock:`` / ``with self.x._lock:`` — a neighbour
        # object's lock taken directly; resolve through attr_types.
        if (isinstance(expr, ast.Attribute)
                and isinstance(expr.value, ast.Attribute)):
            owner = _self_attr(expr.value)
            if owner is not None:
                owner_cls = self.classes.get(self.cls.attr_types.get(owner))
                if owner_cls is not None and expr.attr in owner_cls.lock_attrs:
                    return f"{owner_cls.name}.{expr.attr}"
        return None

    def _record_mutation(self, attr: str, line: int, held: tuple,
                         nested: bool) -> None:
        if attr in self.cls.lock_attrs:
            return  # assigning the lock object itself is construction
        self.method.mutations.append(MutationSite(
            attr, line, self.method.name, frozenset(held), nested))

    def _mutation_targets(self, target: ast.AST) -> list[tuple[str, int]]:
        """(attr, line) pairs this assignment target mutates on self."""
        out = []
        attr = _self_attr(target)
        if attr is not None:
            out.append((attr, target.lineno))
            return out
        if isinstance(target, ast.Subscript):
            # self.a[...] = v mutates a; self.a.b[...] = v mutates the
            # nested object — attribute the write to 'a' (closest self
            # root) so the guard inference still sees it.
            inner = target.value
            while isinstance(inner, (ast.Subscript, ast.Attribute)):
                a = _self_attr(inner)
                if a is not None:
                    out.append((a, target.lineno))
                    return out
                inner = inner.value
            return out
        if isinstance(target, ast.Attribute):
            # self.a.b = v mutates the object held in a.
            a = _self_attr(target.value)
            if a is not None:
                out.append((a, target.lineno))
            return out
        if isinstance(target, (ast.Tuple, ast.List)):
            for e in target.elts:
                out.extend(self._mutation_targets(e))
        return out

    # -- traversal ------------------------------------------------------

    def _visit_block(self, body: list, held: tuple, nested: bool) -> None:
        for stmt in body:
            self._visit_stmt(stmt, held, nested)

    def _visit_stmt(self, stmt: ast.AST, held: tuple, nested: bool) -> None:
        if isinstance(stmt, (ast.With, ast.AsyncWith)):
            new_held = list(held)
            for item in stmt.items:
                lock_id = self._lock_id_of(item.context_expr)
                self._visit_expr(item.context_expr, tuple(new_held), nested)
                if lock_id is not None:
                    self.method.acquires.append(AcquireSite(
                        lock_id, item.context_expr.lineno,
                        frozenset(new_held)))
                    new_held.append(lock_id)
            self._visit_block(stmt.body, tuple(new_held), nested)
            return
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
            # A nested def's body runs at call time, possibly on another
            # thread with no lock held — analyse it with an empty held
            # set so deferred mutations never read as guarded.
            self._visit_block(stmt.body, (), True)
            return
        if isinstance(stmt, ast.Assign):
            for target in stmt.targets:
                if _is_lock_ctor(stmt.value):
                    continue  # lock construction handled in discovery
                for attr, line in self._mutation_targets(target):
                    self._record_mutation(attr, line, held, nested)
            self._visit_expr(stmt.value, held, nested)
            return
        if isinstance(stmt, (ast.AugAssign, ast.AnnAssign)):
            if getattr(stmt, "value", None) is not None:
                for attr, line in self._mutation_targets(stmt.target):
                    self._record_mutation(attr, line, held, nested)
                self._visit_expr(stmt.value, held, nested)
            return
        if isinstance(stmt, ast.Delete):
            for target in stmt.targets:
                for attr, line in self._mutation_targets(target):
                    self._record_mutation(attr, line, held, nested)
            return
        # Generic statement: visit expressions and nested blocks.
        for fname in ("test", "iter", "value", "exc"):
            sub = getattr(stmt, fname, None)
            if isinstance(sub, ast.expr):
                self._visit_expr(sub, held, nested)
        for bname in ("body", "orelse", "finalbody"):
            sub = getattr(stmt, bname, None)
            if isinstance(sub, list):
                self._visit_block(sub, held, nested)
        for hname in ("handlers",):
            for handler in getattr(stmt, hname, []) or []:
                self._visit_block(handler.body, held, nested)
        if isinstance(stmt, (ast.For, ast.AsyncFor)):
            for attr, line in self._mutation_targets(stmt.target):
                self._record_mutation(attr, line, held, nested)
        for cname in ("cases",):  # match statements
            for case in getattr(stmt, cname, []) or []:
                self._visit_block(case.body, held, nested)

    def _visit_expr(self, expr: ast.AST, held: tuple, nested: bool) -> None:
        call_func_ids = set()
        for node in ast.walk(expr):
            if isinstance(node, ast.Call):
                call_func_ids.add(id(node.func))
                self._visit_call(node, held, nested)
        for node in ast.walk(expr):
            # A bound-method reference that escapes as a value (thread
            # target, callback) — NOT the func position of a call.
            if (isinstance(node, ast.Attribute)
                    and isinstance(node.ctx, ast.Load)
                    and id(node) not in call_func_ids):
                attr = _self_attr(node)
                if attr is not None and attr in self.cls.methods:
                    self.cls.value_referenced.add(attr)

    def _visit_call(self, node: ast.Call, held: tuple, nested: bool) -> None:
        fn = node.func
        if isinstance(fn, ast.Attribute):
            # self._m(...) — intra-class call
            owner = _self_attr(fn.value)
            if isinstance(fn.value, ast.Name) and fn.value.id == "self":
                self.method.calls.append(CallSite(
                    "", fn.attr, node.lineno, frozenset(held)))
                return
            if owner is not None:
                # self.x.m(...) — mutator methods mutate the attribute;
                # known neighbour classes contribute cross-class edges.
                if fn.attr in _MUTATOR_METHODS:
                    self._record_mutation(owner, node.lineno, held, nested)
                target_cls = self.cls.attr_types.get(owner)
                if target_cls:
                    self.method.calls.append(CallSite(
                        target_cls, fn.attr, node.lineno, frozenset(held)))


def _discover_class(sf: SourceFile, node: ast.ClassDef,
                    class_names: set) -> ClassInfo:
    cls = ClassInfo(node.name, sf, node.lineno)
    # Pass A: lock attrs + attr types (constructor assignments and
    # annotated __init__ params), scanning every method.
    for stmt in node.body:
        if not isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        param_types = {}
        if stmt.name == "__init__":
            args = stmt.args
            for a in list(args.posonlyargs) + list(args.args) + list(
                    args.kwonlyargs):
                ann_cls = _annotation_class(a.annotation)
                if ann_cls and ann_cls in class_names:
                    param_types[a.arg] = ann_cls
        for sub in ast.walk(stmt):
            if not isinstance(sub, ast.Assign):
                continue
            for target in sub.targets:
                attr = _self_attr(target)
                if attr is None:
                    continue
                if _is_lock_ctor(sub.value):
                    cls.lock_attrs.add(attr)
                elif isinstance(sub.value, ast.Call):
                    _, ctor = _call_name(sub.value)
                    if ctor in class_names:
                        cls.attr_types.setdefault(attr, ctor)
                elif (isinstance(sub.value, ast.Name)
                      and sub.value.id in param_types):
                    cls.attr_types.setdefault(
                        attr, param_types[sub.value.id])
    for stmt in node.body:
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
            cls.methods[stmt.name] = MethodInfo(stmt.name, stmt.lineno)
    return cls


def build_model(repo: RepoView) -> dict[str, ClassInfo]:
    """Index every class in the package and walk its methods (cached on
    the RepoView so TPU401 and TPU402 share one walk)."""
    cached = getattr(repo, "_lockcheck_model", None)
    if cached is not None:
        return cached
    classes: dict[str, ClassInfo] = {}
    class_nodes: list[tuple[SourceFile, ast.ClassDef]] = []
    for sf in repo.package_files():
        if sf.tree is None:
            continue
        for node in ast.walk(sf.tree):
            if isinstance(node, ast.ClassDef):
                class_nodes.append((sf, node))
    class_names = {node.name for _, node in class_nodes}
    for sf, node in class_nodes:
        info = _discover_class(sf, node, class_names)
        # First definition wins on name collisions (rare; resolution is
        # by simple name across the package).
        classes.setdefault(node.name, info)
    for sf, node in class_nodes:
        cls = classes[node.name]
        if cls.sf is not sf or cls.lineno != node.lineno:
            continue
        for stmt in node.body:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                walker = _MethodWalker(cls, cls.methods[stmt.name], classes)
                walker.walk(stmt.body)
    repo._lockcheck_model = classes
    return classes


# ----------------------------------------------------------------------
# Fixpoint: assumed-held on method entry (intra-class)
# ----------------------------------------------------------------------


def entry_held_sets(cls: ClassInfo) -> dict[str, frozenset]:
    """For each method, the locks provably held on EVERY entry.

    Public methods, dunders, and methods whose bound reference escapes
    as a value (thread targets, callbacks) can be entered with nothing
    held.  A private method only ever called while a lock is held
    inherits that guard: start every candidate at the full lock set and
    intersect over call sites until the fixpoint (the shared
    :func:`framework.intersect_fixpoint`).
    """
    locks = cls.lock_ids()
    entry: dict[str, frozenset] = {}
    # Methods called from inside this class.
    called_from: dict[str, list] = {m: [] for m in cls.methods}
    for m in cls.methods.values():
        for call in m.calls:
            if call.callee_class == "" and call.callee in cls.methods:
                called_from[call.callee].append((m.name, call.held))
    for name in cls.methods:
        externally_enterable = (
            not name.startswith("_")
            or name.startswith("__")
            or name in cls.value_referenced
            or not called_from[name]
        )
        entry[name] = frozenset() if externally_enterable else locks
    return intersect_fixpoint(entry, called_from)


# ----------------------------------------------------------------------
# TPU401: guarded vs unguarded mutations
# ----------------------------------------------------------------------


def guard_findings(classes: dict[str, ClassInfo]) -> list[Finding]:
    findings = []
    for cls in classes.values():
        if not cls.lock_attrs:
            continue
        entry = entry_held_sets(cls)
        # attr -> [(site, effective_held)]
        by_attr: dict[str, list] = {}
        for m in cls.methods.values():
            if m.name == "__init__":
                continue  # no concurrent access during construction
            for site in m.mutations:
                effective = site.held | (
                    frozenset() if site.in_nested_def else entry[m.name])
                by_attr.setdefault(site.attr, []).append((site, effective))
        for attr, sites in sorted(by_attr.items()):
            guards = frozenset().union(
                *(held for _, held in sites)) if sites else frozenset()
            guards = guards & cls.lock_ids()
            if not guards:
                continue  # never guarded: plain unshared state
            unguarded = [
                (site, held) for site, held in sites if not (held & guards)
            ]
            if not unguarded:
                continue
            guard_names = ", ".join(sorted(guards))
            for site, _ in sorted(unguarded, key=lambda p: p[0].line):
                findings.append(Finding(
                    cls.sf.rel, site.line, "TPU401",
                    f"attribute '{attr}' of {cls.name} mutated in "
                    f"{site.method}() without holding its inferred guard "
                    f"({guard_names}); other sites mutate it under the "
                    "lock",
                ))
    return findings


# ----------------------------------------------------------------------
# TPU402: lock-order graph + inversions
# ----------------------------------------------------------------------


def _transitive_acquires(classes: dict[str, ClassInfo]) -> dict:
    """(class, method) -> frozenset of lock ids the call may acquire,
    including through intra- and cross-class calls (the shared
    :func:`framework.union_fixpoint`)."""
    seed: dict[tuple[str, str], frozenset] = {}
    edges: dict[tuple[str, str], list] = {}
    for cls in classes.values():
        for m in cls.methods.values():
            key = (cls.name, m.name)
            seed[key] = frozenset(a.lock for a in m.acquires)
            edges[key] = [
                (call.callee_class or cls.name, call.callee)
                for call in m.calls
            ]
    return union_fixpoint(seed, edges)


def lock_order_edges(classes: dict[str, ClassInfo]) -> dict:
    """outer-lock -> {inner-lock -> (file, line) witness}."""
    acq = _transitive_acquires(classes)
    edges: dict[str, dict[str, tuple[str, int]]] = {}

    def add(outer: str, inner: str, sf: SourceFile, line: int) -> None:
        if outer == inner:
            return  # reentrancy, not ordering
        edges.setdefault(outer, {}).setdefault(inner, (sf.rel, line))

    for cls in classes.values():
        entry = entry_held_sets(cls)
        for m in cls.methods.values():
            base = entry.get(m.name, frozenset())
            for site in m.acquires:
                for outer in base | site.held:
                    add(outer, site.lock, cls.sf, site.line)
            for call in m.calls:
                held = base | call.held
                if not held:
                    continue
                target = (call.callee_class or cls.name, call.callee)
                for inner in acq.get(target, frozenset()):
                    for outer in held:
                        add(outer, inner, cls.sf, call.line)
    return edges


def find_inversions(edges: dict) -> list[dict]:
    """Unordered lock pairs acquired in both orders, with witnesses."""
    out = []
    seen = set()
    for a, inners in sorted(edges.items()):
        for b, fwd_witness in sorted(inners.items()):
            rev_witness = edges.get(b, {}).get(a)
            if rev_witness is None:
                continue
            pair = frozenset((a, b))
            if pair in seen:
                continue
            seen.add(pair)
            out.append({
                "locks": sorted(pair),
                "forward": f"{a} -> {b}",
                "forward_at": fwd_witness,
                "reverse": f"{b} -> {a}",
                "reverse_at": rev_witness,
            })
    return out


def inversion_findings(classes: dict[str, ClassInfo]) -> list[Finding]:
    edges = lock_order_edges(classes)
    findings = []
    for inv in find_inversions(edges):
        fwd_file, fwd_line = inv["forward_at"]
        rev_file, rev_line = inv["reverse_at"]
        findings.append(Finding(
            fwd_file, fwd_line, "TPU402",
            f"lock-order inversion: {inv['forward']} here but "
            f"{inv['reverse']} at {rev_file}:{rev_line} — deadlock "
            "precondition",
        ))
    return findings


@rule("TPU401", "unguarded-mutation",
      "A self attribute is mutated both under its inferred lock guard "
      "and outside any lock — the unguarded site races the guarded "
      "ones.")
def check_guarded_mutations(repo: RepoView) -> Iterable[Finding]:
    return guard_findings(build_model(repo))


@rule("TPU402", "lock-order-inversion",
      "Two locks are acquired in both orders on different paths (the "
      "deadlock precondition), across with-nesting and resolved cross-"
      "class calls.")
def check_lock_order(repo: RepoView) -> Iterable[Finding]:
    return inversion_findings(build_model(repo))
