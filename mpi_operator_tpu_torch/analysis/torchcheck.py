"""Torch perf-correctness rules (TPU5xx): the port's counterpart of the
JAX package's ``analysis/jaxcheck.py``.

The JAX family catches the two silent bug classes of a jitted training
stack: recompilation (a jit cache miss per step) and host<->device
synchronization (a transfer barrier inside the step loop). Neither
crashes; both flatten throughput. The port's steps run eager PyTorch, so
the second class bites harder here: every ``.item()`` on the step path
stalls the host until the device queue drains, and the next step's
kernels are not queued meanwhile. Its compiled and captured code
(``torch.compile``, CUDA graphs) has the first class and one more, the
static buffers a graph replays. Each JAX rule has a counterpart with its
id; the name is kept where the semantics carry over (TPU503, TPU506):

**TPU501 — compile-specialized-scalar** (JAX: jit-nonstatic-scalar). A
``torch.compile``-d def (decorator or call form) whose signature carries
a Python-scalar/shape/dict-shaped parameter (``int``/``bool``/``str``/
``tuple``/``dict`` annotation or literal default), compiled without
``dynamic=True``. Dynamo guards on a Python scalar's value and recompiles
for each new one, where JAX would retrace a value left out of
``static_argnums``.

**TPU502 — compile-in-loop** (JAX: jit-in-loop). ``torch.compile(...)``,
``torch.cuda.CUDAGraph()``, ``torch.cuda.graph(...)`` or
``torch.cuda.make_graphed_callables(...)`` evaluated inside a loop body
or a per-step closure (a ``*_step``/``step_fn`` def): each evaluation
compiles or captures afresh.

**TPU503 — host-transfer-in-step.** Within a step root (a
``train_step``/``eval_step``/``step``/``step_fn`` def: the inner
``train_step`` of ``parallel/accum.py:make_update_step``,
``models/generate.py``'s ``Decoder.step``) and every same-module helper
reachable from it (``framework.module_graph``; traversal stops at
compiled boundaries): ``.item()``/``.tolist()``/``.cpu()``/``.numpy()``,
``float()``/``int()``/``bool()`` of a non-constant, ``np.asarray()``,
``print()`` and ``torch.cuda.synchronize()``. Inside a compiled root the
check narrows to conversions applied directly to its parameters (a graph
break and a sync there). The sanctioned spelling is one named
step-boundary read, ``utils/torchtrace.py:host_read(...)`` (JAX's
``jax.device_get``), outside the step: it and the names bound from it
are exempt.

**TPU504 — graph-static-buffer-reuse** (JAX: donated-arg-reuse). A CUDA
graph replays the buffers it captured, as a donated JAX buffer dies with
its call. After ``with torch.cuda.graph(g):``, a static input the
capture read is rebound by assignment (instead of ``.copy_()`` into it)
while ``g.replay()`` follows, so the replay reads the captured buffer,
not the new value; or a static output is kept by reference (``a =
out``, ``outs.append(out)``) and read after a later ``g.replay()`` has
overwritten it, without a ``.clone()``.

**TPU505 — step-double-buffer** (JAX: step-without-donation). A train or
update step (``train_step``/``update_step`` and the helpers it reaches)
or a loop that drives a step carries a second params-sized buffer
through every step: ``zero_grad(set_to_none=False)`` (the gradients held
across the step instead of freed), a per-step ``copy.deepcopy(...)`` or a
cloned ``state_dict()`` — the 2x-memory step that a missing donation is
in JAX.

**TPU506 — hot-loop-host-sync.** A loop that drives a step callable (a
``step``/``step_fn``/``*_step`` call, a compiled binding, or a graph's
``replay()``) and converts device values with ``float()``/``int()``/
``.item()``/``.tolist()``/``.cpu()``/``np.asarray()`` in the same body:
one device round-trip per iteration. Accumulate on the device, or read
through ``host_read`` at the boundary.

**TPU507 — kernel-tile-literal** (JAX: pallas-tile-literal). Kernel
wrappers under ``mpi_operator_tpu_torch/ops/`` take their ``block_*``/
``tile_*`` defaults and ``BLOCK_*``/``TILE_*`` constants from the shared
tile plumbing in ``ops/_common.py`` (``DEFAULT_BLOCK_Q``/``_K``), never
from private numeric literals: the kernels' ``static_assert``s and the
build's ``-D`` defines read that one place.

Unlike the JAX family, which reads the JAX package alone, these rules
read the whole view (the port and ``chip_smoke.py``, whose CUDA-graph
captures are the port's compiled steps); TPU507 reads ``ops/`` only.
Like lockcheck, every rule is a heuristic vet, not a prover; false
positives belong in ``# noqa: TPU5xx`` with the reason, or the baseline.
"""

from __future__ import annotations

import ast
import re
from dataclasses import dataclass, field
from typing import Iterable, Optional

from .framework import (
    Finding,
    RepoView,
    SourceFile,
    module_graph,
    rule,
)

# Step roots: the names the training stack gives its per-step callables
# (the update step's inner def, the decoder's step, timing closures).
STEP_NAME_RE = re.compile(r"^(train|eval|update|test)_step$|^step(_fn)?$")
# Train/update steps carry the optimizer state through every step.
TRAIN_STEP_RE = re.compile(r"^(train|update)_step$")

TILE_PARAM_RE = re.compile(r"^(block|tile)_[a-z0-9]+$")
TILE_CONST_RE = re.compile(r"^(DEFAULT_)?(BLOCK|TILE)_[A-Z0-9_]+$")
OPS_PREFIX = "mpi_operator_tpu_torch/ops/"

# The named step-boundary read (utils/torchtrace.py): the sanctioned
# device-to-host spelling, as jax.device_get is the JAX family's.
HOST_READ = "host_read"

_NP_ROOTS = {"np", "numpy", "onp"}
_STATIC_LOOKING_ANNOTATIONS = {
    "int", "bool", "str", "dict", "Dict", "tuple", "Tuple", "Sequence",
    "Shape",
}
_CONVERTERS = {"float", "int", "bool"}
_SYNC_METHODS = {"item", "tolist", "cpu", "numpy"}
# What creates or captures a CUDA graph, by the dotted name's tail.
_CAPTURE_TAILS = ("cuda.CUDAGraph", "cuda.graph",
                  "cuda.make_graphed_callables")
_CAPTURE_NAMES = {"CUDAGraph", "make_graphed_callables"}
_LOOPS = (ast.For, ast.AsyncFor, ast.While)
_DEFS = (ast.FunctionDef, ast.AsyncFunctionDef)


def _callee(call: ast.Call) -> tuple[str, str]:
    """(root, name) of the callee: ``torch.compile`` -> ("torch",
    "compile"); bare ``host_read`` -> ("", "host_read")."""
    fn = call.func
    if isinstance(fn, ast.Attribute):
        root = fn.value
        return (root.id if isinstance(root, ast.Name) else "", fn.attr)
    if isinstance(fn, ast.Name):
        return ("", fn.id)
    return ("", "")


def _dotted(expr: ast.AST) -> str:
    """``torch.cuda.graph`` for that attribute chain; "" for anything
    that is not a chain of names."""
    parts = []
    while isinstance(expr, ast.Attribute):
        parts.append(expr.attr)
        expr = expr.value
    if not isinstance(expr, ast.Name):
        return ""
    parts.append(expr.id)
    return ".".join(reversed(parts))


def _is_compile_expr(expr: ast.AST) -> bool:
    """expr names ``torch.compile`` (a decorator, or a Call's .func)."""
    return _dotted(expr) == "torch.compile"


def _capture_name(call: ast.Call) -> Optional[str]:
    """The dotted name when ``call`` creates or captures a CUDA graph."""
    name = _dotted(call.func)
    if name.endswith(_CAPTURE_TAILS) or name in _CAPTURE_NAMES:
        return name
    return None


def _is_host_read(call: ast.Call) -> bool:
    return _callee(call)[1] == HOST_READ


def _dynamic(keywords: list) -> bool:
    """``dynamic=True``, or a ``dynamic=`` the AST cannot resolve (a
    variable): the rule must not assume it knows the guards."""
    return any(kw.arg == "dynamic" and not (
        isinstance(kw.value, ast.Constant) and kw.value.value in (False, None))
        for kw in keywords)


@dataclass
class CompileSite:
    """One ``torch.compile`` application (a call or a decorator) or one
    CUDA-graph creation/capture."""

    lineno: int
    what: str                           # how findings name the site
    capture: bool = False               # a CUDA graph, not torch.compile
    fn_name: Optional[str] = None       # compiled function's simple name
    dynamic: bool = False               # dynamic=True (or unresolved)
    in_loop: bool = False
    enclosing: tuple = ()               # enclosing def names, outer first


def _compile_decorator_site(dec: ast.AST, fn: ast.AST
                            ) -> Optional[CompileSite]:
    """A CompileSite when ``dec`` applies torch.compile to ``fn``: bare
    ``@torch.compile``, ``@torch.compile(...)`` or ``@partial(
    torch.compile, ...)``."""
    name = fn.name
    what = f"@torch.compile decoration of {name}()"
    if _is_compile_expr(dec):
        return CompileSite(dec.lineno, what, fn_name=name)
    if isinstance(dec, ast.Call):
        if _is_compile_expr(dec.func) or (
                _callee(dec)[1] == "partial" and dec.args
                and _is_compile_expr(dec.args[0])):
            return CompileSite(dec.lineno, what, fn_name=name,
                               dynamic=_dynamic(dec.keywords))
    return None


@dataclass
class ModuleModel:
    """Everything the TPU5xx rules need to know about one module's
    compiled and captured code, collected in a single annotated walk."""

    sf: SourceFile
    sites: list = field(default_factory=list)
    compiled_defs: dict = field(default_factory=dict)  # def -> CompileSite
    bindings: dict = field(default_factory=dict)       # name -> CompileSite


def _build_model(sf: SourceFile) -> ModuleModel:
    model = ModuleModel(sf)
    if sf.tree is None:
        return model
    parents: dict[int, ast.AST] = {}
    context: dict[int, tuple[bool, tuple]] = {}  # id -> (in_loop, defs)

    def annotate(node: ast.AST, in_loop: bool, stack: tuple) -> None:
        context[id(node)] = (in_loop, stack)
        child_loop = in_loop or isinstance(node, _LOOPS)
        child_stack = stack
        if isinstance(node, _DEFS):
            child_stack = stack + (node.name,)
            # A def's body runs when it is called, not where it is defined.
            child_loop = False
        for child in ast.iter_child_nodes(node):
            parents[id(child)] = node
            annotate(child, child_loop, child_stack)

    annotate(sf.tree, False, ())
    # A decorator's own call is its def's site, not a call site.
    decorators = {id(n) for d in ast.walk(sf.tree) if isinstance(d, _DEFS)
                  for dec in d.decorator_list for n in ast.walk(dec)}

    for node in ast.walk(sf.tree):
        if isinstance(node, _DEFS):
            in_loop, stack = context[id(node)]
            for dec in node.decorator_list:
                site = _compile_decorator_site(dec, node)
                if site is not None:
                    site.in_loop, site.enclosing = in_loop, stack
                    model.sites.append(site)
                    model.compiled_defs.setdefault(node.name, site)
                    model.bindings.setdefault(node.name, site)
        elif isinstance(node, ast.Call) and id(node) not in decorators:
            capture = _capture_name(node)
            if not capture and not _is_compile_expr(node.func):
                continue
            in_loop, stack = context[id(node)]
            site = CompileSite(
                node.lineno, f"{capture}(...)" if capture
                else "torch.compile(...) call", capture=bool(capture),
                dynamic=_dynamic(node.keywords), in_loop=in_loop,
                enclosing=stack)
            if not capture and node.args:
                wrapped = node.args[0]
                if isinstance(wrapped, ast.Name):
                    site.fn_name = wrapped.id
                elif isinstance(wrapped, ast.Attribute):
                    site.fn_name = wrapped.attr
            parent = parents.get(id(node))
            if isinstance(parent, ast.Assign) and parent.value is node:
                for target in parent.targets:
                    if isinstance(target, ast.Name) and not capture:
                        model.bindings[target.id] = site
            model.sites.append(site)
            if site.fn_name:
                model.compiled_defs.setdefault(site.fn_name, site)
    return model


def _model(sf: SourceFile) -> ModuleModel:
    cached = getattr(sf, "_torchcheck_model", None)
    if cached is None:
        cached = sf._torchcheck_model = _build_model(sf)
    return cached


# ----------------------------------------------------------------------
# Body-walk helpers shared by TPU503-506
# ----------------------------------------------------------------------


def _own_body_nodes(fn_node: ast.AST) -> Iterable[ast.AST]:
    """Every node in a def's own body, not descending into nested defs
    (those are separate call-graph nodes)."""
    stack = list(ast.iter_child_nodes(fn_node))
    while stack:
        node = stack.pop()
        if isinstance(node, _DEFS):
            continue
        yield node
        stack.extend(ast.iter_child_nodes(node))


def _host_read_names(fn_node: ast.AST) -> set:
    """Local names bound from ``host_read(...)``: the sanctioned
    step-boundary read; conversions of these are explicit."""
    names = set()
    for node in _own_body_nodes(fn_node):
        if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Call)
                and _is_host_read(node.value)):
            for t in node.targets:
                if isinstance(t, ast.Name):
                    names.add(t.id)
                elif isinstance(t, (ast.Tuple, ast.List)):
                    names.update(
                        e.id for e in t.elts if isinstance(e, ast.Name))
    return names


def _sanctioned(value: ast.AST, read_names: set) -> bool:
    """value is already an explicit host copy (a host_read call or a
    name bound from one) or a compile-time constant."""
    if isinstance(value, ast.Constant):
        return True
    if isinstance(value, ast.Call) and _is_host_read(value):
        return True
    return isinstance(value, ast.Name) and value.id in read_names


def _conversion_calls(fn_node: ast.AST, read_names: set,
                      param_names: Optional[set] = None):
    """(call, kind) pairs for implicit host conversions in a def's (or a
    loop's) own body. With ``param_names`` (a compiled root) only
    conversions applied directly to a parameter count."""

    def traced(value: ast.AST) -> bool:
        if param_names is None:
            return True
        return isinstance(value, ast.Name) and value.id in param_names

    for node in _own_body_nodes(fn_node):
        if not isinstance(node, ast.Call):
            continue
        root, name = _callee(node)
        if isinstance(node.func, ast.Name) and name in _CONVERTERS:
            if node.args and not _sanctioned(node.args[0], read_names) \
                    and traced(node.args[0]):
                yield node, f"{name}()"
        elif isinstance(node.func, ast.Attribute) and name in _SYNC_METHODS:
            recv = node.func.value
            if root not in _NP_ROOTS and not _sanctioned(recv, read_names) \
                    and traced(recv):
                yield node, f".{name}()"
        elif root in _NP_ROOTS and name in ("asarray", "array"):
            if node.args and not _sanctioned(node.args[0], read_names) \
                    and traced(node.args[0]):
                yield node, f"{root}.{name}()"


def _params(fn_node: ast.AST) -> set:
    args = fn_node.args
    return {a.arg for a in (list(args.posonlyargs) + list(args.args)
                            + list(args.kwonlyargs))}


def _step_scope(sf: SourceFile, pattern: re.Pattern) -> list:
    """The step roots of ``sf`` whose names match ``pattern`` and every
    def reachable from them, traversal stopping at compiled defs."""
    graph = module_graph(sf)
    compiled = set(_model(sf).compiled_defs)
    roots = [fn for fn in graph.functions if pattern.fullmatch(fn.name)]
    if not roots:
        return []
    return graph.reachable(roots, stop=lambda fn: fn.name in compiled)


def _hot_loops(sf: SourceFile):
    """(def, loop) for each loop that drives a step: it calls a
    step-named callable, a compiled binding, or a graph's ``replay()``."""
    model = _model(sf)
    hot_names = set(model.bindings) | set(model.compiled_defs)
    for fn in module_graph(sf).functions:
        for node in _own_body_nodes(fn.node):
            if isinstance(node, _LOOPS) and any(
                    isinstance(c, ast.Call) and (
                        _callee(c)[1] in hot_names
                        or STEP_NAME_RE.fullmatch(_callee(c)[1] or "")
                        or _callee(c)[1] == "replay")
                    for c in ast.walk(node)):
                yield fn, node


# ----------------------------------------------------------------------
# TPU501: scalar parameters of compiled functions
# ----------------------------------------------------------------------


def _annotation_name(node: Optional[ast.AST]) -> Optional[str]:
    if node is None:
        return None
    if isinstance(node, ast.Subscript):  # tuple[int, ...], Dict[str, int]
        return _annotation_name(node.value)
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        try:
            return _annotation_name(ast.parse(node.value, mode="eval").body)
        except SyntaxError:
            return None
    return None


def _static_looking(arg: ast.arg, default: Optional[ast.AST]) -> Optional[str]:
    ann = _annotation_name(arg.annotation)
    if ann in _STATIC_LOOKING_ANNOTATIONS:
        return f"annotation '{ann}'"
    if isinstance(default, ast.Constant) and isinstance(
            default.value, (bool, int, str)) and default.value is not None:
        return f"default {default.value!r}"
    if isinstance(default, (ast.Tuple, ast.Dict)):
        return "tuple/dict literal default"
    return None


@rule("TPU501", "compile-specialized-scalar",
      "A torch.compile-d function signature carries a Python scalar/"
      "shape/dict-shaped parameter (int/bool/str/tuple/dict annotation or "
      "literal default) and is compiled without dynamic=True — dynamo "
      "guards on each value and recompiles for every new one.")
def check_compile_scalars(repo: RepoView) -> Iterable[Finding]:
    findings = []
    for sf in repo.files:
        if sf.tree is None:
            continue
        graph = module_graph(sf)
        for name, site in sorted(_model(sf).compiled_defs.items()):
            if site.dynamic:
                continue
            candidates = graph.by_name.get(name, [])
            if not candidates:
                continue
            fn = candidates[0].node
            args = fn.args
            positional = list(args.posonlyargs) + list(args.args)
            # defaults align with the TAIL of the positional list.
            pad = [None] * (len(positional) - len(args.defaults))
            pairs = list(zip(positional, pad + list(args.defaults)))
            if pairs and pairs[0][0].arg in ("self", "cls"):
                pairs = pairs[1:]
            pairs += list(zip(args.kwonlyargs, args.kw_defaults))
            for arg, default in pairs:
                reason = _static_looking(arg, default)
                if reason:
                    findings.append(Finding(
                        sf.rel, fn.lineno, "TPU501",
                        f"compiled {name}() parameter '{arg.arg}' looks "
                        f"static ({reason}) and the compile has no "
                        "dynamic=True — dynamo specializes on it and "
                        "recompiles for every distinct value",
                    ))
    return findings


# ----------------------------------------------------------------------
# TPU502: compiled or captured afresh per iteration / per step
# ----------------------------------------------------------------------


@rule("TPU502", "compile-in-loop",
      "torch.compile or a CUDA-graph capture (CUDAGraph(), "
      "torch.cuda.graph, make_graphed_callables) evaluated inside a loop "
      "body or per-step closure: each evaluation compiles or captures "
      "again, every iteration.")
def check_compile_in_loop(repo: RepoView) -> Iterable[Finding]:
    findings = []
    for sf in repo.files:
        if sf.tree is None:
            continue
        for site in _model(sf).sites:
            again = "captures again" if site.capture else "recompiles"
            if site.in_loop:
                findings.append(Finding(
                    sf.rel, site.lineno, "TPU502",
                    f"{site.what} inside a loop body — {again} every "
                    "iteration; hoist it out of the loop",
                ))
            elif any(STEP_NAME_RE.fullmatch(n) for n in site.enclosing):
                outer = next(n for n in site.enclosing
                             if STEP_NAME_RE.fullmatch(n))
                findings.append(Finding(
                    sf.rel, site.lineno, "TPU502",
                    f"{site.what} inside per-step function {outer}() — "
                    f"{again} on every step; build it once outside the "
                    "step",
                ))
    return findings


# ----------------------------------------------------------------------
# TPU503: implicit host transfers on the step path
# ----------------------------------------------------------------------


@rule("TPU503", "host-transfer-in-step",
      ".item()/.tolist()/.cpu()/.numpy(), float()/int()/bool(), "
      "np.asarray(), print() or torch.cuda.synchronize() inside a step "
      "function or a helper reachable from one — an implicit "
      "device-to-host sync on the hot path.  One named step-boundary "
      "read, host_read(...), outside the step is exempt.")
def check_step_host_transfers(repo: RepoView) -> Iterable[Finding]:
    findings = []
    for sf in repo.files:
        if sf.tree is None:
            continue
        compiled = _model(sf).compiled_defs
        for fn in _step_scope(sf, STEP_NAME_RE):
            reads = _host_read_names(fn.node)
            params = _params(fn.node) if fn.name in compiled else None
            for call, kind in _conversion_calls(fn.node, reads, params):
                findings.append(Finding(
                    sf.rel, call.lineno, "TPU503",
                    f"implicit host transfer on the step path: {kind} "
                    f"on a device value in {fn.name}() — read it through "
                    "host_read at a step boundary or move it off the "
                    "hot path",
                ))
            for node in _own_body_nodes(fn.node):
                if not isinstance(node, ast.Call):
                    continue
                if isinstance(node.func, ast.Name) and node.func.id == "print":
                    if params is not None and not any(
                            isinstance(a, ast.Name) and a.id in params
                            for a in node.args):
                        continue
                    findings.append(Finding(
                        sf.rel, node.lineno, "TPU503",
                        f"print() in step-path function {fn.name}() "
                        "synchronizes the device per call — log outside "
                        "the step",
                    ))
                elif (params is None
                      and _dotted(node.func).endswith("cuda.synchronize")):
                    findings.append(Finding(
                        sf.rel, node.lineno, "TPU503",
                        f"torch.cuda.synchronize() in step-path function "
                        f"{fn.name}() drains the device queue every step "
                        "— synchronize at a step boundary",
                    ))
    return findings


# ----------------------------------------------------------------------
# TPU504: a CUDA graph's static buffers rebound or read stale
# ----------------------------------------------------------------------


def _capture_blocks(fn_node: ast.AST):
    """(graph name, with statement) for each ``with torch.cuda.graph(g)``
    in a def's own body."""
    for node in _own_body_nodes(fn_node):
        if not isinstance(node, ast.With):
            continue
        for item in node.items:
            call = item.context_expr
            if (isinstance(call, ast.Call)
                    and _dotted(call.func).endswith("cuda.graph")
                    and call.args and isinstance(call.args[0], ast.Name)):
                yield call.args[0].id, node


def _stored(stmt: ast.AST) -> set:
    names = set()
    for node in ast.walk(stmt):
        if isinstance(node, ast.Name) and isinstance(node.ctx, ast.Store):
            names.add(node.id)
    return names


def _loop_of(fn_node: ast.AST, target: ast.AST) -> Optional[ast.AST]:
    """The innermost loop of fn's own body that holds ``target``."""
    found = None
    for node in _own_body_nodes(fn_node):
        if isinstance(node, _LOOPS) and any(
                n is target for n in ast.walk(node)):
            if found is None or node.lineno > found.lineno:
                found = node
    return found


@rule("TPU504", "graph-static-buffer-reuse",
      "A CUDA graph replays the buffers it captured: a static input "
      "rebound by assignment (not .copy_() into it) before replay(), or "
      "a static output kept by reference and read after a later "
      "replay() overwrote it (no .clone()).")
def check_graph_static_buffers(repo: RepoView) -> Iterable[Finding]:
    findings = []
    for sf in repo.files:
        if sf.tree is None:
            continue
        for fn in module_graph(sf).functions:
            body = list(_own_body_nodes(fn.node))
            for graph, block in _capture_blocks(fn.node):
                end = block.end_lineno
                inside = [n for s in block.body for n in ast.walk(s)]
                outputs = set().union(*(_stored(s) for s in block.body))
                inputs = {n.id for n in inside
                          if isinstance(n, ast.Name)
                          and isinstance(n.ctx, ast.Load)} - outputs
                replays = [n for n in body if isinstance(n, ast.Call)
                           and isinstance(n.func, ast.Attribute)
                           and n.func.attr == "replay"
                           and _dotted(n.func.value) == graph]
                if not replays:
                    continue

                def replayed_after(node: ast.AST) -> Optional[int]:
                    """Line of a replay that runs after ``node``: later
                    in the body, or anywhere in the same loop."""
                    later = [r.lineno for r in replays
                             if r.lineno > node.lineno]
                    loop = _loop_of(fn.node, node)
                    if loop is not None:
                        later += [r.lineno for r in replays
                                  if any(n is r for n in ast.walk(loop))]
                    return min(later) if later else None

                for stmt in body:
                    if not isinstance(stmt, (ast.Assign, ast.AugAssign,
                                             ast.AnnAssign)):
                        continue
                    if stmt.lineno <= end:
                        continue
                    for name in sorted(_stored(stmt) & inputs):
                        line = replayed_after(stmt)
                        if line is not None:
                            findings.append(Finding(
                                sf.rel, stmt.lineno, "TPU504",
                                f"'{name}' is a static input of graph "
                                f"{graph} and is rebound here before the "
                                f"replay at line {line} — the replay "
                                "reads the captured buffer; copy_() the "
                                "new value into it",
                            ))
                aliases = {}  # alias name -> (static output, line)
                for node in body:
                    if getattr(node, "lineno", 0) <= end:
                        continue
                    if (isinstance(node, ast.Assign)
                            and isinstance(node.value, ast.Name)
                            and node.value.id in outputs):
                        for t in node.targets:
                            if isinstance(t, ast.Name):
                                aliases[t.id] = (node.value.id, node)
                    elif (isinstance(node, ast.Call)
                          and isinstance(node.func, ast.Attribute)
                          and node.func.attr == "append" and node.args
                          and isinstance(node.args[0], ast.Name)
                          and node.args[0].id in outputs
                          and _loop_of(fn.node, node) is not None
                          and replayed_after(node) is not None):
                        findings.append(Finding(
                            sf.rel, node.lineno, "TPU504",
                            f"graph {graph}'s static output "
                            f"'{node.args[0].id}' is appended every "
                            "replay without a clone() — every entry is "
                            "the last replay's",
                        ))
                for alias, (out, bound) in sorted(aliases.items()):
                    line = replayed_after(bound)
                    if line is None:
                        continue
                    stale = [n for n in body if isinstance(n, ast.Name)
                             and isinstance(n.ctx, ast.Load)
                             and n.id == alias and n.lineno > line]
                    if stale:
                        use = min(stale, key=lambda n: n.lineno)
                        findings.append(Finding(
                            sf.rel, use.lineno, "TPU504",
                            f"'{alias}' holds graph {graph}'s static "
                            f"output '{out}' from before the replay at "
                            f"line {line}, which overwrote it — clone() "
                            "it before replaying",
                        ))
    return findings


# ----------------------------------------------------------------------
# TPU505: a second params-sized buffer carried through the step
# ----------------------------------------------------------------------


def _double_buffers(stmt_or_expr: ast.AST) -> Iterable[tuple]:
    """(node, kind) for each second-copy pattern under a node."""
    calls = [n for n in ast.walk(stmt_or_expr) if isinstance(n, ast.Call)]
    names = {_callee(c)[1] for c in calls}
    for call in calls:
        name = _callee(call)[1]
        if name == "zero_grad" and any(
                kw.arg == "set_to_none" and isinstance(kw.value, ast.Constant)
                and kw.value.value is False for kw in call.keywords):
            yield call, "zero_grad(set_to_none=False)"
        elif name == "deepcopy":
            yield call, "copy.deepcopy(...)"
        elif name == "state_dict" and "clone" in names:
            yield call, "a cloned state_dict()"


@rule("TPU505", "step-double-buffer",
      "A train/update step (or a loop driving one) carries a second "
      "params-sized buffer through every step: zero_grad(set_to_none="
      "False), a per-step copy.deepcopy(...) or a cloned state_dict() — "
      "twice the state in device memory.")
def check_step_double_buffer(repo: RepoView) -> Iterable[Finding]:
    findings = []
    for sf in repo.files:
        if sf.tree is None:
            continue
        places = [(fn.name, fn.node, list(ast.iter_child_nodes(fn.node)))
                  for fn in _step_scope(sf, TRAIN_STEP_RE)]
        places += [(fn.name, loop, [loop])
                   for fn, loop in _hot_loops(sf)]
        for where, owner, roots in places:
            seen = set()
            for root in roots:
                for stmt in (n for n in ast.walk(root)
                             if isinstance(n, ast.stmt)):
                    if isinstance(stmt, _DEFS) or id(stmt) in seen:
                        continue
                    seen.add(id(stmt))
                    for call, kind in _double_buffers(stmt):
                        place = ("a loop driving a step in "
                                 if isinstance(owner, _LOOPS) else "step ")
                        findings.append(Finding(
                            sf.rel, call.lineno, "TPU505",
                            f"{kind} in {place}{where}() keeps a second "
                            "params-sized buffer alive through every "
                            "step — free it (set_to_none=True) or copy "
                            "outside the step",
                        ))
    return findings


# ----------------------------------------------------------------------
# TPU506: host syncs inside hot loops
# ----------------------------------------------------------------------


@rule("TPU506", "hot-loop-host-sync",
      "A loop drives a step callable, a compiled binding or a graph "
      "replay() and converts device values (float()/int()/.item()/"
      ".tolist()/.cpu()/np.asarray()) in the same body — one device "
      "round-trip per iteration.  Accumulate on device, or host_read "
      "explicitly at the boundary.")
def check_hot_loop_sync(repo: RepoView) -> Iterable[Finding]:
    findings = []
    for sf in repo.files:
        if sf.tree is None:
            continue
        for fn, loop in _hot_loops(sf):
            for call, kind in _conversion_calls(loop,
                                                _host_read_names(fn.node)):
                findings.append(Finding(
                    sf.rel, call.lineno, "TPU506",
                    f"implicit host sync in a hot loop: {kind} while the "
                    "loop drives a step — one device round-trip per "
                    "iteration",
                ))
    return findings


# ----------------------------------------------------------------------
# TPU507: kernel tile hygiene
# ----------------------------------------------------------------------


@rule("TPU507", "kernel-tile-literal",
      "An ops/ kernel wrapper takes its block/tile size from a private "
      "numeric literal instead of the shared tile plumbing in "
      "ops/_common.py, which the kernels' static_asserts and the build's "
      "defines read.")
def check_tile_hygiene(repo: RepoView) -> Iterable[Finding]:
    findings = []
    for sf in repo.files:
        if sf.tree is None or not sf.rel.startswith(OPS_PREFIX):
            continue
        if sf.rel.endswith("_common.py"):
            continue
        for node in ast.walk(sf.tree):
            if isinstance(node, _DEFS):
                args = node.args
                positional = list(args.posonlyargs) + list(args.args)
                pad = [None] * (len(positional) - len(args.defaults))
                pairs = list(zip(positional, pad + list(args.defaults))) + \
                    list(zip(args.kwonlyargs, args.kw_defaults))
                for arg, default in pairs:
                    if not TILE_PARAM_RE.fullmatch(arg.arg):
                        continue
                    if isinstance(default, ast.Constant) and isinstance(
                            default.value, (int, float)):
                        findings.append(Finding(
                            sf.rel, node.lineno, "TPU507",
                            f"kernel {node.name}() defaults tile "
                            f"parameter '{arg.arg}' to the literal "
                            f"{default.value} — take it from "
                            "ops/_common.py, where the build and the "
                            "kernels read their tiles",
                        ))
        for stmt in sf.tree.body:
            if not isinstance(stmt, ast.Assign):
                continue
            for target in stmt.targets:
                if (isinstance(target, ast.Name)
                        and TILE_CONST_RE.fullmatch(target.id)
                        and isinstance(stmt.value, ast.Constant)
                        and isinstance(stmt.value.value, (int, float))):
                    findings.append(Finding(
                        sf.rel, stmt.lineno, "TPU507",
                        f"module-level tile constant {target.id} "
                        "defined outside ops/_common.py — move it into "
                        "the shared tile plumbing",
                    ))
    return findings
