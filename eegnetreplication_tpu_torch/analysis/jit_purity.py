"""Pass 5 — jit purity: no host side effects in code a CUDA graph captures.

The port's counterpart of ``eegnetreplication_tpu/analysis/jit_purity.py``.
What the port replays as a recorded program is a **CUDA graph**: a capture
records the kernels the captured Python launches, and every replay runs
those kernels again without running the Python.  A ``time.time()``,
``logger`` / ``logging`` call, journal event, metrics-registry update,
Python-level RNG draw or ``print`` inside captured code fires once at
capture and never at replay — the same observability lie as a side effect
inside ``jax.jit`` in the JAX package.  The telemetry convention is the
JAX package's: side effects live around the capture (the engine's warmup,
the replay wrapper), never inside it.  The pass keeps the JAX name
(``jit-purity``) and rule (``jit-impure``), so ``--passes``, baseline keys
and the ``--json`` record read as they do there.

Roots are collected from:

- the calls lexically between ``<graph>.capture_begin(...)`` and the next
  ``<graph>.capture_end()`` of one function (the engine's ``_capture``);
- the body of ``with torch.cuda.graph(...)``;
- the first argument of ``torch.cuda.make_graphed_callables`` (a function,
  a lambda, ``self.<name>``, or a tuple or list of them).

Each root's calls are checked, plus a one-level static call graph, as in
the JAX pass: same-file functions a root calls by name, and for
``self.<name>(...)`` the method ``<name>`` of the enclosing class (or of a
same-file base), a same-file function assigned to ``self.<name>`` in that
class, and the overrides of ``<name>`` in its subclasses anywhere in the
scanned tree (a call through ``self`` dispatches to them; the zoo's
``StackedEngine`` overrides the graphed forward of ``InferenceEngine``).
Other cross-module calls are not followed.

The forbidden calls are the JAX pass's: journal ``.event(...)``, wall
clocks (``time.time``, ``perf_counter``, ``monotonic``...), ``logging`` /
``logger`` calls, calls through a ``.metrics`` attribute chain, stdlib
``random`` and ``numpy.random``, and ``print``; ``import time as t`` and
``from time import perf_counter`` resolve to their true names.  Device
RNG (``torch.rand``, ``torch.randn``...) is pure here, as ``jax.random``
is there: it is recorded into the graph and draws anew at every replay.

Rule: ``jit-impure``.
"""

from __future__ import annotations

import ast

from eegnetreplication_tpu_torch.analysis.core import (
    Contracts,
    Finding,
    Project,
    SourceFile,
    dotted_name,
)

RULE = "jit-impure"

RULES = (RULE,)

_TIME_FNS = ("time", "perf_counter", "monotonic", "time_ns",
             "perf_counter_ns", "monotonic_ns", "process_time")

_FUNCS = (ast.FunctionDef, ast.AsyncFunctionDef)


def _import_map(sf: SourceFile) -> tuple[dict[str, str], dict[str, str]]:
    """(module alias -> real dotted module, bare name -> dotted origin)
    so ``import time as t; t.time()`` and ``from time import
    perf_counter; perf_counter()`` both resolve to their true names."""
    mod_aliases: dict[str, str] = {}
    func_aliases: dict[str, str] = {}
    for node in sf.nodes():
        if isinstance(node, ast.Import):
            for alias in node.names:
                mod_aliases[alias.asname or alias.name.split(".")[0]] = \
                    alias.name if alias.asname else alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module \
                and node.level == 0:
            for alias in node.names:
                func_aliases[alias.asname or alias.name] = \
                    f"{node.module}.{alias.name}"
    return mod_aliases, func_aliases


def _impure_dotted(cdn: str) -> str | None:
    """Why a canonical dotted call name is impure, or None."""
    base, _, tail = cdn.rpartition(".")
    if base in ("time", "_time") and tail in _TIME_FNS:
        return f"wall-clock read {cdn}()"
    # Segment match so the port's own `from utils.logging import logger`
    # (canonical eegnetreplication_tpu_torch.utils.logging.logger.info)
    # counts.
    if "logging" in cdn.split(".") or "logger" in cdn.split("."):
        return f"logging call {cdn}()"
    if base == "random" or cdn.startswith(("numpy.random.",
                                           "np.random.")):
        return f"Python-level RNG {cdn}()"
    return None


def _forbidden_call(node: ast.Call,
                    imports: tuple[dict[str, str], dict[str, str]],
                    ) -> str | None:
    """A human-readable description of why this call is impure, or None."""
    mod_aliases, func_aliases = imports
    func = node.func
    if isinstance(func, ast.Attribute):
        if func.attr == "event":
            return "journal .event(...) emission"
        dn = dotted_name(func)
        if dn is not None:
            segs = dn.split(".")
            # `from torch import rand` stays torch.rand (device RNG, pure);
            # `from numpy import random` becomes numpy.random (impure).
            if segs[0] in func_aliases:
                segs[0:1] = func_aliases[segs[0]].split(".")
            else:
                segs[0] = mod_aliases.get(segs[0], segs[0])
            why = _impure_dotted(".".join(segs))
            if why is not None:
                return why
        # jr.metrics.inc(...) / registry chains through a .metrics attr.
        chain = []
        cur: ast.AST = func
        while isinstance(cur, ast.Attribute):
            chain.append(cur.attr)
            cur = cur.value
        if isinstance(cur, ast.Name):
            chain.append(cur.id)
        if "metrics" in chain[1:]:
            return "metrics-registry update"
    elif isinstance(func, ast.Name):
        if func.id == "print":
            return "print(...) side effect"
        origin = func_aliases.get(func.id)
        if origin is not None:
            return _impure_dotted(origin)
    return None


def _scope_nodes(fn: ast.AST):
    """Every node of one function, not descending into nested functions."""
    stack = list(ast.iter_child_nodes(fn))
    while stack:
        node = stack.pop()
        yield node
        if not isinstance(node, (*_FUNCS, ast.ClassDef, ast.Lambda)):
            stack.extend(ast.iter_child_nodes(node))


def _is_call_to(node: ast.AST, attr: str) -> bool:
    return isinstance(node, ast.Call) \
        and isinstance(node.func, ast.Attribute) and node.func.attr == attr


def _capture_windows(fn: ast.AST) -> list[list[ast.Call]]:
    """The calls between each ``capture_begin(...)`` and the next
    ``capture_end()`` of ``fn``, in source position (the begin call's own
    arguments run before the capture and are left out)."""
    calls = [n for n in _scope_nodes(fn) if isinstance(n, ast.Call)]
    begins = sorted((n for n in calls if _is_call_to(n, "capture_begin")),
                    key=lambda n: (n.lineno, n.col_offset))
    ends = sorted((n for n in calls if _is_call_to(n, "capture_end")),
                  key=lambda n: (n.lineno, n.col_offset))
    windows = []
    for begin in begins:
        start = (begin.end_lineno, begin.end_col_offset)
        end = next((e for e in ends
                    if (e.lineno, e.col_offset) >= start), None)
        if end is None:
            continue
        stop = (end.lineno, end.col_offset)
        windows.append([n for n in calls
                        if (n.lineno, n.col_offset) >= start
                        and (n.end_lineno, n.end_col_offset) <= stop])
    return windows


def _cuda_name(node: ast.AST, func_aliases: dict[str, str]) -> str:
    """The dotted name of a call's function with a bare imported name
    resolved (``from torch.cuda import graph`` -> ``torch.cuda.graph``)."""
    dn = dotted_name(node) or ""
    head = dn.split(".")[0]
    if head in func_aliases:
        dn = func_aliases[head] + dn[len(head):]
    return dn


class _Index:
    """Functions by name per file, import maps per file, and the classes of
    the whole tree (for the subclasses that override a method called
    through ``self``); each built when first asked for."""

    def __init__(self, project: Project):
        self.project = project
        self._funcs: dict[str, dict[str, list[ast.AST]]] = {}
        self._imports: dict[str, tuple[dict[str, str], dict[str, str]]] = {}
        self._classes: list[tuple[SourceFile, ast.ClassDef]] | None = None

    def funcs(self, sf: SourceFile) -> dict[str, list[ast.AST]]:
        if sf.rel not in self._funcs:
            funcs: dict[str, list[ast.AST]] = {}
            for node in sf.nodes():
                if isinstance(node, _FUNCS):
                    funcs.setdefault(node.name, []).append(node)
            self._funcs[sf.rel] = funcs
        return self._funcs[sf.rel]

    def imports(self, sf: SourceFile) -> tuple[dict[str, str],
                                               dict[str, str]]:
        if sf.rel not in self._imports:
            self._imports[sf.rel] = _import_map(sf)
        return self._imports[sf.rel]

    def subclasses(self, name: str) -> list[tuple[SourceFile, ast.ClassDef]]:
        """Every scanned class deriving from a class called ``name``,
        transitively."""
        if self._classes is None:
            self._classes = [(sf, node) for sf in self.project.python_files()
                             for node in sf.nodes()
                             if isinstance(node, ast.ClassDef)]
        out, todo, seen = [], [name], {name}
        while todo:
            base = todo.pop()
            for sf, cls in self._classes:
                if cls.name in seen:
                    continue
                names = {(dotted_name(b) or "").rpartition(".")[2]
                         for b in cls.bases}
                if base in names:
                    seen.add(cls.name)
                    out.append((sf, cls))
                    todo.append(cls.name)
        return out

    def self_targets(self, sf: SourceFile, cls: ast.ClassDef | None,
                     name: str) -> list[tuple[SourceFile, ast.AST]]:
        """What ``self.<name>(...)`` inside ``cls`` may run."""
        if cls is None:
            return []
        out: list[tuple[SourceFile, ast.AST]] = []
        same_file = {c.name: c for c in sf.nodes()
                     if isinstance(c, ast.ClassDef)}
        lineage, todo = [], [cls]
        while todo:  # the class and its same-file bases
            cur = todo.pop()
            if cur in lineage:
                continue
            lineage.append(cur)
            todo.extend(same_file[b.id] for b in cur.bases
                        if isinstance(b, ast.Name) and b.id in same_file)
        for cur in lineage:
            for stmt in cur.body:
                if isinstance(stmt, _FUNCS) and stmt.name == name:
                    out.append((sf, stmt))
            # self.<name> = <same-file function>
            for node in ast.walk(cur):
                if isinstance(node, ast.Assign) \
                        and isinstance(node.value, ast.Name) \
                        and any(isinstance(t, ast.Attribute)
                                and t.attr == name
                                and isinstance(t.value, ast.Name)
                                and t.value.id == "self"
                                for t in node.targets):
                    out.extend((sf, fn) for fn in
                               self.funcs(sf).get(node.value.id, []))
        for sub_sf, sub in self.subclasses(cls.name):
            out.extend((sub_sf, stmt) for stmt in sub.body
                       if isinstance(stmt, _FUNCS) and stmt.name == name)
        return out

    def resolve(self, sf: SourceFile, cls: ast.ClassDef | None,
                expr: ast.AST) -> list[tuple[SourceFile, ast.AST]]:
        """The function bodies a called (or graphed) expression names."""
        if isinstance(expr, ast.Lambda):
            return [(sf, expr)]
        if isinstance(expr, ast.Name):
            return [(sf, fn) for fn in self.funcs(sf).get(expr.id, [])]
        if isinstance(expr, ast.Attribute) \
                and isinstance(expr.value, ast.Name) \
                and expr.value.id == "self":
            return self.self_targets(sf, cls, expr.attr)
        return []


def _enclosing(sf: SourceFile, node: ast.AST):
    """(nearest function around ``node``, nearest class around it or
    None): a closure's ``self`` is its method's."""
    fn = cls = None
    for anc in sf.ancestors(node):
        if fn is None and isinstance(anc, _FUNCS):
            fn = anc
        elif isinstance(anc, ast.ClassDef):
            cls = anc
            break
    return fn, cls


def _owner(sf: SourceFile, fn: ast.AST, default=None):
    """The class ``self`` names inside ``fn`` (a lambda keeps
    ``default``)."""
    if isinstance(fn, ast.Lambda):
        return default
    parent = sf.parents().get(fn)
    return parent if isinstance(parent, ast.ClassDef) \
        else _enclosing(sf, fn)[1]


def _collect_roots(sf: SourceFile, index: _Index):
    """(calls to check, label, enclosing class) for every captured-code
    root in the file."""
    if "capture_begin" not in sf.text and "graph" not in sf.text:
        return []  # names no capture API: no root, no walk
    _, func_aliases = index.imports(sf)
    roots = []
    for node in sf.nodes():
        if isinstance(node, _FUNCS):
            for window in _capture_windows(node):
                roots.append((window, node.name, _owner(sf, node)))
        elif isinstance(node, (ast.With, ast.AsyncWith)):
            if any(isinstance(item.context_expr, ast.Call)
                   and _cuda_name(item.context_expr.func, func_aliases)
                   .endswith("cuda.graph")
                   for item in node.items):
                fn, cls = _enclosing(sf, node)
                calls = [n for stmt in node.body for n in ast.walk(stmt)
                         if isinstance(n, ast.Call)]
                roots.append((calls, fn.name if fn else "<module>", cls))
        elif isinstance(node, ast.Call) and node.args \
                and _cuda_name(node.func, func_aliases).endswith(
                    "make_graphed_callables"):
            fn, cls = _enclosing(sf, node)
            first = node.args[0]
            items = first.elts if isinstance(first, (ast.Tuple, ast.List)) \
                else [first]
            for item in items:
                for target_sf, body in index.resolve(sf, cls, item):
                    label = getattr(body, "name", "<lambda>")
                    calls = [n for n in ast.walk(body)
                             if isinstance(n, ast.Call)]
                    roots.append((calls, label,
                                  _owner(target_sf, body, cls)))
    return roots


def check(project: Project, contracts: Contracts) -> list[Finding]:
    findings: list[Finding] = []
    index = _Index(project)
    for sf in project.python_files():
        for calls, label, cls in _collect_roots(sf, index):
            checked: set[int] = set()
            # The root's calls, then one level of callees.
            frontier = [(sf, calls, label, cls, True)]
            while frontier:
                where, nodes, name, owner, expand = frontier.pop()
                imports = index.imports(where)
                for sub in nodes:
                    why = _forbidden_call(sub, imports)
                    if why is not None:
                        findings.append(Finding(
                            rule=RULE, file=where.rel, line=sub.lineno,
                            symbol=f"{label}:{name}",
                            message=f"{why} inside CUDA-graph-captured "
                                    f"code (root {label!r}, via "
                                    f"{name!r}); a capture runs it once "
                                    f"and a replay never — side effects "
                                    f"belong outside the capture"))
                    elif expand:
                        for target_sf, fn in index.resolve(where, owner,
                                                           sub.func):
                            if id(fn) in checked:
                                continue
                            checked.add(id(fn))
                            frontier.append((
                                target_sf,
                                [n for n in ast.walk(fn)
                                 if isinstance(n, ast.Call)],
                                getattr(fn, "name", "<lambda>"),
                                _owner(target_sf, fn, owner), False))
    return list(dict.fromkeys(findings))
