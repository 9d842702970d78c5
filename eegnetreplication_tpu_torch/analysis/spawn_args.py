"""Pass 3 — spawn args: literal child ``--flags`` vs the target's argparse.

The port's copy of ``eegnetreplication_tpu/analysis/spawn_args.py``.  The
bug class: a supervisor relaunch policy once appended ``--resume`` to a
fleet-shaped cell whose argparse didn't accept it — argparse exits 2, the
supervisor classifies exit 2 as fatal, and the cell is retired
permanently.  Nothing short of running the exact drill catches that at
runtime; statically it is trivial: every literal ``--flag`` placed on a
child command line must appear in the target entry point's
``add_argument`` literals.

Command lines are recognized in list literals (and simple per-function
dataflow over ``cmd += [...]`` / ``cmd.append(...)`` / ``cmd = base +
[...]``).  The *target* of a segment is set by:

- ``"-m", "<module>"``            — a package entry point (thin
  ``__main__.py`` wrappers are followed one import hop);
- an element whose subtree holds a string ending ``.py`` — a script
  (resolved by basename under ``scripts/`` or the repo root);
- an element referencing ``__file__`` — the current file itself;
- a literal ``"--"`` clears the target (supervisor-style separator);
  flags after it are checked against the next ``-m``/script target.

Special seams with known targets:

- ``spawn_replica_fleet(serve_args=..., per_replica_args=...)`` — flags
  target ``eegnetreplication_tpu_torch.serve``;
- ``spawn_cells(serve_args=...)`` — flags must be accepted by BOTH
  ``eegnetreplication_tpu_torch.serve`` and ``...serve.fleet`` (a cell is
  spawned in either shape depending on ``--replicasPerCell``);
- ``SupervisorPolicy(resume_arg="--X")`` — the relaunch flag is checked
  against every command target built in the same function (the exact
  shape of that fault).

Rule: ``spawn-arg-unknown``.
"""

from __future__ import annotations

import ast
import re
from dataclasses import dataclass, field

from eegnetreplication_tpu_torch.analysis.core import (
    PACKAGE,
    Contracts,
    Finding,
    Project,
    SourceFile,
    str_const,
)

RULE_UNKNOWN = "spawn-arg-unknown"

RULES = (RULE_UNKNOWN,)

_FLAG_RE = re.compile(r"^--[A-Za-z][A-Za-z0-9-]*$")
_MODULE_RE = re.compile(r"^[A-Za-z_][\w.]*$")

# Callables whose literal-flag kwargs target known entry points.
_SPECIAL_KWARGS = {
    "spawn_replica_fleet": {
        "serve_args": (f"module:{PACKAGE}.serve",),
        "per_replica_args": (f"module:{PACKAGE}.serve",),
    },
    "spawn_cells": {
        "serve_args": (f"module:{PACKAGE}.serve",
                       f"module:{PACKAGE}.serve.fleet"),
    },
}


@dataclass
class _CmdState:
    """Flags collected for one tracked command list."""

    # (target or None, flag, line); None target = orphan (resolved only
    # if the list later feeds a special kwarg seam).
    flags: list[tuple[str | None, str, int]] = field(default_factory=list)
    targets: set[str] = field(default_factory=set)
    current: str | None = None


class _AcceptSets:
    """Lazily resolved ``add_argument`` literal sets per target key."""

    def __init__(self, project: Project):
        self.project = project
        self._cache: dict[str, set[str] | None] = {}

    def get(self, target: str) -> set[str] | None:
        if target not in self._cache:
            self._cache[target] = self._resolve(target)
        return self._cache[target]

    def _resolve(self, target: str) -> set[str] | None:
        kind, _, name = target.partition(":")
        sf = None
        if kind == "module":
            for rel in (name.replace(".", "/") + ".py",
                        name.replace(".", "/") + "/__main__.py"):
                sf = self.project.by_rel.get(rel)
                if sf is not None:
                    break
        elif kind == "script":
            for rel in (f"scripts/{name}", name):
                sf = self.project.by_rel.get(rel)
                if sf is not None:
                    break
        elif kind == "self":
            sf = self.project.by_rel.get(name)
        if sf is None or sf.tree is None:
            return None  # unknown target: never guess, never flag
        accepted = _add_argument_literals(sf)
        if accepted:
            return accepted
        # Thin wrapper (serve/__main__.py, scripts/supervisor.py): follow
        # in-project ``from X import ...`` one hop and union their sets.
        for node in sf.nodes():
            if isinstance(node, ast.ImportFrom) and node.module \
                    and node.module.startswith(PACKAGE):
                dep = self.project.by_rel.get(
                    node.module.replace(".", "/") + ".py")
                if dep is not None and dep.tree is not None:
                    accepted |= _add_argument_literals(dep)
        return accepted or None


def _add_argument_literals(sf: SourceFile) -> set[str]:
    out: set[str] = set()
    for node in sf.nodes():
        if isinstance(node, ast.Call) \
                and isinstance(node.func, ast.Attribute) \
                and node.func.attr == "add_argument":
            for arg in node.args:
                s = str_const(arg)
                if s is not None and s.startswith("-"):
                    out.add(s)
    return out


def _element_target(el: ast.AST, sf: SourceFile) -> str | None:
    """Script/self target carried by one command-list element, if any."""
    for sub in ast.walk(el):
        if isinstance(sub, ast.Name) and sub.id == "__file__":
            return f"self:{sf.rel}"
        s = str_const(sub)
        if s is not None and s.endswith(".py") and "/" not in s \
                and "\\" not in s:
            return f"script:{s}"
        if s is not None and s.endswith(".py"):
            return f"script:{s.rsplit('/', 1)[-1]}"
    return None


def _scan_list(node: ast.List, sf: SourceFile,
               state: _CmdState | None = None) -> _CmdState:
    state = state or _CmdState()
    elts = node.elts
    i = 0
    prev_was_flag = False
    while i < len(elts):
        el = elts[i]
        s = str_const(el)
        was_flag = False
        if s == "--":
            state.current = None  # separator: next target owns the rest
        elif s == "-m" and i + 1 < len(elts):
            mod = str_const(elts[i + 1])
            if mod is not None and _MODULE_RE.match(mod):
                state.current = f"module:{mod}"
                state.targets.add(state.current)
                prev_was_flag = False
                i += 2
                continue
        elif s is not None and _FLAG_RE.match(s):
            state.flags.append((state.current, s, el.lineno))
            was_flag = True
        elif prev_was_flag:
            # A flag's value: ["--plan", str(root / "chaos.py")] must not
            # retarget the scan — only positional elements name scripts.
            pass
        elif s is not None and s.endswith(".py"):
            # Bare literal script path: ["python", "scripts/x.py", ...]
            # — the most common spelling; same resolution as the
            # str(REPO / "scripts" / "x.py") expression form.
            state.current = f"script:{s.rsplit('/', 1)[-1]}"
            state.targets.add(state.current)
        elif s is None:
            target = _element_target(el, sf)
            if target is not None:
                state.current = target
                state.targets.add(target)
        prev_was_flag = was_flag
        i += 1
    return state


def _literal_flags(node: ast.AST) -> list[tuple[str, int]]:
    """Every literal flag token anywhere under ``node``."""
    out = []
    for sub in ast.walk(node):
        s = str_const(sub)
        if s is not None and _FLAG_RE.match(s):
            out.append((s, sub.lineno))
    return out


def _function_scopes(sf: SourceFile):
    """Every function body plus the module itself, each as one scope."""
    return [sf.tree] + [n for n in sf.nodes()
                        if isinstance(n, (ast.FunctionDef,
                                          ast.AsyncFunctionDef))]


def _ordered_nodes(scope: ast.AST):
    """Source-ordered pre-order traversal of ONE scope: stops at nested
    function boundaries so each statement belongs to exactly one scope."""
    stack = list(reversed(list(ast.iter_child_nodes(scope))))
    while stack:
        node = stack.pop()
        yield node
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            stack.extend(reversed(list(ast.iter_child_nodes(node))))


def check(project: Project, contracts: Contracts) -> list[Finding]:
    findings: list[Finding] = []
    accepts = _AcceptSets(project)

    def check_flag(target: str | None, flag: str, sf: SourceFile,
                   line: int) -> None:
        if target is None:
            return
        accepted = accepts.get(target)
        if accepted is None:
            return
        if flag not in accepted:
            findings.append(Finding(
                rule=RULE_UNKNOWN, file=sf.rel, line=line, symbol=flag,
                message=f"flag {flag!r} is not accepted by {target} "
                        f"(argparse would exit 2 in the child; known "
                        f"flags: {', '.join(sorted(accepted))})"))

    for sf in project.python_files():
        # Nested functions appear in their parents' scopes too; dedupe
        # per-node so a list is never scanned twice.
        seen_lists: set[int] = set()
        for scope in _function_scopes(sf):
            vars_: dict[str, _CmdState] = {}
            # States displaced by reassignment (cmd = [...] twice): their
            # flags/targets were real spawns and must still be checked.
            retired: list[_CmdState] = []
            # Every assignment's value expression, so a seam fed by a
            # Name can fall back to scanning whatever was assigned (the
            # real fleet per_replica_args is a dict comprehension).
            exprs: dict[str, ast.AST] = {}
            scope_targets: set[str] = set()
            policy_resume: list[tuple[str, int]] = []
            seen_binops: set[int] = set()
            for node in _ordered_nodes(scope):
                if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                        and isinstance(node.targets[0], ast.Name):
                    name = node.targets[0].id
                    value = node.value
                    exprs[name] = value
                    seen_binops.add(id(value))
                    # Rebinding a tracked name: the old command was a
                    # real spawn whose flags must still be checked —
                    # unless the new value extends it (cmd = cmd + [...])
                    # and inherits them.
                    displaced = vars_.pop(name, None)
                    consumed = False
                    if isinstance(value, ast.List):
                        seen_lists.add(id(value))
                        vars_[name] = _scan_list(value, sf)
                    elif isinstance(value, ast.BinOp) \
                            and isinstance(value.op, ast.Add):
                        # cmd = base + [...]: inherit base's state.
                        left, right = value.left, value.right
                        base = None
                        if isinstance(left, ast.Name):
                            base = vars_.get(left.id)
                            if base is None and displaced is not None \
                                    and left.id == name:
                                base = displaced
                                consumed = True
                        elif isinstance(left, ast.List):
                            seen_lists.add(id(left))
                            base = _scan_list(left, sf)
                        if base is not None and isinstance(right, ast.List):
                            seen_lists.add(id(right))
                            merged = _CmdState(flags=list(base.flags),
                                               targets=set(base.targets),
                                               current=base.current)
                            vars_[name] = _scan_list(right, sf, merged)
                        else:
                            consumed = False
                    if displaced is not None and not consumed:
                        retired.append(displaced)
                elif isinstance(node, ast.BinOp) \
                        and isinstance(node.op, ast.Add) \
                        and id(node) not in seen_binops:
                    # Inline concat at expression position:
                    # subprocess.run(cmd + ["--flag"]) or ([..] + [..]).
                    left, right = node.left, node.right
                    base = None
                    if isinstance(left, ast.Name):
                        tracked = vars_.get(left.id)
                        if tracked is not None:
                            base = _CmdState(flags=list(tracked.flags),
                                             targets=set(tracked.targets),
                                             current=tracked.current)
                    elif isinstance(left, ast.List):
                        seen_lists.add(id(left))
                        base = _scan_list(left, sf)
                    if base is not None and isinstance(right, ast.List):
                        seen_lists.add(id(right))
                        retired.append(_scan_list(right, sf, base))
                elif isinstance(node, ast.AugAssign) \
                        and isinstance(node.target, ast.Name) \
                        and isinstance(node.op, ast.Add) \
                        and isinstance(node.value, ast.List):
                    state = vars_.get(node.target.id)
                    if state is not None:
                        # Untracked target (built via list(...), etc.):
                        # leave the literal for the standalone scan so
                        # any target it embeds still gets checked.
                        seen_lists.add(id(node.value))
                        _scan_list(node.value, sf, state)
                elif isinstance(node, ast.Call):
                    func = node.func
                    fname = func.attr if isinstance(func, ast.Attribute) \
                        else (func.id if isinstance(func, ast.Name) else None)
                    # cmd.append("--flag") / cmd.extend([...])
                    if isinstance(func, ast.Attribute) \
                            and isinstance(func.value, ast.Name) \
                            and func.value.id in vars_:
                        state = vars_[func.value.id]
                        if fname == "append" and node.args:
                            s = str_const(node.args[0])
                            if s is not None and _FLAG_RE.match(s):
                                state.flags.append((state.current, s,
                                                    node.args[0].lineno))
                        elif fname == "extend" and node.args \
                                and isinstance(node.args[0], ast.List):
                            seen_lists.add(id(node.args[0]))
                            _scan_list(node.args[0], sf, state)
                    # Special seams with known targets.
                    if fname in _SPECIAL_KWARGS:
                        for kw in node.keywords:
                            targets = _SPECIAL_KWARGS[fname].get(kw.arg)
                            if targets is None:
                                continue
                            if isinstance(kw.value, ast.Name):
                                state = vars_.get(kw.value.id)
                                if state is not None:
                                    flags = [(f, ln) for _, f, ln in
                                             state.flags]
                                else:
                                    # Not a tracked list (dict comp,
                                    # conditional expr, ...): scan the
                                    # assigned expression's literals.
                                    expr = exprs.get(kw.value.id)
                                    flags = _literal_flags(expr) \
                                        if expr is not None else []
                            else:
                                flags = _literal_flags(kw.value)
                            for flag, line in flags:
                                for target in targets:
                                    check_flag(target, flag, sf, line)
                    elif fname == "SupervisorPolicy":
                        for kw in node.keywords:
                            if kw.arg == "resume_arg":
                                s = str_const(kw.value)
                                if s is not None and _FLAG_RE.match(s):
                                    policy_resume.append((s,
                                                          kw.value.lineno))
            # Check tracked command lists' flags (live and displaced).
            for state in list(vars_.values()) + retired:
                scope_targets |= state.targets
                for target, flag, line in state.flags:
                    check_flag(target, flag, sf, line)
            # Relaunch flags apply to every child shape this function
            # builds (the relaunch seam).
            for flag, line in policy_resume:
                for target in sorted(scope_targets):
                    check_flag(target, flag, sf, line)
        # Standalone command lists (passed inline to subprocess.run /
        # run_stage / Popen without ever being assigned).
        for node in sf.nodes():
            if isinstance(node, ast.List) and id(node) not in seen_lists:
                state = _scan_list(node, sf)
                if state.targets:
                    for target, flag, line in state.flags:
                        check_flag(target, flag, sf, line)
    # A list can feed several seams (e.g. serve_args reused per replica);
    # report each violation once.
    return list(dict.fromkeys(findings))
