"""Pass 4 — lock discipline: ``*_locked`` callees need the lock held.

The convention across the serving stack: a method named ``*_locked``
asserts nothing and takes no lock — its *callers* must hold the owning
object's lock.  Statically enforceable:

- a call ``self.foo_locked(...)`` is legal only when it is lexically
  inside a ``with self.<lock>:`` block (where ``<lock>`` is an attribute
  the class assigns ``threading.Lock/RLock/Condition`` to), or inside
  another ``*_locked`` method of the same class;
- a bare call ``foo_locked(...)`` at module level follows the same rule
  against module-level lock assignments;
- a call ``other.foo_locked(...)`` on a *different* object is always
  flagged: the caller cannot hold another object's private lock without
  reaching through its encapsulation.

Rule: ``lock-discipline``.
"""

from __future__ import annotations

import ast

from eegnetreplication_tpu_torch.analysis.core import (
    Contracts,
    Finding,
    Project,
    dotted_name,
)

RULE = "lock-discipline"

RULES = (RULE,)

_LOCK_FACTORIES = ("Lock", "RLock", "Condition", "Semaphore",
                   "BoundedSemaphore")


def _is_lock_factory(node: ast.AST) -> bool:
    if not isinstance(node, ast.Call):
        return False
    dn = dotted_name(node.func)
    if dn is not None and dn.split(".")[-1] in _LOCK_FACTORIES:
        return True
    # Dataclass idiom: field(default_factory=threading.Lock).
    if dn is not None and dn.split(".")[-1] == "field":
        for kw in node.keywords:
            if kw.arg == "default_factory":
                fdn = dotted_name(kw.value)
                if fdn is not None \
                        and fdn.split(".")[-1] in _LOCK_FACTORIES:
                    return True
    return False


def _class_lock_attrs(cls: ast.ClassDef) -> set[str]:
    """Attr names assigned a lock anywhere in the class body, plus
    aliases of those locks (``self._idle = threading.Condition(
    self._stats_lock)`` makes both names hold the same lock).  Both
    plain and annotated assignments count, including class-level
    dataclass fields."""
    locks: set[str] = set()
    for node in ast.walk(cls):
        if isinstance(node, ast.Assign) and _is_lock_factory(node.value):
            targets = node.targets
        elif isinstance(node, ast.AnnAssign) and node.value is not None \
                and _is_lock_factory(node.value):
            targets = [node.target]
        else:
            continue
        for target in targets:
            if isinstance(target, ast.Attribute) \
                    and isinstance(target.value, ast.Name) \
                    and target.value.id == "self":
                locks.add(target.attr)
            elif isinstance(target, ast.Name):
                # Class-level dataclass field: _lock: Lock = field(...).
                locks.add(target.id)
    return locks


def _module_lock_names(tree: ast.Module) -> set[str]:
    locks: set[str] = set()
    for node in tree.body:
        if isinstance(node, ast.Assign) and _is_lock_factory(node.value):
            for target in node.targets:
                if isinstance(target, ast.Name):
                    locks.add(target.id)
        elif isinstance(node, ast.AnnAssign) and node.value is not None \
                and isinstance(node.target, ast.Name) \
                and _is_lock_factory(node.value):
            locks.add(node.target.id)
    return locks


def _resolved_lock_attrs(cls: ast.ClassDef,
                         by_name: dict[str, ast.ClassDef],
                         ) -> tuple[set[str], bool]:
    """Lock attrs of ``cls`` plus every same-file ancestor; the bool is
    True when some base could not be resolved in this file (an imported
    base may own the lock, so an empty set must not convict)."""
    locks: set[str] = set()
    external_base = False
    seen: set[str] = set()
    stack = [cls]
    while stack:
        cur = stack.pop()
        if cur.name in seen:
            continue
        seen.add(cur.name)
        locks |= _class_lock_attrs(cur)
        for base in cur.bases:
            if isinstance(base, ast.Name) and base.id in by_name:
                stack.append(by_name[base.id])
            elif not (isinstance(base, ast.Name)
                      and base.id in ("object", "Exception")):
                external_base = True
    return locks, external_base


def check(project: Project, contracts: Contracts) -> list[Finding]:
    findings: list[Finding] = []
    for sf in project.python_files():
        module_locks = _module_lock_names(sf.tree)
        classes_by_name = {n.name: n for n in sf.nodes()
                           if isinstance(n, ast.ClassDef)}
        class_locks: dict[ast.ClassDef, tuple[set[str], bool]] = {}

        for node in sf.nodes():
            if not (isinstance(node, ast.Call)
                    and ((isinstance(node.func, ast.Attribute)
                          and node.func.attr.endswith("_locked"))
                         or (isinstance(node.func, ast.Name)
                             and node.func.id.endswith("_locked")))):
                continue
            method = node.func.attr if isinstance(node.func, ast.Attribute) \
                else node.func.id

            # Enclosing class (nearest) and whether any enclosing function
            # is itself *_locked.
            cls = None
            in_locked_fn = False
            for anc in sf.ancestors(node):
                if isinstance(anc, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                        and anc.name.endswith("_locked"):
                    in_locked_fn = True
                if isinstance(anc, ast.ClassDef) and cls is None:
                    cls = anc
            if cls is not None and cls not in class_locks:
                class_locks[cls] = _resolved_lock_attrs(cls,
                                                        classes_by_name)

            is_self_call = isinstance(node.func, ast.Attribute) \
                and isinstance(node.func.value, ast.Name) \
                and node.func.value.id == "self"
            is_bare_call = isinstance(node.func, ast.Name)

            if not (is_self_call or is_bare_call):
                findings.append(Finding(
                    rule=RULE, file=sf.rel, line=node.lineno, symbol=method,
                    message=f"{method}() is called on another object; "
                            f"*_locked methods may only be called by their "
                            f"own object under its lock"))
                continue
            if in_locked_fn:
                continue

            if is_self_call:
                known, external_base = class_locks.get(cls, (set(), False))
            else:
                known, external_base = module_locks, False
            # An imported base class may own the lock: with no locally
            # detected lock attrs, accept any `with self.<attr>:` guard
            # rather than convict correctly-locked subclass code.
            permissive = is_self_call and not known and external_base
            held = False
            for anc in sf.ancestors(node):
                if isinstance(anc, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    break  # a with outside the enclosing function is a lie
                if isinstance(anc, (ast.With, ast.AsyncWith)):
                    for item in anc.items:
                        expr = item.context_expr
                        if is_self_call \
                                and isinstance(expr, ast.Attribute) \
                                and isinstance(expr.value, ast.Name) \
                                and expr.value.id == "self" \
                                and (expr.attr in known or permissive):
                            held = True
                        elif is_bare_call and isinstance(expr, ast.Name) \
                                and expr.id in known:
                            held = True
                if held:
                    break
            if not held:
                where = "a known lock of its class" if is_self_call \
                    else "a module-level lock"
                findings.append(Finding(
                    rule=RULE, file=sf.rel, line=node.lineno, symbol=method,
                    message=f"{method}() is called without holding "
                            f"{where} (wrap the call in `with "
                            f"self._lock:` or call it from another "
                            f"*_locked method)"))
    return findings
