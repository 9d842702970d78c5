"""Linter core: findings, suppressions, baseline, and the project index.

The port's copy of ``eegnetreplication_tpu/analysis/core.py``, reading the
port's package (:data:`PACKAGE`).  Everything here is stdlib-only and
**never imports the linted code** — contract tables (``EVENT_REQUIRED``,
``SITES``, ``PASSTHROUGH_HEADERS``, ``FaultSpec`` field names) are
extracted from the source ASTs with ``ast.literal_eval``, so the linter
runs in milliseconds, needs no torch, and cannot be fooled by import-time
side effects.

Three mechanisms keep the gate honest without blocking real work:

- **Suppressions** — a ``# lint: ignore[rule-id]`` (or bare
  ``# lint: ignore``) comment on the flagged line silences that line.
  Use for single call sites that are deliberately special.
- **Baseline** — a checked-in JSON file of grandfathered findings, each
  with a one-line ``why``.  Baselined findings don't fail the gate; a
  baseline entry that no longer matches anything is itself an error
  (``stale``), so the baseline can only shrink.
- **Severity** — findings carry ``error`` (gates) or ``warn``
  (reported, never gates); every shipped rule is ``error`` today.

Baseline keys are ``rule:file:symbol`` — no line numbers, so moving code
never churns the baseline; ``symbol`` is the contested name (event type,
site, flag, method).
"""

from __future__ import annotations

import ast
import json
import re
from dataclasses import dataclass, field
from pathlib import Path

LINT_SCHEMA_VERSION = 1

# The package the linter reads; every contract path derives from it.
PACKAGE = "eegnetreplication_tpu_torch"

# Repo-relative files the contract tables live in.
SCHEMA_REL = f"{PACKAGE}/obs/schema.py"
INJECT_REL = f"{PACKAGE}/resil/inject.py"
SERVICE_REL = f"{PACKAGE}/serve/service.py"
# The journal events' documentation: the repo's, read and never edited.
BENCH_NOTES_REL = "BENCH_NOTES.md"
# The baseline the CLI reads by default.
BASELINE_REL = f"{PACKAGE}/analysis/lint_baseline.json"

# Scanned by default: the package and the chip smoke, which spawns the
# package's CLIs with literal flags and --chaos plans (tests/ deliberately
# excluded: tests synthesize invalid events/sites on purpose to exercise
# validation).
DEFAULT_ROOTS = (PACKAGE, "chip_smoke.py")

_SUPPRESS_RE = re.compile(r"#\s*lint:\s*ignore(?:\[([^\]]*)\])?")


@dataclass(frozen=True)
class Finding:
    """One rule violation, anchored to a file:line."""

    rule: str
    file: str          # repo-relative posix path ("" for tree-level)
    line: int
    message: str
    symbol: str = ""   # stable key part: the contested name
    severity: str = "error"

    @property
    def key(self) -> str:
        return f"{self.rule}:{self.file}:{self.symbol or self.message}"

    def render(self) -> str:
        loc = f"{self.file}:{self.line}" if self.file else "<project>"
        return f"{loc}: {self.rule}: {self.message}"


class SourceFile:
    """One parsed source file: text, lines, AST, and a lazy parent map."""

    def __init__(self, root: Path, path: Path):
        self.path = path
        self.rel = path.relative_to(root).as_posix()
        self.text = path.read_text(encoding="utf-8", errors="replace")
        self.lines = self.text.splitlines()
        self.tree: ast.Module | None = None
        self.parse_error: str | None = None
        self._parents: dict[ast.AST, ast.AST] | None = None
        self._nodes: list[ast.AST] | None = None
        try:
            self.tree = ast.parse(self.text, filename=str(path))
        except SyntaxError as exc:  # surfaced as its own finding
            self.parse_error = f"{exc.msg} (line {exc.lineno})"

    def nodes(self) -> list[ast.AST]:
        """Every node of the file in ``ast.walk`` order, walked once and
        shared by the passes (the walk is most of the linter's time)."""
        if self._nodes is None:
            self._nodes = list(ast.walk(self.tree))
        return self._nodes

    def parents(self) -> dict[ast.AST, ast.AST]:
        """child -> parent map for ancestry walks (with/def enclosure)."""
        if self._parents is None:
            self._parents = {}
            for node in self.nodes():
                for child in ast.iter_child_nodes(node):
                    self._parents[child] = node
        return self._parents

    def ancestors(self, node: ast.AST):
        parents = self.parents()
        cur = parents.get(node)
        while cur is not None:
            yield cur
            cur = parents.get(cur)

    def suppressed(self, finding: Finding) -> bool:
        """``# lint: ignore[rule]`` on the finding's line silences it."""
        if not (1 <= finding.line <= len(self.lines)):
            return False
        m = _SUPPRESS_RE.search(self.lines[finding.line - 1])
        if not m:
            return False
        if m.group(1) is None:
            return True
        rules = {r.strip() for r in m.group(1).split(",") if r.strip()}
        return finding.rule in rules


class Project:
    """The scanned tree: parsed sources plus lookup helpers."""

    def __init__(self, root: Path, files: list[SourceFile]):
        self.root = Path(root)
        self.files = files
        self.by_rel = {sf.rel: sf for sf in files}

    @classmethod
    def scan(cls, root: str | Path,
             roots: tuple[str, ...] = DEFAULT_ROOTS) -> "Project":
        root = Path(root)
        paths: list[Path] = []
        for sub in roots:
            base = root / sub
            if base.is_file():
                paths.append(base)
            elif base.is_dir():
                paths.extend(sorted(base.rglob("*.py")))
        files = [SourceFile(root, p) for p in paths
                 if "__pycache__" not in p.parts]
        return cls(root, files)

    def python_files(self) -> list[SourceFile]:
        return [sf for sf in self.files if sf.tree is not None]

    def parse_findings(self) -> list[Finding]:
        return [Finding(rule="parse-error", file=sf.rel, line=1,
                        message=f"cannot parse: {sf.parse_error}",
                        symbol=sf.rel)
                for sf in self.files if sf.tree is None]

    def read_text(self, rel: str) -> str | None:
        p = self.root / rel
        return p.read_text(encoding="utf-8",
                           errors="replace") if p.is_file() else None


# ---------------------------------------------------------------------------
# Contract extraction (AST-only: the linted package is never imported).

def module_literal(tree: ast.Module, name: str):
    """``ast.literal_eval`` of the module-level assignment ``name = ...``
    (None when absent or not a pure literal)."""
    for node in tree.body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name) \
                and node.targets[0].id == name:
            try:
                return ast.literal_eval(node.value)
            except ValueError:
                return None
        if isinstance(node, ast.AnnAssign) and node.value is not None \
                and isinstance(node.target, ast.Name) \
                and node.target.id == name:
            try:
                return ast.literal_eval(node.value)
            except ValueError:
                return None
    return None


def _dict_key_lines(tree: ast.Module, name: str) -> dict[str, int]:
    """Line number of each string key in the dict literal ``name = {...}``."""
    for node in tree.body:
        value = None
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name) \
                and node.targets[0].id == name:
            value = node.value
        elif isinstance(node, ast.AnnAssign) \
                and isinstance(node.target, ast.Name) \
                and node.target.id == name:
            value = node.value
        if isinstance(value, ast.Dict):
            return {k.value: k.lineno for k in value.keys
                    if isinstance(k, ast.Constant) and isinstance(k.value, str)}
    return {}


def _tuple_item_lines(tree: ast.Module, name: str) -> dict[str, int]:
    for node in tree.body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name) \
                and node.targets[0].id == name \
                and isinstance(node.value, (ast.Tuple, ast.List)):
            return {el.value: el.lineno for el in node.value.elts
                    if isinstance(el, ast.Constant)
                    and isinstance(el.value, str)}
    return {}


def _function_str_literals(tree: ast.Module, func: str) -> set[str]:
    for node in ast.walk(tree):
        if isinstance(node, ast.FunctionDef) and node.name == func:
            return {n.value for n in ast.walk(node)
                    if isinstance(n, ast.Constant) and isinstance(n.value, str)}
    return set()


def _class_field_names(tree: ast.Module, cls_name: str) -> set[str]:
    for node in ast.walk(tree):
        if isinstance(node, ast.ClassDef) and node.name == cls_name:
            return {stmt.target.id for stmt in node.body
                    if isinstance(stmt, ast.AnnAssign)
                    and isinstance(stmt.target, ast.Name)}
    return set()


@dataclass
class Contracts:
    """The single-sourced tables every pass checks literals against."""

    # journal events
    event_required: dict[str, tuple] = field(default_factory=dict)
    event_decl_lines: dict[str, int] = field(default_factory=dict)
    event_summary_refs: set[str] = field(default_factory=set)
    schema_rel: str = SCHEMA_REL
    bench_notes_text: str = ""
    # inject sites
    sites: tuple = ()
    site_decl_lines: dict[str, int] = field(default_factory=dict)
    faultspec_fields: set[str] = field(default_factory=set)
    inject_rel: str = INJECT_REL
    # pinned header set
    passthrough_headers: tuple = ()
    service_rel: str = SERVICE_REL

    @classmethod
    def from_project(cls, project: Project) -> "Contracts":
        c = cls()
        schema = project.by_rel.get(SCHEMA_REL)
        if schema is not None and schema.tree is not None:
            c.event_required = module_literal(schema.tree,
                                              "EVENT_REQUIRED") or {}
            c.event_decl_lines = _dict_key_lines(schema.tree,
                                                 "EVENT_REQUIRED")
            c.event_summary_refs = _function_str_literals(schema.tree,
                                                          "event_summary")
        inject = project.by_rel.get(INJECT_REL)
        if inject is not None and inject.tree is not None:
            c.sites = tuple(module_literal(inject.tree, "SITES") or ())
            c.site_decl_lines = _tuple_item_lines(inject.tree, "SITES")
            c.faultspec_fields = _class_field_names(inject.tree, "FaultSpec")
        service = project.by_rel.get(SERVICE_REL)
        if service is not None and service.tree is not None:
            c.passthrough_headers = tuple(
                module_literal(service.tree, "PASSTHROUGH_HEADERS") or ())
        c.bench_notes_text = project.read_text(BENCH_NOTES_REL) or ""
        return c

    def documented_in_bench_notes(self, name: str) -> bool:
        # Word-boundary match so "compile" can't ride on "compile_end".
        return re.search(rf"(?<![A-Za-z0-9_]){re.escape(name)}"
                         rf"(?![A-Za-z0-9_])", self.bench_notes_text) is not None


# ---------------------------------------------------------------------------
# Baseline: grandfathered findings that must only shrink.

def load_baseline(path: str | Path | None) -> dict[str, dict]:
    """``{key: entry}`` from a baseline JSON file (empty when absent).

    The baseline is hand-edited (stale entries must be deleted by hand),
    so malformed content raises ``ValueError`` with enough context to
    fix the entry — not a bare ``KeyError`` traceback.
    """
    if path is None or not Path(path).is_file():
        return {}
    try:
        raw = json.loads(Path(path).read_text())
    except ValueError as exc:
        raise ValueError(f"baseline {path} is not valid JSON: {exc}") \
            from exc
    if not isinstance(raw, dict) or not isinstance(raw.get("findings", []),
                                                   list):
        raise ValueError(
            f"baseline {path} must be an object with a 'findings' list, "
            f"got top-level {type(raw).__name__}")
    out: dict[str, dict] = {}
    for entry in raw.get("findings", []):
        if not isinstance(entry, dict) or "rule" not in entry \
                or "symbol" not in entry:
            raise ValueError(
                f"baseline {path}: every finding entry needs 'rule' and "
                f"'symbol' keys, got {entry!r}")
        key = f"{entry['rule']}:{entry.get('file', '')}:{entry['symbol']}"
        out[key] = entry
    return out


def apply_baseline(findings: list[Finding], baseline: dict[str, dict],
                   ) -> tuple[list[Finding], list[Finding], list[dict]]:
    """Split findings into (new, grandfathered) and report stale entries.

    A baseline entry that matched no finding is *stale*: the underlying
    issue was fixed, so the entry must be deleted — this is what makes
    the baseline shrink-only.
    """
    new: list[Finding] = []
    matched: list[Finding] = []
    hit: set[str] = set()
    for f in findings:
        if f.key in baseline:
            matched.append(f)
            hit.add(f.key)
        else:
            new.append(f)
    stale = [entry for key, entry in baseline.items() if key not in hit]
    return new, matched, stale


def filter_suppressed(project: Project,
                      findings: list[Finding]) -> list[Finding]:
    out = []
    for f in findings:
        sf = project.by_rel.get(f.file)
        if sf is not None and sf.suppressed(f):
            continue
        out.append(f)
    return out


# Shared AST helpers used by several passes. ---------------------------------

def dotted_name(node: ast.AST) -> str | None:
    """``a.b.c`` for a Name/Attribute chain, else None."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def str_const(node: ast.AST) -> str | None:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None
