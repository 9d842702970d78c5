"""Pass 1 — journal events: every ``*.event("type", ...)`` vs the schema.

Rules:

- ``journal-event-unknown``       — a literal event name at a call site is
  not declared in ``EVENT_REQUIRED`` (the emitter would stamp
  ``_schema_error`` at runtime; this catches it at lint time).
- ``journal-event-missing-keys``  — a literal-name call's literal kwargs
  don't cover the type's required keys.  Calls that splat ``**payload``
  are skipped (the keys may arrive dynamically; runtime validation still
  covers them).
- ``journal-event-unemitted``     — a declared type that no call site in
  the scanned tree ever emits (dead schema).  Emission counts literal
  first args plus string assignments to ``*_EVENT`` names (the
  ``MEMBER_EVENT`` class-attr idiom in fleet/cells membership).
- ``journal-event-undocumented``  — a declared type whose name appears
  nowhere in ``BENCH_NOTES.md`` (event-type docs are lint-enforced).
- ``journal-event-unsummarized``  — a declared type that ``event_summary``
  never references.  Some lifecycle/paired types are deliberately
  unsummarized; those live in the baseline, each with a justification.
"""

from __future__ import annotations

import ast

from eegnetreplication_tpu_torch.analysis.core import (
    Contracts,
    Finding,
    Project,
    str_const,
)

RULE_UNKNOWN = "journal-event-unknown"
RULE_KEYS = "journal-event-missing-keys"
RULE_UNEMITTED = "journal-event-unemitted"
RULE_UNDOC = "journal-event-undocumented"
RULE_UNSUMMARIZED = "journal-event-unsummarized"

RULE_CONTRACT = "contract-missing"

RULES = (RULE_UNKNOWN, RULE_KEYS, RULE_UNEMITTED, RULE_UNDOC,
         RULE_UNSUMMARIZED, RULE_CONTRACT)


def check(project: Project, contracts: Contracts) -> list[Finding]:
    findings: list[Finding] = []
    emitted: set[str] = set()
    declared = contracts.event_required
    if not declared:
        # One loud finding at the cause, not hundreds at the call sites:
        # a refactor that makes EVENT_REQUIRED non-literal (dict union,
        # concatenation) breaks AST extraction and must be fixed there.
        return [Finding(
            rule=RULE_CONTRACT, file=contracts.schema_rel, line=1,
            symbol="EVENT_REQUIRED",
            message="EVENT_REQUIRED could not be extracted as a pure "
                    "literal dict; the journal-events pass cannot run")]
    if not contracts.bench_notes_text:
        # Same loudness for the doc contract: an absent/empty
        # BENCH_NOTES.md must not silently disable the undocumented
        # rule ("event docs are lint-enforced" would quietly stop
        # being true).
        findings.append(Finding(
            rule=RULE_CONTRACT, file="BENCH_NOTES.md", line=1,
            symbol="BENCH_NOTES.md",
            message="BENCH_NOTES.md is missing or empty; the "
                    "journal-event-undocumented rule cannot run"))
    if not contracts.event_summary_refs:
        # And for the third contract source: a renamed/moved
        # event_summary would otherwise kill the unsummarized rule AND
        # stale out every baseline entry with a misleading "issue was
        # fixed" message.
        findings.append(Finding(
            rule=RULE_CONTRACT, file=contracts.schema_rel, line=1,
            symbol="event_summary",
            message="event_summary could not be found in the schema "
                    "module; the journal-event-unsummarized rule "
                    "cannot run"))

    for sf in project.python_files():
        for node in sf.nodes():
            if isinstance(node, ast.Call) \
                    and isinstance(node.func, ast.Attribute) \
                    and node.func.attr == "event" and node.args:
                name = str_const(node.args[0])
                if name is None:
                    continue  # dynamic event name: runtime validation owns it
                emitted.add(name)
                if name not in declared:
                    findings.append(Finding(
                        rule=RULE_UNKNOWN, file=sf.rel, line=node.lineno,
                        symbol=name,
                        message=f"event type {name!r} is not declared in "
                                f"EVENT_REQUIRED ({contracts.schema_rel})"))
                    continue
                if any(kw.arg is None for kw in node.keywords):
                    continue  # **payload splat: keys unknown statically
                given = {kw.arg for kw in node.keywords}
                missing = [k for k in declared[name] if k not in given]
                if missing:
                    findings.append(Finding(
                        rule=RULE_KEYS, file=sf.rel, line=node.lineno,
                        symbol=name,
                        message=f"event {name!r} call is missing required "
                                f"key(s) {missing} (EVENT_REQUIRED declares "
                                f"{list(declared[name])})"))
            # MEMBER_EVENT = "fleet_member" — class-attr emission idiom
            # (with or without a type annotation).
            elif isinstance(node, ast.Assign) and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Name) \
                    and node.targets[0].id.endswith("_EVENT"):
                value = str_const(node.value)
                if value is not None:
                    emitted.add(value)
            elif isinstance(node, ast.AnnAssign) \
                    and isinstance(node.target, ast.Name) \
                    and node.target.id.endswith("_EVENT") \
                    and node.value is not None:
                value = str_const(node.value)
                if value is not None:
                    emitted.add(value)

    for name in declared:
        line = contracts.event_decl_lines.get(name, 1)
        if name not in emitted:
            findings.append(Finding(
                rule=RULE_UNEMITTED, file=contracts.schema_rel, line=line,
                symbol=name,
                message=f"event type {name!r} is declared in EVENT_REQUIRED "
                        f"but no scanned call site ever emits it"))
        if contracts.bench_notes_text \
                and not contracts.documented_in_bench_notes(name):
            findings.append(Finding(
                rule=RULE_UNDOC, file=contracts.schema_rel, line=line,
                symbol=name,
                message=f"event type {name!r} is not documented in "
                        f"BENCH_NOTES.md (event-type docs are lint-enforced)"))
        if contracts.event_summary_refs \
                and name not in contracts.event_summary_refs:
            findings.append(Finding(
                rule=RULE_UNSUMMARIZED, file=contracts.schema_rel, line=line,
                symbol=name,
                message=f"event type {name!r} is never referenced by "
                        f"event_summary (summarize it or baseline the "
                        f"exception with a justification)"))
    return findings
