"""Run every lint pass over a project and apply suppressions."""

from __future__ import annotations

from pathlib import Path

from eegnetreplication_tpu_torch.analysis import (
    inject_sites,
    jit_purity,
    journal_events,
    lock_discipline,
    single_source,
    spawn_args,
)
from eegnetreplication_tpu_torch.analysis.core import (
    Contracts,
    Finding,
    Project,
    filter_suppressed,
)

# Name -> pass module (each exposes check(project, contracts) + RULES).
PASSES = {
    "journal-events": journal_events,
    "inject-sites": inject_sites,
    "spawn-args": spawn_args,
    "lock-discipline": lock_discipline,
    "jit-purity": jit_purity,
    "single-source": single_source,
}


def active_rules(passes: tuple[str, ...] | None = None) -> set[str]:
    """Rule ids the given pass subset can produce (plus parse errors) —
    used to scope stale-baseline detection to what actually ran."""
    rules = {"parse-error"}
    for name, module in PASSES.items():
        if passes is None or name in passes:
            rules.update(module.RULES)
    return rules


def run_all(root: str | Path, *, passes: tuple[str, ...] | None = None,
            project: Project | None = None,
            contracts: Contracts | None = None) -> list[Finding]:
    """All findings for the tree at ``root``, suppressions applied,
    sorted by file/line/rule for stable output."""
    project = project or Project.scan(root)
    contracts = contracts or Contracts.from_project(project)
    findings: list[Finding] = project.parse_findings()
    for name, module in PASSES.items():
        if passes is not None and name not in passes:
            continue
        findings.extend(module.check(project, contracts))
    findings = filter_suppressed(project, findings)
    return sorted(findings, key=lambda f: (f.file, f.line, f.rule, f.symbol))
