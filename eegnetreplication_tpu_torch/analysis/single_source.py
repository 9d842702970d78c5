"""Header-set single-sourcing: no hand-spelled ``PASSTHROUGH_HEADERS``.

The port's copy of ``eegnetreplication_tpu/analysis/single_source.py``.
The bug class: the fleet front once forwarded a hand-spelled
``("X-Deadline-Ms", "X-Priority")`` tuple and silently dropped
``X-Model`` — every octet-stream client got the default tenant.  The
fix pinned the set once as ``serve.service.PASSTHROUGH_HEADERS``; this
rule keeps it that way: any list/tuple/set literal containing **two or
more** members of the pinned header set, anywhere outside the defining
module, is a hand-spelled copy that will drift.

Single-header literals (reading one header at a parse site) are fine —
only collections re-spell the *set* contract.

Rule: ``header-set-hand-spelled``.
"""

from __future__ import annotations

import ast

from eegnetreplication_tpu_torch.analysis.core import (
    Contracts,
    Finding,
    Project,
    str_const,
)

RULE = "header-set-hand-spelled"

RULES = (RULE,)


def check(project: Project, contracts: Contracts) -> list[Finding]:
    pinned = set(contracts.passthrough_headers)
    if not pinned:
        return []
    findings: list[Finding] = []
    for sf in project.python_files():
        if sf.rel == contracts.service_rel:
            continue  # the defining module spells the literal once
        for node in sf.nodes():
            if isinstance(node, (ast.List, ast.Tuple, ast.Set)):
                elements = node.elts
            elif isinstance(node, ast.Dict):
                # {"X-Deadline-Ms": d, ...} — the natural HTTP-forwarding
                # shape re-spells the set through its keys.
                elements = [k for k in node.keys if k is not None]
            else:
                continue
            members = [s for s in (str_const(el) for el in elements)
                       if s is not None and s in pinned]
            if len(members) >= 2:
                findings.append(Finding(
                    rule=RULE, file=sf.rel, line=node.lineno,
                    symbol=",".join(sorted(members)),
                    message=f"hand-spelled passthrough header set "
                            f"{members} — import PASSTHROUGH_HEADERS from "
                            f"{contracts.service_rel} instead (a copy is "
                            f"exactly how the dropped-X-Model bug "
                            f"happened)"))
    return findings
