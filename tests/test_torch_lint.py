"""The JAX package's linter over the port's package.

``eegnetreplication_tpu/analysis`` reads its contracts from source ASTs and
never imports the code it lints.  This test configures it for
``eegnetreplication_tpu_torch/`` (it edits nothing there): the contracts
come from the port's ``obs/schema.py``, ``resil/inject.py`` and
``serve/service.py``, an ``inject`` call counts when it resolves to the
port's ``resil.inject``, and the spawn seams name the port's entry
points.  Five passes run: journal-events, inject-sites, spawn-args,
lock-discipline and single-source (the header set a fleet or a front
forwards is spelled once, as ``serve/service.py``'s
``PASSTHROUGH_HEADERS``).  ``jit-purity`` checks JAX code only.

- With an empty baseline the port's tree has no finding, but for the
  events its ``event_summary`` leaves out: the port's ``event_summary`` is
  the JAX one, and those are exactly the JAX baseline's justified
  ``journal-event-unsummarized`` entries.
- The gate guards what the serving tiers add: a mutated copy of the tree
  with an unregistered ``inject.fire`` site, an unregistered journal
  event, an unknown flag on a spawned cell's command line, a declared
  site that nothing fires any more, or a fleet that forwards a
  hand-spelled header set, fails it.
"""

import json
import shutil
from pathlib import Path

import pytest
from torch_port_cases import child_env  # noqa: F401 — one torch thread

from eegnetreplication_tpu.analysis import core, inject_sites, spawn_args
from eegnetreplication_tpu.analysis.core import (
    Contracts,
    Project,
    apply_baseline,
    load_baseline,
)
from eegnetreplication_tpu.analysis.runner import run_all

REPO = Path(__file__).resolve().parents[1]
PORT = "eegnetreplication_tpu_torch"
PASSES = ("journal-events", "inject-sites", "spawn-args", "lock-discipline",
          "single-source")
UNSUMMARIZED = "journal-event-unsummarized"


@pytest.fixture
def port_lint(monkeypatch):
    """The linter configured for the port: ``lint(root)`` -> findings."""
    monkeypatch.setattr(core, "SCHEMA_REL", f"{PORT}/obs/schema.py")
    monkeypatch.setattr(core, "INJECT_REL", f"{PORT}/resil/inject.py")
    monkeypatch.setattr(core, "SERVICE_REL", f"{PORT}/serve/service.py")
    monkeypatch.setattr(inject_sites, "_INJECT_MODULE",
                        f"{PORT}.resil.inject")
    monkeypatch.setattr(spawn_args, "_SPECIAL_KWARGS", {
        "spawn_replica_fleet": {
            "serve_args": (f"module:{PORT}.serve",),
            "per_replica_args": (f"module:{PORT}.serve",)},
        "spawn_cells": {
            "serve_args": (f"module:{PORT}.serve",
                           f"module:{PORT}.serve.fleet")},
    })

    def lint(root: Path):
        project = Project.scan(root, roots=(PORT,))
        contracts = Contracts.from_project(project)
        contracts.schema_rel = core.SCHEMA_REL
        contracts.inject_rel = core.INJECT_REL
        contracts.service_rel = core.SERVICE_REL
        assert contracts.event_required and contracts.sites
        assert set(contracts.passthrough_headers) == {
            "X-Model", "X-Deadline-Ms", "X-Priority"}
        return run_all(root, passes=PASSES, project=project,
                       contracts=contracts)

    return lint


def _gate(findings):
    new, _, stale = apply_baseline(findings, load_baseline(None))
    return [f for f in new if f.rule != UNSUMMARIZED], stale


def test_the_port_tree_lints_clean(port_lint):
    findings = port_lint(REPO)
    new, stale = _gate(findings)
    assert new == [] and stale == [], [f.render() for f in new]
    jax_baseline = json.loads((REPO / "lint_baseline.json").read_text())
    justified = sorted(e["symbol"] for e in jax_baseline["findings"]
                       if e["rule"] == UNSUMMARIZED)
    assert sorted(f.symbol for f in findings
                  if f.rule == UNSUMMARIZED) == justified


def test_the_cell_tier_fires_and_journals_registered_names(port_lint):
    """Every ``inject.fire`` site and journaled event of ``serve/cells/``
    is registered, and both cell sites are probed there."""
    from eegnetreplication_tpu_torch.obs.schema import EVENT_REQUIRED
    from eegnetreplication_tpu_torch.resil.inject import SITES

    cells = REPO / PORT / "serve" / "cells"
    text = "".join(p.read_text() for p in sorted(cells.glob("*.py")))
    assert 'inject.fire("cell.partition"' in text
    assert 'inject.fire("front.lease"' in text
    assert {"cell.partition", "front.lease"} <= set(SITES)
    for name in ("cell_front_start", "cell_member", "session_migrate",
                 "session_failover", "cell_front_end", "front_lease",
                 "affinity_replay", "cell_upgrade"):
        assert name in EVENT_REQUIRED
        assert f'"{name}"' in text
    findings = [f for f in port_lint(REPO)
                if f.file.startswith(f"{PORT}/serve/cells/")]
    assert findings == []


# (file under serve/, text replaced, replacement, the findings)
MUTATIONS = {
    "unknown_site": (
        "cells/membership.py", 'inject.fire("cell.partition"',
        'inject.fire("cell.partitoin"',
        [("inject-site-unknown", "cell.partitoin"),
         ("inject-site-unprobed", "cell.partition")]),
    "unknown_event": (
        "cells/front.py", '"session_migrate", session=sid',
        '"session_moved", session=sid',
        [("journal-event-unemitted", "session_migrate"),
         ("journal-event-unknown", "session_moved")]),
    "unknown_flag": (
        "cells/service.py", '"--sessionsMirror"', '"--sessionsMirrror"',
        [("spawn-arg-unknown", "--sessionsMirrror")]),
    "unprobed_site": (
        "cells/ha.py",
        'inject.fire("front.lease", owner=self.owner, token=token)',
        "pass", [("inject-site-unprobed", "front.lease")]),
    # The fleet forwards a copy of the header set that lacks X-Model, the
    # reference's dropped-tenant fault.
    "hand_spelled_headers": (
        "fleet/service.py",
        "passthrough = {h: self.headers[h] for h in PASSTHROUGH_HEADERS",
        'passthrough = {h: self.headers[h] for h in ("X-Deadline-Ms", '
        '"X-Priority")',
        [("header-set-hand-spelled", "X-Deadline-Ms,X-Priority")]),
}


@pytest.mark.parametrize("name", sorted(MUTATIONS))
def test_the_gate_catches_a_broken_cell_tier(name, port_lint, tmp_path):
    rel, old, new, want = MUTATIONS[name]
    shutil.copytree(REPO / PORT, tmp_path / PORT,
                    ignore=shutil.ignore_patterns("__pycache__", "_build",
                                                  "csrc"))
    # The journal-events pass reads the event docs beside the tree.
    shutil.copy(REPO / "BENCH_NOTES.md", tmp_path / "BENCH_NOTES.md")
    path = tmp_path / PORT / "serve" / rel
    text = path.read_text()
    assert text.count(old) == 1, (rel, old)
    path.write_text(text.replace(old, new))
    new_findings, _ = _gate(port_lint(tmp_path))
    assert sorted((f.rule, f.symbol) for f in new_findings) == want
