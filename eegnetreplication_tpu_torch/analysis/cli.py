"""``python -m eegnetreplication_tpu_torch.analysis.cli`` — run the port's
contract linter from the command line (the port's copy of
``eegnetreplication_tpu/analysis/cli.py``: the same flags, exit codes and
``--json`` record).

Text output is one ``file:line: rule: message`` per finding plus a
summary; ``--json`` emits a machine-readable record for CI::

    {
      "schema_version": 1,
      "root": "/abs/repo",
      "passes": ["journal-events", ...],
      "counts": {"total": N, "new": N, "baselined": N, "stale_baseline": N},
      "findings": [{"rule", "file", "line", "symbol", "message",
                    "severity", "baselined": bool}, ...],
      "stale_baseline": [ ...baseline entries with no matching finding... ]
    }

Exit codes: 0 = clean (no new findings, no stale baseline entries);
1 = new findings and/or stale baseline entries; 2 = usage error.

The baseline (default
``<root>/eegnetreplication_tpu_torch/analysis/lint_baseline.json`` when
present) holds
grandfathered findings keyed ``rule:file:symbol`` — line-number-free so
moving code never churns it — each with a one-line ``why``.  A stale
entry (nothing matches it any more) fails the run until it is deleted:
the baseline can only shrink.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

from eegnetreplication_tpu_torch.analysis.core import (
    BASELINE_REL,
    LINT_SCHEMA_VERSION,
    apply_baseline,
    load_baseline,
)
from eegnetreplication_tpu_torch.analysis.runner import (
    PASSES,
    active_rules,
    run_all,
)


def _default_root() -> Path:
    # The package sits at <root>/eegnetreplication_tpu_torch/analysis;
    # the repo root is two levels up from this file's parent.
    return Path(__file__).resolve().parent.parent.parent


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="eegtpu-lint",
        description="AST contract linter: journal events, inject sites, "
                    "spawn args, lock discipline, jit purity, header "
                    "single-sourcing.")
    parser.add_argument("--root", default=None,
                        help="Repo root to lint (default: the checkout "
                             "this package lives in).")
    parser.add_argument("--passes", default=None,
                        help=f"Comma-separated subset of passes to run "
                             f"(default: all). Known: {', '.join(PASSES)}")
    baseline_group = parser.add_mutually_exclusive_group()
    baseline_group.add_argument(
        "--baseline", default=None,
        help=f"Baseline JSON path (default: <root>/{BASELINE_REL} "
             f"when it exists).")
    baseline_group.add_argument(
        "--no-baseline", action="store_true",
        help="Ignore any baseline: report every finding as new.")
    parser.add_argument("--json", action="store_true", dest="as_json",
                        help="Emit the machine-readable JSON record "
                             "instead of text.")
    args = parser.parse_args(argv)

    root = Path(args.root) if args.root else _default_root()
    if not root.is_dir():
        parser.error(f"--root {root} is not a directory")
    if args.root is None and not (root / "pyproject.toml").is_file():
        # A pip-installed package's parent is site-packages, not the
        # checkout: scanning it would miss chip_smoke/BENCH_NOTES
        # and report spurious findings.  Refuse to guess.
        parser.error(f"default root {root} is not a repo checkout "
                     f"(no pyproject.toml); pass --root <checkout>")
    passes = None
    if args.passes:
        passes = tuple(p.strip() for p in args.passes.split(",")
                       if p.strip())
        unknown = [p for p in passes if p not in PASSES]
        if unknown:
            parser.error(f"unknown pass(es) {unknown}; known: "
                         f"{', '.join(PASSES)}")
        if not passes:
            # "--passes ," must not become run-nothing-exit-0: a CI
            # typo would silently disable the whole gate.
            parser.error(f"--passes selected no passes; known: "
                         f"{', '.join(PASSES)}")

    t0 = time.monotonic()
    findings = run_all(root, passes=passes)
    baseline_path = None
    if not args.no_baseline:
        if args.baseline:
            baseline_path = Path(args.baseline)
            if not baseline_path.is_file():
                # A typo'd explicit path must not silently become "no
                # baseline" (every grandfathered finding would read as
                # new); --no-baseline is the intentional spelling.
                parser.error(f"--baseline {baseline_path} does not exist")
        else:
            baseline_path = root / BASELINE_REL
    try:
        baseline = load_baseline(baseline_path)
    except ValueError as exc:
        parser.error(str(exc))
    # A pass-subset run can only judge baseline entries of the rules it
    # produced; entries for skipped passes are neither matched nor stale.
    rules = active_rules(passes)
    baseline = {k: e for k, e in baseline.items() if e["rule"] in rules}
    new, matched, stale = apply_baseline(findings, baseline)
    wall_s = time.monotonic() - t0

    baselined_keys = {f.key for f in matched}
    if args.as_json:
        record = {
            "schema_version": LINT_SCHEMA_VERSION,
            "root": str(root),
            "passes": list(passes or PASSES),
            "wall_s": round(wall_s, 3),
            "counts": {"total": len(findings), "new": len(new),
                       "baselined": len(matched),
                       "stale_baseline": len(stale)},
            "findings": [{
                "rule": f.rule, "file": f.file, "line": f.line,
                "symbol": f.symbol, "message": f.message,
                "severity": f.severity,
                "baselined": f.key in baselined_keys,
            } for f in findings],
            "stale_baseline": stale,
        }
        print(json.dumps(record, indent=2))
    else:
        for f in new:
            print(f.render())
        for entry in stale:
            print(f"<baseline>: stale entry {entry['rule']}:"
                  f"{entry.get('file', '')}:{entry['symbol']} matches "
                  f"nothing — the issue was fixed; delete the entry "
                  f"(baselines only shrink)")
        print(f"eegtpu-lint: {len(findings)} finding(s) — {len(new)} new, "
              f"{len(matched)} baselined, {len(stale)} stale baseline "
              f"entr{'y' if len(stale) == 1 else 'ies'} "
              f"({wall_s:.2f}s)", file=sys.stderr)
    # Honor severity: "warn" findings are reported but never gate
    # (core.py's documented contract; every shipped rule is "error").
    gating = [f for f in new if f.severity == "error"]
    return 1 if (gating or stale) else 0


if __name__ == "__main__":
    raise SystemExit(main())
