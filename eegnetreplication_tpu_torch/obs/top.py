"""The live console over run journals:
``python -m eegnetreplication_tpu_torch.obs.top``.

The port's copy of ``eegnetreplication_tpu/obs/top.py`` (``eegtpu-top``).
Where ``scripts/obs_report.py`` renders finished runs, this tails every
``events.jsonl`` under the given roots incrementally (``obs/agg.py``) and
redraws one view per refresh: each run's role, status, rps and latency
quantiles over the rolling window, members, breaker and SLO state,
training fold-epochs/s, probes, adaptation.  It reads with byte cursors,
never locks, so it can watch a live supervisor and the train or serve
child it relaunches without disturbing them.

    python -m eegnetreplication_tpu_torch.obs.top reports/obs          # live
    python -m eegnetreplication_tpu_torch.obs.top --json reports/obs   # one snapshot
    python -m eegnetreplication_tpu_torch.obs.top --once reports/obs   # one frame
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

from eegnetreplication_tpu_torch.obs.agg import DEFAULT_WINDOW_S, Aggregator

# Columns: (snapshot key or callable, header).
_CLEAR = "\x1b[2J\x1b[H"


def _short(run_id, width: int = 17) -> str:
    s = str(run_id) if run_id else "?"
    return s if len(s) <= width else s[:width - 1] + "~"


def _cell(value) -> str:
    if value in (None, "", [], {}):
        return "-"
    if isinstance(value, float):
        return f"{value:.3f}".rstrip("0").rstrip(".")
    return str(value)


def _run_row(r: dict) -> list[str]:
    members = r.get("members") or {}
    probes = r.get("probes") or {}
    scale = r.get("scale") or {}
    adapt = r.get("adapt") or {}
    lease = r.get("lease") or {}
    upgrade = r.get("upgrade") or {}
    return [
        _short(r.get("run_id")), r.get("role", "run"),
        r.get("status", "?"),
        _cell(r.get("rps")),
        _cell(r.get("p50_ms")), _cell(r.get("p95_ms")),
        _cell(r.get("window_non_ok")),
        _cell(len(members) or None),
        (f"{scale.get('target')}/{scale.get('actual')}"
         if scale else "-"),
        _cell(r.get("circuit")),
        _cell(",".join(r.get("ejected") or []) or None),
        _cell(",".join(r.get("slo_breached") or []) or None),
        _cell(r.get("fold_epochs_per_s")),
        (f"{probes.get('window')}w/{probes.get('failures')}f"
         if probes else "-"),
        # Closed-loop adaptation: candidates fine-tuned, rolling shadow
        # agreement, and promote/rollback counts (compound like scale).
        _cell(adapt.get("candidates")),
        _cell(adapt.get("shadow_agreement")),
        (f"{adapt.get('promotions')}p/{adapt.get('refusals')}r"
         f"/{adapt.get('rollbacks')}b" if adapt else "-"),
        # Front-tier HA: the fencing-lease holder at its token epoch and
        # its current role letter (act/sby/fen) — the column an operator
        # watches during a failover drill.
        (f"{lease.get('owner')}#{lease.get('token')}"
         f"/{str(lease.get('role') or '?')[:3]}" if lease else "-"),
        (f"{upgrade.get('done')}u/{upgrade.get('rollbacks')}b"
         if upgrade else "-"),
    ]


_HEADERS = ["run", "role", "status", "rps", "p50_ms", "p95_ms", "non_ok",
            "members", "scale", "circuit", "ejected", "slo_breach",
            "fold-ep/s", "probes", "candidates", "shadow_agree",
            "promote/ref/rb", "leader", "upgrade"]


def render(snap: dict) -> str:
    """One frame: a fleet header line plus one row per run."""
    head = (f"eegtpu-top  {time.strftime('%H:%M:%S', time.localtime())}  "
            f"runs={snap['n_runs']}  members={snap['n_members']}  "
            f"rps={snap['rps']}  window={snap['window_s']:g}s")
    if snap.get("slo_breached"):
        head += f"  SLO BREACHED: {','.join(snap['slo_breached'])}"
    if snap.get("dropped_lines"):
        head += f"  dropped_lines={snap['dropped_lines']}"
    rows = [list(_HEADERS)] + [_run_row(r) for r in snap["runs"]]
    widths = [max(len(row[i]) for row in rows)
              for i in range(len(_HEADERS))]
    lines = [head, ""]
    for n, row in enumerate(rows):
        lines.append("  ".join(c.ljust(w) for c, w in zip(row, widths)))
        if n == 0:
            lines.append("  ".join("-" * w for w in widths))
    # Per-member detail under the table (replicas/cells with state).
    members = snap.get("members") or {}
    if members:
        lines.append("")
        for name, info in members.items():
            lines.append(f"  {info.get('kind', 'member')} {name}: "
                         f"{info.get('state', '?')}")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Live fleet observability console over run journals.")
    ap.add_argument("paths", nargs="+",
                    help="metricsDir roots and/or individual run dirs")
    ap.add_argument("--json", action="store_true",
                    help="print ONE aggregated snapshot as JSON and exit "
                         "(machine interface; what the integration tests "
                         "and dashboards consume)")
    ap.add_argument("--once", action="store_true",
                    help="render one frame and exit (no screen clearing)")
    ap.add_argument("--interval", type=float, default=2.0,
                    help="refresh interval in seconds (live mode)")
    ap.add_argument("--window", type=float, default=DEFAULT_WINDOW_S,
                    help="rolling window for rates/quantiles in seconds")
    ap.add_argument("--warmup-polls", type=int, default=2,
                    help="extra polls before a --json/--once snapshot so "
                         "rotation-sealed segments drain")
    args = ap.parse_args(argv)

    missing = [p for p in args.paths if not Path(p).exists()]
    if missing:
        print(f"No such path(s): {missing}", file=sys.stderr)
        return 1

    agg = Aggregator(args.paths, window_s=args.window)
    if args.json or args.once:
        snap = agg.poll()
        for _ in range(max(0, args.warmup_polls)):
            snap = agg.poll()
        if args.json:
            print(json.dumps(snap))
        else:
            print(render(snap))
        return 0

    try:
        while True:
            snap = agg.poll()
            sys.stdout.write(_CLEAR + render(snap) + "\n")
            sys.stdout.flush()
            time.sleep(max(0.1, args.interval))
    except KeyboardInterrupt:
        return 0


if __name__ == "__main__":
    raise SystemExit(main())
