"""Summarize finished run journals:
``python -m eegnetreplication_tpu_torch.obs.report``.

The port's copy of ``scripts/obs_report.py``.  Each run directory
(``<metricsDir>/<run_id>/``) holds the journal's ``events.jsonl`` and the
registry's ``metrics.json``; both are validated against
:mod:`~eegnetreplication_tpu_torch.obs.schema` and each run becomes one
row: protocol, device, epochs and folds, wall, throughput, fault retries,
final losses, and the serving, fleet and cell columns.  Runs are found by
:func:`~eegnetreplication_tpu_torch.obs.agg.discover_runs`, so the member
journals a fleet or a cells run nests at any depth get a row each.

    python -m eegnetreplication_tpu_torch.obs.report reports/obs              # a metricsDir root
    python -m eegnetreplication_tpu_torch.obs.report /tmp/obs/<run_id> ...    # run dirs
    python -m eegnetreplication_tpu_torch.obs.report --json reports/obs       # one JSON line a run

Exit code 0, or 1 when no run is found, or 2 when a run is unreadable or
holds events that fail validation.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from eegnetreplication_tpu_torch.obs import schema
from eegnetreplication_tpu_torch.obs.agg import discover_runs


def summarize_run(run_dir: Path) -> dict:
    """Validated summary of one run directory (schema errors are reported
    as a row, not a crash — a corrupt run must not hide the healthy ones)."""
    out = {"dir": str(run_dir)}
    try:
        # complete=False: a live, crashed, or preempted run is still worth
        # a row (event_summary reports a missing run_end as "incomplete" —
        # live and crashed are indistinguishable from the stream alone);
        # lenient_tail: a run killed mid-write leaves one truncated final
        # line, which must not make the whole stream unreadable.
        events = schema.read_events(run_dir / "events.jsonl", complete=False,
                                    lenient_tail=True)
        out.update(schema.event_summary(events))
        drift = [e for e in events if "_schema_error" in e]
        if drift:
            out["schema_drift"] = f"{len(drift)} event(s) failed validation"
    except (OSError, schema.SchemaError) as exc:
        out["error"] = f"{type(exc).__name__}: {exc}"[:200]
        return out
    metrics_path = run_dir / "metrics.json"
    if metrics_path.exists():
        try:
            m = schema.read_metrics(metrics_path)

            def first_value(section: str, name: str):
                series = m[section].get(name) or []
                return series[0]["value"] if series else None

            out["fold_epochs_total"] = first_value("counters",
                                                   "fold_epochs_total")
            out["fault_retry_wall_s"] = first_value("counters",
                                                    "fault_retry_wall_s")
            out["epoch_throughput"] = first_value("gauges",
                                                  "epoch_throughput")
        except schema.SchemaError as exc:
            out["metrics_error"] = str(exc)[:200]
    return out


_COLUMNS = (
    ("run_id", "run"), ("status", "status"), ("protocol", "protocol"),
    ("platform", "platform"), ("device_kind", "device"),
    ("n_folds", "folds"), ("epochs", "epochs"),
    ("wall_s", "wall_s"), ("epoch_throughput", "fold-ep/s"),
    ("device_fault_retries", "faults"),
    ("faults_injected", "injected"), ("retries", "retries"),
    ("last_train_loss", "train_loss"), ("last_val_acc", "val_acc%"),
    ("last_grad_norm", "grad_norm"),
    # Snapshot persistence: total write wall vs the step loop's actual
    # stall (ckpt_stall_ms ~0 = the writes overlapped training; equal to
    # ckpt_ms = every write blocked, the pre-async behaviour).
    ("ckpt_ms", "ckpt_ms"), ("ckpt_blocked_ms", "ckpt_stall_ms"),
    # Quarantined snapshot generations (torn write -> fallback): the
    # data-loss-adjacent signal an operator must see without grepping.
    ("checkpoint_quarantines", "quarantines"),
    # Serving runs (serve_start/request/model_swap/serve_end streams);
    # training rows show "-" here and vice versa.
    ("n_requests", "reqs"), ("latency_p95_ms", "p95_ms"),
    ("rejected", "rejected"), ("model_swaps", "swaps"),
    # Quantized + self-tuning hot path: the serving precision (after any
    # quant-gate fallback), the gate's argmax agreement, and how many
    # times the LadderTuner swapped the compile ladder under load.
    ("precision", "prec"), ("quant_agreement", "quant_agree"),
    ("ladder_retunes", "retunes"),
    # Multi-tenant zoo: how many models this serving run addressed
    # (single-model rows show "-") and its restack count under reloads.
    ("tenants", "tenants"), ("zoo_restacks", "restacks"),
    # Supervision & liveness: supervisor restarts/hang detections (from
    # supervisor_* events), expired-deadline drops and circuit-breaker
    # trips (from request/circuit_state events).
    ("supervisor_restarts", "restarts"), ("hang_detections", "hangs"),
    ("expired", "expired"), ("breaker_trips", "trips"),
    # Streaming sessions (session_* events): stream count, per-window
    # tail latency, and mid-stream resumes after supervised restarts.
    ("n_sessions", "sessions"), ("window_p95_ms", "p95_window_ms"),
    ("session_resumes", "resumes"),
    # Fleet runs (fleet_* events): replica count, dispatch failovers off
    # dead/failing replicas, and the last rolling reload's outcome.
    ("fleet_replicas", "fleet"), ("fleet_failovers", "failovers"),
    ("fleet_reload_status", "fleet_reload"),
    ("scale_ups", "scale_ups"), ("scale_downs", "scale_downs"),
    ("forced_retires", "forced_retires"),
    # Multi-cell serving (cell_front_*/cell_member/session_migrate/
    # session_failover events): cell count, planned migrations, and
    # unplanned cross-cell session failovers.
    ("cells", "cells"), ("session_migrations", "migrations"),
    ("session_failovers", "cell_failovers"),
    # Gray-failure defenses: latency-outlier ejections,
    # hedged dispatches fired/won, and requests shed by adaptive
    # admission — the columns a gray drill run renders under.
    ("replica_ejections", "ejects"), ("hedges_fired", "hedges"),
    ("hedges_won", "hedge_wins"), ("shed", "shed"),
    # Tracing + SLOs: how many sampled/anomaly-flushed traces the stream
    # holds (stitch them with obs/trace_report.py) and the worst SLO
    # breach the run journaled (blank when every objective held).
    ("traces", "traces"), ("worst_slo", "slo"),
    # Closed-loop adaptation (adaptation_*/shadow_eval/promotion events):
    # candidates fine-tuned, shadow argmax agreement with the live model,
    # and the gate's promote/rollback counts.  Non-adaptation rows show
    # "-" across all four.
    ("adapt_candidates", "candidates"),
    ("shadow_agreement", "shadow_agree"),
    ("promotions", "promotions"), ("rollbacks", "rollbacks"),
    # Front-tier HA + rolling upgrades (front_lease/affinity_replay/
    # cell_upgrade/spool_mirror events): lease takeovers and
    # self-fencings, exact-table WAL replays at promotion, per-cell
    # upgrade completions vs rollbacks, and mirror-spool fallback
    # restores (plus journaled primary spool-read errors).
    ("lease_takeovers", "takeovers"), ("front_fenced", "fenced"),
    ("affinity_replays", "replays"),
    ("cells_upgraded", "upgraded"), ("upgrade_rollbacks", "upg_rb"),
    ("mirror_restores", "mirror"), ("spool_errors", "spool_err"),
)


def _cell(value) -> str:
    if value is None:
        return "-"
    if isinstance(value, float):
        return f"{value:.3f}".rstrip("0").rstrip(".")
    return str(value)


def render_table(summaries: list[dict]) -> str:
    rows = [[label for _, label in _COLUMNS]]
    for s in summaries:
        if s.get("error"):
            rows.append([s.get("dir", "?"), "INVALID: " + s["error"]]
                        + ["-"] * (len(_COLUMNS) - 2))
        else:
            rows.append([_cell(s.get(key)) for key, _ in _COLUMNS])
    widths = [max(len(r[i]) for r in rows) for i in range(len(_COLUMNS))]
    lines = []
    for n, row in enumerate(rows):
        lines.append("  ".join(c.ljust(w) for c, w in zip(row, widths)))
        if n == 0:
            lines.append("  ".join("-" * w for w in widths))
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Summarize telemetry run directories.")
    ap.add_argument("paths", nargs="+",
                    help="metricsDir roots and/or individual run dirs")
    ap.add_argument("--json", action="store_true",
                    help="emit one JSON object per run instead of a table")
    args = ap.parse_args(argv)

    runs = discover_runs(args.paths)
    if not runs:
        print(f"No run directories (events.jsonl) under {args.paths}",
              file=sys.stderr)
        return 1
    summaries = [summarize_run(r) for r in runs]
    if args.json:
        for s in summaries:
            print(json.dumps(s))
    else:
        print(render_table(summaries))
    bad = [s for s in summaries if s.get("error") or s.get("schema_drift")]
    return 2 if bad else 0


if __name__ == "__main__":
    raise SystemExit(main())
