"""Telemetry schemas: what a run journal and its metrics file must hold.

The port's copy of the training, serving, supervision, fleet and
aggregation parts (the serving control plane's events included) of
``eegnetreplication_tpu/obs/schema.py``, so either package's readers
(``scripts/obs_report.py``, ``obs/agg.py``, ``obs/top.py``) read a run of
either package:

- **events.jsonl**, one JSON object per line (:data:`EVENT_REQUIRED` names
  each event's required keys, equal to the JAX table's rows);
- **metrics.json**, the metrics registry's flushed summary
  (:func:`validate_metrics`);
- **BENCH_*.json**, a measurement's envelope (:data:`BENCH_REQUIRED`,
  :func:`validate_bench`), written with :func:`write_json_artifact`, the
  atomic writer ``metrics.json`` goes through too;
- :func:`event_summary`, the JAX package's condensed reading of one
  run's stream (a supervisor's ``supervisor_restarts`` and
  ``supervisor_status`` among its fields), a pure function over event
  dicts that reads a journal written by either package.

Validation is a required-key table plus type checks.  Extra keys are
always allowed; an unknown event type needs only the base keys.
"""

from __future__ import annotations

import json
import numbers
import os
import time
from pathlib import Path
from typing import Any, Iterable

SCHEMA_VERSION = 1

# Keys every journal event carries (stamped by RunJournal.event).
EVENT_BASE_REQUIRED = ("event", "t", "run_id")

# The events' required keys beyond the base: the rows of the JAX
# package's table for the events a training, serving or fleet run of the
# port emits (streaming sessions included).
EVENT_REQUIRED: dict[str, tuple[str, ...]] = {
    "run_start": ("schema_version", "git_sha", "platform", "device_kind",
                  "n_devices", "config"),
    "train_setup": ("protocol", "n_folds", "epochs", "train_pad",
                    "real_train_samples", "padded_train_slots"),
    "fold_group": ("group", "fold_lo", "fold_hi"),
    "epoch": ("epoch", "total_epochs", "train_loss", "val_loss", "val_acc",
              "grad_norm", "n_folds"),
    "device_fault": ("error", "fold_lo", "fold_hi", "retry_fold_batch",
                     "elapsed_s"),
    # One per run-snapshot write: dur_ms the whole write, blocked_ms what
    # the training loop waited for it, overlapped_ms their difference;
    # drain=True marks the join at the writer's close, ok=False a write
    # that did not land.
    "checkpoint_write": ("dur_ms", "async", "overlapped_ms", "blocked_ms",
                         "generation"),
    "fault_injected": ("site", "action", "hit"),
    "retry": ("site", "attempt", "max_attempts", "classification", "error"),
    "checkpoint_quarantine": ("path", "quarantined_to"),
    "run_end": ("status", "wall_s"),
    # Serving: the service's lifecycle, hot swaps, the int8 gate, and the
    # zoo's loads, evictions, restacks and stacked-engine gate.
    "serve_start": ("checkpoint", "buckets", "max_batch", "max_wait_ms"),
    "request": ("n_trials", "latency_ms", "status"),
    "model_swap": ("checkpoint", "digest"),
    "serve_end": ("n_requests", "rejected", "wall_s"),
    "quant_gate": ("precision", "outcome", "agreement", "floor"),
    "model_load": ("model", "digest"),
    "model_evict": ("model", "reason"),
    "zoo_restack": ("n_tenants", "outcome", "reason"),
    "stack_gate": ("precision", "outcome", "agreement", "floor",
                   "n_tenants"),
    # Streaming sessions: one stream's lifecycle, every window decision,
    # the durable snapshot and restore, a window that missed its deadline,
    # and a client's cue label.  serve_end also carries the sessions
    # opened, the windows decided and the snapshots written (``sessions``,
    # ``session_windows``, ``session_snapshots``).
    "session_start": ("session", "hop", "window"),
    "session_window": ("session", "window", "status", "latency_ms"),
    "window_expired": ("session", "window"),
    "session_snapshot": ("path", "n_sessions"),
    "session_resume": ("session", "acked"),
    "session_end": ("session", "windows", "expired"),
    "session_label": ("session", "window", "label"),
    # A failed (or garbled) write of the session snapshot's mirror copy.
    "spool_mirror": ("action",),
    # Online adaptation (adapt/): a fine-tune's start and its stamped
    # candidate, one teed shadow comparison of live and candidate
    # predictions, and every promotion decision (action promote, refused,
    # rollback or error) with the gate's inputs.
    "adaptation_start": ("model", "n_labeled"),
    "adaptation_candidate": ("model", "digest", "steps"),
    "shadow_eval": ("model", "digest", "n_trials", "agree"),
    "promotion": ("model", "action", "digest"),
    # The serving control plane: one captured CUDA graph per bucket
    # (compile_begin, compile, compile_end, as the JAX engine journals its
    # compiled programs), the ladder tuner's retunes, the circuit breaker's
    # transitions, the adaptive admission's limit moves and sheds, trace
    # spans, SLO transitions, profiler windows and worker heartbeats.
    "compile_begin": ("what",),
    "compile_end": ("what", "elapsed_s"),
    "compile": ("what", "cache_hit"),
    "ladder_retune": ("old_buckets", "new_buckets", "reason"),
    "heartbeat": ("phase", "beat"),
    "circuit_state": ("state", "previous", "reason"),
    "admission_change": ("old_limit", "new_limit", "reason"),
    "shed": ("n_shed",),
    "span": ("name", "trace_id", "span_id", "start", "dur_ms"),
    "slo_breach": ("objective", "value", "threshold"),
    "slo_recovered": ("objective", "threshold"),
    "profile_window": ("dur_s", "log_dir", "status"),
    # One canary through the front door (obs/probe.py): status "ok" only
    # for a 200 that matched the pinned answer.
    "probe": ("status", "latency_ms", "url"),
    # Supervision (resil/supervise.py): every launch, exit, hang, kill,
    # relaunch and verdict of the out-of-process supervisor.
    "supervisor_start": ("cmd",),
    "supervisor_launch": ("attempt", "cmd", "resume"),
    "supervisor_exit": ("attempt", "exit_code", "classification"),
    "supervisor_hang": ("attempt", "age_s", "threshold_s", "phase"),
    "supervisor_escalate": ("attempt", "signal"),
    "supervisor_restart": ("attempt", "reason", "delay_s", "resume"),
    "supervisor_giveup": ("restarts", "window_s"),
    "supervisor_end": ("status",),
    # The replica fleet (serve/fleet/): the router's lifecycle, every
    # membership transition, dispatch failover, canary step, shadow
    # compare and rolling reload, and every autoscaler decision (action
    # resync, up, up_failed, down, down_aborted, drained or forced: a
    # down, then drained, then the member's out, in journal order, is
    # the drain-safety proof).
    "fleet_start": ("replicas", "checkpoint"),
    "fleet_member": ("replica", "state", "previous", "reason"),
    "fleet_retry": ("replica", "reason"),
    "fleet_canary": ("phase",),
    "fleet_shadow": ("replica", "reference", "n_trials", "agree"),
    "fleet_reload": ("status", "checkpoint"),
    "fleet_scale": ("action", "target", "n_live", "reason"),
    "fleet_end": ("n_requests", "wall_s"),
    # Multi-cell serving (serve/cells/): the front's lifecycle, every cell
    # membership transition (a cell marked "failed" is journaled before
    # its sessions' failover events), every planned session migration
    # (drain) and every unplanned cross-cell session failover.
    "cell_front_start": ("cells",),
    "cell_member": ("cell", "state", "previous", "reason"),
    "session_migrate": ("session", "from_cell", "to_cell"),
    "session_failover": ("session", "from_cell", "to_cell"),
    "cell_front_end": ("n_requests", "wall_s"),
    # The HA front pair and rolling cell upgrades (serve/cells/ha.py):
    # fencing-lease transitions (acquire, standby, takeover, fenced,
    # release: a takeover is journaled before the first request the new
    # active serves), the standby's WAL replay at promotion, and every
    # rolling-upgrade step (drain, relaunch, live, shadow, undrain,
    # timeout, abort, rollback; strictly serialized per cell).
    "front_lease": ("action", "owner", "token"),
    "affinity_replay": ("n_records", "n_sessions"),
    "cell_upgrade": ("cell", "action"),
    # Gray failures: latency-outlier ejection and half-open re-admission
    # of a degraded replica, and every hedged dispatch.
    "replica_ejected": ("replica", "p95_ms", "fleet_p50_ms"),
    "replica_readmitted": ("replica",),
    "hedge": ("primary", "winner"),
    # Journal aggregation (obs/agg.py): one rolling snapshot over every
    # discovered run journal a poll.
    "agg_snapshot": ("n_runs", "n_members", "window_s"),
}

# metrics.json top-level sections and the keys every series entry needs.
METRIC_SECTIONS = ("counters", "gauges", "histograms")
_HISTOGRAM_KEYS = ("count", "sum", "min", "max", "mean")

# Minimal envelope for measurement artifacts (BENCH_*.json).  Existing
# committed artifacts predate the envelope; the writer stamps it on the
# way out, and the validator is only applied to newly written records.
BENCH_REQUIRED = ("schema_version", "utc", "platform")


class SchemaError(ValueError):
    """An artifact does not satisfy the telemetry schema."""


def _require(record: dict, keys: Iterable[str], what: str) -> None:
    missing = [k for k in keys if k not in record]
    if missing:
        raise SchemaError(f"{what} is missing required keys {missing}: "
                          f"{record!r}")


def validate_event(event: dict) -> dict:
    """Validate one journal event; returns it unchanged on success.  An
    event the emitter already flagged (``_schema_error``) passes, so a
    reader of an otherwise healthy stream is not raised at."""
    if not isinstance(event, dict):
        raise SchemaError(f"event must be a dict, got {type(event).__name__}")
    _require(event, EVENT_BASE_REQUIRED, "event")
    kind = event["event"]
    if not isinstance(kind, str):
        raise SchemaError(f"event name must be a str, got {kind!r}")
    if not isinstance(event["t"], numbers.Real):
        raise SchemaError(f"event timestamp must be numeric: {event['t']!r}")
    if "_schema_error" in event:
        return event
    _require(event, EVENT_REQUIRED.get(kind, ()), f"{kind!r} event")
    return event


def validate_events(events: list[dict], *, complete: bool = True
                    ) -> list[dict]:
    """Validate a run's event stream; ``complete=True`` also requires it to
    open with ``run_start``, close with ``run_end`` and hold one run id."""
    for ev in events:
        validate_event(ev)
    if complete:
        if not events:
            raise SchemaError("event stream is empty")
        if events[0]["event"] != "run_start":
            raise SchemaError(
                f"first event must be run_start, got {events[0]['event']!r}")
        if events[-1]["event"] != "run_end":
            raise SchemaError(
                f"last event must be run_end, got {events[-1]['event']!r}")
        run_ids = {ev["run_id"] for ev in events}
        if len(run_ids) != 1:
            raise SchemaError(f"mixed run_ids in one stream: {run_ids}")
    return events


def rotated_segments(path: str | Path) -> list[Path]:
    """Rotated siblings of an ``events.jsonl`` (``events.jsonl.N``),
    oldest first (highest N)."""
    path = Path(path)
    numbered = []
    for sib in path.parent.glob(path.name + ".*"):
        suffix = sib.name[len(path.name) + 1:]
        if suffix.isdigit():
            numbered.append((int(suffix), sib))
    return [p for _, p in sorted(numbered, reverse=True)]


def _read_jsonl(path: Path, *, lenient_tail: bool) -> list[dict]:
    with open(path) as fh:
        lines = [(n, ln.strip()) for n, ln in enumerate(fh, 1) if ln.strip()]
    events = []
    for i, (lineno, line) in enumerate(lines):
        try:
            events.append(json.loads(line))
        except json.JSONDecodeError as exc:
            if lenient_tail and i == len(lines) - 1:
                break  # the line a killed run was writing
            raise SchemaError(
                f"{path}:{lineno} is not valid JSON: {exc}") from exc
    return events


def read_events(path: str | Path, *, complete: bool = True,
                lenient_tail: bool = False) -> list[dict]:
    """Load and validate an ``events.jsonl`` stream, its rotated segments
    first.  ``lenient_tail=True`` skips an unparseable last line of the live
    file (what a killed run leaves); garbage anywhere else raises."""
    path = Path(path)
    segments = rotated_segments(path)
    events: list[dict] = []
    for seg in segments:
        events.extend(_read_jsonl(seg, lenient_tail=False))
    if path.exists() or not segments:
        events.extend(_read_jsonl(path, lenient_tail=lenient_tail))
    return validate_events(events, complete=complete)


def validate_metrics(record: dict) -> dict:
    """Validate a flushed metrics.json record; returns it on success."""
    if not isinstance(record, dict):
        raise SchemaError("metrics record must be a dict")
    _require(record, ("schema_version", "run_id", "utc") + METRIC_SECTIONS,
             "metrics record")
    for section in METRIC_SECTIONS:
        series_map = record[section]
        if not isinstance(series_map, dict):
            raise SchemaError(f"metrics section {section!r} must be a dict")
        for name, series in series_map.items():
            if not isinstance(series, list):
                raise SchemaError(
                    f"metric {name!r} must be a list of labeled series")
            for entry in series:
                _require(entry, ("labels",), f"metric {name!r} series")
                if not isinstance(entry["labels"], dict):
                    raise SchemaError(f"metric {name!r} labels must be a dict")
                if section == "histograms":
                    _require(entry, _HISTOGRAM_KEYS,
                             f"histogram {name!r} series")
                else:
                    _require(entry, ("value",), f"metric {name!r} series")
                    if not isinstance(entry["value"], numbers.Real):
                        raise SchemaError(
                            f"metric {name!r} value must be numeric: "
                            f"{entry['value']!r}")
    return record


def read_metrics(path: str | Path) -> dict:
    """Load and validate a ``metrics.json`` file."""
    with open(path) as fh:
        return validate_metrics(json.load(fh))


def validate_bench(record: dict) -> dict:
    """Validate a measurement artifact's envelope; returns it on success."""
    if not isinstance(record, dict):
        raise SchemaError("bench record must be a dict")
    _require(record, BENCH_REQUIRED, "bench record")
    return record


def utc_now() -> str:
    return time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime())


def write_json_artifact(path: str | Path, record: dict,
                        kind: str = "bench", indent: int | None = None) -> Path:
    """Validate and atomically write a measurement artifact.

    Stamps ``schema_version`` and ``utc`` when the caller did not, then
    validates per ``kind`` (``"bench"`` or ``"metrics"``) and writes via a
    same-directory temp file + rename so a crash mid-write can never leave
    a truncated artifact where a valid one stood.
    """
    record = dict(record)
    record.setdefault("schema_version", SCHEMA_VERSION)
    record.setdefault("utc", utc_now())
    if kind == "metrics":
        validate_metrics(record)
    elif kind == "bench":
        validate_bench(record)
    else:
        raise ValueError(f"unknown artifact kind {kind!r}")
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
    tmp.write_text(json.dumps(record, indent=indent))
    tmp.replace(path)
    return path


def event_summary(events: list[dict]) -> dict[str, Any]:
    """Condense one run's event stream into the fields the report table
    shows (also used by tests as the canonical reading of a stream)."""
    # A stream with no run_end is either still live or died without its
    # terminal event (crash, SIGKILL) — indistinguishable from the stream
    # alone, so the label stays the honest "incomplete" and the reader is
    # never raised at (same contract as ``read_events(lenient_tail=True)``).
    # A run that closed with ``status="preempted"`` (or any terminal
    # status) overwrites this from its run_end below.
    out: dict[str, Any] = {"run_id": events[0]["run_id"] if events else None,
                           "status": "incomplete" if events else "empty",
                           "n_events": len(events)}
    epochs = [e for e in events if e["event"] == "epoch"]
    faults = [e for e in events if e["event"] == "device_fault"]
    compiles = [e for e in events if e["event"] == "compile_end"]
    injected = [e for e in events if e["event"] == "fault_injected"]
    retries = [e for e in events if e["event"] == "retry"]
    for ev in events:
        kind = ev["event"]
        if kind == "run_start":
            out.update(platform=ev.get("platform"),
                       device_kind=ev.get("device_kind"),
                       git_sha=ev.get("git_sha"),
                       started_utc=ev.get("utc"))
        elif kind == "train_setup":
            out.update(protocol=ev.get("protocol"), n_folds=ev.get("n_folds"),
                       epochs=ev.get("epochs"))
        elif kind == "run_end":
            out.update(status=ev.get("status"), wall_s=ev.get("wall_s"))
            if ev.get("error"):
                out["error_message"] = ev["error"]
    requests = [e for e in events if e["event"] == "request"]
    swaps = [e for e in events if e["event"] == "model_swap"]
    out["n_epoch_events"] = len(epochs)
    out["device_fault_retries"] = len(faults)
    if requests or swaps or any(e["event"] == "serve_start" for e in events):
        # Serving run: request count, tail latency, rejected/error split.
        # p95 here is the EXACT order statistic from the per-request
        # journal events — the post-hoc cross-check of the live bucketed
        # registry estimate (MetricsRegistry.quantile), which /healthz
        # and the SLO monitor read in real time.
        out["n_requests"] = len(requests)
        out["rejected"] = sum(1 for e in requests
                              if e.get("status") == "rejected")
        # Deadline drops and open-circuit refusals are their own buckets:
        # they are load-shedding decisions, not inference errors.
        out["expired"] = sum(1 for e in requests
                             if e.get("status") == "expired")
        out["circuit_refusals"] = sum(1 for e in requests
                                      if e.get("status") == "circuit_open")
        # Adaptive-admission sheds are load-shedding decisions too (a
        # 429 by policy while the hard queue still had room), not errors.
        out["shed"] = sum(1 for e in requests
                          if e.get("status") == "shed")
        out["request_errors"] = sum(
            1 for e in requests
            if e.get("status") not in ("ok", "rejected", "expired",
                                       "circuit_open", "shed"))
        out["model_swaps"] = len(swaps)
        lat = [e["latency_ms"] for e in requests
               if e.get("status") == "ok"
               and isinstance(e.get("latency_ms"), numbers.Real)]
        if lat:
            # The shared obs percentile (linear interpolation) — the same
            # estimator the bench scripts report, so a run's journal row
            # and its BENCH artifact cannot disagree on the same sample.
            from eegnetreplication_tpu_torch.obs.stats import percentile

            out["latency_p50_ms"] = round(percentile(lat, 0.50), 3)
            out["latency_p95_ms"] = round(percentile(lat, 0.95), 3)
        retunes = [e for e in events if e["event"] == "ladder_retune"]
        if retunes:
            out["ladder_retunes"] = len(retunes)
        serve_starts = [e for e in events if e["event"] == "serve_start"]
        if serve_starts and serve_starts[-1].get("precision"):
            out["precision"] = serve_starts[-1]["precision"]
    # Quantization gate: the last verdict is the one that decided what
    # serves (reported for any stream that ran the gate — server, CLI,
    # or bench).
    gates = [e for e in events if e["event"] == "quant_gate"]
    if gates:
        out["quant_gate"] = gates[-1].get("outcome")
        out["quant_agreement"] = gates[-1].get("agreement")
    # Multi-tenant zoo: tenant count (from the serve_start advert, else
    # the distinct models loaded), load/evict churn, restack outcomes,
    # and the last stacked-gate verdict — only reported for zoo streams
    # so single-model rows stay compact.
    loads = [e for e in events if e["event"] == "model_load"]
    evicts = [e for e in events if e["event"] == "model_evict"]
    restacks = [e for e in events if e["event"] == "zoo_restack"]
    serve_tenants = [e.get("tenants") for e in events
                     if e["event"] == "serve_start"
                     and isinstance(e.get("tenants"), list)]
    if loads or evicts or restacks or serve_tenants:
        if serve_tenants:
            out["tenants"] = len(serve_tenants[-1])
        elif restacks and isinstance(restacks[-1].get("n_tenants"), int):
            out["tenants"] = restacks[-1]["n_tenants"]
        else:
            out["tenants"] = len({e["model"] for e in loads})
        out["model_loads"] = len(loads)
        out["model_evictions"] = len(evicts)
        if restacks:
            out["zoo_restacks"] = len(restacks)
            out["zoo_restack_outcome"] = restacks[-1].get("outcome")
    stack_gates = [e for e in events if e["event"] == "stack_gate"]
    if stack_gates:
        out["stack_gate"] = stack_gates[-1].get("outcome")
        out["stack_agreement"] = stack_gates[-1].get("agreement")
    # Streaming sessions: stream counts, per-window tail latency,
    # deadline misses, and snapshot/resume activity — only reported for
    # streams that actually served sessions.
    session_starts = [e for e in events if e["event"] == "session_start"]
    session_resumes = [e for e in events if e["event"] == "session_resume"]
    windows = [e for e in events if e["event"] == "session_window"]
    if session_starts or session_resumes or windows:
        out["n_sessions"] = len({e["session"] for e in
                                 session_starts + session_resumes})
        out["session_windows"] = len(windows)
        out["windows_expired"] = sum(
            1 for e in windows if e.get("status") == "expired")
        out["session_resumes"] = len(session_resumes)
        out["session_snapshots"] = sum(
            1 for e in events if e["event"] == "session_snapshot")
        wlat = [e["latency_ms"] for e in windows
                if e.get("status") == "ok"
                and isinstance(e.get("latency_ms"), numbers.Real)]
        if wlat:
            from eegnetreplication_tpu_torch.obs.stats import percentile

            out["window_p50_ms"] = round(percentile(wlat, 0.50), 3)
            out["window_p95_ms"] = round(percentile(wlat, 0.95), 3)
    # Closed-loop online adaptation: labels received, fine-tune activity
    # (adaptation_start begins a fine-tune, adaptation_candidate lands
    # its stamped checkpoint), the rolling shadow agreement between live
    # and candidate predictions over every teed comparison, and the
    # promotion gate's decision counts — only reported for streams the
    # adaptation loop actually touched, so other rows stay compact.
    labels = [e for e in events if e["event"] == "session_label"]
    adapt_starts = [e for e in events if e["event"] == "adaptation_start"]
    candidates = [e for e in events
                  if e["event"] == "adaptation_candidate"]
    shadow_evals = [e for e in events if e["event"] == "shadow_eval"]
    promotions = [e for e in events if e["event"] == "promotion"]
    if labels or adapt_starts or candidates or shadow_evals or promotions:
        out["session_labels"] = len(labels)
        out["adapt_runs"] = len(adapt_starts)
        out["adapt_candidates"] = len(candidates)
        out["shadow_evals"] = len(shadow_evals)
        agree = [e["agree"] for e in shadow_evals
                 if isinstance(e.get("agree"), numbers.Real)]
        if agree:
            # Per-window weighting: each shadow_eval covers n_trials
            # comparisons, so weight by it where present.
            weights = [e["n_trials"] if isinstance(e.get("n_trials"),
                                                   numbers.Real) else 1
                       for e in shadow_evals
                       if isinstance(e.get("agree"), numbers.Real)]
            total = sum(weights) or 1
            out["shadow_agreement"] = round(
                sum(a * w for a, w in zip(agree, weights)) / total, 4)
        out["promotions"] = sum(1 for e in promotions
                                if e.get("action") == "promote")
        out["promotion_refusals"] = sum(1 for e in promotions
                                        if e.get("action") == "refused")
        out["rollbacks"] = sum(1 for e in promotions
                               if e.get("action") == "rollback")
    # Tracing: how many sampled (or anomaly-flushed) traces this stream
    # holds — the obs_report "traces" column; stitch with trace_report.
    spans = [e for e in events if e["event"] == "span"]
    if spans:
        out["trace_spans"] = len(spans)
        out["traces"] = len({e["trace_id"] for e in spans})
    # SLO monitoring: breach count + the worst breach (largest relative
    # exceedance), and whether every breached objective later recovered.
    breaches = [e for e in events if e["event"] == "slo_breach"]
    if breaches or any(e["event"] == "slo_recovered" for e in events):
        out["slo_breaches"] = len(breaches)

        def exceedance(ev) -> float:
            value, threshold = ev.get("value"), ev.get("threshold")
            if not isinstance(value, numbers.Real) \
                    or not isinstance(threshold, numbers.Real):
                return 0.0
            if ev.get("metric", "").startswith("avail") \
                    or ">" in str(ev.get("objective", "")):
                return threshold / max(abs(value), 1e-12)
            return value / max(abs(threshold), 1e-12)

        if breaches:
            worst = max(breaches, key=exceedance)
            out["worst_slo"] = worst.get("objective")
        last_state: dict[str, str] = {}
        for ev in events:
            if ev["event"] in ("slo_breach", "slo_recovered"):
                last_state[ev.get("objective", "?")] = ev["event"]
        still = sorted(o for o, s in last_state.items()
                       if s == "slo_breach")
        out["slo_breached_now"] = still
    # Snapshot persistence: total write time vs the part the step loop
    # actually stalled on — ckpt_blocked_ms ~0 with overlapped (async)
    # writes is the journal-derived proof the checkpoint cost left the
    # critical path; only reported when the run wrote snapshots.
    # A quarantined snapshot generation is a loud signal (torn write →
    # fallback to the previous generation) an operator must see in the
    # report table, not only by grepping the journal.
    quarantines = [e for e in events
                   if e["event"] == "checkpoint_quarantine"]
    if quarantines:
        out["checkpoint_quarantines"] = len(quarantines)
    ckpt_writes = [e for e in events if e["event"] == "checkpoint_write"]
    if ckpt_writes:
        # ok=False writes never landed (the run saw the error at the next
        # submit/close) — they must not count as durable snapshots.  Their
        # wall/stall time WAS spent though, so the time sums cover every
        # write: the run where a write failed is exactly the one whose
        # checkpoint cost an operator is trying to see.
        landed = [e for e in ckpt_writes if e.get("ok", True)]
        out["checkpoint_writes"] = len(landed)
        if len(landed) < len(ckpt_writes):
            out["ckpt_failed"] = len(ckpt_writes) - len(landed)
        out["ckpt_ms"] = round(sum(
            e["dur_ms"] for e in ckpt_writes
            if isinstance(e.get("dur_ms"), numbers.Real)), 3)
        out["ckpt_blocked_ms"] = round(sum(
            e["blocked_ms"] for e in ckpt_writes
            if isinstance(e.get("blocked_ms"), numbers.Real)
            and not e.get("drain")), 3)
        out["ckpt_async"] = all(e.get("async") for e in ckpt_writes)
    if injected:
        out["faults_injected"] = len(injected)
    if retries:
        out["retries"] = len(retries)
    # Supervision and liveness: restarts/hangs from a supervisor
    # stream, breaker trips from a serving stream — only reported when
    # present so training rows stay compact.
    restarts = [e for e in events if e["event"] == "supervisor_restart"]
    hangs = [e for e in events if e["event"] == "supervisor_hang"]
    trips = [e for e in events if e["event"] == "circuit_state"
             and e.get("state") == "open"]
    if any(e["event"] == "supervisor_start" for e in events) or restarts \
            or hangs:
        out["supervisor_restarts"] = len(restarts)
        out["hang_detections"] = len(hangs)
        giveup = [e for e in events if e["event"] == "supervisor_giveup"]
        ends = [e for e in events if e["event"] == "supervisor_end"]
        if ends:
            out["supervisor_status"] = ends[-1].get("status")
        if giveup:
            out["supervisor_status"] = "crash_loop"
    if trips:
        out["breaker_trips"] = len(trips)
    # Fleet serving: membership churn, dispatch failovers, and the rolling
    # canary's outcome — only reported for fleet streams so single-process
    # serving rows stay compact.
    fleet_starts = [e for e in events if e["event"] == "fleet_start"]
    if fleet_starts or any(e["event"] in ("fleet_member", "fleet_reload")
                           for e in events):
        if fleet_starts:
            # Validation pins key presence, not types: guard like the
            # zoo section's isinstance(e.get("tenants"), list) does.
            replicas = fleet_starts[-1].get("replicas")
            if isinstance(replicas, (list, tuple)):
                out["fleet_replicas"] = len(replicas)
        members = [e for e in events if e["event"] == "fleet_member"]
        out["fleet_member_transitions"] = len(members)
        out["fleet_rejoins"] = sum(1 for e in members
                                   if e.get("reason") == "rejoined")
        out["fleet_failovers"] = sum(1 for e in events
                                     if e["event"] == "fleet_retry")
        reloads = [e for e in events if e["event"] == "fleet_reload"]
        if reloads:
            out["fleet_reloads"] = len(reloads)
            out["fleet_reload_status"] = reloads[-1].get("status")
        shadows = [e for e in events if e["event"] == "fleet_shadow"]
        if shadows:
            agree = [e["agree"] for e in shadows
                     if isinstance(e.get("agree"), numbers.Real)]
            if agree:
                out["fleet_shadow_agree"] = round(
                    sum(agree) / len(agree), 4)
    # Elastic fleet: autoscaler decision counts — up/down are decisions
    # (a failed spawn still counted as an "up" decision journals its own
    # up_failed row), forced_retires is the drain-safety escape hatch
    # firing (0 on a healthy run).
    scales = [e for e in events if e["event"] == "fleet_scale"]
    if scales:
        out["scale_ups"] = sum(1 for e in scales
                               if e.get("action") == "up")
        out["scale_downs"] = sum(1 for e in scales
                                 if e.get("action") == "down")
        out["forced_retires"] = sum(1 for e in scales
                                    if e.get("action") == "forced")
    # Multi-cell serving: cell count, membership churn, and session
    # portability activity (planned migrations vs unplanned failovers) —
    # only reported for cell-front streams so other rows stay compact.
    front_starts = [e for e in events if e["event"] == "cell_front_start"]
    cell_members = [e for e in events if e["event"] == "cell_member"]
    migrations = [e for e in events if e["event"] == "session_migrate"]
    cell_failovers = [e for e in events
                      if e["event"] == "session_failover"]
    if front_starts or cell_members or migrations or cell_failovers:
        if front_starts:
            cells = front_starts[-1].get("cells")
            if isinstance(cells, (list, tuple)):
                out["cells"] = len(cells)
        out["cell_member_transitions"] = len(cell_members)
        out["cells_failed"] = sum(1 for e in cell_members
                                  if e.get("state") == "failed")
        out["session_migrations"] = len(migrations)
        out["session_failovers"] = len(cell_failovers)
        out["spool_errors"] = sum(1 for e in cell_failovers
                                  if e.get("action") == "spool_error")
    # Front-tier HA + rolling upgrades: lease role churn (takeovers and
    # self-fencings), WAL replays at promotion, per-cell upgrade
    # completions vs rollbacks, and mirror-spool fallback activity —
    # only reported for HA/upgrade-active streams.
    leases = [e for e in events if e["event"] == "front_lease"]
    replays = [e for e in events if e["event"] == "affinity_replay"]
    upgrades = [e for e in events if e["event"] == "cell_upgrade"]
    mirrors = [e for e in events if e["event"] == "spool_mirror"]
    if leases or replays or upgrades or mirrors:
        out["lease_takeovers"] = sum(1 for e in leases
                                     if e.get("action") == "takeover")
        out["front_fenced"] = sum(1 for e in leases
                                  if e.get("action") == "fenced")
        out["affinity_replays"] = len(replays)
        out["cells_upgraded"] = sum(1 for e in upgrades
                                    if e.get("action") == "undrain")
        out["upgrade_rollbacks"] = sum(1 for e in upgrades
                                       if e.get("action") == "rollback")
        out["mirror_restores"] = sum(1 for e in mirrors
                                     if e.get("action") == "restored")
    # Gray-failure defenses: outlier ejections/readmissions, hedged
    # dispatches (and how many the hedge won), and AIMD admission moves —
    # only reported when the machinery actually acted, so other rows stay
    # compact.
    ejections = [e for e in events if e["event"] == "replica_ejected"]
    readmissions = [e for e in events
                    if e["event"] == "replica_readmitted"]
    if ejections or readmissions:
        out["replica_ejections"] = len(ejections)
        out["replica_readmissions"] = len(readmissions)
    hedge_events = [e for e in events if e["event"] == "hedge"]
    if hedge_events:
        out["hedges_fired"] = len(hedge_events)
        out["hedges_won"] = sum(1 for e in hedge_events
                                if e.get("winner") == "hedge")
    admission_moves = [e for e in events
                       if e["event"] == "admission_change"]
    shed_events = [e for e in events if e["event"] == "shed"]
    if admission_moves or shed_events:
        out["admission_changes"] = len(admission_moves)
        # The throttled shed records carry deltas; their sum is the
        # journal's count of refused-by-policy requests (the request
        # events' status="shed" tally above is the per-request view).
        out.setdefault("shed", 0)
        out["shed_journaled"] = sum(e.get("n_shed", 0)
                                    for e in shed_events)
    # Black-box probing (obs/probe.py): canary outcomes + the outside-in
    # tail — only reported for streams a prober journaled into, so
    # unprobed rows stay compact.  probe_failures counts every non-"ok"
    # status (mismatch / http_* / timeout / error alike): from the
    # user's vantage they are all unavailability.
    probes = [e for e in events if e["event"] == "probe"]
    if probes:
        out["probes"] = len(probes)
        out["probe_failures"] = sum(1 for e in probes
                                    if e.get("status") != "ok")
        plat = [e["latency_ms"] for e in probes
                if e.get("status") == "ok"
                and isinstance(e.get("latency_ms"), numbers.Real)]
        if plat:
            from eegnetreplication_tpu_torch.obs.stats import percentile

            out["probe_p95_ms"] = round(percentile(plat, 0.95), 3)
    # On-demand profiling (POST /profile): how many bounded trace windows
    # ran and whether the last one landed its artifacts.
    profile_windows = [e for e in events if e["event"] == "profile_window"]
    if profile_windows:
        out["profile_windows"] = len(profile_windows)
        out["profile_status"] = profile_windows[-1].get("status")
    # Fleet aggregation (obs/agg.py): snapshot cadence + the last
    # snapshot's fleet size, so an aggregator's own run renders usefully.
    agg_snapshots = [e for e in events if e["event"] == "agg_snapshot"]
    if agg_snapshots:
        out["agg_snapshots"] = len(agg_snapshots)
        out["agg_runs"] = agg_snapshots[-1].get("n_runs")
        out["agg_members"] = agg_snapshots[-1].get("n_members")
    cache_events = [e for e in events if e["event"] == "compile"
                    and e.get("cache_hit") is not None]
    if cache_events:
        out["compile_cache_hits"] = sum(1 for e in cache_events
                                        if e["cache_hit"])
        out["compile_cache_misses"] = sum(1 for e in cache_events
                                          if not e["cache_hit"])
    out["compile_s"] = round(sum(e.get("elapsed_s", 0.0) for e in compiles), 2)
    if epochs:
        last = epochs[-1]
        out.update(last_epoch=last.get("epoch"),
                   last_train_loss=last.get("train_loss"),
                   last_val_loss=last.get("val_loss"),
                   last_val_acc=last.get("val_acc"),
                   last_grad_norm=last.get("grad_norm"))
    return out
