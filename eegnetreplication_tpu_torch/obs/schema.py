"""Telemetry schemas: what a run journal and its metrics file must hold.

The port's copy of the training and serving parts (the serving control
plane's events included) of
``eegnetreplication_tpu/obs/schema.py``, so the JAX package's readers
(``scripts/obs_report.py``, ``obs/agg.py``, the supervisor) read a
training or serving run of either package:

- **events.jsonl**, one JSON object per line (:data:`EVENT_REQUIRED` names
  each event's required keys, equal to the JAX table's rows);
- **metrics.json**, the metrics registry's flushed summary
  (:func:`validate_metrics`).

Validation is a required-key table plus type checks.  Extra keys are
always allowed; an unknown event type needs only the base keys.
"""

from __future__ import annotations

import json
import numbers
import time
from pathlib import Path
from typing import Iterable

SCHEMA_VERSION = 1

# Keys every journal event carries (stamped by RunJournal.event).
EVENT_BASE_REQUIRED = ("event", "t", "run_id")

# The events' required keys beyond the base: the rows of the JAX
# package's table for the events a training or serving run of the port
# emits (streaming sessions included).
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
}

# metrics.json top-level sections and the keys every series entry needs.
METRIC_SECTIONS = ("counters", "gauges", "histograms")
_HISTOGRAM_KEYS = ("count", "sum", "min", "max", "mean")


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


def utc_now() -> str:
    return time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime())
