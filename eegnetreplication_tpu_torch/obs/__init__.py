"""Structured telemetry: journal, metrics, schema, traces, SLOs.

The port's counterpart of ``eegnetreplication_tpu/obs``, for the training
and serving paths:

- :mod:`~eegnetreplication_tpu_torch.obs.journal`, run-scoped JSONL event
  streams (``events.jsonl``) with a context-local active journal;
- :mod:`~eegnetreplication_tpu_torch.obs.metrics`, counters, gauges and
  histograms flushed to ``metrics.json``, with an optional TensorBoard
  scalar mirror;
- :mod:`~eegnetreplication_tpu_torch.obs.schema`, the required keys of the
  training and serving events, the validation the JAX package's readers
  apply, and the atomic artifact writer (``BENCH_*.json`` and
  ``metrics.json``);
- :mod:`~eegnetreplication_tpu_torch.obs.trace`, request-scoped trace
  spans and the reader that stitches a fleet's journals into trees;
- :mod:`~eegnetreplication_tpu_torch.obs.slo`, sliding-window SLO
  verdicts over the live registry;
- :mod:`~eegnetreplication_tpu_torch.obs.stats`, the shared percentile;
- :mod:`~eegnetreplication_tpu_torch.obs.probe`, the black-box prober;
- :mod:`~eegnetreplication_tpu_torch.obs.agg`, live tailing and folding of
  many run journals, and :mod:`~eegnetreplication_tpu_torch.obs.top`, the
  console over it (``python -m eegnetreplication_tpu_torch.obs.top``);
- :mod:`~eegnetreplication_tpu_torch.obs.report` and
  :mod:`~eegnetreplication_tpu_torch.obs.trace_report`, the readers of
  finished runs: a summary row a run, and traces stitched across
  processes (each ``python -m`` the module).

The registry also renders the Prometheus text of ``GET /metrics``.
Entry points open a run with :func:`journal.run`; library code reaches the
active journal through :func:`journal.current` (a no-op outside a run).
"""

from eegnetreplication_tpu_torch.obs import (
    journal,
    metrics,
    schema,
    slo,
    stats,
    trace,
)
from eegnetreplication_tpu_torch.obs.journal import (
    NullJournal,
    RunJournal,
    bound,
    current,
    new_run_id,
    run,
)
from eegnetreplication_tpu_torch.obs.metrics import MetricsRegistry
from eegnetreplication_tpu_torch.obs.schema import (
    SCHEMA_VERSION,
    SchemaError,
    read_events,
    read_metrics,
    validate_bench,
    validate_event,
    validate_events,
    validate_metrics,
    write_json_artifact,
)

__all__ = [
    "journal", "metrics", "schema", "slo", "stats", "trace",
    "RunJournal", "NullJournal", "MetricsRegistry",
    "bound", "current", "run", "new_run_id",
    "SCHEMA_VERSION", "SchemaError",
    "read_events", "read_metrics",
    "validate_bench", "validate_event", "validate_events",
    "validate_metrics", "write_json_artifact",
]
