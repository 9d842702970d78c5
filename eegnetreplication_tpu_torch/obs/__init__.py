"""Structured telemetry of a training run: journal, metrics, schema.

The port's counterpart of ``eegnetreplication_tpu/obs``, for the training
path:

- :mod:`~eegnetreplication_tpu_torch.obs.journal`, run-scoped JSONL event
  streams (``events.jsonl``) with a context-local active journal;
- :mod:`~eegnetreplication_tpu_torch.obs.metrics`, counters, gauges and
  histograms flushed to ``metrics.json``, with an optional TensorBoard
  scalar mirror;
- :mod:`~eegnetreplication_tpu_torch.obs.schema`, the required keys of the
  training events and the validation the JAX package's readers apply.

Entry points open a run with :func:`journal.run`; library code reaches the
active journal through :func:`journal.current` (a no-op outside a run).
Tracing, SLOs, probes, aggregation, Prometheus text and the ``BENCH_*.json``
writer serve the JAX package's HTTP tiers and benchmarks and are not
ported (ROADMAP.md queue A.5).
"""

from eegnetreplication_tpu_torch.obs import journal, metrics, schema
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
    validate_event,
    validate_events,
    validate_metrics,
)

__all__ = [
    "journal", "metrics", "schema",
    "RunJournal", "NullJournal", "MetricsRegistry",
    "bound", "current", "run", "new_run_id",
    "SCHEMA_VERSION", "SchemaError",
    "read_events", "read_metrics",
    "validate_event", "validate_events", "validate_metrics",
]
