"""Metrics registry: counters, gauges and histograms with labeled series.

The port's copy of the training part of ``eegnetreplication_tpu/obs/
metrics.py``:

- **counter**, a total that only grows (``fold_epochs_total``,
  ``device_fault_retries``, ``fault_retry_wall_s``);
- **gauge**, the last value written (``hbm_bytes_in_use``,
  ``epoch_throughput``);
- **histogram**, count/sum/min/max/mean of the observations
  (``chunk_wall_s``, ``ckpt_write_s``, ``ckpt_block_s``).

A name holds a family of series keyed by labels.  :meth:`MetricsRegistry.
flush` writes a ``metrics.json`` that the JAX package's
``validate_metrics`` accepts.  :class:`TensorBoardMirror` mirrors scalars
through ``torch.utils.tensorboard`` when that imports (it needs the
``tensorboard`` package) and is inert otherwise.  The JAX package's
bucketed quantiles, Prometheus text and process gauges serve its HTTP
tiers and are not ported (ROADMAP.md queue A.5).
"""

from __future__ import annotations

import json
import os
import threading
from dataclasses import dataclass, field
from pathlib import Path

from eegnetreplication_tpu_torch.obs import schema
from eegnetreplication_tpu_torch.utils.logging import logger


def _label_key(labels: dict[str, str]) -> tuple[tuple[str, str], ...]:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


@dataclass
class _Histogram:
    count: int = 0
    sum: float = 0.0
    min: float = float("inf")
    max: float = float("-inf")

    def observe(self, value: float) -> None:
        self.count += 1
        self.sum += value
        self.min = min(self.min, value)
        self.max = max(self.max, value)

    def to_dict(self, labels: dict) -> dict:
        return {"labels": labels, "count": self.count,
                "sum": round(self.sum, 6),
                "min": round(self.min, 6), "max": round(self.max, 6),
                "mean": round(self.sum / self.count, 6) if self.count
                else 0.0}


@dataclass
class MetricsRegistry:
    """Thread-safe in-process metrics.  A name keeps the kind it was first
    used as: using it as another kind raises."""

    _counters: dict = field(default_factory=dict)
    _gauges: dict = field(default_factory=dict)
    _histograms: dict = field(default_factory=dict)
    _lock: threading.Lock = field(default_factory=threading.Lock)

    def _check_kind(self, name: str, kind: dict) -> None:
        for other in (self._counters, self._gauges, self._histograms):
            if other is not kind and name in other:
                raise ValueError(
                    f"metric {name!r} is already registered as a different "
                    "kind; counter/gauge/histogram names must not collide")

    def inc(self, name: str, value: float = 1.0, **labels: str) -> None:
        """Add ``value`` to the counter series ``name{labels}``."""
        if value < 0:
            raise ValueError(f"counter {name!r} cannot decrease ({value})")
        with self._lock:
            self._check_kind(name, self._counters)
            series = self._counters.setdefault(name, {})
            key = _label_key(labels)
            series[key] = series.get(key, 0.0) + float(value)

    def set(self, name: str, value: float, **labels: str) -> None:
        """Set the gauge series ``name{labels}`` to ``value``."""
        with self._lock:
            self._check_kind(name, self._gauges)
            self._gauges.setdefault(name, {})[_label_key(labels)] = float(value)

    def observe(self, name: str, value: float, **labels: str) -> None:
        """Record one observation into the histogram ``name{labels}``."""
        with self._lock:
            self._check_kind(name, self._histograms)
            series = self._histograms.setdefault(name, {})
            series.setdefault(_label_key(labels), _Histogram()).observe(
                float(value))

    def get(self, name: str, **labels: str) -> float | None:
        """Current value of a counter or gauge series (None when absent)."""
        key = _label_key(labels)
        with self._lock:
            for store in (self._counters, self._gauges):
                if name in store and key in store[name]:
                    return store[name][key]
        return None

    def snapshot(self, run_id: str = "standalone") -> dict:
        """The registry as a schema-valid metrics record."""
        with self._lock:
            values = {
                section: {name: [{"labels": dict(k), "value": round(v, 6)}
                                 for k, v in sorted(series.items())]
                          for name, series in sorted(store.items())}
                for section, store in (("counters", self._counters),
                                       ("gauges", self._gauges))}
            histograms = {
                name: [h.to_dict(dict(k)) for k, h in sorted(series.items())]
                for name, series in sorted(self._histograms.items())}
        return {"schema_version": schema.SCHEMA_VERSION, "run_id": run_id,
                "utc": schema.utc_now(), **values, "histograms": histograms}

    def flush(self, path: str | Path, run_id: str = "standalone") -> Path:
        """Write the validated ``metrics.json`` atomically (a same-directory
        temp file, then a rename)."""
        record = schema.validate_metrics(self.snapshot(run_id))
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
        tmp.write_text(json.dumps(record, indent=1))
        tmp.replace(path)
        return path


class TensorBoardMirror:
    """Best-effort scalar mirror beside the ``--profileDir`` traces: inert
    (``active`` False) when ``torch.utils.tensorboard`` does not import."""

    def __init__(self, log_dir: str | Path):
        self._writer = None
        try:
            from torch.utils.tensorboard import SummaryWriter

            self._writer = SummaryWriter(str(log_dir))
        except Exception:  # noqa: BLE001 — the tensorboard package is absent
            logger.debug("No TensorBoard summary writer; scalar mirroring "
                         "to %s disabled", log_dir)

    @property
    def active(self) -> bool:
        return self._writer is not None

    def scalar(self, tag: str, value: float, step: int) -> None:
        if self._writer is not None:
            try:
                self._writer.add_scalar(tag, value, step)
            except Exception:  # noqa: BLE001 — mirroring is an add-on
                self._writer = None

    def close(self) -> None:
        if self._writer is not None:
            try:
                self._writer.close()
            except Exception:  # noqa: BLE001
                pass
            self._writer = None
