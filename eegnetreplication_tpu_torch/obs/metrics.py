"""Metrics registry: counters, gauges and histograms with labeled series.

The port's copy of the training part of ``eegnetreplication_tpu/obs/
metrics.py``:

- **counter**, a total that only grows (``fold_epochs_total``,
  ``device_fault_retries``, ``fault_retry_wall_s``);
- **gauge**, the last value written (``hbm_bytes_in_use``,
  ``epoch_throughput``);
- **histogram**, count/sum/min/max/mean of the observations plus fixed
  log-spaced bucket counts (``chunk_wall_s``, ``request_latency_ms``,
  ``bucket_fill``), so :meth:`MetricsRegistry.quantile` answers p50/p95/
  p99 from the live registry: ``/healthz``, the ladder tuner and the SLO
  monitor read it.

A name holds a family of series keyed by labels.  :meth:`MetricsRegistry.
flush` writes a ``metrics.json`` that the JAX package's
``validate_metrics`` accepts.  :func:`to_prometheus_text` renders the same
snapshot in the Prometheus text exposition format (``GET /metrics``
negotiates between the two); the bucket bounds are the JAX package's, so
both packages give the same text and the same quantiles for the same
observations.  :class:`TensorBoardMirror` mirrors scalars through
``torch.utils.tensorboard`` when that imports (it needs the
``tensorboard`` package) and is inert otherwise.
"""

from __future__ import annotations

import bisect
import os
import re
import threading
import time
from dataclasses import dataclass, field
from pathlib import Path

from eegnetreplication_tpu_torch.obs import schema
from eegnetreplication_tpu_torch.utils.logging import logger


def _label_key(labels: dict[str, str]) -> tuple[tuple[str, str], ...]:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


# Histogram bucket upper bounds (Prometheus ``le``: a bucket counts the
# observations <= its bound), the JAX package's: quarter-decade steps from
# 0.01 to 10^5, one ladder for latencies in ms, walls in s, batch sizes
# and fill fractions.  An estimate lands within one bucket width of the
# exact order statistic.
DEFAULT_BUCKET_BOUNDS: tuple[float, ...] = tuple(
    round(10.0 ** (k / 4.0), 6) for k in range(-8, 21))


def quantile_from_buckets(bounds: tuple[float, ...] | list[float],
                          counts: tuple[int, ...] | list[int],
                          q: float, *, lo: float | None = None,
                          hi: float | None = None) -> float:
    """The ``q``-quantile from bucketed ``counts`` (one per bound plus the
    +Inf overflow): linear interpolation inside the containing bucket,
    clamped to the observed ``lo``/``hi`` when given.  0.0 when empty."""
    total = sum(counts)
    if total <= 0:
        return 0.0
    if not 0.0 <= q <= 1.0:
        raise ValueError(f"quantile must be within [0, 1], got {q}")
    target = q * total
    cum = 0.0
    for i, n in enumerate(counts):
        if n <= 0:
            continue
        if cum + n >= target:
            lower = bounds[i - 1] if i > 0 else 0.0
            upper = bounds[i] if i < len(bounds) else (
                hi if hi is not None else bounds[-1])
            # No observation lies outside [lo, hi]: clamp both ends, or a
            # distribution inside one bucket reads as the bucket's width.
            if lo is not None:
                lower = max(lower, lo)
            if hi is not None:
                upper = min(upper, hi)
            if upper < lower:
                upper = lower
            frac = (target - cum) / n
            return lower + frac * (upper - lower)
        cum += n
    return float(hi) if hi is not None else float(bounds[-1])


@dataclass
class _Histogram:
    count: int = 0
    sum: float = 0.0
    min: float = float("inf")
    max: float = float("-inf")
    bounds: tuple[float, ...] = DEFAULT_BUCKET_BOUNDS
    buckets: list[int] = field(default_factory=list)

    def __post_init__(self):
        if not self.buckets:
            self.buckets = [0] * (len(self.bounds) + 1)

    def observe(self, value: float) -> None:
        self.count += 1
        self.sum += value
        self.min = min(self.min, value)
        self.max = max(self.max, value)
        self.buckets[bisect.bisect_left(self.bounds, value)] += 1

    def quantile(self, q: float) -> float:
        """The live q-quantile estimate from the bucket counts."""
        return quantile_from_buckets(self.bounds, self.buckets, q,
                                     lo=self.min if self.count else None,
                                     hi=self.max if self.count else None)

    def to_dict(self, labels: dict) -> dict:
        return {"labels": labels, "count": self.count,
                "sum": round(self.sum, 6),
                "min": round(self.min, 6), "max": round(self.max, 6),
                "mean": round(self.sum / self.count, 6) if self.count
                else 0.0,
                "bounds": list(self.bounds),
                "buckets": list(self.buckets)}


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

    def quantile(self, name: str, q: float, **labels: str) -> float | None:
        """Live quantile estimate of the histogram ``name{labels}`` (None
        when the series is absent)."""
        key = _label_key(labels)
        with self._lock:
            series = self._histograms.get(name)
            if not series or key not in series:
                return None
            return series[key].quantile(q)

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
        """Write the validated ``metrics.json`` summary atomically."""
        return schema.write_json_artifact(path, self.snapshot(run_id),
                                          kind="metrics", indent=1)


# ---------------------------------------------------------------------------
# Prometheus text exposition (content-negotiated by GET /metrics).
# ---------------------------------------------------------------------------

_NAME_SANITIZE = re.compile(r"[^a-zA-Z0-9_:]")
_LABEL_SANITIZE = re.compile(r"[^a-zA-Z0-9_]")

# Accept-header fragments that select the text format over the JSON
# snapshot (what a Prometheus scraper sends).
PROMETHEUS_ACCEPT_HINTS = ("text/plain", "openmetrics")
PROMETHEUS_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


def wants_prometheus(accept_header: str | None) -> bool:
    """Content negotiation: JSON by default; an Accept header naming
    ``text/plain`` or an OpenMetrics type selects the text format, unless
    it also names ``application/json``."""
    accept = (accept_header or "").lower()
    if "application/json" in accept:
        return False
    return any(hint in accept for hint in PROMETHEUS_ACCEPT_HINTS)


def _prom_name(name: str) -> str:
    name = _NAME_SANITIZE.sub("_", str(name))
    return "_" + name if name[:1].isdigit() else (name or "_")


def _prom_label_value(value) -> str:
    """Escape backslash, double quote and newline, the exposition
    format's three escapes."""
    return (str(value).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _prom_labels(labels: dict, extra: dict | None = None) -> str:
    merged = dict(labels)
    if extra:
        merged.update(extra)
    if not merged:
        return ""
    inner = ",".join(
        f'{_LABEL_SANITIZE.sub("_", str(k))}="{_prom_label_value(v)}"'
        for k, v in sorted(merged.items()))
    return "{" + inner + "}"


def _prom_number(value: float) -> str:
    if value == float("inf"):
        return "+Inf"
    if value == float("-inf"):
        return "-Inf"
    return repr(float(value)) if isinstance(value, float) else str(value)


# HELP strings of the busiest families (the JAX package's); the rest get a
# generated one.
METRIC_HELP = {
    "requests_total": "Requests handled, by terminal status.",
    "request_latency_ms": "End-to-end latency of ok requests (ms).",
    "probe_requests_total": "Synthetic canary requests handled (X-Probe), "
                            "by terminal status — kept out of "
                            "requests_total so probes never move the SLO.",
    "probes_total": "Black-box canary probes sent, by outcome.",
    "probe_latency_ms": "Client-observed canary probe latency (ms).",
    "queue_wait_ms": "Time a request waited in the batching queue (ms).",
    "batch_trials": "Trials per forwarded micro-batch.",
    "batch_requests": "Requests coalesced per forwarded micro-batch.",
    "bucket_fill": "Occupancy fraction of the compiled bucket used.",
    "compile_seconds": "XLA compile wall time per program (s).",
    "wall_seconds": "Run wall time (s).",
    "process_resident_memory_bytes": "Resident set size of this process "
                                     "(bytes).",
    "process_open_fds": "Open file descriptors held by this process.",
    "process_uptime_seconds": "Seconds since this process imported the "
                              "metrics module.",
    "eegtpu_build_info": "Build metadata as labels; value is always 1.",
}


def _metric_help(name: str, prom_type: str) -> str:
    return METRIC_HELP.get(name, f"{name} ({prom_type}).")


# Process gauges, read at scrape time from /proc where it exists.
_PROCESS_START = time.monotonic()


def process_snapshot() -> dict[str, float]:
    out = {"process_uptime_seconds": round(
        time.monotonic() - _PROCESS_START, 3)}
    try:
        with open("/proc/self/statm") as fh:
            rss_pages = int(fh.read().split()[1])
        out["process_resident_memory_bytes"] = float(
            rss_pages * os.sysconf("SC_PAGE_SIZE"))
    except (OSError, ValueError, IndexError):
        pass
    try:
        out["process_open_fds"] = float(len(os.listdir("/proc/self/fd")))
    except OSError:
        pass
    return out


_BUILD_INFO: dict[str, str] | None = None


def build_info() -> dict[str, str]:
    """Build labels (version and git sha), computed once per process."""
    global _BUILD_INFO
    if _BUILD_INFO is None:
        from eegnetreplication_tpu_torch import __version__ as version
        # journal imports this module: the reverse import stays here.
        from eegnetreplication_tpu_torch.obs.journal import _git_sha

        _BUILD_INFO = {"version": str(version), "git_sha": _git_sha()}
    return _BUILD_INFO


def _process_lines() -> list[str]:
    lines: list[str] = []
    for name, value in sorted(process_snapshot().items()):
        lines.append(f"# HELP {name} {_metric_help(name, 'gauge')}")
        lines.append(f"# TYPE {name} gauge")
        lines.append(f"{name} {_prom_number(value)}")
    lines.append("# HELP eegtpu_build_info "
                 f"{_metric_help('eegtpu_build_info', 'gauge')}")
    lines.append("# TYPE eegtpu_build_info gauge")
    lines.append(f"eegtpu_build_info{_prom_labels(build_info())} 1")
    return lines


def to_prometheus_text(snapshot: dict, *, process_metrics: bool = True) -> str:
    """A registry snapshot in the Prometheus text exposition format:
    counters and gauges as they are, histograms as cumulative
    ``_bucket{le=...}`` series plus ``_sum`` and ``_count``, each family
    under its ``# HELP``/``# TYPE`` lines; ``process_metrics`` appends the
    process gauges and ``eegtpu_build_info``."""
    lines: list[str] = []
    for section, prom_type in (("counters", "counter"), ("gauges", "gauge")):
        for name, series in sorted(snapshot.get(section, {}).items()):
            pname = _prom_name(name)
            lines.append(f"# HELP {pname} {_metric_help(name, prom_type)}")
            lines.append(f"# TYPE {pname} {prom_type}")
            for entry in series:
                lines.append(f"{pname}{_prom_labels(entry['labels'])} "
                             f"{_prom_number(entry['value'])}")
    for name, series in sorted(snapshot.get("histograms", {}).items()):
        pname = _prom_name(name)
        lines.append(f"# HELP {pname} {_metric_help(name, 'histogram')}")
        lines.append(f"# TYPE {pname} histogram")
        for entry in series:
            labels = entry["labels"]
            bounds = entry.get("bounds") or []
            buckets = entry.get("buckets") or []
            cum = 0
            for bound, count in zip(bounds, buckets):
                cum += count
                lines.append(
                    f"{pname}_bucket"
                    f"{_prom_labels(labels, {'le': _prom_number(bound)})} "
                    f"{cum}")
            lines.append(
                f"{pname}_bucket{_prom_labels(labels, {'le': '+Inf'})} "
                f"{entry['count']}")
            lines.append(f"{pname}_sum{_prom_labels(labels)} "
                         f"{_prom_number(entry['sum'])}")
            lines.append(f"{pname}_count{_prom_labels(labels)} "
                         f"{entry['count']}")
    if process_metrics:
        lines.extend(_process_lines())
    return "\n".join(lines) + "\n"


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
