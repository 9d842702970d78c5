"""Live SLO evaluation over sliding windows of metrics-registry deltas.

The port's copy of ``eegnetreplication_tpu/obs/slo.py``.

The journal records what happened; an operator (or the fleet router's
health aggregation) needs to know whether the service is MEETING ITS
OBJECTIVES *right now* — tail latency under budget, error rate bounded,
availability above the floor — without sorting a journal after the fact.

:func:`parse_slo_spec` turns a declarative spec string like::

    p95_latency_ms<50,error_rate<0.01,availability>0.999

into :class:`Objective` tuples; :class:`SLOMonitor` samples the serving
registry's ``requests_total`` counters and bucketed ``request_latency_ms``
histogram, keeps a sliding window of snapshots, and evaluates every
objective over the WINDOW DELTA (what happened in the last ``window_s``
seconds, not since boot — a breach must clear once the bad minute ages
out).  Each ok→breach transition journals ``slo_breach`` and each
breach→ok journals ``slo_recovered``; the current verdict feeds
``/healthz`` (a breached replica reports degraded, the fleet router
aggregates per-replica SLO state into its own health view).

Supported objective metrics:

- ``pNN_latency_ms`` (any integer NN) — the NNth percentile of the
  latency histogram's window delta, estimated from its log-spaced
  buckets;
- ``error_rate`` — non-ok, non-rejected requests over non-rejected
  requests (backpressure is load shedding by design, not an error);
- ``availability`` — ok requests over non-rejected requests.
"""

from __future__ import annotations

import re
import threading
import time
from collections import deque
from dataclasses import dataclass

from eegnetreplication_tpu_torch.obs import journal as obs_journal
from eegnetreplication_tpu_torch.obs.metrics import quantile_from_buckets
from eegnetreplication_tpu_torch.utils.logging import logger

DEFAULT_WINDOW_S = 30.0

_OBJECTIVE_RE = re.compile(
    r"^\s*(?P<metric>[A-Za-z_][A-Za-z0-9_]*)\s*(?P<op>[<>])\s*"
    r"(?P<threshold>[0-9.eE+-]+)\s*$")
_PERCENTILE_RE = re.compile(r"^p(\d{1,2})_latency_ms$")


@dataclass(frozen=True)
class Objective:
    """One declarative objective: ``metric op threshold``."""

    metric: str
    op: str                 # "<" (stay under) or ">" (stay over)
    threshold: float

    def __post_init__(self):
        if self.op not in ("<", ">"):
            raise ValueError(f"objective op must be < or >, got {self.op!r}")
        if self.metric not in ("error_rate", "availability") \
                and not _PERCENTILE_RE.match(self.metric):
            raise ValueError(
                f"unknown SLO metric {self.metric!r} (supported: "
                f"pNN_latency_ms, error_rate, availability)")

    @property
    def name(self) -> str:
        return f"{self.metric}{self.op}{self.threshold:g}"

    def ok(self, value: float | None) -> bool:
        """Vacuously true when the window produced no evidence."""
        if value is None:
            return True
        return value < self.threshold if self.op == "<" \
            else value > self.threshold


def parse_slo_spec(spec: str) -> tuple[Objective, ...]:
    """``"p95_latency_ms<50,error_rate<0.01"`` -> Objective tuple.
    Raises ``ValueError`` on malformed clauses (a typo'd SLO silently
    monitoring nothing would be worse than no SLO)."""
    objectives = []
    for clause in spec.split(","):
        if not clause.strip():
            continue
        m = _OBJECTIVE_RE.match(clause)
        if not m:
            raise ValueError(f"malformed SLO clause {clause!r} "
                             f"(expected metric<value or metric>value)")
        objectives.append(Objective(metric=m["metric"], op=m["op"],
                                    threshold=float(m["threshold"])))
    if not objectives:
        raise ValueError(f"SLO spec {spec!r} names no objectives")
    return tuple(objectives)


@dataclass
class _Sample:
    """One registry observation: cumulative counters at time t."""

    t: float
    status_counts: dict[str, float]
    hist_counts: tuple[int, ...] | None
    hist_bounds: tuple[float, ...] | None
    hist_min: float
    hist_max: float


@dataclass
class ObjectiveState:
    """Current verdict for one objective."""

    objective: Objective
    ok: bool = True
    value: float | None = None
    breached_at: float | None = None

    def as_json(self) -> dict:
        return {"objective": self.objective.name,
                "metric": self.objective.metric,
                "threshold": self.objective.threshold,
                "op": self.objective.op,
                "ok": self.ok,
                "value": (round(self.value, 6)
                          if self.value is not None else None)}


class SLOMonitor:
    """Sliding-window SLO evaluation over a live metrics registry.

    ``evaluate()`` is the whole loop body (sample → window delta →
    verdicts → transition events); ``start()`` runs it on a background
    thread every ``interval_s`` (0 disables the thread — callers such as
    ``/healthz`` may then drive ``evaluate()`` on demand).  Never raises
    from the loop: SLO monitoring is advisory and must not take serving
    down.
    """

    def __init__(self, registry, objectives, *,
                 window_s: float = DEFAULT_WINDOW_S,
                 interval_s: float = 1.0,
                 latency_metric: str = "request_latency_ms",
                 counter_metric: str = "requests_total",
                 journal=None, clock=time.monotonic):
        if isinstance(objectives, str):
            objectives = parse_slo_spec(objectives)
        self.objectives = tuple(objectives)
        self.registry = registry
        self.window_s = float(window_s)
        self.interval_s = float(interval_s)
        self.latency_metric = latency_metric
        self.counter_metric = counter_metric
        self._journal = journal if journal is not None \
            else obs_journal.current()
        self._clock = clock
        self._samples: deque[_Sample] = deque()
        self._lock = threading.Lock()
        self._states = {o.name: ObjectiveState(o) for o in self.objectives}
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self.breach_events = 0
        # Seed the window so the first evaluation diffs against boot
        # state instead of reporting cumulative-since-forever values.
        self._sample_now()

    # -- observation -------------------------------------------------------
    def _sample_now(self) -> _Sample:
        snapshot = self.registry.snapshot()
        status_counts: dict[str, float] = {}
        for entry in snapshot["counters"].get(self.counter_metric, []):
            status = entry["labels"].get("status", "")
            status_counts[status] = status_counts.get(status, 0.0) \
                + entry["value"]
        hist_counts = hist_bounds = None
        hmin, hmax = float("inf"), float("-inf")
        series = snapshot["histograms"].get(self.latency_metric, [])
        for entry in series:
            if entry.get("labels"):
                continue  # the serving path observes latency label-free
            hist_counts = tuple(entry.get("buckets") or ())
            hist_bounds = tuple(entry.get("bounds") or ())
            hmin, hmax = entry.get("min", hmin), entry.get("max", hmax)
        if hist_counts is None and series:
            entry = series[0]
            hist_counts = tuple(entry.get("buckets") or ())
            hist_bounds = tuple(entry.get("bounds") or ())
            hmin, hmax = entry.get("min", hmin), entry.get("max", hmax)
        sample = _Sample(t=self._clock(), status_counts=status_counts,
                         hist_counts=hist_counts, hist_bounds=hist_bounds,
                         hist_min=hmin, hist_max=hmax)
        with self._lock:
            self._samples.append(sample)
            cutoff = sample.t - self.window_s
            # Keep ONE sample at/behind the cutoff as the delta baseline:
            # dropping it too would shrink the window to the sampling
            # cadence instead of window_s.
            while len(self._samples) >= 2 and self._samples[1].t <= cutoff:
                self._samples.popleft()
        return sample

    def _window_values(self, newest: _Sample) -> dict[str, float | None]:
        with self._lock:
            oldest = self._samples[0]
        delta_counts = {
            status: newest.status_counts.get(status, 0.0)
            - oldest.status_counts.get(status, 0.0)
            for status in set(newest.status_counts)
            | set(oldest.status_counts)}
        total = sum(delta_counts.values())
        rejected = delta_counts.get("rejected", 0.0)
        admitted = total - rejected
        ok = delta_counts.get("ok", 0.0)
        values: dict[str, float | None] = {}
        if admitted > 0:
            values["error_rate"] = max(0.0, admitted - ok) / admitted
            values["availability"] = ok / admitted
        else:
            values["error_rate"] = None
            values["availability"] = None
        # Latency percentiles from the histogram's window delta.
        if newest.hist_counts and newest.hist_bounds:
            old = oldest.hist_counts or (0,) * len(newest.hist_counts)
            if len(old) != len(newest.hist_counts):
                old = (0,) * len(newest.hist_counts)
            delta = tuple(max(0, int(n - o)) for n, o
                          in zip(newest.hist_counts, old))
            if sum(delta) > 0:
                for objective in self.objectives:
                    m = _PERCENTILE_RE.match(objective.metric)
                    if m:
                        values[objective.metric] = quantile_from_buckets(
                            newest.hist_bounds, delta, int(m[1]) / 100.0,
                            lo=newest.hist_min, hi=newest.hist_max)
        return values

    # -- evaluation --------------------------------------------------------
    def evaluate(self) -> dict[str, ObjectiveState]:
        """One pass: sample, window delta, verdicts, transition events."""
        try:
            newest = self._sample_now()
            values = self._window_values(newest)
            for state in self._states.values():
                obj = state.objective
                value = values.get(obj.metric)
                now_ok = obj.ok(value)
                state.value = value
                if state.ok and not now_ok:
                    state.ok = False
                    state.breached_at = newest.t
                    self.breach_events += 1
                    self._journal.event(
                        "slo_breach", objective=obj.name,
                        metric=obj.metric, value=round(value, 6),
                        threshold=obj.threshold,
                        window_s=self.window_s)
                    self._journal.metrics.set("slo_ok", 0.0,
                                              objective=obj.name)
                    logger.warning("SLO breach: %s (value %.6g, window "
                                   "%.0fs)", obj.name, value, self.window_s)
                elif not state.ok and now_ok:
                    state.ok = True
                    state.breached_at = None
                    self._journal.event(
                        "slo_recovered", objective=obj.name,
                        metric=obj.metric,
                        value=(round(value, 6) if value is not None
                               else None),
                        threshold=obj.threshold,
                        window_s=self.window_s)
                    self._journal.metrics.set("slo_ok", 1.0,
                                              objective=obj.name)
                    logger.info("SLO recovered: %s", obj.name)
        except Exception as exc:  # noqa: BLE001 — advisory subsystem
            logger.warning("SLO evaluation failed (%s: %s); serving "
                           "unaffected", type(exc).__name__, exc)
        return dict(self._states)

    @property
    def breached(self) -> list[str]:
        """Names of currently breached objectives (healthz degradation)."""
        return [name for name, state in self._states.items()
                if not state.ok]

    def state(self) -> dict:
        """The JSON the replica's ``/healthz`` embeds (and the fleet
        membership poll mirrors)."""
        return {"objectives": [s.as_json() for s in self._states.values()],
                "breached": self.breached,
                "window_s": self.window_s}

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> "SLOMonitor":
        if self._thread is not None or self.interval_s <= 0:
            return self
        self._stop.clear()
        self._thread = threading.Thread(target=self._run,
                                        name="serve-slo-monitor",
                                        daemon=True)
        self._thread.start()
        return self

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            self.evaluate()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=30.0)
            self._thread = None
