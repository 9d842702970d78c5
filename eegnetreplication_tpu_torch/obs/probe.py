"""Black-box probing: synthetic canaries through the real front door.

The port's copy of ``eegnetreplication_tpu/obs/probe.py`` over the port's
``obs/slo.py`` and ``obs/stats.py``.

Server-side telemetry sees what the server *thinks* is happening; a gray
replica — slow but alive, or returning fast wrong answers — can look
healthy from inside while failing every user.  The :class:`Prober` is
the outside-in complement: it POSTs a known-answer trial to ``/predict``
over real HTTP on a jittered interval, times the round trip from the
client's vantage, checks the reply against the pinned expected answer,
and evaluates its own availability/latency SLO over a sliding window of
outcomes.

Probe traffic is tagged with an ``X-Probe`` header so the serving stack
can keep it OUT of the adaptive-admission and ladder-tuner statistics
and out of the server-side request SLO (``serve/service.py`` routes
probe requests to ``probe_requests_total`` and exempts them in the
batcher) — the prober must measure the service, not steer it.

Known-answer semantics: the probe payload is a fixed deterministic trial
(geometry discovered from ``/healthz``), and the FIRST successful reply
pins the expected predictions.  The model's argmax on a fixed input is
deterministic, so any later disagreement is a wrong-answer gray failure
(``status="mismatch"``), distinct from unreachability (``http_*`` /
``timeout`` / ``error``).  A deliberate model swap re-pins on the next
probe after :meth:`reset_expected`.

Every probe journals a ``probe`` event; SLO transitions journal
``slo_breach``/``slo_recovered`` with a ``probe:``-prefixed objective
name so outside-in breaches never masquerade as the server-side
monitor's.
"""

from __future__ import annotations

import io
import json
import random
import socket
import threading
import time
import urllib.error
import urllib.request
from collections import deque

import numpy as np

from eegnetreplication_tpu_torch.obs import journal as obs_journal
from eegnetreplication_tpu_torch.obs.slo import Objective, parse_slo_spec
from eegnetreplication_tpu_torch.obs.stats import percentile
from eegnetreplication_tpu_torch.utils.logging import logger

DEFAULT_PROBE_SLO = "availability>0.99,p95_latency_ms<1000"
DEFAULT_INTERVAL_S = 5.0
DEFAULT_WINDOW_S = 60.0

# Header that marks canary traffic.  Single-sourced here: the serving
# stack imports it for exemption, the prober for emission.
PROBE_HEADER = "X-Probe"


class Prober:
    """Sends canaries to one front door URL and scores the answers.

    The target is anything speaking the ``/healthz`` + ``/predict``
    protocol (the port's server; the JAX package's fleet and cell fronts
    too).  Run it
    with :meth:`start` (daemon thread, jittered interval so probes never
    phase-lock with periodic server work) or drive :meth:`probe_once`
    from a caller's own loop (tests, benches).
    """

    def __init__(self, url: str, *, interval_s: float = DEFAULT_INTERVAL_S,
                 jitter: float = 0.3, timeout_s: float = 5.0,
                 slo: str | None = DEFAULT_PROBE_SLO,
                 window_s: float = DEFAULT_WINDOW_S, min_samples: int = 3,
                 journal=None, model: str | None = None, seed: int = 0,
                 clock=time.time):
        self.url = str(url).rstrip("/")
        self.interval_s = float(interval_s)
        self.jitter = max(0.0, min(float(jitter), 0.9))
        self.timeout_s = float(timeout_s)
        self.window_s = float(window_s)
        self.min_samples = max(1, int(min_samples))
        self.model = model
        self.seed = int(seed)
        self.objectives: tuple[Objective, ...] = \
            parse_slo_spec(slo) if slo else ()
        self._journal = journal
        self._clock = clock
        self._lock = threading.Lock()
        self._results: deque = deque()          # (t, ok, latency_ms)
        self._verdicts = {o.name: True for o in self.objectives}
        self._expected = None
        self._payload: tuple[bytes, str] | None = None
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self.probes_sent = 0

    # -- payload ----------------------------------------------------------
    def reset_expected(self) -> None:
        """Forget the pinned known answer (call after a deliberate model
        swap; the next successful probe re-pins)."""
        with self._lock:
            self._expected = None

    def _ensure_payload(self) -> tuple[bytes, str]:
        with self._lock:
            if self._payload is not None:
                return self._payload
        req = urllib.request.Request(f"{self.url}/healthz",
                                     headers={PROBE_HEADER: "1"})
        with urllib.request.urlopen(req, timeout=self.timeout_s) as resp:
            health = json.loads(resp.read())
        geometry = health.get("geometry") or {}
        c = int(geometry.get("n_channels") or 0)
        t = int(geometry.get("n_times") or 0)
        if c <= 0 or t <= 0:
            raise ValueError(
                f"{self.url}/healthz advertises no trial geometry")
        rng = np.random.default_rng(self.seed)
        x = rng.standard_normal((1, c, t), dtype=np.float32)
        buf = io.BytesIO()
        np.savez(buf, X=x)
        payload = (buf.getvalue(), "application/octet-stream")
        with self._lock:
            self._payload = payload
        return payload

    # -- one canary -------------------------------------------------------
    def _send(self, body: bytes, ctype: str):
        """Returns ``(status, predictions, http_code)``."""
        headers = {PROBE_HEADER: "1", "Content-Type": ctype}
        if self.model:
            headers["X-Model"] = self.model
        req = urllib.request.Request(f"{self.url}/predict", data=body,
                                     headers=headers, method="POST")
        try:
            with urllib.request.urlopen(req,
                                        timeout=self.timeout_s) as resp:
                reply = json.loads(resp.read())
            return "ok", reply.get("predictions"), resp.status
        except urllib.error.HTTPError as exc:
            return f"http_{exc.code}", None, exc.code
        except urllib.error.URLError as exc:
            if isinstance(exc.reason, (socket.timeout, TimeoutError)):
                return "timeout", None, None
            return "error", None, None
        except (TimeoutError, socket.timeout):
            return "timeout", None, None
        except (OSError, ValueError):
            return "error", None, None

    def probe_once(self) -> dict:
        """Send one canary, journal the outcome, update the probe SLO."""
        journal = self._journal if self._journal is not None \
            else obs_journal.current()
        code = None
        try:
            body, ctype = self._ensure_payload()
        except (OSError, ValueError, urllib.error.URLError) as exc:
            # Can't even fetch geometry: from the user's vantage the
            # front door is down — that IS the measurement.
            status, latency_ms = "error", self.timeout_s * 1000.0
            logger.debug("Probe payload bootstrap failed: %s", exc)
        else:
            t0 = time.perf_counter()
            status, predictions, code = self._send(body, ctype)
            latency_ms = (time.perf_counter() - t0) * 1000.0
            if status == "ok":
                with self._lock:
                    if self._expected is None:
                        self._expected = predictions
                    elif predictions != self._expected:
                        status = "mismatch"
        self.probes_sent += 1
        journal.event("probe", status=status,
                      latency_ms=round(latency_ms, 3), url=self.url,
                      http_status=code)
        journal.metrics.inc("probes_total", status=status)
        if status == "ok":
            journal.metrics.observe("probe_latency_ms", latency_ms)
        with self._lock:
            self._results.append((self._clock(), status == "ok",
                                  latency_ms))
            self._evaluate_locked(journal)
        return {"status": status, "latency_ms": round(latency_ms, 3)}

    # -- outside-in SLO ---------------------------------------------------
    def _evaluate_locked(self, journal) -> None:
        horizon = self._clock() - self.window_s
        while self._results and self._results[0][0] < horizon:
            self._results.popleft()
        n = len(self._results)
        if n < self.min_samples:
            return
        n_ok = sum(1 for _, ok, _ in self._results if ok)
        ok_lat = [lat for _, ok, lat in self._results if ok]
        for obj in self.objectives:
            value = self._metric_value(obj, n, n_ok, ok_lat)
            verdict = obj.ok(value)
            name = f"probe:{obj.name}"
            previous = self._verdicts.get(obj.name, True)
            if previous and not verdict:
                journal.event("slo_breach", objective=name,
                              value=(round(value, 6)
                                     if value is not None else None),
                              threshold=obj.threshold,
                              metric=f"probe_{obj.metric}",
                              window_s=self.window_s, n_probes=n)
                journal.metrics.inc("probe_slo_breaches")
                logger.warning("Probe SLO breach: %s = %s (threshold %s)",
                               name, value, obj.threshold)
            elif not previous and verdict:
                journal.event("slo_recovered", objective=name,
                              threshold=obj.threshold,
                              window_s=self.window_s)
            self._verdicts[obj.name] = verdict

    @staticmethod
    def _metric_value(obj: Objective, n: int, n_ok: int,
                      ok_lat: list[float]) -> float | None:
        if obj.metric == "availability":
            return n_ok / n
        if obj.metric == "error_rate":
            return 1.0 - n_ok / n
        if not ok_lat:
            return None  # latency objectives are vacuous with no successes
        q = int(obj.metric[1:obj.metric.index("_")]) / 100.0
        return percentile(ok_lat, q)

    @property
    def breached(self) -> bool:
        with self._lock:
            return any(not ok for ok in self._verdicts.values())

    def state(self) -> dict:
        with self._lock:
            return {"url": self.url, "probes_sent": self.probes_sent,
                    "window": len(self._results),
                    "breached": any(not ok
                                    for ok in self._verdicts.values()),
                    "objectives": {f"probe:{name}": ok
                                   for name, ok in
                                   sorted(self._verdicts.items())}}

    # -- background loop --------------------------------------------------
    def start(self) -> "Prober":
        self._stop.clear()
        self._thread = threading.Thread(target=self._run,
                                        name="eegtpu-prober", daemon=True)
        self._thread.start()
        return self

    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                self.probe_once()
            except Exception as exc:  # noqa: BLE001 — probing is advisory
                logger.warning("Probe iteration failed: %s", exc)
            # Jittered cadence: a fixed period can phase-lock with
            # periodic server work (retunes, snapshots) and then every
            # probe measures the same artifact.
            delay = self.interval_s * random.uniform(1.0 - self.jitter,
                                                     1.0 + self.jitter)
            self._stop.wait(delay)

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=self.timeout_s + self.interval_s)
            self._thread = None
