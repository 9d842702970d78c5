"""Latency-outlier ejection: pull gray replicas that health checks miss.

A replica can be slow yet alive: it answers every ``/healthz`` poll, its
heartbeat file stays fresh, its breaker never opens (requests *succeed*,
just late) — and it silently drags the fleet p99 (Huang et al., "Gray
Failure", HotOS'17; Dean & Barroso, "The Tail at Scale", CACM'13).  The
liveness machinery (heartbeats, health polls, breakers) cannot see it
because every signal it reads
is a liveness signal.  This module watches the one signal that does
change: per-replica dispatch latency.

The :class:`OutlierEjector` keeps a rolling window of successful dispatch
latencies per replica (fed by the router on every completed attempt).  A
replica whose rolling p95 exceeds ``k`` times the fleet median — the
median of the per-replica median latencies, so one outlier cannot drag
its own threshold up — is **ejected**: transitioned to the ``degraded``
membership state (no new dispatches; in-flight ones drain normally, the
router's accounting is untouched) and journaled as ``replica_ejected``.

Re-admission reuses the half-open pattern from
:class:`~eegnetreplication_tpu_torch.resil.breaker.CircuitBreaker` — each
ejection IS a one-failure breaker: ejecting opens it, the ``cooldown_s``
elapses into half-open, and the router's ``claim_probe`` then admits a
bounded number of probe dispatches to the degraded replica.  A probe that
completes under the ejection threshold closes the breaker and re-admits
the replica (``replica_readmitted``); a still-slow probe re-opens it and
the cooldown restarts.

Safety: the ``max_eject_fraction`` guard refuses any ejection that would
put more than that fraction of the fleet in ``degraded`` at once — a
detector fed pathological data (a fleet-wide slowdown is not an outlier)
must never evict a majority and collapse capacity onto one survivor.
"""

from __future__ import annotations

import threading
import time
from collections import deque

from eegnetreplication_tpu_torch.obs import journal as obs_journal
from eegnetreplication_tpu_torch.obs.stats import percentile
from eegnetreplication_tpu_torch.resil.breaker import CircuitBreaker
from eegnetreplication_tpu_torch.serve.fleet import membership as ms
from eegnetreplication_tpu_torch.utils.logging import logger


class OutlierEjector:
    """Per-replica latency tracking + the ejection/readmission policy.

    Thread-safe: the router calls :meth:`observe` from every dispatching
    thread and :meth:`claim_probe` from its selection path.
    """

    def __init__(self, membership: ms.FleetMembership, *, k: float = 3.0,
                 window: int = 64, min_samples: int = 16,
                 floor_ms: float = 2.0, cooldown_s: float = 5.0,
                 max_eject_fraction: float = 0.5,
                 check_interval_s: float = 0.1, journal=None,
                 clock=time.monotonic):
        if k <= 1.0:
            raise ValueError(f"k must be > 1 (p95 vs fleet median), got {k}")
        if not 0.0 < max_eject_fraction <= 0.5:
            raise ValueError(
                f"max_eject_fraction must be in (0, 0.5] (never a "
                f"majority), got {max_eject_fraction}")
        if min_samples < 2:
            raise ValueError(f"min_samples must be >= 2, got {min_samples}")
        self.membership = membership
        self.k = float(k)
        self.window = int(window)
        self.min_samples = int(min_samples)
        self.floor_ms = float(floor_ms)
        self.cooldown_s = float(cooldown_s)
        self.max_eject_fraction = float(max_eject_fraction)
        self.check_interval_s = float(check_interval_s)
        self._journal = journal if journal is not None \
            else obs_journal.current()
        self._clock = clock
        self._lock = threading.Lock()
        self._lat: dict[str, deque[float]] = {}
        # One record per ejected replica: a breaker (OPEN = cooldown,
        # HALF_OPEN = probe slots, CLOSED = re-admitted, entry removed),
        # the fleet-median threshold frozen at ejection time (the probe
        # verdict must not depend on a fleet median that may have no
        # samples while the replica is out of rotation), and an explicit
        # count of CLAIMED probes in flight — only a latency answering a
        # claimed probe may judge re-admission; in-flight stragglers
        # from before the ejection never claimed one.
        self._ejections: dict[str, dict] = {}
        self._next_check = 0.0
        self.n_ejected = 0
        self.n_readmitted = 0

    # -- observation feed (router) ----------------------------------------
    def observe(self, replica: ms.Replica, latency_ms: float,
                ok: bool = True) -> None:
        """One completed dispatch attempt's latency.

        For a ``live`` replica this feeds detection; for a ``degraded``
        one it IS the probe verdict the half-open slot was claimed for.
        """
        if replica.state == ms.DEGRADED:
            self._probe_result(replica, latency_ms, ok)
            return
        if not ok:
            return  # error latencies are the breaker's business
        with self._lock:
            self._lat.setdefault(replica.replica_id,
                                 deque(maxlen=self.window)).append(
                float(latency_ms))
            now = self._clock()
            if now < self._next_check:
                return
            self._next_check = now + self.check_interval_s
            verdict = self._detect_locked()
        if verdict is not None:
            self._eject(*verdict)

    # -- detection ---------------------------------------------------------
    def _detect_locked(self) -> tuple[ms.Replica, float, float] | None:
        """Worst eligible outlier ``(replica, p95_ms, fleet_p50_ms)`` or
        ``None`` (``self._lock`` held)."""
        live = [r for r in self.membership.replicas if r.state == ms.LIVE]
        sampled = [(r, self._lat.get(r.replica_id))
                   for r in live]
        sampled = [(r, win) for r, win in sampled
                   if win is not None and len(win) >= self.min_samples]
        if len(sampled) < 2:
            return None  # an outlier needs siblings to be an outlier OF
        medians = [percentile(win, 0.50) for _, win in sampled]
        fleet_p50 = percentile(medians, 0.50)
        threshold = max(self.k * fleet_p50, self.floor_ms)
        worst: tuple[ms.Replica, float] | None = None
        for r, win in sampled:
            p95 = percentile(win, 0.95)
            if p95 > threshold and (worst is None or p95 > worst[1]):
                worst = (r, p95)
        if worst is None:
            return None
        # Max-ejection-fraction guard: counted against every replica the
        # fleet was configured with, so cascading slowness can never
        # evict a majority no matter how it presents.
        n_total = len(self.membership.replicas)
        n_degraded = sum(1 for r in self.membership.replicas
                         if r.state == ms.DEGRADED)
        if (n_degraded + 1) > self.max_eject_fraction * n_total:
            logger.warning(
                "Outlier detector would eject %s (p95 %.1fms vs fleet "
                "median %.1fms) but %d/%d replicas are already degraded "
                "(max fraction %.2f) — refusing", worst[0].replica_id,
                worst[1], fleet_p50, n_degraded, n_total,
                self.max_eject_fraction)
            return None
        return worst[0], worst[1], fleet_p50

    def _eject(self, replica: ms.Replica, p95_ms: float,
               fleet_p50_ms: float) -> None:
        if not self.membership.set_state(
                replica, ms.DEGRADED,
                f"latency_outlier: p95 {p95_ms:.1f}ms > "
                f"{self.k:.1f}x fleet median {fleet_p50_ms:.1f}ms",
                only_from=(ms.LIVE,)):
            return  # lost a race (canary election, concurrent eject)
        breaker = CircuitBreaker(failure_threshold=1,
                                 reset_after_s=self.cooldown_s,
                                 site=f"outlier.{replica.replica_id}",
                                 journal=self._journal, clock=self._clock)
        breaker.record_failure()  # OPEN: the cooldown starts now
        threshold_ms = max(self.k * fleet_p50_ms, self.floor_ms)
        with self._lock:
            self._ejections[replica.replica_id] = {
                "breaker": breaker, "threshold_ms": threshold_ms,
                "pending_probes": 0}
            self._lat.pop(replica.replica_id, None)  # stale-latency reset
            self.n_ejected += 1
        self._journal.event("replica_ejected", replica=replica.replica_id,
                            p95_ms=round(p95_ms, 3),
                            fleet_p50_ms=round(fleet_p50_ms, 3),
                            k=self.k, cooldown_s=self.cooldown_s)
        self._journal.metrics.inc("replica_ejections")
        logger.warning("Ejected %s as a latency outlier: p95 %.1fms vs "
                       "fleet median %.1fms (k=%.1f)", replica.replica_id,
                       p95_ms, fleet_p50_ms, self.k)

    def _prune_stale(self) -> None:
        """Drop ejection records whose replica is no longer ``degraded``
        — it left through another door (health poller marked it OUT and
        a supervisor relaunch re-LIVE'd it).  Without this, a restarted
        replica would show under ``degraded`` in the snapshot forever
        and carry a stale breaker into its next ejection."""
        states = {r.replica_id: r.state for r in self.membership.replicas}
        with self._lock:
            for rid in [rid for rid in self._ejections
                        if states.get(rid) != ms.DEGRADED]:
                self._ejections.pop(rid, None)

    # -- probing + readmission --------------------------------------------
    def claim_probe(self, tried: set[str]) -> ms.Replica | None:
        """A degraded replica whose cooldown has elapsed and whose
        half-open probe slot this call just claimed — the router
        dispatches ONE real request to it and reports back through
        :meth:`observe`.  ``None`` when nothing is probe-ready."""
        self._prune_stale()
        for replica in self.membership.replicas:
            if replica.state != ms.DEGRADED \
                    or replica.replica_id in tried:
                continue
            with self._lock:
                entry = self._ejections.get(replica.replica_id)
            if entry is not None and entry["breaker"].allow():
                with self._lock:
                    entry["pending_probes"] += 1
                return replica
        return None

    def cancel_probe(self, replica: ms.Replica) -> None:
        """Release a probe slot whose dispatch never produced a latency
        (transport failure handled elsewhere, backpressure)."""
        with self._lock:
            entry = self._ejections.get(replica.replica_id)
            if entry is None:
                return
            if entry["pending_probes"] > 0:
                entry["pending_probes"] -= 1
        entry["breaker"].cancel_probe()

    def _probe_result(self, replica: ms.Replica, latency_ms: float,
                      ok: bool) -> None:
        with self._lock:
            entry = self._ejections.get(replica.replica_id)
            if entry is None:
                return
            if entry["pending_probes"] < 1:
                # Not a claimed probe: an in-flight request from BEFORE
                # the ejection draining out (possibly AFTER the cooldown
                # elapsed — the breaker's own state cannot tell them
                # apart).  It must neither restart the cooldown nor — if
                # it happens to be fast — short-circuit the re-admission
                # protocol.
                return
            entry["pending_probes"] -= 1
        breaker, threshold_ms = entry["breaker"], entry["threshold_ms"]
        if ok and latency_ms <= threshold_ms:
            breaker.record_success()  # half-open -> closed
            if self.membership.set_state(
                    replica, ms.LIVE,
                    f"readmitted: probe {latency_ms:.1f}ms <= "
                    f"{threshold_ms:.1f}ms", only_from=(ms.DEGRADED,)):
                with self._lock:
                    self._ejections.pop(replica.replica_id, None)
                    self.n_readmitted += 1
                self._journal.event("replica_readmitted",
                                    replica=replica.replica_id,
                                    probe_ms=round(latency_ms, 3),
                                    threshold_ms=round(threshold_ms, 3))
                self._journal.metrics.inc("replica_readmissions")
                logger.info("Re-admitted %s: probe %.1fms under the "
                            "%.1fms ejection threshold",
                            replica.replica_id, latency_ms, threshold_ms)
        else:
            # Still slow (or failed): re-open, restart the cooldown.
            breaker.record_failure()
            logger.info("Probe to degraded %s still slow (%.1fms > "
                        "%.1fms); cooldown restarts", replica.replica_id,
                        latency_ms, threshold_ms)

    def forget(self, replica: ms.Replica) -> None:
        """Drop ejection/latency state for a replica that left the fleet
        another way (marked OUT by a dead connection mid-probe) so a
        relaunch starts clean."""
        with self._lock:
            self._ejections.pop(replica.replica_id, None)
            self._lat.pop(replica.replica_id, None)

    # -- introspection -----------------------------------------------------
    def snapshot(self) -> dict:
        """The /healthz view: counters plus per-replica rolling stats."""
        self._prune_stale()
        with self._lock:
            stats = {rid: {"n": len(win),
                           "p50_ms": round(percentile(win, 0.50), 3),
                           "p95_ms": round(percentile(win, 0.95), 3)}
                     for rid, win in self._lat.items() if win}
            degraded = sorted(self._ejections)
        return {"k": self.k, "ejected": self.n_ejected,
                "readmitted": self.n_readmitted,
                "degraded": degraded, "replicas": stats}
