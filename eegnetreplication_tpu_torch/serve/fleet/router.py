"""Least-loaded dispatch over live replicas, with per-replica breakers.

The router turns N independent serving processes into one endpoint.  For
each request it picks the live replica with the lowest load (its own
in-flight count to that replica plus the queue depth the membership poll
last read from ``/healthz``), dispatches over a pooled keep-alive
connection, and feeds the outcome to that replica's
:class:`~eegnetreplication_tpu_torch.resil.breaker.CircuitBreaker`.

Failure semantics are what make a fleet more available than its members:

- **Transport failure** (connection refused/reset — the replica process
  died mid-request): the replica is pulled from membership immediately
  and the request is retried on a sibling.  Inference is pure, so the
  retry is safe; a kill-one-replica-under-load run completes with zero
  failed requests.
- **HTTP 5xx** from a replica counts against its breaker and fails over
  to a sibling; only when every live replica has failed does the client
  see the error.
- **HTTP 429** (replica queue full) is backpressure, not a fault: it
  does not trip the breaker, and the client gets 429 only when every
  live replica is saturated.
- **Open breaker** replicas are skipped during selection; half-open
  probe slots are claimed on the chosen replica only, immediately before
  its dispatch, so slots never leak.

Every failover is journaled as a ``fleet_retry`` event.  Dispatched
request bodies are kept in a small ring buffer — the rolling-canary
shadow compare replays exactly this captured live traffic.

Gray-failure defenses (both opt-in):

- **Latency-outlier ejection** — every completed attempt's latency feeds
  an :class:`~eegnetreplication_tpu_torch.serve.fleet.outlier.OutlierEjector`;
  ejected (``degraded``) replicas leave selection entirely and only see
  the ejector's half-open probe dispatches, claimed here in
  :meth:`FleetRouter._pick`.
- **Hedged dispatch** — with a :class:`HedgePolicy`, a first attempt that
  exceeds a quantile-derived delay fires ONE speculative attempt at a
  sibling; the first 200 wins and the loser is abandoned (its breaker
  bookkeeping reconciles via a done-callback).  A hard budget caps hedges
  at ``budget_fraction`` of dispatches so hedging can never amplify an
  overload (Dean & Barroso, "The Tail at Scale").  Every hedge is a
  ``hedge`` journal event.
"""

from __future__ import annotations

import http.client
import os
import threading
import time
from collections import deque
from concurrent.futures import (
    FIRST_COMPLETED,
    ThreadPoolExecutor,
    TimeoutError as FuturesTimeout,  # noqa: A004 — not builtins' on 3.10
    wait,
)
from dataclasses import dataclass

from eegnetreplication_tpu_torch.obs import journal as obs_journal
from eegnetreplication_tpu_torch.obs import trace
from eegnetreplication_tpu_torch.obs.stats import percentile
from eegnetreplication_tpu_torch.serve.fleet import membership as ms
from eegnetreplication_tpu_torch.utils.logging import logger


class NoLiveReplicas(RuntimeError):
    """No live replica could accept the request (the 503-shaped fleet
    signal — every member is out, draining, or breaker-open)."""


class AllReplicasBusy(RuntimeError):
    """Every live replica answered backpressure (the 429-shaped signal)."""


# Transport errors that mean "this process is gone", not "it is slow":
# these pull the replica from membership immediately instead of waiting
# for the health poller's consecutive-failure threshold.
_DEAD_CONNECTION = (ConnectionRefusedError, ConnectionResetError,
                    BrokenPipeError, http.client.BadStatusLine,
                    http.client.RemoteDisconnected)


@dataclass(frozen=True)
class HedgePolicy:
    """When and how aggressively to hedge a slow first attempt.

    The hedge delay is the ``quantile`` of the router's rolling window of
    successful dispatch latencies (clamped to ``[min_delay_ms,
    max_delay_ms]``) — "hedge once the attempt is slower than most
    requests", restated continuously from live traffic.  No hedging until
    ``min_samples`` latencies exist: a cold router has no idea what slow
    means.  ``budget_fraction`` is a HARD cap on extra dispatches
    (hedges / total dispatches), so a fleet-wide slowdown degrades into
    "no more hedges", never into a self-inflicted doubling of load.
    """

    quantile: float = 0.95
    budget_fraction: float = 0.05
    min_delay_ms: float = 1.0
    max_delay_ms: float = 1000.0
    min_samples: int = 20
    window: int = 256

    def __post_init__(self):
        if not 0.0 < self.quantile < 1.0:
            raise ValueError(f"quantile must be in (0, 1), got "
                             f"{self.quantile}")
        if not 0.0 < self.budget_fraction <= 0.5:
            raise ValueError(
                f"budget_fraction must be in (0, 0.5], got "
                f"{self.budget_fraction}")


class FleetRouter:
    """Dispatch requests across a :class:`~eegnetreplication_tpu_torch.serve.fleet.membership.FleetMembership`."""

    def __init__(self, membership: ms.FleetMembership, *,
                 predict_timeout_s: float = 60.0, journal=None,
                 ring_size: int = 128, outlier=None,
                 hedge: HedgePolicy | None = None):
        self.membership = membership
        self.predict_timeout_s = float(predict_timeout_s)
        self._journal = journal if journal is not None \
            else obs_journal.current()
        # Captured live traffic for the canary shadow compare: (body,
        # content_type) of recently dispatched requests.
        self._ring: deque[tuple[bytes, str]] = deque(maxlen=ring_size)
        self._ring_lock = threading.Lock()
        self._stats_lock = threading.Lock()
        self.n_dispatched = 0
        self.n_failovers = 0
        # Gray-failure defenses (opt-in): the latency-outlier ejector fed
        # by every completed attempt, and the hedging policy + its rolling
        # latency window (successful dispatches only — a fast 429 must
        # not shrink the hedge delay toward zero).
        self.outlier = outlier
        self.hedge = hedge
        self.n_hedges = 0
        self.n_hedge_wins = 0
        self._lat_lock = threading.Lock()
        self._lat_window: deque[float] = deque(
            maxlen=hedge.window if hedge is not None else 1)
        # Sized for dispatch concurrency, not just hedges: with hedging
        # on, every FIRST attempt runs here (the caller waits with the
        # hedge-delay timeout), so a small pool would cap fleet-wide
        # in-flight dispatches.  _attempt_hedged additionally refuses to
        # hedge a primary that never STARTED (pool saturated) — queue
        # wait must not masquerade as replica slowness.
        self._hedge_pool = (ThreadPoolExecutor(
            max_workers=max(64, 8 * (os.cpu_count() or 8)),
            thread_name_prefix="fleet-hedge")
            if hedge is not None else None)

    # -- shadow-traffic capture -------------------------------------------
    def recent_bodies(self, n: int) -> list[tuple[bytes, str]]:
        """Up to ``n`` most recently dispatched (body, content_type) pairs
        (newest first) — the canary's shadow-compare sample."""
        with self._ring_lock:
            items = list(self._ring)
        return items[::-1][:n]

    # -- dispatch ----------------------------------------------------------
    def _pick(self, tried: set[str],
              probes: bool = True) -> ms.Replica | None:
        """Least-loaded live replica not yet tried, with a non-open
        breaker.  Claims the breaker's admission (and half-open probe
        slot) on the CHOSEN replica only.

        With an outlier ejector attached, a ``degraded`` replica whose
        cooldown elapsed takes precedence: its claimed re-admission probe
        rides this real request (``probes=False`` suppresses that — a
        hedge must never speculate against a known-slow replica)."""
        if probes and self.outlier is not None:
            probe = self.outlier.claim_probe(tried)
            if probe is not None:
                if probe.breaker.allow():
                    return probe
                # Regular breaker refuses (failing AND slow): release the
                # ejector's probe slot and fall through to the live set.
                self.outlier.cancel_probe(probe)
                tried.add(probe.replica_id)
        while True:
            candidates = [r for r in self.membership.dispatchable()
                          if r.replica_id not in tried
                          and r.breaker.state != "open"]
            if not candidates:
                return None
            replica = min(candidates, key=lambda r: r.load)
            if replica.breaker.allow():
                return replica
            tried.add(replica.replica_id)  # open/probe-exhausted: skip

    def dispatch(self, body: bytes, content_type: str = "application/json",
                 headers: dict | None = None) -> tuple[int, bytes, str]:
        """Route one ``/predict`` body; returns ``(status, body,
        replica_id)``.  Raises :class:`NoLiveReplicas` /
        :class:`AllReplicasBusy` when the fleet cannot take it.

        Tracing: under an active trace context, the whole routing
        decision is one ``router.dispatch`` span; every failover retry is
        a ``router.retry`` CHILD span (replica + reason), and each
        attempt propagates ``X-Trace-Id``/``X-Parent-Span`` so the
        replica's spans parent onto the attempt that actually reached it.
        """
        with trace.span("router.dispatch", journal=self._journal) as sp:
            result = self._dispatch_traced(body, content_type,
                                           dict(headers or {}), sp)
        return result

    def _dispatch_traced(self, body: bytes, content_type: str,
                         send_headers: dict, sp) -> tuple[int, bytes, str]:
        send_headers["Content-Type"] = content_type
        with self._ring_lock:
            self._ring.append((body, content_type))
        with self._stats_lock:
            self.n_dispatched += 1
        tried: set[str] = set()
        last_busy: tuple[int, bytes, str] | None = None
        last_error: tuple[int, bytes, str] | None = None
        attempt = 0
        while True:
            replica = self._pick(tried)
            if replica is None:
                if last_busy is not None:
                    raise AllReplicasBusy(
                        "every live replica answered backpressure")
                if last_error is not None:
                    return last_error  # every live replica failed: honest 5xx
                raise NoLiveReplicas("no live replicas in the fleet")
            tried.add(replica.replica_id)
            if attempt == 0 and self.hedge is not None:
                outcome, replica = self._attempt_hedged(
                    replica, body, send_headers, tried)
            else:
                outcome = self._attempt(replica, body, send_headers,
                                        attempt)
            attempt += 1
            if outcome[0] == "transport":
                continue
            status, data = outcome[1], outcome[2]
            if status == 429:
                # Backpressure is not a fault: release any half-open probe
                # slot allow() claimed (no outcome will be recorded) and
                # try a sibling.  An ejector probe slot releases the same
                # way — a busy degraded replica told us nothing about its
                # latency.
                replica.breaker.cancel_probe()
                if self.outlier is not None:
                    self.outlier.cancel_probe(replica)
                last_busy = (status, data, replica.replica_id)
                continue
            if status >= 500:
                replica.breaker.record_failure()
                last_error = (status, data, replica.replica_id)
                self._failover(replica, f"http {status}")
                continue
            replica.breaker.record_success()
            if sp is not None:
                sp.set(replica=replica.replica_id, attempts=attempt)
            return status, data, replica.replica_id

    def _attempt(self, replica: ms.Replica, body: bytes,
                 send_headers: dict, attempt: int):
        """One dispatch attempt.  Failover attempts (> 0) are traced as
        ``router.retry`` child spans; every attempt carries the trace
        propagation headers with the CURRENT span as the parent, so the
        replica's tree hangs off the attempt that reached it."""
        def run():
            replica.begin()
            t0 = time.perf_counter()
            try:
                status, data = replica.client.request(
                    "POST", "/predict", body=body,
                    headers={**send_headers, **trace.headers()},
                    timeout_s=self.predict_timeout_s)
            except (OSError, http.client.HTTPException) as exc:
                replica.breaker.record_failure()
                if self.outlier is not None:
                    # A failed probe must re-open the ejection breaker
                    # (observed while the replica is still DEGRADED) —
                    # and a replica pulled OUT below forgets its ejection
                    # record entirely so a relaunch starts clean.
                    self.outlier.observe(replica, float("inf"), ok=False)
                if isinstance(exc, _DEAD_CONNECTION):
                    self.membership.mark_unreachable(
                        replica, f"dispatch: {type(exc).__name__}")
                    if self.outlier is not None:
                        self.outlier.forget(replica)
                self._failover(replica, f"{type(exc).__name__}: {exc}")
                return ("transport", None, None)
            finally:
                replica.done()
            latency_ms = (time.perf_counter() - t0) * 1000.0
            self._observe_latency(replica, status, latency_ms)
            return ("http", status, data)

        if attempt == 0 or trace.current() is None:
            return run()
        with trace.span("router.retry", journal=self._journal,
                        replica=replica.replica_id, attempt=attempt) as sp:
            outcome = run()
            # run() converts failures into return values (the failover
            # loop's contract), so no exception reaches the span: mark
            # failed attempts explicitly or every retry reads "ok" in
            # the waterfall.
            if sp is not None and (outcome[0] == "transport"
                                   or (outcome[1] or 0) >= 500):
                sp.status = "error"
            return outcome

    def _observe_latency(self, replica: ms.Replica, status: int,
                         latency_ms: float) -> None:
        """Feed one completed attempt into the gray-failure machinery:
        the ejector's per-replica window (or probe verdict) and, for
        successful dispatches, the hedge-delay latency window."""
        if self.outlier is not None:
            if status == 200:
                self.outlier.observe(replica, latency_ms, ok=True)
            elif status >= 500:
                self.outlier.observe(replica, latency_ms, ok=False)
            elif replica.state == ms.DEGRADED:
                # A 4xx probe (parse error on the probe body, 429 handled
                # by the dispatch loop) proves nothing about latency:
                # release the slot rather than judging it.
                self.outlier.cancel_probe(replica)
        if self.hedge is not None and status == 200:
            with self._lat_lock:
                self._lat_window.append(latency_ms)

    # -- hedged dispatch ---------------------------------------------------
    def _hedge_delay_s(self) -> float | None:
        """Quantile-derived hedge delay, or ``None`` while the latency
        window is too cold to define "slow"."""
        with self._lat_lock:
            if len(self._lat_window) < self.hedge.min_samples:
                return None
            lat = list(self._lat_window)
        ms_delay = percentile(lat, self.hedge.quantile)
        return min(max(ms_delay, self.hedge.min_delay_ms),
                   self.hedge.max_delay_ms) / 1000.0

    def _consume_hedge_budget(self) -> bool:
        """Atomically claim one hedge against the hard budget."""
        with self._stats_lock:
            if (self.n_hedges + 1
                    > self.hedge.budget_fraction * self.n_dispatched):
                return False
            self.n_hedges += 1
            return True

    @staticmethod
    def _reconcile_loser(replica: ms.Replica):
        """Done-callback for an abandoned hedge attempt: its breaker
        bookkeeping still has to happen even though nobody is waiting for
        the result (transport failures already reconciled inside
        ``_attempt``)."""
        def cb(fut):
            outcome = fut.result()  # _attempt never raises
            if outcome[0] != "http":
                return
            if outcome[1] == 429:
                replica.breaker.cancel_probe()
            elif outcome[1] >= 500:
                replica.breaker.record_failure()
            elif outcome[1] == 200:
                replica.breaker.record_success()
        return cb

    def _attempt_hedged(self, primary: ms.Replica, body: bytes,
                        send_headers: dict, tried: set[str]
                        ) -> tuple[tuple, ms.Replica]:
        """First attempt under the hedging policy.

        Runs the primary attempt; if it exceeds the quantile-derived
        delay and the budget admits one, fires a single speculative
        attempt at a sibling.  First 200 wins; the loser is abandoned
        (its thread finishes on its own, bookkeeping via done-callback).
        Returns ``(outcome, replica_that_produced_it)`` so the failover
        loop's post-processing credits the right breaker.
        """
        delay_s = self._hedge_delay_s()
        if delay_s is None:
            return self._attempt(primary, body, send_headers, 0), primary
        ctx = trace.current()
        primary_started = threading.Event()

        def call(replica, started=None):
            if started is not None:
                started.set()
            if ctx is None:
                return self._attempt(replica, body, send_headers, 0)
            # Pool threads do not inherit contextvars: re-enter the
            # request's trace so propagation headers stay correct.
            with trace.use(ctx):
                return self._attempt(replica, body, send_headers, 0)

        primary_f = self._hedge_pool.submit(call, primary, primary_started)
        try:
            return primary_f.result(timeout=delay_s), primary
        except FuturesTimeout:
            pass
        if not primary_started.is_set():
            # The attempt never even reached a replica — the pool is
            # saturated, which is OUR overload, not the primary's
            # slowness.  Hedging here would amplify exactly the load
            # that caused it.
            return primary_f.result(), primary
        # The primary is officially slow.  One speculative sibling, iff a
        # live (never degraded-probe) sibling exists AND the hard budget
        # admits one — in that order, so a hedge-less fleet never burns
        # budget it cannot spend.
        sibling = self._pick(tried, probes=False)
        if sibling is None or not self._consume_hedge_budget():
            if sibling is not None:
                sibling.breaker.cancel_probe()  # release _pick's claim
            return primary_f.result(), primary
        tried.add(sibling.replica_id)
        t_hedge = time.perf_counter()
        hedge_f = self._hedge_pool.submit(call, sibling)
        futures = {primary_f: primary, hedge_f: sibling}
        pending = set(futures)
        winner: tuple[tuple, ms.Replica] | None = None
        while pending and winner is None:
            done, pending = wait(pending, return_when=FIRST_COMPLETED)
            for fut in done:
                outcome = fut.result()
                if outcome[0] == "http" and outcome[1] == 200:
                    winner = (outcome, futures[fut])
                    break
        if winner is not None:
            won_by_hedge = winner[1] is sibling
            if won_by_hedge:
                with self._stats_lock:
                    self.n_hedge_wins += 1
            loser_f = primary_f if won_by_hedge else hedge_f
            # add_done_callback fires immediately on an already-done
            # future, so the loser's bookkeeping happens exactly once
            # whether it finished before or after the winner.
            loser_f.add_done_callback(
                self._reconcile_loser(futures[loser_f]))
            self._journal.event(
                "hedge", primary=primary.replica_id,
                hedge=sibling.replica_id,
                winner="hedge" if won_by_hedge else "primary",
                delay_ms=round(delay_s * 1000.0, 3),
                hedge_wait_ms=round(
                    (time.perf_counter() - t_hedge) * 1000.0, 3))
            self._journal.metrics.inc("hedges_fired")
            if won_by_hedge:
                self._journal.metrics.inc("hedges_won")
            return winner
        # Neither attempt produced a 200 (both futures are done here).
        # Return the outcome the failover loop can CLASSIFY: an "http"
        # outcome (429 must set last_busy, a 5xx must set last_error +
        # failover) beats a bare transport failure — blindly preferring
        # the primary's transport outcome would erase a sibling's
        # backpressure answer and misreport a busy fleet as
        # NoLiveReplicas.  Among equals the primary wins.  The
        # NON-returned attempt's breaker bookkeeping still has to
        # happen, so reconcile it inline.
        candidates = [(primary_f.result(), primary),
                      (hedge_f.result(), sibling)]
        fallback = max(candidates,
                       key=lambda item: (item[0][0] == "http",
                                         item[1] is primary))
        other_f = hedge_f if fallback[1] is primary else primary_f
        self._reconcile_loser(futures[other_f])(other_f)
        self._journal.event("hedge", primary=primary.replica_id,
                            hedge=sibling.replica_id, winner="none",
                            delay_ms=round(delay_s * 1000.0, 3))
        self._journal.metrics.inc("hedges_fired")
        return fallback

    def close(self) -> None:
        """Release the hedge executor (idempotent; abandoned attempts
        are not waited for — their sockets time out on their own)."""
        if self._hedge_pool is not None:
            self._hedge_pool.shutdown(wait=False)

    def dispatch_to(self, replica: ms.Replica, body: bytes,
                    content_type: str = "application/json",
                    timeout_s: float | None = None) -> tuple[int, bytes]:
        """Direct dispatch to ONE replica (no failover, no breaker) — the
        canary shadow compare uses this to ask a specific member."""
        return replica.client.request(
            "POST", "/predict", body=body,
            headers={"Content-Type": content_type},
            timeout_s=timeout_s if timeout_s is not None
            else self.predict_timeout_s)

    def _failover(self, replica: ms.Replica, reason: str) -> None:
        with self._stats_lock:
            self.n_failovers += 1
        self._journal.event("fleet_retry", replica=replica.replica_id,
                            reason=reason[:200])
        self._journal.metrics.inc("fleet_failovers")
        logger.warning("Fleet dispatch failover off %s: %s",
                       replica.replica_id, reason)

    # -- maintenance -------------------------------------------------------
    def wait_idle(self, timeout_s: float = 30.0) -> bool:
        """Block until no dispatches are in flight (drain helper)."""
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            if all(r.inflight == 0 for r in self.membership.replicas):
                return True
            time.sleep(0.02)
        return False
