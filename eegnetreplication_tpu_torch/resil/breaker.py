"""Circuit breaker: fail fast while a dependency is down, probe to recover.

The port's copy of ``eegnetreplication_tpu/resil/breaker.py``.

The serving retry policy (``serve/service.py``) handles a *transient*
forward failure; when the forward is persistently broken (wedged device,
poisoned model push) every request still pays queueing plus a full retry
budget before its 500 — under load that converts one fault into a
saturated queue of slow failures.  The breaker watches consecutive
dispatch outcomes: ``failure_threshold`` consecutive failures OPEN it
(callers are refused instantly — the HTTP layer answers 503 before the
request is even enqueued); after ``reset_after_s`` it becomes HALF_OPEN
and admits up to ``half_open_probes`` probe calls — one success closes
it, one failure re-opens it and restarts the cooldown.  Every transition
is journaled as a ``circuit_state`` event.

Generic on purpose (nothing serve-specific): any dispatch-shaped call
site can wrap one around its failure domain.
"""

from __future__ import annotations

import threading
import time

from eegnetreplication_tpu_torch.utils.logging import logger

CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half_open"


class CircuitOpen(RuntimeError):
    """The call was refused without being attempted (breaker open)."""


class CircuitBreaker:
    """Consecutive-failure breaker with half-open probing (thread-safe).

    ``allow()`` is the admission gate; ``record_success``/``record_failure``
    feed it outcomes from wherever the protected call actually runs (the
    serve batcher worker, which may be a different thread than the
    admitting handler).
    """

    def __init__(self, *, failure_threshold: int = 5,
                 reset_after_s: float = 30.0, half_open_probes: int = 1,
                 site: str = "serve.forward", journal=None,
                 clock=time.monotonic):
        if failure_threshold < 1:
            raise ValueError(
                f"failure_threshold must be >= 1, got {failure_threshold}")
        if half_open_probes < 1:
            raise ValueError(
                f"half_open_probes must be >= 1, got {half_open_probes}")
        self.failure_threshold = int(failure_threshold)
        self.reset_after_s = float(reset_after_s)
        self.half_open_probes = int(half_open_probes)
        self.site = site
        self._journal = journal
        self._clock = clock
        self._lock = threading.Lock()
        self._state = CLOSED
        self._consecutive_failures = 0
        self._opened_at = 0.0
        self._probes_in_flight = 0
        self._trips = 0  # times the breaker transitioned to OPEN

    # -- introspection ----------------------------------------------------
    @property
    def state(self) -> str:
        with self._lock:
            self._maybe_half_open()
            return self._state

    @property
    def trips(self) -> int:
        with self._lock:
            return self._trips

    # -- admission + outcomes ---------------------------------------------
    def allow(self) -> bool:
        """Whether a call may proceed right now (claims a probe slot when
        half-open)."""
        with self._lock:
            self._maybe_half_open()
            if self._state == CLOSED:
                return True
            if self._state == OPEN:
                return False
            if self._probes_in_flight >= self.half_open_probes:
                return False
            self._probes_in_flight += 1
            return True

    def cancel_probe(self) -> None:
        """Release a probe slot claimed by :meth:`allow` when the call was
        never attempted (queue rejected it, request was malformed) — the
        slot must not leak or half-open starves."""
        with self._lock:
            if self._state == HALF_OPEN and self._probes_in_flight > 0:
                self._probes_in_flight -= 1

    def record_success(self) -> None:
        with self._lock:
            self._consecutive_failures = 0
            if self._state == HALF_OPEN:
                self._probes_in_flight = 0
                self._transition(CLOSED, reason="probe_succeeded")

    def record_failure(self) -> None:
        with self._lock:
            self._consecutive_failures += 1
            if self._state == HALF_OPEN:
                self._probes_in_flight = 0
                self._opened_at = self._clock()
                self._transition(OPEN, reason="probe_failed")
            elif (self._state == CLOSED
                  and self._consecutive_failures >= self.failure_threshold):
                self._opened_at = self._clock()
                self._transition(OPEN, reason="failure_threshold")

    # -- internals (lock held) --------------------------------------------
    def _maybe_half_open(self) -> None:
        if (self._state == OPEN
                and self._clock() - self._opened_at >= self.reset_after_s):
            self._probes_in_flight = 0
            self._transition(HALF_OPEN, reason="cooldown_elapsed")

    def _transition(self, new_state: str, reason: str) -> None:
        previous, self._state = self._state, new_state
        if new_state == OPEN:
            self._trips += 1
        from eegnetreplication_tpu_torch.obs import journal as obs_journal

        jr = self._journal if self._journal is not None \
            else obs_journal.current()
        jr.event("circuit_state", state=new_state, previous=previous,
                 reason=reason, site=self.site,
                 consecutive_failures=self._consecutive_failures)
        jr.metrics.inc("circuit_transitions", state=new_state)
        log = logger.warning if new_state == OPEN else logger.info
        log("Circuit %s: %s -> %s (%s; %d consecutive failure(s))",
            self.site, previous, new_state, reason,
            self._consecutive_failures)
