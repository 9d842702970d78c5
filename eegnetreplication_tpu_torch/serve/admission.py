"""Adaptive overload control: AIMD admission instead of a static cliff.

The port's copy of ``eegnetreplication_tpu/serve/admission.py``.  With
``--admissionTargetMs`` above 0, :class:`AdmissionController` owns a live
admission limit (in queued trials) between one full bucket and the hard
``--maxQueue`` bound, moved by AIMD against the queue-wait p95 of the last
``interval_s``: above the target it halves (``backoff``), well below it
it grows by ``increase``.  Every move journals ``admission_change``.

Shedding is two-class: the batcher applies the adaptive limit to bulk
``/predict`` traffic only; priority traffic (session windows,
``X-Priority``) meets only the hard bound.  A shed raises
:class:`~eegnetreplication_tpu_torch.serve.batcher.Shed` (429, status
``shed``), counts ``requests_shed`` and journals a throttled ``shed``
event.  With a target of 0 (the default) there is no controller and the
static bound behaves as before.
"""

from __future__ import annotations

import threading
import time
from collections import deque

from eegnetreplication_tpu_torch.obs import journal as obs_journal
from eegnetreplication_tpu_torch.obs.stats import percentile
from eegnetreplication_tpu_torch.utils.logging import logger

# At most one `shed` journal event per this many seconds: under a flood
# the journal must record that (and how much) shedding happened, not one
# line per refused request.
SHED_JOURNAL_INTERVAL_S = 0.25


class ArrivalWindow:
    """Rolling-window arrival-rate meter (thread-safe).

    The one load signal an autoscaler cannot derive from completions is
    *offered* load — how much work arrived, including work that was shed
    or bounced.  This measures it: :meth:`record` stamps each arrival,
    :meth:`rate` reports events/second over the trailing ``window_s``.
    The admission controller records every bulk :meth:`~AdmissionController.admit`
    consult into one (exported on its snapshot), and the fleet tier
    records router-edge dispatches into another — the window the
    autoscaler's control loop reads.
    """

    def __init__(self, window_s: float = 5.0, clock=time.monotonic):
        if window_s <= 0:
            raise ValueError(f"window_s must be > 0, got {window_s}")
        self.window_s = float(window_s)
        self._clock = clock
        self._events: deque[tuple[float, int]] = deque()
        self._lock = threading.Lock()

    def record(self, n: int = 1) -> None:
        now = self._clock()
        with self._lock:
            self._events.append((now, int(n)))
            self._prune(now)

    def _prune(self, now: float) -> None:
        horizon = now - self.window_s
        while self._events and self._events[0][0] < horizon:
            self._events.popleft()

    def rate(self) -> float:
        """Arrivals per second over the trailing window.  Measured over
        the FULL window (not the observed span), so a burst that just
        started reads as a low-but-rising rate instead of a spike."""
        now = self._clock()
        with self._lock:
            self._prune(now)
            total = sum(n for _, n in self._events)
        return total / self.window_s

    def count(self) -> int:
        now = self._clock()
        with self._lock:
            self._prune(now)
            return sum(n for _, n in self._events)


class AdmissionController:
    """AIMD admitted-queue-depth limit driven by observed queue wait.

    Thread-safe; wired into :class:`~eegnetreplication_tpu_torch.serve.batcher.MicroBatcher`:
    ``submit`` consults :meth:`admit`, the worker feeds :meth:`observe_wait`
    at every dequeue.
    """

    def __init__(self, *, target_wait_ms: float, min_limit: int,
                 max_limit: int, increase: int | None = None,
                 backoff: float = 0.5, interval_s: float = 0.25,
                 journal=None, clock=time.monotonic):
        if target_wait_ms <= 0:
            raise ValueError(
                f"target_wait_ms must be > 0, got {target_wait_ms}")
        if not 1 <= min_limit <= max_limit:
            raise ValueError(
                f"need 1 <= min_limit <= max_limit, got "
                f"{min_limit}/{max_limit}")
        if not 0.0 < backoff < 1.0:
            raise ValueError(f"backoff must be in (0, 1), got {backoff}")
        self.target_wait_ms = float(target_wait_ms)
        self.min_limit = int(min_limit)
        self.max_limit = int(max_limit)
        # Default additive step: one min_limit (≈ one full bucket) per
        # interval.  Conservative on purpose — the additive half of AIMD
        # must probe BELOW the service rate's backlog equilibrium, not
        # leap past it; a span-proportional step re-overshoots a deep
        # queue bound every climb and turns the controller into a
        # sawtooth between "shed everything" and "400 ms of queue".
        self.increase = (int(increase) if increase is not None
                         else max(1, self.min_limit))
        self.backoff = float(backoff)
        self.interval_s = float(interval_s)
        self._journal = journal if journal is not None \
            else obs_journal.current()
        self._clock = clock
        self._lock = threading.Lock()
        # Optimistic start at the hard cap: the first overloaded interval
        # backs it off; an unloaded service never sheds at all.
        self._limit = float(self.max_limit)
        self._waits_ms: list[float] = []
        self._next_adjust = self._clock() + self.interval_s
        self.n_shed = 0
        self.n_changes = 0
        self._last_shed_journal = 0.0
        self._shed_since_journal = 0
        # Offered bulk load in trials/s — measured at the admit() consult,
        # BEFORE the verdict, so shed traffic still counts.  Exported on
        # snapshot() (and thus /healthz) for the fleet autoscaler.
        self.arrivals = ArrivalWindow(clock=clock)

    @property
    def limit(self) -> int:
        with self._lock:
            return int(self._limit)

    # -- admission (batcher submit path) -----------------------------------
    def admit(self, pending_trials: int, n_new: int) -> bool:
        """Whether a BULK request of ``n_new`` trials may join a queue of
        ``pending_trials`` under the current adaptive limit (the hard
        ``max_limit`` cliff is the batcher's own check, applied to every
        class)."""
        self.arrivals.record(n_new)
        with self._lock:
            return pending_trials + n_new <= int(self._limit)

    def record_shed(self) -> None:
        """One bulk request refused under the adaptive limit."""
        journal_now = None
        with self._lock:
            self.n_shed += 1
            self._shed_since_journal += 1
            now = self._clock()
            if now - self._last_shed_journal >= SHED_JOURNAL_INTERVAL_S:
                journal_now = (self._shed_since_journal, int(self._limit))
                self._last_shed_journal = now
                self._shed_since_journal = 0
        self._journal.metrics.inc("requests_shed")
        if journal_now is not None:
            self._journal.event("shed", n_shed=journal_now[0],
                                total_shed=self.n_shed,
                                limit=journal_now[1])

    # -- the AIMD loop (batcher worker path) -------------------------------
    def observe_wait(self, wait_ms: float) -> None:
        """One request's observed queue wait at dequeue; runs the AIMD
        step when the interval has elapsed."""
        adjust = None
        with self._lock:
            self._waits_ms.append(float(wait_ms))
            now = self._clock()
            if now < self._next_adjust:
                return
            self._next_adjust = now + self.interval_s
            waits, self._waits_ms = self._waits_ms, []
            p95 = percentile(waits, 0.95)
            old = int(self._limit)
            if p95 > self.target_wait_ms:
                self._limit = max(float(self.min_limit),
                                  self._limit * self.backoff)
                reason = "backoff"
            elif p95 < 0.5 * self.target_wait_ms \
                    and self._limit < self.max_limit:
                self._limit = min(float(self.max_limit),
                                  self._limit + self.increase)
                reason = "increase"
            else:
                return  # inside the comfort band: hold
            new = int(self._limit)
            if new == old:
                return
            self.n_changes += 1
            adjust = (old, new, reason, p95)
        old, new, reason, p95 = adjust
        self._journal.event("admission_change", old_limit=old,
                            new_limit=new, reason=reason,
                            wait_p95_ms=round(p95, 3),
                            target_wait_ms=self.target_wait_ms)
        self._journal.metrics.set("admission_limit_trials", new)
        log = logger.warning if reason == "backoff" else logger.info
        log("Admission limit %s: %d -> %d trials (queue-wait p95 "
            "%.1fms vs target %.1fms)", reason, old, new, p95,
            self.target_wait_ms)

    def arrival_rate(self) -> float:
        """Measured offered bulk load, trials/s over the rolling window."""
        return self.arrivals.rate()

    def snapshot(self) -> dict:
        """The /healthz view of the controller."""
        rate = self.arrivals.rate()
        with self._lock:
            return {"limit_trials": int(self._limit),
                    "target_wait_ms": self.target_wait_ms,
                    "min_limit": self.min_limit,
                    "max_limit": self.max_limit,
                    "shed": self.n_shed, "changes": self.n_changes,
                    "arrival_trials_per_s": round(rate, 3)}
