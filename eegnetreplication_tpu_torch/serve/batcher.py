"""Dynamic micro-batching: coalesce concurrent requests into one forward.

The core of ``eegnetreplication_tpu/serve/batcher.py``.  A bounded FIFO of
in-flight requests; one worker thread coalesces whatever is queued — up to
``max_batch`` trials, waiting at most ``max_wait_ms`` from the *oldest*
queued request so a lone request is never parked — runs ONE inference over
the concatenation, and scatters the rows back to per-request futures in
dequeue order.  A request too big for the rest of a batch is skipped in
order (later ones that fit ride along) and leads the next batch.

Backpressure is explicit: a request that would push the queue past
``max_queue_trials`` raises :class:`Rejected` at once (HTTP 429).  The
port has no adaptive admission yet, so that hard cliff is the only limit,
for priority (session) traffic as for bulk.  A
request whose deadline passed while it was queued is dropped at dequeue
with :class:`DeadlineExceeded` (HTTP 504) before its forward runs.

Multi-tenant batching (``tenant_aware=True``): every request carries a
tenant index (its model in the zoo), the queue splits per tenant, and the
coalescing takes one request from each pending tenant in turn until the
batch is full, so a cold tenant's lone request rides the next batch
however deep a hot tenant's backlog is.  The batch mixes tenants, and
``infer_fn(trials, tenants)`` gets the per-trial tenant vector.  With one
tenant the order is the plain FIFO above, and with ``tenant_aware`` off
``infer_fn(trials)`` is called as before.

Adaptive admission, heartbeats and trace spans of the JAX batcher arrive
with the slices that port those subsystems.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from concurrent.futures import Future
from typing import Callable

import numpy as np

from eegnetreplication_tpu_torch.utils.logging import logger

# How long close() waits for the worker to drain the queue.
DRAIN_TIMEOUT_S = 30.0


class Rejected(RuntimeError):
    """The request was refused without being enqueued (queue full or
    shutting down) — the 429-shaped signal."""


class DeadlineExceeded(RuntimeError):
    """The request's deadline expired before its forward ran — the
    504-shaped signal."""


class MicroBatcher:
    """Bounded request queue + one coalescing inference worker.

    ``infer_fn(trials) -> predictions`` is called with the concatenated
    ``(n, C, T)`` batch from the worker thread only; an exception from it
    fails exactly the requests in that batch.
    """

    def __init__(self, infer_fn: Callable[..., np.ndarray], *,
                 max_batch: int = 128, max_wait_ms: float = 5.0,
                 max_queue_trials: int = 512, tenant_aware: bool = False):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        if max_queue_trials < max_batch:
            raise ValueError(
                f"max_queue_trials ({max_queue_trials}) must be >= "
                f"max_batch ({max_batch})")
        self._infer_fn = infer_fn
        self.tenant_aware = bool(tenant_aware)
        self.max_batch = int(max_batch)
        self.max_wait_s = float(max_wait_ms) / 1000.0
        self.max_queue_trials = int(max_queue_trials)
        self._cv = threading.Condition()
        # One FIFO per tenant of entries (trials, future, t_enqueued,
        # deadline-or-None, tenant), the deadline a time.monotonic()
        # instant; ``_rr`` is the round-robin ring the coalescing walks.
        self._queues: dict[int, deque] = {}
        self._rr: deque[int] = deque()
        self._pending_trials = 0
        self._closed = False
        # Coalesced forwards dispatched so far (read by /healthz).
        self.batches = 0
        self._worker = threading.Thread(target=self._run,
                                        name="serve-batcher", daemon=True)
        self._worker.start()

    # -- client side ------------------------------------------------------
    @property
    def queue_depth(self) -> int:
        """Trials currently enqueued (not yet handed to the worker)."""
        with self._cv:
            return self._pending_trials

    def submit(self, trials: np.ndarray,
               deadline: float | None = None, priority: bool = False,
               tenant: int = 0) -> Future:
        """Enqueue ``(n, C, T)`` trials; the future resolves to their
        ``(n,)`` predictions.  Raises :class:`Rejected` when the queue is
        full or the batcher is closed.  ``deadline`` (a ``time.monotonic()``
        instant) drops the request at dequeue once passed.  ``priority``
        marks session traffic, which the JAX batcher exempts from its
        adaptive admission limit; only the ``max_queue_trials`` cliff
        applies to it, as to every request here.  ``tenant`` indexes the
        request's model in a zoo (a ``tenant_aware`` batcher only)."""
        x = np.asarray(trials, np.float32)
        if x.ndim == 2:
            x = x[None]
        tenant = int(tenant)
        if tenant != 0 and not self.tenant_aware:
            raise ValueError(
                f"tenant {tenant} submitted to a single-tenant batcher "
                "(construct with tenant_aware=True for zoo serving)")
        if tenant < 0:
            raise ValueError(f"tenant must be >= 0, got {tenant}")
        fut: Future = Future()
        n = len(x)
        if n == 0:
            fut.set_result(np.zeros(0, np.int64))
            return fut
        with self._cv:
            if self._closed:
                raise Rejected("serving is shutting down")
            if self._pending_trials + n > self.max_queue_trials:
                raise Rejected(
                    f"queue full ({self._pending_trials} trials pending, "
                    f"limit {self.max_queue_trials})")
            q = self._queues.get(tenant)
            if q is None:
                q = self._queues[tenant] = deque()
                self._rr.append(tenant)
            q.append((x, fut, time.perf_counter(), deadline, tenant))
            self._pending_trials += n
            self._cv.notify_all()
        return fut

    def close(self, drain: bool = True) -> None:
        """Stop accepting; drain (default) or fail what is queued, then
        join the worker.  Idempotent."""
        with self._cv:
            self._closed = True
            if not drain:
                for q in self._queues.values():
                    while q:
                        fut = q.popleft()[1]
                        fut.set_exception(
                            Rejected("serving is shutting down"))
                self._queues.clear()
                self._rr.clear()
                self._pending_trials = 0
            self._cv.notify_all()
        if self._worker is not threading.current_thread():
            self._worker.join(DRAIN_TIMEOUT_S)
            if self._worker.is_alive():
                logger.warning("Batcher worker did not drain within %.1fs",
                               DRAIN_TIMEOUT_S)

    # -- worker side ------------------------------------------------------
    def _take_batch(self) -> list[tuple] | None:
        """Block for work, honor the coalescing window, pop one batch of
        ``(trials, future, tenant)``; ``None`` once closed and drained.
        Expired requests are failed here, outside the lock, before any
        forward."""
        expired: list[Future] = []
        try:
            with self._cv:
                while not any(self._queues.values()):
                    if self._closed:
                        return None
                    self._cv.wait(0.05)
                return self._coalesce_locked(expired)
        finally:
            for fut in expired:
                if not fut.cancelled():
                    fut.set_exception(DeadlineExceeded(
                        "request deadline expired while queued; dropped "
                        "before inference"))

    def _pop_fit_locked(self, q: deque, now: float, expired: list,
                        parked: list, batch_empty: bool, n: int):
        """The first entry of one tenant's queue that fits what is left of
        the batch.  Expired entries drop; misfits go onto ``parked`` for
        the rest of this pass (the room only shrinks).  ``None`` when
        nothing in the queue fits."""
        while q:
            entry = q.popleft()
            x, fut, _, deadline, _ = entry
            if deadline is not None and now >= deadline:
                self._pending_trials -= len(x)
                expired.append(fut)
                continue
            if not batch_empty and n + len(x) > self.max_batch:
                parked.append(entry)   # a later, smaller request may fit
                continue
            return entry
        return None

    def _coalesce_locked(self, expired: list[Future]) -> list[tuple]:
        # Wait until max_batch trials are queued or max_wait has elapsed
        # since the OLDEST pending request.
        wait_until = min(q[0][2] for q in self._queues.values() if q) \
            + self.max_wait_s
        while self._pending_trials < self.max_batch and not self._closed:
            remaining = wait_until - time.perf_counter()
            if remaining <= 0:
                break
            self._cv.wait(remaining)
        # One request of each pending tenant per turn of the ring (its
        # rotation carries over to the next batch) until the batch fills
        # or nothing more fits; one tenant is a FIFO scan.
        batch: list[tuple] = []
        parked: dict[int, list] = {}
        n = 0
        now = time.monotonic()
        while n < self.max_batch:
            progressed = False
            for _ in range(len(self._rr)):
                tenant = self._rr[0]
                self._rr.rotate(-1)
                q = self._queues.get(tenant)
                if not q:
                    continue
                entry = self._pop_fit_locked(
                    q, now, expired, parked.setdefault(tenant, []),
                    not batch, n)
                if entry is None:
                    continue
                batch.append((entry[0], entry[1], entry[4]))
                n += len(entry[0])
                progressed = True
                if n >= self.max_batch:
                    break
            if not progressed:
                break
        # Skipped entries return to the front in their original order.
        for tenant, entries in parked.items():
            if entries:
                self._queues[tenant].extendleft(reversed(entries))
        for tenant in [t for t, q in self._queues.items() if not q]:
            del self._queues[tenant]
            self._rr.remove(tenant)
        self._pending_trials -= n
        return batch

    def _run(self) -> None:
        while True:
            batch = self._take_batch()
            if batch is None:
                return
            if not batch:   # every queued request expired
                continue
            xs = [x for x, _, _ in batch]
            x = np.concatenate(xs) if len(xs) > 1 else xs[0]
            try:
                if self.tenant_aware:
                    # The per-trial tenant vector, row-aligned with x.
                    tenants = np.concatenate(
                        [np.full(len(bx), t, np.int32)
                         for bx, _, t in batch])
                    preds = np.asarray(self._infer_fn(x, tenants))
                else:
                    preds = np.asarray(self._infer_fn(x))
            except Exception as exc:  # noqa: BLE001 — routed to futures
                logger.warning("Batch of %d trials failed: %s: %s", len(x),
                               type(exc).__name__, exc)
                for _, fut, _ in batch:
                    if not fut.cancelled():
                        fut.set_exception(exc)
                continue
            self.batches += 1
            off = 0
            for bx, fut, _ in batch:
                k = len(bx)
                if not fut.cancelled():
                    fut.set_result(preds[off:off + k])
                off += k
