"""Dynamic micro-batching: coalesce concurrent requests into one forward.

The core of ``eegnetreplication_tpu/serve/batcher.py``.  A bounded FIFO of
in-flight requests; one worker thread coalesces whatever is queued — up to
``max_batch`` trials, waiting at most ``max_wait_ms`` from the *oldest*
queued request so a lone request is never parked — runs ONE inference over
the concatenation, and scatters the rows back to per-request futures in
dequeue order.  A request too big for the rest of a batch is skipped in
order (later ones that fit ride along) and leads the next batch.

Backpressure is explicit: a request that would push the queue past
``max_queue_trials`` raises :class:`Rejected` at once (HTTP 429).  A
request whose deadline passed while it was queued is dropped at dequeue
with :class:`DeadlineExceeded` (HTTP 504) before its forward runs.

Multi-tenant fairness, adaptive admission, heartbeats and trace spans of
the JAX batcher arrive with the slices that port those subsystems.
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

    def __init__(self, infer_fn: Callable[[np.ndarray], np.ndarray], *,
                 max_batch: int = 128, max_wait_ms: float = 5.0,
                 max_queue_trials: int = 512):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        if max_queue_trials < max_batch:
            raise ValueError(
                f"max_queue_trials ({max_queue_trials}) must be >= "
                f"max_batch ({max_batch})")
        self._infer_fn = infer_fn
        self.max_batch = int(max_batch)
        self.max_wait_s = float(max_wait_ms) / 1000.0
        self.max_queue_trials = int(max_queue_trials)
        self._cv = threading.Condition()
        # Entries: (trials, future, t_enqueued, deadline-or-None); the
        # deadline is a time.monotonic() instant.
        self._queue: deque[tuple[np.ndarray, Future, float,
                                 float | None]] = deque()
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
               deadline: float | None = None) -> Future:
        """Enqueue ``(n, C, T)`` trials; the future resolves to their
        ``(n,)`` predictions.  Raises :class:`Rejected` when the queue is
        full or the batcher is closed.  ``deadline`` (a ``time.monotonic()``
        instant) drops the request at dequeue once passed."""
        x = np.asarray(trials, np.float32)
        if x.ndim == 2:
            x = x[None]
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
            self._queue.append((x, fut, time.perf_counter(), deadline))
            self._pending_trials += n
            self._cv.notify_all()
        return fut

    def close(self, drain: bool = True) -> None:
        """Stop accepting; drain (default) or fail what is queued, then
        join the worker.  Idempotent."""
        with self._cv:
            self._closed = True
            if not drain:
                while self._queue:
                    _, fut, _, _ = self._queue.popleft()
                    fut.set_exception(Rejected("serving is shutting down"))
                self._pending_trials = 0
            self._cv.notify_all()
        if self._worker is not threading.current_thread():
            self._worker.join(DRAIN_TIMEOUT_S)
            if self._worker.is_alive():
                logger.warning("Batcher worker did not drain within %.1fs",
                               DRAIN_TIMEOUT_S)

    # -- worker side ------------------------------------------------------
    def _take_batch(self) -> list[tuple[np.ndarray, Future]] | None:
        """Block for work, honor the coalescing window, pop one batch;
        ``None`` once closed and drained.  Expired requests are failed
        here, outside the lock, before any forward."""
        expired: list[Future] = []
        try:
            with self._cv:
                while not self._queue:
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

    def _coalesce_locked(self, expired: list[Future]
                         ) -> list[tuple[np.ndarray, Future]]:
        # Wait until max_batch trials are queued or max_wait has elapsed
        # since the OLDEST pending request.
        wait_until = self._queue[0][2] + self.max_wait_s
        while self._pending_trials < self.max_batch and not self._closed:
            remaining = wait_until - time.perf_counter()
            if remaining <= 0:
                break
            self._cv.wait(remaining)
        batch: list[tuple[np.ndarray, Future]] = []
        parked = []
        n = 0
        now = time.monotonic()
        while self._queue and n < self.max_batch:
            entry = self._queue.popleft()
            x, fut, _, deadline = entry
            if deadline is not None and now >= deadline:
                self._pending_trials -= len(x)
                expired.append(fut)
                continue
            if batch and n + len(x) > self.max_batch:
                parked.append(entry)   # a later, smaller request may fit
                continue
            batch.append((x, fut))
            n += len(x)
        # Skipped entries return to the front in their original order.
        self._queue.extendleft(reversed(parked))
        self._pending_trials -= n
        return batch

    def _run(self) -> None:
        while True:
            batch = self._take_batch()
            if batch is None:
                return
            if not batch:   # every queued request expired
                continue
            xs = [x for x, _ in batch]
            x = np.concatenate(xs) if len(xs) > 1 else xs[0]
            try:
                preds = np.asarray(self._infer_fn(x))
            except Exception as exc:  # noqa: BLE001 — routed to futures
                logger.warning("Batch of %d trials failed: %s: %s", len(x),
                               type(exc).__name__, exc)
                for _, fut in batch:
                    if not fut.cancelled():
                        fut.set_exception(exc)
                continue
            self.batches += 1
            off = 0
            for bx, fut in batch:
                k = len(bx)
                if not fut.cancelled():
                    fut.set_result(preds[off:off + k])
                off += k
