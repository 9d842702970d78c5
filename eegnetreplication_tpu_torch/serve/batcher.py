"""Dynamic micro-batching: coalesce concurrent requests into one forward.

The port's copy of ``eegnetreplication_tpu/serve/batcher.py``.  A bounded
FIFO of in-flight requests; one worker thread coalesces whatever is queued
— up to ``max_batch`` trials, waiting at most ``max_wait_ms`` from the
*oldest* queued request so a lone request is never parked — runs ONE
inference over the concatenation, and scatters the rows back to
per-request futures in dequeue order.  A request too big for the rest of
a batch is skipped in order (later ones that fit ride along) and leads
the next batch.  :meth:`MicroBatcher.reconfigure` adopts a new cap and
window live (the ladder tuner calls it after a retune).

Backpressure is explicit: a request that would push the queue past
``max_queue_trials`` raises :class:`Rejected` at once (HTTP 429), and with
an ``admission`` controller (``serve/admission.py``) a bulk request over
its adaptive limit raises :class:`Shed` (also 429, status ``shed``);
priority (session) traffic meets only the hard bound, and ``exempt``
(probe) traffic bypasses the adaptive limit and is left out of the
observations admission and the tuner read.  A request whose
deadline passed while it was queued is dropped at dequeue with
:class:`DeadlineExceeded` (HTTP 504) before its forward runs.

The worker beats ``serve_idle`` while it polls and ``serve_forward``
around each dispatch (``resil/heartbeat.py``), probes the ``serve.hang``
chaos site inside the dispatch, emits the ``queue.wait``,
``batch.forward`` and ``batch.scatter`` trace spans, and observes the
``queue_wait_ms``, ``batch_trials`` and ``batch_requests`` histograms the
tuner and the admission controller read.  It runs in a copy of the
constructing thread's contextvars, so the serving run's journal is the
active one there too.

Multi-tenant batching (``tenant_aware=True``): every request carries a
tenant index (its model in the zoo), the queue splits per tenant, and the
coalescing takes one request from each pending tenant in turn until the
batch is full, so a cold tenant's lone request rides the next batch
however deep a hot tenant's backlog is.  The batch mixes tenants, and
``infer_fn(trials, tenants)`` gets the per-trial tenant vector.  With one
tenant the order is the plain FIFO above.
"""

from __future__ import annotations

import contextvars
import threading
import time
from collections import deque
from concurrent.futures import Future
from typing import Callable

import numpy as np

from eegnetreplication_tpu_torch.obs import journal as obs_journal
from eegnetreplication_tpu_torch.obs import trace
from eegnetreplication_tpu_torch.resil import heartbeat as hb
from eegnetreplication_tpu_torch.resil import inject
from eegnetreplication_tpu_torch.utils.logging import logger


# How long close() waits for the worker to drain the queue.
DRAIN_TIMEOUT_S = 30.0


class Rejected(RuntimeError):
    """The request was refused without being enqueued (backpressure or
    shutdown) — the 429-shaped signal, distinct from an inference error."""


class Shed(Rejected):
    """A BULK request refused under the *adaptive* admission limit
    (:mod:`~eegnetreplication_tpu_torch.serve.admission`) while the hard queue
    bound still had room — the brownout signal.  Same 429 to the client
    as :class:`Rejected`; distinct in telemetry (status ``shed``) because
    it means "load-shedding by policy", not "queue physically full"."""


class DeadlineExceeded(RuntimeError):
    """The request's deadline expired before its forward ran (dropped at
    dequeue) or before its response could be used — the 504-shaped
    signal: the client has given up, so spending a forward on it only
    steals capacity from requests that still have a waiting caller."""


class MicroBatcher:
    """Bounded request queue + one coalescing inference worker.

    ``infer_fn(trials) -> predictions`` is called with the concatenated
    ``(n, C, T)`` batch from the worker thread only; an exception from it
    fails exactly the requests in that batch (later arrivals are
    unaffected).
    """

    def __init__(self, infer_fn: Callable[[np.ndarray], np.ndarray], *,
                 max_batch: int = 128, max_wait_ms: float = 5.0,
                 max_queue_trials: int = 512, journal=None,
                 heartbeat: hb.Heartbeat | None = None,
                 admission=None, tenant_aware: bool = False):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        if max_queue_trials < max_batch:
            raise ValueError(
                f"max_queue_trials ({max_queue_trials}) must be >= "
                f"max_batch ({max_batch})")
        self._infer_fn = infer_fn
        # tenant_aware: submit() accepts a per-request tenant index, the
        # dequeue is weighted-fair across tenants, and infer_fn is called
        # as infer_fn(trials, tenants) with the per-trial tenant vector
        # (the model zoo's stacked forward).  Off (default): the legacy
        # single-model infer_fn(trials) contract.
        self.tenant_aware = bool(tenant_aware)
        self.max_batch = int(max_batch)
        self.max_wait_s = float(max_wait_ms) / 1000.0
        self.max_queue_trials = int(max_queue_trials)
        self._journal = journal if journal is not None \
            else obs_journal.current()
        # Adaptive overload control (None = the legacy static cliff):
        # submit consults its AIMD limit for BULK traffic, the worker
        # feeds it every observed queue wait.
        self.admission = admission
        # Worker liveness: beats phase "serve_idle" while polling and
        # "serve_forward" around each dispatch, so /healthz (and an
        # external watchdog via EEGTPU_HEARTBEAT_FILE) can tell a wedged
        # worker from an idle one.  Default: the process emitter.
        self.heartbeat = heartbeat if heartbeat is not None else hb.emitter()
        self._cv = threading.Condition()
        # Entries: (trials, future, t_enqueued, deadline-or-None, trace
        # ctx-or-None, tenant) where the deadline is a time.monotonic()
        # instant.  The trace context is captured at submit so the worker
        # can emit queue-wait/forward/scatter spans under the REQUEST's
        # trace even though it runs in its own (construction-time)
        # contextvars.  One FIFO per tenant; ``_rr`` is the persistent
        # round-robin ring the weighted-fair dequeue walks (single-tenant
        # traffic degenerates to one FIFO — the legacy order).
        self._queues: dict[int, deque[
            tuple[np.ndarray, Future, float, float | None,
                  trace.TraceContext | None, int]]] = {}
        self._rr: deque[int] = deque()
        self._pending_trials = 0
        self._closed = False
        # Futures of exempt requests (probes): they ride the real queue
        # and forward but stay out of the admission and tuner
        # observations.  Added under ``_cv`` at submit, discarded on every
        # terminal path (scatter, expiry, failed forward, close).
        self._exempt: set[Future] = set()
        # Coalesced forwards dispatched so far (read by /healthz).
        self.batches = 0
        # Run the worker inside a copy of the constructing thread's
        # context so journal.current() (and inject/retry's journaling)
        # resolve to the serving run from the worker too — plain threads
        # do NOT inherit contextvars.
        ctx = contextvars.copy_context()
        self._worker = threading.Thread(target=ctx.run, args=(self._run,),
                                        name="serve-batcher", daemon=True)
        self._worker.start()

    # -- client side ------------------------------------------------------
    @property
    def queue_depth(self) -> int:
        """Trials currently enqueued (not yet handed to the worker)."""
        with self._cv:
            return self._pending_trials

    @property
    def queue_depth_requests(self) -> int:
        """Requests currently enqueued (not yet handed to the worker) —
        the fleet router's least-loaded dispatch signal."""
        with self._cv:
            return self._pending_requests_locked()

    def _pending_requests_locked(self) -> int:
        return sum(len(q) for q in self._queues.values())

    def _has_pending_locked(self) -> bool:
        return any(self._queues.values())

    def _gauge_depth_locked(self) -> None:
        """Publish both queue-depth gauges (``self._cv`` held).  Every
        transition (submit, coalesce, expiry drop, non-drain close) lands
        here so ``/metrics`` always shows the LIVE depth, not just the
        per-batch ``bucket_fill`` occupancy."""
        self._journal.metrics.set("queue_depth_trials", self._pending_trials)
        self._journal.metrics.set("queue_depth_requests",
                                  self._pending_requests_locked())

    def submit(self, trials: np.ndarray,
               deadline: float | None = None,
               priority: bool = False, tenant: int = 0,
               exempt: bool = False) -> Future:
        """Enqueue ``(n, C, T)`` trials; the future resolves to their
        ``(n,)`` predictions.  Raises :class:`Rejected` when the queue is
        full or the batcher is shut down, :class:`Shed` when the adaptive
        admission limit refuses a bulk request.  ``deadline`` (a
        ``time.monotonic()`` instant) marks when the caller stops caring:
        a request still queued past it is dropped at dequeue with
        :class:`DeadlineExceeded` instead of wasting a forward.
        ``priority=True`` marks control/session traffic: it bypasses the
        adaptive limit (never shed before bulk) and only the hard
        ``max_queue_trials`` cliff applies.  ``tenant`` indexes the
        request's model in a multi-tenant zoo (``tenant_aware``
        batchers only — the single-model contract pins tenant 0).
        ``exempt=True`` marks canary traffic (probes): it bypasses the
        adaptive limit and is left out of the queue-wait and batch-shape
        observations that admission and the ladder tuner read (it still
        fills a batch slot, so ``bucket_fill`` counts it)."""
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
        n = len(x)
        if n == 0:
            fut: Future = Future()
            fut.set_result(np.zeros(0, np.int64))
            return fut
        fut = Future()
        shed_pending = None
        with self._cv:
            if self._closed:
                raise Rejected("serving is shutting down")
            if self._pending_trials + n > self.max_queue_trials:
                self._journal.metrics.inc("requests_rejected")
                raise Rejected(
                    f"queue full ({self._pending_trials} trials pending, "
                    f"limit {self.max_queue_trials})")
            if (self.admission is not None and not priority and not exempt
                    and not self.admission.admit(self._pending_trials, n)):
                # Shed verdict noted here, recorded BELOW: record_shed
                # may write a throttled journal line, and disk I/O under
                # _cv would stall the worker + every submitter at the
                # exact moment the service is overloaded.
                shed_pending = self._pending_trials
            else:
                q = self._queues.get(tenant)
                if q is None:
                    q = self._queues[tenant] = deque()
                    self._rr.append(tenant)
                q.append((x, fut, time.perf_counter(), deadline,
                          trace.current(), tenant))
                if exempt:
                    self._exempt.add(fut)
                self._pending_trials += n
                self._gauge_depth_locked()
                self._cv.notify_all()
        if shed_pending is not None:
            self.admission.record_shed()
            raise Shed(
                f"shed under adaptive admission ({shed_pending} trials "
                f"pending, limit {self.admission.limit})")
        return fut

    def reconfigure(self, *, max_batch: int | None = None,
                    max_wait_ms: float | None = None) -> None:
        """Adopt a new coalescing cap and/or window, live (the
        LadderTuner calls this right after the registry swaps onto a new
        ladder so ``max_batch`` tracks the top bucket).

        Queued requests are untouched; the next ``_coalesce_locked`` pass
        simply reads the new values.  ``max_batch`` is clamped to
        ``max_queue_trials`` (the constructor invariant) — a ladder that
        outgrows the queue bound coalesces at the bound.
        """
        with self._cv:
            if max_batch is not None:
                mb = int(max_batch)
                if mb < 1:
                    raise ValueError(f"max_batch must be >= 1, got {mb}")
                self.max_batch = min(mb, self.max_queue_trials)
            if max_wait_ms is not None:
                ms = float(max_wait_ms)
                if ms < 0:
                    raise ValueError(
                        f"max_wait_ms must be >= 0, got {ms}")
                self.max_wait_s = ms / 1000.0
            self._cv.notify_all()

    def close(self, drain: bool = True,
              timeout: float = DRAIN_TIMEOUT_S) -> None:
        """Stop accepting; drain (default) or fail what is queued, then
        join the worker.  Idempotent."""
        with self._cv:
            self._closed = True
            if not drain:
                for q in self._queues.values():
                    while q:
                        _, fut, _, _, _, _ = q.popleft()
                        self._exempt.discard(fut)
                        fut.set_exception(
                            Rejected("serving is shutting down"))
                self._queues.clear()
                self._rr.clear()
                self._pending_trials = 0
                self._gauge_depth_locked()
            self._cv.notify_all()
        if self._worker is not threading.current_thread():
            self._worker.join(timeout)
            if self._worker.is_alive():
                logger.warning("Batcher worker did not drain within %.1fs",
                               timeout)

    # -- worker side ------------------------------------------------------
    def _take_batch(self) -> list[
            tuple[np.ndarray, Future, float,
                  trace.TraceContext | None, int]] | None:
        """Block for work, honor the coalescing window, pop one batch.
        Returns ``None`` when closed and fully drained.  Requests whose
        deadline already passed are dropped HERE — before the forward —
        with :class:`DeadlineExceeded` on their future."""
        expired: list[tuple[Future, float, trace.TraceContext | None]] = []
        try:
            while True:
                with self._cv:
                    if self._has_pending_locked():
                        return self._coalesce_locked(expired)
                    if self._closed:
                        return None
                    self._cv.wait(0.05)
                # Idle poll elapsed with no work: beat OUTSIDE the lock —
                # the beat's throttled file write (supervised serving)
                # must never add filesystem latency to a concurrent
                # submit() contending for the condition lock.
                self.heartbeat.beat("serve_idle")
        finally:
            # Resolve expired futures outside the lock: their handler
            # threads wake straight into journaling.  The queue-wait span
            # lands FIRST (status "expired") so the handler's anomaly
            # flush finds it already buffered.
            for fut, t_enq, ctx in expired:
                wait_s = time.perf_counter() - t_enq
                trace.emit_span(
                    ctx, "queue.wait", dur_s=wait_s,
                    journal=self._journal, status="expired")
                if self.admission is not None \
                        and fut not in self._exempt:
                    # An expired wait is the strongest overload evidence
                    # there is — it must feed the AIMD loop, not just the
                    # completions that squeaked through.  A probe's
                    # expiry stays out: it must never clamp admission.
                    self.admission.observe_wait(wait_s * 1000.0)
                self._exempt.discard(fut)
                if not fut.cancelled():
                    fut.set_exception(DeadlineExceeded(
                        "request deadline expired while queued; dropped "
                        "before inference"))

    def _oldest_enqueue_locked(self) -> float:
        return min(q[0][2] for q in self._queues.values() if q)

    def _pop_fit_locked(
            self, q, now: float,
            expired: list[tuple[Future, float, trace.TraceContext | None]],
            parked: list, batch_empty: bool, n: int):
        """Pop the first entry of one tenant's queue that fits the
        remaining batch budget; expired entries drop, misfits move onto
        ``parked`` for the REST of this coalesce pass (the budget only
        shrinks — once skipped, an entry cannot fit later, so re-scanning
        it every pop would make the pass O(taken x skipped)).  The
        caller restores parked entries to the queue front in order —
        greedy across requests, no starvation: a skipped request reaches
        the head eventually and an empty batch always takes the head,
        oversize or not.  Returns the entry or ``None`` when nothing in
        this queue fits."""
        while q:
            entry = q.popleft()
            x, fut, t_enq, deadline, ctx, tenant = entry
            if deadline is not None and now >= deadline:
                # Expired while queued: drop before the forward.
                self._pending_trials -= len(x)
                expired.append((fut, t_enq, ctx))
                self._journal.metrics.inc("requests_expired")
                continue
            if not batch_empty and n + len(x) > self.max_batch:
                parked.append(entry)
                continue  # greedy: a later request of this tenant may fit
            return entry
        return None

    def _coalesce_locked(
            self,
            expired: list[tuple[Future, float, trace.TraceContext | None]]
    ) -> list[tuple[np.ndarray, Future, float,
                    trace.TraceContext | None, int]]:
        """Honor the coalescing window and pop one batch (``self._cv``
        held).  Requests whose deadline passed while queued go onto
        ``expired`` instead of into the batch.

        The fill walks the tenant ring WEIGHTED-FAIR: one request per
        pending tenant per cycle (the ring's rotation persists across
        batches), cycling until the batch fills or nothing more fits —
        so a cold tenant's lone request rides the very next dispatch no
        matter how deep a hot sibling's backlog is, and a single tenant
        degenerates to the legacy FIFO+greedy scan (same membership,
        same order).
        """
        # Coalesce: wait until max_batch trials are queued or max_wait
        # has elapsed since the OLDEST pending request — bounded added
        # latency, never an idle park.
        wait_until = self._oldest_enqueue_locked() + self.max_wait_s
        while (self._pending_trials < self.max_batch
               and not self._closed):
            remaining = wait_until - time.perf_counter()
            if remaining <= 0:
                break
            self._cv.wait(remaining)
        batch = []
        n = 0
        now = time.monotonic()
        parked: dict[int, list] = {}
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
                batch.append((entry[0], entry[1], entry[2], entry[4],
                              entry[5]))
                n += len(entry[0])
                progressed = True
                if n >= self.max_batch:
                    break
            if not progressed:
                break
        # Parked (too-big-for-this-batch) entries return to the FRONT in
        # their original order — they are older than everything behind
        # them and lead the next coalesce pass.
        for tenant, entries in parked.items():
            if entries:
                self._queues[tenant].extendleft(reversed(entries))
        # Tenants whose queue drained leave the ring (re-appended on the
        # next submit); the ring's rotation carries the fairness state.
        for tenant in [t for t, q in self._queues.items() if not q]:
            del self._queues[tenant]
            self._rr.remove(tenant)
        self._pending_trials -= n
        self._gauge_depth_locked()
        return batch

    def _dispatch(self, x: np.ndarray, tenants: np.ndarray | None):
        """One inference call: the tenant-aware contract passes the
        per-trial tenant vector alongside the trials."""
        if tenants is not None:
            return self._infer_fn(x, tenants)
        return self._infer_fn(x)

    def _run(self) -> None:
        # First beat at thread start: the worker announces itself before
        # any request exists, so /healthz never reads a "startup" phase
        # from a batcher whose worker is already alive.
        self.heartbeat.beat("serve_idle")
        while True:
            batch = self._take_batch()
            if batch is None:
                return
            if not batch:  # every queued request expired: nothing to run
                continue
            xs = [x for x, _, _, _, _ in batch]
            x = np.concatenate(xs) if len(xs) > 1 else xs[0]
            # The per-trial tenant vector, aligned with the concatenated
            # batch rows — what a zoo's stacked forward gathers by.
            tenants = (np.concatenate(
                [np.full(len(bx), tenant, np.int32)
                 for bx, _, _, _, tenant in batch])
                if self.tenant_aware else None)
            now = time.perf_counter()
            # Queue-wait spans land at dequeue (enqueue -> here), one per
            # traced request, under each REQUEST's own context.
            for bx, _, t_enq, ctx, _ in batch:
                trace.emit_span(ctx, "queue.wait",
                                dur_s=now - t_enq, journal=self._journal,
                                n_trials=len(bx))
            # ONE shared forward span for the whole coalesced batch: it
            # lives in the first sampled request's trace (else the first
            # traced one) and names every other coalesced trace in
            # link_traces, so the stitcher can attach it to their trees.
            ctxs = [ctx for _, _, _, ctx, _ in batch if ctx is not None]
            primary = next((c for c in ctxs if c.sampled),
                           ctxs[0] if ctxs else None)
            link_traces = sorted({c.trace_id for c in ctxs
                                  if primary is not None
                                  and c.trace_id != primary.trace_id})
            forward_span = None
            t_fwd = time.perf_counter()
            try:
                self.heartbeat.beat("serve_forward", n_trials=len(x))
                # Chaos hang site (action="sleep"): a silent stall inside
                # the dispatch — the last beat says "serve_forward" and
                # then nothing, which is exactly the wedged-worker shape
                # /healthz staleness and the supervisor watchdog detect.
                inject.fire("serve.hang", n_trials=len(x))
                if primary is not None:
                    with trace.use(primary), \
                            trace.span("batch.forward",
                                       journal=self._journal,
                                       n_trials=len(x),
                                       n_requests=len(batch),
                                       n_tenants=(
                                           int(len(np.unique(tenants)))
                                           if tenants is not None else 1),
                                       link_traces=link_traces) as sp:
                        preds = np.asarray(self._dispatch(x, tenants))
                        forward_span = sp.span_id if sp else None
                else:
                    preds = np.asarray(self._dispatch(x, tenants))
            except BaseException as exc:  # noqa: BLE001 — routed to futures
                for _, fut, _, _, _ in batch:
                    self._exempt.discard(fut)
                    if not fut.cancelled():
                        fut.set_exception(exc)
                continue
            # Scatter rows back in dequeue order: request i owns
            # preds[off : off + len(request i)].
            self.batches += 1
            t_scatter = time.perf_counter()
            off = 0
            n_exempt_trials = 0
            n_exempt_reqs = 0
            for bx, fut, t_enq, ctx, _ in batch:
                k = len(bx)
                if not fut.cancelled():
                    fut.set_result(preds[off:off + k])
                off += k
                if fut in self._exempt:
                    # Probes ride the forward but never feed the tuner or
                    # admission: their cadence is the operator's.
                    self._exempt.discard(fut)
                    n_exempt_trials += k
                    n_exempt_reqs += 1
                else:
                    self._journal.metrics.observe(
                        "queue_wait_ms", (now - t_enq) * 1000.0)
                    if self.admission is not None:
                        self.admission.observe_wait(
                            (now - t_enq) * 1000.0)
                # Per-request scatter span: dequeue -> result delivered,
                # linked to the shared forward it rode.
                trace.emit_span(
                    ctx, "batch.scatter",
                    dur_s=time.perf_counter() - t_fwd,
                    journal=self._journal, n_trials=k,
                    link_span=forward_span,
                    forward_ms=round((t_scatter - t_fwd) * 1000.0, 3))
            # Batch shapes count user work only: an all-probe batch
            # records nothing.
            if len(batch) > n_exempt_reqs:
                self._journal.metrics.observe(
                    "batch_trials", len(x) - n_exempt_trials)
                self._journal.metrics.observe(
                    "batch_requests", len(batch) - n_exempt_reqs)
            self.heartbeat.beat("serve_idle")
