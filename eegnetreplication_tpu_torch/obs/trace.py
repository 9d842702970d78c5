"""Request-scoped tracing over the run-journal event stream.

The runtime half of ``eegnetreplication_tpu/obs/trace.py``.  A trace
context (``trace_id``, the active ``span_id``, the sampled flag) rides a
:mod:`contextvars` variable, starts at the serving edge (or arrives with
the request in the ``X-Trace-Id`` / ``X-Parent-Span`` /
``X-Trace-Sampled`` headers, which a client's trace keeps), and every
instrumented stage emits one ``span`` journal event: ``replica.request``
and ``http.parse`` in the handler, ``queue.wait``, ``batch.forward`` and
``batch.scatter`` in the batcher, ``engine.forward`` in the engine,
``session.samples`` and ``session.window`` for a stream.

Sampling is head-based (``--traceSample``, default
:data:`DEFAULT_SAMPLE_RATE`).  An unsampled trace's spans wait in a
per-trace buffer and are dropped with the request, unless the request
ends in an anomaly (an error, an expired deadline, a circuit refusal):
:func:`flush_if_anomalous` then journals them after all.

The batcher's coalesced forward gets one span, under the first sampled
request's trace, whose ``link_traces`` names every other trace it
carried.  The reader half (``TraceTree``, ``read_spans``,
``build_traces``, ``chrome_trace_events``) is not ported: the JAX
package's ``scripts/trace_report.py`` reads the port's journals.
"""


from __future__ import annotations

import contextlib
import contextvars
import os
import random
import threading
import time
from typing import Any, Iterator

from eegnetreplication_tpu_torch.obs import journal as obs_journal

# Propagation headers (the contract README documents): the trace id, the
# sender's active span id (the receiver's parent), and the head-based
# sampling verdict so every hop buffers/emits consistently.
TRACE_HEADER = "X-Trace-Id"
PARENT_HEADER = "X-Parent-Span"
SAMPLED_HEADER = "X-Trace-Sampled"

# Head-based sampling default (--traceSample): 1 in 10 requests carries a
# fully journaled trace; the rest cost one in-memory buffer that is
# dropped unless the request ends anomalously.
DEFAULT_SAMPLE_RATE = 0.1

# Unsampled-trace buffer bound per process: an anomaly flush is a debug
# artifact, not a firehose — a runaway span emitter must not hoard memory.
MAX_BUFFERED_SPANS = 256

# Request statuses whose buffered spans are always flushed (the
# tail-capture rule): inference errors, expired deadlines, and circuit
# refusals.  Backpressure (429) is load shedding by design, not an
# anomaly worth a trace.
ANOMALY_STATUSES = ("error", "expired", "circuit_open", "bad_request")


class _TraceState:
    """Per-trace-per-process mutable state shared by every context object
    derived from the same trace: the unsampled-span buffer and the
    flushed latch (once an anomaly flushed the buffer, later spans of the
    same trace journal directly)."""

    __slots__ = ("buffer", "flushed", "lock")

    def __init__(self):
        self.buffer: list[dict] = []
        self.flushed = False
        self.lock = threading.Lock()


class TraceContext:
    """One hop's view of a trace: identity + the active span.

    A plain __slots__ class rather than a dataclass: context objects are
    minted per span on the serving hot path, and attribute-dict
    construction is measurable there.
    """

    __slots__ = ("trace_id", "span_id", "sampled", "state")

    def __init__(self, trace_id: str, span_id: str | None = None,
                 sampled: bool = False, state: _TraceState | None = None):
        self.trace_id = trace_id
        self.span_id = span_id            # the active span (children's parent)
        self.sampled = sampled
        self.state = state if state is not None else _TraceState()

    def __repr__(self):  # pragma: no cover — debugging aid
        return (f"TraceContext({self.trace_id!r}, span={self.span_id!r}, "
                f"sampled={self.sampled})")

    def with_span(self, span_id: str) -> "TraceContext":
        """A child view sharing this trace's buffer/flush state."""
        return TraceContext(self.trace_id, span_id, self.sampled,
                            self.state)


_ACTIVE: contextvars.ContextVar[TraceContext | None] = \
    contextvars.ContextVar("eegtpu_torch_trace_context", default=None)


# Span/trace ids come from a per-process PRNG seeded once from the OS:
# os.urandom is a ~6us syscall and tracing mints several ids per request
# on the serving hot path — the PRNG is ~50x cheaper, and a 64/128-bit
# draw seeded per process keeps ids unique across a fleet's processes.
# getrandbits on a Random instance is one C call, atomic under the GIL,
# so no lock is needed on this path.
_ID_RNG = random.Random(int.from_bytes(os.urandom(16), "big")
                        ^ (os.getpid() << 64))


def new_trace_id() -> str:
    return f"{_ID_RNG.getrandbits(128):032x}"


def new_span_id() -> str:
    return f"{_ID_RNG.getrandbits(64):016x}"


def current() -> TraceContext | None:
    """The active trace context, or None outside any trace."""
    return _ACTIVE.get()


def start(sample_rate: float = DEFAULT_SAMPLE_RATE, *,
          rng: random.Random | None = None) -> TraceContext:
    """A new root trace context with the head-based sampling decision
    made here, once — every later hop inherits the verdict."""
    rate = max(0.0, min(1.0, float(sample_rate)))
    draw = (rng.random() if rng is not None else random.random())
    return TraceContext(trace_id=new_trace_id(), sampled=draw < rate)


def maybe_start(headers, sample_rate: float) -> TraceContext | None:
    """The serving edge's one-liner: honor a propagated context, else
    make the head-based sampling decision — or stay entirely out of the
    way (None: every span is a no-op) when tracing is disabled
    (``sample_rate <= 0``)."""
    ctx = from_headers(headers)
    if ctx is not None:
        return ctx
    if sample_rate <= 0:
        return None
    return start(sample_rate)


def from_headers(headers) -> TraceContext | None:
    """Rebuild the propagated context from request headers (None when the
    request carries no trace)."""
    trace_id = headers.get(TRACE_HEADER)
    if not trace_id:
        return None
    sampled = str(headers.get(SAMPLED_HEADER, "0")).strip() in ("1", "true")
    return TraceContext(trace_id=str(trace_id).strip(),
                        span_id=(headers.get(PARENT_HEADER) or None),
                        sampled=sampled)


def headers(ctx: TraceContext | None = None) -> dict[str, str]:
    """Propagation headers for the given (default: current) context —
    empty outside a trace, so callers can unconditionally merge."""
    ctx = ctx if ctx is not None else current()
    if ctx is None:
        return {}
    out = {TRACE_HEADER: ctx.trace_id,
           SAMPLED_HEADER: "1" if ctx.sampled else "0"}
    if ctx.span_id:
        out[PARENT_HEADER] = ctx.span_id
    return out


@contextlib.contextmanager
def use(ctx: TraceContext | None) -> Iterator[TraceContext | None]:
    """Activate ``ctx`` for the block (handler threads do not inherit the
    listener's contextvars, so every entry point activates explicitly)."""
    token = _ACTIVE.set(ctx)
    try:
        yield ctx
    finally:
        _ACTIVE.reset(token)


def _emit(ctx: TraceContext, record: dict, journal=None) -> None:
    """Journal the span when the trace is sampled (or already anomaly-
    flushed); buffer it otherwise."""
    if ctx.sampled or ctx.state.flushed:
        journal = journal if journal is not None else obs_journal.current()
        journal.event("span", **record)
        return
    with ctx.state.lock:
        if len(ctx.state.buffer) < MAX_BUFFERED_SPANS:
            ctx.state.buffer.append(record)


def emit_span(ctx: TraceContext | None, name: str, *, dur_s: float,
              start_wall: float | None = None, journal=None,
              parent_span_id: str | None = None, span_id: str | None = None,
              status: str = "ok", **attrs: Any) -> str | None:
    """Emit one already-timed span under ``ctx`` (worker threads time
    stages across requests and cannot hold a context manager open per
    request — the micro-batcher's queue-wait/scatter spans come through
    here).  Returns the span id (None outside a trace)."""
    if ctx is None:
        return None
    sid = span_id or new_span_id()
    record = {"name": name, "trace_id": ctx.trace_id, "span_id": sid,
              "parent_span_id": (parent_span_id if parent_span_id
                                 is not None else ctx.span_id),
              "start": round(start_wall if start_wall is not None
                             else time.time() - dur_s, 6),
              "dur_ms": round(dur_s * 1000.0, 3), "status": status}
    record.update(attrs)
    _emit(ctx, record, journal)
    return sid


class Span:
    """Handle yielded by :func:`span`: id + mutable attributes/status."""

    __slots__ = ("name", "span_id", "status", "attrs")

    def __init__(self, name: str, span_id: str):
        self.name = name
        self.span_id = span_id
        self.status = "ok"
        self.attrs: dict[str, Any] = {}

    def set(self, **attrs: Any) -> None:
        self.attrs.update(attrs)


@contextlib.contextmanager
def span(name: str, journal=None, **attrs: Any) -> Iterator[Span | None]:
    """Time one stage as a child of the active span (no-op outside a
    trace).  The span id becomes the active parent within the block, so
    nesting — and cross-process parentage via :func:`headers` — follows
    lexical structure.  An exception marks ``status="error"`` and
    propagates."""
    ctx = current()
    if ctx is None:
        yield None
        return
    handle = Span(name, new_span_id())
    child = ctx.with_span(handle.span_id)
    token = _ACTIVE.set(child)
    start_wall = time.time()
    t0 = time.perf_counter()
    try:
        yield handle
    except BaseException:
        handle.status = "error"
        raise
    finally:
        _ACTIVE.reset(token)
        dur_s = time.perf_counter() - t0
        emit_span(ctx, name, dur_s=dur_s, start_wall=start_wall,
                  journal=journal, parent_span_id=ctx.span_id,
                  span_id=handle.span_id, status=handle.status,
                  **{**attrs, **handle.attrs})


def flush(ctx: TraceContext | None = None, journal=None) -> int:
    """Write the buffered spans of an UNSAMPLED trace (anomaly
    tail-capture) and latch the trace flushed so its remaining spans
    journal directly.  Returns the number of spans written."""
    ctx = ctx if ctx is not None else current()
    if ctx is None or ctx.sampled:
        return 0
    with ctx.state.lock:
        if ctx.state.flushed and not ctx.state.buffer:
            return 0
        ctx.state.flushed = True
        buffered, ctx.state.buffer = ctx.state.buffer, []
    journal = journal if journal is not None else obs_journal.current()
    for record in buffered:
        journal.event("span", **record)
    return len(buffered)


def flush_if_anomalous(status: str, journal=None) -> int:
    """The request-status hook: flush the current trace's buffer when the
    outcome is one of :data:`ANOMALY_STATUSES`."""
    if status in ANOMALY_STATUSES:
        return flush(journal=journal)
    return 0
