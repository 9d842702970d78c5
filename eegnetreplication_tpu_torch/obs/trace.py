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
carried.

The reader half stitches the per-process journals of a fleet run back
into per-trace trees: :func:`read_spans` collects every ``span`` event
under journal files or run directories, :func:`build_traces` links them
parent to child across processes (the router's ``router.dispatch`` parents
the replica's ``replica.request``) into :class:`TraceTree` objects, and
:func:`chrome_trace_events` renders them for Perfetto.

The in-process half times the training path's layers, where a journal
line a span would cost more than the work: :func:`layer` spans (the same
fields: name, id, parent id, start, duration) and :func:`count` counters
go to a bounded ring in memory (:class:`LayerRecord`), on the clock
``torch.profiler`` stamps its events with, and are read in the same
process (:func:`layer_spans`, :func:`layer_counts`).  Only while a
profiler runs does a span also open a ``record_function`` range and, on a
CUDA device, record timing events.
"""


from __future__ import annotations

import collections
import contextlib
import contextvars
import itertools
import os
import random
import sys
import threading
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Iterator, NamedTuple

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


# ---------------------------------------------------------------------------
# Stitching: per-process journals -> per-trace trees.
# ---------------------------------------------------------------------------

@dataclass
class TraceTree:
    """One stitched trace: every span seen for a trace id, tree-linked."""

    trace_id: str
    spans: list[dict]                       # all spans, start-ordered
    children: dict[str, list[dict]]         # span_id -> child spans
    roots: list[dict]                       # spans whose parent is absent
    linked: list[dict] = field(default_factory=list)  # cross-trace links

    @property
    def processes(self) -> list[str]:
        return sorted({s.get("run_id", "?") for s in self.spans})

    @property
    def span_names(self) -> set[str]:
        return {s["name"] for s in self.spans}

    @property
    def duration_ms(self) -> float:
        if not self.spans:
            return 0.0
        t0 = min(s["start"] for s in self.spans)
        t1 = max(s["start"] + s["dur_ms"] / 1000.0 for s in self.spans)
        return (t1 - t0) * 1000.0

    def cross_process_complete(self) -> bool:
        """True when the tree links at least two processes parent→child:
        some span's parent lives in a DIFFERENT process's journal — the
        property the trace-stitch rehearsal stage asserts."""
        by_id = {s["span_id"]: s for s in self.spans}
        for s in self.spans:
            parent = by_id.get(s.get("parent_span_id") or "")
            if parent is not None and \
                    parent.get("run_id") != s.get("run_id"):
                return True
        return False


def read_spans(paths: list[str | Path]) -> list[dict]:
    """Every ``span`` event under the given journal files/run dirs/roots
    (each span annotated with its journal's ``run_id`` — already a field
    of every event).  Unreadable/incomplete journals are skipped, not
    raised: stitching a fleet run must survive a SIGKILLed member's
    truncated stream."""
    from eegnetreplication_tpu_torch.obs import schema

    files: list[Path] = []
    for p in paths:
        p = Path(p)
        if p.is_file():
            files.append(p)
        elif (p / "events.jsonl").exists():
            files.append(p / "events.jsonl")
        elif p.is_dir():
            files.extend(sorted(p.glob("**/events.jsonl")))
    spans: list[dict] = []
    for f in files:
        try:
            events = schema.read_events(f, complete=False, lenient_tail=True)
        except (OSError, schema.SchemaError):
            continue
        spans.extend(e for e in events if e.get("event") == "span"
                     and "_schema_error" not in e)
    return spans


def build_traces(spans: list[dict]) -> dict[str, TraceTree]:
    """Group spans by trace id and link parent→child (an orphan whose
    parent never landed — unflushed sibling process, lost line — becomes
    a root, so partial traces still render)."""
    by_trace: dict[str, list[dict]] = {}
    for s in spans:
        by_trace.setdefault(s["trace_id"], []).append(s)
    trees: dict[str, TraceTree] = {}
    for trace_id, group in by_trace.items():
        group.sort(key=lambda s: (s.get("start", 0.0), s["span_id"]))
        ids = {s["span_id"] for s in group}
        children: dict[str, list[dict]] = {}
        roots = []
        for s in group:
            parent = s.get("parent_span_id")
            if parent and parent in ids:
                children.setdefault(parent, []).append(s)
            else:
                roots.append(s)
        trees[trace_id] = TraceTree(trace_id=trace_id, spans=group,
                                    children=children, roots=roots)
    # Cross-trace links: a shared batch-forward span names the traces of
    # the OTHER requests it served; attach it to their trees as linked.
    by_id_global = {s["span_id"]: s for s in spans}
    for s in spans:
        for linked_trace in (s.get("link_traces") or []):
            tree = trees.get(linked_trace)
            if tree is not None and s["trace_id"] != linked_trace:
                tree.linked.append(s)
    # A span can also point AT another trace's span (link_span): surface
    # the target in this trace's linked list for the waterfall.
    for tree in trees.values():
        for s in tree.spans:
            target = by_id_global.get(s.get("link_span") or "")
            if target is not None and target["trace_id"] != tree.trace_id \
                    and target not in tree.linked:
                tree.linked.append(target)
    return trees


def chrome_trace_events(trees: dict[str, TraceTree]) -> list[dict]:
    """Chrome trace-event JSON (``"X"`` complete events, microsecond
    timestamps) loadable in Perfetto/chrome://tracing: one "process" per
    journal run id, one "thread" per trace."""
    events: list[dict] = []
    pids: dict[str, int] = {}
    tids: dict[str, int] = {}
    seen_threads: set[tuple[int, int]] = set()
    for trace_id, tree in sorted(trees.items()):
        tid = tids.setdefault(trace_id, len(tids) + 1)
        for s in tree.spans:
            run = s.get("run_id", "?")
            pid = pids.setdefault(run, len(pids) + 1)
            seen_threads.add((pid, tid))
            args = {k: v for k, v in s.items()
                    if k not in ("event", "t", "run_id", "name", "start",
                                 "dur_ms")}
            events.append({"name": s["name"], "cat": "span", "ph": "X",
                           "ts": round(s["start"] * 1e6, 1),
                           "dur": round(s["dur_ms"] * 1000.0, 1),
                           "pid": pid, "tid": tid, "args": args})
    for run, pid in pids.items():
        events.append({"name": "process_name", "ph": "M", "pid": pid,
                       "args": {"name": run}})
    tid_names = {tid: trace_id for trace_id, tid in tids.items()}
    for pid, tid in sorted(seen_threads):
        events.append({"name": "thread_name", "ph": "M", "pid": pid,
                       "tid": tid,
                       "args": {"name": f"trace {tid_names[tid]}"}})
    return events


# ---------------------------------------------------------------------------
# Layer spans: the training path's own record, in memory.
# ---------------------------------------------------------------------------

# Spans a process keeps: an epoch of the 90-fold cross-subject protocol
# makes 96 (23 train steps of four), so a 20 s window about 2,400; beyond
# the bound the oldest go first, and are counted.
LAYER_RING = 65_536


class LayerSpan(NamedTuple):
    """One finished :func:`layer` span, the fields of a request span:
    ``start_ns`` and ``end_ns`` on ``time.time_ns()``, the clock
    ``torch.profiler`` stamps its events with; ``device_ms`` the device's
    time between the span's CUDA events (``None`` where it recorded none:
    ``device`` not a CUDA device, or no profiler running)."""

    name: str
    span_id: int
    parent_span_id: int | None
    start_ns: int
    end_ns: int
    device_ms: float | None

    @property
    def dur_ns(self) -> int:
        return self.end_ns - self.start_ns


class LayerRecord:
    """A bounded ring of finished layer spans and a table of counters.

    Appending is one ``deque.append``; a full ring drops its oldest span,
    counts it (:attr:`dropped`), and remembers the newest start it dropped,
    so a reader can tell whether an interval it reads is whole
    (:meth:`lost_since`).  The training path records on one thread."""

    def __init__(self, capacity: int = LAYER_RING):
        self._ring: collections.deque = collections.deque(maxlen=capacity)
        self._counts: dict[str, int] = {}
        self.dropped = 0
        self._dropped_start = -1

    def add(self, rec: tuple) -> None:
        ring = self._ring
        if len(ring) == ring.maxlen:
            self.dropped += 1
            self._dropped_start = max(self._dropped_start, ring[0][3])
        ring.append(rec)

    def count(self, name: str, n: int = 1) -> None:
        self._counts[name] = self._counts.get(name, 0) + n

    def spans(self) -> list[LayerSpan]:
        """The ring, oldest first (in the order the spans ended).  Read
        ``device_ms`` after the device has finished the spans' work: an
        event the device has not reached gives ``None``."""
        out = []
        for name, sid, parent, t0, t1, events in self._ring:
            device_ms = None
            if events is not None and events[1].query():
                device_ms = events[0].elapsed_time(events[1])
            out.append(LayerSpan(name, sid, parent, t0, t1, device_ms))
        return out

    def counts(self) -> dict[str, int]:
        return dict(self._counts)

    def lost_since(self, start_ns: int) -> bool:
        """Whether the ring dropped a span that started at ``start_ns`` or
        later."""
        return self._dropped_start >= start_ns

    def reset(self) -> None:
        self._ring.clear()
        self._counts.clear()
        self.dropped = 0
        self._dropped_start = -1


_LAYERS = LayerRecord()
_LAYER_IDS = itertools.count(1)
_LAYER_PARENT: contextvars.ContextVar[int | None] = contextvars.ContextVar(
    "eegtpu_torch_layer_span", default=None)


class layer:
    """``with layer("train.step"):`` times one layer's work as a child of
    the enclosing layer span and appends it to the process's
    :class:`LayerRecord` when the block ends (an exception too).

    Without a running ``torch.profiler`` that is all: two clock reads and
    an append.  While one runs, the span also opens a ``record_function``
    range of its name, so a ``--profileDir`` trace shows it over the
    kernels it launched, and with ``device`` a CUDA device it records a
    timing event on that device's current stream at each end, whose
    interval becomes :attr:`LayerSpan.device_ms`."""

    __slots__ = ("_name", "_device", "_id", "_parent", "_token", "_t0",
                 "_range", "_start")

    def __init__(self, name: str, *, device=None):
        self._name = name
        self._device = device

    def __enter__(self) -> "layer":
        self._id = sid = next(_LAYER_IDS)
        self._parent = _LAYER_PARENT.get()
        self._token = _LAYER_PARENT.set(sid)
        self._range = self._start = None
        self._t0 = time.time_ns()
        # torch is imported by whatever runs the layers; a process without
        # it has no profiler to feed.
        torch = sys.modules.get("torch")
        if torch is not None and torch.autograd._profiler_enabled():
            self._range = torch.profiler.record_function(self._name)
            self._range.__enter__()
            device = self._device
            if device is not None and device.type == "cuda":
                self._start = torch.cuda.Event(enable_timing=True)
                self._start.record(torch.cuda.current_stream(device))
        return self

    def __exit__(self, *exc) -> None:
        events = None
        if self._range is not None:
            if self._start is not None:
                torch = sys.modules["torch"]
                end = torch.cuda.Event(enable_timing=True)
                end.record(torch.cuda.current_stream(self._device))
                events = (self._start, end)
            self._range.__exit__(*exc)
        t1 = time.time_ns()
        _LAYER_PARENT.reset(self._token)
        _LAYERS.add((self._name, self._id, self._parent, self._t0, t1,
                     events))


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the process's counter ``name``."""
    _LAYERS.count(name, n)


def layer_spans() -> list[LayerSpan]:
    """The process's finished layer spans (:meth:`LayerRecord.spans`)."""
    return _LAYERS.spans()


def layer_counts() -> dict[str, int]:
    """The process's counters since it started (or :func:`reset_layers`)."""
    return _LAYERS.counts()


def layer_dropped() -> int:
    """How many spans the process's ring has dropped."""
    return _LAYERS.dropped


def layer_lost_since(start_ns: int) -> bool:
    """Whether the process's ring dropped a span that started at
    ``start_ns`` or later: a reader of that interval reads it whole only
    when this is false."""
    return _LAYERS.lost_since(start_ns)


def reset_layers() -> None:
    """Empty the process's ring and counters."""
    _LAYERS.reset()
