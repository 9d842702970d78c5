"""Deterministic fault injection at named sites of the training path, the
serving forward, the session store, online adaptation, the replica fleet
and the cell tier.

The port's copy of ``eegnetreplication_tpu/resil/inject.py`` but for its
dataset-download site.  Instrumented code
calls :func:`fire` at a named site; the call is a no-op (one dict lookup)
unless a test or a ``--chaos`` plan has
:func:`arm`-ed that site.  Arming counts hits, so a chaos run repeats
exactly: ``after=N`` skips the first N eligible hits, ``times=M`` fires on
the next M (``times=0``: every later hit), ``every=N`` only on every Nth.
Every firing is journaled as a ``fault_injected`` event.

=========================  =========  =====================================
site                       action     effect
=========================  =========  =====================================
``data.read``              raise      ``OSError`` on a read of a trials
                                      file (transient: ``READ_RETRY``
                                      retries it)
``train.step``             raise      ``torch.cuda.OutOfMemoryError``, once
                                      per chunk of a fold group before its
                                      first epoch (``if_folds_over=N``:
                                      only groups of more than N folds);
                                      the fold-group halving retries it
``train.chunk``            raise      plain ``RuntimeError`` after a chunk
                                      of a chunked run (not a device fault:
                                      it propagates; resume from the
                                      snapshot)
``train.hang``             sleep      a silent stall (``sleep=SECONDS``)
                                      after a chunk of a chunked run
``checkpoint.write``       corrupt    truncate and garble the staged file
                                      of a checkpoint or run snapshot
``checkpoint.write_async`` corrupt    the same, inside the asynchronous
                                      snapshot writer's thread
``host.preempt``           preempt    request a graceful stop (what SIGTERM
                                      does), honoured at the next safe point
``session.snapshot``       corrupt    garble the staged bytes of a session
                                      store snapshot; restore falls back to
                                      the previous generation
``session.restore``        raise      ``OSError`` while the store restores at
                                      startup (transient: retried)
``spool.mirror``           corrupt    garble the staged bytes of the
                                      session snapshot's mirror copy (the
                                      primary write has landed)
``serve.forward``          raise      a CUDA-error-shaped ``RuntimeError``
                                      per dispatch attempt of the batcher
                                      (a device fault: the serve retry
                                      takes it; persistent faults open
                                      the circuit breaker)
``serve.hang``             sleep      a silent stall inside the batcher's
                                      dispatch, after its ``serve_forward``
                                      beat (the heartbeat goes stale)
``serve.degrade``          slow       a bounded delay per dispatch attempt
                                      (``if_tag=`` matches ``--chaosTag``)
``session.drift``          drift      a mid-stream distribution shift: the
                                      session ingest catches
                                      :class:`DriftInjected` and feeds
                                      ``x*scale + offset`` on (``scale=``
                                      finite and > 0, ``offset=`` finite)
``adapt.train``            corrupt    garble the candidate checkpoint a
                                      fine-tune just wrote (the shadow
                                      load refuses it); ``action=raise``
                                      aborts the fine-tune instead
``adapt.promote``          raise      ``RuntimeError`` inside a promotion's
                                      swap; the prior model keeps serving
``replica.network``        truncate   a serve reply is cut off mid-body
                                      (half the bytes under the full
                                      Content-Length) and the connection
                                      closed; the fleet router must treat
                                      it as a transport failure and fail
                                      over (``if_tag=`` matches
                                      ``--chaosTag``)
``fleet.scale``            raise      ``RuntimeError`` in the autoscaler's
                                      action: ``tag="spawn"`` before a
                                      scale-up launches a replica,
                                      ``tag="drain"`` in the scale-down
                                      quiesce wait (``action=sleep`` there
                                      is a hang during the drain, which
                                      times out into a journaled forced
                                      retirement)
``cell.partition``         refuse     ``ConnectionRefusedError`` at the
                                      cell front's client seam: every
                                      request and health poll to the cell
                                      is refused, what a cell crash or a
                                      network partition looks like from
                                      the front (``if_tag=`` confines it
                                      to one cell id)
``front.lease``            raise      ``OSError`` at the HA front's
                                      fencing-lease write: renews fail and
                                      the active front fences itself (left
                                      armed, the standby cannot acquire
                                      either: no split brain)
=========================  =========  =====================================

A plan (the ``--chaos`` flag) is comma-separated site specs with
colon-separated options, or ``@plan.json`` holding a list of spec objects::

    --chaos "train.step:if_folds_over=4,checkpoint.write:after=1"

The JAX package's dataset-download site instruments code the port does
not have; a plan that names it is refused.
"""

from __future__ import annotations

import json
import math
import threading
import time
from contextlib import contextmanager
from dataclasses import dataclass, fields
from pathlib import Path

import torch

from eegnetreplication_tpu_torch.obs import journal as obs_journal
from eegnetreplication_tpu_torch.utils.logging import logger

SITES = ("data.read", "train.step", "train.chunk", "train.hang",
         "checkpoint.write", "checkpoint.write_async", "host.preempt",
         "session.snapshot", "session.restore", "spool.mirror",
         "serve.forward", "serve.hang", "serve.degrade", "session.drift",
         "adapt.train", "adapt.promote", "replica.network", "fleet.scale",
         "cell.partition", "front.lease")

# The JAX package's sites that instrument modules not ported yet.
UNPORTED_SITES = ("fetch.download",)

ACTIONS = ("raise", "corrupt", "preempt", "sleep", "slow", "truncate",
           "drift", "refuse")

# action="sleep" without sleep=: long enough that a watchdog fires first,
# short enough that an unwatched plan eventually lets the process go.
DEFAULT_HANG_S = 60.0
# action="slow" without slow=: late, not stuck.
DEFAULT_SLOW_S = 0.25
# action="drift" without scale=/offset=: a model calibrated before the
# drift visibly misclassifies, and the numbers stay tame.
DEFAULT_DRIFT_SCALE = 3.0
DEFAULT_DRIFT_OFFSET = 2.0


class ResponseTruncated(Exception):
    """Raised by ``action="truncate"``: the instrumented reply path catches
    it and sends a cut-off body over a closed connection instead of the
    real response."""


class DriftInjected(Exception):
    """Raised by ``action="drift"``: the session ingest catches it and
    applies ``chunk*scale + offset`` to the samples it was about to
    ingest (a fault that carries data, not a failure)."""

    def __init__(self, message: str, scale: float, offset: float):
        super().__init__(message)
        self.scale = float(scale)
        self.offset = float(offset)

_EXC_TYPES: dict[str, type[Exception]] = {
    "RuntimeError": RuntimeError,
    "OSError": OSError,
    "IOError": OSError,
    "ConnectionError": ConnectionError,
    "TimeoutError": TimeoutError,
    "ValueError": ValueError,
    "OutOfMemoryError": torch.cuda.OutOfMemoryError,
}

# site -> (default action, default exception name, default message).
_DEFAULTS: dict[str, tuple[str, str | None, str]] = {
    "data.read": ("raise", "OSError",
                  "injected fault: data.read (hit {hit})"),
    "train.step": ("raise", "OutOfMemoryError",
                   "CUDA out of memory (injected fault: train.step, hit "
                   "{hit})"),
    "train.chunk": ("raise", "RuntimeError",
                    "injected crash after chunk {hit}"),
    "train.hang": ("sleep", None, "injected hang: train.hang (hit {hit})"),
    "checkpoint.write": ("corrupt", "OSError",
                         "injected fault: checkpoint.write (hit {hit})"),
    "checkpoint.write_async": ("corrupt", "OSError",
                               "injected fault: checkpoint.write_async "
                               "(hit {hit})"),
    "host.preempt": ("preempt", None, "injected host.preempt (hit {hit})"),
    "session.snapshot": ("corrupt", "OSError",
                         "injected fault: session.snapshot (hit {hit})"),
    "session.restore": ("raise", "OSError",
                        "injected fault: session.restore (hit {hit})"),
    "spool.mirror": ("corrupt", "OSError",
                     "injected fault: spool.mirror (hit {hit})"),
    # A CUDA runtime token, so resil/retry.py classifies it a device
    # fault, as the JAX package's "UNAVAILABLE" message is there.
    "serve.forward": ("raise", "RuntimeError",
                      "CUDA error: unspecified launch failure (injected "
                      "fault: serve.forward, hit {hit})"),
    "serve.hang": ("sleep", None, "injected hang: serve.hang (hit {hit})"),
    "serve.degrade": ("slow", None,
                      "injected degradation: serve.degrade (hit {hit})"),
    "session.drift": ("drift", None,
                      "injected drift: session.drift (hit {hit})"),
    "adapt.train": ("corrupt", "OSError",
                    "injected fault: adapt.train (hit {hit})"),
    "adapt.promote": ("raise", "RuntimeError",
                      "injected fault: adapt.promote (hit {hit})"),
    "replica.network": ("truncate", None,
                        "injected truncation: replica.network (hit {hit})"),
    "fleet.scale": ("raise", "RuntimeError",
                    "injected fault: fleet.scale (hit {hit})"),
    "cell.partition": ("refuse", None,
                       "injected partition: cell.partition (hit {hit})"),
    "front.lease": ("raise", "OSError",
                    "injected fault: front.lease (hit {hit})"),
}


def _check_site(site) -> None:
    if site in UNPORTED_SITES:
        raise ValueError(
            f"Fault-injection site {site!r} is not ported to the torch "
            "package yet (it instruments a module of queue A in "
            f"ROADMAP.md); the port's sites: {', '.join(SITES)}")
    if site not in SITES:
        raise ValueError(
            f"Unknown fault-injection site {site!r}; known sites: "
            f"{', '.join(SITES)}")


@dataclass
class FaultSpec:
    """One armed fault: which site, when it fires, and what it does.

    ``after``, ``times`` and ``every`` count eligible hits only (a
    ``train.step`` hit of a group under ``if_folds_over`` folds neither
    fires nor counts).
    """

    site: str
    after: int = 0              # skip the first N eligible hits
    times: int = 1              # fire on the next M hits; 0 = every hit
    action: str | None = None   # None = the site's default action
    exc: str | None = None      # exception class name for action="raise"
    message: str | None = None  # may contain "{hit}"
    if_folds_over: int | None = None  # train.step: only groups > N folds
    sleep: float | None = None  # action="sleep": hang duration in seconds
    slow: float | None = None   # action="slow": added latency in seconds
    every: int | None = None    # fire only on every Nth due hit
    if_tag: str | None = None   # only hits whose ctx tag= matches
    scale: float | None = None  # action="drift": multiplicative magnitude
    offset: float | None = None  # action="drift": additive magnitude
    refuse: int | None = None   # refuse=1 selects action="refuse"

    def __post_init__(self):
        _check_site(self.site)
        if self.action is not None and self.action not in ACTIONS:
            raise ValueError(
                f"Unknown fault action {self.action!r}; expected one of "
                f"{', '.join(ACTIONS)}")
        if self.exc is not None and self.exc not in _EXC_TYPES:
            raise ValueError(
                f"Unknown exception type {self.exc!r}; expected one of "
                f"{', '.join(sorted(_EXC_TYPES))}")
        if self.after < 0 or self.times < 0:
            raise ValueError(
                f"after/times must be >= 0, got after={self.after} "
                f"times={self.times}")
        if self.every is not None and self.every < 1:
            raise ValueError(f"every must be >= 1, got {self.every}")
        for field_name in ("sleep", "slow"):
            value = getattr(self, field_name)
            if value is None:
                continue
            try:
                value = float(value)
            except (TypeError, ValueError):
                raise ValueError(
                    f"{field_name} must be a number of seconds, got "
                    f"{getattr(self, field_name)!r}") from None
            if not math.isfinite(value) or value < 0:
                raise ValueError(
                    f"{field_name} must be a non-negative finite number "
                    f"of seconds, got {value}")
            setattr(self, field_name, value)
        # A NaN or inf drift would poison every window downstream, and a
        # scale <= 0 is a sign flip a plan almost never means.
        for field_name in ("scale", "offset"):
            value = getattr(self, field_name)
            if value is None:
                continue
            try:
                value = float(value)
            except (TypeError, ValueError):
                raise ValueError(
                    f"{field_name} must be a finite number, got "
                    f"{getattr(self, field_name)!r}") from None
            if not math.isfinite(value):
                raise ValueError(
                    f"{field_name} must be finite, got {value}")
            setattr(self, field_name, value)
        if self.scale is not None and self.scale <= 0:
            raise ValueError(
                f"scale must be > 0 (a drift multiplies the signal), "
                f"got {self.scale}")
        # refuse= selects an action, it counts nothing: anything but 1 is
        # a plan typo (refuse=0 would arm a fault that does nothing).
        if self.refuse is not None:
            if self.refuse != 1:
                raise ValueError(
                    f"refuse must be 1 (it selects the connection-refused "
                    f"action; omit it otherwise), got {self.refuse!r}")
            if self.action is None:
                self.action = "refuse"
            elif self.action != "refuse":
                raise ValueError(
                    f"refuse=1 conflicts with action={self.action!r}")


class ArmedFault:
    """Registry entry: a spec and its hit and fire counts (the handle
    :func:`disarm` takes)."""

    def __init__(self, spec: FaultSpec):
        self.spec = spec
        self.hits = 0    # eligible fire() calls seen
        self.fired = 0   # how many fired


_registry: dict[str, list[ArmedFault]] = {}
_lock = threading.Lock()


def arm(spec: FaultSpec | str, **options) -> ArmedFault:
    """Arm a site (a :class:`FaultSpec`, or a site name and spec fields as
    keywords); returns the handle for :func:`disarm`."""
    if isinstance(spec, str):
        spec = FaultSpec(site=spec, **options)
    elif options:
        raise TypeError("pass options either in the FaultSpec or as "
                        "keywords, not both")
    handle = ArmedFault(spec)
    with _lock:
        _registry.setdefault(spec.site, []).append(handle)
    return handle


def disarm(handle: ArmedFault) -> None:
    """Remove one armed fault (no-op if already disarmed)."""
    with _lock:
        entries = _registry.get(handle.spec.site, [])
        if handle in entries:
            entries.remove(handle)
        if not entries:
            _registry.pop(handle.spec.site, None)


def disarm_all() -> None:
    """Clear the whole registry."""
    with _lock:
        _registry.clear()


def armed() -> list[FaultSpec]:
    """The armed specs."""
    with _lock:
        return [h.spec for entries in _registry.values() for h in entries]


@contextmanager
def scoped(*specs: FaultSpec):
    """Arm ``specs`` for the block and disarm them on the way out, also
    when the injected fault propagates."""
    handles = [arm(s) for s in specs]
    try:
        yield handles
    finally:
        for h in handles:
            disarm(h)


def _eligible(spec: FaultSpec, ctx: dict) -> bool:
    if spec.if_folds_over is not None:
        n_folds = ctx.get("n_folds")
        if n_folds is None or int(n_folds) <= spec.if_folds_over:
            return False
    if spec.if_tag is not None and ctx.get("tag") != spec.if_tag:
        return False
    return True


def _corrupt_file(path: str | Path) -> None:
    """Truncate the file at ``path`` to half and garble its tail: what a
    crash mid-write leaves, caught by both the zip structure and the
    sha256 stamp."""
    p = Path(path)
    data = p.read_bytes()
    cut = max(1, len(data) // 2)
    p.write_bytes(data[:cut][:-8] + b"\x00garbled" if cut > 8
                  else b"\x00garbled")


def fire(site: str, **ctx) -> None:
    """Injection point: a no-op unless ``site`` is armed and due.

    ``ctx`` feeds the predicates (``n_folds``, ``tag``) and the journal
    event; ``path`` names the file a ``corrupt`` action garbles.
    """
    if site not in _registry:  # nothing armed: no lock taken
        return
    to_fire: ArmedFault | None = None
    with _lock:
        for h in _registry.get(site, []):
            if not _eligible(h.spec, ctx):
                continue
            # Every eligible spec counts the hit, even one an earlier spec
            # fires on, so each plan entry's after=N counts the same hits;
            # the first due spec (in arm order) fires.
            h.hits += 1
            if to_fire is not None or h.hits <= h.spec.after:
                continue
            if h.spec.every and (h.hits - h.spec.after - 1) % h.spec.every:
                continue
            if h.spec.times and h.fired >= h.spec.times:
                continue
            h.fired += 1
            to_fire = h
    if to_fire is None:
        return
    spec = to_fire.spec
    d_action, d_exc, d_msg = _DEFAULTS[site]
    action = spec.action or d_action
    message = (spec.message or d_msg).replace("{hit}", str(to_fire.hits))

    jr = obs_journal.current()
    jctx = {k: (str(v) if isinstance(v, Path) else v)
            for k, v in ctx.items()
            if isinstance(v, (str, int, float, bool, Path)) or v is None}
    jr.event("fault_injected", site=site, action=action, hit=to_fire.hits,
             **jctx)
    jr.metrics.inc("faults_injected", site=site)
    logger.warning("Fault injection: site=%s action=%s hit=%d (%s)", site,
                   action, to_fire.hits, message)

    if action == "corrupt":
        path = ctx.get("path")
        if path is None:
            raise RuntimeError(
                f"fault site {site!r} fired with action='corrupt' but the "
                "instrumented call passed no path=")
        _corrupt_file(path)
        return
    if action == "preempt":
        from eegnetreplication_tpu_torch.resil import preempt

        preempt.request(message)
        return
    if action in ("sleep", "slow"):
        # sleep: a stall that outlives a SIGTERM (PEP 475 resumes it);
        # slow: a bounded delay, then the call goes on.
        default = DEFAULT_HANG_S if action == "sleep" else DEFAULT_SLOW_S
        seconds = getattr(spec, action)
        time.sleep(default if seconds is None else seconds)
        return
    if action == "truncate":
        raise ResponseTruncated(message)
    if action == "drift":
        raise DriftInjected(
            message,
            spec.scale if spec.scale is not None else DEFAULT_DRIFT_SCALE,
            spec.offset if spec.offset is not None
            else DEFAULT_DRIFT_OFFSET)
    if action == "refuse":
        # What a dead or partitioned process shows a client: an OSError
        # subtype, so the fleet and cell dispatch paths take it for a dead
        # connection (pull and fail over), not an application error.
        raise ConnectionRefusedError(message)
    raise _EXC_TYPES[spec.exc or d_exc or "RuntimeError"](message)


def parse_plan(text: str) -> list[FaultSpec]:
    """Parse a ``--chaos`` plan into specs: ``@path/to/plan.json`` (a list
    of spec objects) or comma-separated ``site[:key=value]...`` entries.
    Integer options are coerced; an unknown or unported site, or an
    unknown option, raises ``ValueError``."""
    text = text.strip()
    if not text:
        return []
    valid_keys = {f.name for f in fields(FaultSpec)}
    int_fields = {f.name for f in fields(FaultSpec)
                  if f.type in ("int", "int | None")}
    float_fields = {f.name for f in fields(FaultSpec)
                    if f.type in ("float", "float | None")}

    def coerce_int(key: str, value):
        try:
            return int(value)
        except (TypeError, ValueError):
            raise ValueError(
                f"Chaos plan option {key!r} must be an integer, got "
                f"{value!r}") from None

    if text.startswith("@"):
        raw = json.loads(Path(text[1:]).read_text())
        if not isinstance(raw, list):
            raise ValueError(
                f"Chaos plan file {text[1:]} must hold a JSON list of "
                "spec objects")
        specs = []
        for entry in raw:
            if not isinstance(entry, dict):
                raise ValueError(
                    f"Chaos plan entries must be objects, got {entry!r}")
            _check_site(entry.get("site"))
            unknown = set(entry) - valid_keys
            if unknown:
                raise ValueError(
                    f"Unknown chaos plan option(s) {sorted(unknown)} in "
                    f"{entry!r}; valid: {', '.join(sorted(valid_keys))}")
            kwargs = {}
            for k, v in entry.items():
                if k in int_fields:
                    kwargs[k] = coerce_int(k, v) if v is not None else None
                elif k in float_fields:
                    kwargs[k] = v   # FaultSpec validates durations
                elif v is not None and not isinstance(v, str):
                    raise ValueError(
                        f"Chaos plan option {k!r} must be a string, got "
                        f"{v!r}")
                else:
                    kwargs[k] = v
            specs.append(FaultSpec(**kwargs))
        return specs

    specs = []
    for chunk in text.split(","):
        chunk = chunk.strip()
        if not chunk:
            continue
        site, *opts = chunk.split(":")
        _check_site(site)
        kwargs: dict = {}
        for opt in opts:
            if "=" not in opt:
                raise ValueError(
                    f"Chaos plan option {opt!r} in {chunk!r} must be "
                    "key=value")
            key, value = opt.split("=", 1)
            if key not in valid_keys or key == "site":
                raise ValueError(
                    f"Unknown chaos plan option {key!r} in {chunk!r}; "
                    f"valid: {', '.join(sorted(valid_keys - {'site'}))}")
            kwargs[key] = coerce_int(key, value) if key in int_fields else value
        specs.append(FaultSpec(site=site, **kwargs))
    return specs
