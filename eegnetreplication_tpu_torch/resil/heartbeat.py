"""Liveness heartbeats: monotonic beats + per-phase staleness watchdog.

The port's copy of ``eegnetreplication_tpu/resil/heartbeat.py``.  A
long-lived loop calls :func:`beat` (or its :class:`Heartbeat`'s ``beat``)
at its progress points; the serve batcher worker beats ``serve_idle``
while it polls and ``serve_forward`` around each dispatch.  A
:class:`Watchdog` judges the last beat live or stale against per-phase
budgets (a forward may go quiet longer than an idle poll), which is how
``/healthz`` tells a wedged worker from an idle one.

Beats are cheap: an in-memory record always, an atomically replaced
one-line JSON file only when a path is configured
(``EEGTPU_HEARTBEAT_FILE`` or an explicit :class:`Heartbeat` path), file
writes throttled to ``min_write_interval_s``, and ``heartbeat`` journal
events throttled to ``journal_every_s``.
"""

from __future__ import annotations

import json
import os
import threading
import time
from dataclasses import dataclass
from pathlib import Path

from eegnetreplication_tpu_torch.utils.logging import logger

# Environment knob the supervisor sets for its child process: when
# present, the process-default emitter writes beats to this file so an
# external watchdog can judge liveness without any IPC.
HEARTBEAT_FILE_ENV = "EEGTPU_HEARTBEAT_FILE"

# Per-phase staleness budgets (seconds without a beat before the phase
# counts as hung), the JAX package's: "startup" is the phase a supervisor
# assumes between launch and the first beat, "compile" a program build,
# "step" the training cadence, "fetch" a download, and the serve phases
# the batcher worker's idle poll and in-flight forward.
DEFAULT_THRESHOLDS: dict[str, float] = {
    "startup": 600.0,
    "compile": 1800.0,
    "step": 600.0,
    "fetch": 900.0,
    "serve_idle": 30.0,
    "serve_forward": 120.0,
}
DEFAULT_THRESHOLD_S = 600.0


@dataclass(frozen=True)
class Beat:
    """One liveness beat: who, where in the lifecycle, and when."""

    phase: str
    beat: int       # monotonic per-emitter counter
    t: float        # time.time() of the beat
    pid: int

    def age_s(self, now: float | None = None) -> float:
        return max(0.0, (now if now is not None else time.time()) - self.t)


class Heartbeat:
    """Thread-safe beat emitter: in-memory always, file + journal throttled.

    ``path=None`` keeps beats in-process only (the serve worker's
    ``/healthz`` staleness check needs no file); with a path each beat is
    written as one JSON line via same-directory temp + ``os.replace`` so a
    reader can never observe a torn record.
    """

    def __init__(self, path: str | Path | None = None, *,
                 min_write_interval_s: float = 0.5,
                 journal_every_s: float = 30.0):
        self.path = Path(path) if path else None
        self.min_write_interval_s = float(min_write_interval_s)
        self.journal_every_s = float(journal_every_s)
        self._lock = threading.Lock()
        self._count = 0
        self._last: Beat | None = None
        self._last_write = 0.0
        self._last_journal = 0.0

    def beat(self, phase: str = "step", **ctx) -> Beat:
        """Record one beat; write/journal it when the throttles allow."""
        now = time.time()
        with self._lock:
            self._count += 1
            record = Beat(phase=phase, beat=self._count, t=now,
                          pid=os.getpid())
            prev = self._last
            self._last = record
            # A phase CHANGE is always persisted immediately: the watchdog
            # judges staleness against the recorded phase's budget, so a
            # beat that enters "serve_forward" must not sit behind the
            # write throttle while the old "serve_idle" budget applies.
            write = (self.path is not None
                     and (now - self._last_write >= self.min_write_interval_s
                          or prev is None or phase != prev.phase))
            if write:
                self._last_write = now
            journal = now - self._last_journal >= self.journal_every_s
            if journal:
                self._last_journal = now
        if write:
            self._write(record)
        if journal:
            from eegnetreplication_tpu_torch.obs import journal as obs_journal

            jr = obs_journal.current()
            jr.event("heartbeat", phase=phase, beat=record.beat, **ctx)
            jr.metrics.set("heartbeat_age_s", 0.0)
        return record

    def last(self) -> Beat | None:
        """The most recent beat recorded by THIS emitter (in-memory)."""
        with self._lock:
            return self._last

    def _write(self, record: Beat) -> None:
        assert self.path is not None
        try:
            self.path.parent.mkdir(parents=True, exist_ok=True)
            tmp = self.path.with_name(f"{self.path.name}.{record.pid}.tmp")
            tmp.write_text(json.dumps(record.__dict__))
            os.replace(tmp, self.path)
        except OSError as exc:
            # Same contract as the journal: liveness telemetry must never
            # kill the run it is reporting on.
            logger.warning("Heartbeat write to %s failed: %s", self.path, exc)


def read(path: str | Path) -> Beat | None:
    """Parse a heartbeat file; ``None`` when missing or unreadable (a
    torn/garbled file is indistinguishable from no beat and is treated as
    such — the watchdog's missing-beat path owns that verdict)."""
    try:
        raw = json.loads(Path(path).read_text())
        return Beat(phase=str(raw["phase"]), beat=int(raw["beat"]),
                    t=float(raw["t"]), pid=int(raw["pid"]))
    except (OSError, ValueError, KeyError, TypeError):
        return None


@dataclass(frozen=True)
class Staleness:
    """A watchdog verdict: how long since the last beat, and whether that
    exceeds the budget of the phase the process said it was in."""

    stale: bool
    age_s: float
    phase: str
    threshold_s: float
    beat: Beat | None = None


class Watchdog:
    """Classify a heartbeat as live or stale against per-phase budgets."""

    def __init__(self, thresholds: dict[str, float] | None = None,
                 default_s: float = DEFAULT_THRESHOLD_S):
        merged = dict(DEFAULT_THRESHOLDS)
        merged.update(thresholds or {})
        self.thresholds = merged
        self.default_s = float(default_s)

    def threshold_for(self, phase: str) -> float:
        return float(self.thresholds.get(phase, self.default_s))

    def check_beat(self, beat: Beat | None, *, now: float | None = None,
                   since: float | None = None) -> Staleness:
        """Verdict for an in-memory/parsed beat.

        ``beat=None`` (no beat yet) is judged as the synthetic ``startup``
        phase aged from ``since`` (the supervisor passes the child launch
        time); without ``since`` a missing beat is not stale — there is
        nothing to age against.
        """
        now = time.time() if now is None else now
        if beat is None:
            threshold = self.threshold_for("startup")
            if since is None:
                return Staleness(False, 0.0, "startup", threshold, None)
            age = max(0.0, now - since)
            return Staleness(age > threshold, age, "startup", threshold, None)
        age = beat.age_s(now)
        threshold = self.threshold_for(beat.phase)
        return Staleness(age > threshold, age, beat.phase, threshold, beat)

    def check_file(self, path: str | Path, *, now: float | None = None,
                   since: float | None = None,
                   pid: int | None = None) -> Staleness:
        """Verdict for a heartbeat file.  ``pid`` (when given) discards
        beats written by a different process — a stale file left by a
        previous launch must not vouch for the current one."""
        beat = read(path)
        if beat is not None and pid is not None and beat.pid != pid:
            beat = None
        return self.check_beat(beat, now=now, since=since)


# -- process-default emitter -------------------------------------------------
# Library code (training loop, fetch, serve worker) beats through the
# process default so no emitter object threads through every signature;
# the file path comes from EEGTPU_HEARTBEAT_FILE (set by the supervisor).
_default: Heartbeat | None = None
_default_lock = threading.Lock()


def emitter() -> Heartbeat:
    """The process-default emitter (lazily built from the environment)."""
    global _default
    with _default_lock:
        if _default is None:
            _default = Heartbeat(os.environ.get(HEARTBEAT_FILE_ENV) or None)
        return _default


def beat(phase: str = "step", **ctx) -> Beat:
    """Beat the process-default emitter (the one-liner instrumented code
    calls; a dict lookup + timestamp when nothing is configured)."""
    return emitter().beat(phase, **ctx)


def reset_default() -> None:
    """Drop the process-default emitter so the next :func:`beat` re-reads
    the environment (test isolation; also used after a supervisor launch
    changes the env for in-process children)."""
    global _default
    with _default_lock:
        _default = None
