"""Supervisor: run train or serve as a child process with liveness and
an exit-code restart policy.

The port's copy of ``eegnetreplication_tpu/resil/supervise.py``'s
single-child supervisor.  The in-process resilience layers (retry,
preempt, snapshot fallback) cannot help a process that is dead or wedged;
the supervisor is the out-of-process half.  It launches the command as a
child with a heartbeat file configured (``EEGTPU_HEARTBEAT_FILE``, which
the port's train and serve runs beat), watches the file through a
:class:`~eegnetreplication_tpu_torch.resil.heartbeat.Watchdog` with
per-phase budgets, and applies the JAX package's policy:

====================  =====================================================
child outcome         supervisor action
====================  =====================================================
exit 0                done: supervision ends successfully
exit 75 (preempted)   relaunch at once with ``--resume`` appended
hang (stale beat)     SIGTERM (a graceful drain gets the first chance),
                      SIGKILL after ``grace_s``, relaunch with ``--resume``
exit 2 (usage)        fatal: an argparse error is not restarted (exit 64)
any other exit        transient: relaunch after an exponential backoff
                      (:class:`~eegnetreplication_tpu_torch.resil.retry.RetryPolicy`)
====================  =====================================================

A crash-loop breaker bounds the damage: ``max_restarts`` relaunches inside
the sliding ``restart_window_s`` window make the supervisor give up with
exit 70 and a journaled verdict.  A child that cannot reach the card
(``select_device`` raises without CUDA) exits 1, is ``transient``, and
ends there: nothing falls back quietly.  Every decision is a
``supervisor_*`` journal event, so a supervised run's recovery history
reads from one stream (``obs/schema.py::event_summary``).

SIGTERM or SIGINT to the supervisor is forwarded to the child and ends
supervision once the child exits (no relaunch).

:class:`MultiSupervisor` is the JAX package's supervisor of N children at
once (a replica fleet's): the same policy per child, every wait a
deadline polled beside the siblings, ``add_child``/``retire_child`` for
the autoscaler, and ``child=<name>`` on every journaled decision.

    python -m eegnetreplication_tpu_torch.resil.supervise --hang step=60 \\
        -- python -m eegnetreplication_tpu_torch.train \\
        --trainingType Within-Subject --epochs 500 --checkpointEvery 50
"""

from __future__ import annotations

import argparse
import os
import random
import subprocess
import sys
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from pathlib import Path

from eegnetreplication_tpu_torch.obs import journal as obs_journal
from eegnetreplication_tpu_torch.resil import heartbeat as hb
from eegnetreplication_tpu_torch.resil import preempt
from eegnetreplication_tpu_torch.resil import retry as resil_retry
from eegnetreplication_tpu_torch.utils.logging import logger

# Exit-code classifications (journaled with every supervisor_exit).
COMPLETED = "completed"
PREEMPTED = "preempted"
HANG = "hang"
TRANSIENT = "transient"
FATAL = "fatal"

# Supervisor's own exit codes for non-child outcomes.
EX_CRASH_LOOP = 70   # EX_SOFTWARE: the child cannot stay up
EX_FATAL = 64        # EX_USAGE-shaped: the child failed deterministically


@dataclass
class SupervisorPolicy:
    """Restart policy + liveness budgets for one supervised command."""

    grace_s: float = 30.0            # SIGTERM -> SIGKILL escalation window
    poll_s: float = 0.5              # watchdog cadence
    max_restarts: int = 5            # crash-loop breaker: restarts ...
    restart_window_s: float = 600.0  # ... inside this sliding window
    resume_arg: str | None = "--resume"  # appended once on relaunch
    fatal_exit_codes: tuple[int, ...] = (2,)
    thresholds: dict[str, float] = field(default_factory=dict)
    # Backoff between TRANSIENT relaunches (preempted/hang relaunch
    # immediately: the snapshot is fresh and the capacity event has
    # passed).  Seedable rng so tests assert exact schedules.
    backoff: resil_retry.RetryPolicy = field(
        default_factory=lambda: resil_retry.RetryPolicy(
            max_attempts=1_000_000, base_delay_s=1.0, max_delay_s=60.0))


def classify_exit(code: int, *, hang_killed: bool = False,
                  fatal_exit_codes: tuple[int, ...] = (2,)) -> str:
    """Map a child exit code (plus whether WE killed it for a hang) onto
    the restart policy's vocabulary."""
    if hang_killed:
        return HANG
    if code == 0:
        return COMPLETED
    if code == preempt.EX_PREEMPTED:
        return PREEMPTED
    if code in fatal_exit_codes:
        return FATAL
    return TRANSIENT


class Supervisor:
    """Launch, watch, and relaunch one child command under a policy."""

    def __init__(self, cmd: list[str], *,
                 policy: SupervisorPolicy | None = None,
                 heartbeat_file: str | Path | None = None,
                 journal=None, env: dict | None = None,
                 sleep=time.sleep, popen=subprocess.Popen):
        if not cmd:
            raise ValueError("supervisor needs a non-empty child command")
        self.cmd = list(cmd)
        self.policy = policy or SupervisorPolicy()
        self.heartbeat_file = Path(heartbeat_file) if heartbeat_file else None
        self.journal = journal if journal is not None \
            else obs_journal.current()
        self.watchdog = hb.Watchdog(self.policy.thresholds)
        self._env = env
        self._sleep = sleep
        self._popen = popen
        self._restarts: deque[float] = deque()  # relaunch timestamps
        self.attempt = 0

    # -- child lifecycle --------------------------------------------------
    def _launch(self, resume: bool) -> subprocess.Popen:
        cmd = list(self.cmd)
        if resume and self.policy.resume_arg \
                and self.policy.resume_arg not in cmd:
            cmd.append(self.policy.resume_arg)
        env = dict(self._env if self._env is not None else os.environ)
        if self.heartbeat_file is not None:
            # A beat file left by the PREVIOUS launch must not vouch for
            # this one (the watchdog also pid-gates, belt and braces).
            self.heartbeat_file.unlink(missing_ok=True)
            env[hb.HEARTBEAT_FILE_ENV] = str(self.heartbeat_file)
        self.attempt += 1
        child = self._popen(cmd, env=env)
        self.journal.event("supervisor_launch", attempt=self.attempt,
                           cmd=cmd, pid=child.pid, resume=resume)
        logger.info("Supervisor launched attempt %d (pid %d): %s",
                    self.attempt, child.pid, " ".join(cmd))
        return child

    def _terminate(self, child: subprocess.Popen, verdict: hb.Staleness
                   ) -> None:
        """SIGTERM -> grace -> SIGKILL; journals each escalation step."""
        self.journal.event(
            "supervisor_hang", attempt=self.attempt, pid=child.pid,
            age_s=round(verdict.age_s, 3),
            threshold_s=round(verdict.threshold_s, 3), phase=verdict.phase)
        self.journal.metrics.inc("supervisor_hangs")
        logger.warning(
            "Supervisor: child %d looks hung (phase %s, last beat %.1fs "
            "ago, budget %.1fs) — sending SIGTERM", child.pid,
            verdict.phase, verdict.age_s, verdict.threshold_s)
        child.terminate()
        deadline = time.monotonic() + self.policy.grace_s
        while child.poll() is None and time.monotonic() < deadline:
            self._sleep(min(self.policy.poll_s, 0.2))
        if child.poll() is None:
            self.journal.event("supervisor_escalate", attempt=self.attempt,
                               pid=child.pid, signal="SIGKILL",
                               grace_s=self.policy.grace_s)
            logger.warning(
                "Supervisor: child %d survived SIGTERM for %.1fs — "
                "SIGKILL", child.pid, self.policy.grace_s)
            child.kill()
        child.wait()

    def _watch(self, child: subprocess.Popen) -> bool:
        """Block until the child exits; returns True when WE killed it for
        a hang.  Forwards a stop request (SIGTERM/SIGINT to the
        supervisor) to the child."""
        launched = time.time()
        stop_deadline: float | None = None
        while child.poll() is None:
            self._sleep(self.policy.poll_s)
            if preempt.requested() and stop_deadline is None:
                stop_deadline = time.monotonic() + self.policy.grace_s
                logger.warning("Supervisor: stop requested — forwarding "
                               "SIGTERM to child %d", child.pid)
                child.terminate()
                continue
            if stop_deadline is not None:
                # The forwarded stop gets the same grace as a hang kill:
                # a child wedged mid-drain must not pin the supervisor.
                if time.monotonic() >= stop_deadline:
                    self.journal.event("supervisor_escalate",
                                       attempt=self.attempt, pid=child.pid,
                                       signal="SIGKILL",
                                       grace_s=self.policy.grace_s)
                    child.kill()
                continue
            if self.heartbeat_file is None:
                continue
            verdict = self.watchdog.check_file(
                self.heartbeat_file, since=launched, pid=child.pid)
            if verdict.stale:
                self._terminate(child, verdict)
                return True
        return False

    # -- the supervision loop ---------------------------------------------
    def _crash_loop_tripped(self, now: float) -> bool:
        window = self.policy.restart_window_s
        while self._restarts and now - self._restarts[0] > window:
            self._restarts.popleft()
        return len(self._restarts) >= self.policy.max_restarts

    def run(self) -> int:
        """Supervise until completion, a fatal exit, a crash-loop verdict,
        or an external stop; returns the supervisor's exit code."""
        self.journal.event("supervisor_start", cmd=self.cmd,
                           grace_s=self.policy.grace_s,
                           max_restarts=self.policy.max_restarts,
                           restart_window_s=self.policy.restart_window_s,
                           heartbeat_file=(str(self.heartbeat_file)
                                           if self.heartbeat_file else None))
        resume = False
        transient_attempts = 0
        while True:
            child = self._launch(resume)
            hang_killed = self._watch(child)
            code = child.wait()
            kind = classify_exit(
                code, hang_killed=hang_killed,
                fatal_exit_codes=self.policy.fatal_exit_codes)
            self.journal.event("supervisor_exit", attempt=self.attempt,
                               exit_code=code, classification=kind)
            logger.info("Supervisor: attempt %d exited %d (%s)",
                        self.attempt, code, kind)
            if preempt.requested():
                # Our own stop request: the child was already asked to
                # drain; end supervision with its exit code, no relaunch.
                self.journal.event("supervisor_end", status="stopped",
                                   exit_code=code)
                return code
            if kind == COMPLETED:
                self.journal.event("supervisor_end", status=COMPLETED,
                                   exit_code=0)
                return 0
            if kind == FATAL:
                self.journal.event("supervisor_end", status=FATAL,
                                   exit_code=code)
                logger.error("Supervisor: fatal child exit %d — not "
                             "restarting", code)
                return EX_FATAL
            # PREEMPTED / HANG / TRANSIENT all relaunch, gated by the
            # crash-loop breaker.
            now = time.monotonic()
            if self._crash_loop_tripped(now):
                self.journal.event(
                    "supervisor_giveup", restarts=len(self._restarts),
                    window_s=self.policy.restart_window_s,
                    last_exit_code=code, last_classification=kind)
                self.journal.event("supervisor_end", status="crash_loop",
                                   exit_code=code)
                logger.error(
                    "Supervisor: crash-loop breaker tripped (%d restarts "
                    "inside %.0fs) — giving up", len(self._restarts),
                    self.policy.restart_window_s)
                return EX_CRASH_LOOP
            self._restarts.append(now)
            if kind == TRANSIENT:
                transient_attempts += 1
                delay = self.policy.backoff.delay(transient_attempts)
            else:
                transient_attempts = 0
                delay = 0.0
            resume = resume or self.policy.resume_arg is not None
            self.journal.event("supervisor_restart", attempt=self.attempt,
                               reason=kind, delay_s=round(delay, 3),
                               resume=resume)
            self.journal.metrics.inc("supervisor_restarts", reason=kind)
            logger.warning(
                "Supervisor: relaunching after %s exit (backoff %.2fs%s)",
                kind, delay, ", --resume appended" if resume else "")
            if delay > 0:
                self._sleep(delay)


@dataclass
class ChildSpec:
    """One child of a :class:`MultiSupervisor`: a name (journaled on every
    decision about it), the command, its own heartbeat file, and optional
    per-child environment overrides (the fleet uses these to give each
    replica its own port/heartbeat without N command templates)."""

    name: str
    cmd: list[str]
    heartbeat_file: str | Path | None = None
    env: dict | None = None


# _Child terminal/active states (MultiSupervisor bookkeeping).
_RUNNING = "running"
_BACKOFF = "backoff"        # waiting for relaunch_at
_DONE = "done"
_FATAL = "fatal"
_CRASH_LOOP = "crash_loop"


class _Child:
    """Runtime state for one supervised child (internal to
    :class:`MultiSupervisor`; exposed read-only through ``children``)."""

    def __init__(self, spec: ChildSpec):
        self.spec = spec
        self.proc: subprocess.Popen | None = None
        self.state = _BACKOFF
        self.relaunch_at = 0.0          # monotonic instant for _BACKOFF
        self.launched_t = 0.0           # time.time() of the last launch
        self.attempt = 0
        self.resume = False
        self.transient_attempts = 0
        self.restarts: deque[float] = deque()
        self.hang_killed = False
        self.term_deadline: float | None = None  # SIGTERM->SIGKILL window
        self.last_exit: int | None = None
        self.retiring = False           # retire_child asked for teardown

    @property
    def pid(self) -> int | None:
        return self.proc.pid if self.proc is not None else None

    @property
    def terminal(self) -> bool:
        return self.state in (_DONE, _FATAL, _CRASH_LOOP)


class MultiSupervisor:
    """Supervise N children concurrently under one policy, independently.

    The single-child :class:`Supervisor` blocks on its one child; a
    replica fleet needs N children where one crash restarts ONE child
    while its siblings keep serving.  Each child gets its own heartbeat
    watchdog (pid-gated, per-phase budgets), its own SIGTERM->SIGKILL
    escalation window, its own transient-restart backoff (non-blocking —
    a backing-off child never delays a sibling's supervision), and its own
    sliding-window crash-loop breaker: a child that cannot stay up is
    retired with a journaled ``supervisor_giveup`` while the rest of the
    fleet keeps running.  Every event carries ``child=<name>``.

    A stop request (SIGTERM/SIGINT under ``preempt.guard``, or
    :meth:`stop` for in-process embedders like the fleet bench) forwards
    SIGTERM to every running child, escalates stragglers after
    ``grace_s``, and ends supervision with no relaunches.

    Membership is dynamic: :meth:`add_child` joins a new child to a
    running supervisor (launched by the loop's next poll) and
    :meth:`retire_child` tears down exactly the named child — SIGTERM,
    grace, SIGKILL — without disturbing siblings, then forgets its
    crash-loop breaker state entirely, so the autoscaler can grow and
    shrink the fleet through the same per-child machinery a static fleet
    already trusts.  Once either has been called, ``run()`` keeps
    supervising through all-terminal instants and exits only on a stop.

    ``run()`` returns 0 when every child completed (a drain exit —
    ``EX_PREEMPTED`` after our own stop — counts as completed),
    ``EX_CRASH_LOOP`` when any child was retired by its breaker, else
    ``EX_FATAL`` when any child exited fatally — including children
    retired BEFORE a stop request arrived (``supervisor_end`` then says
    ``status="stopped"`` but keeps the degraded code).

    Deliberately a separate loop from :class:`Supervisor` rather than a
    generalization of it: the single-child supervisor blocks through its
    backoff sleeps and its hang-kill grace window (semantics its tests
    pin exactly, e.g. the seeded backoff schedule), while N children
    need every wait to be a DEADLINE polled alongside the siblings so
    one bouncing replica never stalls another's supervision.  The shared
    vocabulary (classify_exit, SupervisorPolicy, the journal event
    shapes) is factored; the loops are not.
    """

    def __init__(self, specs: list[ChildSpec], *,
                 policy: SupervisorPolicy | None = None,
                 journal=None, env: dict | None = None,
                 sleep=time.sleep, popen=subprocess.Popen):
        if not specs:
            raise ValueError("MultiSupervisor needs at least one child")
        names = [s.name for s in specs]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate child names: {names}")
        self.policy = policy or SupervisorPolicy()
        self.journal = journal if journal is not None \
            else obs_journal.current()
        self.watchdog = hb.Watchdog(self.policy.thresholds)
        self._env = env
        self._sleep = sleep
        self._popen = popen
        self._stop = False
        self._stop_lock = threading.Lock()
        # Guards mutation of the children dict (add_child/retire_child run
        # on other threads — e.g. the autoscaler — while run() polls).
        self._children_lock = threading.Lock()
        # Set by the first add_child/retire_child: an elastic fleet keeps
        # supervising through transient all-terminal instants (a retire
        # can empty the dict just before the next scale-up) and only exits
        # on an explicit stop.
        self._dynamic = False
        self.children: dict[str, _Child] = {
            s.name: _Child(s) for s in specs}

    # -- external control --------------------------------------------------
    def stop(self) -> None:
        """Request a graceful stop (thread-safe): children get SIGTERM at
        the next poll, stragglers SIGKILL after ``grace_s``."""
        with self._stop_lock:
            self._stop = True

    def _stop_requested(self) -> bool:
        with self._stop_lock:
            if self._stop:
                return True
        return preempt.requested()

    # -- dynamic membership (the autoscaler's seam) ------------------------
    def add_child(self, spec: ChildSpec) -> None:
        """Add one child to a RUNNING supervisor (thread-safe).

        The child starts in backoff with an immediate relaunch deadline,
        so the supervision loop launches it on its next poll — all
        process operations stay on the supervising thread.  A re-added
        name gets a brand-new :class:`_Child`: the previous incarnation's
        crash-loop breaker window, attempt count, and resume flag are
        deliberately forgotten (retirement is not a crash).
        """
        with self._children_lock:
            if spec.name in self.children:
                raise ValueError(f"duplicate child name: {spec.name!r}")
            self._dynamic = True
            self.children[spec.name] = _Child(spec)

    def retire_child(self, name: str, *, wait_s: float | None = 10.0
                     ) -> bool:
        """Retire ONE named child: SIGTERM, ``grace_s``, SIGKILL, then
        forget it — siblings are never touched (thread-safe).

        The teardown itself happens on the supervision thread (the only
        thread that owns child processes); this call marks the child and,
        with ``wait_s``, blocks until the loop has reaped it.  Returns
        True once the child is gone (an unknown name counts — retiring
        twice must be idempotent), False on a wait timeout.
        """
        with self._children_lock:
            self._dynamic = True
            child = self.children.get(name)
            if child is None:
                return True
            child.retiring = True
        if wait_s is None:
            return False
        deadline = time.monotonic() + wait_s
        while time.monotonic() < deadline:
            with self._children_lock:
                if name not in self.children:
                    return True
            time.sleep(min(self.policy.poll_s, 0.05))
        with self._children_lock:
            return name not in self.children

    def _reap_retiring(self, child: _Child) -> None:
        """Tear down one retiring child without blocking the loop:
        SIGTERM now, SIGKILL at the grace deadline, and once the process
        is gone drop the child from the dict entirely (its breaker
        history dies with it)."""
        proc = child.proc
        if proc is not None and proc.poll() is None:
            if child.term_deadline is None:
                logger.info("MultiSupervisor: retiring %s (pid %d) — "
                            "SIGTERM", child.spec.name, proc.pid)
                proc.terminate()
                child.term_deadline = time.monotonic() + self.policy.grace_s
            self._escalate_if_due(child)
            if proc.poll() is None:
                return  # still draining; reap on a later poll
        code = proc.wait() if proc is not None else None
        child.last_exit = code
        child.state = _DONE
        self.journal.event("supervisor_exit", child=child.spec.name,
                           attempt=child.attempt, exit_code=code,
                           classification="retired")
        logger.info("MultiSupervisor: child %s retired (exit %s)",
                    child.spec.name, code)
        with self._children_lock:
            self.children.pop(child.spec.name, None)

    # -- per-child lifecycle ----------------------------------------------
    def _launch(self, child: _Child) -> None:
        spec = child.spec
        cmd = list(spec.cmd)
        if child.resume and self.policy.resume_arg \
                and self.policy.resume_arg not in cmd:
            cmd.append(self.policy.resume_arg)
        env = dict(self._env if self._env is not None else os.environ)
        if spec.env:
            env.update({k: str(v) for k, v in spec.env.items()})
        if spec.heartbeat_file is not None:
            Path(spec.heartbeat_file).unlink(missing_ok=True)
            env[hb.HEARTBEAT_FILE_ENV] = str(spec.heartbeat_file)
        child.attempt += 1
        child.hang_killed = False
        child.term_deadline = None
        child.launched_t = time.time()
        child.proc = self._popen(cmd, env=env)
        child.state = _RUNNING
        self.journal.event("supervisor_launch", child=spec.name,
                           attempt=child.attempt, cmd=cmd,
                           pid=child.proc.pid, resume=child.resume)
        logger.info("MultiSupervisor launched %s attempt %d (pid %d)",
                    spec.name, child.attempt, child.proc.pid)

    def _begin_hang_kill(self, child: _Child, verdict: hb.Staleness) -> None:
        """SIGTERM now, arm the non-blocking SIGKILL deadline — a hung
        child's grace window must not stall its siblings' supervision."""
        assert child.proc is not None
        self.journal.event("supervisor_hang", child=child.spec.name,
                           attempt=child.attempt, pid=child.proc.pid,
                           age_s=round(verdict.age_s, 3),
                           threshold_s=round(verdict.threshold_s, 3),
                           phase=verdict.phase)
        self.journal.metrics.inc("supervisor_hangs")
        logger.warning(
            "MultiSupervisor: child %s (pid %d) looks hung (phase %s, "
            "last beat %.1fs ago, budget %.1fs) — SIGTERM",
            child.spec.name, child.proc.pid, verdict.phase, verdict.age_s,
            verdict.threshold_s)
        child.hang_killed = True
        child.term_deadline = time.monotonic() + self.policy.grace_s
        child.proc.terminate()

    def _escalate_if_due(self, child: _Child) -> None:
        if child.term_deadline is None or child.proc is None:
            return
        if time.monotonic() < child.term_deadline:
            return
        self.journal.event("supervisor_escalate", child=child.spec.name,
                           attempt=child.attempt, pid=child.proc.pid,
                           signal="SIGKILL", grace_s=self.policy.grace_s)
        logger.warning("MultiSupervisor: child %s survived SIGTERM for "
                       "%.1fs — SIGKILL", child.spec.name,
                       self.policy.grace_s)
        child.proc.kill()
        child.term_deadline = None

    def _crash_loop_tripped(self, child: _Child, now: float) -> bool:
        window = self.policy.restart_window_s
        while child.restarts and now - child.restarts[0] > window:
            child.restarts.popleft()
        return len(child.restarts) >= self.policy.max_restarts

    def _on_exit(self, child: _Child, stopping: bool) -> None:
        """Classify one child's exit; schedule its relaunch or retire it.
        Never blocks (backoff is a deadline, not a sleep)."""
        assert child.proc is not None
        code = child.proc.wait()
        child.last_exit = code
        kind = classify_exit(code, hang_killed=child.hang_killed,
                             fatal_exit_codes=self.policy.fatal_exit_codes)
        if stopping and kind == PREEMPTED:
            # Our own stop request drained it: that is completion here.
            kind = COMPLETED
        self.journal.event("supervisor_exit", child=child.spec.name,
                           attempt=child.attempt, exit_code=code,
                           classification=kind)
        logger.info("MultiSupervisor: child %s attempt %d exited %d (%s)",
                    child.spec.name, child.attempt, code, kind)
        if stopping:
            # Under a stop, any non-fatal exit is a completed drain.
            child.state = _FATAL if kind == FATAL else _DONE
            return
        if kind == COMPLETED:
            child.state = _DONE
            return
        if kind == FATAL:
            child.state = _FATAL
            logger.error("MultiSupervisor: child %s fatal exit %d — not "
                         "restarting", child.spec.name, code)
            return
        now = time.monotonic()
        if self._crash_loop_tripped(child, now):
            self.journal.event("supervisor_giveup", child=child.spec.name,
                               restarts=len(child.restarts),
                               window_s=self.policy.restart_window_s,
                               last_exit_code=code,
                               last_classification=kind)
            child.state = _CRASH_LOOP
            logger.error(
                "MultiSupervisor: child %s crash-loop breaker tripped "
                "(%d restarts inside %.0fs) — retiring it",
                child.spec.name, len(child.restarts),
                self.policy.restart_window_s)
            return
        child.restarts.append(now)
        if kind == TRANSIENT:
            child.transient_attempts += 1
            delay = self.policy.backoff.delay(child.transient_attempts)
        else:
            child.transient_attempts = 0
            delay = 0.0
        child.resume = child.resume or self.policy.resume_arg is not None
        child.state = _BACKOFF
        child.relaunch_at = now + delay
        self.journal.event("supervisor_restart", child=child.spec.name,
                           attempt=child.attempt, reason=kind,
                           delay_s=round(delay, 3), resume=child.resume)
        self.journal.metrics.inc("supervisor_restarts", reason=kind)
        logger.warning("MultiSupervisor: relaunching %s after %s exit "
                       "(backoff %.2fs)", child.spec.name, kind, delay)

    # -- the supervision loop ---------------------------------------------
    def _poll_child(self, child: _Child, stopping: bool) -> None:
        if child.terminal:
            return
        if child.retiring:
            # Checked before _BACKOFF so a retiring child is never
            # (re)launched — retire_child only sets the flag; every
            # process operation happens here, on this thread.
            self._reap_retiring(child)
            return
        if child.state == _BACKOFF:
            if stopping:
                child.state = _DONE  # never launched again under a stop
            elif time.monotonic() >= child.relaunch_at:
                self._launch(child)
            return
        assert child.proc is not None
        if child.proc.poll() is not None:
            self._on_exit(child, stopping)
            return
        if stopping:
            if child.term_deadline is None:
                logger.warning("MultiSupervisor: stop requested — "
                               "forwarding SIGTERM to %s (pid %d)",
                               child.spec.name, child.proc.pid)
                child.proc.terminate()
                child.term_deadline = time.monotonic() + self.policy.grace_s
            self._escalate_if_due(child)
            return
        self._escalate_if_due(child)
        if child.term_deadline is not None \
                or child.spec.heartbeat_file is None:
            return
        verdict = self.watchdog.check_file(
            child.spec.heartbeat_file, since=child.launched_t,
            pid=child.proc.pid)
        if verdict.stale:
            self._begin_hang_kill(child, verdict)

    def run(self) -> int:
        """Supervise until every child is retired/complete (or a stop
        request drains the fleet); returns the aggregate exit code."""
        self.journal.event(
            "supervisor_start", mode="multi",
            cmd=[c.spec.cmd for c in self.children.values()],
            children=list(self.children),
            grace_s=self.policy.grace_s,
            max_restarts=self.policy.max_restarts,
            restart_window_s=self.policy.restart_window_s)
        stopping = False
        while True:
            if not stopping and self._stop_requested():
                stopping = True
            with self._children_lock:
                kids = list(self.children.values())
            for child in kids:
                self._poll_child(child, stopping)
            with self._children_lock:
                # A dynamic fleet only exits on an explicit stop: between
                # a retire and the next scale-up, "everyone is terminal"
                # (or the dict is momentarily empty) is a normal instant,
                # not the end of supervision.
                done = all(c.terminal for c in self.children.values()) \
                    and (stopping or not self._dynamic)
            if done:
                break
            self._sleep(self.policy.poll_s)
        states = {name: c.state for name, c in self.children.items()}
        # The exit code reports the worst child outcome even under a stop
        # request: a child retired by its crash-loop breaker (or a fatal
        # exit) before the operator's SIGTERM is still a degraded fleet,
        # and scripts gating on the code must not read it as green.  Only
        # the STATUS distinguishes "we were asked to stop" from "all
        # children ran to completion".
        if any(c.state == _CRASH_LOOP for c in self.children.values()):
            status, code = "crash_loop", EX_CRASH_LOOP
        elif any(c.state == _FATAL for c in self.children.values()):
            status, code = FATAL, EX_FATAL
        else:
            status, code = COMPLETED, 0
        if stopping:
            status = "stopped"
        self.journal.event("supervisor_end", status=status,
                           exit_code=code, children=states)
        logger.info("MultiSupervisor: done (%s): %s", status, states)
        return code


def _parse_thresholds(specs: list[str]) -> dict[str, float]:
    out: dict[str, float] = {}
    for spec in specs:
        for chunk in spec.split(","):
            chunk = chunk.strip()
            if not chunk:
                continue
            if "=" not in chunk:
                raise ValueError(
                    f"--hang entries must be phase=seconds, got {chunk!r}")
            phase, _, value = chunk.partition("=")
            try:
                out[phase.strip()] = float(value)
            except ValueError:
                raise ValueError(
                    f"--hang {chunk!r}: seconds must be a number") from None
    return out


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="python -m eegnetreplication_tpu_torch.resil.supervise",
        description="Supervise a train/serve command: heartbeat watchdog, "
                    "hang SIGTERM->SIGKILL escalation, exit-code restart "
                    "policy, crash-loop breaker.",
        epilog="Everything after `--` is the child command.")
    parser.add_argument("--metricsDir", default=None,
                        help="Run-journal root for supervisor_* events "
                             "(default reports/obs).")
    parser.add_argument("--heartbeatFile", default=None,
                        help="Heartbeat file shared with the child "
                             "(default: <run dir>/heartbeat.json).")
    parser.add_argument("--graceS", type=float, default=30.0,
                        help="SIGTERM -> SIGKILL escalation window.")
    parser.add_argument("--pollS", type=float, default=0.5,
                        help="Watchdog poll cadence.")
    parser.add_argument("--hang", action="append", default=[],
                        metavar="PHASE=SECONDS",
                        help="Per-phase staleness budget override, "
                             "comma-separable (phases: startup, compile, "
                             "step, fetch, serve_idle, serve_forward). "
                             "Repeatable.")
    parser.add_argument("--maxRestarts", type=int, default=5,
                        help="Crash-loop breaker: give up after this many "
                             "relaunches inside --restartWindowS.")
    parser.add_argument("--restartWindowS", type=float, default=600.0,
                        help="Sliding window for the crash-loop breaker.")
    parser.add_argument("--resumeArg", default="--resume",
                        help="Flag appended to the child command on "
                             "relaunch ('' disables).")
    parser.add_argument("--backoffBaseS", type=float, default=1.0,
                        help="Base delay of the transient-restart backoff.")
    parser.add_argument("--backoffSeed", type=int, default=None,
                        help="Seed the backoff jitter (reproducible "
                             "restart schedules).")
    parser.add_argument("cmd", nargs=argparse.REMAINDER,
                        help="-- followed by the child command.")
    return parser


def main(argv=None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    cmd = list(args.cmd)
    if cmd and cmd[0] == "--":
        cmd = cmd[1:]
    if not cmd:
        parser.error("no child command given (put it after `--`)")
    try:
        thresholds = _parse_thresholds(args.hang)
    except ValueError as exc:
        parser.error(str(exc))

    from eegnetreplication_tpu_torch.config import Paths

    metrics_dir = (Path(args.metricsDir) if args.metricsDir
                   else Paths.from_here().reports / "obs")
    policy = SupervisorPolicy(
        grace_s=args.graceS, poll_s=args.pollS,
        max_restarts=args.maxRestarts,
        restart_window_s=args.restartWindowS,
        resume_arg=args.resumeArg or None, thresholds=thresholds,
        backoff=resil_retry.RetryPolicy(
            max_attempts=1_000_000, base_delay_s=args.backoffBaseS,
            max_delay_s=60.0,
            rng=(random.Random(args.backoffSeed)
                 if args.backoffSeed is not None else None)))
    with obs_journal.run(metrics_dir, config=vars(args),
                         role="supervisor") as journal, preempt.guard():
        heartbeat_file = (Path(args.heartbeatFile) if args.heartbeatFile
                          else journal.dir / "heartbeat.json")
        sup = Supervisor(cmd, policy=policy, heartbeat_file=heartbeat_file,
                         journal=journal)
        code = sup.run()
        journal.run_end(status="ok" if code == 0 else "error",
                        error=None if code == 0
                        else f"supervisor exit {code}")
    return code


if __name__ == "__main__":
    sys.exit(main())
