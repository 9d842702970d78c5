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
supervision once the child exits (no relaunch).  The JAX package's
``MultiSupervisor`` (one supervisor for a fleet's replicas) is not ported:
it has no consumer until ``serve/fleet/`` is (ROADMAP.md queue A.6).

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
