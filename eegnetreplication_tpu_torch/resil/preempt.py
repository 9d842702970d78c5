"""Graceful stop on SIGTERM/SIGINT.

The subset of ``eegnetreplication_tpu/resil/preempt.py`` that serving and
training use: a signal only sets a flag; the server polls
:func:`requested` and drains, the training loop calls :func:`check` at
each epoch boundary and, in a chunked run, right after each chunk's run
snapshot was handed to the writer (raising :class:`Preempted`), and the
entry point exits :data:`EX_PREEMPTED` so a scheduler or supervisor reads
the exit as "relaunch me with --resume".

Drain hooks (:func:`add_drain_hook`) let a subsystem with durable state in
flight (the snapshot writer, ``training/async_ckpt.py``) commit it when a
stop unwinds past its own shutdown path: :func:`guard` runs them on the way
out when a stop was requested.
"""

from __future__ import annotations

import contextlib
import signal
import threading
from typing import Callable, Iterator

from eegnetreplication_tpu_torch.utils.logging import logger

# BSD EX_TEMPFAIL, the same code the JAX package's entry points exit with.
EX_PREEMPTED = 75

_flag = threading.Event()

# Hooks must be idempotent and must not raise (failures are logged): an
# orderly shutdown may already have flushed what a hook flushes.
_drain_hooks: list[Callable[[], None]] = []
_drain_lock = threading.Lock()


def add_drain_hook(fn: Callable[[], None]) -> None:
    """Run ``fn()`` at graceful-stop drain time (once registered)."""
    with _drain_lock:
        if fn not in _drain_hooks:
            _drain_hooks.append(fn)


def remove_drain_hook(fn: Callable[[], None]) -> None:
    """Unregister a drain hook (no-op when absent)."""
    with _drain_lock:
        if fn in _drain_hooks:
            _drain_hooks.remove(fn)


def run_drain_hooks() -> None:
    """Run every registered drain hook, logging (not raising) failures."""
    with _drain_lock:
        hooks = list(_drain_hooks)
    for fn in hooks:
        try:
            fn()
        except Exception as exc:  # noqa: BLE001 — drain must complete
            logger.warning("Preemption drain hook %r failed: %s", fn, exc)


_reason: str | None = None


def request(reason: str | None = None) -> None:
    """Flag a stop request (signal handlers and the ``host.preempt`` chaos
    site call this)."""
    global _reason
    _reason = reason or _reason
    _flag.set()


def requested() -> bool:
    return _flag.is_set()


def clear() -> None:
    """Reset the stop flag and the registered drain hooks."""
    global _reason
    _reason = None
    _flag.clear()
    with _drain_lock:
        _drain_hooks.clear()


class Preempted(RuntimeError):
    """A stop was requested; raised at a safe point."""


def check(**ctx) -> None:
    """Raise :class:`Preempted` if a stop was requested, after probing the
    ``host.preempt`` chaos site (so an armed plan stops the run exactly
    here).  Call only at the safe points the JAX package probes: before a
    one-pass run and at each chunk boundary."""
    from eegnetreplication_tpu_torch.resil import inject

    inject.fire("host.preempt", **ctx)
    raise_if_requested(**ctx)


def raise_if_requested(**ctx) -> None:
    """Raise :class:`Preempted` if a stop was requested (a flag read)."""
    if _flag.is_set():
        where = ", ".join(f"{k}={v}" for k, v in ctx.items())
        why = f"{_reason}; " if _reason else ""
        raise Preempted(f"stop requested ({why}{where}); rerun with --resume "
                        "to continue from the last run snapshot")


@contextlib.contextmanager
def guard(signals: tuple[int, ...] = (signal.SIGTERM, signal.SIGINT)
          ) -> Iterator[None]:
    """Install graceful-stop handlers for the block; restore on exit, and
    run the drain hooks if a stop was requested.

    Entry points only.  A second signal while the first is being honored
    falls through to the previous handler, so a stuck process can still be
    killed with a repeated Ctrl-C.
    """
    previous = {}

    def handler(signum, frame):
        name = signal.Signals(signum).name
        if _flag.is_set():
            prev = previous.get(signum)
            signal.signal(signum, prev if callable(prev) else signal.SIG_DFL)
            logger.warning("Second %s — restoring default disposition", name)
            signal.raise_signal(signum)
            return
        logger.warning("%s received — draining and stopping", name)
        request(name)

    for sig in signals:
        previous[sig] = signal.signal(sig, handler)
    try:
        yield
    finally:
        for sig, prev in previous.items():
            signal.signal(sig, prev)
        if _flag.is_set():
            run_drain_hooks()
