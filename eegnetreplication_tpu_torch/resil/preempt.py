"""Graceful stop on SIGTERM/SIGINT.

The subset of ``eegnetreplication_tpu/resil/preempt.py`` that serving and
training use: a signal only sets a flag; the server polls
:func:`requested` and drains, the training loop calls :func:`check` at
each epoch boundary (raising :class:`Preempted`), and the entry point exits
:data:`EX_PREEMPTED` so a scheduler or supervisor reads the exit as
"relaunch me".
"""

from __future__ import annotations

import contextlib
import signal
import threading
from typing import Iterator

from eegnetreplication_tpu_torch.utils.logging import logger

# BSD EX_TEMPFAIL, the same code the JAX package's entry points exit with.
EX_PREEMPTED = 75

_flag = threading.Event()


def request() -> None:
    """Flag a stop request (signal handlers call this)."""
    _flag.set()


def requested() -> bool:
    return _flag.is_set()


def clear() -> None:
    _flag.clear()


class Preempted(RuntimeError):
    """A stop was requested; raised at a safe point."""


def check(**ctx) -> None:
    """Raise :class:`Preempted` if a stop was requested (a flag read)."""
    if _flag.is_set():
        where = ", ".join(f"{k}={v}" for k, v in ctx.items())
        raise Preempted(f"stop requested ({where})")


@contextlib.contextmanager
def guard(signals: tuple[int, ...] = (signal.SIGTERM, signal.SIGINT)
          ) -> Iterator[None]:
    """Install graceful-stop handlers for the block; restore on exit.

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
        request()

    for sig in signals:
        previous[sig] = signal.signal(sig, handler)
    try:
        yield
    finally:
        for sig, prev in previous.items():
            signal.signal(sig, prev)
