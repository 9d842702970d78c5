"""Fault classes, the shared ``retry`` journal record, and backoff.

The port's copy of ``eegnetreplication_tpu/resil/retry.py``: the
classifier that decides which training errors are worth retrying with a
smaller fold group (``training/protocols.py::run_folds``), the ``retry``
event every such retry journals, and the backoff loop (:class:`RetryPolicy`,
:func:`call`) that processed-trial reads (``data/io.py``, the ``data.read``
site) and the session store's restore run under, and whose seedable delay
curve spaces the supervisor's transient relaunches
(``resil/supervise.py``).  On a spent budget the original exception
propagates unchanged.
"""

from __future__ import annotations

import random
import time
from dataclasses import dataclass
from typing import Any, Callable

import torch

from eegnetreplication_tpu_torch.obs import journal as obs_journal
from eegnetreplication_tpu_torch.utils.logging import logger

# CUDA runtime fault tokens.  Deliberately narrow: Python-level errors (bad
# arguments, an injected train.chunk crash, a stop request) must propagate.
DEVICE_FAULT_TOKENS = ("CUDA error", "CUBLAS_STATUS", "CUDNN_STATUS",
                       "out of memory")

DEVICE_FAULT = "device_fault"   # retryable, with a smaller program
TRANSIENT = "transient"         # network or IO hiccup, retryable as is
FATAL = "fatal"                 # deterministic error, never retried


def is_device_fault(exc: BaseException) -> bool:
    """True for a CUDA out-of-memory error or a ``RuntimeError`` carrying a
    CUDA runtime token: the faults a smaller fold group may survive."""
    if isinstance(exc, torch.cuda.OutOfMemoryError):
        return True
    if not isinstance(exc, RuntimeError):
        return False
    msg = str(exc)
    return any(tok in msg for tok in DEVICE_FAULT_TOKENS)


def classify(exc: BaseException) -> str:
    """``device_fault``, ``transient`` or ``fatal``: missing or forbidden
    files are fatal, other OS and connection errors transient."""
    if is_device_fault(exc):
        return DEVICE_FAULT
    if isinstance(exc, (FileNotFoundError, NotADirectoryError,
                        IsADirectoryError, PermissionError)):
        return FATAL
    if isinstance(exc, (ConnectionError, TimeoutError, OSError)):
        return TRANSIENT
    return FATAL


def journal_retry(*, site: str, attempt: int, max_attempts: int,
                  exc: BaseException, delay_s: float = 0.0,
                  **extra: Any) -> None:
    """Journal one retried attempt as a ``retry`` event and count it in
    ``retries_total``."""
    jr = obs_journal.current()
    jr.event("retry", site=site, attempt=attempt, max_attempts=max_attempts,
             classification=classify(exc), delay_s=round(delay_s, 3),
             error=f"{type(exc).__name__}: {exc}"[:300], **extra)
    jr.metrics.inc("retries_total", site=site)


@dataclass(frozen=True)
class RetryPolicy:
    """Attempt and deadline budgets and the backoff curve: ``delay(k)`` for
    attempt k = 1, 2, ... is ``base_delay_s * multiplier**(k-1)`` capped at
    ``max_delay_s``, randomized by ``+-jitter`` of itself; no attempt
    starts after ``deadline_s`` of wall (when set).  ``retry_on`` names the
    classifications worth another attempt; ``rng`` (a seeded
    ``random.Random``) makes the jitter, and so a schedule, exact."""

    max_attempts: int = 3
    base_delay_s: float = 0.1
    multiplier: float = 2.0
    max_delay_s: float = 30.0
    jitter: float = 0.1
    retry_on: tuple[str, ...] = (TRANSIENT, DEVICE_FAULT)
    deadline_s: float | None = None
    rng: random.Random | None = None

    def delay(self, attempt: int) -> float:
        d = min(self.base_delay_s * self.multiplier ** (attempt - 1),
                self.max_delay_s)
        if self.jitter:
            r = self.rng if self.rng is not None else random
            d *= 1.0 + r.uniform(-self.jitter, self.jitter)
        return max(d, 0.0)


def call(fn: Callable[[], Any], *, policy: RetryPolicy | None = None,
         site: str = "call") -> Any:
    """Run ``fn()`` under ``policy`` and return its result.  Only the
    classifications in ``policy.retry_on`` are retried, never past
    ``max_attempts`` or (when set) ``deadline_s`` of wall; once the budget
    is spent, or for any other error, the original exception propagates
    unchanged."""
    policy = policy or RetryPolicy()
    start = time.monotonic()
    attempt = 0
    while True:
        attempt += 1
        try:
            return fn()
        except Exception as exc:  # noqa: BLE001 — classified below
            kind = classify(exc)
            if (kind not in policy.retry_on
                    or attempt >= policy.max_attempts
                    or (policy.deadline_s is not None
                        and time.monotonic() - start >= policy.deadline_s)):
                raise
            delay = policy.delay(attempt)
            journal_retry(site=site, attempt=attempt,
                          max_attempts=policy.max_attempts, exc=exc,
                          delay_s=delay)
            logger.warning("Retryable %s fault at %s (attempt %d/%d): "
                           "%.200s; backing off %.2fs", kind, site, attempt,
                           policy.max_attempts, exc, delay)
            time.sleep(delay)
