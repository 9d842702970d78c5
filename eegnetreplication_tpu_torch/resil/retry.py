"""Fault classes and the shared ``retry`` journal record.

The port's subset of ``eegnetreplication_tpu/resil/retry.py``: the
classifier that decides which training errors are worth retrying with a
smaller fold group (``training/protocols.py::run_folds``), and the
``retry`` event every such retry journals.  The backoff policy and
``call`` serve the JAX package's fetch and serving tiers and are not
ported (ROADMAP.md queue A.5).
"""

from __future__ import annotations

from typing import Any

import torch

from eegnetreplication_tpu_torch.obs import journal as obs_journal

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
