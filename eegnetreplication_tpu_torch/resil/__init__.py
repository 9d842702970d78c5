"""Resilience primitives of the port: checkpoint integrity and graceful
stop on SIGTERM with drain hooks (the ported part of the JAX package's
``resil`` exports)."""

from eegnetreplication_tpu_torch.resil import integrity, preempt  # noqa: F401
from eegnetreplication_tpu_torch.resil.integrity import (  # noqa: F401
    IntegrityError,
)
from eegnetreplication_tpu_torch.resil.preempt import (  # noqa: F401
    EX_PREEMPTED,
    Preempted,
)

__all__ = ["integrity", "preempt", "IntegrityError", "EX_PREEMPTED",
           "Preempted"]
