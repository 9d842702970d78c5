"""Resilience primitives of the port: checkpoint integrity, graceful stop
on SIGTERM with drain hooks, fault injection at the training and serving
paths' named sites, the device-fault classifier, the serving circuit
breaker and liveness heartbeats (the ported part of the JAX package's
``resil`` exports)."""

from eegnetreplication_tpu_torch.resil import (  # noqa: F401
    breaker,
    heartbeat,
    inject,
    integrity,
    preempt,
    retry,
)
from eegnetreplication_tpu_torch.resil.inject import (  # noqa: F401
    FaultSpec,
    parse_plan,
)
from eegnetreplication_tpu_torch.resil.integrity import (  # noqa: F401
    IntegrityError,
)
from eegnetreplication_tpu_torch.resil.preempt import (  # noqa: F401
    EX_PREEMPTED,
    Preempted,
)

__all__ = ["breaker", "heartbeat", "inject", "integrity", "preempt",
           "retry", "FaultSpec",
           "parse_plan", "IntegrityError", "EX_PREEMPTED", "Preempted"]
