"""Online inference serving on the card.

- :mod:`~eegnetreplication_tpu_torch.serve.engine` — load a checkpoint once,
  fold block 1 once, bucketed padded forwards (1/8/32/128) through the
  hand-written block-1 kernel, each bucket one captured CUDA graph on the
  card, thread-safe ``infer``; the ``predict`` CLI runs the same engine,
  so CLI and server cannot drift.  ``precision="int8"`` serves quantized
  weights behind the quant gate.
- :mod:`~eegnetreplication_tpu_torch.serve.batcher` — dynamic
  micro-batching with explicit 429 backpressure, adaptive admission
  (:mod:`~eegnetreplication_tpu_torch.serve.admission`) and dequeue
  deadlines, tenant-aware for the zoo.
- :mod:`~eegnetreplication_tpu_torch.serve.tuner` — the ladder tuner:
  retunes the bucket ladder to the observed traffic off the hot path.
- :mod:`~eegnetreplication_tpu_torch.serve.zoo` — the stacked engine
  (a mixed-tenant batch through one K1-stacked launch per chunk), the
  stack gate, the zoo's addressing.
- :mod:`~eegnetreplication_tpu_torch.serve.registry` — hot reload
  (``ModelRegistry``) and the multi-tenant ``ModelZoo``.
- :mod:`~eegnetreplication_tpu_torch.serve.sessions` — live headset
  streams: the EMS carry on K2s, the window slider, the durable session
  store.
- :mod:`~eegnetreplication_tpu_torch.serve.service` — the stdlib HTTP
  wiring (``POST /predict``, ``POST /reload``, ``POST /profile``,
  ``/session/*``, ``GET /healthz``, ``GET /metrics``), the circuit
  breaker, heartbeat, tracing and SLOs, the serving journal and the
  SIGTERM drain.
"""

from eegnetreplication_tpu_torch.serve.batcher import (
    DeadlineExceeded,
    MicroBatcher,
    Rejected,
    Shed,
)
from eegnetreplication_tpu_torch.serve.engine import (
    CLASS_NAMES,
    DEFAULT_BUCKETS,
    InferenceEngine,
    bucket_ladder,
    build_gated_engine,
    load_model_from_checkpoint,
    variables_digest,
)
from eegnetreplication_tpu_torch.serve.registry import (
    ModelRegistry,
    ModelZoo,
)
from eegnetreplication_tpu_torch.serve.service import (
    ServeApp,
    serve_until_preempted,
)
from eegnetreplication_tpu_torch.serve.tuner import LadderTuner

__all__ = [
    "CLASS_NAMES", "DEFAULT_BUCKETS", "DeadlineExceeded", "InferenceEngine",
    "LadderTuner", "MicroBatcher", "ModelRegistry", "ModelZoo", "Rejected",
    "ServeApp", "Shed",
    "bucket_ladder", "build_gated_engine", "load_model_from_checkpoint",
    "serve_until_preempted", "variables_digest",
]
