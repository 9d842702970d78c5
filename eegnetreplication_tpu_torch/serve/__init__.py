"""Online inference serving on the card.

- :mod:`~eegnetreplication_tpu_torch.serve.engine` — load a checkpoint once,
  fold block 1 once, bucketed padded forwards (1/8/32/128) through the
  hand-written block-1 kernel, thread-safe ``infer``; the ``predict`` CLI
  runs the same engine, so CLI and server cannot drift.
- :mod:`~eegnetreplication_tpu_torch.serve.batcher` — dynamic
  micro-batching with explicit 429 backpressure and dequeue deadlines.
- :mod:`~eegnetreplication_tpu_torch.serve.service` — the stdlib HTTP
  wiring (``POST /predict``, ``GET /healthz``) and the SIGTERM drain.
"""

from eegnetreplication_tpu_torch.serve.batcher import (
    DeadlineExceeded,
    MicroBatcher,
    Rejected,
)
from eegnetreplication_tpu_torch.serve.engine import (
    CLASS_NAMES,
    DEFAULT_BUCKETS,
    InferenceEngine,
    bucket_ladder,
    load_model_from_checkpoint,
    variables_digest,
)
from eegnetreplication_tpu_torch.serve.service import (
    ServeApp,
    serve_until_preempted,
)

__all__ = [
    "CLASS_NAMES", "DEFAULT_BUCKETS", "DeadlineExceeded", "InferenceEngine",
    "MicroBatcher", "Rejected", "ServeApp", "bucket_ladder",
    "load_model_from_checkpoint", "serve_until_preempted",
    "variables_digest",
]
