"""Durable streaming BCI sessions on the card: stateful serving with
mid-stream resume.

The port's copy of ``eegnetreplication_tpu/serve/sessions``.  A live EEG
headset streams 22-channel samples at 250 Hz, and the stream has state the
process must not lose: the exponential-moving-standardization carry, the
partial sliding window, the decision cursor.

- :mod:`~eegnetreplication_tpu_torch.serve.sessions.session` — one
  stream's state: the chunk-resumable EMS carrier
  (:class:`~eegnetreplication_tpu_torch.ops.ems.StreamingEMS`, one K2s
  launch a push on the card), a sliding window with a configurable hop,
  and the decision record.  Chunking-invariant by construction, so a
  resumed stream re-standardizes resent samples to the same bytes.
- :mod:`~eegnetreplication_tpu_torch.serve.sessions.store` — the
  durability layer: every session's flat state in one sha256-stamped npz
  (atomic tmp + rename, keep-N generations, corrupt generations
  quarantined with fallback), the JAX package's format, restored under
  ``--resume`` so clients continue from the last acked sample.

The HTTP surface (``/session/*``) lives in
:mod:`~eegnetreplication_tpu_torch.serve.service`; windows go through the
shared engine and micro-batcher with per-window deadlines.
"""

from eegnetreplication_tpu_torch.serve.sessions.session import (
    StreamSession,
    WindowDecision,
)
from eegnetreplication_tpu_torch.serve.sessions.store import SessionStore

__all__ = ["StreamSession", "WindowDecision", "SessionStore"]
