"""Closed-loop online adaptation: label → fine-tune → shadow → promote.

The port's counterpart of ``eegnetreplication_tpu/adapt``.  A live BCI
session drifts; the labels its client posts (``POST
/session/<id>/label``) pair with the decided windows in a
:class:`~eegnetreplication_tpu_torch.adapt.buffer.ReplayBuffer`, a
background
:class:`~eegnetreplication_tpu_torch.adapt.worker.AdaptationWorker`
fine-tunes the tenant with the offline train step, a
:class:`~eegnetreplication_tpu_torch.adapt.shadow.ShadowEvaluator` scores
the candidate on live traffic without serving it, and a
:class:`~eegnetreplication_tpu_torch.adapt.gate.PromotionGate` decides
whether the
:class:`~eegnetreplication_tpu_torch.adapt.controller.AdaptationController`
promotes it through the zoo's zero-drop reload (rollback is one POST).
"""

from eegnetreplication_tpu_torch.adapt.buffer import ReplayBuffer
from eegnetreplication_tpu_torch.adapt.controller import (
    AdaptationController,
)
from eegnetreplication_tpu_torch.adapt.gate import (
    GateDecision,
    PromotionGate,
)
from eegnetreplication_tpu_torch.adapt.shadow import ShadowEvaluator
from eegnetreplication_tpu_torch.adapt.worker import (
    AdaptationWorker,
    Candidate,
)

__all__ = [
    "AdaptationController",
    "AdaptationWorker",
    "Candidate",
    "GateDecision",
    "PromotionGate",
    "ReplayBuffer",
    "ShadowEvaluator",
]
