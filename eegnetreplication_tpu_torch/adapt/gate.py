"""PromotionGate: the floors a shadow candidate must clear to serve.

The port's copy of ``eegnetreplication_tpu/adapt/gate.py`` (the same
defaults, bounds, errors and :class:`GateDecision` fields).

The gate is a pure decision function over the evaluator's cumulative
stats — no I/O, no locks — so its policy is trivially unit-testable and
every decision journals the exact inputs it saw.

Decision semantics (in order):

- ``wait`` — not enough evidence yet: fewer than ``min_samples`` shadow
  forwards, or fewer than ``min_labeled`` ground-truth evals.  Labeled
  evidence is mandatory: agreement alone cannot distinguish "candidate
  learned the drift" from "candidate learned nothing", because after a
  real drift the live model is the wrong reference.
- ``refuse`` — evidence is in and a floor failed: labeled accuracy
  under ``accuracy_floor``, or agreement under ``agreement_floor``
  (default 0.0 = disabled; a meaningful agreement floor only makes
  sense for no-drift canarying where live is still trustworthy).
  A refusal is terminal for the candidate.
- ``promote`` — evidence is in and every floor cleared.
"""

from __future__ import annotations

from dataclasses import dataclass

DEFAULT_MIN_SAMPLES = 12
DEFAULT_MIN_LABELED = 8
DEFAULT_ACCURACY_FLOOR = 0.55
DEFAULT_AGREEMENT_FLOOR = 0.0


@dataclass(frozen=True)
class GateDecision:
    action: str          # "promote" | "wait" | "refuse"
    reason: str
    n_trials: int
    labeled_n: int
    agreement: float | None
    accuracy: float | None


class PromotionGate:
    """Configurable floors over a minimum shadow sample count."""

    def __init__(self, *, min_samples: int = DEFAULT_MIN_SAMPLES,
                 min_labeled: int = DEFAULT_MIN_LABELED,
                 accuracy_floor: float = DEFAULT_ACCURACY_FLOOR,
                 agreement_floor: float = DEFAULT_AGREEMENT_FLOOR):
        if min_samples < 1:
            raise ValueError(f"min_samples must be >= 1, got {min_samples}")
        if min_labeled < 1:
            raise ValueError(f"min_labeled must be >= 1, got {min_labeled}")
        if not 0.0 <= accuracy_floor <= 1.0:
            raise ValueError(f"accuracy_floor must be in [0, 1], got "
                             f"{accuracy_floor}")
        if not 0.0 <= agreement_floor <= 1.0:
            raise ValueError(f"agreement_floor must be in [0, 1], got "
                             f"{agreement_floor}")
        self.min_samples = int(min_samples)
        self.min_labeled = int(min_labeled)
        self.accuracy_floor = float(accuracy_floor)
        self.agreement_floor = float(agreement_floor)

    def config(self) -> dict:
        return {"min_samples": self.min_samples,
                "min_labeled": self.min_labeled,
                "accuracy_floor": self.accuracy_floor,
                "agreement_floor": self.agreement_floor}

    def decide(self, stats: dict) -> GateDecision:
        n = int(stats.get("n_trials") or 0)
        labeled_n = int(stats.get("labeled_n") or 0)
        agreement = stats.get("agreement")
        accuracy = stats.get("accuracy")

        def _d(action: str, reason: str) -> GateDecision:
            return GateDecision(action=action, reason=reason, n_trials=n,
                                labeled_n=labeled_n, agreement=agreement,
                                accuracy=accuracy)

        if n < self.min_samples:
            return _d("wait", f"{n}/{self.min_samples} shadow samples")
        if labeled_n < self.min_labeled:
            return _d("wait", f"{labeled_n}/{self.min_labeled} labeled evals")
        if accuracy is not None and accuracy < self.accuracy_floor:
            return _d("refuse", f"labeled accuracy {accuracy:.3f} < floor "
                                f"{self.accuracy_floor:.3f}")
        if agreement is not None and agreement < self.agreement_floor:
            return _d("refuse", f"agreement {agreement:.3f} < floor "
                                f"{self.agreement_floor:.3f}")
        return _d("promote", f"accuracy {accuracy:.3f} >= "
                             f"{self.accuracy_floor:.3f} over {labeled_n} "
                             f"labeled / {n} shadow samples")
