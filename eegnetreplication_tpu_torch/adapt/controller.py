"""AdaptationController: the closed loop, wired end to end.

The port's copy of ``eegnetreplication_tpu/adapt/controller.py`` over the
port's zoo (promotion restacks K1-stacked through ``ModelZoo.reload``).

One object owns the loop's state machine per tenant::

    idle --(enough fresh labels)--> adapting --(candidate written)-->
    shadowing --(gate: promote)--> idle (new weights serving)
                --(gate: refuse / integrity failure)--> idle (discarded)

The hot path touches the controller in exactly two places, both O(1):
``observe_window`` (decide path: capture + sampled shadow tee) and
``on_label`` (label endpoint: pair + labeled shadow tee + maybe trigger
a fine-tune).  Everything heavy — the fine-tune itself, shadow scoring,
the promotion reload — runs on background threads.

Promotion rides the zoo's existing zero-drop ``reload`` + restack: the
candidate file is first moved to a stable ``<model>.promoted.<digest>``
path (the candidate slot is about to be rotated by the next fine-tune —
a serving tenant must never point at a recyclable path), the prior
(checkpoint, digest) is pushed onto a rollback stack, and
``POST /adapt/rollback`` pops it through the same zero-drop reload.
Every decision journals a ``promotion`` event carrying the full gate
input snapshot; the ``adapt.promote`` chaos site fires inside the
promotion so a mid-swap death provably leaves the prior tenant serving.
"""

from __future__ import annotations

import threading
import time
from pathlib import Path

from eegnetreplication_tpu_torch.adapt.buffer import ReplayBuffer
from eegnetreplication_tpu_torch.adapt.gate import PromotionGate
from eegnetreplication_tpu_torch.adapt.shadow import ShadowEvaluator
from eegnetreplication_tpu_torch.adapt.worker import (
    AdaptationWorker,
    Candidate,
)
from eegnetreplication_tpu_torch.obs import journal as obs_journal
from eegnetreplication_tpu_torch.resil import inject
from eegnetreplication_tpu_torch.utils.logging import logger

# Fresh labels (beyond those already consumed) required to trigger a
# fine-tune.
DEFAULT_TRIGGER_LABELS = 16


class _TenantLoop:
    """Per-tenant loop state (caller holds the controller lock)."""

    __slots__ = ("state", "candidate", "consumed_labels", "history",
                 "promotions", "rollbacks", "refusals", "errors",
                 "last_decision")

    def __init__(self):
        self.state = "idle"            # idle | adapting | shadowing
        self.candidate: Candidate | None = None
        self.consumed_labels = 0       # labels already fed to a fine-tune
        self.history: list[tuple[str, str]] = []  # (checkpoint, digest)
        self.promotions = 0
        self.rollbacks = 0
        self.refusals = 0
        self.errors = 0
        self.last_decision: str | None = None


class AdaptationController:
    """Owns the per-tenant closed-loop adaptation state machine."""

    def __init__(self, zoo, adapt_dir: str | Path, *,
                 trigger_labels: int = DEFAULT_TRIGGER_LABELS,
                 sample_every: int = 1,
                 gate: PromotionGate | None = None,
                 buffer: ReplayBuffer | None = None,
                 learning_rate: float = 1e-3, steps: int = 60,
                 batch_size: int = 32, seed: int = 0,
                 auto: bool = True, journal=None):
        if trigger_labels < 1:
            raise ValueError(f"trigger_labels must be >= 1, got "
                             f"{trigger_labels}")
        self.zoo = zoo
        self.adapt_dir = Path(adapt_dir)
        self.adapt_dir.mkdir(parents=True, exist_ok=True)
        self.trigger_labels = int(trigger_labels)
        self.auto = bool(auto)
        self._journal = journal if journal is not None \
            else obs_journal.current()
        self.buffer = buffer if buffer is not None else ReplayBuffer()
        self.gate = gate if gate is not None else PromotionGate()
        self.worker = AdaptationWorker(
            self.buffer, self.adapt_dir, learning_rate=learning_rate,
            steps=steps, batch_size=batch_size, seed=seed,
            journal=self._journal, device=getattr(zoo, "device", None))
        self.shadow = ShadowEvaluator(
            sample_every=sample_every, on_eval=self._on_shadow_eval,
            journal=self._journal)
        self._lock = threading.Lock()
        self._loops: dict[str, _TenantLoop] = {}
        self._threads: list[threading.Thread] = []

    def _loop(self, model_id: str) -> _TenantLoop:
        loop = self._loops.get(model_id)
        if loop is None:
            loop = self._loops[model_id] = _TenantLoop()
        return loop

    # -- hot-path hooks ----------------------------------------------------
    def observe_window(self, model_id: str, session_id: str, index: int,
                       window, live_pred: int) -> None:
        """Decide-path hook: capture the standardized window for replay
        and tee it to an active shadow (sampled)."""
        self.buffer.observe(model_id, session_id, index, window)
        if self.shadow.active(model_id):
            self.shadow.tee(model_id, window, live_pred)

    def tee_predictions(self, model_id: str, trials, preds) -> None:
        """/predict-path hook: offer each trial of a served batch to the
        tenant's active shadow (the evaluator's sampling bounds the
        work; a full queue drops, never blocks)."""
        if not self.shadow.active(model_id):
            return
        for win, pred in zip(trials, preds):
            self.shadow.tee(model_id, win, int(pred))

    def on_label(self, model_id: str, session_id: str, index: int,
                 label: int, live_pred: int | None = None) -> bool:
        """Label-endpoint hook: pair the label with its captured window,
        feed an active shadow a ground-truth eval, and maybe trigger a
        fine-tune.  Returns whether the label paired with a window."""
        paired = self.buffer.label(model_id, session_id, index, label)
        if paired and live_pred is not None and self.shadow.active(model_id):
            window = self.buffer.window_for(model_id, session_id, index)
            if window is not None:
                self.shadow.tee(model_id, window, live_pred, label=label)
        if self.auto:
            self.maybe_adapt(model_id)
        return paired

    # -- the fine-tune trigger ---------------------------------------------
    def maybe_adapt(self, model_id: str) -> bool:
        """Spawn a background fine-tune when the tenant is idle and has
        accumulated ``trigger_labels`` fresh labels.  Returns whether a
        fine-tune was started."""
        n_labeled = self.buffer.n_labeled(model_id)
        with self._lock:
            loop = self._loop(model_id)
            if loop.state != "idle":
                return False
            if n_labeled - loop.consumed_labels < self.trigger_labels:
                return False
            loop.state = "adapting"
            loop.consumed_labels = n_labeled
        thread = threading.Thread(
            target=self._run_adaptation, args=(model_id,),
            name=f"adapt-{model_id}", daemon=True)
        thread.start()
        with self._lock:
            self._threads = [t for t in self._threads if t.is_alive()]
            self._threads.append(thread)
        return True

    def _run_adaptation(self, model_id: str) -> None:
        """Background fine-tune → shadow registration.  Never raises."""
        # Fresh threads carry no contextvars: bind the controller's
        # journal so context-reached instrumentation (inject.fire's
        # fault_injected for adapt.train) journals into this run.
        with obs_journal.bound(self._journal):
            self._run_adaptation_journaled(model_id)

    def _run_adaptation_journaled(self, model_id: str) -> None:
        try:
            base = self.zoo.checkpoint_for(self.zoo.resolve(model_id))
            candidate = self.worker.fine_tune(model_id, base)
        except Exception as exc:  # noqa: BLE001 — loop must survive
            logger.warning("Adaptation fine-tune for %s failed: %s",
                           model_id, exc)
            self._journal.event(
                "promotion", model=model_id, action="error", digest="",
                stage="fine_tune", error=f"{type(exc).__name__}: {exc}"[:300])
            with self._lock:
                loop = self._loop(model_id)
                loop.state = "idle"
                loop.errors += 1
                loop.last_decision = "error"
            return
        try:
            digest = self.zoo.register_shadow(model_id, candidate.path)
        except Exception as exc:  # noqa: BLE001 — bad candidate refused
            # The bad-candidate shape: a corrupted fine-tune (the
            # adapt.train chaos default) fails integrity right here and
            # is REFUSED before it ever sees traffic — journaled as a
            # terminal promotion refusal, never promoted.
            logger.warning("Shadow registration refused candidate for %s: "
                           "%s", model_id, exc)
            self._journal.event(
                "promotion", model=model_id, action="refused",
                digest=candidate.digest, stage="shadow_load",
                reason=f"candidate failed shadow load: "
                       f"{type(exc).__name__}: {exc}"[:300],
                checkpoint=str(candidate.path))
            self._journal.metrics.inc("promotion_refusals")
            with self._lock:
                loop = self._loop(model_id)
                loop.state = "idle"
                loop.refusals += 1
                loop.last_decision = "refused"
            return
        with self._lock:
            loop = self._loop(model_id)
            loop.candidate = candidate
            loop.state = "shadowing"
        self.shadow.start(
            model_id,
            lambda x: self.zoo.shadow_infer(model_id, x),
            digest)

    # -- gate + promotion --------------------------------------------------
    def _on_shadow_eval(self, model_id: str, stats: dict) -> None:
        """ShadowEvaluator callback (shadow thread): consult the gate
        after every scored window."""
        with self._lock:
            loop = self._loops.get(model_id)
            if loop is None or loop.state != "shadowing":
                return
            candidate = loop.candidate
        decision = self.gate.decide(stats)
        if decision.action == "wait":
            return
        if decision.action == "refuse":
            self._refuse(model_id, candidate, decision)
            return
        self._promote(model_id, candidate, decision)

    def _refuse(self, model_id: str, candidate: Candidate, decision) -> None:
        self._journal.event(
            "promotion", model=model_id, action="refused",
            digest=candidate.digest if candidate else "",
            stage="gate", reason=decision.reason,
            n_trials=decision.n_trials, labeled_n=decision.labeled_n,
            agreement=decision.agreement, accuracy=decision.accuracy,
            **self.gate.config())
        self._journal.metrics.inc("promotion_refusals")
        self.shadow.stop(model_id)
        self.zoo.drop_shadow(model_id)
        with self._lock:
            loop = self._loop(model_id)
            loop.state = "idle"
            loop.candidate = None
            loop.refusals += 1
            loop.last_decision = "refused"
        logger.info("Candidate for %s refused: %s", model_id,
                    decision.reason)

    def _promote(self, model_id: str, candidate: Candidate,
                 decision) -> None:
        """Zero-drop swap of the candidate into serving, with rollback
        bookkeeping.  An error mid-promotion leaves the prior tenant
        serving (the zoo reload contract) and the shadow active, so a
        transient failure retries on the next scored window."""
        t0 = time.perf_counter()
        resolved = self.zoo.resolve(model_id)
        prior_ckpt = str(self.zoo.checkpoint_for(resolved))
        prior_digest = self.zoo.digest_for(resolved) or ""
        # The candidate slot gets rotated by the NEXT fine-tune; a serving
        # tenant must point at a stable artifact instead.
        promoted = candidate.path.with_name(
            f"{model_id}.promoted.{candidate.digest[:12]}.npz")
        try:
            inject.fire("adapt.promote", model=model_id,
                        digest=candidate.digest)
            candidate.path.replace(promoted)
            new_digest = self.zoo.reload(resolved, promoted)
        except Exception as exc:  # noqa: BLE001 — prior tenant keeps serving
            logger.warning("Promotion for %s failed (prior model keeps "
                           "serving): %s", model_id, exc)
            if promoted.exists() and not candidate.path.exists():
                promoted.replace(candidate.path)
            self._journal.event(
                "promotion", model=model_id, action="error",
                digest=candidate.digest, stage="reload",
                error=f"{type(exc).__name__}: {exc}"[:300])
            with self._lock:
                self._loop(model_id).errors += 1
            return
        self.shadow.stop(model_id)
        self.zoo.drop_shadow(model_id)
        # A promoted model starts a fresh evidence window: old replay
        # pairs describe the PRIOR weights' distribution decisions.
        self.buffer.clear(model_id)
        with self._lock:
            loop = self._loop(model_id)
            loop.history.append((prior_ckpt, prior_digest))
            loop.state = "idle"
            loop.candidate = None
            loop.consumed_labels = 0
            loop.promotions += 1
            loop.last_decision = "promote"
        self._journal.event(
            "promotion", model=model_id, action="promote",
            digest=new_digest, previous_digest=prior_digest,
            checkpoint=str(promoted), reason=decision.reason,
            n_trials=decision.n_trials, labeled_n=decision.labeled_n,
            agreement=decision.agreement, accuracy=decision.accuracy,
            fit_accuracy=candidate.fit_accuracy,
            elapsed_s=round(time.perf_counter() - t0, 3),
            **self.gate.config())
        self._journal.metrics.inc("promotions")
        logger.info("Promoted adapted model for %s: %s -> %s (%s)",
                    model_id, prior_digest[:12], new_digest[:12],
                    decision.reason)

    # -- rollback ----------------------------------------------------------
    def rollback(self, model_id: str | None) -> dict:
        """Restore the tenant's pre-promotion checkpoint via the same
        zero-drop reload.  Raises LookupError when there is nothing to
        roll back to (the route maps it to a 409)."""
        # Resolve FIRST (None/digest-prefix -> canonical tenant id): loop
        # state is keyed by the canonical id, and keying by the raw spec
        # would mint a fresh empty loop whose bare history reads as
        # "nothing to roll back" for a tenant that WAS promoted.
        resolved = self.zoo.resolve(model_id)
        with self._lock:
            loop = self._loop(resolved)
            if not loop.history:
                raise LookupError(
                    f"no promotion to roll back for {resolved!r}")
            prior_ckpt, prior_digest = loop.history.pop()
        try:
            digest = self.zoo.reload(resolved, prior_ckpt)
        except Exception:
            with self._lock:   # restore the history entry: nothing changed
                self._loop(resolved).history.append(
                    (prior_ckpt, prior_digest))
            raise
        with self._lock:
            loop = self._loop(resolved)
            loop.rollbacks += 1
            loop.last_decision = "rollback"
        self._journal.event(
            "promotion", model=resolved, action="rollback", digest=digest,
            checkpoint=prior_ckpt)
        self._journal.metrics.inc("adapt_rollbacks")
        logger.info("Rolled back %s to %s", resolved, digest[:12])
        return {"model": resolved, "digest": digest,
                "checkpoint": prior_ckpt}

    # -- introspection / lifecycle -----------------------------------------
    def status(self) -> dict:
        with self._lock:
            models = {}
            for mid, loop in self._loops.items():
                models[mid] = {
                    "state": loop.state,
                    "buffer": self.buffer.stats(mid),
                    "shadow": self.shadow.stats(mid),
                    "candidate_digest": (loop.candidate.digest
                                         if loop.candidate else None),
                    "promotions": loop.promotions,
                    "rollbacks": loop.rollbacks,
                    "refusals": loop.refusals,
                    "errors": loop.errors,
                    "rollback_depth": len(loop.history),
                    "last_decision": loop.last_decision,
                }
        return {"trigger_labels": self.trigger_labels,
                "gate": self.gate.config(), "models": models}

    def drain(self, timeout: float = 30.0) -> bool:
        """Wait for in-flight fine-tunes and queued shadow scoring —
        benches/tests synchronize on this, the serving path never does."""
        deadline = time.monotonic() + timeout
        with self._lock:
            threads = list(self._threads)
        for thread in threads:
            thread.join(timeout=max(0.0, deadline - time.monotonic()))
        return self.shadow.drain(
            timeout=max(0.1, deadline - time.monotonic()))

    def close(self) -> None:
        self.shadow.close()
