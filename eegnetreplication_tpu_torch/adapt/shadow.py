"""ShadowEvaluator: score a candidate on live traffic without serving it.

The port's copy of ``eegnetreplication_tpu/adapt/shadow.py``.  The
candidate's forward is the zoo's shadow engine: on the card one replay of
its captured bucket-1 graph, whose block 1 is K1.

A fine-tuned candidate must EARN promotion.  The evaluator tees a
sampled fraction of the tenant's decided windows to the candidate (a
non-serving shadow registered in the zoo) and accumulates three signals:

- **agreement** — does the shadow match the live model's prediction?
  A sanity floor, not the promotion signal: after a real drift the live
  model is exactly what is *wrong*, so high agreement can mean "learned
  nothing" and low agreement can mean "fixed it".
- **accuracy on labeled windows** — every labeled replay window the
  client posts is also run through the shadow; this is ground truth and
  the signal the :class:`~eegnetreplication_tpu_torch.adapt.gate.PromotionGate`
  actually gates on.
- **latency** — the shadow forward's own wall time, journaled so the
  drill can prove shadow scoring never rode the serving path.

All shadow forwards run on ONE background thread fed by a bounded
queue; the hot path pays a single ``queue.put_nowait`` (drops are
counted, never blocked on).  Every processed tee journals a
``shadow_eval`` event; cumulative stats feed the gate via the
controller's ``on_eval`` callback.
"""

from __future__ import annotations

import queue
import threading
import time

import numpy as np

from eegnetreplication_tpu_torch.obs import journal as obs_journal
from eegnetreplication_tpu_torch.utils.logging import logger

DEFAULT_SAMPLE_EVERY = 1      # tee every Nth decided window (1 = all)
DEFAULT_MAX_QUEUE = 256


class _ShadowState:
    """One active shadow: its infer fn, identity, and running tallies."""

    __slots__ = ("infer", "digest", "seen", "teed", "dropped", "n_trials",
                 "agree", "labeled_n", "labeled_correct", "live_correct",
                 "latency_ms_sum")

    def __init__(self, infer, digest: str):
        self.infer = infer
        self.digest = digest
        self.seen = 0          # decide-path windows offered for sampling
        self.teed = 0          # windows actually enqueued
        self.dropped = 0       # queue-full drops (hot path never blocks)
        self.n_trials = 0      # shadow forwards completed
        self.agree = 0         # shadow == live
        self.labeled_n = 0
        self.labeled_correct = 0
        self.live_correct = 0  # live model on the same labeled windows
        self.latency_ms_sum = 0.0

    def stats(self) -> dict:
        agreement = (self.agree / self.n_trials) if self.n_trials else None
        acc = (self.labeled_correct / self.labeled_n) if self.labeled_n \
            else None
        live_acc = (self.live_correct / self.labeled_n) if self.labeled_n \
            else None
        return {
            "digest": self.digest, "seen": self.seen, "teed": self.teed,
            "dropped": self.dropped, "n_trials": self.n_trials,
            "agreement": None if agreement is None else round(agreement, 6),
            "labeled_n": self.labeled_n,
            "accuracy": None if acc is None else round(acc, 6),
            "live_accuracy": None if live_acc is None
            else round(live_acc, 6),
            "mean_latency_ms": (round(self.latency_ms_sum / self.n_trials, 3)
                                if self.n_trials else None),
        }


class ShadowEvaluator:
    """Sampled live-traffic tee onto non-serving shadow candidates."""

    def __init__(self, *, sample_every: int = DEFAULT_SAMPLE_EVERY,
                 max_queue: int = DEFAULT_MAX_QUEUE, on_eval=None,
                 journal=None):
        if sample_every < 1:
            raise ValueError(f"sample_every must be >= 1, got {sample_every}")
        self.sample_every = int(sample_every)
        self._on_eval = on_eval   # callback(model_id, stats_dict)
        self._journal = journal if journal is not None \
            else obs_journal.current()
        self._lock = threading.Lock()
        self._shadows: dict[str, _ShadowState] = {}
        self._queue: queue.Queue = queue.Queue(maxsize=int(max_queue))
        self._thread: threading.Thread | None = None
        self._stop = threading.Event()

    # -- lifecycle ---------------------------------------------------------
    def start(self, model_id: str, infer, digest: str) -> None:
        """Activate a shadow for ``model_id``.  ``infer`` maps a
        (B, C, T) float32 batch to (B,) predicted classes; the caller
        (the controller) already loaded/registered the candidate —
        a load failure never reaches here."""
        with self._lock:
            self._shadows[model_id] = _ShadowState(infer, digest)
            if self._thread is None:
                self._stop.clear()
                self._thread = threading.Thread(
                    target=self._worker, name="shadow-eval", daemon=True)
                self._thread.start()

    def active(self, model_id: str) -> bool:
        with self._lock:
            return model_id in self._shadows

    def stop(self, model_id: str) -> None:
        with self._lock:
            self._shadows.pop(model_id, None)

    def close(self) -> None:
        self._stop.set()
        self._queue.put(None)   # wake the worker
        thread = self._thread
        if thread is not None:
            thread.join(timeout=5.0)
        self._thread = None

    # -- the tee (hot path) ------------------------------------------------
    def tee(self, model_id: str, window: np.ndarray, live_pred: int,
            label: int | None = None) -> bool:
        """Offer one decided window.  Unlabeled windows are sampled every
        Nth; labeled windows are ALWAYS teed (they are the scarce
        ground-truth signal the gate needs).  Never blocks: a full queue
        counts a drop and returns False."""
        with self._lock:
            state = self._shadows.get(model_id)
            if state is None:
                return False
            state.seen += 1
            if label is None and (state.seen - 1) % self.sample_every:
                return False
            item = (model_id, np.asarray(window, np.float32).copy(),
                    int(live_pred), None if label is None else int(label))
            try:
                self._queue.put_nowait(item)
            except queue.Full:
                state.dropped += 1
                return False
            state.teed += 1
            return True

    def drain(self, timeout: float = 30.0) -> bool:
        """Block until every enqueued tee has been scored (benches/tests
        synchronize on this before reading stats)."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            with self._lock:
                pending = self._queue.unfinished_tasks
            if not pending:
                return True
            time.sleep(0.01)
        return False

    # -- scoring (background thread) ---------------------------------------
    def _worker(self) -> None:
        # Bind the journal: this fresh thread carries no contextvars, and
        # the promotion path it drives (gate decide -> controller promote)
        # crosses an inject site (adapt.promote) that journals its
        # fault_injected through the context.
        with obs_journal.bound(self._journal):
            while not self._stop.is_set():
                item = self._queue.get()
                try:
                    if item is None:
                        continue
                    self._score(*item)
                except Exception:  # noqa: BLE001 — scoring must not die
                    logger.exception("Shadow eval failed; window skipped")
                finally:
                    self._queue.task_done()

    def _score(self, model_id: str, window: np.ndarray, live_pred: int,
               label: int | None) -> None:
        with self._lock:
            state = self._shadows.get(model_id)
        if state is None:
            return   # shadow retired while the item sat in the queue
        t0 = time.perf_counter()
        pred = int(np.asarray(state.infer(window[None]))[0])
        latency_ms = (time.perf_counter() - t0) * 1e3
        agree = pred == int(live_pred)
        with self._lock:
            state.n_trials += 1
            state.agree += int(agree)
            state.latency_ms_sum += latency_ms
            if label is not None:
                state.labeled_n += 1
                state.labeled_correct += int(pred == label)
                state.live_correct += int(int(live_pred) == label)
            stats = state.stats()
        event = {"model": model_id, "digest": state.digest, "n_trials": 1,
                 "agree": int(agree), "shadow_pred": pred,
                 "live_pred": int(live_pred),
                 "latency_ms": round(latency_ms, 3)}
        if label is not None:
            event.update(label=int(label), correct=int(pred == label),
                         live_correct=int(int(live_pred) == label))
        self._journal.event("shadow_eval", **event)
        self._journal.metrics.inc("shadow_evals")
        if self._on_eval is not None:
            self._on_eval(model_id, stats)

    # -- introspection -----------------------------------------------------
    def stats(self, model_id: str) -> dict | None:
        with self._lock:
            state = self._shadows.get(model_id)
            return None if state is None else state.stats()
