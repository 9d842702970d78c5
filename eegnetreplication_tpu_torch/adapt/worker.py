"""AdaptationWorker: fine-tune one tenant's model off the hot path.

The port's counterpart of ``eegnetreplication_tpu/adapt/worker.py``.  It
reuses the training stack: :class:`TrainState` over
:meth:`StateLayout.of` with one fold (G = 1) and
:func:`~eegnetreplication_tpu_torch.training.steps.train_step`, the step
the offline trainer runs, so an online candidate is not a second training
implementation.  The batch indices come from
``np.random.default_rng(seed)`` exactly as the JAX worker draws them, so
both packages fine-tune on the same batches; dropout masks come from a
``torch.Generator`` on the model's device seeded with ``seed`` (the JAX
PRNG's masks are not comparable, so the packages agree at dropout 0).
The fit accuracy is ``eval_forward`` over the labeled set: one
K1-stacked launch on the card.

On the card the whole fine-tune runs on a CUDA stream of its own, beside
the batcher's graph replays and the sessions' K2s launches.  Nothing in
the step loop waits for the device; the fit accuracy's range check and
the candidate's copy to the host wait once, after the last step.  The
candidate lands as a stamped checkpoint (:func:`save_checkpoint`)
rotated through ``CANDIDATE_KEEP`` generations;
the ``adapt.train`` chaos site fires after the write lands (its default
action garbles the file, which the shadow load then refuses).

The worker is synchronous; the controller owns the background thread.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

from eegnetreplication_tpu_torch.obs import journal as obs_journal
from eegnetreplication_tpu_torch.ops.fused_eegnet import fold_index
from eegnetreplication_tpu_torch.resil import inject
from eegnetreplication_tpu_torch.training.checkpoint import (
    load_checkpoint,
    rotate_generations,
    save_checkpoint,
    to_jax_variables,
)
from eegnetreplication_tpu_torch.training.steps import (
    StateLayout,
    TrainState,
    eval_forward,
    train_step,
)
from eegnetreplication_tpu_torch.utils.device import resolve_device
from eegnetreplication_tpu_torch.utils.logging import logger

# Candidate generations kept per tenant (including the newest): a refused
# candidate's file survives for post-mortem while the next fine-tune
# writes over the slot.
CANDIDATE_KEEP = 3

# The reference Adam's epsilon (training/steps.py, config.py).
ADAM_EPS = 1e-7


@dataclass
class Candidate:
    """A fine-tuned checkpoint awaiting shadow evaluation."""

    model_id: str
    path: Path
    digest: str          # digest of the in-memory weights, before any fault
    steps: int
    n_labeled: int
    loss: float
    fit_accuracy: float  # accuracy on the replay set it was trained on


class AdaptationWorker:
    """Fine-tunes a tenant's served weights on its labeled replay set."""

    def __init__(self, buffer, adapt_dir: str | Path, *,
                 learning_rate: float = 1e-3, steps: int = 60,
                 batch_size: int = 32, seed: int = 0, journal=None,
                 device: torch.device | str | None = None):
        self.buffer = buffer
        self.adapt_dir = Path(adapt_dir)
        self.learning_rate = float(learning_rate)
        self.steps = int(steps)
        self.batch_size = int(batch_size)
        self.seed = int(seed)
        self.device = resolve_device(device)
        self._journal = journal if journal is not None \
            else obs_journal.current()
        self._stream = None      # the fine-tune's CUDA stream, made once

    def candidate_path(self, model_id: str) -> Path:
        return self.adapt_dir / f"{model_id}.candidate.npz"

    def _on_own_stream(self):
        """The fine-tune's stream on the card (a no-op on the CPU)."""
        if self.device.type != "cuda":
            return contextlib.nullcontext()
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        return torch.cuda.stream(self._stream)

    def warmup(self, base_checkpoint: str | Path) -> float:
        """One train step on zeros at ``base_checkpoint``'s geometry, on
        the worker's stream, before the server takes traffic; returns its
        wall.  On the card the first use of the training path (cuDNN's
        and cuBLAS's handles, their kernels' lazy loading, the CUDA
        generator) otherwise lands inside the first fine-tune, and there it
        stalled every serving thread for ~0.4 s (``PERF.md``).  A no-op on
        the CPU."""
        if self.device.type != "cuda":
            return 0.0
        from eegnetreplication_tpu_torch.serve.engine import (
            load_model_from_checkpoint,
        )

        t0 = time.perf_counter()
        dev = self.device
        with self._on_own_stream():
            model = load_model_from_checkpoint(base_checkpoint, device=dev)
            state = TrainState.create(
                StateLayout.of(model),
                {k: v[None] for k, v in model.state_dict().items()})
            b = self.batch_size
            g = torch.Generator(device=dev)
            g.manual_seed(self.seed)
            train_step(model, state,
                       torch.zeros((1, b, model.n_channels, model.n_times),
                                   device=dev),
                       torch.zeros((1, b), dtype=torch.int64, device=dev),
                       torch.ones((1, b), device=dev),
                       learning_rate=self.learning_rate, adam_eps=ADAM_EPS,
                       maxnorm_mode="reference", generator=g)
            self._stream.synchronize()
        return time.perf_counter() - t0

    def fine_tune(self, model_id: str, base_checkpoint: str | Path
                  ) -> Candidate:
        """Run the fine-tune and write the stamped candidate checkpoint.

        Raises whatever the step (or an armed ``adapt.train`` fault with
        ``action=raise``) raises: the controller journals the outcome, and
        a raise here means no candidate was produced.
        """
        t0 = time.perf_counter()
        x, y = self.buffer.dataset(model_id)
        n = int(len(y))
        self._journal.event("adaptation_start", model=model_id, n_labeled=n,
                            base_checkpoint=str(base_checkpoint),
                            steps=self.steps, lr=self.learning_rate)
        self._journal.metrics.inc("adapt_runs")
        if n == 0:
            raise ValueError(f"no labeled replay data for {model_id!r}")

        # Imported here: serve.service imports this package, and a
        # module-level serve import would make the import order circular.
        from eegnetreplication_tpu_torch.serve.engine import (
            load_model_from_checkpoint,
            variables_digest,
        )

        dev = self.device
        # The JAX worker's batch draws, all at once: the host feeds the
        # step loop nothing after this.
        rng = np.random.default_rng(self.seed)
        idx = np.stack([rng.integers(0, n, size=min(self.batch_size, n))
                        for _ in range(self.steps)]) if self.steps else \
            np.zeros((0, min(self.batch_size, n)), np.int64)
        with self._on_own_stream():
            model = load_model_from_checkpoint(base_checkpoint, device=dev)
            _, base_meta = load_checkpoint(base_checkpoint)
            state = TrainState.create(
                StateLayout.of(model),
                {k: v[None] for k, v in model.state_dict().items()})
            xd = torch.from_numpy(x).to(dev)
            yd = torch.from_numpy(y.astype(np.int64)).to(dev)
            idx_d = torch.from_numpy(idx.astype(np.int64)).to(dev)
            w = torch.ones((1, idx.shape[1]), dtype=torch.float32,
                           device=dev)
            g = torch.Generator(device=dev)
            g.manual_seed(self.seed)
            loss = torch.zeros(1, device=dev)
            for step in range(self.steps):
                b = idx_d[step]
                state, loss, _ = train_step(
                    model, state, xd[b][None], yd[b][None], w,
                    learning_rate=self.learning_rate, adam_eps=ADAM_EPS,
                    maxnorm_mode="reference", generator=g)
            with torch.no_grad():
                logits = eval_forward(model, state, xd[None],
                                      fold_index(1, n, dev))
                correct = (torch.argmax(logits[0], dim=-1) == yd).sum()
            # The candidate and its scalars cross to the host.
            state_dict = state.state_dict(0)
            fit_acc = float(correct.cpu()) / n
            loss_f = float(loss[0].cpu())

        path = self.candidate_path(model_id)
        rotate_generations(path, CANDIDATE_KEEP)
        meta = dict(base_meta)
        meta.update({
            "adapted_from": str(base_checkpoint),
            "adapt_steps": self.steps,
            "adapt_n_labeled": n,
        })
        save_checkpoint(path, state_dict, meta)
        # Fired after the stamped write lands: the default corrupt action
        # garbles the finished candidate (the shadow load refuses it),
        # action=raise aborts before the shadow ever sees it.
        inject.fire("adapt.train", model=model_id, path=path)

        digest = variables_digest(*to_jax_variables(state_dict))
        self._journal.event(
            "adaptation_candidate", model=model_id, digest=digest,
            steps=self.steps, n_labeled=n, loss=round(loss_f, 6),
            fit_accuracy=round(fit_acc, 6), checkpoint=str(path),
            elapsed_s=round(time.perf_counter() - t0, 3))
        self._journal.metrics.inc("adapt_candidates")
        logger.info("Adaptation candidate for %s: %d steps on %d labeled "
                    "windows (fit acc %.3f, digest %s)", model_id,
                    self.steps, n, fit_acc, digest[:12])
        return Candidate(model_id=model_id, path=path, digest=digest,
                         steps=self.steps, n_labeled=n, loss=loss_f,
                         fit_accuracy=fit_acc)
