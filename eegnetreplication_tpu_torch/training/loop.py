"""Fold training: every fold of a protocol advances together on the card.

The counterpart of ``eegnetreplication_tpu/training/loop.py``.  The JAX
package compiles a whole run into one ``lax.scan`` and ``vmap``s it over the
folds; PyTorch runs eagerly, so here the epoch and step loops are Python,
and the fold axis is a leading tensor axis: one train step, and one
validation or test batch, is one pass for all G folds (``training/steps.py``).

- The data pool lives on the device once, ``(N_pool, C, T)``; a fold is an
  index set into it (:class:`FoldSpec`), and a batch is an index gather.
- Each epoch's shuffle comes from a *slot source*: by default
  :func:`shuffled_slot_source`, which draws every fold's permutation on a
  CPU ``torch.Generator`` (so the card and the CPU see the same batch
  order); a test can hand in the JAX package's ``_shuffled_slots`` instead.
  The first ``n`` slots are the real indices in random order, the rest wrap
  around (``slot % n``) at loss weight 0.
- Nothing waits for the device inside an epoch: losses, accuracies and the
  best-by-validation snapshot stay on the device, and the run syncs once,
  when :meth:`FoldTrainer.result` copies them out.
- Best-by-validation uses strict ``>`` (ties keep the earlier epoch, like
  the reference's ``model.py:180``); the test pass evaluates the best state.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from eegnetreplication_tpu_torch.models.eegnet import EEGNet
from eegnetreplication_tpu_torch.ops.fused_eegnet import fold_index
from eegnetreplication_tpu_torch.resil import preempt
from eegnetreplication_tpu_torch.training import steps as steps_lib
from eegnetreplication_tpu_torch.training.steps import TrainState

# epoch -> (pool indices, loss weights), each (G, train_steps * batch_size)
SlotSource = Callable[[int], tuple[torch.Tensor, torch.Tensor]]


@dataclass
class FoldSpec:
    """Index sets of G folds over one data pool, padded to static lengths
    (the padding's content is unused); ``*_n`` are the real counts."""

    train_idx: torch.Tensor   # (G, Ntr_pad) int64
    train_n: torch.Tensor     # (G,) int64
    val_idx: torch.Tensor     # (G, Nva_pad)
    val_n: torch.Tensor
    test_idx: torch.Tensor    # (G, Nte_pad)
    test_n: torch.Tensor

    @property
    def n_folds(self) -> int:
        return self.train_idx.shape[0]

    def to(self, device) -> "FoldSpec":
        return FoldSpec(*(getattr(self, f).to(device) for f in
                          ("train_idx", "train_n", "val_idx", "val_n",
                           "test_idx", "test_n")))


@dataclass
class FoldResult:
    """Outcome of G folds' runs (cf. the reference's ``model.py:189``),
    on the CPU."""

    best_state: TrainState          # best-by-validation-accuracy snapshot
    best_val_acc: torch.Tensor      # (G,) percentage
    min_val_loss: torch.Tensor      # (G,)
    train_losses: torch.Tensor      # (G, epochs)
    val_losses: torch.Tensor        # (G, epochs)
    val_accuracies: torch.Tensor    # (G, epochs) percentage
    grad_norms: torch.Tensor        # (G, epochs) mean raw gradient norm
    test_accuracy: torch.Tensor     # (G,) percentage, best state on test


def pad_indices(idx: np.ndarray, pad_to: int) -> np.ndarray:
    """Pad an index vector to a static length (padding content unused)."""
    out = np.zeros(pad_to, dtype=np.int64)
    out[: len(idx)] = idx
    return out


def make_fold_spec(folds, *, train_pad: int, val_pad: int, test_pad: int,
                   device=None) -> FoldSpec:
    """Stack ragged ``(train, val, test)`` index triples into a
    :class:`FoldSpec` of tensors on ``device``."""
    def stack(which, pad):
        return torch.from_numpy(np.stack(
            [pad_indices(np.asarray(f[which]), pad) for f in folds]))

    def counts(which):
        return torch.tensor([len(f[which]) for f in folds],
                            dtype=torch.int64)

    spec = FoldSpec(stack(0, train_pad), counts(0), stack(1, val_pad),
                    counts(1), stack(2, test_pad), counts(2))
    return spec if device is None else spec.to(device)


def shuffled_slots(generator: torch.Generator, idx: torch.Tensor, n: int,
                   n_slots: int) -> tuple[torch.Tensor, torch.Tensor]:
    """One fold's epoch shuffle with wrap-around padding, on the CPU.

    Returns ``(pool_indices, weights)`` of length ``n_slots``: the first
    ``n`` slots are the ``n`` real entries of ``idx`` in random order; later
    slots repeat them (``slot % n``) with weight 0.
    """
    slots = torch.arange(n_slots)
    if n > 0:
        order = torch.randperm(n, generator=generator)
        picked = idx[order[slots % n]]
    else:
        picked = idx[torch.zeros_like(slots)]
    return picked, (slots < n).to(torch.float32)


def shuffled_slot_source(spec: FoldSpec, n_slots: int,
                         generator: torch.Generator) -> SlotSource:
    """The default slot source: each epoch, every fold's
    :func:`shuffled_slots` from one CPU generator, in fold order."""
    train_idx = spec.train_idx.cpu()
    train_n = [int(n) for n in spec.train_n.cpu()]

    def source(epoch: int) -> tuple[torch.Tensor, torch.Tensor]:
        del epoch   # the generator's stream carries the schedule
        picked, weights = zip(*(
            shuffled_slots(generator, train_idx[g], train_n[g], n_slots)
            for g in range(len(train_n))))
        return torch.stack(picked), torch.stack(weights)

    return source


def linear_slots(idx: torch.Tensor, n: torch.Tensor, n_slots: int
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Validation/test slot layout of G folds: slot ``s`` reads
    ``idx[s % n]`` with weight ``s < n``; ``(G, n_slots)`` each."""
    slots = torch.arange(n_slots, device=idx.device)[None, :]
    nn_ = n[:, None]
    pos = torch.where(nn_ > 0, slots % torch.clamp(nn_, min=1),
                      torch.zeros_like(slots))
    return torch.gather(idx, 1, pos), (slots < nn_).to(torch.float32)


def n_steps(pad: int, batch_size: int, at_least: int = 0) -> int:
    return max(at_least, math.ceil(pad / batch_size))


class FoldTrainer:
    """G folds trained together over one pool on one device.

    ``model`` is a template giving the geometry and the training
    hyperparameters (``bn_mode``, ``dropout_rate``).  Per epoch
    (:meth:`run_epoch`): ``ceil(train_pad / B)`` train steps, then
    ``max(1, ceil(val_pad / B))`` validation batches, each one launch of
    the stacked K1 kernel for all folds; then the best-by-validation
    update.  :meth:`test` evaluates the best state in ``max(1,
    ceil(test_pad / B))`` batches.
    """

    def __init__(self, model: EEGNet, pool_x: torch.Tensor,
                 pool_y: torch.Tensor, spec: FoldSpec,
                 init_state: TrainState, *, batch_size: int,
                 learning_rate: float, adam_eps: float,
                 maxnorm_mode: str = "reference",
                 slot_source: SlotSource | None = None,
                 shuffle_generator: torch.Generator | None = None,
                 dropout_generator: torch.Generator | None = None):
        device = pool_x.device
        self.model = model
        self.pool_x, self.pool_y = pool_x, pool_y.long()
        self.spec = spec.to(device)
        self.batch_size = batch_size
        self.step_kw = dict(learning_rate=learning_rate, adam_eps=adam_eps,
                            maxnorm_mode=maxnorm_mode,
                            generator=dropout_generator)
        g = spec.n_folds
        self.train_steps = n_steps(spec.train_idx.shape[1], batch_size)
        self.val_steps = n_steps(spec.val_idx.shape[1], batch_size, 1)
        self.test_steps = n_steps(spec.test_idx.shape[1], batch_size, 1)
        if slot_source is None:
            slot_source = shuffled_slot_source(
                spec, self.train_steps * batch_size,
                shuffle_generator or torch.Generator().manual_seed(0))
        self.slot_source = slot_source
        self.fold_idx = fold_index(g, batch_size, device)

        def real_batches(n):
            return torch.clamp(torch.ceil(n / batch_size), min=1.0)

        self.real_train_batches = real_batches(self.spec.train_n.double()
                                               ).float()
        self.real_val_batches = real_batches(self.spec.val_n.double()
                                             ).float()
        self.val_gather, self.val_w = linear_slots(
            self.spec.val_idx, self.spec.val_n,
            self.val_steps * batch_size)
        self.state = init_state.to(device)
        self.best = self.state
        self.best_acc = torch.zeros(g, device=device)
        self.min_val_loss = torch.full((g,), math.inf, device=device)
        self.history: list[tuple[torch.Tensor, ...]] = []

    def _batch(self, gather: torch.Tensor, weights: torch.Tensor, step: int):
        b = self.batch_size
        idx = gather[:, step * b:(step + 1) * b]
        return (self.pool_x[idx], self.pool_y[idx],
                weights[:, step * b:(step + 1) * b])

    def run_epoch(self) -> None:
        """Train every fold one epoch, validate, keep the best state."""
        preempt.check(what="epoch", epoch=len(self.history))
        gather, weights = self.slot_source(len(self.history))
        device = self.pool_x.device
        gather = gather.to(device, torch.int64)
        weights = weights.to(device, torch.float32)
        loss_sum = torch.zeros(self.spec.n_folds, device=device)
        gnorm_sum = torch.zeros_like(loss_sum)
        for step in range(self.train_steps):
            x, y, w = self._batch(gather, weights, step)
            self.state, loss, gnorm = steps_lib.train_step(
                self.model, self.state, x, y, w, **self.step_kw)
            loss_sum = loss_sum + loss
            gnorm_sum = gnorm_sum + gnorm
        # epoch_train_loss = running_loss / len(train_loader) (model.py:171)
        train_loss = loss_sum / self.real_train_batches
        grad_norm = gnorm_sum / self.real_train_batches

        val_loss_sum = torch.zeros_like(loss_sum)
        correct = torch.zeros_like(loss_sum)
        with torch.no_grad():
            for step in range(self.val_steps):
                x, y, w = self._batch(self.val_gather, self.val_w, step)
                loss, hits = steps_lib.eval_step(self.model, self.state, x, y,
                                                 w, self.fold_idx)
                val_loss_sum = val_loss_sum + torch.where(
                    w.sum(1) > 0, loss, torch.zeros_like(loss))
                correct = correct + hits
        val_loss = val_loss_sum / self.real_val_batches
        val_acc = 100.0 * correct / torch.clamp(self.spec.val_n, min=1)

        improved = val_acc > self.best_acc          # strict >, model.py:180
        self.best = self.state.select(improved, self.best)
        self.best_acc = torch.maximum(self.best_acc, val_acc)
        self.min_val_loss = torch.minimum(self.min_val_loss, val_loss)
        self.history.append((train_loss, val_loss, val_acc, grad_norm))

    def test(self) -> torch.Tensor:
        """Test accuracy (percentage, ``(G,)``) of the best states."""
        return evaluate_pool(self.model, self.best, self.pool_x, self.pool_y,
                             self.spec.test_idx, self.spec.test_n,
                             self.batch_size, self.fold_idx)

    def result(self) -> FoldResult:
        """Run the test pass and copy everything to the CPU (the run's one
        wait for the device)."""
        test_acc = self.test()
        per_epoch = [torch.stack(series, dim=1).cpu()
                     for series in zip(*self.history)]
        return FoldResult(
            best_state=self.best.to("cpu"),
            best_val_acc=self.best_acc.cpu(),
            min_val_loss=self.min_val_loss.cpu(),
            train_losses=per_epoch[0], val_losses=per_epoch[1],
            val_accuracies=per_epoch[2], grad_norms=per_epoch[3],
            test_accuracy=test_acc.cpu())


def evaluate_pool(model: EEGNet, state: TrainState, pool_x: torch.Tensor,
                  pool_y: torch.Tensor, idx: torch.Tensor, n: torch.Tensor,
                  batch_size: int, fold_idx: torch.Tensor | None = None
                  ) -> torch.Tensor:
    """Accuracy (percentage, ``(G,)``) of every fold's ``state`` on its
    ``pool[idx[:n]]`` (the reference's ``evaluate_model``)."""
    steps = n_steps(idx.shape[1], batch_size, 1)
    gather, weights = linear_slots(idx, n, steps * batch_size)
    if fold_idx is None:
        fold_idx = fold_index(idx.shape[0], batch_size, pool_x.device)
    correct = torch.zeros(idx.shape[0], device=pool_x.device)
    with torch.no_grad():
        for step in range(steps):
            sl = slice(step * batch_size, (step + 1) * batch_size)
            bi = gather[:, sl]
            _, hits = steps_lib.eval_step(model, state, pool_x[bi],
                                          pool_y[bi].long(), weights[:, sl],
                                          fold_idx)
            correct = correct + hits
    return 100.0 * correct / torch.clamp(n, min=1)


def init_fold_states(model: EEGNet, n_folds: int,
                     generator: torch.Generator) -> TrainState:
    """``n_folds`` independent initial states, stacked.

    Each fold draws a fresh EEGNet of ``model``'s geometry from
    ``generator`` (a CPU generator, so one seed gives the same weights on
    any device), like the reference's fresh ``EEGNet()`` per fold
    (``train.py:92``).
    """
    dicts = []
    for _ in range(n_folds):
        fresh = EEGNet(model.n_channels, model.n_times, model.n_classes,
                       model.F1, model.D, device="cpu", generator=generator)
        dicts.append(fresh.state_dict())
    stacked = {k: torch.stack([d[k] for d in dicts]) for k in dicts[0]}
    return TrainState.create(steps_lib.StateLayout.of(model), stacked)
