"""The within-subject protocol on the card.

The counterpart of ``within_subject_training`` in
``eegnetreplication_tpu/training/protocols.py`` (the reference's
``train.py:30-168``).  Every fold is an index set over one pool that lives
on the device, and all folds train together (``training/loop.py``):

- per subject, the Train and Eval sessions concatenated (``train.py:58-59``);
- ``KFold(4, shuffle=True, random_state=42)`` over them and the inner 80/20
  split of the train-val ids (``data/splits.py``), in the reference's fold
  order; every fold padded to the largest fold's counts;
- dropout 0.5; per subject, the mean test accuracy of its folds and the
  best fold by ``argmax`` of the best validation accuracy (the first
  maximum, i.e. strict ``>`` in fold order, ``train.py:126-128``), saved as
  ``subject_XX_best_model.pth`` (the reference's ``state_dict``) and
  ``.npz`` (the native format, read by both packages).

Seeds: ``seed`` draws the folds' initial weights, ``seed + 1`` the epoch
shuffles (both on CPU generators, so the card and the CPU train on the same
weights and batches), ``seed + 2`` the dropout masks on the training
device.  The cross-subject protocol, fold batching, chunked runs with
snapshots and ``--resume``, and the device mesh are not ported
(ROADMAP.md queue A).
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from pathlib import Path
from typing import Callable

import numpy as np
import torch

from eegnetreplication_tpu_torch.config import (
    DEFAULT_TRAINING,
    Paths,
    TrainingConfig,
)
from eegnetreplication_tpu_torch.data.containers import BCICI2ADataset
from eegnetreplication_tpu_torch.data.splits import (
    inner_train_val_split,
    kfold_indices,
)
from eegnetreplication_tpu_torch.models import EEGNet, get_model
from eegnetreplication_tpu_torch.training import checkpoint as ckpt_lib
from eegnetreplication_tpu_torch.training.loop import (
    FoldResult,
    FoldTrainer,
    SlotSource,
    init_fold_states,
    make_fold_spec,
)
from eegnetreplication_tpu_torch.utils.device import resolve_device
from eegnetreplication_tpu_torch.utils.logging import logger

LoadFn = Callable[[int, str], BCICI2ADataset]


def _default_loader(subject: int, mode: str) -> BCICI2ADataset:
    from eegnetreplication_tpu_torch.data.io import load_subject_dataset

    return load_subject_dataset(subject=subject, mode=mode)


@dataclass
class ProtocolResult:
    per_subject_test_acc: list[float]
    avg_test_acc: float
    best_states: list[dict]         # per subject: the best fold's state_dict
    fold_test_acc: np.ndarray       # every fold's test accuracy
    # Training wall on the host clock, from the first epoch (the pool
    # already on the device) to the test pass's results on the host (the
    # test pass included, as in the JAX package's single-program runs).
    # Basis of epoch_throughput.
    wall_seconds: float
    epochs: int
    subjects: tuple[int, ...] = tuple(range(1, 10))
    fold_min_val_loss: np.ndarray | None = None
    folds: FoldResult | None = None  # every fold's per-epoch record

    @property
    def epoch_throughput(self) -> float:
        """Fold-epochs trained per second."""
        return len(self.fold_test_acc) * self.epochs / max(
            self.wall_seconds, 1e-9)


def build_pool(datasets: list[BCICI2ADataset]
                ) -> tuple[np.ndarray, np.ndarray, list[np.ndarray]]:
    """Concatenate datasets into one pool; return per-dataset global
    indices."""
    offsets, cursor = [], 0
    for d in datasets:
        offsets.append(np.arange(cursor, cursor + len(d)))
        cursor += len(d)
    pool_x = np.concatenate([d.X for d in datasets]).astype(np.float32)
    pool_y = np.concatenate([d.y for d in datasets]).astype(np.int64)
    return pool_x, pool_y, offsets


def within_subject_folds(offsets: list[np.ndarray],
                         config: TrainingConfig = DEFAULT_TRAINING
                         ) -> list[tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """The ``(train, val, test)`` pool indices of every fold, subjects in
    order and ``config.kfold_splits`` folds each (the reference's order)."""
    folds = []
    for g in offsets:
        for train_val_ids, test_ids in kfold_indices(
                len(g), config.kfold_splits, config.kfold_seed):
            train_ids, val_ids = inner_train_val_split(train_val_ids)
            folds.append((g[train_ids], g[val_ids], g[test_ids]))
    return folds


def save_model(state_dict: dict, model: EEGNet, model_name: str,
               path: Path) -> None:
    """The reference's ``.pth`` at ``path`` and the native ``.npz`` beside
    it, with the geometry the loaders read."""
    ckpt_lib.save_pth(path, state_dict)
    ckpt_lib.save_checkpoint(
        path.with_suffix(".npz"), state_dict,
        metadata={"model": model_name, "n_channels": model.n_channels,
                  "n_times": model.n_times, "F1": model.F1, "D": model.D})


def within_subject_trainer(pool_x: np.ndarray, pool_y: np.ndarray,
                           offsets: list[np.ndarray], *,
                           config: TrainingConfig = DEFAULT_TRAINING,
                           seed: int = 0,
                           device: torch.device | str | None = None,
                           model_name: str = "eegnet",
                           slot_source: SlotSource | None = None
                           ) -> tuple[FoldTrainer, EEGNet, list]:
    """The protocol's :class:`FoldTrainer` over a pool (:func:`build_pool`)
    with the pool copied to ``device``; returns ``(trainer, model template,
    folds)``.  :func:`within_subject_training` runs its epochs."""
    device = resolve_device(device)
    model = get_model(model_name, n_channels=pool_x.shape[1],
                      n_times=pool_x.shape[2],
                      dropout_rate=config.dropout_within_subject,
                      bn_mode=config.bn_mode, device="cpu")
    folds = within_subject_folds(offsets, config)
    spec = make_fold_spec(
        folds, train_pad=max(len(f[0]) for f in folds),
        val_pad=max(len(f[1]) for f in folds),
        test_pad=max(len(f[2]) for f in folds), device=device)
    init = init_fold_states(model, len(folds),
                            torch.Generator().manual_seed(seed))
    trainer = FoldTrainer(
        model, torch.from_numpy(pool_x).to(device),
        torch.from_numpy(pool_y).to(device), spec, init,
        batch_size=config.batch_size, learning_rate=config.learning_rate,
        adam_eps=config.adam_eps, maxnorm_mode=config.maxnorm_mode,
        slot_source=slot_source,
        shuffle_generator=torch.Generator().manual_seed(seed + 1),
        dropout_generator=torch.Generator(device=device).manual_seed(
            seed + 2))
    return trainer, model, folds


def within_subject_training(epochs: int | None = None, *,
                            config: TrainingConfig = DEFAULT_TRAINING,
                            loader: LoadFn = _default_loader,
                            subjects: tuple[int, ...] = tuple(range(1, 10)),
                            seed: int = 0, paths: Paths | None = None,
                            model_name: str = "eegnet",
                            save_models: bool = True,
                            device: torch.device | str | None = None,
                            slot_source: SlotSource | None = None
                            ) -> ProtocolResult:
    """Within-subject protocol: per subject, 4-fold CV over both sessions,
    every fold of every subject trained together on ``device`` (the card
    unless ``EEGTPU_PLATFORM=cpu``).  ``slot_source`` replaces the epoch
    shuffles (tests feed the JAX package's)."""
    epochs = epochs if epochs is not None else config.epochs
    paths = paths or Paths.from_here()
    device = resolve_device(device)
    if config.precision != "highest":
        raise ValueError(
            f"precision={config.precision!r}: the torch port computes in "
            "full f32 only ('highest'); the TPU matmul modes are not ported")

    datasets = []
    for s in subjects:
        logger.info("Loading Subject %d", s)
        datasets.append(loader(s, "Train").concat(loader(s, "Eval")))
    trainer, model, folds = within_subject_trainer(
        *build_pool(datasets), config=config, seed=seed, device=device,
        model_name=model_name, slot_source=slot_source)
    logger.info("Training %d folds (%d subjects x %d) for %d epochs on %s, "
                "all folds per step", len(folds), len(subjects),
                config.kfold_splits, epochs, device)
    t0 = time.perf_counter()
    for _ in range(epochs):
        trainer.run_epoch()
    result = trainer.result()
    wall = time.perf_counter() - t0

    fold_test = result.test_accuracy.numpy()
    fold_best_val = result.best_val_acc.numpy()
    k = config.kfold_splits
    per_subject_test_acc, best_states = [], []
    for i, s in enumerate(subjects):
        per_subject_test_acc.append(float(np.mean(fold_test[i * k:(i + 1) * k])))
        best_fold = i * k + int(np.argmax(fold_best_val[i * k:(i + 1) * k]))
        best_states.append(result.best_state.state_dict(best_fold))
        logger.info("Subject %d - Average Test Accuracy: %.2f%%", s,
                    per_subject_test_acc[-1])
        if save_models:
            paths.models.mkdir(parents=True, exist_ok=True)
            save_model(best_states[-1], model, model_name,
                       paths.models / f"subject_{s:02d}_best_model.pth")

    avg = float(np.mean(per_subject_test_acc))
    logger.info("Overall Average Test Accuracy across all subjects: %.2f%%",
                avg)
    out = ProtocolResult(per_subject_test_acc, avg, best_states, fold_test,
                         wall, epochs, tuple(subjects),
                         fold_min_val_loss=result.min_val_loss.numpy(),
                         folds=result)
    logger.info("Throughput: %.2f fold-epochs/s (%d folds x %d epochs in "
                "%.1fs)", out.epoch_throughput, len(folds), epochs, wall)
    return out
