"""Deterministic split logic reproducing the reference's protocols exactly.

The port's copy of ``eegnetreplication_tpu/data/splits.py`` (pure numpy):

- :func:`kfold_indices`: sklearn ``KFold(n_splits, shuffle=True,
  random_state)`` semantics (the reference's ``train.py:70-73``), train and
  test ids sorted ascending;
- :func:`inner_train_val_split`: the first fifth of the train-val ids
  validates, the rest trains (``train.py:77-79``);
- :func:`cross_subject_fold_subjects`: the seeded 5-train/3-val subject
  draw per cross-subject fold (``train.py:199-202``).
"""

from __future__ import annotations

import numpy as np


def kfold_indices(n_samples: int, n_splits: int = 4, seed: int = 42,
                  shuffle: bool = True) -> list[tuple[np.ndarray, np.ndarray]]:
    """``(train_ids, test_ids)`` pairs with sklearn KFold semantics: a
    ``RandomState(seed)`` permutation of ``arange(n)`` cut into consecutive
    test chunks of ``n // k`` (+1 for the first ``n % k`` folds)."""
    if n_splits < 2:
        raise ValueError("n_splits must be >= 2")
    if n_splits > n_samples:
        raise ValueError(
            f"Cannot have n_splits={n_splits} > n_samples={n_samples}")
    order = np.arange(n_samples)
    if shuffle:
        order = np.random.RandomState(seed).permutation(n_samples)
    indices = np.arange(n_samples)
    fold_sizes = np.full(n_splits, n_samples // n_splits, dtype=int)
    fold_sizes[: n_samples % n_splits] += 1
    splits = []
    current = 0
    for size in fold_sizes:
        # Through a boolean mask, as sklearn does, so both come out sorted:
        # the inner split takes the *first* fifth of the train ids.
        test_mask = np.zeros(n_samples, dtype=bool)
        test_mask[order[current:current + size]] = True
        splits.append((indices[~test_mask], indices[test_mask]))
        current += size
    return splits


def inner_train_val_split(train_val_ids: np.ndarray
                          ) -> tuple[np.ndarray, np.ndarray]:
    """The reference's inner split: 20% validation from the front."""
    val_size = len(train_val_ids) // 5
    return train_val_ids[val_size:], train_val_ids[:val_size]


def cross_subject_fold_subjects(test_subject: int, fold_count: int,
                                subjects: tuple[int, ...] = tuple(range(1, 10)),
                                n_train: int = 5,
                                seed_base: int = 42
                                ) -> tuple[np.ndarray, np.ndarray]:
    """Seeded train/val subject draw for one cross-subject fold:
    ``RandomState(seed_base + fold_count)`` (``fold_count`` 1-based) permutes
    the non-test subject labels; the first ``n_train`` train, the rest
    validate."""
    other = np.array([s for s in subjects if s != test_subject])
    rng = np.random.RandomState(seed_base + fold_count)
    shuffled = rng.permutation(other)
    return shuffled[:n_train], shuffled[n_train:]
