"""The reference's two protocols, worked out from the reference's
``train.py`` and scikit-learn's ``KFold``: which trials each fold trains,
validates and tests on, and in which order the batches come.

The pool is laid out as the traffic file's ``pool_layout`` says:
``"sessions"`` puts every subject's first session, then every subject's
second (the cross-subject pool), ``"subjects"`` puts each subject's two
sessions side by side (the within-subject pool).  A fold is a triple of
index vectors into that pool.
"""

from __future__ import annotations

import numpy as np
import torch


def session_offsets(n_subjects: int, n_sessions: int, n_trials: int,
                    layout: str) -> list[list[np.ndarray]]:
    """``offsets[s][k]``: the pool indices of subject ``s``'s session
    ``k`` under ``layout``."""
    out = []
    for s in range(n_subjects):
        row = []
        for k in range(n_sessions):
            if layout == "sessions":
                start = (k * n_subjects + s) * n_trials
            elif layout == "subjects":
                start = (s * n_sessions + k) * n_trials
            else:
                raise ValueError(f"unknown pool layout {layout!r}")
            row.append(np.arange(start, start + n_trials))
        out.append(row)
    return out


def kfold(n: int, k: int, seed: int) -> list[tuple[np.ndarray, np.ndarray]]:
    """scikit-learn's ``KFold(k, shuffle=True, random_state=seed)``: a
    ``RandomState(seed)`` permutation cut into consecutive test parts, the
    first ``n % k`` one longer; both id sets ascending."""
    order = np.random.RandomState(seed).permutation(n)
    sizes = [n // k + (1 if i < n % k else 0) for i in range(k)]
    out, at = [], 0
    for size in sizes:
        test = np.sort(order[at:at + size])
        train = np.setdiff1d(np.arange(n), test)
        out.append((train, test))
        at += size
    return out


def within_subject_folds(offsets, traffic: dict):
    """Per subject in order, ``kfold_splits`` folds over both sessions
    concatenated; the first fifth of each fold's train-val ids validates
    (the reference's ``train.py:70-79``)."""
    folds = []
    for sessions in offsets:
        ids = np.concatenate(sessions)
        for train_val, test in kfold(len(ids), traffic["kfold_splits"],
                                     traffic["kfold_seed"]):
            n_val = len(train_val) // 5
            folds.append((ids[train_val[n_val:]], ids[train_val[:n_val]],
                          ids[test]))
    return folds


def cross_subject_folds(offsets, traffic: dict):
    """Per held-out subject in order, ``repeats_per_subject`` folds; the
    k-th fold of all (from 1) permutes the other subjects with
    ``RandomState(42 + k)``, trains on the first ``train_subjects`` and
    validates on the rest, on their first session, and tests on the held-out
    subject's second session (``train.py:188-258``)."""
    n = len(offsets)
    folds, k = [], 0
    for test in range(n):
        for _ in range(traffic["repeats_per_subject"]):
            k += 1
            others = np.array([s for s in range(n) if s != test])
            drawn = np.random.RandomState(42 + k).permutation(others)
            tr = drawn[:traffic["train_subjects"]]
            va = drawn[traffic["train_subjects"]:]
            folds.append((np.concatenate([offsets[s][0] for s in tr]),
                          np.concatenate([offsets[s][0] for s in va]),
                          offsets[test][1]))
    return folds


def folds_of(traffic: dict) -> list[tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """Every fold of the traffic's protocol."""
    offsets = session_offsets(traffic["subjects"], traffic["sessions"],
                              traffic["trials_per_session"],
                              traffic["pool_layout"])
    if traffic["protocol"] == "within_subject":
        return within_subject_folds(offsets, traffic)
    if traffic["protocol"] == "cross_subject":
        return cross_subject_folds(offsets, traffic)
    raise ValueError(f"unknown protocol {traffic['protocol']!r}")


def shuffle_seed(seed: int, fold: int, epoch: int) -> int:
    """The 64-bit seed of one fold's batch order at one epoch: numpy's
    ``SeedSequence`` over ``(seed, fold, epoch)``."""
    words = np.random.SeedSequence([seed & (2 ** 64 - 1), fold, epoch])
    return int(words.generate_state(1, np.uint64)[0])


def epoch_slots(train_ids: np.ndarray, n_slots: int, seed: int, fold: int,
                epoch: int) -> tuple[np.ndarray, np.ndarray]:
    """One fold's training slots at one epoch: the real trials in the order
    of a ``torch.randperm`` drawn from ``shuffle_seed``, then the same
    order again from the start to fill ``n_slots``, at loss weight 0."""
    n = len(train_ids)
    gen = torch.Generator().manual_seed(shuffle_seed(seed, fold, epoch))
    order = torch.randperm(n, generator=gen).numpy()
    slots = np.arange(n_slots)
    return train_ids[order[slots % n]], (slots < n).astype(np.float32)


def n_batches(n: int, batch: int) -> int:
    return max(1, -(-n // batch))
