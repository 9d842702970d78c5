"""Processed-trial storage and loading.

The port's copy of ``eegnetreplication_tpu/data/io.py``: one ``.npz`` per
subject/session holding already-epoched trials (``X: (n, C, T)``,
``y: (n,)``), the same files the JAX package writes.  Where a session has
only its continuous ``-preprocessed.npz`` bundle, it is epoched on the fly.
The reference's ``.fif`` files and the retry policy around reads are not
ported.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from eegnetreplication_tpu_torch.config import Paths
from eegnetreplication_tpu_torch.data.containers import (
    BCICI2ADataset,
    concat_datasets,
)
from eegnetreplication_tpu_torch.utils.logging import logger


def trials_filename(subject: int, mode: str) -> str:
    """Native processed-trials filename for a subject/session."""
    session = "T" if mode == "Train" else "E"
    return f"A{int(subject):02d}{session}-trials.npz"


def save_trials(dataset: BCICI2ADataset, path: str | Path) -> Path:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(path, X=dataset.X.astype(np.float32),
                        y=dataset.y.astype(np.int64))
    return path


def load_trials(path: str | Path) -> BCICI2ADataset:
    with np.load(Path(path)) as data:
        return BCICI2ADataset(X=data["X"], y=data["y"])


def load_subject_dataset(subject: int | str = "all", mode: str = "Train",
                         paths: Paths | None = None) -> BCICI2ADataset:
    """Processed trials of one subject (or all) and session, from the
    native ``*-trials.npz`` files under ``data/processed/{mode}``, else by
    epoching its ``*-preprocessed.npz`` bundles."""
    paths = paths or Paths.from_here()
    root = paths.data_processed / mode
    pattern = (trials_filename(int(subject), mode) if subject != "all"
               else "*-trials.npz")
    files = sorted(root.glob(pattern))
    if files:
        logger.info("Loading %d processed trial files from %s", len(files),
                    root)
        return concat_datasets([load_trials(f) for f in files])

    # Continuous bundles only: epoch on the fly.
    if list(root.glob("*-preprocessed.npz")):
        from eegnetreplication_tpu_torch.data.epoching import (
            build_dataset_from_preprocessed,
        )

        return build_dataset_from_preprocessed(subject=subject, mode=mode,
                                               paths=paths)

    raise FileNotFoundError(
        f"No processed trials found in {root} for subject {subject!r} "
        f"(expected {pattern} or *-preprocessed.npz).  Make them with "
        "`python -m eegnetreplication_tpu_torch.dataset`.")
