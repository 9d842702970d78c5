"""Project configuration: paths and the BCI Competition IV 2a constants.

The subset of ``eegnetreplication_tpu/config.py`` that serving,
preprocessing and training read: where raw recordings, processed trials,
trained models and reports live (under the repo root, or under
``EEGTPU_DATA_ROOT``), the dataset's channel, rate, band and window
constants, and the training hyperparameters (:class:`TrainingConfig`, the
same fields and defaults as the JAX package's).
"""

from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass
from pathlib import Path


@dataclass(frozen=True)
class Paths:
    """The project paths the port reads and writes (same layout as the JAX
    package's)."""

    project_root: Path
    data_raw: Path
    data_processed: Path
    models: Path
    reports: Path
    checkpoints: Path

    @staticmethod
    def from_here() -> "Paths":
        """Anchor at the repo root (one level above the package), or at
        ``EEGTPU_DATA_ROOT`` when set."""
        env_root = os.environ.get("EEGTPU_DATA_ROOT")
        root = Path(env_root) if env_root \
            else Path(__file__).resolve().parents[1]
        return Paths.from_root(root)

    @staticmethod
    def from_root(root: Path) -> "Paths":
        root = Path(root)
        return Paths(project_root=root,
                     data_raw=root / "data" / "raw",
                     data_processed=root / "data" / "processed",
                     models=root / "models",
                     reports=root / "reports",
                     checkpoints=root / "checkpoints")


# BCI Competition IV 2a (the reference's dataset.py:89-96, 114, 223-224).
N_EEG_CHANNELS = 22
RAW_SFREQ = 250.0
TARGET_SFREQ = 128.0
BANDPASS_LOW_HZ = 4.0
BANDPASS_HIGH_HZ = 38.0
EPOCH_TMIN_S = 0.5
EPOCH_TMAX_S = 2.5

EEG_CHANNEL_NAMES = (
    "Fz", "FC3", "FC1", "FCz", "FC2", "FC4", "C5", "C3", "C1", "Cz",
    "C2", "C4", "C6", "CP3", "CP1", "CPz", "CP2", "CP4", "P1", "Pz",
    "P2", "POz",
)
EOG_CHANNEL_NAMES = ("EOG-left", "EOG-central", "EOG-right")


@dataclass(frozen=True)
class TrainingConfig:
    """Training hyperparameters (the reference's ``train.py:25-27,92-103``;
    the JAX package's ``config.py:86-127``)."""

    batch_size: int = 64
    epochs: int = 500
    learning_rate: float = 1e-3
    adam_eps: float = 1e-7
    dropout_within_subject: float = 0.5
    dropout_cross_subject: float = 0.25
    kfold_splits: int = 4
    kfold_seed: int = 42
    cs_repeats_per_subject: int = 10
    cs_train_subjects: int = 5
    cs_val_subjects: int = 3
    # Quirk Q1: the reference's "max-norm" hooks clamp the *gradients* of
    # the spatial filters (+-1.0) and the classifier (+-0.25); "paper"
    # projects the weights' L2 norms instead (Lawhern et al.).
    maxnorm_mode: str = "reference"
    # Full f32 ("highest") is the only numerics mode the port runs:
    # utils/device.py turns TF32 off.  The JAX package's "high", "default"
    # and "bf16" are TPU matmul modes, not ported.
    precision: str = "highest"
    # BatchNorm training semantics: "flax" (padding slots counted, biased
    # running variance) or "torch" (padding masked, unbiased running
    # variance); models/norm.py.
    bn_mode: str = "flax"

    def replace(self, **kw) -> "TrainingConfig":
        return dataclasses.replace(self, **kw)


DEFAULT_TRAINING = TrainingConfig()
