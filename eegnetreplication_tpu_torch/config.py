"""Project configuration: paths and the BCI Competition IV 2a constants.

The subset of ``eegnetreplication_tpu/config.py`` that fetching, serving,
preprocessing and training read: where raw recordings, the moabb runs,
processed trials, trained models and reports live (under the repo root, or
under ``EEGTPU_DATA_ROOT``), the datasets the fetchers download, the
dataset's channel, rate, band and window constants, and the training
hyperparameters (:class:`TrainingConfig`, the same fields and defaults as
the JAX package's).
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
    data_moabb: Path
    data_moabb_processed: Path
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
                     data_moabb=root / "data" / "moabb",
                     data_moabb_processed=root / "data" / "moabb_processed",
                     models=root / "models",
                     reports=root / "reports",
                     checkpoints=root / "checkpoints")


KAGGLE_DATASET = "prashastham/bci-competition-iv-dataset-2a"
MOABB_DATASET = "BNCI2014_001"

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
    # Numerics mode of the model's matmuls and convolutions, the JAX
    # package's four with their meaning on an NVIDIA H100 (the
    # jax.lax.Precision docstring); a run enters utils/device.py::numerics:
    #   "highest" — full f32, TF32 off for cuBLAS and cuDNN; the parity
    #               default (EEGNet's eval block 1 runs on K1-stacked).
    #   "high"    — TF32 matmuls and convolutions (JAX Precision.HIGH).
    #   "default" — TF32 as well: the backend default on this card, the
    #               same numerics as "high".
    #   "bf16"    — bf16 activations end to end (every weight cast per op,
    #               bf16 GEMMs and convolutions); parameters, Adam moments,
    #               BatchNorm statistics and checkpoints stay f32, the
    #               BatchNorms normalise in f32, and the logits are cast to
    #               f32 for the loss.
    # On the CPU "high" and "default" are the f32 computation.  Any other
    # value raises ValueError naming the four (training/protocols.py::
    # _model_kwargs_for_precision).
    precision: str = "highest"
    # BatchNorm training semantics: "flax" (padding slots counted, biased
    # running variance) or "torch" (padding masked, unbiased running
    # variance); models/norm.py.
    bn_mode: str = "flax"

    def replace(self, **kw) -> "TrainingConfig":
        return dataclasses.replace(self, **kw)


DEFAULT_TRAINING = TrainingConfig()
