"""Project configuration: paths and the BCI Competition IV 2a constants.

The subset of ``eegnetreplication_tpu/config.py`` that serving and
preprocessing read: where raw recordings and processed trials live (under
the repo root, or under ``EEGTPU_DATA_ROOT``), and the dataset's channel,
rate, band and window constants.  The other paths and the training
hyperparameters arrive with the training slice.
"""

from __future__ import annotations

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
                     data_processed=root / "data" / "processed")


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
