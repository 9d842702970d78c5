"""Project configuration: paths.

The serving subset of ``eegnetreplication_tpu/config.py``: where processed
trials live (under the repo root, or under ``EEGTPU_DATA_ROOT``).  The
other paths and the training hyperparameters arrive with the training
slice.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from pathlib import Path


@dataclass(frozen=True)
class Paths:
    """The project paths this slice reads (same layout as the JAX
    package's)."""

    project_root: Path
    data_processed: Path

    @staticmethod
    def from_here() -> "Paths":
        """Anchor at the repo root (one level above the package), or at
        ``EEGTPU_DATA_ROOT`` when set."""
        env_root = os.environ.get("EEGTPU_DATA_ROOT")
        root = Path(env_root) if env_root \
            else Path(__file__).resolve().parents[1]
        return Paths(project_root=root,
                     data_processed=root / "data" / "processed")
