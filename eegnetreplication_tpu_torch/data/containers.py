"""In-memory dataset container (copy of the JAX package's
``data/containers.py``): plain numpy arrays with the sequence protocol."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class BCICI2ADataset:
    """Dataset bundle for BCI Competition IV Dataset 2a.

    Attributes:
        X: float array of shape ``(n_trials, n_channels, n_times)``.
        y: int array of shape ``(n_trials,)`` with labels in ``0..3``.
    """

    X: np.ndarray
    y: np.ndarray

    def __post_init__(self) -> None:
        if self.X.ndim != 3:
            raise ValueError(f"X must be (n, C, T); got shape {self.X.shape}")
        if self.y.shape != (self.X.shape[0],):
            raise ValueError(
                f"y must be (n,) matching X's leading dim; got {self.y.shape} vs {self.X.shape}"
            )

    def __len__(self) -> int:
        return self.X.shape[0]

    def __getitem__(self, idx: int) -> tuple[np.ndarray, int]:
        return self.X[idx], int(self.y[idx])

    @property
    def n_channels(self) -> int:
        return self.X.shape[1]

    @property
    def n_times(self) -> int:
        return self.X.shape[2]

    def concat(self, other: "BCICI2ADataset") -> "BCICI2ADataset":
        """Concatenate two datasets along the trial axis (the protocol's
        Train + Eval sessions of one subject)."""
        return BCICI2ADataset(
            X=np.concatenate([self.X, other.X], axis=0),
            y=np.concatenate([self.y, other.y], axis=0),
        )

    def subset(self, indices: np.ndarray) -> "BCICI2ADataset":
        """Select trials by index."""
        return BCICI2ADataset(X=self.X[indices], y=self.y[indices])


def concat_datasets(datasets: list[BCICI2ADataset]) -> BCICI2ADataset:
    """Concatenate many datasets along the trial axis."""
    return BCICI2ADataset(
        X=np.concatenate([d.X for d in datasets], axis=0),
        y=np.concatenate([d.y for d in datasets], axis=0),
    )
