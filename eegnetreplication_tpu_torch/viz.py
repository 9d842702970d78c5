"""Learned-filter visualization: temporal filters, spatial topomaps, spectra.

The port's copy of ``eegnetreplication_tpu/viz.py``, the counterpart of the
reference's viz stack (``src/eegnet_repl/ui.py:516-595``) with two
structural changes:

- it consumes checkpoints in either format (native ``.npz`` through the
  port's :func:`~eegnetreplication_tpu_torch.training.checkpoint.load_checkpoint`,
  or reference ``.pth``) through :func:`load_model_filters`, instead of
  requiring a live torch module;
- the scalp topomap is self-contained: the reference calls MNE's
  ``plot_topomap`` on a standard-1020 montage (``ui.py:534-560``); here the
  22-electrode BCI-IV-2a subset carries its own 2D head-layout coordinate
  table (azimuthal 10-20 projection: 0.2 radius per 10% arc step) and the
  field map is cubic-interpolated with scipy — no MNE dependency.

All plotting functions return the matplotlib Figure and only call
``plt.show()`` when ``show=True``, so they are testable headless.
matplotlib is imported inside them, so nothing else in the port needs it;
:func:`topomap_grid`, the field a topomap draws, needs only scipy.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path

import numpy as np

from eegnetreplication_tpu_torch.config import EEG_CHANNEL_NAMES, TARGET_SFREQ
from eegnetreplication_tpu_torch.utils.logging import logger

# 2D head-circle coordinates (azimuthal equidistant 10-20 projection; the
# vertex Cz is the origin, the head circumference is radius 1.0, and each 10%
# arc step moves 0.2 outward) for the 22 BCI-IV-2a electrodes, in the
# reference's channel order (``dataset.py:89-96``).
ELECTRODE_XY = {
    "Fz": (0.0, 0.4),
    "FC3": (-0.40, 0.21), "FC1": (-0.20, 0.20), "FCz": (0.0, 0.2),
    "FC2": (0.20, 0.20), "FC4": (0.40, 0.21),
    "C5": (-0.6, 0.0), "C3": (-0.4, 0.0), "C1": (-0.2, 0.0), "Cz": (0.0, 0.0),
    "C2": (0.2, 0.0), "C4": (0.4, 0.0), "C6": (0.6, 0.0),
    "CP3": (-0.40, -0.21), "CP1": (-0.20, -0.20), "CPz": (0.0, -0.2),
    "CP2": (0.20, -0.20), "CP4": (0.40, -0.21),
    "P1": (-0.20, -0.41), "Pz": (0.0, -0.4), "P2": (0.20, -0.41),
    "POz": (0.0, -0.6),
}


@dataclass
class FilterSet:
    """Learned filters extracted from a checkpoint.

    temporal: ``(F1, k_t)`` temporal conv kernels (reference
        ``temporal.0.weight[:, 0, 0, :]``, ``ui.py:518``).
    spatial: ``(F2, C)`` depthwise spatial filters (reference
        ``spatial.weight[:, 0, :, 0]``, ``ui.py:548``).
    """

    temporal: np.ndarray
    spatial: np.ndarray
    channel_names: tuple[str, ...] = EEG_CHANNEL_NAMES
    sfreq: float = TARGET_SFREQ


def load_model_filters(path: str | Path) -> FilterSet:
    """Load a checkpoint (``.npz`` native or ``.pth`` torch) into a FilterSet.

    Replaces ``load_model`` (``ui.py:26-36``) — the reference materializes a
    full torch module just to read two weight tensors; quirk Q4's hardcoded
    ``T=256`` disappears because no model is instantiated.
    """
    path = Path(path)
    if path.suffix == ".npz":
        from eegnetreplication_tpu_torch.training.checkpoint import (
            load_checkpoint,
        )

        # The loader verifies the content digest and gives the reference's
        # state_dict layout, the same keys a .pth holds.
        sd, _ = load_checkpoint(path)
    elif path.suffix == ".pth":
        import torch

        # weights_only=True: the state_dicts are plain tensors and
        # untrusted .pth pickles must not execute code.
        sd = torch.load(path, map_location="cpu", weights_only=True)
    else:
        raise ValueError(f"Unknown checkpoint format: {path.suffix!r}")
    # torch NCHW weights: temporal (F1, 1, 1, kt); spatial (F2, 1, C, 1).
    temporal = sd["temporal.0.weight"][:, 0, 0, :].numpy()
    spatial = sd["spatial.weight"][:, 0, :, 0].numpy()
    return FilterSet(temporal=np.asarray(temporal, np.float32),
                     spatial=np.asarray(spatial, np.float32))


def _grid_axes(n: int, n_cols: int = 4, panel=(15, 8)):
    import matplotlib.pyplot as plt

    n_rows = n // n_cols + int(n % n_cols > 0)
    fig, axes = plt.subplots(n_rows, n_cols, figsize=panel, squeeze=False)
    return fig, axes, n_cols


def plot_temporal_filters(filters: FilterSet, show: bool = True,
                          save_path: str | Path | None = None):
    """Plot the learned temporal kernels over a 0-250 ms axis (``ui.py:516-532``)."""
    temporal = filters.temporal
    t = np.linspace(0, 0.25, temporal.shape[1])
    fig, axes, n_cols = _grid_axes(temporal.shape[0])
    for i in range(temporal.shape[0]):
        ax = axes[i // n_cols][i % n_cols]
        ax.plot(t, temporal[i], "ko-")
        ax.set_title(f"Temporal Filter {i + 1}")
        ax.set_xlabel("Time (s)")
        ax.set_ylabel("Amplitude")
    fig.tight_layout()
    return _finish(fig, show, save_path)


def topomap_grid(values: np.ndarray, channel_names=EEG_CHANNEL_NAMES,
                 resolution: int = 64) -> np.ndarray:
    """The ``(resolution, resolution)`` field :func:`plot_topomap` draws:
    per-electrode values interpolated by a thin-plate spline over the
    head square, NaN outside the head circle."""
    from scipy.interpolate import RBFInterpolator

    xy = np.array([ELECTRODE_XY[name] for name in channel_names])
    grid = np.linspace(-1.0, 1.0, resolution)
    gx, gy = np.meshgrid(grid, grid)
    pts = np.stack([gx.ravel(), gy.ravel()], axis=-1)
    interp = RBFInterpolator(xy, values, kernel="thin_plate_spline")(pts)
    interp = interp.reshape(gx.shape)
    interp[gx ** 2 + gy ** 2 > 1.0] = np.nan  # clip to the head circle
    return interp


def plot_topomap(values: np.ndarray, ax, channel_names=EEG_CHANNEL_NAMES,
                 cmap: str = "viridis", resolution: int = 64) -> None:
    """Draw one interpolated scalp map onto ``ax`` (MNE-free topomap).

    Thin-plate-spline interpolation of per-electrode values over a
    head-circle grid (smooth inside and beyond the electrode hull, like MNE's
    spherical-spline maps), plus the standard head/nose/ear outline.
    """
    from matplotlib import patches

    xy = np.array([ELECTRODE_XY[name] for name in channel_names])
    interp = topomap_grid(values, channel_names, resolution)

    ax.imshow(interp, extent=(-1, 1, -1, 1), origin="lower", cmap=cmap)
    ax.add_patch(patches.Circle((0, 0), 1.0, fill=False, lw=1.5))
    ax.add_patch(patches.Polygon([(-0.08, 0.99), (0.0, 1.12), (0.08, 0.99)],
                                 fill=False, lw=1.5))  # nose
    for side in (-1, 1):
        ax.add_patch(patches.Ellipse((side * 1.03, 0.0), 0.08, 0.24,
                                     fill=False, lw=1.5))
    ax.scatter(xy[:, 0], xy[:, 1], s=4, c="k")
    ax.set_xlim(-1.2, 1.2)
    ax.set_ylim(-1.15, 1.2)
    ax.set_aspect("equal")
    ax.axis("off")


def plot_spatial_filters(filters: FilterSet, show: bool = True,
                         save_path: str | Path | None = None):
    """Topomap grid of the depthwise spatial filters (``ui.py:534-560``)."""
    spatial = filters.spatial
    fig, axes, n_cols = _grid_axes(
        spatial.shape[0], panel=(16, 4 * int(np.ceil(spatial.shape[0] / 4))))
    for i in range(spatial.shape[0]):
        ax = axes[i // n_cols][i % n_cols]
        plot_topomap(spatial[i], ax, channel_names=filters.channel_names)
        ax.set_title(f"Spatial Filter {i + 1}")
    fig.tight_layout()
    return _finish(fig, show, save_path)


def PS(time_signal: np.ndarray, f_sampling: float, method: str = "ps"):
    """Hand-rolled FFT power spectrum, signature-identical to ``ui.py:562-573``."""
    fft = np.fft.fft(time_signal)
    mag_squared = np.real(fft * np.conjugate(fft))
    f = np.fft.fftfreq(len(time_signal), 1 / f_sampling)
    if method == "psd":
        scaling_factor = 2 / (f_sampling * len(time_signal))
    else:
        scaling_factor = 2 / (len(time_signal) ** 2)
    return f, scaling_factor * mag_squared


def plot_power_spectra_of_temporal_filters(filters: FilterSet,
                                           show: bool = True,
                                           save_path: str | Path | None = None):
    """Per-filter power spectra (``ui.py:575-595``)."""
    temporal = filters.temporal
    fig, axes, n_cols = _grid_axes(temporal.shape[0])
    for i in range(temporal.shape[0]):
        ax = axes[i // n_cols][i % n_cols]
        f, ps = PS(temporal[i], f_sampling=filters.sfreq, method="ps")
        half = len(f) // 2 - 1
        ax.plot(f[:half], ps[:half], "ro-")
        ax.set_title(f"Temporal Filter {i + 1}")
        ax.set_xlabel("Frequency (Hz)")
        ax.set_ylabel("Power (dB)")
        ax.set_xticks(range(0, 51, 10))
    fig.tight_layout()
    return _finish(fig, show, save_path)


def _finish(fig, show: bool, save_path):
    if save_path is not None:
        fig.savefig(save_path, dpi=120)
        logger.info("Saved figure to %s", save_path)
    if show:
        import matplotlib.pyplot as plt

        plt.show()
    return fig
