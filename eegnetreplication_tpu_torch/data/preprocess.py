"""Raw-recording preprocessing: GDF -> standardized 22-channel 128 Hz arrays.

The counterpart of ``eegnetreplication_tpu/data/preprocess.py``, with the
same stages, the same ``-preprocessed.npz`` bundle and the same keys:

1. keep the first 22 channels, the EEG block of the BCI-IV-2a layout (the
   trailing 3 are EOG);
2. zero out non-finite samples (the competition GDFs mark artifact spans
   with NaN);
3. FFT resample to 128 Hz;
4. zero-phase 4-38 Hz FIR bandpass, MNE-style design;
5. exponential moving standardization, by the method ``EEGTPU_EMS_METHOD``
   names (``associative``, the default; ``scan``; or ``pallas``, which on
   the card is the CUDA kernel K2).

Stages 3-5 run as torch ops on the device (cuFFT on the card); the result
comes back to the host as float32.  Event positions are rescaled to the new
rate with numpy's ``round``, like MNE does on resample.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

from eegnetreplication_tpu_torch.config import (
    BANDPASS_HIGH_HZ,
    BANDPASS_LOW_HZ,
    EEG_CHANNEL_NAMES,
    N_EEG_CHANNELS,
    TARGET_SFREQ,
)
from eegnetreplication_tpu_torch.data.gdf import GDFRecording, read_gdf
from eegnetreplication_tpu_torch.ops.dsp import (
    fir_bandpass,
    mne_style_bandpass_design,
    resample_fft,
)
from eegnetreplication_tpu_torch.ops.ems import exponential_moving_standardize
from eegnetreplication_tpu_torch.utils.device import resolve_device
from eegnetreplication_tpu_torch.utils.logging import logger

EMS_METHOD_ENV = "EEGTPU_EMS_METHOD"


@dataclass
class ProcessedRecording:
    """A preprocessed continuous recording plus its (resampled) events."""

    data: np.ndarray        # (22, T') float32, standardized, 128 Hz
    sfreq: float
    labels: list[str]
    event_pos: np.ndarray   # (n_events,) int64, samples at the NEW rate
    event_typ: np.ndarray   # (n_events,) int64 GDF event codes

    def save(self, path: str | Path) -> Path:
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        np.savez_compressed(path, data=self.data.astype(np.float32),
                            sfreq=np.float64(self.sfreq),
                            labels=np.array(self.labels),
                            event_pos=self.event_pos.astype(np.int64),
                            event_typ=self.event_typ.astype(np.int64))
        return path

    @staticmethod
    def load(path: str | Path) -> "ProcessedRecording":
        with np.load(Path(path)) as z:
            return ProcessedRecording(
                data=z["data"], sfreq=float(z["sfreq"]),
                labels=[str(s) for s in z["labels"]],
                event_pos=z["event_pos"], event_typ=z["event_typ"],
            )


def preprocess_recording(rec: GDFRecording,
                         target_sfreq: float = TARGET_SFREQ,
                         l_freq: float = BANDPASS_LOW_HZ,
                         h_freq: float = BANDPASS_HIGH_HZ,
                         ems_factor_new: float = 1e-3,
                         ems_init_block_size: int = 1000, *,
                         device: torch.device | str | None = None,
                         ) -> ProcessedRecording:
    """Run the preprocessing chain on one recording, on ``device``
    (``None`` selects one through ``utils/device.py``)."""
    dev = resolve_device(device)
    x = rec.signals[:N_EEG_CHANNELS]
    n_bad = int(np.sum(~np.isfinite(x)))
    if n_bad:
        logger.info("Zeroing %d non-finite samples (%.3f%%)", n_bad,
                    100.0 * n_bad / x.size)
        x = np.where(np.isfinite(x), x, 0.0).astype(np.float32)

    num = int(round(x.shape[1] * target_sfreq / rec.sfreq))
    kernel = mne_style_bandpass_design(target_sfreq, l_freq, h_freq)

    xt = torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32)).to(dev)
    xt = resample_fft(xt, num)
    xt = fir_bandpass(xt, target_sfreq, l_freq, h_freq, kernel=kernel)
    xt = exponential_moving_standardize(
        xt, factor_new=ems_factor_new, init_block_size=ems_init_block_size,
        method=os.environ.get(EMS_METHOD_ENV, "associative"))
    out = xt.cpu().numpy().astype(np.float32, copy=False)

    scale = target_sfreq / rec.sfreq
    new_pos = np.round(rec.event_pos * scale).astype(np.int64)
    return ProcessedRecording(
        data=out, sfreq=float(target_sfreq),
        labels=list(EEG_CHANNEL_NAMES)[:N_EEG_CHANNELS],
        event_pos=new_pos, event_typ=rec.event_typ.astype(np.int64),
    )


def preprocess_raw_data(src_path: str | Path, dest_path: str | Path, *,
                        device: torch.device | str | None = None,
                        ) -> list[Path]:
    """Preprocess every ``.gdf`` under ``src_path`` into ``dest_path`` as
    ``<stem>-preprocessed.npz``; returns the paths written."""
    src_path, dest_path = Path(src_path), Path(dest_path)
    dev = resolve_device(device)
    logger.info("Preprocessing raw data from %s to %s on %s", src_path,
                dest_path, dev)
    written = []
    for file in sorted(src_path.glob("*.gdf")):
        processed = preprocess_recording(read_gdf(file), device=dev)
        out_file = dest_path / (file.stem + "-preprocessed.npz")
        processed.save(out_file)
        logger.info("Saved preprocessed file to %s", out_file)
        written.append(out_file)
    return written
