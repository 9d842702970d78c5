"""Signal-processing ops of the preprocessing front-end, on ``torch.fft``.

The counterpart of ``eegnetreplication_tpu/ops/dsp.py``: FFT resampling
(spectrum truncation, the method behind MNE's ``raw.resample``) and a
zero-phase FIR bandpass by frequency-domain convolution.  On the card both
run through cuFFT, as the JAX package leaves them to XLA; neither is a
hand-written kernel (the JAX package has no Pallas kernel here).

The filter design is MNE's "auto" firwin design, computed on the host with
scipy and identical to the JAX package's:

- transition bandwidths ``l_trans = min(max(0.25*l, 2), l)``,
  ``h_trans = min(max(0.25*h, 2), nyq - h)``;
- a hamming-window design of length ``ceil(3.3 * sfreq / min(l_trans,
  h_trans))`` rounded up to odd (a zero-phase type-I FIR);
- gain 0 below ``l - l_trans``, 1 in ``[l, h]``, 0 above ``h + h_trans``.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F


def mne_style_bandpass_design(sfreq: float, l_freq: float,
                              h_freq: float) -> np.ndarray:
    """The bandpass FIR kernel, ``(n_taps,)`` float32 (host, scipy)."""
    from scipy.signal import firwin2

    nyq = sfreq / 2.0
    l_trans = min(max(0.25 * l_freq, 2.0), l_freq)
    h_trans = min(max(0.25 * h_freq, 2.0), nyq - h_freq)
    n_taps = int(math.ceil(3.3 * sfreq / min(l_trans, h_trans)))
    n_taps += 1 - n_taps % 2  # odd length -> symmetric, zero-phase capable

    freq = [0.0, l_freq - l_trans, l_freq, h_freq, h_freq + h_trans, nyq]
    gain = [0.0, 0.0, 1.0, 1.0, 0.0, 0.0]
    return firwin2(n_taps, freq, gain, fs=sfreq, window="hamming").astype(
        np.float32)


def resample_fft(x: torch.Tensor, num: int) -> torch.Tensor:
    """FFT resampling of ``x (..., T)`` to ``num`` samples.

    Keeps the lowest ``num // 2 + 1`` frequency bins (or zero-pads up to
    them) and scales by ``num / T``, with scipy's handling of the unpaired
    Nyquist bin of an even length.
    """
    t = x.shape[-1]
    spectrum = torch.fft.rfft(x, dim=-1)
    n_keep = num // 2 + 1
    if n_keep <= spectrum.shape[-1]:
        spectrum = spectrum[..., :n_keep].clone()
        # A real even-length target has an unpaired Nyquist bin: fold the
        # discarded conjugate half's energy (2x the real part) into it.
        if num % 2 == 0 and num < t:
            spectrum[..., -1] = 2.0 * spectrum[..., -1].real
    else:
        # Upsampling an even-length source: split its Nyquist bin's energy
        # before zero-padding.
        if t % 2 == 0:
            spectrum[..., -1] = 0.5 * spectrum[..., -1]
        spectrum = F.pad(spectrum, (0, n_keep - spectrum.shape[-1]))
    return torch.fft.irfft(spectrum, n=num, dim=-1) * (num / t)


def _fir_zero_phase(x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """Zero-phase FIR of ``x (..., T)`` with an odd symmetric ``kernel``:
    reflect-pad by half the kernel on both sides (MNE's edge handling),
    convolve through the FFT at the next power of two, and keep the centre
    so the linear-phase delay cancels."""
    n_taps = kernel.shape[0]
    half = n_taps // 2
    t = x.shape[-1]
    if half >= t:
        raise ValueError(
            f"fir_bandpass: a {n_taps}-tap filter reflects {half} samples "
            f"at each edge, which needs more than {half} samples; got {t}")
    lead = x.shape[:-1]
    xp = F.pad(x.reshape(-1, 1, t), (half, half), mode="reflect")
    xp = xp.reshape(*lead, t + 2 * half)
    n = xp.shape[-1] + n_taps - 1
    nfft = 1 << max(1, n - 1).bit_length()  # next power of two
    spec = torch.fft.rfft(xp, n=nfft, dim=-1) * torch.fft.rfft(kernel,
                                                               n=nfft)
    full = torch.fft.irfft(spec, n=nfft, dim=-1)[..., :n]
    return full[..., n_taps - 1: n_taps - 1 + t]


def fir_bandpass(x: torch.Tensor, sfreq: float, l_freq: float = 4.0,
                 h_freq: float = 38.0,
                 kernel: np.ndarray | None = None) -> torch.Tensor:
    """Zero-phase bandpass of ``x (..., T)`` with the MNE-style design."""
    if kernel is None:
        kernel = mne_style_bandpass_design(sfreq, l_freq, h_freq)
    return _fir_zero_phase(
        x, torch.as_tensor(kernel, dtype=x.dtype, device=x.device))
