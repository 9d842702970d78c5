"""The port's DSP ops (``eegnetreplication_tpu_torch/ops/dsp.py``) against
the JAX package's (``eegnetreplication_tpu/ops/dsp.py``) on the CPU.

Both filter designs are the same scipy call, so they must be equal.  The
FFT ops run in f32 in both packages with other FFT libraries, so they are
held to atol 1e-5 on unit-variance inputs.
"""

import numpy as np
import pytest
import torch
import torch_port_cases  # noqa: F401 (caps torch's threads)

from eegnetreplication_tpu.ops import dsp as jax_dsp
from eegnetreplication_tpu_torch.ops import dsp

ATOL = 1e-5


def _x(shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


@pytest.mark.parametrize("sfreq, l_freq, h_freq",
                         [(128.0, 4.0, 38.0), (250.0, 4.0, 38.0),
                          (128.0, 8.0, 30.0)])
def test_bandpass_design_equals_jax(sfreq, l_freq, h_freq):
    got = dsp.mne_style_bandpass_design(sfreq, l_freq, h_freq)
    want = jax_dsp.mne_style_bandpass_design(sfreq, l_freq, h_freq)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("num", [512, 513, 2000, 2001])
def test_resample_fft_matches_jax(num):
    x = _x((3, 1000))
    got = dsp.resample_fft(torch.from_numpy(x), num).numpy()
    want = np.asarray(jax_dsp.resample_fft(x, num))
    assert got.shape == (3, num) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("num", [999, 1001])
def test_resample_fft_odd_source_matches_jax(num):
    x = _x((2, 999), seed=1)
    got = dsp.resample_fft(torch.from_numpy(x), num).numpy()
    want = np.asarray(jax_dsp.resample_fft(x, num))
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_fir_bandpass_matches_jax():
    x = _x((3, 1024), seed=2)
    got = dsp.fir_bandpass(torch.from_numpy(x), 128.0).numpy()
    want = np.asarray(jax_dsp.fir_bandpass(x, 128.0))
    assert got.shape == x.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_fir_bandpass_takes_a_precomputed_kernel_and_leading_dims():
    x = _x((2, 3, 600), seed=3)
    kernel = dsp.mne_style_bandpass_design(128.0, 4.0, 38.0)
    got = dsp.fir_bandpass(torch.from_numpy(x), 128.0, kernel=kernel)
    want = np.asarray(jax_dsp.fir_bandpass(x, 128.0, kernel=kernel))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)


def test_fir_bandpass_refuses_a_signal_shorter_than_its_reflection():
    """The 213-tap filter reflects 106 samples at each edge."""
    with pytest.raises(ValueError, match="reflects 106 samples"):
        dsp.fir_bandpass(torch.zeros(2, 100), 128.0)
