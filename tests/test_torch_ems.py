"""The port's EMS (``ops/ems.py``, ``ops/ems_kernel.py``) against the JAX
package's on the CPU.

Every port method (``associative``, ``scan``, ``pallas``, which on the CPU
is the kernel's plain version) and ``ems_reference`` itself are held
against the JAX ``exponential_moving_standardize(method="scan")`` and the
Pallas kernel in interpret mode (``ems_pallas(..., interpret=True)``) at
rtol/atol 1e-4, the JAX package's own Pallas-vs-scan tolerance, on the
inputs of ``tests/test_ems.py``; and against the float64 loop at 2e-3.
"""

import functools

import jax
import numpy as np
import pytest
import torch

from eegnetreplication_tpu.ops.ems import (
    exponential_moving_standardize as jax_ems,
    raw_exponential_moving_standardize as jax_raw_ems,
)
from eegnetreplication_tpu.ops.ems_pallas import ems_pallas
from eegnetreplication_tpu_torch.ops import build, ems_kernel
from eegnetreplication_tpu_torch.ops.ems import (
    exponential_moving_standardize,
    raw_exponential_moving_standardize,
)
from torch_port_cases import EMS_CASES, ems_input, numpy_ems_reference

TOL = 1e-4
LOOP_TOL = 2e-3
PORT_METHODS = ("associative", "scan", "pallas", "ems_reference")


def _port(x: np.ndarray, method: str, **kw) -> np.ndarray:
    xt = torch.from_numpy(x)
    if method == "ems_reference":
        return ems_kernel.ems_reference(xt, **kw).numpy()
    return exponential_moving_standardize(xt, method=method, **kw).numpy()


# Jitted once per shape: one compile instead of one per eager op.  The
# Pallas call stays eager: its host constants are cached per block length,
# and a trace would cache traced values there.
_jax_scan = jax.jit(functools.partial(jax_ems, method="scan"),
                    static_argnames=("factor_new", "init_block_size"))


@functools.lru_cache(maxsize=None)
def _jax_reference(case: str, which: str) -> np.ndarray:
    x, kw = ems_input(case)
    if which == "scan":
        return np.asarray(_jax_scan(x, **kw))
    return np.asarray(ems_pallas(x, interpret=True, **kw))


@pytest.mark.parametrize("jax_which", ["scan", "pallas_interpret"])
@pytest.mark.parametrize("method", PORT_METHODS)
@pytest.mark.parametrize("case", sorted(EMS_CASES))
def test_port_matches_jax(case, method, jax_which):
    x, kw = ems_input(case)
    got = _port(x, method, **kw)
    want = _jax_reference(case, jax_which)
    assert got.shape == x.shape and got.dtype == np.float32
    assert np.all(np.isfinite(got))
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("method", PORT_METHODS)
@pytest.mark.parametrize("case", ["signal_4x3000", "ragged_3x700",
                                  "single_1x500_init100",
                                  "short_2x50_init_past_T"])
def test_port_matches_float64_loop(case, method):
    x, kw = ems_input(case)
    got = _port(x, method, **kw)
    want = numpy_ems_reference(x, **kw)
    np.testing.assert_allclose(got, want, rtol=LOOP_TOL, atol=LOOP_TOL)


@pytest.mark.parametrize("method", PORT_METHODS)
def test_constant_signal_is_finite_and_zero(method):
    x, kw = ems_input("constant_3x400")
    got = _port(x, method, **kw)
    assert np.all(np.isfinite(got))
    np.testing.assert_allclose(got, 0.0, atol=1e-3)


@pytest.mark.parametrize("method", PORT_METHODS)
def test_factor_new_0_1_matches_jax_scan(method):
    x, _ = ems_input("signal_4x3000")
    got = _port(x, method, factor_new=0.1)
    want = np.asarray(_jax_scan(x, factor_new=0.1))
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_seed_variance_is_biased():
    x, _ = ems_input("signal_4x3000")
    mean0, var0 = ems_kernel.seed_stats(torch.from_numpy(x), 10)
    np.testing.assert_allclose(mean0.numpy(), x[:, :10].mean(-1), rtol=1e-6)
    np.testing.assert_allclose(var0.numpy(), x[:, :10].var(-1, ddof=0),
                               rtol=1e-5)
    assert not np.allclose(var0.numpy(), x[:, :10].var(-1, ddof=1),
                           rtol=1e-3)


@pytest.mark.parametrize("method", PORT_METHODS)
def test_short_init_block_uses_the_biased_variance(method):
    """With a 10-sample seed block the unbiased variance is 11% larger,
    which moves the early outputs far past the tolerance."""
    x, _ = ems_input("signal_4x3000")
    got = _port(x[:, :400], method, init_block_size=10)
    want = numpy_ems_reference(x[:, :400], init_block_size=10)
    np.testing.assert_allclose(got, want, rtol=LOOP_TOL, atol=LOOP_TOL)


def test_unknown_method_raises():
    with pytest.raises(ValueError, match="Unknown EMS method"):
        exponential_moving_standardize(torch.zeros(2, 10), method="bogus")


def test_pallas_method_takes_only_channels_by_time():
    with pytest.raises(ValueError, match=r"expects \(C, T\)"):
        exponential_moving_standardize(torch.zeros(2, 3, 10),
                                       method="pallas")


@pytest.mark.parametrize("method", ["associative", "scan"])
def test_leading_dims_match_jax(method):
    x = np.random.RandomState(4).randn(2, 3, 300).astype(np.float32)
    got = exponential_moving_standardize(torch.from_numpy(x), method=method,
                                         init_block_size=50).numpy()
    want = np.asarray(_jax_scan(x, init_block_size=50))
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_cpu_ems_never_touches_the_builder(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("ops/build.py was called for a CPU tensor")

    monkeypatch.setattr(build, "load", refuse)
    monkeypatch.setattr(build, "build", refuse)
    monkeypatch.setattr(build, "nvcc_path", refuse)
    x, kw = ems_input("ragged_3x700")
    before = ems_kernel.ems.launches
    got = ems_kernel.ems(torch.from_numpy(x), **kw)
    via_method = exponential_moving_standardize(torch.from_numpy(x),
                                                method="pallas", **kw)
    assert ems_kernel.ems.launches == before
    want = ems_kernel.ems_reference(torch.from_numpy(x), **kw)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    torch.testing.assert_close(via_method, want, rtol=0, atol=0)


def test_ems_has_no_kernel_for_other_devices():
    with pytest.raises(ValueError, match="no kernel for device meta"):
        ems_kernel.ems(torch.empty(2, 10, device="meta"))


@pytest.mark.parametrize("method", ["associative", "pallas"])
def test_raw_ems_keeps_numpy_dtype_and_matches_jax(method):
    x = np.random.RandomState(6).randn(3, 1500)          # float64
    got = raw_exponential_moving_standardize(x, method=method, device="cpu")
    want = jax_raw_ems(x, method="scan")
    assert isinstance(got, np.ndarray) and got.dtype == np.float64
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
