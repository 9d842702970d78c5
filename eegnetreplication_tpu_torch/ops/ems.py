"""Exponential moving standardization (EMS) along time.

The counterpart of ``eegnetreplication_tpu/ops/ems.py``
(``exponential_moving_standardize`` and
``raw_exponential_moving_standardize``).  Per-channel EMAs of the mean and
the variance, seeded from the statistics of the first ``init_block_size``
samples (biased variance), with ``eps`` inside the square root:

    m_t = (1 - a) m_{t-1} + a x_t
    v_t = (1 - a) v_{t-1} + a (x_t - m_t)^2
    out_t = (x_t - m_t) / sqrt(v_t + eps)

Three numerically equivalent formulations, picked by ``method``, with the
JAX package's names and default:

- ``"associative"``: both recurrences as parallel prefix scans.  Torch has
  no public associative scan, so it is a doubling (Hillis-Steele) scan over
  time: pass ``k`` adds ``c^(2^k)`` times the value ``2^k`` samples back,
  ``ceil(log2 T)`` passes;
- ``"scan"``: the sequential recurrence, one step per sample;
- ``"pallas"``: the single-pass kernel, K2 on the card
  (:func:`~eegnetreplication_tpu_torch.ops.ems_kernel.ems`), its plain
  version on the CPU; ``(C, T)`` inputs only.

``StreamingEMS`` and ``ems_time_sharded`` are not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch

from eegnetreplication_tpu_torch.ops.ems_kernel import (
    ems,
    f32_coefficients,
    seed_stats,
)
from eegnetreplication_tpu_torch.utils.device import resolve_device

METHODS = ("associative", "scan", "pallas")


def _linear_recurrence_doubling(inputs: torch.Tensor, c: float,
                                init: torch.Tensor) -> torch.Tensor:
    """Solve ``s_t = c s_{t-1} + inputs_t`` along the last axis with
    ``s_{-1} = init`` by a doubling scan."""
    t_total = inputs.shape[-1]
    s = inputs
    shift = 1
    while shift < t_total:
        # c^shift in float64, rounded to the tensor's dtype by the multiply.
        s = torch.cat([s[..., :shift],
                       s[..., shift:] + c ** shift * s[..., :-shift]], dim=-1)
        shift *= 2
    steps = torch.arange(1, t_total + 1, dtype=torch.float64,
                         device=inputs.device)
    decay = (c ** steps).to(inputs.dtype)      # c^(t+1)
    return decay * init[..., None] + s


def exponential_moving_standardize(
    x: torch.Tensor,
    factor_new: float = 1e-3,
    init_block_size: int = 1000,
    eps: float = 1e-10,
    method: str = "associative",
) -> torch.Tensor:
    """Exponentially-moving standardize ``x (..., T)`` along its last axis.

    ``method`` is ``"associative"`` (the default), ``"scan"`` or
    ``"pallas"`` (K2; ``(C, T)`` only, computed in f32 and cast back).
    Returns a tensor of ``x``'s shape and dtype on ``x``'s device.
    """
    if method not in METHODS:
        raise ValueError(f"Unknown EMS method: {method!r}")
    if method == "pallas":
        if x.dim() != 2:
            raise ValueError(
                f"EMS method 'pallas' expects (C, T), got {tuple(x.shape)}")
        out = ems(x.to(torch.float32).contiguous(), factor_new=factor_new,
                  init_block_size=init_block_size, eps=eps)
        return out.to(x.dtype)

    t_total = x.shape[-1]
    a, c = f32_coefficients(factor_new)
    mean0, var0 = seed_stats(x, init_block_size)

    # The mean recurrence runs on the init-mean-centred signal: the same
    # affine recurrence, exact for constant inputs in f32.
    z = x - mean0[..., None]

    if method == "associative":
        means = _linear_recurrence_doubling(a * z, c, torch.zeros_like(mean0))
        dev = z - means
        variances = _linear_recurrence_doubling(a * torch.square(dev), c,
                                                var0)
    else:
        means = torch.empty_like(z)
        variances = torch.empty_like(z)
        m = torch.zeros_like(mean0)
        v = var0
        for t in range(t_total):
            z_t = z[..., t]
            m = c * m + a * z_t
            v = c * v + a * torch.square(z_t - m)
            means[..., t] = m
            variances[..., t] = v
        dev = z - means
    return dev / torch.sqrt(variances + eps)


def raw_exponential_moving_standardize(
    x: np.ndarray, factor_new: float = 0.001, init_block_size: int = 1000,
    method: str = "associative", *, device: torch.device | str | None = None,
) -> np.ndarray:
    """Numpy-in/numpy-out EMS with the reference's signature
    (``dataset.py:45-70``): computes in f32 on ``device`` (``None`` selects
    one through ``utils/device.py``) and casts back to ``x``'s dtype."""
    x = np.asarray(x)
    dev = resolve_device(device)
    xt = torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32)).to(dev)
    out = exponential_moving_standardize(
        xt, factor_new=float(factor_new), init_block_size=int(init_block_size),
        method=method)
    return out.cpu().numpy().astype(x.dtype, copy=False)
