"""Exponential moving standardization in one pass: the CUDA kernel K2 and its
plain twin.

The counterpart of ``eegnetreplication_tpu/ops/ems_pallas.py``.  Per
channel of a ``(C, T)`` recording, with ``a = factor_new``, ``c = 1 - a``
and the seed statistics of the first ``min(init_block_size, T)`` samples
(``mean0``, biased ``var0``):

    z_t = x_t - mean0
    m_t = c m_{t-1} + a z_t               (m_{-1} = 0)
    v_t = c v_{t-1} + a (z_t - m_t)^2     (v_{-1} = var0)
    out_t = (z_t - m_t) / sqrt(v_t + eps)

- :func:`ems_reference` is the plain PyTorch version: what the Pallas
  kernel's body computes, time block by time block, each block's recurrence
  a triangular product ``U[j, t] = c^(t-j)`` with the carry threaded across
  blocks.  The CPU path takes it, and the kernel is held against it on the
  card; nothing on the card's main path calls it.
- :func:`ems` dispatches: a CPU tensor takes :func:`ems_reference`, a CUDA
  tensor launches K2 (``csrc/ems.cu``) or raises; there is no fallback.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from eegnetreplication_tpu_torch.ops import build

# The Pallas kernel's time block, kept by the plain version.
REFERENCE_BLOCK_T = 512

# K2's tiling (``csrc/ems.cu``: kThreads, kItems, kTile): one block per tile
# of EMS_TILE samples of one channel, EMS_ITEMS consecutive samples a
# thread.  The wrapper checks them against the built library.
EMS_THREADS = 256
EMS_ITEMS = 16
EMS_TILE = EMS_THREADS * EMS_ITEMS


def f32_coefficients(factor_new: float) -> tuple[float, float]:
    """``(a, c)`` rounded to f32 the way the JAX package does:
    ``c = f32(1.0 - factor_new)`` computed in float64 first."""
    return (float(np.float32(factor_new)),
            float(np.float32(1.0 - float(factor_new))))


def seed_stats(x: torch.Tensor, init_block_size: int):
    """``(mean0, var0)``, each ``x.shape[:-1]``: the mean and the biased
    variance of the first ``min(init_block_size, T)`` samples of
    ``x (..., T)``."""
    block = x[..., :min(int(init_block_size), x.shape[-1])]
    return (torch.mean(block, dim=-1),
            torch.var(block, dim=-1, correction=0))


def ems_reference(x: torch.Tensor, factor_new: float = 1e-3,
                  init_block_size: int = 1000,
                  eps: float = 1e-10) -> torch.Tensor:
    """Plain PyTorch EMS of ``x (C, T)`` f32, time-blocked like
    ``_ems_kernel``: within a block of ``L`` samples, ``s = carry * c^(t+1)
    + (a b) @ U`` with ``U[j, t] = c^(t-j)`` for ``j <= t`` (host float64,
    cast to f32 once).  A ragged last block uses the leading corner of
    ``U``, which is what zero padding would give (the product is causal).
    Run it with TF32 off (``utils/device.py`` pins that)."""
    if x.dim() != 2:
        raise ValueError(f"ems_reference expects (C, T), got {tuple(x.shape)}")
    a, _ = f32_coefficients(factor_new)
    c64 = 1.0 - float(factor_new)
    block_t = REFERENCE_BLOCK_T
    j = np.arange(block_t)[:, None]
    t = np.arange(block_t)[None, :]
    u = torch.from_numpy(np.where(j <= t, c64 ** (t - j), 0.0)
                         .astype(np.float32)).to(x.device)
    pw = torch.from_numpy((c64 ** (np.arange(block_t) + 1.0))
                          .astype(np.float32)).to(x.device)

    mean0, var0 = seed_stats(x, init_block_size)
    z = x - mean0[:, None]
    out = torch.empty_like(x)
    carry_m = torch.zeros_like(mean0)
    carry_v = var0
    for start in range(0, x.shape[-1], block_t):
        zb = z[:, start:start + block_t]
        n = zb.shape[-1]
        ub, pwb = u[:n, :n], pw[:n]
        m = carry_m[:, None] * pwb + (a * zb) @ ub
        dev = zb - m
        v = carry_v[:, None] * pwb + (a * torch.square(dev)) @ ub
        out[:, start:start + n] = dev / torch.sqrt(v + eps)
        carry_m, carry_v = m[:, -1], v[:, -1]
    return out


def _k2_library() -> ctypes.CDLL:
    lib = build.load("ems")
    if lib.eeg_ems_launch.argtypes is None:
        for fn in (lib.eeg_ems_tile, lib.eeg_ems_items):
            fn.argtypes = []
            fn.restype = ctypes.c_int
        lib.eeg_ems_error_string.argtypes = [ctypes.c_int]
        lib.eeg_ems_error_string.restype = ctypes.c_char_p
        lib.eeg_ems_launch.argtypes = (
            [ctypes.c_void_p] * 6 + [ctypes.c_int] * 2
            + [ctypes.c_float] * 3 + [ctypes.c_void_p])
        lib.eeg_ems_launch.restype = ctypes.c_int
    built = (lib.eeg_ems_tile(), lib.eeg_ems_items())
    if built != (EMS_TILE, EMS_ITEMS):
        raise RuntimeError(f"ems: the built K2 tiles {built} samples, the "
                           f"wrapper expects {(EMS_TILE, EMS_ITEMS)}")
    return lib


def n_tiles(t_total: int) -> int:
    """K2's tiles per channel, and so its blocks per channel."""
    return -(-int(t_total) // EMS_TILE)


@functools.lru_cache(maxsize=8)
def _powers(c: float, tiles: int, device: torch.device) -> torch.Tensor:
    """K2's coefficients: ``c^n`` in float64 from the f32 ``c``, cast to
    f32 once, for ``n = EMS_ITEMS * i`` (``i = 0..EMS_THREADS``, the spans
    inside a tile) and then ``n = EMS_TILE * j`` (``j = 0..tiles-1``, whole
    tiles); cached per (c, tiles, device)."""
    n = np.concatenate([EMS_ITEMS * np.arange(EMS_THREADS + 1),
                        EMS_TILE * np.arange(tiles)]).astype(np.float64)
    host = (c ** n).astype(np.float32)
    return torch.from_numpy(host).to(device)


def ems(x: torch.Tensor, factor_new: float = 1e-3,
        init_block_size: int = 1000, eps: float = 1e-10) -> torch.Tensor:
    """Single-pass EMS of ``x (C, T)`` f32 along time.

    A CPU ``x`` runs :func:`ems_reference`.  A CUDA ``x`` must be float32,
    2-D and contiguous; the seed statistics are computed on the device, a
    zeroed status buffer is allocated, and K2 runs on the current stream
    (one launch per call, counted in ``ems.launches``; the same input gives
    the same bits every time).  Anything else raises.
    """
    if x.device.type == "cpu":
        return ems_reference(x, factor_new, init_block_size, eps)
    if x.device.type != "cuda":
        raise ValueError(f"ems: no kernel for device {x.device}")
    if x.dtype != torch.float32:
        raise TypeError(f"ems: x must be float32, got {x.dtype}")
    if x.dim() != 2:
        raise ValueError(f"ems: x must be (C, T), got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError("ems: x must be contiguous")
    n_ch, t_total = x.shape
    tiles = n_tiles(t_total)
    if t_total >= 2 ** 31 or n_ch * tiles >= 2 ** 31:
        raise ValueError(f"ems: (C, T) = {tuple(x.shape)} does not fit the "
                         "kernel's int")
    out = torch.empty_like(x)
    if n_ch == 0 or t_total == 0:
        return out
    lib = _k2_library()
    a, c = f32_coefficients(factor_new)
    mean0, var0 = seed_stats(x, init_block_size)
    powers = _powers(c, tiles, x.device)
    # The ticket counter and every tile's two published aggregates, zeroed
    # for this launch.
    status = torch.zeros(1 + 2 * n_ch * tiles, dtype=torch.int64,
                         device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.eeg_ems_launch(
            x.data_ptr(), mean0.data_ptr(), var0.data_ptr(),
            powers.data_ptr(), status.data_ptr(), out.data_ptr(), n_ch,
            t_total, a, c, float(eps), stream)
    if err != 0:
        raise RuntimeError(
            f"ems: K2 launch failed with CUDA error {err} "
            f"({lib.eeg_ems_error_string(err).decode()})")
    ems.launches += 1
    return out


ems.launches = 0
