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

The carry form, K2s, advances the same recurrences over one chunk of a
stream from a carried ``(m, v)`` and hands the carry back (the JAX
package's jitted ``lax.scan`` ``_stream_chunk`` in ``ops/ems.py``):

- :func:`ems_stream_reference` is its plain version, the per-sample loop
  of the sequential scan with the carry threaded in and out;
- :func:`ems_stream` dispatches the same way: a CPU tensor takes the
  plain version, a CUDA tensor launches K2s (``csrc/ems_stream.cu``) or
  raises.  The two equal each other bit for bit (each operation rounded on
  its own), and any chunking of a stream equals the one-shot call.
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
    # A contiguous copy: the same block reduces to the same bits whether it
    # is sliced from a whole recording or from a stream's seed buffer.
    block = x[..., :min(int(init_block_size), x.shape[-1])].contiguous()
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


# K2s's channels a block (``csrc/ems_stream.cu``: kChannels): one, so a
# session's channels run on as many SMs.
EMS_STREAM_CHANNELS = 1


def ems_stream_reference(x: torch.Tensor, mean0: torch.Tensor,
                         m: torch.Tensor, v: torch.Tensor,
                         factor_new: float = 1e-3,
                         eps: float = 1e-10) -> torch.Tensor:
    """Plain PyTorch EMS carry over a chunk ``x (C, n)``: one step per
    sample, each operation a separate PyTorch call (so each is rounded on
    its own, as K2s rounds them).  The square root is taken in float64 and
    rounded once to ``x``'s dtype: PyTorch's vectorized float32 ``sqrt`` on
    the CPU is not correctly rounded, K2s's ``__fsqrt_rn`` is.  ``mean0``
    is the seed mean; ``m`` and ``v`` hold the carry entering the chunk and
    are overwritten with the carry leaving it.  Returns ``out (C, n)``."""
    a, c = f32_coefficients(factor_new)
    z = x - mean0[:, None]
    means = torch.empty_like(z)
    variances = torch.empty_like(z)
    mm, vv = m.clone(), v.clone()
    for t in range(x.shape[-1]):
        z_t = z[:, t]
        mm = c * mm + a * z_t
        vv = c * vv + a * torch.square(z_t - mm)
        means[:, t] = mm
        variances[:, t] = vv
    m.copy_(mm)
    v.copy_(vv)
    scale = variances + eps
    return (z - means) / torch.sqrt(scale.double()).to(scale.dtype)


def _k2s_library() -> ctypes.CDLL:
    lib = build.load("ems_stream")
    if lib.eeg_ems_stream_launch.argtypes is None:
        lib.eeg_ems_stream_channels.argtypes = []
        lib.eeg_ems_stream_channels.restype = ctypes.c_int
        lib.eeg_ems_stream_error_string.argtypes = [ctypes.c_int]
        lib.eeg_ems_stream_error_string.restype = ctypes.c_char_p
        lib.eeg_ems_stream_launch.argtypes = (
            [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_longlong]
            + [ctypes.c_float] * 3 + [ctypes.c_void_p])
        lib.eeg_ems_stream_launch.restype = ctypes.c_int
    built = lib.eeg_ems_stream_channels()
    if built != EMS_STREAM_CHANNELS:
        raise RuntimeError(f"ems_stream: the built K2s takes {built} "
                           f"channels a block, the wrapper expects "
                           f"{EMS_STREAM_CHANNELS}")
    return lib


def ems_stream(x: torch.Tensor, mean0: torch.Tensor, m: torch.Tensor,
               v: torch.Tensor, factor_new: float = 1e-3,
               eps: float = 1e-10) -> torch.Tensor:
    """Advance the EMS carry ``(m, v)`` over the chunk ``x (C, n)`` and
    return the standardized ``out (C, n)``; ``m`` and ``v`` are updated in
    place.

    CPU tensors run :func:`ems_stream_reference`.  CUDA tensors must all be
    float32, contiguous and on one device, ``x`` 2-D and the others
    ``(C,)`` (``m`` and ``v`` distinct); K2s then runs on the current
    stream, one launch a call with ``n > 0`` (counted in
    ``ems_stream.launches``).  Anything else raises.
    """
    if x.dim() != 2:
        raise ValueError(f"ems_stream: x must be (C, n), got "
                         f"{tuple(x.shape)}")
    n_ch, n = x.shape
    for name, t in (("mean0", mean0), ("m", m), ("v", v)):
        if tuple(t.shape) != (n_ch,):
            raise ValueError(f"ems_stream: {name} must be ({n_ch},), got "
                             f"{tuple(t.shape)}")
        if t.device != x.device:
            raise ValueError(f"ems_stream: {name} is on {t.device}, x on "
                             f"{x.device}")
    if x.device.type == "cpu":
        return ems_stream_reference(x, mean0, m, v, factor_new, eps)
    if x.device.type != "cuda":
        raise ValueError(f"ems_stream: no kernel for device {x.device}")
    for name, t in (("x", x), ("mean0", mean0), ("m", m), ("v", v)):
        if t.dtype != torch.float32:
            raise TypeError(f"ems_stream: {name} must be float32, got "
                            f"{t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"ems_stream: {name} must be contiguous")
    if m.data_ptr() == v.data_ptr() and n_ch:
        raise ValueError("ems_stream: m and v must be distinct tensors")
    out = torch.empty_like(x)
    if n_ch == 0 or n == 0:
        return out
    lib = _k2s_library()
    a, c = f32_coefficients(factor_new)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.eeg_ems_stream_launch(
            x.data_ptr(), mean0.data_ptr(), m.data_ptr(), v.data_ptr(),
            out.data_ptr(), n_ch, n, a, c, float(eps), stream)
    if err != 0:
        raise RuntimeError(
            f"ems_stream: K2s launch failed with CUDA error {err} "
            f"({lib.eeg_ems_stream_error_string(err).decode()})")
    ems_stream.launches += 1
    return out


ems_stream.launches = 0
