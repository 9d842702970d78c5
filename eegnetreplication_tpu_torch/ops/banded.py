"""EEGNet's convolutions as banded matmuls, the ``conv_impl="banded"``
schedule.

The counterpart of ``eegnetreplication_tpu/ops/banded.py``.  A length-``K``
SAME convolution along time is a matmul with a banded ``(P, T)`` matrix
(``P = T + K - 1``, the padded input length).  The band is built by
contracting the taps with a constant one-hot expansion

    E[k, p, t] = 1  iff  p == t + k

so the forward and every gradient are matmuls, with no scatter:

    M    = einsum('kpt,kf->ptf',  E, w)        # band from the taps
    out  = x_pad @ M                           # the convolution
    dw   = einsum('kpt,ptf->kf',  E, dM)       # its weight gradient

Every op here takes the fold-stacked form the training loop runs: a
leading G axis (G weight sets on G batches) that is the batch axis of
``bmm``/``matmul``, the counterpart of the JAX package's fold ``vmap``; a
single model is G = 1.  Kernels come in the port's ``state_dict`` layouts
(NCHW, ``(out, in/groups, kh, kw)``) with the G axis in front, and
activations in the JAX ops' time-then-feature order.

Every op runs in its activation's dtype (bf16 under the ``"bf16"``
numerics mode): the expansion tensor is built in it, so a band holds the
taps exactly, as the JAX ops build theirs in the taps' dtype.

The band multiplies ~T/K times the MACs of the minimal convolution.  Past
:data:`BANDED_TILE_T` outputs the time axis is cut into tiles of
:data:`_TILE` outputs that share one ``(tile + K - 1, tile)`` band, so the
band's memory and the MAC inflation stay bounded for long recordings.
The expansion tensor is built once per ``(k, t, device, dtype)``.
"""

from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F

# The JAX package's tiling threshold and tile (``ops/banded.py``).
BANDED_TILE_T = 512
_TILE = 256


@functools.lru_cache(maxsize=64)
def _expansion(k: int, t: int, device: torch.device,
               dtype: torch.dtype) -> torch.Tensor:
    """The one-hot ``E[k, p, t] = (p == t + k)``, ``(k, t + k - 1, t)`` in
    ``dtype`` on ``device``."""
    p = t + k - 1
    kk = torch.arange(k)[:, None, None]
    pp = torch.arange(p)[None, :, None]
    tt = torch.arange(t)[None, None, :]
    return (pp == tt + kk).to(dtype).to(device)


def expansion(k: int, t: int, device,
              dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The cached expansion tensor of a width-``k`` SAME convolution with
    ``t`` outputs, in ``dtype`` on ``device``."""
    return _expansion(int(k), int(t), torch.device(device), dtype)


def same_pad_1d(x: torch.Tensor, k: int) -> torch.Tensor:
    """Zero-pad the last axis with XLA/torch SAME padding for width ``k``
    (``(k - 1) // 2`` left, ``k // 2`` right)."""
    return F.pad(x, ((k - 1) // 2, k // 2))


def _tile_windows(x_pad: torch.Tensor, k: int, t_out: int,
                  tile: int) -> torch.Tensor:
    """Overlapping output-tile windows ``(..., n_tiles, tile + k - 1)``:
    the outputs ``[i * tile, (i + 1) * tile)`` read ``x_pad[i * tile : i *
    tile + tile + k - 1]`` (zero past the end)."""
    n_tiles = math.ceil(t_out / tile)
    full = n_tiles * tile + k - 1
    xp = F.pad(x_pad, (0, full - x_pad.shape[-1]))
    return xp.unfold(-1, tile + k - 1, tile)


def conv1d_same_banded(x_pad: torch.Tensor, taps: torch.Tensor,
                       t_out: int) -> torch.Tensor:
    """Banded SAME convolution along the last axis of G stacked inputs.

    ``x_pad`` ``(G, ..., P)`` is already padded to ``P = t_out + K - 1``;
    ``taps`` ``(G, K, F)``.  Returns ``(G, ..., t_out, F)``.  Past
    :data:`BANDED_TILE_T` outputs it runs
    :func:`conv1d_same_banded_tiled`.
    """
    if t_out > BANDED_TILE_T:
        return conv1d_same_banded_tiled(x_pad, taps, t_out)
    g, k, f = taps.shape
    lead = x_pad.shape[1:-1]
    e = expansion(k, t_out, x_pad.device, taps.dtype)
    band = torch.einsum("kpt,gkf->gptf", e, taps)
    out = torch.bmm(x_pad.reshape(g, -1, x_pad.shape[-1]),
                    band.reshape(g, band.shape[1], t_out * f))
    return out.reshape(g, *lead, t_out, f)


def conv1d_same_banded_tiled(x_pad: torch.Tensor, taps: torch.Tensor,
                             t_out: int, tile: int = _TILE) -> torch.Tensor:
    """Tiled twin of :func:`conv1d_same_banded`: one ``(tile + K - 1,
    tile)`` band serves every tile, so memory is O(K tile^2) and the MAC
    inflation ~tile/K whatever ``t_out``."""
    g, k, f = taps.shape
    lead = x_pad.shape[1:-1]
    windows = _tile_windows(x_pad, k, t_out, tile)    # (G, ..., n, tile+k-1)
    n = windows.shape[-2]
    e = expansion(k, tile, x_pad.device, taps.dtype)
    band = torch.einsum("kpt,gkf->gptf", e, taps)     # (G, tile+k-1, tile, F)
    out = torch.bmm(windows.reshape(g, -1, windows.shape[-1]),
                    band.reshape(g, band.shape[1], tile * f))
    return out.reshape(g, *lead, n * tile, f)[..., :t_out, :]


def temporal_conv_banded(x: torch.Tensor, weight: torch.Tensor
                         ) -> torch.Tensor:
    """EEGNet's temporal convolution: ``x`` ``(G, B, C, T)`` and ``weight``
    ``(G, F1, 1, 1, K)`` -> ``(G, B, C, T, F1)``, one ``(B*C, P) @ (P,
    T*F1)`` matmul per set."""
    taps = weight[:, :, 0, 0, :].transpose(1, 2)       # (G, K, F1)
    return conv1d_same_banded(same_pad_1d(x, taps.shape[1]), taps,
                              x.shape[-1])


def spatial_conv_banded(x: torch.Tensor, weight: torch.Tensor
                        ) -> torch.Tensor:
    """EEGNet's depthwise spatial convolution: ``x`` ``(G, B, C, T, F1)``
    and ``weight`` ``(G, F2, 1, C, 1)`` (groups F1, output ``f2 = f1 * D +
    d``) -> ``(G, B, T, F2)``, a reduction over C batched over (set,
    feature)."""
    g, b, c, t, f1 = x.shape
    f2 = weight.shape[1]
    s = weight[:, :, 0, :, 0].reshape(g, f1, f2 // f1, c)   # (G, F1, D, C)
    h = torch.einsum("gbctf,gfdc->gbtfd", x, s)
    return h.reshape(g, b, t, f2)


def depthwise_conv_banded(x: torch.Tensor, weight: torch.Tensor
                          ) -> torch.Tensor:
    """EEGNet's separable depthwise convolution: ``x`` ``(G, B, T, F)`` and
    ``weight`` ``(G, F, 1, 1, K)`` (one filter per feature, SAME) -> ``(G,
    B, T, F)``, a banded matmul batched over (set, feature)."""
    g, b, t, f = x.shape
    taps = weight[:, :, 0, 0, :]                       # (G, F, K)
    k = taps.shape[-1]
    xp = same_pad_1d(x.permute(0, 3, 1, 2), k)         # (G, F, B, P)
    if t > BANDED_TILE_T:
        windows = _tile_windows(xp, k, t, _TILE)       # (G, F, B, n, W)
        n = windows.shape[-2]
        band = torch.einsum("kpt,gfk->gfpt",
                            expansion(k, _TILE, x.device, taps.dtype), taps)
        h = torch.matmul(windows.reshape(g, f, b * n, windows.shape[-1]),
                         band)                         # (G, F, B*n, tile)
        h = h.reshape(g, f, b, n * _TILE)[..., :t]
    else:
        band = torch.einsum("kpt,gfk->gfpt",
                            expansion(k, t, x.device, taps.dtype), taps)
        h = torch.matmul(xp, band)                     # (G, F, B, T)
    return h.permute(0, 2, 3, 1)


def pointwise_conv_banded(x: torch.Tensor, weight: torch.Tensor
                          ) -> torch.Tensor:
    """The pointwise ``(1, 1)`` convolution as the matmul it is: ``x``
    ``(G, B, T, F)`` and ``weight`` ``(G, O, F, 1, 1)`` -> ``(G, B, T,
    O)``."""
    g, b, t, f = x.shape
    w = weight[:, :, :, 0, 0].transpose(1, 2)          # (G, F, O)
    return torch.bmm(x.reshape(g, b * t, f), w).reshape(g, b, t, -1)


def avg_pool_width(x: torch.Tensor, window: int) -> torch.Tensor:
    """VALID non-overlapping pooling over the time axis of ``(..., T, F)``
    as a reshape-mean (the last ``T % window`` samples are dropped)."""
    t = x.shape[-2]
    t_out = t // window
    return x[..., :t_out * window, :].reshape(
        *x.shape[:-2], t_out, window, x.shape[-1]).mean(-2)
