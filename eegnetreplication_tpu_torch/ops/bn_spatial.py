"""EEGNet's first training BatchNorm and spatial convolution as one op: the
CUDA kernels of ``csrc/bn_spatial.cu`` and their plain twin.

Replaces no Pallas kernel: the JAX package leaves this chain of its banded
training forward to XLA's fusion.  It is here because the card's trace
showed the time: as PyTorch ops on permuted views (``models/norm.py``'s
``batch_norm_train`` in flax mode, then ``ops/banded.py``'s
``spatial_conv_banded``), autograd makes some thirty strided passes a train
step over the temporal convolution's output ``h`` ``(G, B, C, T, F1)``,
1.04 GB at 90 folds.  The op computes, per fold ``g`` and feature ``f1``
(``N = B * C * T``),

    m = mean(h),  v = max(mean(h^2) - m^2, 0),  inv = scale / sqrt(v + eps)
    out[g, b, t, f1 * D + d] = sum_c s[g, f1, d, c] * ((h - m) * inv + bias)

with the running statistics moved ``momentum`` of the way, exactly what
the composition computes, and its gradients with respect to ``h``,
``scale``, ``bias`` and the spatial taps ``s`` as autograd differentiates
the composition (through ``m`` and through ``v = m2 - m^2``, the clamp's
gradient zero where ``m2 - m^2 < 0``):

    dy = sum_d s[f1, d, c] * dout[t, f1 * D + d]
    dh = dy * inv + c0 + c1 * (h - m),   c0 = -inv * sum(dy) / N,
    c1 = 2 * dv / N,   dv = -sum(dy * (h - m)) * scale / (2 (v + eps)^1.5)

- :func:`bn_spatial_train` dispatches: a CPU ``h`` runs the plain twin
  (:func:`stats_reference`, :func:`forward_reference`,
  :func:`backward_reference`, the kernels' own arithmetic: sums in f64),
  a CUDA ``h`` the kernels (two launches of passes over ``h`` and a
  combine each way, six a train step), or raises; there is no fallback.
- :func:`supported` is the geometry the kernels take (F1 divides 32,
  D in 1, 2, 4, the taps and a dout tile in a block's shared memory).
- ``bn_spatial_train.launches`` counts kernel launches on the card (three
  a forward, three a backward; ``.captured`` inside a graph capture), and
  the layer counter ``bn_spatial.forwards`` (``obs/trace.py::count``) each
  forward that ran them.

What bounds it is bytes (~3 FLOP a byte of ``h``): forward two reads of
``h``, backward two reads and one write, ~5.5 GB and ~1.64 ms at 90 folds
on an H100 (``csrc/bn_spatial.cu`` has the design).  The saved tensors
are ``h`` and the ``(G, F1)`` statistics; the normalised activation is
never written.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from eegnetreplication_tpu_torch.ops import build
from eegnetreplication_tpu_torch.ops.fused_eegnet import count_launch

# csrc/bn_spatial.cu: kThreads; kTileFloats (checked against the built
# library); a block's 48 KB of shared memory less pass C's 4 KB of static
# reductions, in floats.
THREADS = 256
TILE_FLOATS = 8192
SMEM_FLOATS = 11264
# Pass A's blocks in all: about eight resident on each of an H100's 132 SMs.
TARGET_BLOCKS = 1056
DEPTHS = (1, 2, 4)


def supported(c: int, f1: int, d: int) -> bool:
    """Whether the kernels take ``C`` channels, ``F1`` features and depth
    ``D``: F1 divides 32, D is 1, 2 or 4, and pass C's shared memory holds
    the taps and at least one warp's step of dout."""
    return (c >= 1 and 1 <= f1 <= 32 and 32 % f1 == 0 and d in DEPTHS
            and c * f1 * d + 128 * d <= SMEM_FLOATS)


@dataclass(frozen=True)
class Plan:
    """A launch's sizes: ``vec`` floats a load (4, or 1 where rows are not
    16-byte aligned), ``per_fold`` pass-A blocks a fold, and pass C's row
    ``tile`` (a multiple of ``32 * vec`` floats of h, as few tiles a row
    as shared memory allows, evenly long) and its count."""

    vec: int
    per_fold: int
    tile: int
    n_tiles: int


def plan(g: int, b: int, c: int, t: int, f1: int, d: int, pitch: int,
         aligned: bool) -> Plan:
    """The :class:`Plan` of ``h`` ``(G, B, C, T, F1)`` with rows ``pitch``
    floats apart (``aligned``: its first float is 16-byte aligned)."""
    row = t * f1
    vec = 4 if aligned and row % 4 == 0 and pitch % 4 == 0 else 1
    per_fold = max(1, min(-(-b * c // (THREADS // 32)),
                          -(-TARGET_BLOCKS // g)))
    step = 32 * vec
    cap = min(TILE_FLOATS, SMEM_FLOATS - c * f1 * d) // d // step * step
    if cap < step:
        raise ValueError(f"bn_spatial: C={c}, F1={f1}, D={d} leave no room "
                         "for a dout tile in shared memory")
    n_tiles = -(-row // cap)
    tile = -(-(-(-row // n_tiles)) // step) * step
    return Plan(vec, per_fold, tile, -(-row // tile))


def _per_feature(v: torch.Tensor) -> torch.Tensor:
    """``(G, F1)`` -> ``(G, 1, 1, 1, F1)`` against ``h``."""
    return v[:, None, None, None, :]


def stats_reference(h: torch.Tensor, scale: torch.Tensor, mean: torch.Tensor,
                    var: torch.Tensor, momentum: float, eps: float
                    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Passes A and A' in plain PyTorch: ``stat`` ``(G, F1, 4)`` (the batch
    mean, ``inv``, ``1 / sqrt(v + eps)``, 1 where ``m2 - m^2 >= 0``) and the
    new running mean and variance.  Sums and the statistics in f64, as the
    kernels take them."""
    n = h.shape[1] * h.shape[2] * h.shape[3]
    hd = h.double()
    m = hd.sum((1, 2, 3)) / n
    raw = (hd * hd).sum((1, 2, 3)) / n - m * m
    v = raw.clamp(min=0.0)
    r = 1.0 / torch.sqrt(v + eps)
    stat = torch.stack([m, r * scale.double(), r, (raw >= 0).double()],
                       -1).float()
    new_mean = momentum * mean + (1.0 - momentum) * m.float()
    new_var = momentum * var + (1.0 - momentum) * v.float()
    return stat, new_mean, new_var


def forward_reference(h: torch.Tensor, s: torch.Tensor, stat: torch.Tensor,
                      bias: torch.Tensor) -> torch.Tensor:
    """Pass B in plain PyTorch: ``out`` ``(G, B, T, F1 * D)`` from ``h``, the
    taps ``s`` ``(G, F1, D, C)`` and pass A's ``stat``."""
    g, b, _, t, f1 = h.shape
    y = (h - _per_feature(stat[..., 0])) * _per_feature(stat[..., 1]) \
        + _per_feature(bias)
    return torch.einsum("gbctf,gfdc->gbtfd", y, s).reshape(g, b, t, -1)


def backward_reference(h: torch.Tensor, dout: torch.Tensor, s: torch.Tensor,
                       stat: torch.Tensor, scale: torch.Tensor,
                       bias: torch.Tensor):
    """Passes C, C' and D in plain PyTorch: ``(dh, dscale, dbias, ds)``
    from the output's gradient ``dout`` ``(G, B, T, F1 * D)``, the
    hand-derived gradient of the composition (module docstring)."""
    g, b, c, t, f1 = h.shape
    n = b * c * t
    m, inv, r = stat[..., 0], stat[..., 1], stat[..., 2].double()
    xm = h - _per_feature(m)
    y = xm * _per_feature(inv) + _per_feature(bias)
    do = dout.reshape(g, b, t, f1, -1)
    dy = torch.einsum("gbtfd,gfdc->gbctf", do, s)
    a1 = dy.sum((1, 2, 3), dtype=torch.float64)
    a2 = (dy * xm).sum((1, 2, 3), dtype=torch.float64)
    ds = torch.einsum("gbctf,gbtfd->gfdc", y, do)
    dv = torch.where(stat[..., 3] > 0, -0.5 * a2 * scale.double() * r ** 3,
                     torch.zeros_like(a2))
    c0 = (-inv.double() * a1 / n).float()
    c1 = (2.0 * dv / n).float()
    dh = dy * _per_feature(inv) + (_per_feature(c0) + _per_feature(c1) * xm)
    return dh, (a2 * r).float(), a1.float(), ds


def _library() -> ctypes.CDLL:
    lib = build.load("bn_spatial")
    if lib.eeg_bn_spatial_forward.argtypes is None:
        lib.eeg_bn_spatial_tile_floats.argtypes = []
        lib.eeg_bn_spatial_tile_floats.restype = ctypes.c_int
        lib.eeg_bn_spatial_error_string.argtypes = [ctypes.c_int]
        lib.eeg_bn_spatial_error_string.restype = ctypes.c_char_p
        lib.eeg_bn_spatial_forward.argtypes = (
            [ctypes.c_void_p] * 11 + [ctypes.c_int] * 6
            + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int]
            + [ctypes.c_float] * 3 + [ctypes.c_void_p])
        lib.eeg_bn_spatial_forward.restype = ctypes.c_int
        lib.eeg_bn_spatial_backward.argtypes = (
            [ctypes.c_void_p] * 13 + [ctypes.c_int] * 6
            + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int]
            + [ctypes.c_void_p])
        lib.eeg_bn_spatial_backward.restype = ctypes.c_int
    built = lib.eeg_bn_spatial_tile_floats()
    if built != TILE_FLOATS:
        raise RuntimeError(f"bn_spatial: the built library tiles dout in "
                           f"{built} floats, the wrapper plans {TILE_FLOATS}")
    return lib


def _raise_on(lib, err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(
            f"bn_spatial: {what} launch failed with CUDA error {err} "
            f"({lib.eeg_bn_spatial_error_string(err).decode()})")


def row_pitch(h: torch.Tensor) -> int:
    """Floats between consecutive ``(g, b, c)`` rows of ``h`` ``(G, B, C,
    T, F1)``, whose rows must each be contiguous and evenly spaced (the
    banded convolution's contiguous output, or its tiled path's slice of a
    longer time axis); raises otherwise."""
    g, b, c, t, f1 = h.shape
    pitch = t * f1
    for i, n in ((2, 1), (1, c), (0, b * c)):
        if h.shape[i] > 1:
            pitch = h.stride(i) // n if h.stride(i) % n == 0 else -1
            break
    want = (b * c * pitch, c * pitch, pitch, f1, 1)
    if pitch < t * f1 or any(n > 1 and h.stride(i) != want[i]
                             for i, n in enumerate(h.shape)):
        raise ValueError(f"bn_spatial: h {tuple(h.shape)} with strides "
                         f"{h.stride()} is not evenly spaced contiguous rows")
    return pitch


def _launch_forward(lib, h, s, scale, bias, mean, var, momentum, eps,
                    pitch: int, p: Plan, stream: int):
    """Passes A, A' and B: ``(out, stat, new_mean, new_var)``."""
    g, b, c, t, f1 = h.shape
    d = s.shape[2]
    f32 = {"device": h.device, "dtype": torch.float32}
    out = torch.empty((g, b, t, f1 * d), **f32)
    stat = torch.empty((g, f1, 4), **f32)
    new_mean = torch.empty((g, f1), **f32)
    new_var = torch.empty((g, f1), **f32)
    part = torch.empty((g, p.per_fold, f1, 2), device=h.device,
                       dtype=torch.float64)
    err = lib.eeg_bn_spatial_forward(
        h.data_ptr(), s.data_ptr(), scale.data_ptr(), bias.data_ptr(),
        mean.data_ptr(), var.data_ptr(), out.data_ptr(), stat.data_ptr(),
        new_mean.data_ptr(), new_var.data_ptr(), part.data_ptr(),
        g, b, c, t, f1, d, pitch, p.vec, p.per_fold, eps, momentum,
        1.0 - momentum, stream)
    _raise_on(lib, err, "forward")
    return out, stat, new_mean, new_var


def _launch_backward(lib, h, dout, s, scale, bias, stat, pitch: int,
                     p: Plan, stream: int):
    """Passes C, C' and D: ``(dh, dscale, dbias, ds)``."""
    g, b, c, t, f1 = h.shape
    d = s.shape[2]
    f32 = {"device": h.device, "dtype": torch.float32}
    dh = torch.empty((g, b, c, t, f1), **f32)
    ds = torch.empty((g, f1, d, c), **f32)
    dscale = torch.empty((g, f1), **f32)
    dbias = torch.empty((g, f1), **f32)
    ds_part = torch.empty((g, b, p.n_tiles, c, f1 * d), **f32)
    bn_part = torch.empty((g, b, p.n_tiles, f1, 2), device=h.device,
                          dtype=torch.float64)
    coef = torch.empty((g, f1, 2), **f32)
    err = lib.eeg_bn_spatial_backward(
        h.data_ptr(), dout.data_ptr(), s.data_ptr(), scale.data_ptr(),
        bias.data_ptr(), stat.data_ptr(), dh.data_ptr(), ds.data_ptr(),
        dscale.data_ptr(), dbias.data_ptr(), ds_part.data_ptr(),
        bn_part.data_ptr(), coef.data_ptr(), g, b, c, t, f1, d, pitch,
        p.vec, p.tile, stream)
    _raise_on(lib, err, "backward")
    return dh, dscale, dbias, ds


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


class _BnSpatial(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h, scale, bias, s, mean, var, momentum, eps):
        if h.device.type == "cpu":
            stat, new_mean, new_var = stats_reference(h, scale, mean, var,
                                                      momentum, eps)
            out = forward_reference(h, s, stat, bias)
            ctx.launch = None
        else:
            pitch = row_pitch(h)
            g, b, c, t, f1 = h.shape
            p = plan(g, b, c, t, f1, s.shape[2], pitch,
                     h.data_ptr() % 16 == 0)
            lib = _library()
            with torch.cuda.device(h.device):
                out, stat, new_mean, new_var = _launch_forward(
                    lib, h, s, scale, bias, mean, var, momentum, eps, pitch,
                    p, _stream(h))
            count_launch(bn_spatial_train, "bn_spatial.forwards", 3)
            ctx.launch = (lib, pitch, p)
        ctx.save_for_backward(h, scale, bias, s, stat)
        ctx.mark_non_differentiable(new_mean, new_var)
        return out, new_mean, new_var

    @staticmethod
    def backward(ctx, dout, _d_mean, _d_var):
        h, scale, bias, s, stat = ctx.saved_tensors
        if ctx.launch is None:
            grads = backward_reference(h, dout, s, stat, scale, bias)
        else:
            lib, pitch, p = ctx.launch
            dout = dout.contiguous()
            if dout.data_ptr() % 16:
                dout = dout.clone()
            with torch.cuda.device(h.device):
                grads = _launch_backward(lib, h, dout, s, scale, bias, stat,
                                         pitch, p, _stream(h))
            count_launch(bn_spatial_train, n=3)
        dh, dscale, dbias, ds = grads
        return dh, dscale, dbias, ds, None, None, None, None


def _check_operands(h, named) -> None:
    """Raise on anything the kernels do not take."""
    for name, v in named.items():
        if v.device != h.device:
            raise ValueError(f"bn_spatial: {name} is on {v.device}, h on "
                             f"{h.device}")
        if v.dtype != torch.float32:
            raise TypeError(f"bn_spatial: {name} must be float32, got "
                            f"{v.dtype}")


def bn_spatial_train(h: torch.Tensor, scale: torch.Tensor,
                     bias: torch.Tensor, mean: torch.Tensor,
                     var: torch.Tensor, weight: torch.Tensor, *,
                     momentum: float = 0.9, eps: float = 1e-5
                     ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``temporal.1``'s flax-mode training BatchNorm and the depthwise
    spatial convolution of G stacked EEGNets, as one op.

    ``h`` ``(G, B, C, T, F1)`` is the banded temporal convolution's output
    (any evenly spaced contiguous rows, not copied); ``scale``, ``bias``
    and the running ``mean``, ``var`` are ``(G, F1)``; ``weight`` is the
    spatial kernel ``(G, F1 * D, 1, C, 1)``.  Returns the convolution's
    output ``(G, B, T, F1 * D)``, what ``ops/banded.py::
    spatial_conv_banded`` returns on the normalised ``h``, and the new
    running mean and variance (detached), the composition's to f32
    rounding.  Differentiable in ``h``, ``scale``, ``bias`` and ``weight``.
    A CPU ``h`` runs the plain twin; a CUDA ``h`` the kernels (module
    docstring), after checking device, dtype, geometry and layout.
    """
    g, b, c, t, f1 = h.shape
    f2 = weight.shape[1]
    if tuple(weight.shape) != (g, f2, 1, c, 1) or f2 % f1:
        raise ValueError(f"bn_spatial: weight {tuple(weight.shape)} does not "
                         f"fit h {tuple(h.shape)}")
    d = f2 // f1
    s = weight[:, :, 0, :, 0].reshape(g, f1, d, c).contiguous()
    scale, bias = scale.contiguous(), bias.contiguous()
    mean, var = mean.detach().contiguous(), var.detach().contiguous()
    if h.device.type == "cuda":
        _check_operands(h, {"h": h, "scale": scale, "bias": bias,
                            "mean": mean, "var": var, "weight": s})
        if not supported(c, f1, d):
            raise ValueError(f"bn_spatial: no kernel for C={c}, F1={f1}, "
                             f"D={d}")
    elif h.device.type != "cpu":
        raise ValueError(f"bn_spatial: no kernel for device {h.device}")
    return _BnSpatial.apply(h, scale, bias, s, mean, var, float(momentum),
                            float(eps))


bn_spatial_train.launches = 0
bn_spatial_train.captured = 0
