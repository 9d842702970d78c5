"""Fused EEGNet block 1 for eval mode: the CUDA kernel K1 and its plain twin.

The counterpart of ``eegnetreplication_tpu/ops/fused_eegnet.py``.  In eval
mode every stage of block 1 before the ELU is linear (BatchNorm is a
per-channel affine), so the temporal filter and the depthwise spatial
filters commute:

    y[f2, t] = A[f2] * sum_k W[f2, k] * (sum_c S[f2, c] x[c, t+k-15]) + B[f2]

with ``A``/``B`` folding both BatchNorms.  Block 1 becomes one ``(F2, C)``
mix and a 32-tap filter on F2 mixed rows, then ELU and AvgPool(4).

- :func:`fold_block1_params` derives ``(S, W, A, B)`` from the model's
  ``state_dict``;
- :func:`block1_reference` is the plain PyTorch version (the CPU path, and
  what the kernel is held against on the card);
- :func:`block1` dispatches: a CPU tensor takes the plain version, a CUDA
  tensor launches K1 (``csrc/block1.cu``) or raises — there is no fallback;
- :func:`fused_eval_forward` runs the whole network with the fused block 1
  and block 2 plus the classifier as torch ops, matching ``EEGNet.forward``.

The JAX package's ``EEGTPU_FUSED_EVAL=0`` escape hatch and its Pallas probe
have no counterpart: on the card the kernel runs, or the call raises.
"""

from __future__ import annotations

import ctypes
from typing import Mapping

import torch
import torch.nn.functional as F

from eegnetreplication_tpu_torch.ops import build

TEMPORAL_K = 32
PAD_LEFT = 15   # SAME padding of an even kernel: (15, 16)
PAD_RIGHT = 16


def fold_block1_params(state_dict: Mapping[str, torch.Tensor],
                       eps: float = 1e-5):
    """Fold block-1 weights and both BatchNorms into ``(S, W, A, B)``.

    Returns contiguous tensors on the weights' device:
        S: ``(F2, C)`` spatial mixing matrix.
        W: ``(F2, K)`` per-output temporal taps (group kernel replicated).
        A, B: ``(F2,)`` affine folding the temporal and spatial BatchNorms.
    """
    w_t = state_dict["temporal.0.weight"]      # (F1, 1, 1, K)
    w_s = state_dict["spatial.weight"]         # (F2, 1, C, 1)
    f1 = w_t.shape[0]
    f2 = w_s.shape[0]
    d = f2 // f1

    def bn_affine(prefix):
        inv = 1.0 / torch.sqrt(state_dict[f"{prefix}.running_var"] + eps)
        scale = state_dict[f"{prefix}.weight"] * inv
        shift = state_dict[f"{prefix}.bias"] \
            - state_dict[f"{prefix}.running_mean"] * scale
        return scale, shift

    a1, b1 = bn_affine("temporal.1")      # per F1, between the convs
    a2, b2 = bn_affine("aggregation.0")   # per F2, after the spatial conv

    S = w_s[:, 0, :, 0].contiguous()                        # (F2, C)
    group = torch.arange(f2, device=w_t.device) // d        # f2 -> f1
    W = w_t[:, 0, 0, :][group].contiguous()                 # (F2, K)
    col_sum = torch.sum(S, dim=1)                           # sum_c s[f2,c]
    A = (a2 * a1[group]).contiguous()
    B = (a2 * (b1[group] * col_sum) + b2).contiguous()
    return S, W, A, B


def _elu(x: torch.Tensor) -> torch.Tensor:
    return torch.where(x > 0, x, torch.expm1(x))


def block1_reference(x, S, W, A, B):
    """Plain PyTorch block 1: ``(B, C, T) -> (B, F2, T//4)``."""
    mixed = torch.einsum("fc,bct->bft", S, x)
    padded = F.pad(mixed, (PAD_LEFT, PAD_RIGHT))
    t = x.shape[-1]
    acc = torch.zeros_like(mixed)
    for k in range(TEMPORAL_K):
        acc = acc + W[None, :, k:k + 1] * padded[..., k:k + t]
    act = _elu(A[None, :, None] * acc + B[None, :, None])
    t_pool = t // 4
    pooled = act[..., : t_pool * 4].reshape(*act.shape[:-1], t_pool, 4)
    return torch.mean(pooled, dim=-1)


def _k1_library() -> ctypes.CDLL:
    lib = build.load("block1")
    if lib.eeg_block1_launch.argtypes is None:
        lib.eeg_cuda_error_string.argtypes = [ctypes.c_int]
        lib.eeg_cuda_error_string.restype = ctypes.c_char_p
        lib.eeg_block1_launch.argtypes = (
            [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_void_p])
        lib.eeg_block1_launch.restype = ctypes.c_int
    return lib


def _check_operands(x, S, W, A, B) -> None:
    named = {"x": x, "S": S, "W": W, "A": A, "B": B}
    for name, t in named.items():
        if t.device != x.device:
            raise ValueError(f"block1: {name} is on {t.device}, x on "
                             f"{x.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"block1: {name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"block1: {name} must be contiguous")
    if x.dim() != 3:
        raise ValueError(f"block1: x must be (B, C, T), got {tuple(x.shape)}")
    _, c, t = x.shape
    f2 = S.shape[0]
    expected = {"S": (f2, c), "W": (f2, TEMPORAL_K), "A": (f2,), "B": (f2,)}
    for name, shape in expected.items():
        if tuple(named[name].shape) != shape:
            raise ValueError(f"block1: {name} must be {shape}, got "
                             f"{tuple(named[name].shape)}")
    if t < 4:
        raise ValueError(f"block1: T={t} leaves no AvgPool(4) output")


def block1(x, S, W, A, B):
    """Fused block 1: ``(B, C, T) -> (B, F2, T//4)``.

    A CPU ``x`` runs :func:`block1_reference`.  A CUDA ``x`` launches K1 on
    the current stream (one launch per call, counted in
    ``block1.launches``) after checking device, dtype, shape and
    contiguity; anything the kernel does not take raises.
    """
    if x.device.type == "cpu":
        return block1_reference(x, S, W, A, B)
    if x.device.type != "cuda":
        raise ValueError(f"block1: no kernel for device {x.device}")
    _check_operands(x, S, W, A, B)
    n, c, t = x.shape
    f2 = S.shape[0]
    lib = _k1_library()
    out = torch.empty((n, f2, t // 4), device=x.device, dtype=torch.float32)
    if n == 0:
        return out
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.eeg_block1_launch(
            x.data_ptr(), S.data_ptr(), W.data_ptr(), A.data_ptr(),
            B.data_ptr(), out.data_ptr(), n, c, t, f2, stream)
    if err != 0:
        raise RuntimeError(
            f"block1: K1 launch failed with CUDA error {err} "
            f"({lib.eeg_cuda_error_string(err).decode()})")
    block1.launches += 1
    return out


block1.launches = 0


def fused_eval_forward(model, x: torch.Tensor, block1_params=None
                       ) -> torch.Tensor:
    """Eval-mode EEGNet logits with the fused block 1.

    Numerically equivalent to ``model(x)``.  ``block1_params`` is a
    precomputed :func:`fold_block1_params` result (the serving engine folds
    once at load); ``None`` folds from the model's weights on each call.
    """
    S, W, A, B = (block1_params if block1_params is not None
                  else fold_block1_params(model.state_dict(),
                                          model.bn_epsilon))
    h = block1(x, S, W, A, B).unsqueeze(2)            # (B, F2, 1, T//4)

    # --- Block 2 (separable conv, SAME (7, 8)) + classifier, functional
    # on the model's weights ---
    f2 = h.shape[1]
    h = F.conv2d(F.pad(h, (7, 8)), model.block_2[0].weight, groups=f2)
    h = F.conv2d(h, model.block_2[1].weight)
    bn = model.block_2[2]
    inv = 1.0 / torch.sqrt(bn.running_var + model.bn_epsilon)
    h = ((h - bn.running_mean[:, None, None]) * inv[:, None, None]
         * bn.weight[:, None, None] + bn.bias[:, None, None])
    h = _elu(h)
    h = F.avg_pool2d(h, (1, 8))
    return F.linear(h.flatten(1), model.classifier.weight,
                    model.classifier.bias)
