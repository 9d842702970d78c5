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
  and block 2 plus the classifier as torch ops, matching ``EEGNet.forward``;
- :func:`block1_stacked` (and its plain version
  :func:`block1_stacked_reference`) takes G weight sets and an index per
  trial, the form ``block1_pallas`` takes under ``jax.vmap`` over the
  weights; :func:`fused_eval_forward_stacked` runs every fold of a
  fold-stacked state through it in one launch (the training loop's
  validation and test passes).  On the card it launches K1-stacked
  (``csrc/block1_stacked.cu``), K1's arithmetic redesigned for the
  training batch; :func:`stacked_plan` sizes its launch.

The JAX package's ``EEGTPU_FUSED_EVAL=0`` escape hatch and its Pallas probe
have no counterpart: on the card the kernel runs, or the call raises.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Mapping

import torch
import torch.nn.functional as F

from eegnetreplication_tpu_torch.obs import trace as obs_trace
from eegnetreplication_tpu_torch.ops import build

TEMPORAL_K = 32
PAD_LEFT = 15   # SAME padding of an even kernel: (15, 16)
PAD_RIGHT = 16

# K1-stacked's work items (``csrc/block1_stacked.cu``: kLongPool,
# kShortPool): one trial and one time tile of that many pooled outputs.
# The wrapper checks them against the built library.
K1S_LONG_POOL = 64
K1S_SHORT_POOL = 32


def fold_block1_params(state_dict: Mapping[str, torch.Tensor],
                       eps: float = 1e-5):
    """Fold block-1 weights and both BatchNorms into ``(S, W, A, B)``.

    Returns contiguous tensors on the weights' device:
        S: ``(F2, C)`` spatial mixing matrix.
        W: ``(F2, K)`` per-output temporal taps (group kernel replicated).
        A, B: ``(F2,)`` affine folding the temporal and spatial BatchNorms.

    A fold-stacked ``state_dict`` (every tensor with a leading G axis)
    folds each set on its own and gives ``(G, F2, C)``, ``(G, F2, K)``,
    ``(G, F2)`` and ``(G, F2)``.
    """
    w_t = state_dict["temporal.0.weight"]      # ([G,] F1, 1, 1, K)
    w_s = state_dict["spatial.weight"]         # ([G,] F2, 1, C, 1)
    f1 = w_t.shape[-4]
    f2 = w_s.shape[-4]
    d = f2 // f1

    def bn_affine(prefix):
        inv = 1.0 / torch.sqrt(state_dict[f"{prefix}.running_var"] + eps)
        scale = state_dict[f"{prefix}.weight"] * inv
        shift = state_dict[f"{prefix}.bias"] \
            - state_dict[f"{prefix}.running_mean"] * scale
        return scale, shift

    a1, b1 = bn_affine("temporal.1")      # per F1, between the convs
    a2, b2 = bn_affine("aggregation.0")   # per F2, after the spatial conv

    S = w_s[..., 0, :, 0].contiguous()                      # (F2, C)
    group = torch.arange(f2, device=w_t.device) // d        # f2 -> f1
    W = w_t[..., group, 0, 0, :].contiguous()               # (F2, K)
    col_sum = torch.sum(S, dim=-1)                          # sum_c s[f2,c]
    A = (a2 * a1[..., group]).contiguous()
    B = (a2 * (b1[..., group] * col_sum) + b2).contiguous()
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


def block1_stacked_reference(x, S, W, A, B, idx):
    """Plain PyTorch block 1 on stacked weights: trial ``n`` of ``x``
    ``(N, C, T)`` runs with set ``idx[n]`` of ``S`` ``(G, F2, C)``, ``W``
    ``(G, F2, K)``, ``A`` and ``B`` ``(G, F2)``; returns ``(N, F2, T//4)``.
    An index outside ``[0, G)`` raises."""
    idx = idx.long()
    g = S.shape[0]
    if idx.numel() and (int(idx.min()) < 0 or int(idx.max()) >= g):
        raise ValueError(f"block1_stacked: idx outside [0, {g})")
    Sn, Wn, An, Bn = S[idx], W[idx], A[idx], B[idx]
    mixed = torch.einsum("nfc,nct->nft", Sn, x)
    padded = F.pad(mixed, (PAD_LEFT, PAD_RIGHT))
    t = x.shape[-1]
    acc = torch.zeros_like(mixed)
    for k in range(TEMPORAL_K):
        acc = acc + Wn[:, :, k:k + 1] * padded[..., k:k + t]
    act = _elu(An[:, :, None] * acc + Bn[:, :, None])
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


def _k1s_library() -> ctypes.CDLL:
    lib = build.load("block1_stacked")
    if lib.eeg_block1_stacked_launch.argtypes is None:
        for fn in (lib.eeg_block1_stacked_long_pool,
                   lib.eeg_block1_stacked_short_pool):
            fn.argtypes = []
            fn.restype = ctypes.c_int
        lib.eeg_block1_stacked_blocks_per_sm.argtypes = [ctypes.c_int] * 3
        lib.eeg_block1_stacked_blocks_per_sm.restype = ctypes.c_int
        lib.eeg_block1_stacked_error_string.argtypes = [ctypes.c_int]
        lib.eeg_block1_stacked_error_string.restype = ctypes.c_char_p
        lib.eeg_block1_stacked_launch.argtypes = (
            [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 + [ctypes.c_void_p])
        lib.eeg_block1_stacked_launch.restype = ctypes.c_int
    built = (lib.eeg_block1_stacked_long_pool(),
             lib.eeg_block1_stacked_short_pool())
    if built != (K1S_LONG_POOL, K1S_SHORT_POOL):
        raise RuntimeError(f"block1_stacked: the built K1-stacked takes work "
                           f"items of {built} pooled outputs, the wrapper "
                           f"expects {(K1S_LONG_POOL, K1S_SHORT_POOL)}")
    return lib


def stacked_plan(n_trials: int, t: int, n_sms: int, per_sm_long: int,
                 per_sm_short: int) -> tuple[int, int, int, int]:
    """``(pool, n_items, per_block, grid)`` of a K1-stacked launch over
    ``n_trials`` trials of ``t`` samples on a card of ``n_sms`` SMs that
    holds ``per_sm_long``/``per_sm_short`` blocks of each item length.

    A work item is one trial and one time tile of ``pool`` pooled outputs.
    Long items (a whole trial at T=257) when there are enough of them to
    give every resident block one; short ones otherwise, so a small batch
    still spreads over the card.  Each block walks ``per_block``
    consecutive items (the last block fewer), ``grid`` blocks in all, no
    more than the card holds at once.  Raises when no item fits a block's
    shared memory."""
    t_pool = int(t) // 4

    def items(pool):
        return int(n_trials) * -(-t_pool // pool)

    if per_sm_long > 0 and items(K1S_LONG_POOL) >= n_sms * per_sm_long:
        pool, slots = K1S_LONG_POOL, n_sms * per_sm_long
    elif per_sm_short > 0:
        pool, slots = K1S_SHORT_POOL, n_sms * per_sm_short
    else:   # a short item's stages are smaller: neither fits
        raise ValueError("block1_stacked: a block's shared memory does not "
                         "hold this geometry's stages")
    n_items = items(pool)
    per_block = -(-n_items // max(1, min(n_items, slots)))
    return pool, n_items, per_block, -(-n_items // per_block)


@functools.lru_cache(maxsize=32)
def _k1s_occupancy(device_index: int, c: int, f2: int) -> tuple[int, int,
                                                                 int]:
    """``(n_sms, per_sm_long, per_sm_short)`` of the card at ``(C, F2)``."""
    lib = _k1s_library()
    with torch.cuda.device(device_index):
        n_sms = torch.cuda.get_device_properties(
            device_index).multi_processor_count
        return (n_sms,
                lib.eeg_block1_stacked_blocks_per_sm(K1S_LONG_POOL, c, f2),
                lib.eeg_block1_stacked_blocks_per_sm(K1S_SHORT_POOL, c, f2))


def _check_operands(x, S, W, A, B, idx=None) -> None:
    """Raise on anything K1 does not take.  With ``idx`` the weights are
    stacked ``(G, ...)`` sets and ``idx`` is an ``(N,)`` int32 index."""
    what = "block1" if idx is None else "block1_stacked"
    named = {"x": x, "S": S, "W": W, "A": A, "B": B}
    for name, t in named.items():
        if t.device != x.device:
            raise ValueError(f"{what}: {name} is on {t.device}, x on "
                             f"{x.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{what}: {name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")
    if x.dim() != 3:
        raise ValueError(f"{what}: x must be (B, C, T), got {tuple(x.shape)}")
    n, c, t = x.shape
    lead = () if idx is None else tuple(S.shape[:1])
    f2 = S.shape[len(lead)] if S.dim() > len(lead) else -1
    expected = {"S": lead + (f2, c), "W": lead + (f2, TEMPORAL_K),
                "A": lead + (f2,), "B": lead + (f2,)}
    for name, shape in expected.items():
        if tuple(named[name].shape) != shape:
            raise ValueError(f"{what}: {name} must be {shape}, got "
                             f"{tuple(named[name].shape)}")
    if t < 4:
        raise ValueError(f"{what}: T={t} leaves no AvgPool(4) output")
    if idx is not None:
        if idx.device != x.device:
            raise ValueError(f"{what}: idx is on {idx.device}, x on "
                             f"{x.device}")
        if idx.dtype != torch.int32:
            raise TypeError(f"{what}: idx must be int32, got {idx.dtype}")
        if tuple(idx.shape) != (n,) or not idx.is_contiguous():
            raise ValueError(f"{what}: idx must be a contiguous ({n},) "
                             f"vector, got {tuple(idx.shape)}")
        if lead[0] < 1:
            raise ValueError(f"{what}: no weight sets")


def _check_index_range(idx: torch.Tensor, g: int) -> None:
    """Raise unless ``0 <= idx < g``.  Reading the range waits for the
    device, so a checked index remembers the version it was checked at
    (an in-place write bumps ``_version``): the training loop builds its
    index once and reuses it, and pays the wait once."""
    # An inference-mode tensor keeps no version counter: checked each call.
    stamp = None if idx.is_inference() else (idx._version, g)
    if stamp is not None and getattr(idx, "_eeg_checked_range", None) == stamp:
        return
    lo, hi = torch.aminmax(idx)
    lo, hi = int(lo), int(hi)
    if lo < 0 or hi >= g:
        raise ValueError(f"block1_stacked: idx spans [{lo}, {hi}], outside "
                         f"[0, {g})")
    if stamp is not None:
        idx._eeg_checked_range = stamp


def count_launch(fn, counter: str | None = None, n: int = 1) -> None:
    """Count ``n`` launches of ``fn``'s kernels in ``fn.launches``, and one
    call in the process's layer counter ``counter`` when given.  Inside a
    CUDA graph capture nothing runs yet: the launches go to
    ``fn.captured``, and whoever replays the graph counts them per replay
    (``serve/engine.py``)."""
    if torch.cuda.is_current_stream_capturing():
        fn.captured += n
    else:
        fn.launches += n
        if counter is not None:
            obs_trace.count(counter)


def _launch_error(lib, err: int) -> RuntimeError:
    return RuntimeError(
        f"block1: K1 launch failed with CUDA error {err} "
        f"({lib.eeg_cuda_error_string(err).decode()})")


def block1(x, S, W, A, B):
    """Fused block 1: ``(B, C, T) -> (B, F2, T//4)``.

    A CPU ``x`` runs :func:`block1_reference`.  A CUDA ``x`` launches K1 on
    the current stream (one launch per call, counted in
    ``block1.launches``, or in ``block1.captured`` inside a graph capture)
    after checking device, dtype, shape and contiguity; anything the
    kernel does not take raises.
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
        raise _launch_error(lib, err)
    count_launch(block1)
    return out


block1.launches = 0
block1.captured = 0


def block1_stacked(x, S, W, A, B, idx, *, idx_checked: bool = False):
    """Fused block 1 on stacked weights: ``(N, C, T) -> (N, F2, T//4)``,
    trial ``n`` with weight set ``idx[n]``.

    ``S`` ``(G, F2, C)``, ``W`` ``(G, F2, 32)``, ``A`` and ``B`` ``(G, F2)``,
    ``idx`` ``(N,)`` int32.  A CPU ``x`` runs
    :func:`block1_stacked_reference`.  A CUDA ``x`` launches K1-stacked
    (``csrc/block1_stacked.cu``, sized by :func:`stacked_plan`) on the
    current stream (one launch per call, counted in
    ``block1_stacked.launches`` apart from ``block1.launches`` and in the
    layer counter ``k1_stacked.launches`` (``obs/trace.py::count``), or in
    ``block1_stacked.captured`` inside a graph capture) after checking
    device, dtype, shape, contiguity and ``0 <= idx < G``; anything the
    kernel does not take raises.  ``idx_checked=True`` skips the range
    check, which waits for the device: the caller has checked the range
    on the host (a graph capture may not wait).
    """
    if x.device.type == "cpu":
        return block1_stacked_reference(x, S, W, A, B, idx)
    if x.device.type != "cuda":
        raise ValueError(f"block1_stacked: no kernel for device {x.device}")
    _check_operands(x, S, W, A, B, idx)
    n, c, t = x.shape
    g, f2 = S.shape[0], S.shape[1]
    out = torch.empty((n, f2, t // 4), device=x.device, dtype=torch.float32)
    if n == 0:
        return out
    if not idx_checked:
        _check_index_range(idx, g)
    lib = _k1s_library()
    dev_index = x.device.index if x.device.index is not None \
        else torch.cuda.current_device()
    pool, _, per_block, _ = stacked_plan(n, t, *_k1s_occupancy(dev_index, c,
                                                                f2))
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.eeg_block1_stacked_launch(
            x.data_ptr(), S.data_ptr(), W.data_ptr(), A.data_ptr(),
            B.data_ptr(), idx.data_ptr(), out.data_ptr(), n, c, t, f2, g,
            pool, per_block, stream)
    if err != 0:
        raise RuntimeError(
            f"block1_stacked: K1-stacked launch failed with CUDA error {err} "
            f"({lib.eeg_block1_stacked_error_string(err).decode()})")
    count_launch(block1_stacked, "k1_stacked.launches")
    return out


block1_stacked.launches = 0
block1_stacked.captured = 0


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


def fold_index(n_sets: int, per_set: int, device) -> torch.Tensor:
    """``(n_sets * per_set,)`` int32: set ``g`` for trials ``g * per_set``
    to ``(g + 1) * per_set - 1``, the index of a fold-stacked batch."""
    return torch.arange(n_sets, dtype=torch.int32,
                        device=device).repeat_interleave(per_set)


def fused_eval_forward_stacked(params: Mapping[str, torch.Tensor],
                               stats: Mapping[str, torch.Tensor],
                               x: torch.Tensor, idx: torch.Tensor,
                               eps: float = 1e-5,
                               conv_impl: str = "lax") -> torch.Tensor:
    """Eval-mode logits of G EEGNets at once, block 1 in one launch.

    ``params``/``stats`` hold the ``state_dict`` tensors with a leading G
    axis; ``x`` is ``(G, B, C, T)``, batch ``g`` for set ``g``, and ``idx``
    its flattened set index (:func:`fold_index`).  Returns ``(G, B,
    n_classes)``, equal to each set's :func:`fused_eval_forward` on its
    batch.  ``conv_impl`` is block 2's schedule (``models/eegnet.py``).
    """
    from eegnetreplication_tpu_torch.models.eegnet import (
        stacked_block2_classifier,
    )

    g, b, c, t = x.shape
    S, W, A, B = fold_block1_params({**params, **stats}, eps)
    h = block1_stacked(x.reshape(g * b, c, t), S, W, A, B, idx)
    return stacked_block2_classifier(h.reshape(g, b, *h.shape[1:]), params,
                                     stats, eps=eps, conv_impl=conv_impl)
