"""FLOP accounting and MFU for the fold trainer and the eval forward.

The counterpart of ``eegnetreplication_tpu/utils/flops.py``.  The JAX
package lowers its real step functions and reads XLA's HLO cost model; the
port has no such model, so it counts EEGNet's work in closed form from the
shapes, under the same conventions:

- a convolution or matmul costs 2 FLOPs per multiply-accumulate, and only
  the taps that land inside the input count (a SAME convolution's padding
  multiplies nothing);
- the first layer (the temporal convolution) gets a weight gradient only:
  no gradient flows into the input;
- an elementwise pass costs one FLOP per arithmetic op per element, a
  reduction one per input element, and transcendental ops (``expm1``,
  ``rsqrt``, ``exp``, ``log``) none.  The per-element op counts of each pass
  (:data:`BN_EVAL` ... :data:`PARAM_UPDATE`) are those of the JAX step's
  HLO: BatchNorm with batch statistics and its gradient is 16 ops per
  element, the ELU and pool passes of block 1 with their gradients 12 more
  on the same tensor, and so on;
- only the useful work of the algorithm counts: one model's step on one
  batch, times the folds.  The fold-stacked, grouped schedule the port
  runs (grouped convolutions over G folds, padded batches) does not add to
  it, and neither do random bits: the JAX count holds threefry's integer
  ops for each dropout mask (~42 per element, under 1% of a step), the
  port's does not.

The eval step runs block 1 in the fused algebra (a ``(F2, C)`` mix, then
32 taps on F2 rows), as the JAX ``eval_step`` does, which is why it costs
less than the unfused forward.

The MFU denominator, :func:`assumed_peak_flops`, keys on the card's name.
``utils/device.py`` turns TF32 off, so the port runs its f32 work on the
CUDA cores: the peak is the card's dense FP32 (non-tensor) rate.  An
unknown card gets no peak, and the training log then prints GFLOP/s
without MFU.  ``EEGTPU_PEAK_FLOPS`` (a float) overrides, as in the JAX
package.
"""

from __future__ import annotations

import math
import os

__all__ = [
    "train_step_flops",
    "eval_step_flops",
    "fold_epoch_flops",
    "eval_forward_flops",
    "assumed_peak_flops",
    "mfu",
]

TEMPORAL_K, TEMPORAL_PAD = 32, (15, 16)   # SAME, even kernel
SEPARABLE_K, SEPARABLE_PAD = 16, (7, 8)

# FLOPs per element of each elementwise pass (see the module docstring).
BN_EVAL = 3           # (x - mean) * scale + shift
BN_TRAIN = 16         # batch mean and variance, normalize, and the gradient
ELU = 2               # compare, select (expm1 is a transcendental)
BLOCK1_ACT_TRAIN = 12  # ELU and AvgPool(4) forward and backward, per input
BLOCK2_ACT_TRAIN = 23  # ELU, AvgPool(8), dropout forward and backward
DROPOUT_TRAIN = 10    # mask select and scale, forward and backward
CE_PER_CLASS = 10     # softmax, log, weighted cross-entropy and its gradient
PARAM_UPDATE = 18     # Adam's moments and update, the max-norm clamp


def _valid_taps(n: int, k: int, pad: tuple[int, int]) -> int:
    """(output, tap) pairs of a 1-D SAME convolution of length ``n`` that
    land inside the input."""
    left = pad[0]
    return sum(min(k, n + left - t) - max(0, left - t) for t in range(n))


def _dims(model) -> dict[str, int]:
    c, t = int(model.n_channels), int(model.n_times)
    f1, d = int(model.F1), int(model.D)
    f2 = f1 * d
    t4 = t // 4
    return dict(c=c, t=t, f1=f1, f2=f2, t4=t4, t8=t4 // 8,
                k=int(getattr(model, "n_classes", 4)))


def _conv_macs(g: dict[str, int]) -> dict[str, int]:
    """Multiply-accumulates of one trial's forward, per layer."""
    return {
        "temporal": g["f1"] * g["c"] * _valid_taps(g["t"], TEMPORAL_K,
                                                   TEMPORAL_PAD),
        "spatial": g["c"] * g["f2"] * g["t"],
        "depthwise": g["f2"] * _valid_taps(g["t4"], SEPARABLE_K,
                                           SEPARABLE_PAD),
        "pointwise": g["f2"] * g["f2"] * g["t4"],
        "classifier": g["f2"] * g["t8"] * g["k"],
    }


def _n_params(g: dict[str, int]) -> int:
    return (TEMPORAL_K * g["f1"] + g["c"] * g["f2"] + SEPARABLE_K * g["f2"]
            + g["f2"] * g["f2"] + g["f2"] * g["t8"] * g["k"] + g["k"]
            + 2 * (g["f1"] + 2 * g["f2"]))


def eval_forward_flops(model, batch_size: int) -> float:
    """FLOPs of one unfused inference forward of ``batch_size`` trials (the
    JAX ``model.apply`` in eval mode)."""
    g = _dims(model)
    macs = sum(_conv_macs(g).values())
    per_trial = (2 * macs + g["k"]
                 + BN_EVAL * (g["f1"] * g["c"] * g["t"] + g["f2"] * g["t"]
                              + g["f2"] * g["t4"])
                 + ELU * (g["f2"] * g["t"] + g["f2"] * g["t4"])
                 + 4 * g["f2"] * g["t4"] + 8 * g["f2"] * g["t8"])
    return float(batch_size * per_trial)


def eval_step_flops(model, batch_size: int) -> float:
    """FLOPs of one validation batch: block 1 in the fused algebra, block 2,
    the classifier and the weighted loss."""
    g = _dims(model)
    macs = _conv_macs(g)
    block1 = (2 * g["f2"] * g["c"] * g["t"]                 # the mix
              + 2 * g["f2"] * _valid_taps(g["t"], TEMPORAL_K, TEMPORAL_PAD)
              + 2 * g["f2"] * g["t"]                         # the affine
              + ELU * g["f2"] * g["t"] + 4 * g["f2"] * g["t4"])
    block2 = (2 * (macs["depthwise"] + macs["pointwise"] + macs["classifier"])
              + g["k"] + (BN_EVAL + ELU) * g["f2"] * g["t4"]
              + 8 * g["f2"] * g["t8"])
    return float(batch_size * (block1 + block2 + CE_PER_CLASS * g["k"]))


def train_step_flops(model, batch_size: int) -> float:
    """FLOPs of ONE optimizer step of one model at ``batch_size``: the
    training forward, the backward (no input gradient at the first layer),
    the loss, Adam and the max-norm clamp."""
    g = _dims(model)
    macs = _conv_macs(g)
    fwd = 2 * sum(macs.values()) + g["k"]
    bwd = 2 * macs["temporal"] + 4 * (macs["spatial"] + macs["depthwise"]
                                      + macs["pointwise"]
                                      + macs["classifier"]) + g["k"]
    n1 = g["f1"] * g["c"] * g["t"]
    n2, n3, n4 = g["f2"] * g["t"], g["f2"] * g["t4"], g["f2"] * g["t8"]
    elementwise = (BN_TRAIN * (n1 + n2 + n3)
                   + BLOCK1_ACT_TRAIN * n2 + DROPOUT_TRAIN * n3
                   + BLOCK2_ACT_TRAIN * n3 + DROPOUT_TRAIN * n4
                   + CE_PER_CLASS * g["k"])
    return float(batch_size * (fwd + bwd + elementwise)
                 + PARAM_UPDATE * _n_params(g))


def fold_epoch_flops(model, *, batch_size: int, train_pad: int,
                     val_pad: int) -> float:
    """FLOPs of one (fold x epoch): ``ceil(train_pad / batch)`` training
    steps and ``max(1, ceil(val_pad / batch))`` validation batches, the
    JAX scanner's slot math (padded batches count: they run at full
    cost)."""
    train_steps = math.ceil(train_pad / batch_size)
    val_steps = max(1, math.ceil(val_pad / batch_size))
    return (train_steps * train_step_flops(model, batch_size)
            + val_steps * eval_step_flops(model, batch_size))


# Dense FP32 (non-tensor-core) peaks, NVIDIA's H100 data sheet, by a
# substring of ``torch.cuda.get_device_name``; the first match wins.
_PEAK_BY_NAME = (
    ("h100 pcie", 51.2e12, "H100 PCIe FP32 peak (51.2 TFLOP/s)"),
    ("h100", 66.9e12, "H100 SXM FP32 peak (66.9 TFLOP/s)"),
)


def assumed_peak_flops(device_name: str | None = None
                       ) -> tuple[float | None, str]:
    """(peak FLOP/s, label) for the MFU denominator; ``(None, label)`` for
    a card the table does not know.  ``EEGTPU_PEAK_FLOPS`` overrides."""
    env = os.environ.get("EEGTPU_PEAK_FLOPS")
    if env:
        try:
            return float(env), f"EEGTPU_PEAK_FLOPS={env}"
        except ValueError:
            pass
    name = (device_name or "").lower()
    for needle, peak, label in _PEAK_BY_NAME:
        if needle in name:
            return peak, label
    return None, f"no FP32 peak known for {device_name!r}"


def mfu(flops_per_s: float, device_name: str | None = None) -> float | None:
    """Model FLOP/s utilization against :func:`assumed_peak_flops`, or
    ``None`` without a known peak."""
    peak, _ = assumed_peak_flops(device_name)
    return None if peak is None else flops_per_s / peak
