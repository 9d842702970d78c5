"""FLOP accounting and MFU for the fold trainer and the eval forward.

The counterpart of ``eegnetreplication_tpu/utils/flops.py``.  The JAX
package lowers its real step functions and reads XLA's HLO cost model; the
port has no such model, so it counts each registered model's work (EEGNet,
ShallowConvNet, DeepConvNet) in closed form from the shapes, under the
same conventions:

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
less than the unfused forward.  The baselines have no fused eval: their
eval step is the forward and the loss.

The count is the minimal convolution's whatever EEGNet's ``conv_impl``:
the banded schedule multiplies ~T/K times the MACs on purpose, and the
JAX package counts the ``"lax"`` schedule for that reason
(``_canonical_schedule``), so MFU is not flattered by the inflation.

The MFU denominator, :func:`assumed_peak_flops`, keys on the card's name
and on the arithmetic the run's numerics mode computes in, as the JAX
table keys the peak of the arithmetic its chip runs.  Under ``"highest"``
``utils/device.py`` turns TF32 off, so the port runs its f32 work on the
CUDA cores: the peak is the card's dense FP32 (non-tensor) rate.
``"high"`` and ``"default"`` run TF32 on the tensor cores and ``"bf16"``
BF16: their peaks are the dense tensor-core rates of that type (NVIDIA's
H100 data sheet).  An unknown card gets no peak, and the training log
then prints GFLOP/s without MFU.  ``EEGTPU_PEAK_FLOPS`` (a float)
overrides, as in the JAX package.
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


# --- The baselines (models/convnets.py) ----------------------------------
# Per-element op counts of their elementwise passes, read off the JAX
# step's HLO as EEGNet's are: jax.nn.elu is 4 ops; the training passes are
# per element of the tensor that enters the pool (Shallow: square,
# AvgPool(35, 7) and log, forward and backward; Deep: ELU and MaxPool(2),
# forward and backward), and the dropouts per element they mask.
CONVNET_ELU = 4
SHALLOW_ACT_TRAIN = 46
DEEP_ACT_TRAIN = 27


def _baseline_kind(model) -> str | None:
    if hasattr(model, "n_filters_time"):
        return "shallow"
    if hasattr(model, "filters"):
        return "deep"
    return None


def _shallow_dims(model) -> dict:
    c, t = int(model.n_channels), int(model.n_times)
    ft, fs = int(model.n_filters_time), int(model.n_filters_spat)
    t1 = t - int(model.filter_time_length) + 1
    window, stride = int(model.pool_time_length), int(model.pool_time_stride)
    t2 = (t1 - window) // stride + 1
    k = int(getattr(model, "n_classes", 4))
    macs = {"temporal": ft * c * t1 * int(model.filter_time_length),
            "spatial": fs * ft * c * t1, "classifier": fs * t2 * k}
    n_params = (ft * int(model.filter_time_length) + fs * ft * c + 2 * fs
                + fs * t2 * k + k)
    return dict(c=c, k=k, n1=fs * t1, n2=fs * t2, window=window,
                macs=macs, n_params=n_params)


def _deep_dims(model) -> dict:
    c, t = int(model.n_channels), int(model.n_times)
    kl, pool = int(model.kernel_length), int(model.pool_length)
    widths = [int(f) for f in model.filters]
    k = int(getattr(model, "n_classes", 4))
    macs, pre_pool, pooled = {}, [], []
    t = t - kl + 1
    macs["temporal"] = widths[0] * c * t * kl
    macs["spatial"] = widths[0] * widths[0] * c * t
    pre_pool.append(widths[0] * t)
    t //= pool
    pooled.append(widths[0] * t)
    for i in range(1, len(widths)):
        t = t - kl + 1
        macs[f"conv_{i}"] = widths[i] * widths[i - 1] * kl * t
        pre_pool.append(widths[i] * t)
        t //= pool
        pooled.append(widths[i] * t)
    macs["classifier"] = widths[-1] * t * k
    n_params = (widths[0] * kl + widths[0] * widths[0] * c
                + sum(widths[i] * widths[i - 1] * kl
                      for i in range(1, len(widths)))
                + 2 * sum(widths) + widths[-1] * t * k + k)
    return dict(c=c, k=k, pre_pool=pre_pool, pooled=pooled, pool=pool,
                macs=macs, n_params=n_params)


def _baseline_forward(model) -> tuple[float, dict]:
    """One trial's eval forward FLOPs and the baseline's dims."""
    if _baseline_kind(model) == "shallow":
        g = _shallow_dims(model)
        return (2 * sum(g["macs"].values()) + g["k"]
                + (BN_EVAL + 1) * g["n1"]             # BN, square
                + g["window"] * g["n2"]               # pool sums, divide
                + g["n2"], g)                         # the log's clamp
    g = _deep_dims(model)
    n = sum(g["pre_pool"])
    return (2 * sum(g["macs"].values()) + g["k"]
            + (BN_EVAL + CONVNET_ELU) * n
            + (g["pool"] - 1) * sum(g["pooled"]), g)


def _baseline_train(model) -> tuple[float, float]:
    """(per-trial FLOPs of one train step, per-step Adam FLOPs)."""
    fwd, g = _baseline_forward(model)
    macs = g["macs"]
    # every layer but the first gets an input gradient
    bwd = 2 * macs["temporal"] + 4 * sum(
        v for name, v in macs.items() if name != "temporal") + g["k"]
    fwd = 2 * sum(macs.values()) + g["k"]
    if _baseline_kind(model) == "shallow":
        elementwise = ((BN_TRAIN + SHALLOW_ACT_TRAIN) * g["n1"]
                       + DROPOUT_TRAIN * g["n2"])
    else:
        elementwise = ((BN_TRAIN + DEEP_ACT_TRAIN) * sum(g["pre_pool"])
                       + DROPOUT_TRAIN * sum(g["pooled"][:-1]))
    return (fwd + bwd + elementwise + CE_PER_CLASS * g["k"],
            PARAM_UPDATE * g["n_params"])


def eval_forward_flops(model, batch_size: int) -> float:
    """FLOPs of one unfused inference forward of ``batch_size`` trials (the
    JAX ``model.apply`` in eval mode)."""
    if _baseline_kind(model):
        return float(batch_size * _baseline_forward(model)[0])
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
    the classifier and the weighted loss (a baseline: its forward and the
    loss)."""
    if _baseline_kind(model):
        fwd, g = _baseline_forward(model)
        return float(batch_size * (fwd + CE_PER_CLASS * g["k"]))
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
    if _baseline_kind(model):
        per_trial, update = _baseline_train(model)
        return float(batch_size * per_trial + update)
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


# The arithmetic each numerics mode computes in on the card.
ARITHMETIC = {"highest": "FP32", "high": "TF32", "default": "TF32",
              "bf16": "BF16"}

# Dense peaks in TFLOP/s (FP32 on the CUDA cores, TF32 and BF16 on the
# tensor cores, without sparsity), NVIDIA's H100 data sheet, by a
# substring of ``torch.cuda.get_device_name``; the first match wins.
_PEAK_BY_NAME = (
    ("h100 pcie", "H100 PCIe", {"FP32": "51.2", "TF32": "378",
                                "BF16": "756"}),
    ("h100", "H100 SXM", {"FP32": "66.9", "TF32": "494.7",
                          "BF16": "989.4"}),
)


def assumed_peak_flops(device_name: str | None = None,
                       precision: str = "highest"
                       ) -> tuple[float | None, str]:
    """(peak FLOP/s, label) for the MFU denominator of a run in the
    numerics mode ``precision``: the card's dense peak for that mode's
    arithmetic (:data:`ARITHMETIC`); ``(None, label)`` for a card the table
    does not know.  ``EEGTPU_PEAK_FLOPS`` overrides."""
    env = os.environ.get("EEGTPU_PEAK_FLOPS")
    if env:
        try:
            return float(env), f"EEGTPU_PEAK_FLOPS={env}"
        except ValueError:
            pass
    arithmetic = ARITHMETIC[precision]
    name = (device_name or "").lower()
    for needle, card, peaks in _PEAK_BY_NAME:
        if needle in name:
            tflops = peaks[arithmetic]
            return float(tflops + "e12"), (f"{card} {arithmetic} peak "
                                          f"({tflops} TFLOP/s)")
    return None, f"no {arithmetic} peak known for {device_name!r}"


def mfu(flops_per_s: float, device_name: str | None = None,
        precision: str = "highest") -> float | None:
    """Model FLOP/s utilization against :func:`assumed_peak_flops`, or
    ``None`` without a known peak."""
    peak, _ = assumed_peak_flops(device_name, precision)
    return None if peak is None else flops_per_s / peak
