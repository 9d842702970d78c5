"""EEGNet-8,2 (Lawhern et al. 2018, arXiv:1611.08024), one model, NCHW.

Block 1: a temporal ``Conv(1 x 32, same)`` -> BatchNorm -> a depthwise
spatial ``Conv(C x 1)`` with ``D`` filters per temporal filter ->
BatchNorm -> ELU -> AvgPool(1, 4) -> Dropout.  Block 2: a separable
convolution (depthwise ``1 x 16 same``, then pointwise ``1 x 1``) ->
BatchNorm -> ELU -> AvgPool(1, 8) -> Dropout -> flatten (feature-major)
-> Dense(4).  No convolution has a bias; the dense layer has one.

Where this follows the configuration rather than the paper:

- the "max-norm" of the reference implementation clamps the *gradients*
  of the spatial filters (+-1.0) and of the dense weights (+-0.25)
  elementwise (``maxnorm_mode: reference``), where the paper bounds the
  weights' norms;
- BatchNorm in flax's convention (``bn_mode: flax``): the batch statistics
  count every slot of the padded batch, the running variance moves toward
  the biased batch variance, momentum 0.9 on the running value;
- weights start U(+-1/sqrt(fan_in)), biases too, drawn in the order of
  :data:`DRAWS` from a CPU generator, BatchNorm at the identity;
- a SAME convolution of even length pads 15 | 16 and 7 | 8.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from portbench.reference.layers import batch_norm, dropout


def shapes(cfg: dict) -> dict[str, tuple[int, ...]]:
    """Every parameter's shape, by the names the comparison uses."""
    c, t, k = cfg["n_channels"], cfg["n_times"], cfg["n_classes"]
    f1, f2 = cfg["F1"], cfg["F1"] * cfg["D"]
    t_out = t // (cfg["pool_1"] * cfg["pool_2"])
    return {
        "temporal.0.weight": (f1, 1, 1, cfg["temporal_kernel"]),
        "temporal.1.weight": (f1,), "temporal.1.bias": (f1,),
        "spatial.weight": (f2, 1, c, 1),
        "aggregation.0.weight": (f2,), "aggregation.0.bias": (f2,),
        "block_2.0.weight": (f2, 1, 1, cfg["separable_kernel"]),
        "block_2.1.weight": (f2, f2, 1, 1),
        "block_2.2.weight": (f2,), "block_2.2.bias": (f2,),
        "classifier.weight": (k, f2 * t_out), "classifier.bias": (k,),
    }


# The tensors drawn from the generator, in order; the dense bias shares
# the dense weight's bound.  Every other parameter is a BatchNorm's.
DRAWS = ("temporal.0.weight", "spatial.weight", "block_2.0.weight",
         "block_2.1.weight", "classifier.weight", "classifier.bias")
NORMS = ("temporal.1", "aggregation.0", "block_2.2")


def init(cfg: dict, generator: torch.Generator
         ) -> tuple[dict[str, torch.Tensor], dict[str, torch.Tensor]]:
    """One model's parameters and running statistics, on the CPU."""
    shp = shapes(cfg)
    params = {}
    for name in DRAWS:
        fan_in = math.prod(shp[name.replace("bias", "weight")][1:])
        bound = 1.0 / math.sqrt(fan_in)
        params[name] = torch.empty(shp[name]).uniform_(-bound, bound,
                                                       generator=generator)
    stats = {}
    for prefix in NORMS:
        n = shp[f"{prefix}.weight"][0]
        params[f"{prefix}.weight"] = torch.ones(n)
        params[f"{prefix}.bias"] = torch.zeros(n)
        stats[f"{prefix}.running_mean"] = torch.zeros(n)
        stats[f"{prefix}.running_var"] = torch.ones(n)
    return {k: params[k] for k in shp}, stats


def forward(cfg: dict, p: dict, s: dict, x: torch.Tensor, *, train: bool,
            masks=None, rate: float = 0.0):
    """Logits ``(B, n_classes)`` of trials ``(B, C, T)`` and the running
    statistics after this batch (the old ones in eval mode)."""
    kt, ks = cfg["temporal_kernel"], cfg["separable_kernel"]
    new = dict(s)
    h = F.conv2d(F.pad(x[:, None], (kt // 2 - 1, kt // 2)),
                 p["temporal.0.weight"])
    h = batch_norm(h, p, s, new, "temporal.1", train, cfg)
    h = F.conv2d(h, p["spatial.weight"], groups=cfg["F1"])
    h = batch_norm(h, p, s, new, "aggregation.0", train, cfg)
    h = F.avg_pool2d(F.elu(h), (1, cfg["pool_1"]))
    if train and rate > 0:
        h = dropout(h, masks[0], rate)
    h = F.conv2d(F.pad(h, (ks // 2 - 1, ks // 2)), p["block_2.0.weight"],
                 groups=h.shape[1])
    h = F.conv2d(h, p["block_2.1.weight"])
    h = batch_norm(h, p, s, new, "block_2.2", train, cfg)
    h = F.avg_pool2d(F.elu(h), (1, cfg["pool_2"]))
    if train and rate > 0:
        h = dropout(h, masks[1], rate)
    return F.linear(h.flatten(1), p["classifier.weight"],
                    p["classifier.bias"]), new


def mask_draws(cfg: dict, schedule: str, n_folds: int, batch: int
               ) -> list[tuple[int, ...]]:
    """The shapes the program's dropout stream draws per train step, in
    order: one ``torch.rand`` for all folds after each pool.  Its banded
    schedule lays the pooled activations out ``(G, B, T', F2)``, its lax
    schedule ``(B, G * F2, 1, T')``."""
    f2, t = cfg["F1"] * cfg["D"], cfg["n_times"]
    t1 = t // cfg["pool_1"]
    t2 = t1 // cfg["pool_2"]
    if schedule == "banded":
        return [(n_folds, batch, t1, f2), (n_folds, batch, t2, f2)]
    if schedule == "lax":
        return [(batch, n_folds * f2, 1, t1), (batch, n_folds * f2, 1, t2)]
    raise ValueError(f"no dropout stream known for schedule {schedule!r}")


def fold_masks(cfg: dict, schedule: str, drawn: torch.Tensor, layer: int
               ) -> torch.Tensor:
    """Every fold's part of draw ``layer``, laid out ``(G, B, F2, 1, T')``
    (the layout of this module's activations, a fold first)."""
    f2 = cfg["F1"] * cfg["D"]
    if schedule == "banded":
        return drawn.transpose(2, 3)[:, :, :, None, :]
    b, _, _, t = drawn.shape
    return drawn.reshape(b, -1, f2, 1, t).transpose(0, 1)


MAXNORM = {"spatial.weight": 1.0, "classifier.weight": 0.25}


# --- The FLOP count --------------------------------------------------------
# Frozen from the port's ``utils/flops.py`` as it stood when the benchmark
# was defined: 2 FLOPs a multiply-accumulate, only the taps that land inside
# the input, no input gradient at the first layer, the elementwise passes at
# the per-element op counts of the JAX step's HLO, transcendental ops free.
# The validation batch counts block 1 in the fused algebra the program's
# validation pass computes (a (F2, C) mix, then 32 taps on F2 rows).

BN_EVAL, BN_TRAIN, ELU = 3, 16, 2
BLOCK1_ACT_TRAIN, BLOCK2_ACT_TRAIN, DROPOUT_TRAIN = 12, 23, 10
CE_PER_CLASS, PARAM_UPDATE = 10, 18


def _valid_taps(n: int, k: int, left: int) -> int:
    return sum(min(k, n + left - t) - max(0, left - t) for t in range(n))


def _dims(cfg: dict) -> dict:
    c, t = cfg["n_channels"], cfg["n_times"]
    f1, f2 = cfg["F1"], cfg["F1"] * cfg["D"]
    t4 = t // cfg["pool_1"]
    kt, ks = cfg["temporal_kernel"], cfg["separable_kernel"]
    g = dict(c=c, t=t, f1=f1, f2=f2, t4=t4, t8=t4 // cfg["pool_2"],
             k=cfg["n_classes"], kt=kt)
    g["macs"] = {
        "temporal": f1 * c * _valid_taps(t, kt, kt // 2 - 1),
        "spatial": c * f2 * t,
        "depthwise": f2 * _valid_taps(t4, ks, ks // 2 - 1),
        "pointwise": f2 * f2 * t4,
        "classifier": f2 * g["t8"] * g["k"],
    }
    g["n_params"] = (kt * f1 + c * f2 + ks * f2 + f2 * f2
                     + f2 * g["t8"] * g["k"] + g["k"] + 2 * (f1 + 2 * f2))
    return g


def train_step_flops(cfg: dict, batch: int) -> float:
    """One optimizer step of one model on ``batch`` trials."""
    g = _dims(cfg)
    macs = g["macs"]
    fwd = 2 * sum(macs.values()) + g["k"]
    bwd = 2 * macs["temporal"] + 4 * (macs["spatial"] + macs["depthwise"]
                                      + macs["pointwise"]
                                      + macs["classifier"]) + g["k"]
    n1 = g["f1"] * g["c"] * g["t"]
    n2, n3, n4 = g["f2"] * g["t"], g["f2"] * g["t4"], g["f2"] * g["t8"]
    elementwise = (BN_TRAIN * (n1 + n2 + n3) + BLOCK1_ACT_TRAIN * n2
                   + DROPOUT_TRAIN * n3 + BLOCK2_ACT_TRAIN * n3
                   + DROPOUT_TRAIN * n4 + CE_PER_CLASS * g["k"])
    return float(batch * (fwd + bwd + elementwise)
                 + PARAM_UPDATE * g["n_params"])


def eval_step_flops(cfg: dict, batch: int) -> float:
    """One validation batch of one model."""
    g = _dims(cfg)
    macs = g["macs"]
    block1 = (2 * g["f2"] * g["c"] * g["t"]
              + 2 * g["f2"] * _valid_taps(g["t"], g["kt"], g["kt"] // 2 - 1)
              + 2 * g["f2"] * g["t"] + ELU * g["f2"] * g["t"]
              + 4 * g["f2"] * g["t4"])
    block2 = (2 * (macs["depthwise"] + macs["pointwise"] + macs["classifier"])
              + g["k"] + (BN_EVAL + ELU) * g["f2"] * g["t4"]
              + 8 * g["f2"] * g["t8"])
    return float(batch * (block1 + block2 + CE_PER_CLASS * g["k"]))
