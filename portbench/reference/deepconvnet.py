"""Deep4 (Schirrmeister et al. 2017, arXiv:1703.05051; braindecode's
``Deep4Net``), one model, NCHW.

Block 1: a temporal ``Conv(1 x k)`` with 25 filters, then a spatial
``Conv(C x 1)`` over all 25 of them -> BatchNorm -> ELU -> MaxPool(1, 2).
Blocks 2-4: Dropout -> ``Conv(1 x k)`` of widths 50, 100, 200 ->
BatchNorm -> ELU -> MaxPool(1, 2).  Then flatten (feature-major) and
Dense(4).  Convolutions and pools are VALID and have no bias.

Where this follows the configuration rather than the paper:

- the kernels (k = 5) and pools (2) are braindecode's 250 Hz ones (10, 3)
  scaled to 128 Hz (the configuration's ``assumed``);
- BatchNorm in flax's convention (``layers.batch_norm``), with the
  configuration's momentum and epsilon;
- weights start U(+-1/sqrt(fan_in)) from a CPU generator in the order of
  :func:`draws`, the dense bias at 0, BatchNorm at the identity; no
  max-norm.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from portbench.reference.layers import batch_norm, dropout


def _lengths(cfg: dict) -> list[int]:
    """Time steps entering each pool, then the length left at the end."""
    k, pool = cfg["kernel_length"], cfg["pool_length"]
    t, out = cfg["n_times"], []
    for _ in cfg["filters"]:
        t = t - (k - 1)
        out.append(t)
        t //= pool
    return out + [t]


def shapes(cfg: dict) -> dict[str, tuple[int, ...]]:
    w, k, c = cfg["filters"], cfg["kernel_length"], cfg["n_channels"]
    out = {"temporal_conv.weight": (w[0], 1, 1, k),
           "spatial_conv.weight": (w[0], w[0], c, 1),
           "bn_0.weight": (w[0],), "bn_0.bias": (w[0],)}
    for i in range(1, len(w)):
        out[f"conv_{i}.weight"] = (w[i], w[i - 1], 1, k)
        out[f"bn_{i}.weight"] = (w[i],)
        out[f"bn_{i}.bias"] = (w[i],)
    out["classifier.weight"] = (cfg["n_classes"], w[-1] * _lengths(cfg)[-1])
    out["classifier.bias"] = (cfg["n_classes"],)
    return out


def draws(cfg: dict) -> list[str]:
    return (["temporal_conv.weight", "spatial_conv.weight"]
            + [f"conv_{i}.weight" for i in range(1, len(cfg["filters"]))]
            + ["classifier.weight"])


def init(cfg: dict, generator: torch.Generator
         ) -> tuple[dict[str, torch.Tensor], dict[str, torch.Tensor]]:
    shp = shapes(cfg)
    params = {}
    for name in draws(cfg):
        bound = 1.0 / math.sqrt(math.prod(shp[name][1:]))
        params[name] = torch.empty(shp[name]).uniform_(-bound, bound,
                                                       generator=generator)
    params["classifier.bias"] = torch.zeros(shp["classifier.bias"])
    stats = {}
    for i in range(len(cfg["filters"])):
        n = cfg["filters"][i]
        params[f"bn_{i}.weight"] = torch.ones(n)
        params[f"bn_{i}.bias"] = torch.zeros(n)
        stats[f"bn_{i}.running_mean"] = torch.zeros(n)
        stats[f"bn_{i}.running_var"] = torch.ones(n)
    return {k: params[k] for k in shp}, stats


def forward(cfg: dict, p: dict, s: dict, x: torch.Tensor, *, train: bool,
            masks=None, rate: float = 0.0):
    pool = (1, cfg["pool_length"])
    new = dict(s)
    h = F.conv2d(x[:, None], p["temporal_conv.weight"])
    h = F.conv2d(h, p["spatial_conv.weight"])
    h = F.max_pool2d(F.elu(batch_norm(h, p, s, new, "bn_0", train, cfg)),
                     pool)
    for i in range(1, len(cfg["filters"])):
        if train and rate > 0:
            h = dropout(h, masks[i - 1], rate)
        h = F.conv2d(h, p[f"conv_{i}.weight"])
        h = F.max_pool2d(F.elu(batch_norm(h, p, s, new, f"bn_{i}", train,
                                          cfg)), pool)
    return F.linear(h.flatten(1), p["classifier.weight"],
                    p["classifier.bias"]), new


def mask_draws(cfg: dict, schedule: str, n_folds: int, batch: int
               ) -> list[tuple[int, ...]]:
    """The program's dropout stream: one ``torch.rand`` for all folds
    before each of blocks 2-4, over its grouped layout ``(B, G * F, 1,
    T)``."""
    if schedule != "grouped":
        raise ValueError(f"no dropout stream known for schedule {schedule!r}")
    w, t = cfg["filters"], _lengths(cfg)
    return [(batch, n_folds * w[i], 1, t[i] // cfg["pool_length"])
            for i in range(len(w) - 1)]


def fold_masks(cfg: dict, schedule: str, drawn: torch.Tensor, layer: int
               ) -> torch.Tensor:
    """Every fold's part of draw ``layer``, laid out ``(G, B, F, 1, T)``."""
    b, _, _, t = drawn.shape
    return drawn.reshape(b, -1, cfg["filters"][layer], 1, t).transpose(0, 1)


MAXNORM: dict = {}


# --- The FLOP count --------------------------------------------------------
# Frozen from the port's ``utils/flops.py`` (see ``eegnet.py``): Deep4's
# elementwise passes are BatchNorm (16 a pre-pool element in training, 3 in
# eval), ELU and MaxPool(2) with their gradients (27), ELU alone in eval (4)
# and the pool's compares, and dropout (10 a masked element).

BN_EVAL, BN_TRAIN, ELU_EVAL, ACT_TRAIN, DROPOUT_TRAIN = 3, 16, 4, 27, 10
CE_PER_CLASS, PARAM_UPDATE = 10, 18


def _dims(cfg: dict) -> dict:
    c, k = cfg["n_channels"], cfg["n_classes"]
    kl, pool, widths = cfg["kernel_length"], cfg["pool_length"], cfg["filters"]
    lengths = _lengths(cfg)
    macs = {"temporal": widths[0] * c * lengths[0] * kl,
            "spatial": widths[0] * widths[0] * c * lengths[0]}
    for i in range(1, len(widths)):
        macs[f"conv_{i}"] = widths[i] * widths[i - 1] * kl * lengths[i]
    macs["classifier"] = widths[-1] * lengths[-1] * k
    pre_pool = [widths[i] * lengths[i] for i in range(len(widths))]
    pooled = [widths[i] * (lengths[i] // pool) for i in range(len(widths))]
    n_params = (widths[0] * kl + widths[0] * widths[0] * c
                + sum(widths[i] * widths[i - 1] * kl
                      for i in range(1, len(widths)))
                + 2 * sum(widths) + widths[-1] * lengths[-1] * k + k)
    return dict(k=k, pool=pool, macs=macs, pre_pool=pre_pool, pooled=pooled,
                n_params=n_params)


def _forward_flops(g: dict) -> float:
    return (2 * sum(g["macs"].values()) + g["k"]
            + (BN_EVAL + ELU_EVAL) * sum(g["pre_pool"])
            + (g["pool"] - 1) * sum(g["pooled"]))


def train_step_flops(cfg: dict, batch: int) -> float:
    g = _dims(cfg)
    macs = g["macs"]
    fwd = 2 * sum(macs.values()) + g["k"]
    bwd = 2 * macs["temporal"] + 4 * sum(
        v for name, v in macs.items() if name != "temporal") + g["k"]
    elementwise = ((BN_TRAIN + ACT_TRAIN) * sum(g["pre_pool"])
                   + DROPOUT_TRAIN * sum(g["pooled"][:-1]))
    return float(batch * (fwd + bwd + elementwise + CE_PER_CLASS * g["k"])
                 + PARAM_UPDATE * g["n_params"])


def eval_step_flops(cfg: dict, batch: int) -> float:
    g = _dims(cfg)
    return float(batch * (_forward_flops(g) + CE_PER_CLASS * g["k"]))
