"""The two layers the models share, as the configurations state them."""

from __future__ import annotations

import torch


def batch_norm(h: torch.Tensor, p: dict, s: dict, new: dict, prefix: str,
               train: bool, cfg: dict) -> torch.Tensor:
    """BatchNorm over the batch and spatial axes of ``h`` ``(B, F, H, W)``
    in flax's convention (the ``bn_*`` keys of ``cfg``): in training the
    batch statistics of every slot, the biased variance, and
    ``running = momentum * running + (1 - momentum) * batch`` into ``new``;
    in eval the running statistics."""
    eps, momentum = cfg["bn_epsilon"], cfg["bn_momentum"]
    mean_key, var_key = f"{prefix}.running_mean", f"{prefix}.running_var"
    if train:
        var, mean = torch.var_mean(h, dim=(0, 2, 3), unbiased=False)
        new[mean_key] = momentum * s[mean_key] + (1 - momentum) * mean.detach()
        new[var_key] = momentum * s[var_key] + (1 - momentum) * var.detach()
    else:
        mean, var = s[mean_key], s[var_key]
    scale = p[f"{prefix}.weight"] / torch.sqrt(var + eps)
    return ((h - mean[None, :, None, None]) * scale[None, :, None, None]
            + p[f"{prefix}.bias"][None, :, None, None])


def dropout(h: torch.Tensor, uniform: torch.Tensor, rate: float
            ) -> torch.Tensor:
    """Keep where the uniform draw is below ``1 - rate``, scaled by
    ``1 / (1 - rate)``."""
    keep = 1.0 - rate
    return torch.where(uniform < keep, h / keep, torch.zeros_like(h))
