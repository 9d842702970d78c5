"""Training-mode BatchNorm, functional, in the JAX package's two modes.

The counterpart of ``eegnetreplication_tpu/models/norm.py``
(``TorchBatchNorm``) and of flax's ``nn.BatchNorm``.  Stock
``nn.BatchNorm2d`` matches neither, and its in-place running-statistics
update cannot serve G folds stacked along an axis, so BatchNorm here is a
function that *returns* the new running statistics and never writes one.

Layout: ``x`` is ``(B, G, F, *spatial)``, batch first, then G independent
weight sets (the folds of a protocol, 1 for a single model), then the F
features; ``scale``, ``bias``, ``mean`` and ``var`` are ``(G, F)`` and the
optional ``sample_weights`` ``(G, B)`` (0 marks a wrap-around padding slot).
Statistics are per ``(g, f)`` over the batch and spatial axes.

- ``"flax"`` (the default, as in the JAX package): ``nn.BatchNorm``.  The
  batch statistics count every slot, padding included; the variance is
  ``E[x^2] - E[x]^2`` clamped at 0; the running variance moves toward the
  *biased* batch variance.
- ``"torch"``: ``TorchBatchNorm``, the reference's semantics.  Statistics
  only over slots with weight > 0; the running variance moves toward the
  unbiased ``var * d / (d - 1)``; a batch with no real slot leaves the
  running statistics as they were.

Both use flax's momentum convention (``running <- momentum * running +
(1 - momentum) * batch``, 0.9 here is torch's 0.1) and eps 1e-5.

**Synced BatchNorm.**  Given a data-axis group (``group``, a
:class:`~eegnetreplication_tpu_torch.parallel.mesh.AxisGroup`; the JAX
package's ``bn_axis_name``), the batch is split over the group's ranks and
the statistics are the whole batch's: ``"torch"`` mode sums the weighted
sums ``s1``, ``s2`` and the count over the group (the JAX module psums
them), ``"flax"`` mode averages the ranks' means and mean squares (flax's
``lax.pmean``).  Each is one ``all_reduce`` a BatchNorm, differentiable:
its backward sums the gradient over the group.
"""

from __future__ import annotations

import torch

BN_MODES = ("flax", "torch")


def _per_feature(t: torch.Tensor, ndim: int) -> torch.Tensor:
    """``(G, F)`` -> ``(1, G, F, 1, ...)`` against an ``ndim``-d ``x``."""
    return t.reshape(1, *t.shape, *([1] * (ndim - 3)))


def batch_norm_train(x: torch.Tensor, scale: torch.Tensor,
                     bias: torch.Tensor, mean: torch.Tensor,
                     var: torch.Tensor,
                     sample_weights: torch.Tensor | None = None, *,
                     mode: str = "flax", momentum: float = 0.9,
                     eps: float = 1e-5, group=None
                     ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Normalise ``x`` with its batch statistics (the whole batch's over
    ``group`` when one is given; see the module docstring).

    Returns ``(y, new_mean, new_var)``: the output (differentiable in
    ``x``, ``scale`` and ``bias``) and the running statistics after this
    batch (detached).  ``sample_weights`` is read only in ``"torch"`` mode.
    """
    synced = group is not None and group.active
    if mode not in BN_MODES:
        raise ValueError(f"bn_mode must be 'flax' or 'torch'; got {mode!r}")
    dims = (0,) + tuple(range(3, x.ndim))
    spatial = 1
    for d in x.shape[3:]:
        spatial *= d
    if mode == "flax":
        m = x.mean(dims)
        m2 = (x * x).mean(dims)
        if synced:
            m, m2 = group.sum_differentiable(
                torch.stack([m, m2])) / group.size
        v = torch.clamp(m2 - m * m, min=0.0)
        batch_var = v
        keep = None
    else:
        if sample_weights is None:
            w = x.new_ones((x.shape[1], x.shape[0]))
        else:
            w = (sample_weights > 0).to(x.dtype)                # (G, B)
        w_b = w.t().reshape(x.shape[0], x.shape[1],
                            *([1] * (x.ndim - 2)))
        denom = w.sum(1, keepdim=True) * spatial                # (G, 1)
        s1 = (x * w_b).sum(dims)
        s2 = (x * x * w_b).sum(dims)
        if synced:
            s1, s2, denom = group.sum_differentiable(torch.stack(
                [s1, s2, denom.expand_as(s1)]))
            denom = denom[:, :1]
        d = torch.clamp(denom, min=1.0)
        m = s1 / d
        v = torch.clamp(s2 / d - m * m, min=0.0)
        batch_var = v * d / torch.clamp(d - 1.0, min=1.0)       # unbiased
        keep = denom > 0

    with torch.no_grad():
        new_mean = momentum * mean + (1.0 - momentum) * m.detach()
        new_var = momentum * var + (1.0 - momentum) * batch_var.detach()
        if keep is not None:   # an all-padding batch: stats unchanged
            new_mean = torch.where(keep, new_mean, mean)
            new_var = torch.where(keep, new_var, var)

    inv = torch.rsqrt(v + eps) * scale
    y = (x - _per_feature(m, x.ndim)) * _per_feature(inv, x.ndim) \
        + _per_feature(bias, x.ndim)
    return y, new_mean, new_var


def batch_norm_eval(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                    mean: torch.Tensor, var: torch.Tensor,
                    eps: float = 1e-5) -> torch.Tensor:
    """Normalise ``x`` with the running statistics (both modes alike)."""
    inv = torch.rsqrt(var + eps) * scale
    return (x - _per_feature(mean, x.ndim)) * _per_feature(inv, x.ndim) \
        + _per_feature(bias, x.ndim)
