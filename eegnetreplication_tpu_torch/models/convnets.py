"""ShallowConvNet and DeepConvNet (Schirrmeister et al. 2017) in PyTorch.

The counterpart of ``eegnetreplication_tpu/models/convnets.py``, with its
hyperparameters (braindecode's 250 Hz kernels and pools scaled to 128 Hz)
and its flax layer names as module names (``temporal_conv``,
``spatial_conv``, ``bn``, ``conv_1``, ``bn_1``, ..., ``classifier``), so
``training/checkpoint.py`` carries weights across from the JAX package's
tree.  Both take ``(B, C, T)`` trials and return ``(B, n_classes)`` logits,
as :class:`~eegnetreplication_tpu_torch.models.eegnet.EEGNet` does.

What the flax modules compute, in torch's NCHW:

- the spatial convolution is a *full* convolution over the temporal
  features (``(C, 1)`` kernel, every input feature), not a depthwise one;
- pools are VALID (the tail that does not fill a window is dropped);
- the classifier's fan-in is flattened feature-major (torch's NCHW),
  where flax flattens NHWC feature-fastest: the checkpoint converters
  permute its rows as they do EEGNet's;
- BatchNorm has flax's semantics only (``models/norm.py``, ``"flax"``):
  neither package's constructor takes a ``bn_mode``, so asking for
  ``"torch"`` is a ``TypeError`` in both;
- no max-norm (``MAXNORM_LIMITS = {}``).

Weights are drawn like the JAX package's ``torch_kernel_init``
(U(+-1/sqrt(fan_in))) from ``generator``, the classifier bias is zero (flax's
``Dense`` default) and BatchNorm starts at the identity.  Training runs
through :meth:`stacked` (G weight sets on G batches, grouped convolutions,
per-set BatchNorm statistics), the form the fold trainer advances; a
single model's training forward is G = 1.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from eegnetreplication_tpu_torch.models.eegnet import (
    classify,
    dropout,
    elu,
    grouped_norm,
    stacked_norm,
    stacked_state,
    train_forward,
)
from eegnetreplication_tpu_torch.utils.device import resolve_device


def _safe_log(x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    return torch.log(torch.clamp(x, min=eps))


class _ConvNet(nn.Module):
    """What both baselines share: init, the eval/training forward through
    :meth:`stacked`, the fold trainer's hooks."""

    MAXNORM_LIMITS: dict = {}
    bn_epsilon = 1e-5

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator | None = None
                         ) -> None:
        """Conv and dense kernels ~ U(+-1/sqrt(fan_in)), dense biases 0,
        BatchNorm at the identity; drawn on the generator's device (the CPU
        by default) and copied over."""
        draw_on = generator.device if generator is not None else "cpu"
        for module in self.modules():
            if isinstance(module, (nn.Conv2d, nn.Linear)):
                bound = 1.0 / math.sqrt(module.weight[0].numel())  # fan-in
                values = torch.empty(module.weight.shape, device=draw_on)
                module.weight.copy_(values.uniform_(-bound, bound,
                                                    generator=generator))
                if module.bias is not None:
                    module.bias.zero_()
            elif isinstance(module, nn.BatchNorm2d):
                module.reset_parameters()

    def forward(self, x: torch.Tensor,
                sample_weights: torch.Tensor | None = None) -> torch.Tensor:
        """Logits of ``(B, C, T)`` trials; in training mode the BatchNorms
        use batch statistics (``sample_weights`` is accepted and unused, as
        in the JAX package) and replace their running statistics."""
        self.check_length(x.shape[-1])
        x = x.to(torch.float32)
        if self.training:
            return train_forward(self, x, sample_weights)
        params, stats = stacked_state(self)
        return self.stacked(params, stats, x[None], train=False)[0][0]

    def fresh(self, generator: torch.Generator) -> "_ConvNet":
        """A new model of this configuration on the CPU, drawn from
        ``generator``."""
        return type(self)(**self.config(), device="cpu", generator=generator)

    def metadata(self) -> dict:
        """The geometry a checkpoint records (the JAX ``_save_model``'s)."""
        return {"n_channels": self.n_channels, "n_times": self.n_times}

    def _start(self, x: torch.Tensor, params, stats, *, train: bool,
               generator, bn_group=None):
        """The shared prologue of :meth:`stacked`: the grouped input
        ``(B, G, C, T)``, the per-set norm over the grouped layout (synced
        over ``bn_group`` when given), and the dropout."""
        self.check_length(x.shape[-1])
        g = x.shape[0]
        new_stats: dict[str, torch.Tensor] = {}
        norm = grouped_norm(stacked_norm(
            params, stats, train=train, sample_weights=None, bn_mode="flax",
            momentum=self.momentum, eps=self.bn_epsilon,
            new_stats=new_stats, group=bn_group), g)
        rate = self.dropout_rate if train else 0.0

        def drop(h):
            return dropout(h, rate, generator)

        return x.transpose(0, 1), g, norm, drop, new_stats


def _grouped_conv(h: torch.Tensor, weight: torch.Tensor, g: int
                  ) -> torch.Tensor:
    """G sets' convolutions at once: ``weight`` ``(G, out, in, kh, kw)``
    over the grouped layout ``(B, G*in, H, W)``."""
    return F.conv2d(h, weight.reshape(-1, *weight.shape[2:]), groups=g)


class ShallowConvNet(_ConvNet):
    """Shallow FBCSP-style ConvNet: temporal conv -> spatial conv -> BN ->
    square -> mean-pool -> log -> dropout -> dense.  The kernel (13) and
    pool (35, stride 7) are braindecode's 250 Hz defaults (25, 75/15)
    scaled to 128 Hz."""

    def __init__(self, n_channels: int = 22, n_times: int = 257,
                 n_classes: int = 4, n_filters_time: int = 40,
                 n_filters_spat: int = 40, filter_time_length: int = 13,
                 pool_time_length: int = 35, pool_time_stride: int = 7,
                 dropout_rate: float = 0.5, momentum: float = 0.9, *,
                 bn_axis_name: str | None = None,
                 device: torch.device | str | None = None,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.bn_axis_name = bn_axis_name
        self.n_channels, self.n_times = int(n_channels), int(n_times)
        self.n_classes = int(n_classes)
        self.n_filters_time = int(n_filters_time)
        self.n_filters_spat = int(n_filters_spat)
        self.filter_time_length = int(filter_time_length)
        self.pool_time_length = int(pool_time_length)
        self.pool_time_stride = int(pool_time_stride)
        self.dropout_rate = float(dropout_rate)
        self.momentum = float(momentum)
        self.check_length(self.n_times)
        kw = {"device": resolve_device(device)}
        self.temporal_conv = nn.Conv2d(1, self.n_filters_time,
                                       (1, self.filter_time_length),
                                       bias=False, **kw)
        self.spatial_conv = nn.Conv2d(self.n_filters_time,
                                      self.n_filters_spat,
                                      (self.n_channels, 1), bias=False, **kw)
        self.bn = nn.BatchNorm2d(self.n_filters_spat, eps=self.bn_epsilon,
                                 **kw)
        self.classifier = nn.Linear(self.n_filters_spat * self.t_out,
                                    self.n_classes, **kw)
        self.reset_parameters(generator)
        self.eval()

    def config(self) -> dict:
        return {k: getattr(self, k) for k in (
            "n_channels", "n_times", "n_classes", "n_filters_time",
            "n_filters_spat", "filter_time_length", "pool_time_length",
            "pool_time_stride", "dropout_rate", "momentum")}

    @property
    def t_out(self) -> int:
        """Time steps left after the conv and the pool."""
        t = self.n_times - self.filter_time_length + 1
        return (t - self.pool_time_length) // self.pool_time_stride + 1

    def check_length(self, t: int) -> None:
        """The JAX model's length check (``convnets.py:62-67``)."""
        min_t = self.filter_time_length + self.pool_time_length - 1
        if t < min_t:
            raise ValueError(
                f"ShallowConvNet needs n_times >= {min_t} "
                f"(filter {self.filter_time_length} + pool "
                f"{self.pool_time_length}); got {t}")

    def stacked(self, params, stats, x, *, train: bool,
                sample_weights=None, generator=None, bn_group=None):
        """G models on G batches: ``x`` ``(G, B, C, T)`` -> logits ``(G, B,
        n_classes)`` and the new running statistics (``{}`` in eval mode);
        ``params``/``stats`` are the ``state_dict`` tensors with a leading
        G axis.  ``sample_weights`` is unused (flax BatchNorm)."""
        del sample_weights
        h, g, norm, drop, new_stats = self._start(
            x, params, stats, train=train, generator=generator,
            bn_group=bn_group)
        b = h.shape[0]
        h = _grouped_conv(h, params["temporal_conv.weight"], g)
        h = _grouped_conv(h, params["spatial_conv.weight"], g)
        h = torch.square(norm(h, "bn"))                  # (B, G*F, 1, T')
        h = F.avg_pool2d(h, (1, self.pool_time_length),
                         stride=(1, self.pool_time_stride))
        h = drop(_safe_log(h))
        return classify(h.reshape(b, g, -1).transpose(0, 1),
                        params), new_stats


class DeepConvNet(_ConvNet):
    """Deep4-style ConvNet: four conv/max-pool blocks of widths 25, 50,
    100 and 200 (temporal conv and spatial conv in the first), BN and ELU
    in each, dropout before blocks 2-4.  Kernels (1, 5) and pools (1, 2)
    are braindecode's 250 Hz defaults scaled to 128 Hz."""

    def __init__(self, n_channels: int = 22, n_times: int = 257,
                 n_classes: int = 4,
                 filters: tuple[int, ...] = (25, 50, 100, 200),
                 kernel_length: int = 5, pool_length: int = 2,
                 dropout_rate: float = 0.5, momentum: float = 0.9, *,
                 bn_axis_name: str | None = None,
                 device: torch.device | str | None = None,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.bn_axis_name = bn_axis_name
        self.n_channels, self.n_times = int(n_channels), int(n_times)
        self.n_classes = int(n_classes)
        self.filters = tuple(int(f) for f in filters)
        self.kernel_length = int(kernel_length)
        self.pool_length = int(pool_length)
        self.dropout_rate = float(dropout_rate)
        self.momentum = float(momentum)
        self.check_length(self.n_times)
        kw = {"device": resolve_device(device)}
        k, f0 = self.kernel_length, self.filters[0]
        self.temporal_conv = nn.Conv2d(1, f0, (1, k), bias=False, **kw)
        self.spatial_conv = nn.Conv2d(f0, f0, (self.n_channels, 1),
                                      bias=False, **kw)
        self.bn_0 = nn.BatchNorm2d(f0, eps=self.bn_epsilon, **kw)
        for i, (w_in, w_out) in enumerate(zip(self.filters,
                                              self.filters[1:]), start=1):
            setattr(self, f"conv_{i}", nn.Conv2d(w_in, w_out, (1, k),
                                                 bias=False, **kw))
            setattr(self, f"bn_{i}", nn.BatchNorm2d(w_out,
                                                    eps=self.bn_epsilon,
                                                    **kw))
        self.classifier = nn.Linear(self.filters[-1] * self.t_out,
                                    self.n_classes, **kw)
        self.reset_parameters(generator)
        self.eval()

    def config(self) -> dict:
        return {k: getattr(self, k) for k in (
            "n_channels", "n_times", "n_classes", "filters", "kernel_length",
            "pool_length", "dropout_rate", "momentum")}

    def _t_after(self, t: int) -> int:
        for _ in self.filters:
            t = (t - (self.kernel_length - 1)) // self.pool_length
        return t

    @property
    def t_out(self) -> int:
        """Time steps left after the four blocks."""
        return self._t_after(self.n_times)

    def check_length(self, t: int) -> None:
        """The JAX model's length check (``convnets.py:122-130``)."""
        if self._t_after(t) < 1:
            raise ValueError(
                f"DeepConvNet's {len(self.filters)} conv/pool blocks "
                f"(kernel {self.kernel_length}, pool {self.pool_length}) "
                f"consume n_times={t} to nothing; need a longer "
                f"window (>= ~{self.kernel_length * 2 ** len(self.filters)})")

    def stacked(self, params, stats, x, *, train: bool,
                sample_weights=None, generator=None, bn_group=None):
        """G models on G batches, as :meth:`ShallowConvNet.stacked`."""
        del sample_weights
        h, g, norm, drop, new_stats = self._start(
            x, params, stats, train=train, generator=generator,
            bn_group=bn_group)
        b = h.shape[0]
        pool = (1, self.pool_length)
        h = _grouped_conv(h, params["temporal_conv.weight"], g)
        h = _grouped_conv(h, params["spatial_conv.weight"], g)
        h = F.max_pool2d(elu(norm(h, "bn_0")), pool, stride=pool)
        for i in range(1, len(self.filters)):
            h = _grouped_conv(drop(h), params[f"conv_{i}.weight"], g)
            h = F.max_pool2d(elu(norm(h, f"bn_{i}")), pool, stride=pool)
        return classify(h.reshape(b, g, -1).transpose(0, 1),
                        params), new_stats
