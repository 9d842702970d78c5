"""EEGNet (Lawhern et al. 2018) in PyTorch.

The counterpart of ``eegnetreplication_tpu/models/eegnet.py``, in the
reference's own NCHW layout and layer names (``temporal.0/1``, ``spatial``,
``aggregation.0``, ``block_2.0/1/2``, ``classifier``), so its
``state_dict`` is the reference's ``.pth`` layout and
``training/checkpoint.py`` carries weights across from the JAX package's
flax tree.

- Block 1: temporal ``Conv(1x32, same)`` -> BN -> depthwise spatial
  ``Conv(Cx1, groups=F1)`` -> BN -> ELU -> AvgPool(1,4) -> Dropout;
- Block 2: depthwise ``1x16 same`` + pointwise ``1x1`` -> BN -> ELU ->
  AvgPool(1,8) -> Dropout -> Flatten;
- classifier: ``Linear(F2*(T//32) -> n_classes)``, logits out.

torch's ``padding="same"`` pads an even kernel (15, 16) and (7, 8), exactly
like XLA's SAME, so feature maps align sample for sample with the JAX model.

Training mode uses the functional BatchNorm of ``models/norm.py`` in the
JAX package's two modes (stock ``nn.BatchNorm2d`` matches neither) and
dropout after each pool.  It is written once, for G weight sets stacked
along a leading axis (:func:`stacked_forward`): the training loop advances
every fold of a protocol in one pass, as the JAX package's fold ``vmap``
does, and a single module's training forward is the case G = 1.  The
stacked parameters are the ``state_dict`` tensors with a leading G axis,
under the same names.
"""

from __future__ import annotations

import math
from typing import Callable, Mapping

import torch
import torch.nn.functional as F
from torch import nn

from eegnetreplication_tpu_torch.models.norm import (
    BN_MODES,
    batch_norm_eval,
    batch_norm_train,
)
from eegnetreplication_tpu_torch.utils.device import resolve_device

TEMPORAL_K = 32
SEPARABLE_K = 16

# Layers under the reference's "max-norm" (quirk Q1), weights only: the
# spatial filters at 1.0 and the classifier at 0.25 (model.py:43-44,83-84).
MAXNORM_LIMITS = {"spatial.weight": 1.0, "classifier.weight": 0.25}

# The running statistics of the three BatchNorms, by state_dict name.
BN_PREFIXES = ("temporal.1", "aggregation.0", "block_2.2")


class EEGNet(nn.Module):
    """EEGNet for ``(B, C, T)`` EEG trials; returns ``(B, n_classes)`` logits.

    Defaults mirror the reference: F1=8 temporal filters, depth multiplier
    D=2, F2=F1*D pointwise filters.  Weights are drawn like torch's default
    conv/linear init (U(+-1/sqrt(fan_in)), the JAX model's init too) from
    ``generator`` when given.  The module starts in eval mode;
    ``.train()`` selects the training forward (``bn_mode`` BatchNorm,
    momentum 0.9 in flax's convention).
    """

    MAXNORM_LIMITS = MAXNORM_LIMITS

    def __init__(self, n_channels: int = 22, n_times: int = 257,
                 n_classes: int = 4, F1: int = 8, D: int = 2,
                 dropout_rate: float = 0.5, bn_epsilon: float = 1e-5, *,
                 bn_mode: str = "flax", momentum: float = 0.9,
                 device: torch.device | str | None = None,
                 generator: torch.Generator | None = None):
        super().__init__()
        if bn_mode not in BN_MODES:
            raise ValueError(
                f"bn_mode must be 'flax' or 'torch'; got {bn_mode!r}")
        device = resolve_device(device)
        self.n_channels = int(n_channels)
        self.n_times = int(n_times)
        self.n_classes = int(n_classes)
        self.F1 = int(F1)
        self.D = int(D)
        self.dropout_rate = float(dropout_rate)
        self.bn_epsilon = float(bn_epsilon)
        self.bn_mode = bn_mode
        self.momentum = float(momentum)
        f2 = self.F2
        kw = {"device": device}
        self.temporal = nn.Sequential(
            nn.Conv2d(1, self.F1, (1, 32), padding="same", bias=False, **kw),
            nn.BatchNorm2d(self.F1, eps=bn_epsilon, **kw),
        )
        self.spatial = nn.Conv2d(self.F1, f2, (self.n_channels, 1),
                                 groups=self.F1, bias=False, **kw)
        self.aggregation = nn.Sequential(
            nn.BatchNorm2d(f2, eps=bn_epsilon, **kw), nn.ELU(),
            nn.AvgPool2d((1, 4)), nn.Dropout(dropout_rate),
        )
        self.block_2 = nn.Sequential(
            nn.Conv2d(f2, f2, (1, 16), padding="same", groups=f2,
                      bias=False, **kw),
            nn.Conv2d(f2, f2, (1, 1), bias=False, **kw),
            nn.BatchNorm2d(f2, eps=bn_epsilon, **kw), nn.ELU(),
            nn.AvgPool2d((1, 8)), nn.Dropout(dropout_rate), nn.Flatten(),
        )
        self.classifier = nn.Linear(f2 * self.t_prime, self.n_classes, **kw)
        self.reset_parameters(generator)
        self.eval()

    @property
    def F2(self) -> int:
        return self.F1 * self.D

    @property
    def t_prime(self) -> int:
        """Time steps left after both pools: the classifier's fan-in is
        ``F2 * t_prime``."""
        return self.n_times // 32

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator | None = None
                         ) -> None:
        """Conv/linear weights and biases ~ U(+-1/sqrt(fan_in)); BatchNorm
        affine to identity and running statistics to (0, 1).

        Values are drawn on the generator's device (the CPU by default) and
        copied over, so one seed gives the same weights on any device.
        """
        draw_on = generator.device if generator is not None else "cpu"

        def uniform_(param, bound):
            values = torch.empty(param.shape, device=draw_on)
            param.copy_(values.uniform_(-bound, bound, generator=generator))

        for module in self.modules():
            if isinstance(module, (nn.Conv2d, nn.Linear)):
                bound = 1.0 / math.sqrt(module.weight[0].numel())  # fan-in
                uniform_(module.weight, bound)
                if module.bias is not None:
                    uniform_(module.bias, bound)
            elif isinstance(module, nn.BatchNorm2d):
                module.reset_parameters()

    def forward(self, x: torch.Tensor,
                sample_weights: torch.Tensor | None = None) -> torch.Tensor:
        """Logits of ``(B, C, T)`` trials.  In training mode the BatchNorms
        use batch statistics (``sample_weights`` ``(B,)`` marks padding
        slots for ``bn_mode="torch"``) and their running statistics are
        replaced by the new ones; dropout draws from torch's global
        generator."""
        if tuple(x.shape[-2:]) != (self.n_channels, self.n_times):
            raise ValueError(
                f"Expected input (..., {self.n_channels}, {self.n_times}); "
                f"got {tuple(x.shape)}")
        x = x.to(torch.float32)
        if self.training:
            return self._train_forward(x, sample_weights)
        x = x.unsqueeze(1)                          # (B, 1, C, T)
        x = self.temporal(x)
        x = self.spatial(x)
        x = self.aggregation(x)
        x = self.block_2(x)
        return self.classifier(x)

    def _train_forward(self, x, sample_weights):
        params = {k: v.unsqueeze(0) for k, v in self.named_parameters()}
        stats = {k: v.unsqueeze(0) for k, v in self.named_buffers()
                 if not k.endswith("num_batches_tracked")}
        w = None if sample_weights is None else sample_weights[None]
        logits, new_stats = stacked_forward(
            params, stats, x[None], train=True, sample_weights=w,
            bn_mode=self.bn_mode, dropout_rate=self.dropout_rate,
            momentum=self.momentum, eps=self.bn_epsilon)
        buffers = dict(self.named_buffers())
        with torch.no_grad():
            for name, value in new_stats.items():
                buffers[name].copy_(value[0])
        return logits[0]


def _elu(x: torch.Tensor) -> torch.Tensor:
    return torch.where(x > 0, x, torch.expm1(x))


def _dropout(h: torch.Tensor, rate: float,
             generator: torch.Generator | None) -> torch.Tensor:
    """flax ``nn.Dropout``: keep with probability ``1 - rate`` and scale
    the kept values by ``1 / (1 - rate)``; rate 0 is the identity."""
    if rate == 0.0:
        return h
    keep = 1.0 - rate
    mask = torch.rand(h.shape, generator=generator, device=h.device) < keep
    return torch.where(mask, h / keep, torch.zeros_like(h))


Norm = Callable[[torch.Tensor, str], torch.Tensor]


def _stacked_norm(params, stats, g: int, *, train: bool, sample_weights,
                  bn_mode: str, momentum: float, eps: float,
                  new_stats: dict) -> Norm:
    """BatchNorm over a grouped activation ``(B, G*F, H, W)``: features
    ``g*F .. g*F+F-1`` belong to weight set ``g``.  In training mode the
    new running statistics land in ``new_stats``."""
    def norm(h: torch.Tensor, prefix: str) -> torch.Tensor:
        hv = h.reshape(h.shape[0], g, h.shape[1] // g, *h.shape[2:])
        scale, bias = params[f"{prefix}.weight"], params[f"{prefix}.bias"]
        mean = stats[f"{prefix}.running_mean"]
        var = stats[f"{prefix}.running_var"]
        if train:
            y, new_stats[f"{prefix}.running_mean"], \
                new_stats[f"{prefix}.running_var"] = batch_norm_train(
                    hv, scale, bias, mean, var, sample_weights,
                    mode=bn_mode, momentum=momentum, eps=eps)
        else:
            y = batch_norm_eval(hv, scale, bias, mean, var, eps)
        return y.reshape(h.shape)

    return norm


def _block2_classifier(h: torch.Tensor, params: Mapping[str, torch.Tensor],
                       g: int, norm: Norm, drop) -> torch.Tensor:
    """Block 2 and the classifier of G stacked EEGNets.

    ``h`` is block 1's output in the grouped layout ``(B, G*F2, 1, T')``;
    returns ``(G, B, n_classes)``.  The separable convolution runs as two
    grouped convolutions (depthwise over G*F2 groups, pointwise over G).
    """
    b, gf2 = h.shape[:2]
    f2 = gf2 // g
    h = F.conv2d(F.pad(h, (SEPARABLE_K // 2 - 1, SEPARABLE_K // 2)),
                 params["block_2.0.weight"].reshape(gf2, 1, 1, SEPARABLE_K),
                 groups=gf2)
    h = F.conv2d(h, params["block_2.1.weight"].reshape(gf2, f2, 1, 1),
                 groups=g)
    h = drop(F.avg_pool2d(_elu(norm(h, "block_2.2")), (1, 8)))
    h = h.reshape(b, g, -1).transpose(0, 1)          # (G, B, F2 * T'')
    return torch.baddbmm(params["classifier.bias"][:, None, :], h,
                         params["classifier.weight"].transpose(1, 2))


def stacked_forward(params: Mapping[str, torch.Tensor],
                    stats: Mapping[str, torch.Tensor], x: torch.Tensor, *,
                    train: bool,
                    sample_weights: torch.Tensor | None = None,
                    bn_mode: str = "flax", dropout_rate: float = 0.0,
                    generator: torch.Generator | None = None,
                    momentum: float = 0.9, eps: float = 1e-5
                    ) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """G EEGNets on G batches at once: ``x`` ``(G, B, C, T)`` -> logits
    ``(G, B, n_classes)`` and the new running statistics (``{}`` in eval
    mode).

    ``params`` and ``stats`` are the ``state_dict`` tensors (parameters;
    BatchNorm running means and variances) with a leading G axis.  Each
    set's output equals the single model's on its batch: the convolutions
    run grouped over the sets (cuDNN on the card), the BatchNorm statistics
    are per set.  ``sample_weights`` ``(G, B)`` feeds ``bn_mode="torch"``;
    dropout masks come from ``generator`` (on ``x``'s device).
    """
    g, b, c, t = x.shape
    if sample_weights is not None and tuple(sample_weights.shape) != (g, b):
        raise ValueError(f"sample_weights must be ({g}, {b}) for a batch "
                         f"{tuple(x.shape)}, got {tuple(sample_weights.shape)}")
    w_t = params["temporal.0.weight"]                 # (G, F1, 1, 1, K)
    w_s = params["spatial.weight"]                    # (G, F2, 1, C, 1)
    f1, f2 = w_t.shape[1], w_s.shape[1]
    new_stats: dict[str, torch.Tensor] = {}
    norm = _stacked_norm(params, stats, g, train=train,
                         sample_weights=sample_weights, bn_mode=bn_mode,
                         momentum=momentum, eps=eps, new_stats=new_stats)
    rate = dropout_rate if train else 0.0

    def drop(h):
        return _dropout(h, rate, generator)

    h = x.transpose(0, 1)                             # (B, G, C, T)
    h = F.conv2d(F.pad(h, (TEMPORAL_K // 2 - 1, TEMPORAL_K // 2)),
                 w_t.reshape(g * f1, 1, 1, TEMPORAL_K), groups=g)
    h = norm(h, "temporal.1")                         # (B, G*F1, C, T)
    h = F.conv2d(h, w_s.reshape(g * f2, 1, c, 1), groups=g * f1)
    h = drop(F.avg_pool2d(_elu(norm(h, "aggregation.0")), (1, 4)))
    return _block2_classifier(h, params, g, norm, drop), new_stats


def stacked_block2_classifier(h: torch.Tensor,
                              params: Mapping[str, torch.Tensor],
                              stats: Mapping[str, torch.Tensor],
                              eps: float = 1e-5) -> torch.Tensor:
    """Eval-mode block 2 and classifier of G stacked EEGNets on block 1's
    output ``(G, B, F2, T')``; returns ``(G, B, n_classes)``."""
    g, b, f2, tq = h.shape
    h = h.transpose(0, 1).reshape(b, g * f2, 1, tq)
    norm = _stacked_norm(params, stats, g, train=False, sample_weights=None,
                         bn_mode="flax", momentum=0.0, eps=eps, new_stats={})
    return _block2_classifier(h, params, g, norm, lambda v: v)


def eegnet_wide(n_channels: int = 22, n_times: int = 257,
                dropout_rate: float = 0.25, **kw) -> EEGNet:
    """EEGNet-wide (F1=16, D=4, F2=64)."""
    return EEGNet(n_channels=n_channels, n_times=n_times, F1=16, D=4,
                  dropout_rate=dropout_rate, **kw)


MODEL_REGISTRY = {"eegnet": EEGNet, "eegnet_wide": eegnet_wide}


def get_model(name: str, **kwargs) -> EEGNet:
    """Construct a model by registry name (``eegnet``, ``eegnet_wide``)."""
    try:
        ctor = MODEL_REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"Unknown model {name!r} for the torch port; available: "
            f"{sorted(MODEL_REGISTRY)}.  ShallowConvNet, DeepConvNet and "
            "the other baselines are not ported yet (ROADMAP.md queue A, "
            "item 6)") from None
    return ctor(**kwargs)
