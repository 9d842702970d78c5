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
under the same names.  It runs either of the JAX model's conv schedules
(``conv_impl``): grouped convolutions (``"lax"``) or ``ops/banded.py``'s
batched matmuls (``"banded"``, what ``"auto"`` resolves to), with the same
parameters and the same results to f32 rounding.

``dtype`` and ``precision`` are the JAX module's numerics fields.  At
``dtype=torch.bfloat16`` (the ``"bf16"`` numerics mode) the forward
computes in bf16: the input and every weight are cast per op, the
BatchNorms normalise in f32 (``models/norm.py``), and the logits come out
f32; the parameters stay f32, so their gradients land f32.  ``precision``
(``"highest"``, ``"high"`` or ``None``) takes effect through the run's
``utils/device.py::numerics`` scope; the model records it for the fused
eval gate (``training/steps.py::supports_fused_eval``).

The registry (``models/registry.py``) also holds ShallowConvNet and
DeepConvNet (``models/convnets.py``), which share this module's
functional pieces (BatchNorm over G sets, dropout, the classifier) and its
``stacked``/``fresh``/``metadata`` interface with the fold trainer.
"""

from __future__ import annotations

import math
import os
from typing import Callable, Mapping

import torch
import torch.nn.functional as F
from torch import nn

from eegnetreplication_tpu_torch.models.norm import (
    BN_MODES,
    batch_norm_eval,
    batch_norm_train,
)
from eegnetreplication_tpu_torch.ops import banded, bn_spatial
from eegnetreplication_tpu_torch.utils.device import resolve_device

TEMPORAL_K = 32
SEPARABLE_K = 16

# Layers under the reference's "max-norm" (quirk Q1), weights only: the
# spatial filters at 1.0 and the classifier at 0.25 (model.py:43-44,83-84).
MAXNORM_LIMITS = {"spatial.weight": 1.0, "classifier.weight": 0.25}

# The running statistics of the three BatchNorms, by state_dict name.
BN_PREFIXES = ("temporal.1", "aggregation.0", "block_2.2")

CONV_IMPLS = ("banded", "lax")
# What conv_impl="auto" resolves to on this port: "banded", as in the JAX
# package, because on the card it is not slower.  chip_smoke.py phase 17c,
# NVIDIA H100 80GB HBM3 at 700 W, fold-epochs/s of the protocols' trainer
# in turns banded, lax, lax, banded: 376.8 against 241.1 at 36 folds and
# 109.8 against 65.5 at 90 (PERF.md section 5).
AUTO_CONV_IMPL = "banded"


def resolve_conv_impl(conv_impl: str) -> str:
    """The schedule ``conv_impl`` names, with the JAX package's rules:
    ``EEGTPU_CONV_IMPL`` overrides ``"auto"`` only (its own ``"auto"`` or
    an empty value is the default), an explicit value wins, and anything
    else raises."""
    if conv_impl == "auto":
        impl = os.environ.get("EEGTPU_CONV_IMPL") or AUTO_CONV_IMPL
        conv_impl = AUTO_CONV_IMPL if impl == "auto" else impl
    if conv_impl not in CONV_IMPLS:
        raise ValueError(
            f"conv_impl must be 'auto', 'banded', or 'lax'; "
            f"got {conv_impl!r}")
    return conv_impl


class EEGNet(nn.Module):
    """EEGNet for ``(B, C, T)`` EEG trials; returns ``(B, n_classes)`` logits.

    Defaults mirror the reference: F1=8 temporal filters, depth multiplier
    D=2, F2=F1*D pointwise filters.  Weights are drawn like torch's default
    conv/linear init (U(+-1/sqrt(fan_in)), the JAX model's init too) from
    ``generator`` when given.  The module starts in eval mode;
    ``.train()`` selects the training forward (``bn_mode`` BatchNorm,
    momentum 0.9 in flax's convention).  ``bn_axis_name`` names the mesh
    axis the training BatchNorms sync over (the JAX model's; ``"data"``
    under a data-parallel step, which hands :meth:`stacked` that axis's
    group).  ``conv_impl`` is the schedule of
    the training forward and of the fold-stacked eval block 2 (``"lax"``:
    grouped convolutions; ``"banded"``: ``ops/banded.py``'s matmuls;
    ``"auto"``: :func:`resolve_conv_impl`, once, here).  ``dtype`` is the
    compute dtype of the forward (f32, or bf16 with f32 parameters) and
    ``precision`` the matmul precision the model was built for (module
    docstring).
    """

    MAXNORM_LIMITS = MAXNORM_LIMITS

    def __init__(self, n_channels: int = 22, n_times: int = 257,
                 n_classes: int = 4, F1: int = 8, D: int = 2,
                 dropout_rate: float = 0.5, bn_epsilon: float = 1e-5, *,
                 bn_mode: str = "flax", momentum: float = 0.9,
                 conv_impl: str = "auto", bn_axis_name: str | None = None,
                 dtype: torch.dtype = torch.float32,
                 precision: str | None = "highest",
                 device: torch.device | str | None = None,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.conv_impl = resolve_conv_impl(conv_impl)
        self.dtype = dtype
        self.precision = precision
        self.bn_axis_name = bn_axis_name
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

    def metadata(self) -> dict:
        """The geometry a checkpoint records for this model."""
        return {"n_channels": self.n_channels, "n_times": self.n_times,
                "F1": self.F1, "D": self.D}

    def fresh(self, generator: torch.Generator) -> "EEGNet":
        """A new EEGNet of this geometry and schedule on the CPU, drawn from
        ``generator``."""
        return EEGNet(self.n_channels, self.n_times, self.n_classes,
                      self.F1, self.D, conv_impl=self.conv_impl,
                      dtype=self.dtype, precision=self.precision,
                      device="cpu", generator=generator)

    def stacked(self, params, stats, x, *, train: bool,
                sample_weights=None, generator=None, bn_group=None):
        """:func:`stacked_forward` with this model's hyperparameters."""
        return stacked_forward(
            params, stats, x, train=train, sample_weights=sample_weights,
            bn_mode=self.bn_mode, dropout_rate=self.dropout_rate,
            generator=generator, momentum=self.momentum,
            eps=self.bn_epsilon, conv_impl=self.conv_impl,
            bn_group=bn_group, dtype=self.dtype, precision=self.precision)

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
        generator.  A bf16 model's eval forward is its stacked forward
        at G = 1; the logits are f32 in every mode."""
        if tuple(x.shape[-2:]) != (self.n_channels, self.n_times):
            raise ValueError(
                f"Expected input (..., {self.n_channels}, {self.n_times}); "
                f"got {tuple(x.shape)}")
        x = x.to(self.dtype)
        if self.training:
            return train_forward(self, x, sample_weights)
        if self.dtype != torch.float32:
            params, stats = stacked_state(self)
            return self.stacked(params, stats, x[None], train=False)[0][0]
        x = x.unsqueeze(1)                          # (B, 1, C, T)
        x = self.temporal(x)
        x = self.spatial(x)
        x = self.aggregation(x)
        x = self.block_2(x)
        return self.classifier(x)


def stacked_state(model: nn.Module) -> tuple[dict, dict]:
    """A module's parameters and running statistics as G = 1 stacks
    (``num_batches_tracked`` left out)."""
    params = {k: v.unsqueeze(0) for k, v in model.named_parameters()}
    stats = {k: v.unsqueeze(0) for k, v in model.named_buffers()
             if not k.endswith("num_batches_tracked")}
    return params, stats


def train_forward(model: nn.Module, x: torch.Tensor,
                  sample_weights: torch.Tensor | None) -> torch.Tensor:
    """A single model's training forward: its ``stacked`` forward at G = 1,
    the new running statistics written into its buffers; dropout draws
    from torch's global generator."""
    params, stats = stacked_state(model)
    w = None if sample_weights is None else sample_weights[None]
    logits, new_stats = model.stacked(params, stats, x[None], train=True,
                                      sample_weights=w)
    buffers = dict(model.named_buffers())
    with torch.no_grad():
        for name, value in new_stats.items():
            buffers[name].copy_(value[0])
    return logits[0]


def elu(x: torch.Tensor) -> torch.Tensor:
    return torch.where(x > 0, x, torch.expm1(x))



def dropout(h: torch.Tensor, rate: float,
            generator: torch.Generator | None) -> torch.Tensor:
    """flax ``nn.Dropout``: keep with probability ``1 - rate`` and scale
    the kept values by ``1 / (1 - rate)``; rate 0 is the identity."""
    if rate == 0.0:
        return h
    keep = 1.0 - rate
    mask = torch.rand(h.shape, generator=generator, device=h.device) < keep
    return torch.where(mask, h / keep, torch.zeros_like(h))


Norm = Callable[[torch.Tensor, str], torch.Tensor]


def stacked_norm(params, stats, *, train: bool, sample_weights,
                 bn_mode: str, momentum: float, eps: float,
                 new_stats: dict, group=None) -> Norm:
    """BatchNorm of G weight sets over an activation laid out ``(B, G, F,
    *spatial)`` (any strides): statistics per set and feature, synced over
    ``group`` (a data-axis ``AxisGroup``) when given.  In training mode the
    new running statistics land in ``new_stats``."""
    def norm(hv: torch.Tensor, prefix: str) -> torch.Tensor:
        scale, bias = params[f"{prefix}.weight"], params[f"{prefix}.bias"]
        mean = stats[f"{prefix}.running_mean"]
        var = stats[f"{prefix}.running_var"]
        if train:
            y, new_stats[f"{prefix}.running_mean"], \
                new_stats[f"{prefix}.running_var"] = batch_norm_train(
                    hv, scale, bias, mean, var, sample_weights,
                    mode=bn_mode, momentum=momentum, eps=eps, group=group)
            return y
        return batch_norm_eval(hv, scale, bias, mean, var, eps)

    return norm


def stacked_norm_spatial(params, stats, *, momentum: float, eps: float,
                         new_stats: dict
                         ) -> Callable[[torch.Tensor], torch.Tensor]:
    """``temporal.1``'s training BatchNorm (flax mode) and the spatial
    convolution of G weight sets as one op (``ops/bn_spatial.py``): the
    banded temporal output ``(G, B, C, T, F1)`` -> ``(G, B, T, F2)``, the
    new running statistics into ``new_stats``."""
    def f(h: torch.Tensor) -> torch.Tensor:
        out, new_stats["temporal.1.running_mean"], \
            new_stats["temporal.1.running_var"] = bn_spatial.bn_spatial_train(
                h, params["temporal.1.weight"], params["temporal.1.bias"],
                stats["temporal.1.running_mean"],
                stats["temporal.1.running_var"], params["spatial.weight"],
                momentum=momentum, eps=eps)
        return out

    return f


def grouped_norm(norm: Norm, g: int) -> Norm:
    """``norm`` over the grouped layout ``(B, G*F, H, W)`` of the grouped
    convolutions: features ``g*F .. g*F+F-1`` belong to weight set ``g``."""
    def f(h: torch.Tensor, prefix: str) -> torch.Tensor:
        hv = h.reshape(h.shape[0], g, h.shape[1] // g, *h.shape[2:])
        return norm(hv, prefix).reshape(h.shape)

    return f


def classify(h: torch.Tensor, params: Mapping[str, torch.Tensor]
             ) -> torch.Tensor:
    """The classifier of G sets on their flattened features ``(G, B,
    fan_in)`` -> ``(G, B, n_classes)``, in ``h``'s dtype."""
    return torch.baddbmm(params["classifier.bias"][:, None, :], h,
                         params["classifier.weight"].transpose(1, 2))


def cast_params(params: Mapping[str, torch.Tensor], dtype: torch.dtype
                ) -> Mapping[str, torch.Tensor]:
    """``params`` in the compute ``dtype`` (the JAX modules cast every
    kernel to their ``dtype`` where an op reads it); the BatchNorms read
    the f32 originals.  At f32 it is ``params`` itself."""
    if dtype == torch.float32:
        return params
    return {k: v.to(dtype) for k, v in params.items()}


def _block2_classifier(h: torch.Tensor, params: Mapping[str, torch.Tensor],
                       g: int, norm: Norm, drop) -> torch.Tensor:
    """Block 2 and the classifier of G stacked EEGNets, ``"lax"`` schedule.

    ``h`` is block 1's output in the grouped layout ``(B, G*F2, 1, T')``;
    returns ``(G, B, n_classes)``.  The separable convolution runs as two
    grouped convolutions (depthwise over G*F2 groups, pointwise over G).
    """
    b, gf2 = h.shape[:2]
    f2 = gf2 // g
    norm = grouped_norm(norm, g)
    h = F.conv2d(F.pad(h, (SEPARABLE_K // 2 - 1, SEPARABLE_K // 2)),
                 params["block_2.0.weight"].reshape(gf2, 1, 1, SEPARABLE_K),
                 groups=gf2)
    h = F.conv2d(h, params["block_2.1.weight"].reshape(gf2, f2, 1, 1),
                 groups=g)
    h = drop(F.avg_pool2d(elu(norm(h, "block_2.2")), (1, 8)))
    return classify(h.reshape(b, g, -1).transpose(0, 1), params)


def _block2_classifier_banded(h: torch.Tensor,
                              params: Mapping[str, torch.Tensor],
                              norm: Norm, drop) -> torch.Tensor:
    """Block 2 and the classifier of G stacked EEGNets, ``"banded"``
    schedule: ``h`` ``(G, B, T', F2)`` -> ``(G, B, n_classes)``."""
    g, b = h.shape[:2]
    h = banded.depthwise_conv_banded(h, params["block_2.0.weight"])
    h = banded.pointwise_conv_banded(h, params["block_2.1.weight"])
    h = norm(h.permute(1, 0, 3, 2), "block_2.2").permute(1, 0, 3, 2)
    h = drop(banded.avg_pool_width(elu(h), 8))       # (G, B, T'', F2)
    # torch's NCHW flatten: feature-major
    return classify(h.transpose(2, 3).reshape(g, b, -1), params)


def fuses_bn_spatial(x: torch.Tensor, *, train: bool, bn_mode: str,
                     precision: str | None, bn_group, c: int, f1: int,
                     d: int) -> bool:
    """Whether the banded training forward runs ``temporal.1``'s BatchNorm
    and the spatial convolution as one op (``ops/bn_spatial.py``'s CUDA
    kernels): CUDA f32 activations of a ``"highest"`` model (the fused eval
    gate's numerics, ``training/steps.py::supports_fused_eval``), flax-mode
    BatchNorm, no active BatchNorm sync group, and a geometry the kernels
    take.  Anything else keeps the composition of ``models/norm.py`` and
    ``ops/banded.py``."""
    return (train and x.device.type == "cuda" and x.dtype == torch.float32
            and precision == "highest" and bn_mode == "flax"
            and not (bn_group is not None and bn_group.active)
            and bn_spatial.supported(c, f1, d))


def _stacked_forward_banded(params, x, norm: Norm, drop,
                            norm_spatial=None) -> torch.Tensor:
    """The ``"banded"`` schedule of :func:`stacked_forward`: every
    convolution a matmul of ``ops/banded.py``, activations laid out set
    first and features last, the BatchNorms on permuted views.
    ``norm_spatial`` replaces ``temporal.1``'s BatchNorm and the spatial
    convolution when given (the fused op, :func:`fuses_bn_spatial`)."""
    h = banded.temporal_conv_banded(x, params["temporal.0.weight"])
    if norm_spatial is not None:
        h = norm_spatial(h)
    else:
        # (G, B, C, T, F1) -> the norm's (B, G, F1, C, T) and back
        h = norm(h.permute(1, 0, 4, 2, 3), "temporal.1")
        h = banded.spatial_conv_banded(h.permute(1, 0, 3, 4, 2),
                                       params["spatial.weight"])
    h = norm(h.permute(1, 0, 3, 2), "aggregation.0").permute(1, 0, 3, 2)
    h = drop(banded.avg_pool_width(elu(h), 4))       # (G, B, T', F2)
    return _block2_classifier_banded(h, params, norm, drop)


def stacked_forward(params: Mapping[str, torch.Tensor],
                    stats: Mapping[str, torch.Tensor], x: torch.Tensor, *,
                    train: bool, precision: str | None,
                    sample_weights: torch.Tensor | None = None,
                    bn_mode: str = "flax", dropout_rate: float = 0.0,
                    generator: torch.Generator | None = None,
                    momentum: float = 0.9, eps: float = 1e-5,
                    conv_impl: str = "lax", bn_group=None,
                    dtype: torch.dtype = torch.float32
                    ) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """G EEGNets on G batches at once: ``x`` ``(G, B, C, T)`` -> logits
    ``(G, B, n_classes)`` and the new running statistics (``{}`` in eval
    mode).

    ``params`` and ``stats`` are the ``state_dict`` tensors (parameters;
    BatchNorm running means and variances) with a leading G axis.  Each
    set's output equals the single model's on its batch: under ``"lax"``
    the convolutions run grouped over the sets (cuDNN on the card), under
    ``"banded"`` as batched matmuls (``ops/banded.py``); the BatchNorm
    statistics are per set.  ``sample_weights`` ``(G, B)`` feeds
    ``bn_mode="torch"``; dropout masks come from ``generator`` (on ``x``'s
    device), so the two schedules draw different masks at p > 0.
    ``bn_group`` syncs the training BatchNorms over a data-axis group
    (``x`` is then this rank's part of each batch).  ``dtype`` is the
    compute dtype (module docstring): activations, convolutions, ELU,
    pooling, dropout and the classifier run in it, the BatchNorms in f32,
    and the logits are returned f32.  ``precision`` is the model's
    (module docstring), named by every caller: with ``"highest"`` the
    banded schedule's training forward runs block 1's first BatchNorm and
    spatial convolution as one op where :func:`fuses_bn_spatial` holds.
    """
    g, b, c, t = x.shape
    if sample_weights is not None and tuple(sample_weights.shape) != (g, b):
        raise ValueError(f"sample_weights must be ({g}, {b}) for a batch "
                         f"{tuple(x.shape)}, got {tuple(sample_weights.shape)}")
    if conv_impl not in CONV_IMPLS:
        raise ValueError(f"conv_impl must be 'banded' or 'lax'; got "
                         f"{conv_impl!r}")
    new_stats: dict[str, torch.Tensor] = {}
    norm = stacked_norm(params, stats, train=train,
                        sample_weights=sample_weights, bn_mode=bn_mode,
                        momentum=momentum, eps=eps, new_stats=new_stats,
                        group=bn_group)
    rate = dropout_rate if train else 0.0

    def drop(h):
        return dropout(h, rate, generator)

    x, weights = x.to(dtype), cast_params(params, dtype)
    w_t = weights["temporal.0.weight"]                # (G, F1, 1, 1, K)
    w_s = weights["spatial.weight"]                   # (G, F2, 1, C, 1)
    f1, f2 = w_t.shape[1], w_s.shape[1]
    if conv_impl == "banded":
        norm_spatial = None
        if fuses_bn_spatial(x, train=train, bn_mode=bn_mode,
                            precision=precision, bn_group=bn_group, c=c,
                            f1=f1, d=f2 // f1):
            norm_spatial = stacked_norm_spatial(
                params, stats, momentum=momentum, eps=eps,
                new_stats=new_stats)
        return (_stacked_forward_banded(weights, x, norm, drop,
                                        norm_spatial).float(), new_stats)
    gnorm = grouped_norm(norm, g)
    h = x.transpose(0, 1)                             # (B, G, C, T)
    h = F.conv2d(F.pad(h, (TEMPORAL_K // 2 - 1, TEMPORAL_K // 2)),
                 w_t.reshape(g * f1, 1, 1, TEMPORAL_K), groups=g)
    h = gnorm(h, "temporal.1")                        # (B, G*F1, C, T)
    h = F.conv2d(h, w_s.reshape(g * f2, 1, c, 1), groups=g * f1)
    h = drop(F.avg_pool2d(elu(gnorm(h, "aggregation.0")), (1, 4)))
    return _block2_classifier(h, weights, g, norm, drop).float(), new_stats


def stacked_block2_classifier(h: torch.Tensor,
                              params: Mapping[str, torch.Tensor],
                              stats: Mapping[str, torch.Tensor],
                              eps: float = 1e-5,
                              conv_impl: str = "lax") -> torch.Tensor:
    """Eval-mode block 2 and classifier of G stacked EEGNets on block 1's
    output ``(G, B, F2, T')``; returns ``(G, B, n_classes)``."""
    g, b, f2, tq = h.shape
    norm = stacked_norm(params, stats, train=False, sample_weights=None,
                        bn_mode="flax", momentum=0.0, eps=eps, new_stats={})
    if conv_impl == "banded":
        return _block2_classifier_banded(h.transpose(2, 3), params, norm,
                                         lambda v: v)
    h = h.transpose(0, 1).reshape(b, g * f2, 1, tq)
    return _block2_classifier(h, params, g, norm, lambda v: v)


def eegnet_wide(n_channels: int = 22, n_times: int = 257,
                dropout_rate: float = 0.25, **kw) -> EEGNet:
    """EEGNet-wide (F1=16, D=4, F2=64)."""
    return EEGNet(n_channels=n_channels, n_times=n_times, F1=16, D=4,
                  dropout_rate=dropout_rate, **kw)
